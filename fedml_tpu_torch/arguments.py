"""Typed flat configuration (counterpart of ``fedml_tpu/arguments.py``).

A YAML file with sections (``common_args``, ``data_args``, ...) is flattened
into one attribute namespace so every component reads ``args.X``. The schema
holds only the keys the ported slice reads; unknown keys are kept untyped,
and :func:`fedml_tpu_torch.runner.check_ported` refuses the knobs of
features the slice has not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import yaml

from .constants import (FEDML_SIMULATION_BACKEND_ALIASES,
                        FEDML_TRAINING_PLATFORM_SIMULATION)

_SCHEMA: Dict[str, Any] = {
    # common_args
    "training_type": FEDML_TRAINING_PLATFORM_SIMULATION,
    "random_seed": 0,
    "scenario": "horizontal",    # cross-silo: horizontal (hierarchical raises)
    "run_id": "0",
    # data_args
    "dataset": "synthetic_mnist",
    "data_cache_dir": "~/.cache/fedml_tpu/data",
    "partition_method": "hetero",
    "partition_alpha": 0.5,
    "allow_synthetic": False,    # opt-in gate for synthetic stand-ins
    "synthetic_size": 0,         # stand-in train set size (0 = default)
    "synthetic_test_size": 0,    # stand-in test set size (0 = 1000)
    "max_total_samples": 0,      # cap on the train set (0 = none)
    # model_args
    "model": "lr",
    "precision": "float32",      # or "bfloat16" for the compute path
    # fused conv->GN->residual->ReLU block for the <= 64-channel ResNet
    # stages: true/pallas = the hand-written CUDA kernel, reference = the
    # same math in plain PyTorch. A mode string; bools work too
    "fused_conv_block": "",
    # train_args
    "federated_optimizer": "FedAvg",
    "client_num_in_total": 8,
    "client_num_per_round": 8,
    "comm_round": 10,
    "epochs": 1,
    "batch_size": 32,
    "client_optimizer": "sgd",
    "learning_rate": 0.03,
    "weight_decay": 0.0,
    "momentum": 0.0,
    "server_optimizer": "sgd",
    "server_lr": 1.0,
    "server_momentum": 0.9,
    "fedprox_mu": 0.1,
    "feddyn_alpha": 0.01,
    "sampling_stream": "legacy",
    # fold the sampled clients into the batch axis (optimizers that
    # evaluate shared params only: FedSGD); refuses any other optimizer
    "client_slot_fold": False,
    # rounds run between two device -> host reads (the GPU engine's block)
    "rounds_per_dispatch": 8,
    # the defended round: auto/fused = no read-back inside a block on the
    # one-card sharded kernels, host = a verdict read after every round
    "robust_fused": "auto",
    # false/host forces FedMLDefender's host kernels (robust_fused: host)
    "sharded_defense": "auto",
    # security_args / dp_args (the other knobs, e.g. byzantine_client_num,
    # krum_param_m, dp_type, dp_epsilon, are read where they are used,
    # with the JAX package's defaults)
    "enable_attack": False,
    "attack_type": None,
    "enable_defense": False,
    "defense_type": None,
    "rfa_iters": 8,              # Weiszfeld iterations for the RFA defense
    # rfa_tol > 0: stop once the estimate moves less than this (rfa_iters
    # becomes a budget)
    "rfa_tol": 0.0,
    "enable_dp": False,
    "dp_mechanism": "gaussian",
    "enable_dp_ldp": False,
    # quantize the fused robust path's [K, D] update matrix before the
    # attack and the defense: int8 rows with per-row scales, or a bf16
    # round trip (None keeps it f32)
    "robust_relayout_quant": None,
    # chaos_args: seeded availability faults (core/chaos); all off
    "chaos_seed": None,              # falls back to random_seed
    "chaos_dropout_prob": 0.0,       # per-(round, client) dropout
    "chaos_straggler_prob": 0.0,     # per-(round, client) straggler
    "chaos_straggler_work": 0.5,     # fraction of local work a straggler runs
    "chaos_crash_at_round": None,    # raise ChaosCrash after this round
    # link faults at the cross-silo Message send seam (the transport
    # interceptor, core/chaos/interceptor.py)
    "chaos_link_loss_prob": 0.0,     # per-message loss
    "chaos_link_dup_prob": 0.0,      # per-message duplication
    "chaos_link_delay_prob": 0.0,    # per-message delay probability
    "chaos_link_delay_s": 0.0,       # delay applied when it fires
    # dropped clients leave the weighted average's denominator (off: their
    # scheduled weight stays and dilutes the aggregate)
    "chaos_tolerance": True,
    # sample ceil(client_num_per_round * (1 + frac)) clients
    "chaos_over_sample": 0.0,
    # selection_args (core/selection); the defaults are uniform selection
    # on the sampling stream, bit-identical schedules
    "client_selection": "uniform",   # uniform|power_of_choice|oort|reputation
    # size the cohort from the observed Beta-posterior dropout rate,
    # capped at (1 + selection_max_over_sample) * client_num_per_round
    "selection_adaptive_oversample": False,
    "selection_max_over_sample": 1.0,
    "selection_loss_window": 8,      # last-K training losses per client
    "selection_ema_alpha": 0.2,      # latency / work-fraction EMA weight
    "selection_rep_threshold": 0.3,  # reputation below this is benched
    "selection_min_keep_frac": 0.5,  # never bench past this cohort share
    "poc_d_factor": 2.0,             # power-of-choice candidate multiplier
    "oort_explore_frac": 0.1,        # cohort fraction exploring new clients
    "oort_alpha": 2.0,               # system-utility latency exponent
    "oort_pref_latency_s": 0.0,      # 0 = observed median latency
    # pacer-driven cohort sizing of the SP loop (grow k when the cohort's
    # summed loss utility saturates)
    "pacer_adapt_cohort": False,
    "pacer_util_window": 4,          # rounds per utility comparison window
    "pacer_util_saturation": 0.05,   # relative improvement below = plateau
    "pacer_min_cohort_scale": 1.0,   # k multiplier bounds
    "pacer_max_cohort_scale": 4.0,
    # cross-device (cross_device/): the device's trainer engine (torch;
    # "jax" names the same engine; native = the C++ core) and its uplink
    # artifacts' wire compression (None = dense, byte-identical)
    "device_engine": "torch",
    "device_wire_compression": None,
    # the durable multi-tenant fleet plane (core/fleet): a sqlite registry
    # path (None = in-memory only), this server's task name in it (None =
    # "train" for the FL server, "fa" for the analytics server), and the
    # per-device participation cap in a trailing window (0 = uncapped)
    "fleet_registry": None,
    "fleet_task_id": None,
    "fleet_max_rounds_per_window": 0,
    "fleet_fairness_window_s": 3600.0,
    # contribution assessment: loo | gtg (None = off)
    "contribution_method": None,
    "shapley_max_perms": 20,         # GTG-Shapley permutation budget
    # async_args: buffered-async rounds (core/async_rounds, FedBuff +
    # FedAsync staleness decay); `sync` keeps the round barrier
    "round_mode": "sync",            # sync | async_buffered
    "async_buffer_k": 0,             # pour trigger; 0 = half the cohort
    "async_alpha": 0.6,              # FedAsync mixing rate for each pour
    "async_staleness_weighting": "polynomial",  # constant|polynomial|hinge
    "async_staleness_poly": 0.5,     # poly decay exponent / hinge slope
    "async_hinge_b": 4,              # hinge: free staleness up to b versions
    # staleness clamp before weighting (stale uploads are down-weighted,
    # never dropped); 0 = adaptive from observed arrival-rate posteriors
    "async_staleness_cap": 16,
    # the JAX package's cross-silo pour valve (its async cross-silo
    # server is not ported)
    "async_pour_timeout_s": 0.0,
    # simulated-arrival heterogeneity (async engine + SP Async_FedAvg)
    "async_duration_sigma": 0.6,
    # validation_args
    "frequency_of_the_test": 5,
    # comm_args (the cross-silo transports: INPROC | TCP | GRPC; a WAN
    # session with any other backend value runs over GRPC, as in the JAX
    # package)
    "backend": "gpu",
    # wire-efficiency for cross-silo updates (utils/compression.py). Off by
    # default: the wire stays byte-identical to the dense float32 path.
    "comm_compression": None,            # topk|randk|qsgd|topk_qsgd|randk_qsgd
    "comm_compression_ratio": 0.1,       # sparsifier keep-ratio in (0, 1]
    "comm_quantize_levels": 127,         # QSGD levels (int8 wire, <= 127)
    "comm_compression_broadcast": "full",  # server->client: full|bf16|compress
    # stats-driven per-round keep-ratio (core/wire/adaptive); bounds default
    # to [ratio / 4, ratio]
    "comm_compression_adaptive": False,
    "comm_compression_ratio_min": None,
    "comm_compression_ratio_max": None,
    "comm_compression_latency_budget_s": None,  # uplink s == full pressure
    # secure aggregation (federated_optimizer SA / LSA): SA's field lanes
    # (0 = dense field; 4 | 8 | 16-bit lanes) and their round-0 clip
    # (auto-scaled after); the Shamir threshold (0 = a majority); LSA's
    # privacy parameter and decode threshold (0 = n - 1)
    "secagg_compress_bits": 0,
    "secagg_compress_clip": 4.0,
    "secagg_threshold": 0,
    "lsa_privacy_t": 1,
    "lsa_threshold": 0,
    # comm retry policy (exponential backoff + jitter at the transport
    # send seam; 0 attempts = fail fast); deadline_s caps the total retry
    # budget in wall seconds (0 = attempt count only)
    "comm_retry_max_attempts": 4,
    "comm_retry_base_s": 0.2,
    "comm_retry_max_s": 2.0,
    "comm_retry_deadline_s": 0.0,
    # cross-silo: a timed-out round aggregates only if at least
    # ceil(frac * expected) silos reported
    "round_quorum_frac": 0.0,
    # cross-silo data-index assignment: legacy round-robin | scored
    "silo_index_assignment": "legacy",
    # tracking_args (core/mlops.init): the run's JSONL record file
    "enable_tracking": True,     # master switch for the JSONL sink
    "log_file_dir": "~/.cache/fedml_tpu/logs",
    "log_server_url": None,      # remote log shipper endpoint (log_daemon)
    "sys_perf_profiling": False,  # host/device sampler thread (mlops)
    # obs_args (core/obs.configure): spans and the metrics registry are
    # on by default; the snapshot cadence in rounds and in wall seconds
    # (0 = off)
    "obs_tracing": True,
    "obs_metrics": True,
    "obs_metrics_flush_rounds": 10,
    "obs_metrics_flush_s": 60.0,
    # host/device split + per-round MFU at the engine's dispatch seam
    # (waits for the device at every block's end)
    "obs_profile_device": False,
    # per-program roofline capture (core/obs/roofline.py)
    "obs_roofline": False,
    # accepted and inert, as in the JAX package (secure aggregation is
    # federated_optimizer SA / LSA; core/fhe.FedMLFHE reads enable_fhe)
    "enable_secure_agg": False,
    "enable_fhe": False,
    # checkpoint/artifact args
    "save_model_path": None,     # persist final params (serving artifact)
    "checkpoint_dir": None,      # round checkpoints (with the codec)
    "checkpoint_every_rounds": 0,  # 0 = off
    # federated-LoRA adapter export: after run_federated_llm, write the
    # global + per-silo personalized adapters as named artifacts the
    # serving adapter bank loads (None = off)
    "llm_adapter_export_dir": None,
    "llm_adapter_personalize_steps": 4,
    # serving_args (serving/llm_template.from_artifact + serving/batch)
    "llm_serving_mode": "single",      # single | batch
    "serving_slots": 8,                # in-flight decode slots
    "serving_kv_block_size": 16,       # must divide llm_max_seq_len
    "serving_prefill_chunk": 32,
    "serving_max_adapters": 64,        # adapter-bank capacity
    "serving_deadline_s": 0.0,         # per-request decode deadline (0=off)
    "serving_request_timeout_s": 120.0,
    "serving_watchdog_s": 30.0,        # stall/NaN watchdog (0 = off)
    "serving_flight_records": 256,
    "serving_flight_dir": None,
    "serving_max_resets": 3,
    "serving_reset_window_s": 300.0,
    "serving_max_requeues": 2,
    "serving_preempt_after_s": 0.0,
    "serving_shed_queue_depth": 0,     # load shedding (0 = off)
    # chaos_serving_* — seeded serving-plane fault injection (core/chaos
    # serving kinds; all off). *_prob knobs draw per index from the
    # (chaos_seed, kind, index) stream; *_at_step / *_at_request are the
    # single-shot variants
    "chaos_serving_stall_prob": 0.0,     # per-decode-step stall draw
    "chaos_serving_stall_s": 0.0,        # injected stall length
    "chaos_serving_stall_at_step": None,  # stall exactly at this step
    "chaos_serving_nan_prob": 0.0,       # per-step NaN-logit poison draw
    "chaos_serving_nan_at_step": None,   # poison exactly at this step
    "chaos_serving_conn_drop_prob": 0.0,  # gateway->replica connect drop
    "chaos_serving_crash_at_request": None,  # replica dies on request N
    "llm_prefix_cache": False,
    "llm_prefill_batch": 0,
    "llm_suffix_cache": False,
    "llm_stream": False,               # SSE on /v1/chat/completions
    "llm_adapter_dir": None,           # adapter-bank manifest dir to serve
    # poll llm_adapter_dir every this many seconds and hot-swap changed
    # exports (0 = off)
    "llm_adapter_watch_s": 0.0,
}


class Arguments:
    """Flat config namespace. Known keys get defaults from ``_SCHEMA``;
    unknown keys are attached as-is."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 **overrides: Any):
        for key, default in _SCHEMA.items():
            setattr(self, key, default)
        merged: Dict[str, Any] = {}
        if config:
            merged.update(_flatten_sections(config))
        merged.update(overrides)
        for key, value in merged.items():
            setattr(self, key, _coerce(key, value))
        self._finalize()

    def _finalize(self) -> None:
        backend = str(getattr(self, "backend", "gpu")).lower()
        self.backend = FEDML_SIMULATION_BACKEND_ALIASES.get(backend, backend)
        if self.client_num_per_round > self.client_num_in_total:
            self.client_num_per_round = self.client_num_in_total
        for key in ("data_cache_dir", "log_file_dir", "checkpoint_dir"):
            val = getattr(self, key, None)
            if isinstance(val, str):
                setattr(self, key, os.path.expanduser(val))

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def __repr__(self) -> str:
        keys = sorted(self.to_dict())
        return "Arguments(" + ", ".join(
            f"{k}={getattr(self, k)!r}" for k in keys) + ")"


_SECTION_SUFFIX = "_args"


def _flatten_sections(config: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten ``{section_args: {k: v}}`` into ``{k: v}``; later sections
    win on duplicate keys."""
    flat: Dict[str, Any] = {}
    for key, value in config.items():
        if key.endswith(_SECTION_SUFFIX) and isinstance(value, dict):
            flat.update(value)
        else:
            flat[key] = value
    return flat


def _coerce(key: str, value: Any) -> Any:
    default = _SCHEMA.get(key)
    if default is None or value is None:
        return value
    ty = type(default)
    if isinstance(value, ty):
        return value
    try:
        if ty is bool and isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return ty(value)
    except (TypeError, ValueError):
        return value


def load_arguments(config_path: Optional[str] = None, rank: int = 0,
                   role: Optional[str] = None, **overrides: Any) -> Arguments:
    """Load a YAML config (if given) into a flat :class:`Arguments`."""
    config: Dict[str, Any] = {}
    if config_path:
        with open(config_path, "r") as f:
            config = yaml.safe_load(f) or {}
    args = Arguments(config, **overrides)
    args.rank = rank
    if role is not None:
        args.role = role
    return args


def add_args() -> argparse.Namespace:
    """Bootstrap CLI flags (``--cf <yaml>``)."""
    parser = argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument("--cf", "--config_file", dest="yaml_config_file",
                        type=str, default=None, help="yaml configuration file")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    parser.add_argument("--run_id", type=str, default="0")
    known, _ = parser.parse_known_args()
    return known

