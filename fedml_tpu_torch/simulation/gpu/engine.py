"""The GPU simulator: FL rounds on one CUDA device (counterpart of
``fedml_tpu/simulation/tpu/engine.py``, ``TPUSimulator``: the round core,
``run_rounds_fused``, ``run``'s block loop, ``round_cost_flops`` and the
``_traced`` dispatch seam).

The JAX package runs a block of rounds as one SPMD program: a ``lax.scan``
over rounds, over each chip's schedule slots and over a ``while_loop`` of
local steps, a weighted ``psum`` over the ``client`` mesh axis and the
server transform. On one card the psum is the identity, so a round here
is: each sampled client in schedule order trains from the global params
and its own row of the per-client state (its key is ``fold_in(round_key,
client_id)``, the JAX engine's ``gcid``); its update and its extras are
accumulated weighted by the client's weight and its new state is written
back to its row; both sums are divided by ``max(Σw, 1e-12)`` and
``server_update`` applies them with the round index.

``client_states`` holds the optimizer's per-client state (SCAFFOLD's
``c_i``, FedDyn's ``h_i``) as one stacked tensor ``[num_clients, ...]`` per
leaf on the device; a client that sits out a round keeps its row.

``client_slot_fold`` (optimizers that declare ``folds_client_slots``:
FedSGD) folds every sampled client into the batch axis: one full-batch
pass over ``[n_batches, n_sampled * batch_size]`` replaces the per-client
passes (the JAX engine folds each chip's slots; one card folds them all).

What stands for the one dispatch: every local step is a replay of one CUDA
graph (``core/algframe/local_training.py::StepProgram``), captured once per
run, and a block of rounds reads nothing back from the device until it
ends. Blocks hold at most ``rounds_per_dispatch`` rounds and end at every
eval round and every checkpoint round; ``frequency_of_the_test <= 0``
(timing mode) evaluates nothing, in the loop or after it.

Privacy and robustness act between the local steps and the server step,
outside the captured step (the program and its key do not change):

* DP (``enable_dp``, ``dp_type``): under LDP and NbAFL each sampled
  client's update is clipped and noised (key ``fold_in(client_key,
  DP_LDP_FOLD)``), under CDP it is clipped; under CDP and NbAFL the
  aggregate is noised (``fold_in(round_key, DP_CDP_FOLD)``). The
  accountant records every round, and ``run`` returns
  ``dp_epsilon_spent``.
* A data attack poisons the byzantine clients' host arrays before they
  move to the device (``simulation/poisoning.py``).
* Robust mode (a model attack or a defense): each sampled client's update
  is written, in sampled order, into row k of a preallocated ``[K, D]``
  float32 matrix on the device, in the JAX package's flat layout
  (``core/collectives.py::FlatLayout``). Then come the model attack
  (``ATTACK_FOLD``), the defense (``DEFENSE_FOLD``) with its cross-round
  state on the device, CDP and ``server_update``. ``robust_fused``:
  ``auto``/``fused`` run the one-card kernels of
  ``core/security/defense/sharded.py`` and read nothing back across a
  block but the stacked ``[K]`` verdicts at its end; ``host`` runs each
  round as its own block and reads its verdict back, through the same
  kernels or, with ``sharded_defense: false``, the ``FedMLDefender`` host
  kernels. An attack with no defense runs on the host path, as in JAX.
  The verdicts land in ``self.verdicts`` and in the selection store.
  Contribution assessment (``contribution_method``) and a user
  ``ServerAggregator`` put the run in robust mode too: contribution reads
  the post-attack matrix (a contribution-only run fuses through the
  ``mean`` kernel, in rounds of one); the aggregator's hooks aggregate on
  the host path, unless a defense is configured. ``robust_relayout_quant``
  rounds the fused path's matrix (int8 rows, or bf16) before the attack.

Chaos and selection are host-side policy riding the rounds as data. Each
round's cohort comes from ``core/selection`` (uniform by default: the
sampling stream's draw), every round of a block chosen before the block
runs; each client's work fraction from ``core/chaos``'s plan (0 for a
dropped or benched client) sets how many times it replays the captured
step. The per-client losses selection reads stay on the device, queued,
until the next selection query. ``chaos_crash_at_round`` raises
``ChaosCrash`` after the round's record and flushed checkpoint.

Round checkpoints (``checkpoint_dir`` / ``checkpoint_every_rounds``,
``core/checkpoint.py``) hold ``params``, ``server_state``, the round
``rng``, under DP the accountant's state (``dp``), for an optimizer with
per-client state ``client_states``, for a stateful defense on the
device its ``defense_state`` and for a tracking selection strategy its
store (``selection``): the part of the JAX engine's checkpoint state this
engine has. ``run`` resumes from the newest one at the round after it; a
checkpoint without an optional leaf restores without it (with a
warning), that state then starts cold.

The compute plane (``core/obs/roofline.py``) sits at the ``_traced``
seam: every block's signature (the params', server state's and data's
shapes) feeds recompile forensics, where a block that built a new step
program past the first (on a card: a new CUDA-graph capture) emits a
``kind: recompile`` record naming what changed; under ``obs_roofline``
each program the block ran is captured once per signature after it, its
rows multiplied by the steps it ran in the block.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import (METRICS, GradProgram,
                                             StepProgram, batch_real_of,
                                             evaluate)
from ...core.algframe.types import ClientData, Params, TrainHyper
from ...core.chaos import ChaosCrash, FaultLedger, FaultPlan
from ...core.checkpoint import RoundCheckpointer
from ...core.collectives import (FlatLayout, WeightedSum, stack_trees,
                                 tree_copy_, tree_leaves, tree_map,
                                 weighted_mean)
from ...core.contribution import ContributionAssessorManager
from ...core.dp import FedMLDifferentialPrivacy
from ...core.obs import profiler as obs_profiler
from ...core.obs import roofline as obs_roofline
from ...core.obs import sink as obs_sink
from ...core.obs import trace as obs_trace
from ...core.security import FedMLAttacker, FedMLDefender
from ...core.security.defense import robust_agg, verdict_from_info
from ...core.security.defense import sharded as sharded_defense
from ...core.selection import SelectionManager, slot_placement

logger = logging.getLogger(__name__)

# PRNG fold tags of the DP noise, attack and defense streams (the JAX
# engine's, shared with the SP golden loop)
DP_LDP_FOLD = 999983
DP_CDP_FOLD = 999979
ATTACK_FOLD = 1000003
DEFENSE_FOLD = 1000033


def check_extras_compat(opt, params, dp, robust_mode: bool) -> None:
    """Optimizers whose extras ride the aggregation (SCAFFOLD delta_c, Mime
    full-batch grads, FedNova a_i) leak through side channels that LDP noise
    and robust defenses do not cover — combining them would silently void
    the privacy/robustness guarantee, so refuse loudly."""
    if not tree_leaves(opt.server_extras_zero(params)):
        return
    if dp.is_dp_enabled():
        raise ValueError(
            f"{opt.name}: DP cannot cover this optimizer's extras (they "
            "would be aggregated un-noised and leak client data); use a "
            "stateless-extras optimizer (FedAvg/FedProx/FedOpt/FedDyn) "
            "with DP.")
    if robust_mode:
        raise ValueError(
            f"{opt.name}: robust aggregation defends only model updates; "
            "this optimizer's extras would bypass the defense. Use a "
            "stateless-extras optimizer (FedAvg/FedProx/FedOpt/FedDyn) "
            "with attacks/defenses.")


def dp_client_update(dp: FedMLDifferentialPrivacy, update: Params,
                     client_key: np.ndarray) -> Params:
    """A client's update as DP sends it: clipped and noised under LDP and
    NbAFL, clipped under CDP."""
    if dp.is_local_dp_enabled():
        return dp.add_local_noise(update, prng.fold_in(client_key,
                                                       DP_LDP_FOLD))
    if dp.is_global_dp_enabled():
        return dp.clip_update(update)
    return update


def dp_server_noise(dp: FedMLDifferentialPrivacy, agg: Params,
                    round_key: np.ndarray) -> Params:
    """The aggregate as CDP and NbAFL apply it."""
    if dp.is_global_dp_enabled():
        return dp.add_global_noise(agg, prng.fold_in(round_key, DP_CDP_FOLD))
    return agg


def host_robust_aggregate(attacker: FedMLAttacker, defender: FedMLDefender,
                          mat: torch.Tensor, w: torch.Tensor, sampled,
                          round_key: np.ndarray, server_aggregator=None,
                          assess: Optional[Callable] = None):
    """The host kernels' attack -> defense on the round's ``[K, D]``
    matrix (the SP golden loop's ``_aggregate_robust``, and the engine's
    host path): ``(aggregate [D], [K] verdict or None)``. ``assess(mat)``
    sees the post-attack matrix (contribution assessment). With no
    defense, a user ``ServerAggregator``'s hook chain aggregates, else the
    weighted mean."""
    ids = np.asarray(sampled)
    if attacker.is_model_attack():
        mat = attacker.poison_updates(mat, ids,
                                      prng.fold_in(round_key, ATTACK_FOLD))
    if assess is not None:
        assess(mat)
    if defender.is_defense_enabled():
        vec, info = defender.defend_matrix(
            mat, w, prng.fold_in(round_key, DEFENSE_FOLD), ids)
        return vec, verdict_from_info(info, len(ids))
    if server_aggregator is not None:
        # the user hook chain (reference server_aggregator.py :44/:75/:90)
        mat2, w2 = server_aggregator.on_before_aggregation(mat, w)
        return server_aggregator.on_after_aggregation(
            server_aggregator.aggregate(mat2, w2)), None
    return robust_agg.weighted_mean(mat, w), None


def assess_contribution(manager: ContributionAssessorManager, spec,
                        layout: FlatLayout, params: Params,
                        test: Dict[str, torch.Tensor], mat: torch.Tensor,
                        w: torch.Tensor, sampled, round_idx: int) -> None:
    """Contribution of the round's clients from its post-attack ``[K, D]``
    matrix (both simulators): a coalition's value is the eval accuracy of
    the round-start ``params`` plus the masked weighted mean of its rows,
    one function on the matrix's device for every coalition; each value
    is one scalar read."""
    def eval_fn(p):
        stats = evaluate(spec, layout.unflatten(p["v"], like=params),
                         test["x"], test["y"], test["mask"])
        return stats["correct"] / torch.clamp(stats["count"], min=1.0)

    manager.assess({"v": layout.flatten(params)}, {"v": mat}, w, eval_fn,
                   client_ids=list(sampled), round_idx=round_idx)


def quantize_rows(mat: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """The JAX engine's quantized relayout of the ``[K, D]`` matrix, as
    the rows come out of it (``robust_relayout_quant``). On one card the
    ``all_to_all`` moving the rows is the identity; what stays is the
    rounding the defense sees: ``int8`` rows with per-row float32 scales
    ``where(amax > 0, amax, 1) / 127`` (round half to even, then
    ``q * scale``), or a bfloat16 round trip. None returns ``mat``."""
    if mode == "bf16":
        return mat.to(torch.bfloat16).to(torch.float32)
    if mode == "int8":
        amax = torch.amax(torch.abs(mat), dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
        q = torch.round(mat / scale).to(torch.int8)
        return q.to(torch.float32) * scale
    return mat


class GPUSimulator:
    """FL simulation on one device: clients' data and per-client state
    resident on the device, clients trained one after another through one
    step program (and, for the optimizers that take a full-batch gradient,
    one gradient program).

    ``dispatch_stats``: ``dispatches`` (blocks run), ``captures`` (CUDA
    graphs captured; 1 per run on a card, 0 on the CPU), and the step
    programs' ``warmup_steps``, ``replays`` and ``capture_s``."""

    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None,
                 server_aggregator=None):
        # `round_mode: async_buffered` lives in the AsyncBufferedSimulator
        # subclass (simulation/gpu/async_engine.py); built directly, this
        # engine would silently run the sync barrier: refuse
        from ...core.async_rounds import round_mode_from_args
        if (round_mode_from_args(args) == "async_buffered"
                and type(self) is GPUSimulator):
            raise ValueError(
                "round_mode: async_buffered needs the "
                "AsyncBufferedSimulator — build via FedMLRunner / "
                "run_simulation (they dispatch on round_mode), or import "
                "fedml_tpu_torch.simulation.gpu.async_engine directly")
        self.args = args
        self.fed = fed_dataset
        self.bundle = bundle
        self.opt = optimizer
        self.spec = spec
        self.device = device
        self.server_aggregator = server_aggregator
        seed = int(getattr(args, "random_seed", 0))
        # the JAX engine splits PRNGKey(seed) into (init, round stream);
        # parameter init here draws from a torch.Generator instead, so only
        # the round stream is kept
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        n_clients = int(fed_dataset.num_clients)
        # chaos: each client's work fraction (0 dropped, (0, 1) straggler)
        # sets its local step count; chaos_tolerance picks the denominator
        self.chaos = FaultPlan.from_args(args)
        self.chaos_ledger = FaultLedger()
        self.chaos_tolerance = bool(getattr(args, "chaos_tolerance", True))
        # participant selection: passive at the default knobs (uniform
        # strategy on the sampling stream, nothing observed or saved)
        self.selection = SelectionManager(args, n_clients)
        if (self.selection.strategy_name == "reputation"
                and not self.chaos_tolerance):
            # benched clients ride the work-0 dropout channel, which only
            # leaves the denominator under tolerance
            raise ValueError(
                "client_selection: reputation requires chaos_tolerance "
                "(benched clients are renormalized out of the weighted "
                "average); with chaos_tolerance: false they would dilute "
                "every round's aggregate instead")
        over = float(getattr(args, "chaos_over_sample", 0.0) or 0.0)
        base_n = int(args.client_num_per_round)
        self._base_n = base_n
        # static over-sampling: extra clients so the post-dropout cohort
        # still hits the configured size in expectation
        self._static_n = min(n_clients,
                             int(np.ceil(base_n * (1.0 + max(over, 0.0)))))
        # the cohort cap: adaptive over-sampling sizes each round's draw
        # between base_n and this
        if self.selection.adaptive:
            cap = float(getattr(args, "selection_max_over_sample", 1.0)
                        or 0.0)
            self._sample_n = min(
                n_clients, int(np.ceil(base_n * (1.0 + max(cap, over,
                                                            0.0)))))
        else:
            self._sample_n = self._static_n
        self.attacker = FedMLAttacker(args)
        self.defender = FedMLDefender(args)
        self.dp = FedMLDifferentialPrivacy(args)
        if self.attacker.is_data_attack():
            from ..poisoning import poison_dataset
            fed_dataset = poison_dataset(fed_dataset, self.attacker)
            self.fed = fed_dataset
        # [clients, n_batches] host bools, read once here rather than from
        # the device every round
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self.train = fed_dataset.train.to(device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in fed_dataset.test.items()}
        if init_params is None:
            gen = torch.Generator().manual_seed(seed)
            self.params = bundle.init(gen, device)
        else:
            self.params = load_params(bundle, init_params, device)
        self.server_state = optimizer.server_init(self.params)
        self.client_states = (
            stack_trees(optimizer.client_state_init(self.params),
                        fed_dataset.num_clients)
            if optimizer.has_client_state else {})
        self.contribution = ContributionAssessorManager(args)
        defended = (self.attacker.is_model_attack()
                    or self.defender.is_defense_enabled())
        self.robust_mode = (defended or self.contribution.enabled
                            or server_aggregator is not None)
        if server_aggregator is not None and \
                self.defender.is_defense_enabled():
            logger.warning(
                "both a defense (%s) and a user ServerAggregator are "
                "configured: the defense takes precedence and the user "
                "aggregator is SKIPPED", self.defender.defense_type)
        check_extras_compat(optimizer, self.params, self.dp, defended)
        self.layout = FlatLayout.of(self.params)
        self._sharded = self._use_sharded_defense()
        self.robust_fused = self._resolve_robust_fused()
        if self.robust_fused and self.selection.adaptive:
            # the fused robust path stacks [K] verdicts across a block;
            # the cohort size stays constant there
            self.selection.pin_adaptive(
                "the fused robust program needs a constant [K] cohort "
                "shape (compile-once); use robust_fused: host for a "
                "per-round adaptive cohort under defenses")
            self._sample_n = self._static_n
        self._relayout_quant = self._resolve_relayout_quant()
        self.verdicts: Dict[int, Tuple[List[int], np.ndarray]] = {}
        self._mat: Optional[torch.Tensor] = None
        # a stateful defense on the device keeps its cross-round state
        # (foolsgold's history, cclip's momentum, ...) here, in the
        # checkpoint, and in place across the rounds of a block
        self._defense_state = None
        if (self._sharded
                and sharded_defense.is_stateful(self.defender.defense_type)):
            self._defense_state = sharded_defense.defense_state_init(
                self.defender.defense_type, int(fed_dataset.num_clients),
                self.layout.size, device)
        self._slot_fold = self._resolve_slot_fold()
        self.history: List[Dict[str, Any]] = []
        # one step program per (model, dtype, batch shape, inner optimizer,
        # optimizer transform); one gradient program per batch shape
        self.programs: Dict[Tuple, Any] = {}
        self.dispatch_stats: Dict[str, Any] = {"dispatches": 0,
                                               "captures": 0}
        # profiling plane (core/obs/profiler): opt-in host/device split and
        # per-round MFU at the dispatch seam; off by default because it
        # waits for the device at every block's end
        self._obs_profile = bool(getattr(args, "obs_profile_device", False))
        self._flops_per_round: Optional[float] = None
        # compute plane: always-on recompile forensics, opt-in roofline
        # capture (obs_roofline) of the programs a block runs
        self._roofline = obs_roofline.DispatchTracker(
            enabled=bool(getattr(args, "obs_roofline",
                                 obs_roofline.default_enabled())),
            device=device)
        self.ckpt = RoundCheckpointer(
            getattr(args, "checkpoint_dir", None),
            int(getattr(args, "checkpoint_every_rounds", 0) or 0))
        if (self.ckpt.enabled and self.defender.is_defense_enabled()
                and sharded_defense.is_stateful(self.defender.defense_type)
                and self._defense_state is None):
            logger.warning(
                "%s keeps cross-round state, but the host-kernel path "
                "does not checkpoint it — crash-resume restarts the "
                "defense state cold; use the default sharded path for "
                "checkpointed defense state", self.defender.defense_type)

    # -- checkpoints --------------------------------------------------------
    # leaves whose presence can flip between a save and a resume (a knob
    # set later): restored without them, loudly, rather than refused
    _OPTIONAL_CKPT_KEYS = ("selection", "defense_state")

    def ckpt_state(self) -> Dict[str, Any]:
        st = {"params": self.params, "server_state": self.server_state,
              "rng": self.rng}
        if self.dp.is_dp_enabled():
            # the accountant's RDP: a resumed run reports the epsilon of
            # every round, not of the rounds since the resume
            st["dp"] = self.dp.state_dict()
        if self.opt.has_client_state:
            st["client_states"] = self.client_states
        if getattr(self, "_defense_state", None) is not None:
            st["defense_state"] = self._defense_state
        if self.selection.stateful:
            # the observed history the strategies select from: a resumed
            # run selects the cohorts the uninterrupted one does
            st["selection"] = self.selection.state_dict()
        return st

    def restore(self) -> int:
        """Load the newest checkpoint, if any; returns the round to start
        at. A checkpoint written without an optional leaf
        (``_OPTIONAL_CKPT_KEYS``: the knob was set later) restores
        without it, loudly: that state then starts cold. A step program
        built before this (``capture_step``) takes the restored params at
        its next client: it copies the start params into its own tensors
        then."""
        restored = self._ckpt_latest()
        if restored is None:
            return 0
        step, st = restored
        self._load_ckpt_state(st)
        logger.info("resumed from checkpoint at round %d", step)
        return step + 1

    def _ckpt_latest(self):
        """The newest checkpoint as ``(step, state)`` or None, retried
        without the optional leaves it lacks."""
        template = self.ckpt_state()
        opts = [k for k in self._OPTIONAL_CKPT_KEYS if k in template]
        # least state lost first: the full template, each optional leaf
        # dropped alone, then all of them
        candidates = [()] + [(k,) for k in opts]
        if len(opts) > 1:
            candidates.append(tuple(opts))
        restored, err = None, None
        for drop in candidates:
            try:
                restored = self.ckpt.latest(
                    {k: v for k, v in template.items() if k not in drop})
            except ValueError as e:
                err = e
                continue
            if drop and restored is not None:
                logger.warning(
                    "checkpoint restore succeeded only without the %s "
                    "leaf (%s) — that state resumes cold", "/".join(drop),
                    err)
            break
        else:
            raise err
        return restored

    def _load_ckpt_state(self, st: Dict[str, Any]) -> None:
        self.params, self.server_state = st["params"], st["server_state"]
        self.rng = st["rng"]
        if "dp" in st:
            self.dp.load_state_dict(st["dp"])
        if self.opt.has_client_state:
            self.client_states = st["client_states"]
        if "defense_state" in st:
            self._defense_state = st["defense_state"]
        if "selection" in st:
            self.selection.load_state_dict(st["selection"])

    # -- the local step -----------------------------------------------------
    def step_program(self, hyper: TrainHyper) -> StepProgram:
        """The step program for this run's model, compute dtype, batch
        shape, inner optimizer and optimizer transform; built at first use,
        captured into a CUDA graph at its first client on a card."""
        inner = self.opt.make_inner_opt(hyper)
        x = self.train.x
        key = (getattr(self.bundle, "name", None),
               getattr(self.bundle, "compute_dtype", None),
               tuple(x.shape[2:]), x.dtype, inner.key,
               self.opt.transform_key)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.opt.make_step_program(
                self.params, self.server_state, self.train.client(0), hyper)
            self.programs[key] = prog
        return prog

    def grad_program(self, cdata: ClientData) -> GradProgram:
        """The full-batch gradient program for ``cdata``'s batch shape
        (a client's, or the folded round's wider one)."""
        key = ("grad", getattr(self.bundle, "name", None),
               getattr(self.bundle, "compute_dtype", None),
               tuple(cdata.x.shape[1:]), cdata.x.dtype)
        prog = self.programs.get(key)
        if prog is None:
            prog = GradProgram(self.spec, self.params, cdata)
            self.programs[key] = prog
        return prog

    def capture_step(self, hyper: TrainHyper) -> float:
        """Build the programs a round runs now (warm them up and capture
        them on a card), so their one-time cost falls outside a timed
        block. Returns the seconds that took."""
        t0 = time.perf_counter()
        if self._slot_fold:
            folded = self._fold(range(int(self.args.client_num_per_round)))
            self.grad_program(folded).prepare(self.params, folded)
        else:
            self.opt.prepare_programs(
                self, self.params, self.server_state,
                tree_map(lambda a: a[0], self.client_states),
                self.train.client(0), hyper)
        self._update_program_stats()
        return time.perf_counter() - t0

    def _update_program_stats(self) -> None:
        progs = self.programs.values()
        for k in ("captures", "warmup_steps", "replays", "capture_s"):
            self.dispatch_stats[k] = sum(getattr(p, k) for p in progs)

    def _resolve_slot_fold(self) -> bool:
        """``client_slot_fold``: folding is exact only when every sampled
        client evaluates the SHARED params and nothing downstream needs
        per-client updates; refuse loudly otherwise, naming every reason
        (a silent fallback would misreport the measured mode): an
        optimizer with per-client trajectories, robust mode (it needs the
        per-client update matrix), DP (it clips and noises per-client
        updates) and a selection strategy that reads per-client
        metrics."""
        pref = getattr(self.args, "client_slot_fold", False)
        if not pref or str(pref).lower() in ("false", "0", "no", "none",
                                             "off"):
            return False
        reasons = []
        if not getattr(self.opt, "folds_client_slots", False):
            reasons.append(
                f"optimizer {type(self.opt).__name__} runs per-client "
                "local trajectories (only optimizers declaring "
                "folds_client_slots=True, e.g. FedSGD, evaluate shared "
                "params on a sample-additive objective)")
        if self.robust_mode:
            reasons.append("robust mode needs the per-client update stack")
        if self.dp.is_local_dp_enabled() or self.dp.is_global_dp_enabled():
            reasons.append("DP clips/noises per-client updates")
        if self.selection.track:
            reasons.append("the selection strategy consumes per-slot "
                           "metrics, which a folded pass cannot produce")
        if reasons:
            raise ValueError(
                "client_slot_fold: this config cannot fold client slots "
                "into the batch axis: " + "; ".join(reasons))
        return True

    # -- robust mode --------------------------------------------------------
    def _resolve_robust_fused(self) -> bool:
        """``robust_fused``: ``auto`` (default) runs the defended round on
        the one-card sharded kernels with no read-back inside a block
        whenever a defense is configured and ``sharded_defense`` is not
        off, or the run is contribution-only (the ``mean`` kernel
        aggregates); ``host`` reads the verdict back after every round;
        ``fused`` demands the first and refuses a config that cannot have
        it (an attack with no defense, ``sharded_defense: false``, a user
        ``ServerAggregator``)."""
        pref = str(getattr(self.args, "robust_fused", "auto")
                   or "auto").lower()
        if pref in ("false", "0", "no", "host"):
            if self.robust_mode:
                logger.info("robust rounds take the HOST-dispatch path: "
                            "robust_fused: %r", pref)
            return False
        ok = self.robust_mode and (self._sharded
                                   or self._fusable_without_defense())
        if pref in ("true", "1", "yes", "fused") and self.robust_mode \
                and not ok:
            raise ValueError(
                "robust_fused: this config cannot fuse the robust round "
                "(it needs the sharded defense path — no user "
                "ServerAggregator, sharded_defense not forced off); use "
                "robust_fused: auto or host")
        return ok

    def _fusable_without_defense(self) -> bool:
        """A contribution-only robust run (no defense, no model attack, no
        user aggregator) fuses through the ``mean`` kernel."""
        return (self.contribution.enabled
                and not self.defender.is_defense_enabled()
                and not self.attacker.is_model_attack()
                and self.server_aggregator is None)

    def _use_sharded_defense(self) -> bool:
        """The sharded kernels are the default whenever a defense is
        configured; ``sharded_defense: false`` forces the host kernels,
        and so does a user ``ServerAggregator`` (it takes the host-ordered
        matrix)."""
        if not self.defender.is_defense_enabled():
            return False
        pref = str(getattr(self.args, "sharded_defense", "auto")
                   or "auto").lower()
        if pref in ("false", "0", "no", "host"):
            logger.info("robust rounds take the HOST-dispatch path: "
                        "sharded_defense: %r forces the host kernels", pref)
            return False
        if self.server_aggregator is not None:
            logger.info("robust rounds take the HOST-dispatch path: a user "
                        "ServerAggregator consumes the host-ordered update "
                        "matrix")
            return False
        return sharded_defense.supports_sharded(self.defender.defense_type)

    def _resolve_relayout_quant(self) -> Optional[str]:
        """``robust_relayout_quant`` -> None | 'int8' | 'bf16'. Only the
        fused robust path quantizes its matrix (the JAX engine's quantized
        ``all_to_all``); on the host path the knob warns and stays off."""
        pref = getattr(self.args, "robust_relayout_quant", None)
        if pref is None or str(pref).lower() in ("none", "off", "false",
                                                 "0", ""):
            return None
        mode = str(pref).lower()
        if mode == "bfloat16":
            mode = "bf16"
        if mode not in ("int8", "bf16"):
            raise ValueError(
                f"unknown robust_relayout_quant {pref!r} "
                "(none|int8|bf16)")
        if self.robust_mode and not self.robust_fused:
            logger.warning(
                "robust_relayout_quant: %s requested but the robust path "
                "is host-dispatch (robust_fused off) — the dense f32 "
                "matrix is kept; use robust_fused: auto/fused for the "
                "quantized rows", mode)
            return None
        return mode

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device. On a card it goes through
        pinned memory: a copy from pageable memory would first wait for
        everything queued on the card, ending the block's overlap of host
        and device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _matrix(self, k: int) -> torch.Tensor:
        """The round's ``[K, D]`` update matrix, allocated once per run."""
        if self._mat is None or self._mat.shape[0] != k:
            self._mat = torch.empty((k, self.layout.size),
                                    dtype=torch.float32, device=self.device)
        return self._mat

    def _defend(self, mat: torch.Tensor, w: torch.Tensor, sampled,
                round_key: np.ndarray, assess: Optional[Callable] = None):
        """Attack -> defense on the round's matrix: ``(aggregate [D],
        [K] verdict or None)``; ``assess(mat)`` sees the post-attack
        matrix. On the one-card kernels (the fused path, or a defense on
        the sharded kernels) the verdict stays on the device, and the
        fused path first rounds the rows as ``robust_relayout_quant``
        says; the host kernels' verdict comes back as numpy."""
        if not (self._sharded or self.robust_fused):
            return host_robust_aggregate(
                self.attacker, self.defender, mat, w, sampled, round_key,
                server_aggregator=self.server_aggregator, assess=assess)
        mat = quantize_rows(mat, self._relayout_quant)
        ids = self._to_device(np.asarray(sampled, np.int64))
        if self.attacker.is_model_attack():
            byz = self._to_device(self.attacker.byzantine_mask(sampled))
            mat = sharded_defense.apply_attack(
                self.attacker.attack_type, mat, byz,
                prng.fold_in(round_key, ATTACK_FOLD),
                self.attacker.attack_scale)
        if assess is not None:
            assess(mat)
        # a contribution-only run aggregates with the mean kernel
        defense = (self.defender.defense_type
                   if self.defender.is_defense_enabled() else "mean")
        vec, state, verdict = sharded_defense.defend_shard_stateful(
            mat, w, defense,
            sharded_defense.DefenseHP.from_defender(self.defender),
            state=self._defense_state, ids=ids,
            key=prng.fold_in(round_key, DEFENSE_FOLD))
        if self._defense_state is not None:
            self._defense_state = state
        return vec, verdict

    # -- chaos and selection ------------------------------------------------
    def _schedule_for(self, round_idx: int) -> Tuple[List[int], List[float]]:
        """The round's cohort and each client's work fraction (the JAX
        engine's ``_schedule_for`` on one device): the strategy draws
        ``round_target`` clients; a chaos-dropped or reputation-benched
        client gets work 0, a straggler ``chaos_straggler_work``, the rest
        1. Records the schedule in the selection store and the fault
        ledger. Reads nothing from the device but the store's queue."""
        # adaptive sizing replaces the static chaos_over_sample factor:
        # its base is the raw per-round target
        base = (self._base_n if self.selection.adaptive
                else self._static_n)
        target_n = self.selection.round_target(round_idx, base,
                                               self._sample_n)
        sampled, excluded = self.selection.select(round_idx, target_n)
        sampled = [int(c) for c in sampled]
        excl = set(int(c) for c in excluded)
        faults = (self.chaos.round_faults(round_idx, sampled)
                  if self.chaos.injects_availability else None)
        works = [0.0 if c in excl else
                 (faults.scale_for(c) if faults is not None else 1.0)
                 for c in sampled]
        self.selection.note_schedule(round_idx, sampled, excluded,
                                     dict(zip(sampled, works)), target_n)
        if faults is not None:
            # injected against observed, at the aggregation seam
            self.chaos_ledger.record_round(
                round_idx,
                injected={"dropped": list(faults.dropped),
                          "stragglers": dict(faults.work_scale)},
                observed={"sampled": len(sampled),
                          "participating": sum(w > 0 for w in works),
                          "tolerance": self.chaos_tolerance})
        return sampled, works

    def _slot_metrics(self, slots) -> Optional[Dict[str, torch.Tensor]]:
        """The per-client ``loss_sum`` / ``count`` of a round as ``[1, K]``
        device tensors (the JAX engine's per-slot metrics on one device);
        a client that reported nothing has zeros."""
        if slots is None:
            return None
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return {k: torch.stack([zero if m is None else m[k].float()
                                for m in slots]).view(1, -1)
                for k in ("loss_sum", "count")}

    # -- contribution -------------------------------------------------------
    def _assess_contribution(self, mat: torch.Tensor, w: torch.Tensor,
                             sampled, round_idx: int) -> None:
        """LOO / GTG-Shapley on the round's post-attack ``[K, D]`` matrix:
        a coalition's value is the eval accuracy of the round-start params
        plus the masked weighted mean of its rows, one function on the
        device for every coalition (``core/contribution``); each value is
        one scalar read. The host path keeps the JAX engine's guard: a
        matrix over ``CONTRIBUTION_HOST_GUARD_BYTES`` is not assessed."""
        nbytes = int(mat.numel()) * mat.element_size()
        if not self.robust_fused and nbytes > CONTRIBUTION_HOST_GUARD_BYTES:
            logger.error(
                "contribution assessment skipped: update matrix is %.1f "
                "GiB (> 2 GiB host guard) — Shapley/LOO on a model this "
                "size would OOM the host; use a smaller model or disable "
                "contribution assessment", nbytes / 2**30)
            return
        assess_contribution(self.contribution, self.spec, self.layout,
                            self.params, self.test, mat, w, sampled,
                            round_idx)

    # -- rounds -------------------------------------------------------------
    def _round(self, round_idx: int, hyper: TrainHyper, sched):
        """One round of the cohort ``sched`` (``(sampled, works)``, from
        :meth:`_schedule_for`); returns (summed metrics on the device,
        local steps run, the defense's [K] verdict or None, the per-client
        metrics selection reads or None). Reads nothing back from the
        device, except on the host-kernel robust path and for
        contribution values.

        Chaos: a client of work fraction ``ws`` runs ``ceil(epochs *
        real_batches * ws)`` steps of the one captured step. A dropped
        client (``ws`` 0) runs none and reports nothing: no update, no
        metrics, no state write; in robust mode its row is its zero-step
        update at weight 0. Under ``chaos_tolerance`` its weight leaves
        the denominator; without it, its scheduled weight stays: the
        optimizer's weight from its zero-step ``local_train`` (FedLocalSGD
        weighs a client 1, not by its samples)."""
        sampled, works = sched
        round_key = prng.fold_in(self.rng, round_idx)
        self.dp.record_round(len(sampled) / max(self.fed.num_clients, 1))
        if self._slot_fold:
            return self._folded_round(round_idx, sampled, works,
                                      round_key) + (None, None)
        robust = self.robust_mode
        mat = self._matrix(len(sampled)) if robust else None
        w = (torch.empty(len(sampled), dtype=torch.float32,
                         device=self.device) if robust else None)
        # robust mode sums only the extras and the weight here: the
        # updates go to the matrix
        acc = WeightedSum({} if robust else self.params,
                          self.opt.server_extras_zero(self.params),
                          device=self.device)
        acc_m, steps, slots = self._train_cohort(
            sampled, works, round_key, hyper, rows=mat, w=w, acc=acc,
            skip_dropped=not robust and self.chaos_tolerance)
        agg, agg_ex = acc.mean()
        agg, verdict = self._server_aggregate(round_idx, agg, mat, w,
                                              sampled, round_key)
        self._server_step(round_idx, agg, agg_ex)
        return acc_m, steps, verdict, self._slot_metrics(slots)

    def _train_cohort(self, sampled, works, round_key: np.ndarray,
                      hyper: TrainHyper, rows: Optional[torch.Tensor] = None,
                      w: Optional[torch.Tensor] = None,
                      acc: Optional[WeightedSum] = None,
                      skip_dropped: bool = True, extras_into=None):
        """Train ``sampled`` one after another from the global params
        (client ``cid``'s key ``fold_in(round_key, cid)``, its work
        fraction from ``works``), each through the captured step. Returns
        (summed metrics on the device, local steps run, the per-client
        metrics selection reads or None).

        ``rows`` (``[n, row_d]`` float32 on the device): client k's
        update goes into row k in the JAX flat layout, and ``extras_into``
        (a callable ``(extras, row_tail)``) writes its extras after it
        (the async engine's update ‖ extras row); ``w[k]`` gets its
        weight, 0 for a dropped client. ``acc`` sums the rest: the update
        when there are no rows, the extras and the weight. A dropped
        client (work 0) is skipped when ``skip_dropped``; otherwise it
        runs its zero-step ``local_train``, and without
        ``chaos_tolerance`` its weight stays in ``acc``'s denominator. It
        reports nothing and writes no client state either way."""
        d = self.layout.size
        acc_m: Dict[str, torch.Tensor] = {}
        slots: Optional[list] = [] if self.selection.track else None
        steps = 0
        for k, (cid, ws) in enumerate(zip(sampled, works)):
            if ws <= 0.0 and skip_dropped:
                if slots is not None:
                    slots.append(None)
                continue
            # views of the client's rows: written back in place below
            cstate = tree_map(lambda a: a[cid], self.client_states)
            ckey = prng.fold_in(round_key, cid)
            out, n_steps = self.opt.local_train(
                self.params, self.server_state, cstate,
                self.train.client(cid), ckey,
                hyper if ws == 1.0 else dataclasses.replace(
                    hyper, work_scale=ws),
                batch_real=self.batch_real[cid], programs=self)
            steps += n_steps
            update = self._client_dp(out.update, ckey)
            if rows is not None:
                # row k, in the JAX package's flat layout
                self.layout.flatten_into(update, rows[k, :d])
                if extras_into is not None:
                    extras_into(out.extras, rows[k, d:])
                if w is not None:
                    w[k] = out.weight if ws > 0.0 else 0.0
                update = {}
            if ws <= 0.0:
                if acc is not None and not self.chaos_tolerance:
                    acc.add_weight(out.weight)
                if slots is not None:
                    slots.append(None)
                continue
            if acc is not None:
                acc.add(out.replace(update=update))
            if self.opt.has_client_state:
                tree_copy_(cstate, out.client_state)
            for name, m in out.metrics.items():
                acc_m[name] = acc_m[name] + m if name in acc_m else m
            if slots is not None:
                slots.append(out.metrics)
        for name in METRICS:    # a cohort whose clients all dropped
            acc_m.setdefault(name, torch.zeros(
                (), dtype=torch.float32, device=self.device))
        return acc_m, steps, slots

    def _client_dp(self, update: Params, client_key: np.ndarray) -> Params:
        """A client's update as DP sends it (LDP noise, or the CDP clip)."""
        return dp_client_update(self.dp, update, client_key)

    def _server_aggregate(self, round_idx: int, agg: Params, mat, w,
                          sampled, round_key: np.ndarray):
        """The server's side of the round before its step: in robust mode
        the attack, contribution assessment and the defense on the matrix
        (``agg`` is then empty), then CDP's noise. Returns (aggregate
        update, verdict or None)."""
        verdict = None
        if mat is not None:
            assess = None
            if self.contribution.enabled:
                assess = lambda m: self._assess_contribution(  # noqa: E731
                    m, w, sampled, round_idx)
            vec, verdict = self._defend(mat, w, sampled, round_key, assess)
            agg = self.layout.unflatten(vec)
        return dp_server_noise(self.dp, agg, round_key), verdict

    def _fold(self, sampled, report: Optional[np.ndarray] = None
              ) -> ClientData:
        """The sampled clients' data folded into the batch axis:
        ``[clients, n_batches, bs, ...]`` -> ``[n_batches, n * bs, ...]``,
        batch i holding each client's batch i in schedule order. A client
        whose ``report`` is 0 keeps its place with its samples masked."""
        idx = torch.as_tensor(np.asarray(list(sampled), np.int64),
                              device=self.device)

        def fold(a):
            a = a.transpose(0, 1)
            return a.reshape((a.shape[0], -1) + tuple(a.shape[3:]))

        t = self.train
        mask, n = t.mask[idx], t.num_samples[idx].float()
        if report is not None:
            r = self._to_device(report)
            mask = mask * r.view((-1,) + (1,) * (mask.dim() - 1)).to(
                mask.dtype)
            n = n * r
        return ClientData(fold(t.x[idx]), fold(t.y[idx]), fold(mask),
                          n.sum())

    def _folded_round(self, round_idx: int, sampled, works, round_key
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
        """One folded round: one full-batch pass over the folded clients
        gives the weight-scaled update sum directly. A dropped client's
        samples are masked (the JAX engine's fold); a straggler reports
        its whole gradient."""
        report = np.asarray([w > 0.0 for w in works], np.float32)
        folded = self._fold(sampled, None if report.all() else report)
        den = folded.num_samples
        if not self.chaos_tolerance and not report.all():
            den = self._fold(sampled).num_samples
        acc_u, acc_m = self.opt.local_train_folded(
            self.params, folded, round_key, programs=self)
        self._server_step(
            round_idx, weighted_mean(acc_u, den),
            weighted_mean(self.opt.server_extras_zero(self.params), den))
        return acc_m, 0

    def _server_step(self, round_idx: int, agg: Params, agg_ex) -> None:
        self.params, self.server_state = self.opt.server_update(
            self.params, self.server_state, agg, agg_ex, round_idx)

    def _block(self, name: str, start_round: int, n_rounds: int,
               hyper: TrainHyper) -> List[Dict[str, float]]:
        self._ensure_flops_model(hyper)
        with obs_trace.span("block", root=True,
                            attrs={"role": "engine",
                                   "start_round": int(start_round),
                                   "rounds": int(n_rounds)}):
            # every round's cohort is chosen before the block runs (the
            # JAX engine's fused block): nothing inside it waits for the
            # device
            scheds = [self._schedule_for(start_round + i)
                      for i in range(n_rounds)]
            out = self._traced(name, n_rounds, lambda: [
                self._round(start_round + i, hyper, scheds[i])
                for i in range(n_rounds)])
            # the block's one device -> host read (and its stacked
            # verdicts, on the fused robust path)
            host = torch.stack([torch.stack([o[0][k] for k in METRICS])
                                for o in out]).cpu().numpy()
            verdicts = [o[2] for o in out]
            if verdicts and torch.is_tensor(verdicts[0]):
                verdicts = list(torch.stack(verdicts).cpu().numpy())
        n = self.fed.num_clients
        for i, (o, v) in enumerate(zip(out, verdicts)):
            r, sampled = start_round + i, scheds[i][0]
            if v is not None and self.defender.is_defense_enabled():
                self.verdicts[r] = (sampled, np.asarray(v))
                logger.info("round %d: defense verdict %s", r,
                            np.round(np.asarray(v), 4).tolist())
            # per-client losses stay on the device, queued until the
            # next selection query
            self.selection.note_results(
                r, sampled, slot_placement(sampled, 1, n),
                slot_metrics=o[3], verdict=v)
        return [dict({k: float(v) for k, v in zip(METRICS, row)},
                     local_steps=o[1])
                for row, o in zip(host, out)]

    def run_rounds_fused(self, start_round: int, n_rounds: int,
                         hyper: TrainHyper) -> List[Dict[str, float]]:
        """Run ``n_rounds`` rounds with no device -> host read between them
        (one at the block's end). Returns each round's summed metrics
        (``loss_sum``, ``correct``, ``count``) and ``local_steps``. Robust
        rounds on the host path (``robust_fused: host``, an attack with no
        defense, a user aggregator) and contribution runs run as blocks of
        one round each: each reads its verdict or its values back."""
        if n_rounds > 1 and (
                (self.robust_mode and not self.robust_fused)
                or self.contribution.enabled):
            return [self.run_round(start_round + i, hyper)
                    for i in range(n_rounds)]
        return self._block("rounds_fused", start_round, n_rounds, hyper)

    def run_round(self, round_idx: int, hyper: TrainHyper
                  ) -> Dict[str, float]:
        """One round as its own block; what :meth:`run_rounds_fused`
        returns for it."""
        return self._block("round", round_idx, 1, hyper)[0]

    # -- the dispatch seam --------------------------------------------------
    def _ensure_flops_model(self, hyper: TrainHyper) -> None:
        """Count the FLOPs model once per run, only under
        ``obs_profile_device`` (it runs one step on the CPU)."""
        if self._obs_profile and self._flops_per_round is None:
            self._flops_per_round = self.round_cost_flops(hyper)

    def _traced(self, name: str, n_rounds: int, fn):
        """Per-block observability: a ``dispatch`` span around the host's
        enqueue of the block, and the step captures it triggered. With
        ``obs_profile_device`` the host then waits for the device
        (``device_wait_s``), the block is named in a ``torch.profiler``
        trace, and the FLOPs model becomes the per-round MFU gauge and a
        ``profile`` record. The compute plane: the block's signature and
        the programs it built feed recompile forensics; under
        ``obs_roofline`` the programs it ran are captured after it (once
        per signature), so nothing of the capture is charged to it."""
        c0 = self.dispatch_stats["captures"]
        sig = obs_roofline.dispatch_signature(self._dispatch_args())
        built = set(self.programs)
        steps0 = {k: p.steps for k, p in self.programs.items()}
        with obs_trace.span("dispatch", attrs={"name": name,
                                               "rounds": int(n_rounds)}) \
                as sp:
            t0 = time.perf_counter()
            if self._obs_profile:
                with torch.profiler.record_function(name):
                    out = fn()
            else:
                out = fn()
            wall = time.perf_counter() - t0
            wait = None
            if self._obs_profile:
                t1 = time.perf_counter()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                wait = time.perf_counter() - t1
                sp.set_attr("device_wait_s", round(wait, 6))
        self._update_program_stats()
        captures = self.dispatch_stats["captures"] - c0
        # the port's compile: a new step program (captured on a card)
        self._roofline.observe(name, sig, len(set(self.programs) - built))
        ran = [(p, p.steps - steps0.get(k, 0))
               for k, p in self.programs.items()]
        ran = [(p, n) for p, n in ran if n > 0]
        if ran:
            self._roofline.maybe_capture(
                name, lambda: _programs_body(ran), sig=sig)
        if self._obs_profile:
            obs_profiler.record_dispatch_profile(
                name, n_rounds, wall, wait, self._flops_per_round, 1,
                captures=captures, device=self.device)
            obs_profiler.sample_hbm_peak_gb(self.device)
        self.dispatch_stats["dispatches"] += 1
        return out

    def _dispatch_args(self) -> Dict[str, Any]:
        """What a block reads: the signature's tree."""
        t = self.train
        return {"params": self.params, "server_state": self.server_state,
                "client_states": self.client_states,
                "train": {"x": t.x, "y": t.y, "mask": t.mask}}

    def round_cost_flops(self, hyper: TrainHyper) -> float:
        """FLOPs of one round's training, for MFU: one fwd+bwd step at the
        real batch shape times ``n_sampled * epochs * mean real batches
        per client`` (from the mask: padded batches are skipped, so they
        are not work).

        The step is counted by ``torch.utils.flop_counter.FlopCounterMode``
        on a CPU copy of the model, in float32 and on the unfused plain
        path: the counter cannot see inside a CUDA kernel's launch, and the
        model's work is the same whichever kernel does it. It counts convolutions and
        matmuls at their full extent, padding taps included (an LSTM's
        input projection and its per-step recurrent products too), and no
        elementwise op. XLA's ``cost_analysis`` (the JAX engine's count)
        counts only the taps that land inside the unpadded input and one
        FLOP per elementwise op; on the CIFAR ResNets the padding taps
        weigh more, so this count is a few percent above XLA's."""
        from torch.utils.flop_counter import FlopCounterMode

        twin = copy.deepcopy(self.bundle).to(torch.device("cpu"))
        if hasattr(twin, "compute_dtype"):
            twin.compute_dtype = torch.float32
        # the unfused path: the fused block's backward recomputes its
        # forward, work a model-FLOPs count leaves out
        for m in twin.module.modules():
            if getattr(m, "use_fused", False):
                m.use_fused = False
        spec = type(self.spec)(twin.apply)
        leaves = {k: v.detach().cpu().requires_grad_()
                  for k, v in self.params.items()}
        batch = {k: torch.zeros(t.shape[2:], dtype=t.dtype)
                 for k, t in (("x", self.train.x), ("y", self.train.y),
                              ("mask", self.train.mask))}
        # a model with dropout draws its masks from a key: any key will do
        rng = (torch.zeros(2, dtype=torch.int64)
               if getattr(twin, "has_dropout", False)
               else None)
        with FlopCounterMode(display=False) as counter:
            loss, _ = spec.loss(leaves, batch, rng)
            torch.autograd.grad(loss, list(leaves.values()))
        per_batch = float(counter.get_total_flops())
        n_sampled = int(self.args.client_num_per_round)
        mean_real = float(np.mean(np.sum(self.batch_real, axis=-1)))
        steps = n_sampled * int(hyper.epochs) * mean_real
        if self.chaos.injects_availability:
            # dropped clients run no step, stragglers a fraction
            steps *= self.chaos.expected_work_fraction
        return per_batch * steps

    # -- eval and the run ---------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        stats = evaluate(self.spec, self.params, self.test["x"],
                         self.test["y"], self.test["mask"])
        n = max(float(stats["count"]), 1.0)
        return {"test_acc": float(stats["correct"]) / n,
                "test_loss": float(stats["loss_sum"]) / n}

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(
            args.comm_round)
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        self._ensure_flops_model(hyper)
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        rpd = max(int(getattr(args, "rounds_per_dispatch", 8) or 1), 1)
        n_test_batches = int(self.test["x"].shape[0])
        t0 = time.time()
        round_idx = self.restore()
        while round_idx < rounds:
            # run up to (and including) the next eval round; freq <= 0
            # never evaluates (x % -1 == 0 for every x, so it must not
            # reach the modulo)
            if freq <= 0:
                next_eval = rounds - 1
            else:
                next_eval = (round_idx if round_idx % freq == 0
                             else (round_idx // freq + 1) * freq)
            stop = min(next_eval, rounds - 1, round_idx + rpd - 1)
            if self.ckpt.enabled:
                # maybe_save fires when (r + 1) % every == 0: the block
                # must END on such a round, or the checkpoint would hold
                # end-of-block params under an earlier round's label
                every = self.ckpt.every
                stop = min(stop, (round_idx + every) // every * every - 1)
            block = self.run_rounds_fused(round_idx, stop - round_idx + 1,
                                          hyper)
            for i, m in enumerate(block):
                r = round_idx + i
                cnt = max(m["count"], 1.0)
                rec: Dict[str, Any] = {
                    "round": r, "train_loss": m["loss_sum"] / cnt,
                    "train_acc": m["correct"] / cnt,
                    "local_steps": m["local_steps"]}
                if freq > 0 and (r % freq == 0 or r == rounds - 1):
                    with obs_trace.span("eval", root=True,
                                        attrs={"role": "engine",
                                               "round_idx": r}):
                        rec.update(self.evaluate())
                    rec["eval_batches"] = n_test_batches
                    logger.info("round %d: test_acc=%.4f", r,
                                rec["test_acc"])
                self.history.append(rec)
                obs_sink.log_round_info(rounds, r)
                if self.ckpt.enabled:
                    with obs_trace.span("checkpoint", root=True,
                                        attrs={"role": "engine",
                                               "round_idx": r}):
                        self.ckpt.maybe_save(r, self.ckpt_state())
                if self.chaos.crash_due(r):
                    # the injected crash comes after the round's record
                    # and its checkpoint, flushed, so a resume restores a
                    # consistent trajectory
                    self.ckpt.flush()
                    raise ChaosCrash(r)
            round_idx = stop + 1
        # the writes must be on disk before the run returns: the next
        # run's checkpointer cannot wait on this one's
        self.ckpt.flush()
        wall = time.time() - t0
        last_eval = next((h for h in reversed(self.history)
                          if "test_acc" in h), None)
        if last_eval is None:
            last_eval = ({"test_acc": None} if freq <= 0
                         else self.evaluate())
        result = {"params": self.params, "history": self.history,
                  "wall_time_s": wall,
                  "final_test_acc": last_eval["test_acc"],
                  "final_test_loss": last_eval.get("test_loss"),
                  "rounds": rounds,
                  "dispatch_stats": dict(self.dispatch_stats)}
        if self.dp.is_dp_enabled():
            result["dp_epsilon_spent"] = self.dp.get_epsilon_spent()
        return result


#: the host path's bound on the matrix contribution assessment takes (the
#: JAX engine's 2 GiB host guard)
CONTRIBUTION_HOST_GUARD_BYTES = 2 << 30


def _programs_body(ran) -> None:
    """The roofline capture's body: each program that ran in a block, one
    step on copies of its tensors, its rows multiplied by the steps it
    ran."""
    for prog, n in ran:
        with obs_roofline.repeat(n):
            prog.analysis_step()


def load_params(bundle, init_params: Dict[str, Any],
                device: torch.device) -> Params:
    """Parameters from ``init_params`` (tensors or numpy arrays under the
    names of the bundle's trainable parameters: the model's state dict, or
    the LLM's adapter dict) instead of a fresh init, as f32 on
    ``device``."""
    bundle.to(device)
    want = bundle.template()
    if set(init_params) != set(want):
        raise ValueError(
            f"init_params keys differ from the model's: missing "
            f"{sorted(set(want) - set(init_params))}, unexpected "
            f"{sorted(set(init_params) - set(want))}")
    params = {}
    for k, shape in want.items():
        v = init_params[k]
        v = v.detach() if torch.is_tensor(v) else torch.tensor(np.asarray(v))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"init_params[{k!r}]: shape "
                             f"{tuple(v.shape)} != {tuple(shape)}")
        params[k] = v.to(device, torch.float32).clone()
    return params
