"""FedMLRunner façade (counterpart of ``fedml_tpu/runner.py``): builds the
GPU simulator or the SP golden loop for the ported slices, hands a user
``ServerAggregator`` to the GPU engine, and refuses what they have not
ported."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .constants import (FEDML_SIMULATION_TYPE_GPU, FEDML_SIMULATION_TYPE_SP,
                        FEDML_TRAINING_PLATFORM_SIMULATION)
from .device import get_device

# Knobs of the JAX package whose features the port does not have yet, each
# with the value(s) that mean "off". A run that sets one otherwise raises
# NotImplementedError naming it, rather than silently ignoring it.
UNPORTED_KNOBS: Dict[str, tuple] = {
    "enable_secure_agg": (None, False), "enable_fhe": (None, False),
    # link faults act only through the transport interceptor
    # (core/chaos's ChaosCommManager), which waits for the distributed
    # runtimes
    "chaos_link_loss_prob": (None, 0, 0.0),
    "chaos_link_dup_prob": (None, 0, 0.0),
    "chaos_link_delay_prob": (None, 0, 0.0),
    "round_mode": (None, "sync"),
    "mesh_shape": (None,),
    "obs_roofline": (None, False),
    # serving chaos (core/chaos's ServingChaosInjector)
    "chaos_serving_stall_prob": (None, 0, 0.0),
    "chaos_serving_stall_s": (None, 0, 0.0),
    "chaos_serving_stall_at_step": (None,),
    "chaos_serving_nan_prob": (None, 0, 0.0),
    "chaos_serving_nan_at_step": (None,),
    "chaos_serving_conn_drop_prob": (None, 0, 0.0),
    "chaos_serving_crash_at_request": (None,),
    # the values of this knob that are ported
    "llm_attention_impl": (None, "", "dense", "flash"),
}

# the GPU engine's availability faults: the SP golden loop has none, as in
# the JAX package, so backend="sp" refuses them rather than ignore them
ENGINE_CHAOS_KNOBS: Dict[str, tuple] = {
    "chaos_dropout_prob": (None, 0, 0.0),
    "chaos_straggler_prob": (None, 0, 0.0),
    "chaos_crash_at_round": (None,),
    "chaos_over_sample": (None, 0, 0.0),
}


PORTED_OPTIMIZERS = ("FedAvg, FedProx, FedOpt (sgd, adam, adagrad, yogi), "
                     "FedSGD, FedLocalSGD, SCAFFOLD, FedNova, FedDyn, Mime")


def _knob_on(args, knob: str, off: tuple) -> bool:
    v = getattr(args, knob, None)
    if isinstance(v, str):
        v = v.lower()
    return v not in off


def check_ported(args) -> None:
    """Raise NotImplementedError for the first knob of an unported
    feature that ``args`` turns on, and for the engine's chaos knobs on
    the SP backend."""
    for knob, off in UNPORTED_KNOBS.items():
        if _knob_on(args, knob, off):
            raise NotImplementedError(
                f"{knob}={getattr(args, knob)!r} is not ported to "
                f"fedml_tpu_torch yet (ported: the GPU and SP simulators' "
                f"rounds with every federated optimizer ({PORTED_OPTIMIZERS})"
                f" and client_slot_fold, differential privacy (LDP, CDP, "
                f"NbAFL), the model and data attacks, the 22 defenses and "
                f"the defended round (robust_fused, sharded_defense, "
                f"robust_relayout_quant), chaos (dropout, stragglers, "
                f"crash-at-round, over-sampling; the GPU engine), "
                f"participant selection (client_selection, "
                f"selection_adaptive_oversample, pacer_adapt_cohort), "
                f"contribution assessment (LOO, GTG-Shapley) and a user "
                f"ServerAggregator, with the CIFAR ResNets, the linear "
                f"models or the federated LoRA causal LM, their round "
                f"checkpoints, and serving them)")
    if getattr(args, "backend", None) == FEDML_SIMULATION_TYPE_SP:
        for knob, off in ENGINE_CHAOS_KNOBS.items():
            if _knob_on(args, knob, off):
                raise NotImplementedError(
                    f"{knob}={getattr(args, knob)!r}: the SP golden loop "
                    f"injects no chaos (neither does the JAX package's); "
                    f"run it on backend='gpu'")


class FedMLRunner:
    """Dispatch on ``args.training_type`` x ``args.backend``: the port has
    the simulation platform on the GPU and SP backends."""

    def __init__(self, args, device=None, dataset=None, model=None,
                 client_trainer=None, server_aggregator=None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.server_aggregator = server_aggregator
        check_ported(args)
        ttype = getattr(args, "training_type",
                        FEDML_TRAINING_PLATFORM_SIMULATION)
        if ttype != FEDML_TRAINING_PLATFORM_SIMULATION:
            raise NotImplementedError(
                f"training_type={ttype!r} is not ported to fedml_tpu_torch "
                f"yet (ported: simulation)")
        backend = getattr(args, "backend", FEDML_SIMULATION_TYPE_GPU)
        if backend == FEDML_SIMULATION_TYPE_GPU:
            from .simulation.gpu.engine import GPUSimulator as Simulator
        elif backend == FEDML_SIMULATION_TYPE_SP:
            from .simulation.sp.simulator import SPSimulator as Simulator
        else:
            raise NotImplementedError(
                f"backend={backend!r} is not ported to fedml_tpu_torch yet "
                f"(ported: gpu, sp)")
        from .core.algframe.client_trainer import make_trainer_spec
        from .optimizers.registry import create_optimizer
        spec = (client_trainer if client_trainer is not None
                else make_trainer_spec(dataset, model))
        opt = create_optimizer(args, spec)
        kw = {}
        if server_aggregator is not None:
            if backend == FEDML_SIMULATION_TYPE_SP:
                raise NotImplementedError(
                    "server_aggregator: the SP golden loop runs no user "
                    "ServerAggregator (neither does the JAX package's); "
                    "run it on backend='gpu'")
            kw["server_aggregator"] = server_aggregator
        self.runner = Simulator(args, dataset, model, opt, spec,
                                get_device(device), init_params=init_params,
                                **kw)

    def run(self, comm_round: Optional[int] = None) -> Any:
        return self.runner.run(comm_round)
