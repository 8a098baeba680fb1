"""FedMLRunner façade (counterpart of ``fedml_tpu/runner.py``): builds the
GPU simulator (sync, or buffered-async under ``round_mode:
async_buffered``), the SP golden loop or the SP ``Async_FedAvg`` loop for
the ported slices, hands a user ``ServerAggregator`` to the GPU engine,
builds a cross-silo party (``training_type: cross_silo``: the server or a
silo of the horizontal session, ``cross_silo/``), and refuses what they
have not ported (an unported model or dataset is refused by
``model.create`` / ``data.load``, naming itself)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .constants import (FEDML_SIMULATION_TYPE_GPU, FEDML_SIMULATION_TYPE_SP,
                        FEDML_TRAINING_PLATFORM_CROSS_CLOUD,
                        FEDML_TRAINING_PLATFORM_CROSS_SILO,
                        FEDML_TRAINING_PLATFORM_SIMULATION)
from .device import get_device

# Knobs of the JAX package whose features the port does not have yet, each
# with the value(s) that mean "off". A run that sets one otherwise raises
# NotImplementedError naming it, rather than silently ignoring it.
UNPORTED_KNOBS: Dict[str, tuple] = {
    "enable_secure_agg": (None, False), "enable_fhe": (None, False),
    "mesh_shape": (None,),
    "obs_roofline": (None, False),
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

# what the port runs, for the refusals' messages
PORTED_SUMMARY = (
    "ported: the simulation platform, i.e. the GPU and SP simulators' "
    f"rounds with every federated optimizer ({PORTED_OPTIMIZERS}) and "
    "client_slot_fold, differential privacy (LDP, CDP, NbAFL), the model "
    "and data attacks, the 22 defenses and the defended round, chaos, "
    "participant selection, contribution assessment, a user "
    "ServerAggregator and buffered-async rounds; the cross-silo platform "
    "(training_type: cross_silo), i.e. the horizontal session, synchronous "
    "or buffered-async (round_mode: async_buffered), over INPROC, TCP, "
    "gRPC, PUBSUB (broker + object store) or TRPC with the comm_retry_*, "
    "comm_compression_*, round_timeout_s / round_quorum_frac, async_*, "
    "chaos_* (link faults included) and checkpoint knobs, whose secure "
    "aggregation (SA, LSA), split learning, gossip, vertical and "
    "hierarchical scenarios still raise; the models and tasks of the zoo, "
    "round checkpoints, the federated LoRA causal LM and serving")

# federated_optimizer values that the JAX package dispatches to protocol
# simulators of their own: none runs the engine, so none can honor
# `round_mode: async_buffered` (only Async_FedAvg is ported)
_PROTOCOL_FOS = frozenset((
    "centralized", "fedgkt", "fednas", "fedseg", "fedgan",
    "hierarchicalfl", "async_fedavg", "asyncfedavg",
    "decentralized_fl", "split_nn", "classical_vertical",
    "vertical_fl", "vfl", "turbo_aggregate", "turboaggregate"))
_ASYNC_FEDAVG = ("async_fedavg", "asyncfedavg")


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
                f"fedml_tpu_torch yet ({PORTED_SUMMARY})")
    fo = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if fo in _ASYNC_FEDAVG:
        loop = "the SP Async_FedAvg loop"
    elif getattr(args, "backend", None) == FEDML_SIMULATION_TYPE_SP:
        loop = "the SP golden loop"
    else:
        return
    for knob, off in ENGINE_CHAOS_KNOBS.items():
        if _knob_on(args, knob, off):
            raise NotImplementedError(
                f"{knob}={getattr(args, knob)!r}: {loop} injects no chaos "
                f"(neither does the JAX package's); run it on "
                f"backend='gpu' (round_mode: async_buffered for async "
                f"rounds)")


class FedMLRunner:
    """Dispatch on ``args.training_type`` x ``args.backend``: the port has
    the simulation platform on the GPU and SP backends, and the
    cross-silo platform (``cross_silo`` / ``cross_cloud``) over INPROC, TCP,
    gRPC, PUBSUB and TRPC."""

    def __init__(self, args, device=None, dataset=None, model=None,
                 client_trainer=None, server_aggregator=None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.server_aggregator = server_aggregator
        check_ported(args)
        ttype = getattr(args, "training_type",
                        FEDML_TRAINING_PLATFORM_SIMULATION)
        if ttype in (FEDML_TRAINING_PLATFORM_CROSS_SILO,
                     FEDML_TRAINING_PLATFORM_CROSS_CLOUD):
            if server_aggregator is not None:
                raise NotImplementedError(
                    "server_aggregator: the cross-silo server takes no "
                    "user ServerAggregator (neither does the JAX "
                    "package's); run it on the simulation platform")
            from .cross_silo.runner import build_cross_silo_runner
            self.runner = build_cross_silo_runner(
                args, dataset, model, client_trainer,
                device=get_device(device), init_params=init_params)
            return
        if ttype != FEDML_TRAINING_PLATFORM_SIMULATION:
            raise NotImplementedError(
                f"training_type={ttype!r} is not ported to fedml_tpu_torch "
                f"yet (ported: simulation, cross_silo)")
        from .core.async_rounds import round_mode_from_args
        from .core.algframe.client_trainer import make_trainer_spec
        from .optimizers.registry import create_optimizer
        backend = getattr(args, "backend", FEDML_SIMULATION_TYPE_GPU)
        fo = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        async_mode = round_mode_from_args(args) == "async_buffered"
        if async_mode and fo in _PROTOCOL_FOS:
            raise ValueError(
                f"round_mode: async_buffered is a GPU-engine mode; "
                f"federated_optimizer {fo!r} runs its own protocol "
                "simulator and would silently ignore it (the SP async "
                "equivalent is federated_optimizer: Async_FedAvg)")
        spec = (client_trainer if client_trainer is not None
                else make_trainer_spec(dataset, model))
        kw = {}
        if fo in _ASYNC_FEDAVG:
            # the protocol loop drives plain FedAvg client steps
            import copy
            inner = copy.copy(args)
            inner.federated_optimizer = "FedAvg"
            opt = create_optimizer(inner, spec)
            from .simulation.sp.async_fedavg import \
                AsyncFedAvgSimulator as Simulator
        elif backend == FEDML_SIMULATION_TYPE_GPU:
            opt = create_optimizer(args, spec)
            if async_mode:
                from .simulation.gpu.async_engine import \
                    AsyncBufferedSimulator as Simulator
            else:
                from .simulation.gpu.engine import GPUSimulator as Simulator
        elif backend == FEDML_SIMULATION_TYPE_SP:
            if async_mode:
                raise ValueError(
                    "round_mode: async_buffered is a GPU-engine mode; the "
                    "SP equivalent is federated_optimizer: Async_FedAvg")
            opt = create_optimizer(args, spec)
            from .simulation.sp.simulator import SPSimulator as Simulator
        else:
            raise NotImplementedError(
                f"backend={backend!r} is not ported to fedml_tpu_torch yet "
                f"(ported: gpu, sp)")
        if server_aggregator is not None:
            if backend == FEDML_SIMULATION_TYPE_SP or fo in _ASYNC_FEDAVG:
                raise NotImplementedError(
                    "server_aggregator: the SP loops run no user "
                    "ServerAggregator (neither do the JAX package's); "
                    "run it on backend='gpu'")
            kw["server_aggregator"] = server_aggregator
        self.runner = Simulator(args, dataset, model, opt, spec,
                                get_device(device), init_params=init_params,
                                **kw)

    def run(self, comm_round: Optional[int] = None) -> Any:
        return self.runner.run(comm_round)
