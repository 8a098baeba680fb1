"""FedMLRunner façade (counterpart of ``fedml_tpu/runner.py``): builds the
GPU simulator (sync, or buffered-async under ``round_mode:
async_buffered``), the SP golden loop, or the protocol simulators
(``Async_FedAvg``, ``hierarchicalfl``, ``decentralized_fl``, ``split_nn``,
the vertical names, ``turbo_aggregate``, ``FedGKT``, ``FedNAS``,
``FedSeg`` (or a segmentation dataset), ``FedGAN`` (or the ``gan``
bundle pair) and ``centralized``, on any backend, as the JAX package
dispatches them), hands a user ``ServerAggregator`` to the GPU engine,
builds a cross-silo party (``training_type: cross_silo``, ``cross_silo/``: the
horizontal, gossip, split-learning or vertical session, or ``scenario:
hierarchical``), runs a session and serves its aggregate
(``training_type: fedml_serving``, alias ``serving``), and refuses what
they have not ported (an unported model or dataset is refused by
``model.create`` / ``data.load``, naming itself)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .constants import (FEDML_SIMULATION_TYPE_GPU, FEDML_SIMULATION_TYPE_SP,
                        FEDML_TRAINING_PLATFORM_CROSS_CLOUD,
                        FEDML_TRAINING_PLATFORM_CROSS_DEVICE,
                        FEDML_TRAINING_PLATFORM_CROSS_SILO,
                        FEDML_TRAINING_PLATFORM_SERVING,
                        FEDML_TRAINING_PLATFORM_SIMULATION)
from .device import get_device, get_mesh

# Knobs of the JAX package whose features the port does not have yet, each
# with the value(s) that mean "off". A run that sets one otherwise raises
# NotImplementedError naming it, rather than silently ignoring it. Every
# knob is ported now (``mesh_shape`` and ring attention were the last);
# combinations not ported yet raise where they are built, naming both
# knobs (e.g. robust mode over more than one client rank).
UNPORTED_KNOBS: Dict[str, tuple] = {}

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
    "ServerAggregator, buffered-async rounds, the protocol simulators "
    "(Async_FedAvg, hierarchicalfl, decentralized_fl, split_nn, vertical "
    "FL, turbo_aggregate, FedGKT, FedNAS, FedSeg, FedGAN) and centralized "
    "training; the cross-silo platform (training_type: cross_silo), i.e. the "
    "horizontal session, synchronous or buffered-async (round_mode: "
    "async_buffered), gossip, split learning, vertical FL and scenario: "
    "hierarchical, over INPROC, TCP, gRPC, PUBSUB (broker + object store) "
    "or TRPC with the comm_retry_*, comm_compression_*, "
    "gossip_compression, round_timeout_s / round_quorum_frac, async_*, "
    "chaos_* (link faults included) and checkpoint knobs, and its secure "
    "aggregation (federated_optimizer SA or LSA, secagg_compress_bits; "
    "the cryptography package needed), Paillier FHE (core/fhe) and the "
    "enable_secure_agg / enable_fhe flags (inert, as in the JAX package); "
    "federated serving (training_type: fedml_serving); the cross-device "
    "platform (training_type: cross_device: the device server, simulated "
    "devices on the torch or native engine, cohort assembly and the fleet "
    "registry); the models and "
    "tasks of the zoo, round checkpoints, the federated LoRA causal LM "
    "and serving; multi-rank runs (one process per rank): the GPU "
    "engine's client axis (mesh_shape), ring attention and the FSDP + "
    "tensor-parallel LLM step (llm/sharding.py)")

# federated_optimizer values that the JAX package dispatches to protocol
# simulators of their own: none runs the engine, so none can honor
# `round_mode: async_buffered`
_PROTOCOL_FOS = frozenset((
    "centralized", "fedgkt", "fednas", "fedseg", "fedgan",
    "hierarchicalfl", "async_fedavg", "asyncfedavg",
    "decentralized_fl", "split_nn", "classical_vertical",
    "vertical_fl", "vfl", "turbo_aggregate", "turboaggregate"))
_ASYNC_FEDAVG = ("async_fedavg", "asyncfedavg")
# the ported protocol simulators: module and class under simulation/sp,
# and whether the protocol drives plain FedAvg client steps
_PROTOCOL_SIMULATORS = {
    "async_fedavg": ("async_fedavg", "AsyncFedAvgSimulator", True),
    "asyncfedavg": ("async_fedavg", "AsyncFedAvgSimulator", True),
    "hierarchicalfl": ("hierarchical", "HierarchicalSimulator", True),
    "decentralized_fl": ("decentralized", "DecentralizedSimulator", True),
    "split_nn": ("split_nn", "SplitNNSimulator", False),
    "classical_vertical": ("vertical_fl", "VerticalFLSimulator", False),
    "vertical_fl": ("vertical_fl", "VerticalFLSimulator", False),
    "vfl": ("vertical_fl", "VerticalFLSimulator", False),
    "turbo_aggregate": ("turbo_aggregate", "TurboAggregateSimulator", True),
    "turboaggregate": ("turbo_aggregate", "TurboAggregateSimulator", True),
}
# the protocols with model and loss stacks of their own (no trainer spec:
# segmentation, GAN, NAS and GKT tasks have no classification spec), by
# module and class; dispatched before the spec is built, as in the JAX
# runner. A segmentation dataset runs FedSeg and a (generator,
# discriminator) bundle pair FedGAN whatever the optimizer's name.
_OWN_STACK = {
    "centralized": ("centralized", "CentralizedTrainer"),
    "fedgkt": ("simulation.sp.fedgkt", "FedGKTSimulator"),
    "fednas": ("simulation.sp.fednas", "FedNASSimulator"),
    "fedseg": ("simulation.sp.fedseg", "FedSegSimulator"),
    "fedgan": ("simulation.sp.fedgan", "FedGANSimulator"),
}


def _own_stack(fo: str, dataset, model) -> Optional[str]:
    """The ``_OWN_STACK`` entry that runs ``fo`` on this dataset and
    model, if any."""
    if fo in ("centralized", "fedgkt", "fednas"):
        return fo
    if fo == "fedseg" or getattr(dataset, "task", None) == "segmentation":
        return "fedseg"
    if fo == "fedgan" or isinstance(model, tuple):
        return "fedgan"
    return None


def _knob_on(args, knob: str, off: tuple) -> bool:
    v = getattr(args, knob, None)
    if isinstance(v, str):
        v = v.lower()
    return v not in off


def check_ported(args) -> None:
    """Raise NotImplementedError for the first knob of an unported
    feature that ``args`` turns on, and for the engine's chaos knobs on
    the SP backend and the protocol simulators."""
    for knob, off in UNPORTED_KNOBS.items():
        if _knob_on(args, knob, off):
            raise NotImplementedError(
                f"{knob}={getattr(args, knob)!r} is not ported to "
                f"fedml_tpu_torch yet ({PORTED_SUMMARY})")
    fo = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    hint = ("run it on backend='gpu' (round_mode: async_buffered for "
            "async rounds)")
    if fo in _ASYNC_FEDAVG:
        loop = "the SP Async_FedAvg loop"
    elif (fo in _PROTOCOL_SIMULATORS or fo in _OWN_STACK) and getattr(
            args, "training_type",
            FEDML_TRAINING_PLATFORM_SIMULATION) == \
            FEDML_TRAINING_PLATFORM_SIMULATION:
        loop = f"the {fo} protocol simulator"
        hint = "the GPU engine's rounds take them"
    elif getattr(args, "backend", None) == FEDML_SIMULATION_TYPE_SP:
        loop = "the SP golden loop"
    else:
        return
    for knob, off in ENGINE_CHAOS_KNOBS.items():
        if _knob_on(args, knob, off):
            raise NotImplementedError(
                f"{knob}={getattr(args, knob)!r}: {loop} injects no chaos "
                f"(neither does the JAX package's); {hint}")


class FedMLRunner:
    """Dispatch on ``args.training_type`` x ``args.backend``: the port has
    the simulation platform on the GPU and SP backends, the cross-silo
    platform (``cross_silo`` / ``cross_cloud``) over INPROC, TCP, gRPC,
    PUBSUB and TRPC, the cross-device platform (``cross_device``) and
    federated serving (``fedml_serving``)."""

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
        if ttype == FEDML_TRAINING_PLATFORM_CROSS_DEVICE:
            if server_aggregator is not None:
                raise NotImplementedError(
                    "server_aggregator: the device server takes no user "
                    "ServerAggregator (the JAX package's ignores one)")
            from .cross_device.runner import build_cross_device_runner
            self.runner = build_cross_device_runner(
                args, dataset, model, device=get_device(device),
                init_params=init_params)
            return
        if ttype in (FEDML_TRAINING_PLATFORM_SERVING, "serving"):
            if server_aggregator is not None:
                raise NotImplementedError(
                    "server_aggregator: the federated serving session's "
                    "server takes no user ServerAggregator (neither does "
                    "the JAX package's)")
            from .serving.federated import FederatedServingRunner
            self.runner = FederatedServingRunner(
                args, dataset, model, client_trainer,
                device=get_device(device), init_params=init_params)
            return
        if ttype != FEDML_TRAINING_PLATFORM_SIMULATION:
            raise NotImplementedError(
                f"training_type={ttype!r} is not ported to fedml_tpu_torch "
                f"yet (ported: simulation, cross_silo, cross_device, "
                f"fedml_serving)")
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
        own = _own_stack(fo, dataset, model)
        if own is not None:
            import importlib
            if server_aggregator is not None:
                raise NotImplementedError(
                    "server_aggregator: the SP loops run no user "
                    "ServerAggregator (neither do the JAX package's); "
                    "run it on backend='gpu'")
            module, name = _OWN_STACK[own]
            Trainer = getattr(importlib.import_module(
                f".{module}", __package__), name)
            dev = get_device(device)
            if own == "centralized":
                self.runner = Trainer(args, dataset, model,
                                      spec=client_trainer, device=dev,
                                      init_params=init_params)
            else:
                self.runner = Trainer(args, dataset, model, device=dev,
                                      init_params=init_params)
            return
        spec = (client_trainer if client_trainer is not None
                else make_trainer_spec(dataset, model))
        kw = {}
        if fo in _PROTOCOL_SIMULATORS:
            import copy
            import importlib
            module, name, fedavg = _PROTOCOL_SIMULATORS[fo]
            opt = None
            if fedavg:
                # the protocol loop drives plain FedAvg client steps
                inner = copy.copy(args)
                inner.federated_optimizer = "FedAvg"
                opt = create_optimizer(inner, spec)
            Simulator = getattr(importlib.import_module(
                f".simulation.sp.{module}", __package__), name)
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
            if backend == FEDML_SIMULATION_TYPE_SP or \
                    fo in _PROTOCOL_SIMULATORS:
                raise NotImplementedError(
                    "server_aggregator: the SP loops run no user "
                    "ServerAggregator (neither do the JAX package's); "
                    "run it on backend='gpu'")
            kw["server_aggregator"] = server_aggregator
        if backend == FEDML_SIMULATION_TYPE_GPU and \
                fo not in _PROTOCOL_SIMULATORS:
            # the client axis: this rank's mesh and device (mesh_shape);
            # the SP loops run in one process and ignore it, as the JAX
            # package's do
            kw["mesh"], dev = get_mesh(args, device)
        else:
            dev = get_device(device)
        self.runner = Simulator(args, dataset, model, opt, spec, dev,
                                init_params=init_params, **kw)

    def run(self, comm_round: Optional[int] = None) -> Any:
        return self.runner.run(comm_round)
