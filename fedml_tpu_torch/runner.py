"""FedMLRunner façade (counterpart of ``fedml_tpu/runner.py``): builds the
GPU simulator for the ported slice and refuses what it has not ported."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .constants import (FEDML_SIMULATION_TYPE_GPU,
                        FEDML_TRAINING_PLATFORM_SIMULATION)
from .device import get_device

# Knobs of the JAX package whose features this slice does not port, each
# with the value(s) that mean "off". A run that sets one otherwise raises
# NotImplementedError naming it, rather than silently ignoring it.
UNPORTED_KNOBS: Dict[str, tuple] = {
    "enable_dp": (None, False), "enable_dp_ldp": (None, False),
    "enable_attack": (None, False), "enable_defense": (None, False),
    "enable_secure_agg": (None, False), "enable_fhe": (None, False),
    "chaos_dropout_prob": (None, 0, 0.0),
    "chaos_straggler_prob": (None, 0, 0.0),
    "chaos_link_loss_prob": (None, 0, 0.0),
    "chaos_link_dup_prob": (None, 0, 0.0),
    "chaos_link_delay_prob": (None, 0, 0.0),
    "chaos_crash_at_round": (None,),
    "chaos_over_sample": (None, 0, 0.0),
    "client_selection": (None, "uniform"),
    "selection_adaptive_oversample": (None, False),
    "checkpoint_dir": (None, ""),
    "checkpoint_every_rounds": (None, 0),
    "client_slot_fold": (None, False),
    "robust_fused": (None, "auto"),
    "robust_relayout_quant": (None, "none"),
    "rounds_per_dispatch": (None,),
    "round_mode": (None, "sync"),
    "mesh_shape": (None,),
    "save_model_path": (None, ""),
}


def check_ported(args) -> None:
    """Raise NotImplementedError for the first knob of an unported
    feature that ``args`` turns on."""
    for knob, off in UNPORTED_KNOBS.items():
        v = getattr(args, knob, None)
        if isinstance(v, str):
            v = v.lower()
        if v not in off:
            raise NotImplementedError(
                f"{knob}={getattr(args, knob)!r} is not ported to "
                f"fedml_tpu_torch yet (slice 1 ports the FedAvg round)")


class FedMLRunner:
    """Dispatch on ``args.training_type`` x ``args.backend``: the port has
    the simulation platform on the GPU backend."""

    def __init__(self, args, device=None, dataset=None, model=None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        check_ported(args)
        ttype = getattr(args, "training_type",
                        FEDML_TRAINING_PLATFORM_SIMULATION)
        if ttype != FEDML_TRAINING_PLATFORM_SIMULATION:
            raise NotImplementedError(
                f"training_type={ttype!r} is not ported to fedml_tpu_torch "
                f"yet (ported: simulation)")
        backend = getattr(args, "backend", FEDML_SIMULATION_TYPE_GPU)
        if backend != FEDML_SIMULATION_TYPE_GPU:
            raise NotImplementedError(
                f"backend={backend!r} is not ported to fedml_tpu_torch yet "
                f"(ported: gpu)")
        from .core.algframe.client_trainer import make_trainer_spec
        from .optimizers.registry import create_optimizer
        from .simulation.gpu.engine import GPUSimulator
        spec = make_trainer_spec(dataset, model)
        opt = create_optimizer(args, spec)
        self.runner = GPUSimulator(args, dataset, model, opt, spec,
                                   get_device(device),
                                   init_params=init_params)

    def run(self, comm_round: Optional[int] = None) -> Any:
        return self.runner.run(comm_round)
