"""``federated_optimizer`` name -> optimizer class (counterpart of
``fedml_tpu/optimizers/registry.py``). Only FedAvg is ported."""

from __future__ import annotations

from .base import FedOptimizer


def create_optimizer(args, spec) -> FedOptimizer:
    name = str(getattr(args, "federated_optimizer", "FedAvg"))
    # "_seq" picks the same math (sequential scheduling is the engine's)
    if name.lower().removesuffix("_seq") != FedOptimizer.name.lower():
        raise NotImplementedError(
            f"federated_optimizer={name!r} is not ported to fedml_tpu_torch "
            f"yet (ported: FedAvg)")
    return FedOptimizer(args, spec)

