"""``federated_optimizer`` name -> optimizer class (counterpart of
``fedml_tpu/optimizers/registry.py``): one optimizer class serves every
engine."""

from __future__ import annotations

from typing import Dict, List, Type

from .base import FedOptimizer

_REGISTRY: Dict[str, Type[FedOptimizer]] = {}


def register(cls: Type[FedOptimizer]) -> Type[FedOptimizer]:
    _REGISTRY[cls.name.lower()] = cls
    return cls


def create_optimizer(args, spec) -> FedOptimizer:
    name = str(getattr(args, "federated_optimizer", "FedAvg"))
    # "_seq" picks the same math (sequential scheduling is the engine's)
    key = name.lower().removesuffix("_seq")
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown federated_optimizer {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](args, spec)


def available_optimizers() -> List[str]:
    return sorted(_REGISTRY)


register(FedOptimizer)  # FedAvg
