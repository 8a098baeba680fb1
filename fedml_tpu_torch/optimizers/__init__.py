"""The federated optimizers (counterpart of ``fedml_tpu/optimizers``):
FedAvg, FedProx, FedOpt (sgd / adam / adagrad / yogi server optimizers),
FedSGD, FedLocalSGD, SCAFFOLD, FedNova, FedDyn and Mime."""

from .base import FedOptimizer
from .registry import available_optimizers, create_optimizer, register

# importing registers each optimizer under its reference name
from . import fedprox, fedopt, scaffold, fednova, feddyn, mime  # noqa: F401,E402

__all__ = ["FedOptimizer", "create_optimizer", "available_optimizers",
           "register"]
