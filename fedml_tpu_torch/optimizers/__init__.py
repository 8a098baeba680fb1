"""Federated optimizers of the ported slice (FedAvg)."""

from .base import FedOptimizer
from .registry import create_optimizer

__all__ = ["FedOptimizer", "create_optimizer"]
