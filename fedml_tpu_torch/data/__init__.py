"""Datasets for the ported slice: ``load(args) -> (FederatedDataset,
output_dim)``."""

from .containers import FederatedDataset
from .data_loader import DatasetUnavailableError, load

__all__ = ["DatasetUnavailableError", "FederatedDataset", "load"]
