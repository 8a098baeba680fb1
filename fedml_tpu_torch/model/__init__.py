"""Models for the ported slice: ``create(args, output_dim) -> ModelBundle``."""

from .model_hub import ModelBundle, create

__all__ = ["ModelBundle", "create"]
