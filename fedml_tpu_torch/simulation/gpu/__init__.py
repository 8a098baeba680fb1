"""The one-device GPU simulation engine."""

from .engine import GPUSimulator

__all__ = ["GPUSimulator"]
