"""The single-process golden simulator."""

from .simulator import SPSimulator

__all__ = ["SPSimulator"]
