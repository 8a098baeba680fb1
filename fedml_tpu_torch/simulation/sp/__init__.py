"""The single-process golden simulator (the protocol simulators sit beside
it: async_fedavg, hierarchical, decentralized, split_nn, vertical_fl)."""

from .simulator import SPSimulator

__all__ = ["SPSimulator"]
