"""Topology managers for decentralized FL (a copy of
``fedml_tpu/core/distributed/topology``; reference
``core/distributed/topology/``: ``base_topology_manager.py:4``,
``symmetric_topology_manager.py:7``, ``asymmetric_topology_manager.py:7``).

A topology is an [n, n] row-stochastic mixing matrix; neighbor lists derive
from its sparsity. ``to_ppermute_pairs`` gives the directed edges as
(src, dst) pairs, the form the JAX engine's ``ppermute`` takes.
"""

from .base_topology_manager import BaseTopologyManager
from .symmetric_topology_manager import SymmetricTopologyManager
from .asymmetric_topology_manager import AsymmetricTopologyManager

__all__ = ["BaseTopologyManager", "SymmetricTopologyManager",
           "AsymmetricTopologyManager"]
