"""Asymmetric (directed) topologies (reference
``asymmetric_topology_manager.py:7``): directed ring + random out-edges,
rows normalized (column sums unconstrained)."""

from __future__ import annotations

import numpy as np

from .base_topology_manager import BaseTopologyManager


class AsymmetricTopologyManager(BaseTopologyManager):
    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = int(n)
        self.neighbor_num = int(neighbor_num)
        self.seed = seed
        self.topology = np.zeros((self.n, self.n))

    def generate_topology(self) -> None:
        n = self.n
        rng = np.random.RandomState(self.seed)
        adj = np.eye(n)
        for i in range(n):
            adj[i, (i + 1) % n] = 1  # directed ring
            extra = rng.choice(n, size=max(self.neighbor_num - 1, 0),
                               replace=False)
            for j in extra:
                adj[i, j] = 1
        self.topology = adj / adj.sum(axis=1, keepdims=True)
