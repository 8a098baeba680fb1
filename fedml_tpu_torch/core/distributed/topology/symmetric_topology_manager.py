"""Symmetric (undirected) topologies (reference
``symmetric_topology_manager.py:7``): ring with ``neighbor_num`` hops each
side plus optional random extra edges, symmetrized, rows normalized."""

from __future__ import annotations

import numpy as np

from .base_topology_manager import BaseTopologyManager


class SymmetricTopologyManager(BaseTopologyManager):
    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = int(n)
        self.neighbor_num = int(neighbor_num)
        self.seed = seed
        self.topology = np.zeros((self.n, self.n))

    def generate_topology(self) -> None:
        n, k = self.n, self.neighbor_num
        adj = np.eye(n)
        for i in range(n):
            for h in range(1, k // 2 + 1):
                adj[i, (i + h) % n] = 1
                adj[i, (i - h) % n] = 1
        adj = np.maximum(adj, adj.T)  # symmetric
        self.topology = adj / adj.sum(axis=1, keepdims=True)

    def generate_custom_topology(self, adj: np.ndarray) -> None:
        adj = np.maximum(np.asarray(adj, float), np.asarray(adj, float).T)
        np.fill_diagonal(adj, 1.0)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
