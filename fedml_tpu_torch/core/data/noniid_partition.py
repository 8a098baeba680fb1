"""Non-IID partitioning (host-side numpy).

A copy of ``fedml_tpu/core/data/noniid_partition.py``: the same draws from
the same ``RandomState`` give exactly the JAX package's client splits.
Hetero Dirichlet partition with per-client balancing, plus the ``homo`` and
``shards`` methods. Output is a dict client_idx → np.ndarray of sample
indices; ``data/containers.py`` pads it into static shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def homo_partition(n_samples: int, num_clients: int,
                   rng: np.random.RandomState) -> Dict[int, np.ndarray]:
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part) for i, part in enumerate(np.array_split(idxs, num_clients))}


def hetero_dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    rng: Optional[np.random.RandomState] = None,
    min_size_floor: int = 1,
) -> Dict[int, np.ndarray]:
    """Dirichlet(alpha) label-skew partition. For each class, draw client
    proportions ~ Dir(alpha), capping clients already above the average share
    (the balancing trick of the reference's
    ``partition_class_samples_with_dirichlet_distribution``). Re-draws until
    every client has at least ``min_size_floor`` samples."""
    rng = rng or np.random.RandomState(0)
    n = labels.shape[0]
    classes = np.unique(labels)
    min_size = 0
    idx_batch = None
    while min_size < min_size_floor:
        idx_batch = [[] for _ in range(num_clients)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, num_clients))
            # balance: zero out clients that already hold >= fair share
            proportions = np.array([
                p * (len(ib) < n / num_clients)
                for p, ib in zip(proportions, idx_batch)])
            s = proportions.sum()
            if s <= 0:
                proportions = np.ones(num_clients) / num_clients
            else:
                proportions = proportions / s
            cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_k, cuts)):
                idx_batch[i].extend(part.tolist())
        min_size = min(len(ib) for ib in idx_batch)
    out = {}
    for i in range(num_clients):
        arr = np.asarray(idx_batch[i], dtype=np.int64)
        rng.shuffle(arr)
        out[i] = arr
    return out


def shard_partition(
    labels: np.ndarray,
    num_clients: int,
    shards_per_client: int = 2,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[int, np.ndarray]:
    """Pathological label-shard partition (McMahan et al. FedAvg paper; the
    reference's MNIST loader uses this shape): sort by label, cut into
    ``num_clients * shards_per_client`` shards, deal each client
    ``shards_per_client`` random shards — most clients see ~2 classes."""
    rng = rng or np.random.RandomState(0)
    order = np.argsort(labels, kind="stable")
    n_shards = num_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    assignment = rng.permutation(n_shards)
    out = {}
    for i in range(num_clients):
        mine = assignment[i * shards_per_client:(i + 1) * shards_per_client]
        arr = np.concatenate([shards[s] for s in mine])
        rng.shuffle(arr)
        out[i] = arr
    return out


def partition(
    labels: np.ndarray,
    num_clients: int,
    method: str = "hetero",
    alpha: float = 0.5,
    seed: int = 0,
) -> Dict[int, np.ndarray]:
    rng = np.random.RandomState(seed)
    if method in ("homo", "iid"):
        return homo_partition(labels.shape[0], num_clients, rng)
    if method in ("hetero", "dirichlet", "noniid"):
        return hetero_dirichlet_partition(labels, num_clients, alpha, rng)
    if method in ("shards", "pathological"):
        return shard_partition(labels, num_clients, rng=rng)
    raise ValueError(f"unknown partition_method {method!r}")
