"""Edge-case backdoor evaluation set (a copy of
``fedml_tpu/data/edge_case.py``; no JAX in it).

Parity target: reference ``data/edge_case_examples/`` — out-of-distribution
samples of a source class (e.g. Southwest-livery planes for CIFAR) that a
backdoor adversary trains with a TARGET label; attack success is measured
as the fraction of HELD-OUT edge-case samples the poisoned global model
assigns to the target.

Here edge cases are DERIVED from the task's real data instead of shipped
as a separate download: source-class samples under a fixed strong
transform (intensity inversion + transpose) — far enough off-distribution
that a clean model handles them poorly, consistent enough that a backdoor
generalizes across them. Works for any image-shaped or flat-square-image
dataset in the zoo.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EdgeCaseSet:
    """Poison split (for the adversary's shards) + a held-out eval split."""
    x_poison: np.ndarray
    x_eval: np.ndarray
    source_label: int
    target_label: int


def _transform(x: np.ndarray) -> np.ndarray:
    """Fixed off-distribution transform: invert intensities about the
    per-set max and transpose the spatial axes."""
    flat = x.ndim == 2
    if flat:
        side = int(round(x.shape[-1] ** 0.5))
        x = x.reshape(len(x), side, side)
        out = (x.max() - x).transpose(0, 2, 1)
        return out.reshape(len(out), -1)
    return (x.max() - x).swapaxes(1, 2)


def build_edge_case_set(x: np.ndarray, y: np.ndarray, source_label: int,
                        target_label: int, eval_fraction: float = 0.5,
                        seed: int = 0) -> EdgeCaseSet:
    """Select real samples of ``source_label``, transform them, and split
    into a poison half (train with ``target_label``) and an eval half."""
    x = np.asarray(x)
    y = np.asarray(y).reshape(-1)
    idx = np.flatnonzero(y == source_label)
    if len(idx) < 4:
        raise ValueError(f"too few source-class samples ({len(idx)})")
    rng = np.random.RandomState(seed)
    rng.shuffle(idx)
    edge = _transform(x[idx])
    n_eval = max(int(len(idx) * eval_fraction), 1)
    return EdgeCaseSet(x_poison=edge[n_eval:], x_eval=edge[:n_eval],
                       source_label=int(source_label),
                       target_label=int(target_label))


def attack_success_rate(predict_fn, edge: EdgeCaseSet) -> float:
    """Fraction of held-out edge-case samples classified as the TARGET
    label. ``predict_fn(x) -> [n] int predictions``."""
    preds = np.asarray(predict_fn(edge.x_eval)).reshape(-1)
    return float((preds == edge.target_label).mean())


def inject_edge_cases(fed, edge: EdgeCaseSet, byzantine_mask: np.ndarray):
    """Overwrite the leading samples of each byzantine client's shard with
    edge-case samples labeled TARGET (the reference adversary's data
    poisoning). Returns a new FederatedDataset; clean clients untouched."""
    import dataclasses as _dc

    x = np.array(fed.train.x)
    y = np.array(fed.train.y)
    m = np.array(fed.train.mask)
    n_poison = len(edge.x_poison)
    if n_poison == 0:
        return fed
    for cid in np.flatnonzero(np.asarray(byzantine_mask) > 0):
        flat_x = x[cid].reshape((-1,) + x.shape[3:])
        flat_y = y[cid].reshape(-1)
        flat_m = m[cid].reshape(-1)
        real = np.flatnonzero(flat_m > 0)
        take = real[:min(n_poison, len(real))]
        flat_x[take] = edge.x_poison[:len(take)].reshape(
            (len(take),) + flat_x.shape[1:])
        flat_y[take] = edge.target_label
        x[cid] = flat_x.reshape(x.shape[1:])
        y[cid] = flat_y.reshape(y.shape[1:])
    return _dc.replace(fed, train=_dc.replace(fed.train, x=x, y=y))
