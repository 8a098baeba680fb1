"""DP noise mechanisms on parameter dicts (counterpart of
``fedml_tpu/core/dp/mechanisms.py``).

A mechanism adds calibrated noise to a flat parameter dict. The keys and
the noise follow the JAX package's flat layout
(:class:`~fedml_tpu_torch.core.collectives.FlatLayout`): ``split(rng,
n_leaves)`` gives one key per leaf in flax leaf order, each leaf's noise is
drawn in its flax shape and laid onto the port's leaf. All leaves are drawn
in one pass on the tensors' device (``prng.normal_segments_t``, the keys
split there too), so the noise equals ``jax.random``'s bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ... import prng
from ..collectives import FlatLayout, tree_leaves, tree_unflatten

Tree = Dict[str, torch.Tensor]


def gaussian_sigma(epsilon: float, delta: float, sensitivity: float) -> float:
    """Classic analytic calibration sigma = s * sqrt(2 ln(1.25/delta)) / eps
    (Dwork & Roth; reference ``mechanisms/gaussian.py``)."""
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def laplace_scale(epsilon: float, sensitivity: float) -> float:
    return sensitivity / epsilon


def _add_noise(tree: Tree, rng: np.ndarray, scale: float, draw) -> Tree:
    layout = FlatLayout.of(tree)
    dev = next(iter(tree.values())).device
    noise = layout.unflatten(draw(rng, layout.segments(dev)))
    leaves = tree_leaves(tree)
    noised = torch._foreach_add(leaves, torch._foreach_mul(
        tree_leaves(noise, tree), scale))
    return tree_unflatten(tree, noised)


def add_gaussian_noise(tree: Tree, rng: np.ndarray, sigma: float) -> Tree:
    """``leaf + sigma * normal(key_i, leaf.shape)`` per leaf."""
    return _add_noise(tree, rng, sigma, prng.normal_segments_t)


def add_laplace_noise(tree: Tree, rng: np.ndarray, scale: float) -> Tree:
    """``leaf + scale * laplace(key_i, leaf.shape)`` per leaf."""
    return _add_noise(tree, rng, scale, prng.laplace_segments_t)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    """L2-clip the whole tree (the DP sensitivity bound). The float32 sum
    of squares runs over every leaf (from the leaves' norms: one
    multi-tensor op, not one reduction per leaf)."""
    leaves = tree_leaves(tree)
    sq = torch.stack(torch._foreach_norm(leaves)).square().sum()
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(sq), min=1e-12),
                        max=1.0)
    return tree_unflatten(tree, torch._foreach_mul(leaves, scale))


class Gaussian:
    def __init__(self, epsilon: float, delta: float, sensitivity: float = 1.0):
        self.sigma = gaussian_sigma(epsilon, delta, sensitivity)

    def add_noise(self, tree: Tree, rng: np.ndarray) -> Tree:
        return add_gaussian_noise(tree, rng, self.sigma)


class Laplace:
    def __init__(self, epsilon: float, delta: float = 0.0,
                 sensitivity: float = 1.0):
        self.scale = laplace_scale(epsilon, sensitivity)

    def add_noise(self, tree: Tree, rng: np.ndarray) -> Tree:
        return add_laplace_noise(tree, rng, self.scale)


def create_mechanism(name: str, epsilon: float, delta: float,
                     sensitivity: float = 1.0):
    name = (name or "gaussian").lower()
    if name == "gaussian":
        return Gaussian(epsilon, delta, sensitivity)
    if name == "laplace":
        return Laplace(epsilon, delta, sensitivity)
    raise ValueError(f"unknown dp mechanism {name!r}")
