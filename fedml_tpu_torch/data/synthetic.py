"""Synthetic stand-ins (deterministic, no network).

A copy of the generator in ``fedml_tpu/data/synthetic.py`` that the
CIFAR-shaped stand-in uses: class prototypes plus Gaussian noise, drawn from
one ``RandomState`` so the port's arrays equal the JAX package's exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(
    n_samples: int,
    n_features: int,
    n_classes: int,
    seed: int = 0,
    noise: float = 1.0,
    flat: bool = True,
    image_shape: Tuple[int, ...] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    prototypes = rng.randn(n_classes, n_features).astype(np.float32)
    y = rng.randint(0, n_classes, size=n_samples).astype(np.int32)
    x = prototypes[y] + noise * rng.randn(n_samples, n_features).astype(
        np.float32)
    if not flat and image_shape is not None:
        x = x.reshape((n_samples,) + tuple(image_shape))
    return x, y
