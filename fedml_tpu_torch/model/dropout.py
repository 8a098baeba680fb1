"""flax ``nn.Dropout`` with flax's masks, bit for bit.

In the JAX package a model with dropout draws its masks from the
``dropout`` key the local loop hands ``apply``: each ``Dropout`` module
takes ``make_rng("dropout")``, which flax derives by folding into that key
the first 32 bits of a SHA-1 of the module's scope path and its call count
(``flax/core/scope.py::_fold_in_static``), then keeps an element where
``uniform(key, shape) < 1 - rate`` and scales it by ``1 / (1 - rate)``.
:class:`Dropout` computes the same key and the same bits with
:mod:`fedml_tpu_torch.prng`'s device form, on the activations' device:
inside a captured step the key is a tensor the step derives from a tensor
written before each replay.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch
from torch import nn

from .. import prng


def scope_salt(*path) -> int:
    """flax's ``_fold_in_static`` hash of a scope path (strings and
    non-negative ints, no separators): the first 4 bytes of the SHA-1,
    big-endian."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


class Dropout(nn.Module):
    """``nn.Dropout(rate)`` at top-level scope ``name`` (``Dropout_k``),
    called once per forward. No parameters."""

    def __init__(self, rate: float, name: str):
        super().__init__()
        self.rate = float(rate)
        # make_rng's first call in the module's scope: path (name, 1)
        self.salt = scope_salt(name, 1)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("a training forward with dropout needs the "
                             "dropout key (rng=)")
        keep = 1.0 - self.rate
        mask = prng.bernoulli_t(prng.fold_in_t(rng, self.salt), keep,
                                x.shape)
        return torch.where(mask, x / keep, torch.zeros_like(x))
