"""Finance / vertical-FL party models (counterpart of
``fedml_tpu/model/finance.py``): a party's feature extractor
(``VFLFeatureExtractor``, the reference's LocalModel), the interactive
head over the fused representations (``VFLClassifier``, DenseModel) and
the lending-club tabular MLP. Each flattens its input; the layers are
flax-named ``Dense_k`` ``torch.nn.Linear`` s."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .cv.cnn import FlaxInit


class _DenseStack(FlaxInit):
    """Flatten -> ``Dense_k`` (relu) per hidden width -> ``Dense`` out."""

    def __init__(self, in_features: int, out: int, hidden: Sequence[int]):
        super().__init__()
        widths = (in_features, *hidden, out)
        self.depth = len(widths) - 1
        for k in range(self.depth):
            self.add_module(f"Dense_{k}", nn.Linear(widths[k], widths[k + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for k in range(self.depth):
            h = getattr(self, f"Dense_{k}")(h)
            if k < self.depth - 1:
                h = torch.relu(h)
        return h


class VFLFeatureExtractor(_DenseStack):
    """One party's tower over its vertical feature slice."""

    def __init__(self, in_features: int, out_dim: int = 32,
                 hidden: Sequence[int] = (64,)):
        super().__init__(in_features, out_dim, hidden)


class VFLClassifier(_DenseStack):
    """A linear layer over the concatenated party representations."""

    def __init__(self, in_features: int, num_classes: int = 2):
        super().__init__(in_features, num_classes, ())


class LendingClubMLP(_DenseStack):
    """Tabular credit-risk MLP (the lending-club standalone baseline)."""

    def __init__(self, in_features: int, num_classes: int = 2,
                 hidden: Sequence[int] = (128, 64)):
        super().__init__(in_features, num_classes, hidden)
