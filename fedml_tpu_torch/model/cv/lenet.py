"""LeNet-5, the cross-device reference model (counterpart of
``fedml_tpu/model/cv/lenet.py``): conv 5x5 ``SAME`` (6) -> relu ->
average pool 2/2, conv 5x5 ``VALID`` (16) -> relu -> average pool 2/2,
then Dense 120 / 84 / ``num_classes``. Names and layouts as in
:mod:`.cnn` (``Conv_k.kernel`` HWIO with a bias, ``Dense_k``).

Both convolutions run as explicit im2col GEMMs (:func:`conv_gemm`):
on the H100, cuDNN's filter gradient of the 1-channel 5x5 stem is ~1e-3
off a float64 reference (relative to its largest entry) with TF32 off,
whatever its deterministic, benchmark and layout settings, where the
GEMM's is at float32 rounding (``chip_smoke.py`` phase 23 (a) holds the
card to the CPU)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.kernels.conv_block import _same_pads
from .cnn import Conv, FlaxInit, _image_shape


def conv_gemm(x: torch.Tensor, w: torch.Tensor,
              pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> torch.Tensor:
    """A stride-1 NHWC x HWIO convolution as one explicit im2col GEMM
    (``unfold``, then a matmul); ``pads`` = ``((top, bottom), (left,
    right))``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    kh, kw, cin, cout = (int(d) for d in w.shape)
    (pt, pb), (pl, pr) = pads
    xn = F.pad(x.to(dt).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    ho, wo = xn.shape[2] - kh + 1, xn.shape[3] - kw + 1
    cols = F.unfold(xn, (kh, kw))                     # [n, cin kh kw, L]
    wm = w.to(dt).permute(3, 2, 0, 1).reshape(cout, cin * kh * kw)
    return (wm @ cols).reshape(x.shape[0], cout, ho, wo).permute(0, 2, 3, 1)


class GemmConv(Conv):
    """:class:`.cnn.Conv` (``SAME``, or ``VALID`` with ``same=False``)
    computed by :func:`conv_gemm`."""

    def __init__(self, cin: int, cout: int, ksize: int, same: bool = True):
        super().__init__(cin, cout, ksize)
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = int(self.kernel.shape[0])
        pads = ((_same_pads(int(x.shape[1]), k, 1),
                 _same_pads(int(x.shape[2]), k, 1)) if self.same
                else ((0, 0), (0, 0)))
        y = conv_gemm(x, self.kernel, pads)
        return y + self.bias.to(y.dtype)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``nn.avg_pool`` over NHWC, ``VALID``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)


class LeNet5(FlaxInit):
    def __init__(self, num_classes: int = 10,
                 input_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = _image_shape(input_shape)
        self.Conv_0 = GemmConv(c, 6, 5)
        self.Conv_1 = GemmConv(6, 16, 5, same=False)
        side = lambda n: (n // 2 - 4) // 2  # noqa: E731
        self.Dense_0 = nn.Linear(side(h) * side(w) * 16, 120)
        self.Dense_1 = nn.Linear(120, 84)
        self.Dense_2 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = avg_pool(torch.relu(self.Conv_0(x)), 2, 2)
        x = avg_pool(torch.relu(self.Conv_1(x)), 2, 2)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)
