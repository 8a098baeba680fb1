"""The work each hand-written kernel's function must do: the bytes it
must move (each input read once, each output written once) and its
operations. One definition that ``chip_smoke.py``'s bounds and the
roofline's kernel rows (``core/obs/roofline.py``) both read."""

from __future__ import annotations


def block_cost(n, h, cin, cout, s, itemsize):
    """(bytes, ops) one block must move and do: x, every param and the
    output once each; the conv multiply-adds (2 ops each) plus ~7 ops per
    element for each GroupNorm and 1 each for the ReLUs and the add."""
    ho = -(-h // s)
    proj = s != 1 or cin != cout
    params = 9 * cin * cout + 9 * cout * cout + 4 * cout + (
        cin * cout + 2 * cout if proj else 0)
    nbytes = itemsize * (n * h * h * cin + n * ho * ho * cout + params)
    elems = n * ho * ho * cout
    macs = elems * (9 * cin + 9 * cout + (cin if proj else 0))
    ops = 2 * macs + elems * (7 * (3 if proj else 2) + 3)
    return nbytes, ops


def attention_cost(shape, itemsize, kernel):
    """(bytes, causal FLOPs) the kernel's function must move and do: each
    input read once and each output written once; 2·b·h·(s²/2)·d per
    product, 2 products for B2, 3 for B3 and 4 for B4."""
    b, s, h, d, _ = shape
    t = b * s * h * d * itemsize
    row = b * h * s * 4
    tensors, rows, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3),
                               "dkv": (6, 2, 4)}[kernel]
    return tensors * t + rows * row, products * b * h * s * s * d
