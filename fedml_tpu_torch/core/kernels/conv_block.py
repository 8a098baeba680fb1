"""Fused conv -> GroupNorm -> residual-add -> ReLU block (CUDA, Hopper).

Port of ``fedml_tpu/core/kernels/conv_block.py``. The ResNet-56 BasicBlock

    conv3x3(s) -> GN -> relu -> conv3x3 -> GN -> (+residual|proj) -> relu

runs as ONE launch of a hand-written CUDA kernel (``csrc/conv_block.cu``),
which replaces the Pallas TPU kernel
``fedml_tpu/core/kernels/conv_block.py::_block_kernel``:

* what bounds it: at ResNet-56's narrow (16-64 channel) stages the block's
  arithmetic is small next to the bytes the unfused chain moves through
  device memory (every GroupNorm and residual op re-reads the full
  activation), so the ideal kernel is bytes-bound;
* what the design does about it: every intermediate stays on chip, so each
  activation is read once and written once. In bfloat16 a thread-block
  cluster of :func:`cluster_for` CTAs covers one sample, each CTA a band of
  output rows (:func:`bands`); the convolutions run on the tensor cores as
  implicit GEMMs, and GroupNorm's statistics and conv2's halo rows cross the
  cluster through distributed shared memory. In float32 one CTA per sample
  keeps everything in shared memory as f32 and computes on the CUDA cores.
  The source note says more; the measured times and bounds are in
  ``PERF.md``.

Public functions keep the JAX package's layout: NHWC activations, HWIO
weights, GroupNorm scale/bias ``[C]``, the same ``params`` dict keys
(``w1``, ``g1_scale``, ``g1_bias``, ``w2``, ``g2_*``, and for a strided or
channel-changing block ``wp``, ``gp_*``).

:func:`fused_block` launches the kernel for a CUDA tensor and raises if it
cannot; only a tensor on the CPU takes :func:`reference_block`, the plain
PyTorch version. Its gradient recomputes :func:`reference_block` under
autograd, exactly the JAX package's ``_fused_bwd``: nothing from the
kernel's on-chip intermediates is saved.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import count_launch
from .cost import block_cost

#: flax GroupNorm default epsilon — the unfused path's value
GN_EPS = 1e-6

#: largest channel width routed to the fused kernel (narrow stages only)
MAX_FUSED_CHANNELS = 64

#: shared memory one CTA may use on an H100 (the 227 KB opt-in)
MAX_SMEM_BYTES = 232448

#: float32 kernel: threads per CTA, rounded down to a multiple of the
#: channel count
MAX_THREADS = 512

#: bfloat16 kernel: channel counts it takes (in and out), warps per CTA,
#: 16x16 output units a warp holds in registers per convolution, the
#: largest (portable) cluster, and the SMs a grid should fill
MMA_WIDTHS = (16, 32, 64)
MMA_WARPS = 8
MMA_UNITS = 4
MAX_CLUSTER = 8
NUM_SMS = 132

Params = Dict[str, torch.Tensor]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain PyTorch reference — the numerical golden, and the backward recompute.


def _same_pads(extent: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME" padding: a 3x3 stride-2 conv on an even extent pads
    (0, 1), where torch's ``padding=1`` would pad (1, 1)."""
    out = -(-extent // stride)
    total = max((out - 1) * stride + k - extent, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, strides: int,
               groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO convolution with XLA SAME padding. ``groups`` is flax's
    ``feature_group_count``: the kernel is ``[kh, kw, cin / groups,
    cout]`` (a depthwise conv's ``[k, k, 1, C]`` with ``groups = C``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    ph = _same_pads(int(x.shape[1]), kh, strides)
    pw = _same_pads(int(x.shape[2]), kw, strides)
    xn = F.pad(x.to(dt).permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, w.to(dt).permute(3, 2, 0, 1), stride=strides,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float) -> torch.Tensor:
    """flax GroupNorm semantics: f32 one-pass stats per (sample, group),
    normalized output scaled/shifted and cast back to the input dtype."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h, w, groups, c // groups).float()
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = xg.square().mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * scale.float() + bias.float()
    return y.to(torch.promote_types(x.dtype, scale.dtype))


def reference_block(x: torch.Tensor, params: Params, *, strides: int = 1,
                    groups: int = 8, eps: float = GN_EPS) -> torch.Tensor:
    """Plain PyTorch BasicBlock math on an explicit param dict — mirrors
    ``fedml_tpu/core/kernels/conv_block.py:reference_block`` term for
    term."""
    y = _conv_same(x, params["w1"], strides)
    y = _group_norm(y, params["g1_scale"], params["g1_bias"], groups, eps)
    y = torch.relu(y)
    y = _conv_same(y, params["w2"], 1)
    y = _group_norm(y, params["g2_scale"], params["g2_bias"], groups, eps)
    if "wp" in params:
        r = _conv_same(x, params["wp"], strides)
        r = _group_norm(r, params["gp_scale"], params["gp_bias"], groups,
                        eps)
    else:
        r = x
    return torch.relu(r + y)


# ---------------------------------------------------------------------------
# The CUDA kernel.


def _lib():
    from .build import load
    lib = load("conv_block")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv_block_forward.argtypes = (
            [ptr] * 11 + [i32] * 7 + [ctypes.c_float, i32, i32, i32, ptr])
        lib.conv_block_forward.restype = i32
        lib.conv_block_mma_smem_bytes.argtypes = [i32] * 6
        lib.conv_block_mma_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def threads_for(c: int) -> int:
    """CTA width: the largest multiple of ``c`` up to 512, so each thread
    always owns one channel (and one GroupNorm group)."""
    return (MAX_THREADS // c) * c


def _out_extent(h: int, w: int, strides: int) -> Tuple[int, int]:
    return -(-h // strides), -(-w // strides)


def _units(rows: int, wo: int, c: int) -> int:
    """16-pixel x 16-channel output units of a band of ``rows`` rows."""
    return -(-rows * wo // 16) * (c // 16)


def cluster_for(n: int, h: int, w: int, c: int, strides: int) -> int:
    """CTAs per sample of the bfloat16 kernel: the largest of 8, 4, 2, 1
    with ``n`` x that many CTAs on the card's 132 SMs, at most the output
    height (each CTA keeps at least one row), and raised until a band's
    output units fit the warps' registers. Raises if none does."""
    ho, wo = _out_extent(h, w, strides)
    cap = min(MAX_CLUSTER, ho)
    k = min(next((k for k in (8, 4, 2) if n * k <= NUM_SMS), 1), cap)
    while _units(-(-ho // k), wo, c) > MMA_WARPS * MMA_UNITS:
        if k == cap:
            raise ValueError(
                f"block {h}x{w}->{c} at stride {strides}: a band of "
                f"{-(-ho // k)} output rows holds more than the "
                f"{MMA_WARPS * MMA_UNITS} output units the kernel keeps in "
                f"registers")
        k += 1
    return k


def bands(ho: int, cluster: int) -> List[Tuple[int, int]]:
    """Output rows ``[start, stop)`` of each CTA of a cluster, by rank (as
    the kernel splits them)."""
    return [(r * ho // cluster, (r + 1) * ho // cluster)
            for r in range(cluster)]


def _align128(v: int) -> int:
    return -(-v // 128) * 128


def smem_bytes(h: int, w: int, cin: int, c: int, strides: int,
               groups: int, dtype: torch.dtype = torch.float32,
               cluster: int = 1) -> int:
    """Shared memory one CTA needs. float32: x and y1 with their halos, y2,
    the partial sums and the GroupNorm statistics of one sample, all f32.
    bfloat16 (``cluster`` CTAs per sample): the tallest band's input rows
    with their halo and its y1 rows with theirs (bf16), the larger conv's
    weights and the projection's (bf16), per-warp column sums, the cluster
    partials, the statistics and the GroupNorm params (f32); as
    ``csrc/conv_block.cu::band_layout``."""
    ho, wo = _out_extent(h, w, strides)
    if dtype == torch.bfloat16:
        rmax = -(-ho // cluster)
        parts = (((rmax - 1) * strides + 3) * (w + 2) * cin * 2,
                 (rmax + 2) * (wo + 2) * c * 2, 9 * max(cin, c) * c * 2,
                 cin * c * 2, 2 * MMA_WARPS * c * 2 * 4, 3 * c * 2 * 4,
                 3 * c * 2 * 4, 6 * c * 4)
        return sum(_align128(b) for b in parts)
    floats = ((h + 2) * (w + 2) * cin + (ho + 2) * (wo + 2) * c + ho * wo * c
              + 2 * threads_for(c) + 6 * groups)
    return 4 * floats


def _check(x: torch.Tensor, params: Params, strides: int,
           groups: int) -> int:
    """Raise on what the kernel for x's dtype does not take; return the
    CTAs per sample (the bfloat16 kernel's cluster, 1 in float32)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_block kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    n, h, w, cin = (int(d) for d in x.shape)
    c = int(params["w1"].shape[-1])
    want = {"w1": (3, 3, cin, c), "g1_scale": (c,), "g1_bias": (c,),
            "w2": (3, 3, c, c), "g2_scale": (c,), "g2_bias": (c,)}
    if "wp" in params:
        want.update({"wp": (1, 1, cin, c), "gp_scale": (c,),
                     "gp_bias": (c,)})
    elif strides != 1 or cin != c:
        raise ValueError("a strided or channel-changing block needs the "
                         "projection params wp/gp_scale/gp_bias")
    if set(params) != set(want):
        raise ValueError(f"params keys {sorted(params)} != {sorted(want)}")
    for k, shape in want.items():
        p = params[k]
        if tuple(p.shape) != shape:
            raise ValueError(f"{k}: shape {tuple(p.shape)} != {shape}")
        if p.dtype != x.dtype or p.device != x.device:
            raise TypeError(f"{k}: {p.dtype} on {p.device}, but x is "
                            f"{x.dtype} on {x.device}")
    if strides not in (1, 2):
        raise ValueError(f"strides must be 1 or 2, got {strides}")
    if groups < 1 or c % groups:
        raise ValueError(f"groups={groups} must divide {c} channels")
    cluster = 1
    if x.dtype == torch.bfloat16:
        if cin not in MMA_WIDTHS or c not in MMA_WIDTHS:
            raise ValueError(f"the bfloat16 kernel takes {MMA_WIDTHS} "
                             f"channels, got {cin}->{c}")
        cluster = cluster_for(n, h, w, c, strides)
    elif c > MAX_THREADS:
        raise ValueError(f"{c} output channels exceed the kernel's "
                         f"{MAX_THREADS}-thread CTA")
    need = smem_bytes(h, w, cin, c, strides, groups, x.dtype, cluster)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"block {h}x{w}x{cin}->{c} needs {need} bytes of shared memory "
            f"per CTA, over the {MAX_SMEM_BYTES}-byte limit")
    return cluster


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x: torch.Tensor, params: Params, strides: int, groups: int,
            eps: float) -> torch.Tensor:
    """One kernel launch on the current stream. Raises on anything the
    kernel does not take, and if the launch is refused."""
    cluster = _check(x, params, strides, groups)
    # 16-byte aligned, as the bfloat16 kernel's cp.async copies need
    x, p = _aligned(x), {k: _aligned(v) for k, v in params.items()}
    n, h, w, cin = (int(d) for d in x.shape)
    c = int(p["w1"].shape[-1])
    out = torch.empty((n, *_out_extent(h, w, strides), c), dtype=x.dtype,
                      device=x.device)
    if n == 0:
        return out
    # a null projection pointer selects the identity residual
    ptrs = [p[k].data_ptr() if k in p else None for k in (
        "w1", "g1_scale", "g1_bias", "w2", "g2_scale", "g2_bias", "wp",
        "gp_scale", "gp_bias")]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().conv_block_forward(
            x.data_ptr(), *ptrs, out.data_ptr(), n, h, w, cin, c,
            int(strides), int(groups), float(eps), _DTYPES[x.dtype],
            threads_for(c), cluster, stream)
    if err != 0:
        raise RuntimeError(f"conv_block kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(fused_block, lambda: _work(x, p, out, strides))
    return out


def _work(x, params, out, strides):
    """The launch's roofline row: operand and output shapes and
    :func:`.cost.block_cost` (square images, as ResNet's)."""
    from ..obs.roofline import shape_str
    nbytes, ops = block_cost(int(x.shape[0]), int(x.shape[1]),
                             int(x.shape[3]), int(out.shape[3]),
                             int(strides), x.element_size())
    operands = [shape_str(x)] + [shape_str(params[k])
                                 for k in ("w1", "w2", "wp") if k in params]
    return operands, shape_str(out), nbytes, ops


class _FusedBlock(torch.autograd.Function):
    """Kernel forward (the plain version for a CPU tensor), reference-
    recompute backward: ``_fused_fwd``/``_fused_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, strides, groups, eps, names, *leaves):
        params = dict(zip(names, leaves))
        ctx.save_for_backward(x, *leaves)
        ctx.cfg = (strides, groups, eps, names)
        if x.device.type == "cpu":
            return reference_block(x, params, strides=strides,
                                   groups=groups, eps=eps)
        return _launch(x, params, strides, groups, eps)

    @staticmethod
    def backward(ctx, g):
        strides, groups, eps, names = ctx.cfg
        x, *leaves = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = reference_block(x, dict(zip(names, leaves)),
                                  strides=strides, groups=groups, eps=eps)
            grads = torch.autograd.grad(out, [x, *leaves], g)
        return (grads[0], None, None, None, None, *grads[1:])


def fused_block(x: torch.Tensor, params: Params, *, strides: int = 1,
                groups: int = 8, eps: float = GN_EPS) -> torch.Tensor:
    """The fused BasicBlock: the CUDA kernel forward for a CUDA tensor (the
    plain :func:`reference_block` only for a CPU tensor), reference-
    recompute backward. Same signature and params as
    :func:`reference_block`. ``fused_block.launches`` counts kernel
    launches (``captured``: launches recorded into a CUDA graph; see
    :func:`.count_launch`)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block runs on cuda (or cpu), not "
                         f"{x.device}")
    names = tuple(params)
    return _FusedBlock.apply(x, int(strides), int(groups), float(eps), names,
                             *(params[k] for k in names))


fused_block.launches = fused_block.captured = 0
fused_block.analysed = 0
