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
* what the design does about it: one CTA per sample keeps the input with
  its halo, both intermediates and the GroupNorm statistics in shared
  memory as f32, so each activation is read once and written once. The
  first version computes its convolutions on CUDA cores; its measured time
  and bound are in ``PERF.md``.

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
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

#: flax GroupNorm default epsilon — the unfused path's value
GN_EPS = 1e-6

#: largest channel width routed to the fused kernel (narrow stages only)
MAX_FUSED_CHANNELS = 64

#: shared memory one CTA may use on an H100 (the 227 KB opt-in)
MAX_SMEM_BYTES = 232448

#: threads per CTA, rounded down to a multiple of the channel count
MAX_THREADS = 512

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


def _conv_same(x: torch.Tensor, w: torch.Tensor, strides: int) -> torch.Tensor:
    """NHWC x HWIO convolution with XLA SAME padding."""
    dt = torch.promote_types(x.dtype, w.dtype)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    ph = _same_pads(int(x.shape[1]), kh, strides)
    pw = _same_pads(int(x.shape[2]), kw, strides)
    xn = F.pad(x.to(dt).permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, w.to(dt).permute(3, 2, 0, 1), stride=strides)
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
            [ptr] * 11 + [i32] * 7 + [ctypes.c_float, i32, i32, ptr])
        lib.conv_block_forward.restype = i32
        lib._typed = True
    return lib


def threads_for(c: int) -> int:
    """CTA width: the largest multiple of ``c`` up to 512, so each thread
    always owns one channel (and one GroupNorm group)."""
    return (MAX_THREADS // c) * c


def smem_bytes(h: int, w: int, cin: int, c: int, strides: int,
               groups: int) -> int:
    """Shared memory one CTA needs: x and y1 with their halos, y2, the
    partial sums and the GroupNorm statistics, all f32."""
    ho, wo = -(-h // strides), -(-w // strides)
    floats = ((h + 2) * (w + 2) * cin + (ho + 2) * (wo + 2) * c + ho * wo * c
              + 2 * threads_for(c) + 6 * groups)
    return 4 * floats


def _check(x: torch.Tensor, params: Params, strides: int, groups: int):
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
    if c > MAX_THREADS:
        raise ValueError(f"{c} output channels exceed the kernel's "
                         f"{MAX_THREADS}-thread CTA")
    need = smem_bytes(h, w, cin, c, strides, groups)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"block {h}x{w}x{cin}->{c} needs {need} bytes of shared memory "
            f"per sample, over the {MAX_SMEM_BYTES}-byte limit")


def _launch(x: torch.Tensor, params: Params, strides: int, groups: int,
            eps: float) -> torch.Tensor:
    """One kernel launch on the current stream. Raises on anything the
    kernel does not take, and if the launch is refused."""
    _check(x, params, strides, groups)
    x = x.contiguous()
    p = {k: v.contiguous() for k, v in params.items()}
    n, h, w, cin = (int(d) for d in x.shape)
    c = int(p["w1"].shape[-1])
    out = torch.empty((n, -(-h // strides), -(-w // strides), c),
                      dtype=x.dtype, device=x.device)
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
            threads_for(c), stream)
    if err != 0:
        raise RuntimeError(f"conv_block kernel launch failed: CUDA error "
                           f"{err}")
    fused_block.launches += 1
    return out


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
    launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block runs on cuda (or cpu), not "
                         f"{x.device}")
    names = tuple(params)
    return _FusedBlock.apply(x, int(strides), int(groups), float(eps), names,
                             *(params[k] for k in names))


fused_block.launches = 0
