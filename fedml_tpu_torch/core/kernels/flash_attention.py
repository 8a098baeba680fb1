"""Causal flash attention with key padding: forward, dQ and dK/dV (CUDA,
Hopper).

Port of the three Pallas TPU kernels of ``fedml_tpu/llm/attention.py``:

* B2 ``_flash_fwd_kernel`` -> :func:`flash_fwd`: O and the per-row f32
  logsumexp, by online softmax over key tiles up to the diagonal;
* B3 ``_flash_dq_kernel`` -> :func:`flash_dq`: dQ = scale·Σ dS·K with
  P recomputed from (Q, K, LSE) and dS = P∘(dO·Vᵀ − D);
* B4 ``_flash_dkv_kernel`` -> :func:`flash_dkv`: dV = Σ Pᵀ·dO and
  dK = Σ dSᵀ·(scale·Q), from the causal diagonal on.

The kernels are in ``csrc/flash_attention.cu``. What bounds them on this
card and what their design does about it is noted there: one CTA per
(batch·head, tile of 64 rows), the other operand streamed through shared
memory in tiles of 64, f32 accumulation in registers, and the backward
split into a dQ kernel and a dK/dV kernel so that no two CTAs write the
same output (no atomics: the backward is bitwise reproducible).

Which kernel runs is fixed by the dtype, one kernel per (kernel, dtype):

============  =======================================  ====================
kernel        bfloat16                                 float32
============  =======================================  ====================
B2 forward    tensor cores (mma.sync bf16, f32 sums)   CUDA cores, f32 FMA
B3 dQ         tensor cores (mma.sync bf16, f32 sums)   CUDA cores, f32 FMA
B4 dK/dV      tensor cores (mma.sync bf16, f32 sums)   CUDA cores, f32 FMA
============  =======================================  ====================

The tensor-core kernels round P (and dS in B3 and B4) to bf16 as the left
operand of their second product, as FlashAttention-2/3 do; S, the softmax
statistics and every sum stay f32. The CUDA-core kernels keep P and dS in
f32, as the JAX kernels do.

Layouts, at every public function: q, k, v, o, dO and the gradients are
``[b, s, h, d]`` (the JAX package's model layout; the kernels read it with
strides, so no transpose to ``[b·h, s, d]`` is made); the key-padding mask
is ``[b, s]`` f32 (1 = real key) or None; LSE is ``[b, h, s]`` f32 (the JAX
kernel's ``[b·h, s, 1]``); D = rowsum(dO∘O) is ``[b, s, h]`` f32. A key is
live for a query iff ``k <= q`` and ``mask[k] > 0``. A query with no live
key gets O = 0 exactly and LSE ≈ −1e30, and contributes nothing to any
gradient; a masked key gets dK = dV = 0 exactly.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
only CPU tensors take the plain PyTorch version beside it
(``reference_*``), which materialises the ``[s, s]`` scores.
``<wrapper>.launches`` counts kernel launches (``captured``: launches
recorded into a CUDA graph; see :func:`.count_launch`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import count_launch

NEG_INF = -1e30

#: rows of Q (B2, B3) or keys (B4) per CTA, and the tile streamed past them
TILE = 64

#: largest head dimension the kernels take
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the numerical goldens, and the CPU path.


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``[b, h, s, s]`` f32 scores of the pre-scaled queries, as the TPU
    kernels form them: ``(q·scale)·kᵀ``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())


def _live(mask: Optional[torch.Tensor], b: int, s: int,
          device) -> torch.Tensor:
    """``[b, 1, s, s]`` bool: key ``k`` is live for query ``q``."""
    live = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    live = live.expand(b, 1, s, s)
    if mask is not None:
        live = live & (mask > 0)[:, None, None, :]
    return live


def reference_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (O ``[b, s, h, d]`` in q's dtype, LSE ``[b, h, s]`` f32)."""
    b, s = q.shape[:2]
    live = _live(mask, b, s, q.device)
    sc = torch.where(live, _scores(q, k), NEG_INF)
    m = sc.amax(-1, keepdim=True)
    # gate on `live`, not only the exp: a row with no live key has
    # m = NEG_INF, and exp(NEG_INF - NEG_INF) = 1 would average V
    p = torch.where(live, torch.exp(sc - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.transpose(
        1, 2)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _probs_and_ds(q, k, v, mask, do, lse, dd):
    """Recomputed P and dS = P∘(dO·Vᵀ − D), both ``[b, h, s, s]`` f32."""
    b, s = q.shape[:2]
    live = _live(mask, b, s, q.device)
    p = torch.where(live, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - dd.permute(0, 2, 1)[..., None])
    return p, ds


def reference_dq(q, k, v, mask, do, lse, dd) -> torch.Tensor:
    """-> dQ ``[b, s, h, d]`` in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, mask, do, lse, dd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def reference_dkv(q, k, v, mask, do, lse, dd
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dK, dV) ``[b, s, h, d]`` in k's and v's dtype."""
    p, ds = _probs_and_ds(q, k, v, mask, do, lse, dd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels.


def _lib():
    from .build import load
    lib = load("flash_attention")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32] * 4 + [f32, i32, ptr]   # b, s, h, d, scale, dtype, stream
        lib.flash_fwd.argtypes = [ptr] * 6 + tail
        lib.flash_bwd_dq.argtypes = [ptr] * 8 + tail
        lib.flash_bwd_dkv.argtypes = [ptr] * 9 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = i32
        lib._typed = True
    return lib


def _check(q, k, v, mask, do=None, lse=None, dd=None):
    """Shapes, dtypes and devices the kernels take; raise on the rest."""
    if q.dim() != 4:
        raise ValueError(f"q must be [b, s, h, d], got {tuple(q.shape)}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is outside the kernels' 1.."
                         f"{MAX_HEAD_DIM}")
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t is not None and (tuple(t.shape) != tuple(q.shape)
                              or t.dtype != q.dtype):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, but q is "
                             f"{q.dtype} {tuple(q.shape)}")
    for name, t, shape in (("mask", mask, (b, s)), ("lse", lse, (b, h, s)),
                           ("dd", dd, (b, s, h))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be {list(shape)} float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (k, v, mask, do, lse, dd):
        if t is not None and t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _call(fn, tensors, q: torch.Tensor, name: str):
    """Launch ``fn`` on the current stream with the problem size of ``q``
    and raise if the launch was refused."""
    b, s, h, d = (int(x) for x in q.shape)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(_ptr(t) for t in tensors), b, s, h, d,
                 1.0 / math.sqrt(d), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _contig(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda (or cpu), not "
                         f"{q.device}")
    return q.device.type == "cpu"


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: -> (O ``[b, s, h, d]`` in q's dtype, LSE ``[b, h, s]`` f32)."""
    if _on_cpu(q):
        return reference_fwd(q, k, v, mask)
    _check(q, k, v, mask)
    q, k, v, mask = _contig(q, k, v, mask)
    b, s, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.numel():
        _call(_lib().flash_fwd, (q, k, v, mask, o, lse), q, "flash_fwd")
        count_launch(flash_fwd)
    return o, lse


def flash_dq(q, k, v, mask, do, lse, dd) -> torch.Tensor:
    """B3: -> dQ ``[b, s, h, d]`` in q's dtype. ``lse`` ``[b, h, s]`` and
    ``dd`` ``[b, s, h]``, both f32."""
    if _on_cpu(q):
        return reference_dq(q, k, v, mask, do, lse, dd)
    _check(q, k, v, mask, do, lse, dd)
    q, k, v, mask, do, lse, dd = _contig(q, k, v, mask, do, lse, dd)
    dq = torch.empty_like(q)
    if q.numel():
        _call(_lib().flash_bwd_dq, (q, k, v, mask, do, lse, dd, dq), q,
              "flash_dq")
        count_launch(flash_dq)
    return dq


def flash_dkv(q, k, v, mask, do, lse, dd
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: -> (dK, dV) ``[b, s, h, d]`` in k's dtype."""
    if _on_cpu(q):
        return reference_dkv(q, k, v, mask, do, lse, dd)
    _check(q, k, v, mask, do, lse, dd)
    q, k, v, mask, do, lse, dd = _contig(q, k, v, mask, do, lse, dd)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _call(_lib().flash_bwd_dkv, (q, k, v, mask, do, lse, dd, dk, dv), q,
              "flash_dkv")
        count_launch(flash_dkv)
    return dk, dv


flash_fwd.launches = flash_fwd.captured = 0
flash_dq.launches = flash_dq.captured = 0
flash_dkv.launches = flash_dkv.captured = 0
