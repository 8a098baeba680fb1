"""Attention implementations for the LLM path (counterpart of
``fedml_tpu/llm/attention.py``).

- ``dense``: plain causal attention with f32 scores, the numerical golden.
- ``flash``: the flash-attention kernels of
  :mod:`fedml_tpu_torch.core.kernels.flash_attention` for both directions:
  the forward (B2) emits O and the per-query logsumexp; the backward
  recomputes probabilities tile by tile from (Q, K, LSE) in two kernels,
  dQ (B3) and dK/dV (B4), so the ``[s, s]`` score matrix never reaches
  device memory. Key-padding masks are supported. On CPU tensors the same
  autograd Function runs the kernels' plain versions.
- ``ring`` (sequence-parallel over several devices) is not ported yet: it
  belongs to the multi-GPU LLM slice and raises.

The cached/paged decode path (``cached_attention``) belongs to the serving
slice and is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.kernels import flash_attention as fa

NEG_INF = fa.NEG_INF


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     impl: str = "dense",
                     attn_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Dispatch. q/k/v: [b, s, h, d] -> [b, s, h, d]."""
    if impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' (sequence-parallel ring attention) is not "
            "ported to fedml_tpu_torch yet; it belongs to the multi-GPU LLM "
            "slice (ported: dense, flash)")
    if impl == "flash":
        return flash_causal_attention(q, k, v, attn_mask=attn_mask)
    if impl == "dense":
        return dense_causal_attention(q, k, v, attn_mask=attn_mask)
    raise ValueError(f"unknown attention_impl {impl!r} (dense|flash|ring)")


def dense_causal_attention(q, k, v, attn_mask=None):
    """[b, s, h, d] — reference semantics, scores in f32."""
    _, s, _, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    mask = mask[None, None]
    if attn_mask is not None:  # [b, s] key padding
        mask = mask & attn_mask.bool()[:, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp of the JAX package: forward B2 saves
    (q, k, v, mask, O, LSE); backward computes D = rowsum(dO∘O) in f32 from
    the stored O, then B3 and B4. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = fa.flash_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, o, lse = ctx.saved_tensors
        g = g.contiguous()
        dd = (g.float() * o.float()).sum(-1)          # [b, s, h]
        dq = fa.flash_dq(q, k, v, mask, g, lse, dd)
        dk, dv = fa.flash_dkv(q, k, v, mask, g, lse, dd)
        return dq, dk, dv, None


def flash_causal_attention(q, k, v, attn_mask: Optional[torch.Tensor] = None):
    """Flash attention, fused forward and backward. q/k/v ``[b, s, h, d]``
    in float32 or bfloat16, head_dim up to 128; ``attn_mask``: optional
    ``[b, s]`` key-padding mask (1 = real). Any sequence length: the
    kernels bound-check their tiles, so nothing is padded."""
    mask = None if attn_mask is None else attn_mask.float().contiguous()
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask)
