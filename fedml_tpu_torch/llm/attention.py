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
- ``ring``: ring attention over the ranks of a process group (the ``sp``
  mesh axis): each rank holds a slice of the sequence; K/V blocks (and the
  key-padding mask) travel round the ring by point-to-point sends while
  each rank folds the visiting block into an f32 online softmax, so
  context length scales with the number of ranks. The JAX package's fold
  is an XLA program (``ppermute`` in a ``scan``), not a Pallas kernel, so
  it is plain PyTorch here. Runs only inside :func:`ring_axis`.

- ``cached_attention``: decode/prefill attention over a slot's gathered
  cache view (the serving path). An XLA program in the JAX package, not a
  Pallas kernel, so plain PyTorch here.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch

from ..core.kernels import flash_attention as fa

NEG_INF = fa.NEG_INF

# (process group, size) of the ring; set around the sequence-parallel
# forward (llm/sharding.py::make_ring_forward)
_RING_AXIS: contextvars.ContextVar[Optional[Tuple[object, int]]] = \
    contextvars.ContextVar("fedml_tpu_torch_ring_axis", default=None)


@contextlib.contextmanager
def ring_axis(group, size: int):
    """Run ``attention_impl='ring'`` over ``group`` (``size`` ranks, each
    holding one slice of the sequence, in rank order)."""
    token = _RING_AXIS.set((group, int(size)))
    try:
        yield
    finally:
        _RING_AXIS.reset(token)


def ring_index() -> Optional[int]:
    """This rank's place on the ring of the current :func:`ring_axis`
    (None outside one): its sequence slice is the ``index``-th."""
    ax = _RING_AXIS.get()
    if ax is None:
        return None
    import torch.distributed as dist
    return dist.get_rank(ax[0])


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     impl: str = "dense",
                     attn_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Dispatch. q/k/v: [b, s, h, d] -> [b, s, h, d]."""
    if impl == "ring":
        ax = _RING_AXIS.get()
        if ax is None:
            raise RuntimeError(
                "attention_impl='ring' requires the sequence-parallel "
                "context (fedml_tpu.llm.attention.ring_axis) — wrap the "
                "forward in shard_map over the 'sp' axis")
        return ring_causal_attention(q, k, v, group=ax[0], size=ax[1],
                                     attn_mask=attn_mask)
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


def cached_attention(q, k_all, v_all, q_positions):
    """Decode/prefill attention over a position-ordered cached K/V view.

    q: [b, s, h, d] (s = 1 for decode, chunk length for prefill);
    k_all/v_all: [b, T, h, d] — the slot's gathered cache view with the
    current tokens already written at their logical positions;
    q_positions: [b, s] absolute positions of the query rows.

    The live mask is ``key_index <= q_position``; everything later is set
    to NEG_INF through ``where`` (exact-zero probability), and the softmax
    runs over all T keys in f32, term for term as
    :func:`dense_causal_attention`, so a decode step over a
    ``T == max_seq_len`` view agrees with the full forward over the padded
    ``[1, max_seq_len]`` buffer.
    """
    d = q.shape[-1]
    t = k_all.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_all.float()) * scale
    key_idx = torch.arange(t, dtype=torch.int32, device=q.device)
    live = key_idx[None, None, None, :] <= q_positions[:, None, :, None]
    scores = torch.where(live, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_all.float())
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


# ----------------------------------------------------------------- ring ----

def _ring_block(q, k_blk, qpos, kpos, km, scale):
    """Scores of the local queries against one visiting K block, f32
    ``[b, h, s_q, s_k]``, and the ``live`` gate: causal on the global
    positions and the block's key mask."""
    s_blk = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    live = ((qpos[:, None] >= kpos[None, :])[None, None]
            & km.bool()[:, None, None, :])
    return torch.where(live, s_blk, NEG_INF), live


class _Ring(torch.autograd.Function):
    """Ring attention with the JAX package's training-memory contract: the
    forward saves only q, k, v, the key mask, the output and the row
    logsumexp, all O(s_loc·d); no ``[s_loc, s_loc]`` block outlives a
    step. The backward runs a second ring: it recomputes each visiting
    block's probabilities from the LSE, accumulates dQ at home, and
    carries the dK/dV partial sums with their K/V block, so each arrives
    home after ``size`` steps."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, size):
        import torch.distributed as dist
        from ..core.collectives import ring_shift
        b, s_loc, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        me = dist.get_rank(group)
        ar = torch.arange(s_loc, device=q.device)
        qpos = me * s_loc + ar
        o = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                        device=q.device)
        m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        k_cur, v_cur, km = k, v, mask
        for step in range(size):
            src = (me - step) % size
            s_blk, live = _ring_block(q, k_cur, qpos, src * s_loc + ar, km,
                                      scale)
            m_new = torch.maximum(m, s_blk.amax(-1))
            alpha = torch.exp(m - m_new)
            # gate on `live`: a row with no live key has m_new = NEG_INF
            # and exp(NEG_INF - NEG_INF) = 1, which would average V
            p = torch.where(live, torch.exp(s_blk - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v_cur.float())
            m = m_new
            if step + 1 < size:
                k_cur, v_cur, km = ring_shift((k_cur, v_cur, km), group)
        out = (o / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
        out = out.to(q.dtype)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.group, ctx.size = group, size
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        from ..core.collectives import ring_shift
        q, k, v, mask, out, lse = ctx.saved_tensors
        group, size = ctx.group, ctx.size
        b, s_loc, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        me = dist.get_rank(group)
        ar = torch.arange(s_loc, device=q.device)
        qpos = me * s_loc + ar
        gf = g.float()
        dd = (gf * out.float()).sum(-1).transpose(1, 2)     # [b, h, s_q]
        dq = torch.zeros((b, s_loc, h, d), dtype=torch.float32,
                         device=q.device)
        k_cur, v_cur, km = k, v, mask
        dk = torch.zeros_like(dq)
        dv = torch.zeros_like(dq)
        for step in range(size):
            src = (me - step) % size
            s_blk, live = _ring_block(q, k_cur, qpos, src * s_loc + ar, km,
                                      scale)
            p = torch.where(live, torch.exp(s_blk - lse[..., None]), 0.0)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, gf)
            dp = torch.einsum("bqhd,bkhd->bhqk", gf, v_cur.float())
            ds = p * (dp - dd[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds,
                                   k_cur.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
            # the block's partial sums travel on with it; after `size`
            # shifts they are home
            if step + 1 < size:
                k_cur, v_cur, km, dk, dv = ring_shift(
                    (k_cur, v_cur, km, dk, dv), group)
            else:
                dk, dv = ring_shift((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_causal_attention(q, k, v, group=None, size: Optional[int] = None,
                          attn_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Causal attention with the sequence split over ``group``'s ranks:
    q/k/v are this rank's slices ``[b, s_loc, h, d]`` (rank ``i`` holds
    positions ``i·s_loc ..``); ``attn_mask`` its ``[b, s_loc]`` key-padding
    slice (1 = real key), which travels with its K/V block. A query row
    whose visible keys are all padded yields exactly zero. ``group``
    defaults to the whole world."""
    import torch.distributed as dist
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group) if size is None else int(size)
    mask = (torch.ones(q.shape[:2], dtype=torch.float32, device=q.device)
            if attn_mask is None else attn_mask.float().contiguous())
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                       group, size)
