"""Causal LM for the FedLLM path (counterpart of ``fedml_tpu/llm/model.py``).

A Llama-style decoder (RMSNorm / rotary / SwiGLU) in PyTorch that keeps
the flax module's parameter names and layouts, so a flax tree maps onto its
``state_dict`` path for path (:mod:`fedml_tpu_torch.interop`):
``layer_i.attn.{q,k,v}.kernel`` ``[h, heads, head_dim]``,
``layer_i.attn.o.kernel`` ``[heads·head_dim, h]``,
``layer_i.mlp.{gate,up,down}.kernel`` ``[in, out]``,
``layer_i.ln_{attn,mlp}.scale``, ``ln_f.scale``, ``embed.embedding``
``[vocab, h]`` and, when untied, ``lm_head.kernel`` ``[h, vocab]``.

Mixed precision is per op, as flax does it, not a blanket cast of the
parameters: parameters are f32 masters; each Dense layer and the embedding
cast their input and kernel to the compute dtype; RMSNorm takes its
statistics in f32 and multiplies by its f32 scale before casting back;
rotary embedding rotates in f32 and casts back; residual adds run in the
compute dtype; logits are f32.

Cache-aware path (continuous-batching serving): ``positions`` ``[b, s]``
absolute positions (out-of-range values mark padded or inactive rows whose
cache writes are dropped), ``kv_view`` per-layer ``(k_all, v_all)``
gathered cache views ``[b, T, kv_heads, head_dim]``, and ``adapters`` a
flat LoRA dict under the flax names (``layer_0.attn.q.lora_a`` ...), each
leaf either shared (``[d_in, r]``) or per slot (``[b, d_in, r]``) —
applied as factored f32 side paths, never merged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class LLMConfig:
    """Static architecture config (reference ``ModelArguments``,
    ``configurations.py:156``, minus the HF-hub plumbing)."""

    vocab_size: int = 512
    hidden_size: int = 128
    intermediate_size: int = 352
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: Optional[int] = None  # grouped-query attention; None = MHA
    max_seq_len: int = 256
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    # compute dtype for activations/matmuls; params stay float32 masters
    dtype: str = "float32"
    # attention implementation: "dense" | "flash" (the CUDA kernels)
    attention_impl: str = "dense"
    # tie input embedding and LM head (small models)
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown LLM dtype {self.dtype!r} "
                             f"({'|'.join(_DTYPES)})")
        return _DTYPES[self.dtype]

    def flops_per_token(self) -> float:
        """Approximate fwd+bwd FLOPs per token (6 * params + attention),
        used by the bench's MFU report."""
        p = self.param_count()
        attn = 12 * self.num_layers * self.hidden_size * self.max_seq_len
        return 6.0 * p + attn

    def param_count(self) -> int:
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (h * h * 2 +                       # q, o
                     2 * h * self.kv_heads * self.head_dim +  # k, v
                     3 * h * i +                       # gate, up, down
                     2 * h)                            # 2 rmsnorms
        emb = v * h if self.tie_embeddings else 2 * v * h
        return self.num_layers * per_layer + emb + h


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary position embedding, half-split rotation computed in f32.
    x: [b, s, heads, head_dim]; positions: [b, s]."""
    half = x.shape[-1] // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32),
                     -torch.arange(0, half, dtype=torch.float32) / half)
    ang = positions[..., None].float() * freq.to(x.device)  # [b, s, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _trunc_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal at ±2σ with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return t


class Dense(nn.Module):
    """flax ``DenseGeneral`` over the last axis without bias: kernel
    ``[in, *features]`` f32; input and kernel cast to the compute dtype."""

    def __init__(self, in_features: int, features: Tuple[int, ...],
                 dtype: torch.dtype):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, *features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(_trunc_normal(self.kernel.shape,
                                            self.kernel.shape[0], gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.to(self.dtype)
        y = x.to(self.dtype) @ k.reshape(k.shape[0], -1)
        return y.reshape(*x.shape[:-1], *self.features)


class Embed(nn.Module):
    """flax ``Embed``: table ``[vocab, h]`` f32, looked up (and attended)
    in the compute dtype."""

    def __init__(self, vocab: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(
                self.embedding.shape[1]), generator=gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.embedding.to(self.dtype).t()


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        normed = xf * torch.rsqrt(var + self.eps)
        return (normed * self.scale).to(x.dtype)


def _lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Low-rank side path ``(x @ a) @ b * scale`` in f32 (the S-LoRA batched
    apply: adapters stay factored, so a per-slot adapter gather is two small
    products, not a weight copy). Leaves are shared ``[d_in, r]`` /
    ``[r, d_out]`` or per slot ``[b, d_in, r]`` / ``[b, r, d_out]``."""
    xf = x.float()
    if a.dim() == 3:   # per-slot adapters
        h = torch.einsum("bsd,bdr->bsr", xf, a)
        return torch.einsum("bsr,bro->bso", h, b) * scale
    return ((xf @ a) @ b) * scale


def _adapted(dense: "Dense", name: str, x: torch.Tensor, adapter,
             scale: float) -> torch.Tensor:
    """``dense(x)`` plus the LoRA side path of ``adapter[name]`` when the
    adapter has one (``adapter``: flat ``{"q.lora_a": ..., ...}``)."""
    y = dense(x)
    if adapter is not None and f"{name}.lora_a" in adapter:
        delta = _lora_delta(x, adapter[f"{name}.lora_a"],
                            adapter[f"{name}.lora_b"], scale)
        y = y + delta.reshape(y.shape).to(y.dtype)
    return y


def _write_view(view: torch.Tensor, positions: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """The view with ``rows`` ``[b, s, H, D]`` written at ``positions``
    ``[b, s]``, as f32; rows whose position lies outside ``[0, T)`` are
    dropped (XLA's ``mode="drop"``). ``index_put_`` has no drop mode, and an
    out-of-range index raises on the CPU and asserts on the card, so the
    view gets one spare row ``T`` that every dropped row writes, and it is
    cut off again: no host sync, and a dropped row never lands on a kept
    position."""
    b, t = view.shape[:2]
    ext = torch.cat([view.float(), view.new_zeros(
        (b, 1) + tuple(view.shape[2:]), dtype=torch.float32)], dim=1)
    keep = (positions >= 0) & (positions < t)
    pos = torch.where(keep, positions.long(), t)
    bidx = torch.arange(b, device=view.device)[:, None].expand_as(pos)
    ext.index_put_((bidx, pos), rows.to(view.dtype).float())
    return ext[:, :t]


class Attention(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.q = Dense(h, (cfg.num_heads, cfg.head_dim), dt)
        self.k = Dense(h, (cfg.kv_heads, cfg.head_dim), dt)
        self.v = Dense(h, (cfg.kv_heads, cfg.head_dim), dt)
        self.o = Dense(cfg.num_heads * cfg.head_dim, (h,), dt)

    def forward(self, x, positions, attn_mask=None, kv_view=None,
                adapter=None, lora_scale: float = 1.0):
        """Default path (``kv_view=None``): full causal self-attention,
        returns ``(out, None)``. Cache path: ``kv_view = (k_all, v_all)``
        position-ordered views ``[b, T, kv_heads, head_dim]`` of the slots'
        cached keys/values; the current tokens' K/V are written into the
        view at ``positions`` before attending, and returned as
        ``(out, (k_cur, v_cur))`` for the caller to scatter into the paged
        pool. ``adapter``: optional flat ``{q,k,v,o}.lora_{a,b}`` side
        paths."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = _adapted(self.q, "q", x, adapter, lora_scale)
        k = _adapted(self.k, "k", x, adapter, lora_scale)
        v = _adapted(self.v, "v", x, adapter, lora_scale)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        rep = cfg.num_heads // cfg.kv_heads
        from .attention import cached_attention, causal_attention
        if kv_view is not None:
            new_kv = (k, v)
            # the views are lifted to f32 here, as cached_attention would:
            # the values written are the compute-dtype K/V, exactly
            k_all = _write_view(kv_view[0], positions, k)
            v_all = _write_view(kv_view[1], positions, v)
            if rep != 1:
                k_all = k_all.repeat_interleave(rep, dim=2)
                v_all = v_all.repeat_interleave(rep, dim=2)
            out = cached_attention(q, k_all, v_all, positions)
        else:
            new_kv = None
            if rep != 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = causal_attention(q, k, v, impl=cfg.attention_impl,
                                   attn_mask=attn_mask)
        out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
        return _adapted(self.o, "o", out, adapter, lora_scale), new_kv


class MLP(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        h, i, dt = cfg.hidden_size, cfg.intermediate_size, cfg.compute_dtype
        self.gate = Dense(h, (i,), dt)
        self.up = Dense(h, (i,), dt)
        self.down = Dense(i, (h,), dt)

    def forward(self, x, adapter=None, lora_scale: float = 1.0):
        gate = _adapted(self.gate, "gate", x, adapter, lora_scale)
        up = _adapted(self.up, "up", x, adapter, lora_scale)
        return _adapted(self.down, "down", F.silu(gate) * up, adapter,
                        lora_scale)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.attn = Attention(cfg)
        self.mlp = MLP(cfg)
        self.ln_attn = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.ln_mlp = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, x, positions, attn_mask=None, kv_view=None,
                adapter=None, lora_scale: float = 1.0):
        attn = mlp = None
        if adapter is not None:
            attn = _sub(adapter, "attn.")
            mlp = _sub(adapter, "mlp.")
        a_out, new_kv = self.attn(self.ln_attn(x), positions, attn_mask,
                                  kv_view=kv_view, adapter=attn,
                                  lora_scale=lora_scale)
        h = x + a_out
        h = h + self.mlp(self.ln_mlp(h), adapter=mlp, lora_scale=lora_scale)
        return h, new_kv


def _sub(flat, prefix: str):
    """The entries of a flat dict under ``prefix``, with it stripped."""
    n = len(prefix)
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix)}


class CausalLM(nn.Module):
    """Decoder-only LM. ``forward(tokens [b, s]) -> logits [b, s, vocab]``
    (f32).

    Cache-aware path: pass ``positions`` and ``kv_view`` (one
    ``(k_all, v_all)`` per layer) and it returns
    ``(logits, [(k_cur, v_cur), ...])`` for the caller to scatter into its
    paged pool; ``adapters`` (flat LoRA dict, shared or per-slot leaves)
    with ``lora_scale`` adds the factored side paths."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, dt)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg))
        self.ln_f = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.hidden_size, (cfg.vocab_size,), dt)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Fresh parameters from ``gen`` (flax's initializers: LeCun
        truncated normal kernels, N(0, 1/h) embedding, unit norm scales),
        drawn in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, tokens, train: bool = False, attn_mask=None,
                positions=None, kv_view=None, adapters=None,
                lora_scale: float = 1.0):
        del train  # no dropout in the decoder
        cfg = self.cfg
        x = self.embed(tokens)
        if positions is None:
            pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                               device=tokens.device)
            positions = pos[None, :].expand(tokens.shape)
        new_kvs = []
        for i in range(cfg.num_layers):
            x, new_kv = getattr(self, f"layer_{i}")(
                x, positions, attn_mask,
                kv_view=None if kv_view is None else kv_view[i],
                adapter=None if adapters is None
                else _sub(adapters, f"layer_{i}."),
                lora_scale=lora_scale)
            new_kvs.append(new_kv)
        x = self.ln_f(x)
        if cfg.tie_embeddings:
            logits = self.embed.attend(x)
        else:
            logits = self.lm_head(x)
        logits = logits.float()
        if kv_view is not None:
            return logits, new_kvs
        return logits


def init_llm(cfg: LLMConfig, generator: Optional[torch.Generator] = None
             ) -> Tuple[CausalLM, Params]:
    """Build the module with parameters drawn from ``generator`` (seed 0
    when None), on the CPU; returns it and its parameters as a flat dict
    under the flax names."""
    model = CausalLM(cfg)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    model.reset_parameters(gen)
    return model, {k: v.detach() for k, v in model.state_dict().items()}


def count_params(params: Params) -> int:
    return int(sum(int(p.numel()) for p in params.values()))
