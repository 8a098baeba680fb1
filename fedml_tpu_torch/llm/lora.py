"""LoRA as a transform of the flat parameter dict (counterpart of
``fedml_tpu/llm/lora.py``).

LoRA is data, not module surgery: a flat dict of ``(lora_a, lora_b)``
factor pairs keyed like the targeted kernels
(``layer_0.attn.q.lora_a`` beside ``layer_0.attn.q.kernel``). The forward
merges ``W + (a @ b) * (alpha / rank)`` into the f32 master kernel before
the Dense layer casts it to the compute dtype; gradients flow only through
the adapter dict, and federated aggregation ships the adapter dict alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]

# kernel parents targeted by default: attention projections + MLP
DEFAULT_TARGETS: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")


def _target_keys(params: Params, targets: Sequence[str]):
    out = []
    for key in params:
        path = key.split(".")
        if path[-1] == "kernel" and len(path) >= 2 and path[-2] in targets:
            out.append(key)
    return out


def _prefix(key: str) -> str:
    return key.rsplit(".", 1)[0]


def lora_shapes(params: Params, rank: int = 8,
                targets: Sequence[str] = DEFAULT_TARGETS
                ) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the adapter dict for ``params``: ``lora_a``
    ``[in, rank]`` and ``lora_b`` ``[rank, prod(out)]`` per target."""
    keys = _target_keys(params, targets)
    if not keys:
        raise ValueError(f"no LoRA targets found; targets={tuple(targets)}")
    out: Dict[str, Tuple[int, ...]] = {}
    for key in keys:
        shape = tuple(params[key].shape)
        d_out = 1
        for n in shape[1:]:
            d_out *= int(n)
        out[_prefix(key) + ".lora_a"] = (int(shape[0]), rank)
        out[_prefix(key) + ".lora_b"] = (rank, d_out)
    return out


def lora_init(generator: torch.Generator, params: Params, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Params:
    """A zero-effect adapter dict for the targeted kernels: ``lora_a``
    gaussian with std 1/rank (drawn on the CPU from ``generator``, in
    target order) and ``lora_b`` zeros, so the merged model equals the base
    model exactly. On the device of ``params``."""
    shapes = lora_shapes(params, rank, targets)
    dev = next(iter(params.values())).device
    out: Params = {}
    for key, shape in shapes.items():
        if key.endswith(".lora_a"):
            t = torch.randn(shape, generator=generator) / rank
        else:
            t = torch.zeros(shape)
        out[key] = t.to(dev)
    return out


def lora_merge(params: Params, lora: Params, alpha: float = 16.0) -> Params:
    """Params with ``W + (a @ b) * (alpha / rank)`` at every adapted
    kernel (f32, before any cast to the compute dtype). Differentiable in
    ``lora``."""
    flat = dict(params)
    for key, a in lora.items():
        if not key.endswith(".lora_a"):
            continue
        base_key = _prefix(key) + ".kernel"
        b = lora[_prefix(key) + ".lora_b"]
        kernel = flat[base_key]
        delta = (a @ b) * (alpha / a.shape[1])
        flat[base_key] = kernel + delta.reshape(kernel.shape).to(kernel.dtype)
    return flat


def lora_zero_like(lora: Params) -> Params:
    """An all-zero adapter with ``lora``'s structure."""
    return {k: torch.zeros_like(v) for k, v in lora.items()}


def lora_param_count(lora: Params) -> int:
    return int(sum(int(p.numel()) for p in lora.values()))


def make_lora_apply(apply_fn: Callable[..., torch.Tensor], base_params: Params,
                    alpha: float = 16.0) -> Callable[..., torch.Tensor]:
    """Close over frozen base params: returns ``apply(lora, x, **kw)`` so
    the adapter dict is the only trainable dict the algorithm frame
    sees."""

    def apply(lora: Params, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return apply_fn(lora_merge(base_params, lora, alpha), x, **kwargs)

    return apply
