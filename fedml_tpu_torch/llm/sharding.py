"""Parameter sharding for the LLM path (counterpart of
``fedml_tpu/llm/sharding.py``): FSDP + tensor parallelism over DTensor,
and the sequence-parallel forward.

Design, as the JAX package's: Megatron-style tensor parallelism over the
``tensor`` axis (attention heads and the MLP's intermediate split; paired
projections split on the opposite side, so each block needs one reduce),
ZeRO-3 parameter sharding over ``fsdp`` on the remaining large axis, the
batch over ``data`` (and over ``fsdp``: ZeRO-3's ranks each take their own
batch slice), and the sequence over ``sp`` for ring attention.

The JAX package annotates shardings and lets XLA insert the collectives.
Here the parameters are DTensors on the mesh (:func:`shard_llm_params`);
the step (:func:`make_sharded_train_step`) gathers each over ``fsdp`` with
DTensor's ``redistribute`` (an all-gather) and declares its gradient
partial over the batch axes, so DTensor's backward reduce-scatters it
over ``fsdp`` and all-reduces it over ``data``. DTensor has no
tensor-parallel plan for the port's einsum-style ``Dense`` (its
``ColwiseParallel`` / ``RowwiseParallel`` take ``nn.Linear`` only), so the
Megatron collectives are written out as small autograd Functions over the
``tensor`` group (:func:`copy_to_tp`, :func:`reduce_from_tp`,
:func:`gather_from_tp`), which the model's modules apply inside
:func:`tensor_parallel`.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Optional, Tuple

import torch

from ..constants import AXIS_DATA, AXIS_FSDP, AXIS_SEQ, AXIS_TENSOR
from ..core.mesh import placements, fsdp_dim, mesh_sizes
from .attention import ring_axis

Spec = Tuple[Optional[str], ...]

# (group, size, index) of the tensor-parallel ranks around a sharded step
_TP: contextvars.ContextVar[Optional[Tuple[object, int, int]]] = \
    contextvars.ContextVar("fedml_tpu_torch_tensor_parallel", default=None)


def _mesh_axis(sizes: Dict[str, int], name: Optional[str]) -> Optional[str]:
    """Use an axis only if the mesh has it with size > 1."""
    return name if sizes.get(name, 1) > 1 else None


def llm_param_specs(params: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, Spec]:
    """A PartitionSpec-like tuple (one mesh axis or None per dimension) for
    each CausalLM (+ LoRA) parameter, by its flax path:

      q/k/v kernel [h, heads, hd]  -> (fsdp, tensor, -)
      o kernel     [h_attn, h]     -> (tensor, fsdp)
      gate/up      [h, inter]      -> (fsdp, tensor)
      down         [inter, h]      -> (tensor, fsdp)
      embed/lm_head [vocab, h] / [h, vocab] -> (tensor, fsdp)
      norms / biases / LoRA factors -> replicated (under ``tensor`` each
        rank's side path takes its slice of a factor: ``model._tp_factors``)
      anything else: the largest divisible axis over fsdp
    """
    sizes = mesh_sizes(mesh)
    fsdp = _mesh_axis(sizes, AXIS_FSDP)
    tp = _mesh_axis(sizes, AXIS_TENSOR)

    def spec_for(path: Tuple[str, ...], leaf) -> Spec:
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        rest = (None,) * (leaf.dim() - 2)
        if name in ("lora_a", "lora_b") or leaf.dim() <= 1:
            return (None,) * leaf.dim()
        if name == "kernel" and parent in ("q", "k", "v"):
            return (fsdp, tp) + rest
        if name == "kernel" and parent == "o":
            return (tp, fsdp) + rest
        if name == "kernel" and parent in ("gate", "up"):
            return (fsdp, tp) + rest
        if name == "kernel" and parent == "down":
            return (tp, fsdp) + rest
        if name == "embedding" or parent == "lm_head":
            return (tp, fsdp) + rest
        spec = [None] * leaf.dim()
        if fsdp is not None:
            best = fsdp_dim(sizes, tuple(leaf.shape))
            if best is not None:
                spec[best] = fsdp
        return tuple(spec)

    return {k: spec_for(tuple(k.split(".")), v) for k, v in params.items()}


def _check_divisible(key: str, shape, spec: Spec, sizes) -> None:
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % sizes[ax]:
            raise ValueError(f"{key}: dimension {dim} does not split evenly "
                             f"over {ax!r} ({sizes[ax]} ranks)")


def shard_llm_params(params: Dict[str, torch.Tensor], mesh,
                     specs: Optional[Dict[str, Spec]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The parameters as DTensors on ``mesh`` per ``specs``
    (:func:`llm_param_specs` by default): each rank keeps its shard. Every
    rank passes the same full tensors."""
    from torch.distributed.tensor import distribute_tensor
    specs = llm_param_specs(params, mesh) if specs is None else specs
    sizes = mesh_sizes(mesh)
    out = {}
    for k, v in params.items():
        _check_divisible(k, v.shape, specs[k], sizes)
        # a copy: the step updates the shards in place
        out[k] = distribute_tensor(
            v.detach().to(mesh.device_type, copy=True), mesh,
            placements(mesh, specs[k]))
    return out


# -- tensor parallelism: the Megatron collectives ----------------------------

@contextlib.contextmanager
def tensor_parallel(group):
    """Run the causal LM with its parameters split over ``group`` (the
    ``tensor`` axis) by :func:`llm_param_specs`' rules: the model's
    modules then insert the Megatron collectives."""
    import torch.distributed as dist
    token = _TP.set((group, dist.get_world_size(group),
                     dist.get_rank(group)))
    try:
        yield
    finally:
        _TP.reset(token)


def tp_context() -> Optional[Tuple[object, int, int]]:
    """``(group, size, index)`` inside :func:`tensor_parallel`, else
    None."""
    return _TP.get()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from ..core.collectives import psum_packed
    return psum_packed([x], group)[0]


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce of the gradient (the
    input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward (the partial sums of a
    row-parallel layer), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along the last dimension forward; the rank's own slice
    of the gradient backward (every rank's gradient of the gathered tensor
    is the same)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        from ..core.collectives import psum_packed
        ctx.index, ctx.n = index, x.shape[-1]
        full = x.new_zeros(x.shape[:-1] + (x.shape[-1] * size,))
        full[..., index * ctx.n:(index + 1) * ctx.n] = x
        return psum_packed([full], group)[0]

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    tp = _TP.get()
    return x if tp is None else _CopyToTP.apply(x, tp[0])


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    tp = _TP.get()
    return x if tp is None else _ReduceFromTP.apply(x, tp[0])


def gather_from_tp(x: torch.Tensor) -> torch.Tensor:
    tp = _TP.get()
    return x if tp is None else _GatherFromTP.apply(x, *tp)


# -- the sharded step --------------------------------------------------------

def make_sharded_train_step(loss_fn: Callable, optimizer, mesh,
                            params_specs: Dict[str, Spec]):
    """A step ``(params, opt_state, batch, rng) -> (params, opt_state,
    loss)`` over ``mesh``: ``params`` are :func:`shard_llm_params`'
    DTensors (updated in place and returned), ``opt_state`` the inner
    optimizer's state of the local shards (None: made at the first step),
    ``batch`` the full ``{"x", "y", "mask"}`` batch on every rank.

    Each rank takes its rows of the batch (split over ``data`` x
    ``fsdp``), gathers its parameters over ``fsdp`` (DTensor), and runs
    ``loss_fn(params, batch, rng)`` (the causal LM under
    :func:`tensor_parallel` when the ``tensor`` axis is split). The loss's
    aux ``loss_sum`` and ``count`` weight the batch slices exactly: the
    returned loss is the full batch's ``Σ loss_sum / Σ count``, and the
    gradient is its gradient, reduce-scattered over ``fsdp`` and
    all-reduced over ``data`` by DTensor's backward. The optimizer steps
    each rank's shards."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate
    sizes = mesh_sizes(mesh)
    names = mesh.mesh_dim_names
    batch_axes = [a for a in (AXIS_DATA, AXIS_FSDP) if _mesh_axis(sizes, a)]
    tp = _mesh_axis(sizes, AXIS_TENSOR)
    tp_group = mesh.get_group(AXIS_TENSOR) if tp else None
    tp_size = sizes.get(AXIS_TENSOR, 1)
    n_slices, me = 1, 0
    for a in batch_axes:
        n_slices, me = n_slices * sizes[a], me * sizes[a] + \
            mesh.get_local_rank(a)
    gather = {k: [p if n == AXIS_TENSOR else Replicate()
                  for n, p in zip(names, placements(mesh, s))]
              for k, s in params_specs.items()}
    grads = {k: [Partial() if n in batch_axes else p
                 for n, p in zip(names, g)] for k, g in gather.items()}

    def step(params, opt_state, batch, rng=None):
        b = int(batch["x"].shape[0])
        if b % n_slices:
            raise ValueError(f"batch {b} does not split over {batch_axes} "
                             f"({n_slices} slices)")
        rows = slice(me * (b // n_slices), (me + 1) * (b // n_slices))
        local_batch = {k: v[rows] for k, v in batch.items()}
        local = {}
        for k, p in params.items():
            p.requires_grad_(True)
            local[k] = p.redistribute(mesh, gather[k]).to_local(
                grad_placements=grads[k])
        ctx = (tensor_parallel(tp_group) if tp_group is not None
               else contextlib.nullcontext())
        with ctx:
            _, aux = loss_fn(local, local_batch, rng)
        # every tensor rank holds the same sums: the world's sum over
        # them counts each batch slice tp_size times
        tot = torch.stack([aux["loss_sum"].detach().float(),
                           aux["count"].detach().float()])
        from ..core.collectives import psum_packed
        tot = psum_packed([tot], dist.group.WORLD)[0] / tp_size
        count = torch.clamp(tot[1], min=1.0)
        (aux["loss_sum"] / count).backward()
        with torch.no_grad():
            shards = {k: p.to_local() for k, p in params.items()}
            g = {k: p.grad.to_local() for k, p in params.items()}
            if opt_state is None:
                opt_state = optimizer.init(shards)
            optimizer.step_(shards, g, opt_state)
        for p in params.values():
            p.grad = None
        return params, opt_state, tot[0] / count

    return step


# -- sequence parallelism ----------------------------------------------------

def make_ring_forward(model_apply: Callable, mesh,
                      axis_name: str = AXIS_SEQ) -> Callable:
    """Sequence-parallel forward: every rank passes the full ``tokens``
    ``[b, S]`` (and optional ``[b, S]`` key-padding ``attn_mask``, 1 =
    real token); each takes its slice of the sequence over ``axis_name``
    and runs ``model_apply(params, tokens, attn_mask)`` on it with ring
    attention rotating K/V and the mask round the ranks. Returns ``fwd
    (params, tokens, attn_mask=None) -> logits``: this rank's slice
    ``[b, S / size, vocab]``."""
    size = mesh_sizes(mesh)[axis_name]
    group = mesh.get_group(axis_name)
    index = mesh.get_local_rank(axis_name)

    def call(params, tokens, attn_mask=None):
        if attn_mask is None:
            attn_mask = torch.ones(tokens.shape, dtype=torch.int32,
                                   device=tokens.device)
        s = tokens.shape[1]
        if s % size:
            raise ValueError(f"sequence {s} does not split over "
                             f"{axis_name!r} ({size} ranks)")
        cut = slice(index * (s // size), (index + 1) * (s // size))
        with ring_axis(group, size):
            return model_apply(params, tokens[:, cut], attn_mask[:, cut])

    return call
