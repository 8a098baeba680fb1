"""Tree helpers of the round (counterpart of the tree half of
``fedml_tpu/core/collectives.py``).

The port's pytrees are nested dicts of tensors (``Params`` and the
optimizers' states and extras). Each helper walks them in the first
tree's key order and runs the leaf arithmetic as multi-tensor
``torch._foreach_*`` ops: a ResNet-56 tree has ~280 leaves, and one op per
leaf would put ~280 small kernels on the card for every line of a server
step or a client's bookkeeping.

The collectives over the ranks of a process group: :func:`psum_packed`
(the JAX package's ``psum_tree`` over the ``client`` axis: one
``all_reduce(SUM)`` of every leaf packed into one flat float32 buffer,
never one call per leaf), :func:`all_to_all_tiled` and
:func:`all_gather_tiled` (``jax.lax.all_to_all`` / ``all_gather`` with
``tiled=True``: the robust round's relayout of the update rows into
feature shards, and the gather of weights, scales and the defended
vector) and :func:`ring_shift` (``ppermute`` one step round a ring: every
tensor packed into one byte buffer, one send and one receive). gloo's
point-to-point sends read host memory only, so on a gloo group
:func:`ring_shift` copies a CUDA buffer through host memory explicitly;
gloo's all-reduce, all-to-all and all-gather take device memory
themselves (``scripts/gloo_cuda_probe.py``); NCCL and the CPU copy
nothing.
:data:`STATS` counts the calls, the payload and wire bytes and the bytes
staged through the host.

:class:`FlatLayout` is the JAX package's flat vector of a parameter tree
(``tree_flatten_to_vector``, ``vector_to_tree_like``, ``stack_to_matrix``):
what privacy noise, attacks and defenses see. The port's own
:func:`tree_leaves` keeps insertion order for everything else.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

PyTree = Any


def tree_map(fn: Callable, *trees: PyTree) -> PyTree:
    """``fn`` over the leaves of nested dicts, in the first tree's
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree: PyTree, like: PyTree = None) -> List[torch.Tensor]:
    """The leaves of ``tree`` in ``like``'s key order (``tree``'s own by
    default)."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return [leaf for k in like for leaf in tree_leaves(tree[k], like[k])]
    return [tree]


def tree_unflatten(like: PyTree, leaves: Sequence[torch.Tensor]) -> PyTree:
    """``leaves`` (in ``like``'s leaf order) in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _each(op: Callable, leaves: List[torch.Tensor], *args) -> list:
    """``torch._foreach_<op>`` that takes an empty list too."""
    return op(leaves, *args) if leaves else []


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_unflatten(a, _each(torch._foreach_add, tree_leaves(a),
                                   tree_leaves(b, a)))


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_unflatten(a, _each(torch._foreach_sub, tree_leaves(a),
                                   tree_leaves(b, a)))


def tree_scale(tree: PyTree, s) -> PyTree:
    """``tree * s``; ``s`` a Python number or a 0-d tensor."""
    return tree_unflatten(tree, _each(torch._foreach_mul, tree_leaves(tree),
                                      s))


def tree_copy_(dst: PyTree, src: PyTree) -> None:
    """Copy ``src`` into ``dst``'s tensors in place (same structure)."""
    leaves = tree_leaves(dst)
    if leaves:
        torch._foreach_copy_(leaves, tree_leaves(src, dst))


@torch.no_grad()
def tree_add_scaled_(acc: PyTree, tree: PyTree, w: torch.Tensor) -> None:
    """``acc += tree * w`` in place (the weighted sum's accumulator)."""
    leaves = tree_leaves(acc)
    if leaves:
        torch._foreach_add_(leaves, torch._foreach_mul(
            tree_leaves(tree, acc), w))


def stack_trees(tree: PyTree, n: int) -> PyTree:
    """``n`` copies of ``tree`` stacked on a new leading axis (one row per
    client)."""
    return tree_map(lambda v: v.unsqueeze(0).repeat(
        (n,) + (1,) * v.dim()).contiguous(), tree)


def tree_weighted_average(stacked: PyTree, weights: torch.Tensor) -> PyTree:
    """Leaves with a leading client axis -> their average weighted by
    ``weights / max(sum(weights), 1e-12)`` (``fedml_tpu``'s
    ``tree_weighted_average``; ``FedMLAggOperator.agg``)."""
    norm = weights / torch.clamp(weights.sum(), min=1e-12)
    return tree_map(lambda leaf: (leaf * norm.reshape(
        (-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)).sum(0), stacked)


def average_trees(trees: Sequence[PyTree], weights: torch.Tensor) -> PyTree:
    """A list of parameter dicts -> their average weighted by
    ``weights`` (the JAX package's ``tree_weighted_average(stack_trees(
    trees), weights)``)."""
    return tree_weighted_average(
        {k: torch.stack([t[k] for t in trees]) for k in trees[0]}, weights)


class WeightedSum:
    """The round's aggregation: ``Σ_k w_k x_k`` of the clients' updates and
    extras, accumulated client by client in schedule order, and their mean
    ``sum / max(Σ_k w_k, 1e-12)`` (the JAX engine's weighted psum, then the
    divide). The GPU engine and the golden loop both use it, so the two
    aggregate with the same arithmetic."""

    def __init__(self, params: PyTree, extras_zero: PyTree, device=None):
        self.update = tree_zeros_like(params)
        self.extras = extras_zero
        self.weight = torch.zeros(
            (), dtype=torch.float32,
            device=device or next(iter(params.values())).device)

    def add(self, out) -> None:
        """Add one ``ClientOutput``'s update and extras at its weight."""
        tree_add_scaled_(self.update, out.update, out.weight)
        tree_add_scaled_(self.extras, out.extras, out.weight)
        self.weight = self.weight + out.weight

    def add_weight(self, w: torch.Tensor) -> None:
        """Add ``w`` to the denominator alone: a chaos-dropped client's
        scheduled weight when ``chaos_tolerance`` is off."""
        self.weight = self.weight + w

    def mean(self):
        """``(update, extras)`` over ``max(Σw, 1e-12)``."""
        return weighted_mean(self.update, self.weight), weighted_mean(
            self.extras, self.weight)


def weighted_mean(total: PyTree, weight: torch.Tensor) -> PyTree:
    """A weighted sum over its weight: ``total / max(weight, 1e-12)``."""
    denom = torch.clamp(weight, min=1e-12)
    return tree_map(lambda v: v / denom, total)


# -- the JAX package's flat layout -------------------------------------------

def _flax_path(key: str, shape) -> Tuple[Tuple[str, ...], bool]:
    """A state-dict key's flax path, and whether the leaf is a Dense
    kernel stored ``[out, in]`` here and ``[in, out]`` in flax (the one
    layout change, ``fedml_tpu_torch.interop``)."""
    path = key.split(".")
    dense = (len(path) >= 2 and path[-1] == "weight"
             and path[-2].startswith("Dense_") and len(shape) == 2)
    if dense:
        path[-1] = "kernel"
    return tuple(path), dense


class FlatLayout:
    """The flat vector ``jax.tree_util.tree_leaves`` makes of the same
    parameters in flax's tree: leaves in flax path order (dict keys
    sorted at every level, so ``BasicBlock_10`` comes before
    ``BasicBlock_2``), each leaf raveled in its flax layout (a Dense
    kernel as ``[in, out]``). Random draws hash each coordinate's
    position in this vector, so noise, attacks and defenses built on it
    touch the coordinates JAX's do at the same key.

    Get one with :meth:`of` (cached per parameter names and shapes)."""

    def __init__(self, shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]):
        entries = []
        for key, shape in shapes:
            path, dense = _flax_path(key, shape)
            flax_shape = tuple(reversed(shape)) if dense else tuple(shape)
            entries.append((path, key, dense, flax_shape))
        entries.sort(key=lambda e: e[0])
        self.keys = [e[1] for e in entries]           # flax leaf order
        self.transposed = [e[2] for e in entries]
        self.flax_shapes = [e[3] for e in entries]
        self.sizes = [int(torch.Size(s).numel()) for s in self.flax_shapes]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(entries))]
        self.size = sum(self.sizes)
        self.port_keys = [k for k, _ in shapes]       # the tree's own order
        self._segments: Dict[str, Any] = {}

    @staticmethod
    def of(tree: Dict[str, torch.Tensor], stacked: bool = False
           ) -> "FlatLayout":
        """The layout of a flat parameter dict (``stacked``: leaves carry
        a leading client axis, ignored)."""
        lead = 1 if stacked else 0
        return _layout(tuple((k, tuple(v.shape[lead:]))
                             for k, v in tree.items()))

    @property
    def n_leaves(self) -> int:
        return len(self.keys)

    def _leaf(self, tree, i: int, stacked: bool) -> torch.Tensor:
        v = tree[self.keys[i]]
        if self.transposed[i]:
            v = v.transpose(-1, -2)
        return v.reshape((v.shape[0], -1) if stacked else (-1,))

    def flatten(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``tree_flatten_to_vector``: the ``[D]`` vector."""
        return torch.cat([self._leaf(tree, i, False)
                          for i in range(self.n_leaves)])

    def flatten_into(self, tree: Dict[str, torch.Tensor],
                     out: torch.Tensor) -> None:
        """Write :meth:`flatten` of ``tree`` into ``out`` (a contiguous
        ``[D]`` row, e.g. of the round's update matrix), as float32."""
        torch.cat([self._leaf(tree, i, False).float()
                   for i in range(self.n_leaves)], out=out)

    def stack_to_matrix(self, stacked: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        """``[K, ...]``-leaved tree -> ``[K, D]`` float32 matrix."""
        return torch.cat([self._leaf(stacked, i, True).float()
                          for i in range(self.n_leaves)], dim=1)

    def unflatten(self, vec: torch.Tensor,
                  like: Dict[str, torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """``vector_to_tree_like``: ``[D]`` -> the tree, in the port's key
        order and layouts (and ``like``'s dtypes when given)."""
        out = {}
        for i, key in enumerate(self.keys):
            o = self.offsets[i]
            v = vec[o:o + self.sizes[i]].view(self.flax_shapes[i])
            if self.transposed[i]:
                v = v.t().contiguous()
            if like is not None:
                v = v.to(like[key].dtype)
            out[key] = v
        return {k: out[k] for k in self.port_keys}

    def segments(self, device) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Per-coordinate (leaf index, index within the leaf) on
        ``device``, and the leaf count: the key row and counter of a
        per-leaf draw (``prng.normal_segments_t``)."""
        dev = str(torch.device(device))
        if dev not in self._segments:
            from .. import prng
            self._segments[dev] = prng.segments_t(self.sizes, device)
        return self._segments[dev]


@lru_cache(maxsize=32)
def _layout(shapes) -> FlatLayout:
    return FlatLayout(shapes)


def tree_flatten_to_vector(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``tree_flatten_to_vector`` of the same params."""
    return FlatLayout.of(tree).flatten(tree)


def vector_to_tree_like(vec: torch.Tensor, tree: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`tree_flatten_to_vector`, in ``tree``'s dtypes."""
    return FlatLayout.of(tree).unflatten(vec, like=tree)


def stack_to_matrix(stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[K, ...]``-leaved params -> the ``[K, D]`` matrix of their flat
    vectors (``fedml_tpu/core/security/defense/__init__.py``)."""
    return FlatLayout.of(stacked, stacked=True).stack_to_matrix(stacked)


# -- collectives over the ranks of a process group ---------------------------

#: calls, payload bytes, wire bytes by the ring rule and seconds of the
#: collectives in this process, and the bytes staged through host memory
#: (copied down and back up). A call's payload is its operand's bytes (an
#: all-gather's: its result's); its wire bytes per rank are ``2 (g - 1) /
#: g`` of the payload for an all-reduce and ``(g - 1) / g`` for an
#: all-to-all and an all-gather over ``g`` ranks (the JAX package's
#: ``core/obs/roofline.py::_collective_wire_bytes``); a ring step sends its
#: payload whole.
STATS: Dict[str, float] = {
    "all_reduce_calls": 0, "all_reduce_bytes": 0,
    "all_reduce_wire_bytes": 0,
    "all_to_all_calls": 0, "all_to_all_bytes": 0,
    "all_to_all_wire_bytes": 0, "all_to_all_s": 0.0,
    "all_gather_calls": 0, "all_gather_bytes": 0,
    "all_gather_wire_bytes": 0,
    "p2p_calls": 0, "p2p_bytes": 0, "staged_bytes": 0}

def reset_collective_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("_s") else 0


def collective_stats() -> Dict[str, float]:
    return dict(STATS)


def _count(op: str, payload: int, g: int) -> None:
    """One call of ``op`` moving ``payload`` bytes over ``g`` ranks."""
    STATS[op + "_calls"] += 1
    STATS[op + "_bytes"] += payload
    STATS[op + "_wire_bytes"] += (2 if op == "all_reduce" else 1) * \
        payload * (g - 1) // g


def group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def psum_packed(tensors: Sequence[torch.Tensor], group
                ) -> List[torch.Tensor]:
    """The SUM over ``group``'s ranks of every tensor, by one
    ``all_reduce`` of one flat float32 buffer; returns new tensors of the
    inputs' shapes and dtypes. The order of the ranks' sum is the
    backend's."""
    import torch.distributed as dist
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", flat.numel() * 4, group_size(group))
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[o:o + n].view(t.shape).to(t.dtype))
        o += n
    return out


def all_to_all_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=1, concat_axis=0,
    tiled=True)`` over ``group``: this rank's ``[S, D]`` rows (``D`` a
    multiple of the group size ``g``) -> the ``[g S, D / g]`` grid of every
    rank's rows, column block of this rank's index, rows source-rank-major.
    One ``all_to_all_single``; counted in :data:`STATS`."""
    import torch.distributed as dist
    g = group_size(group)
    s, d = (int(n) for n in x.shape)
    if d % g:
        raise ValueError(f"all_to_all_tiled: {d} columns over {g} ranks")
    inp = x.reshape(s, g, d // g).transpose(0, 1).contiguous()
    out = torch.empty_like(inp)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, inp, group=group)
    STATS["all_to_all_s"] += time.perf_counter() - t0
    _count("all_to_all", inp.numel() * inp.element_size(), g)
    return out.reshape(g * s, d // g)


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)`` over ``group``: every
    rank's ``x`` concatenated along dim 0 in rank order. One
    ``all_gather_into_tensor``; counted in :data:`STATS`."""
    import torch.distributed as dist
    g = group_size(group)
    x = x.contiguous()
    out = x.new_empty((g * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    _count("all_gather", out.numel() * out.element_size(), g)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group
               ) -> List[torch.Tensor]:
    """One step of a ring over ``group``: each rank sends ``tensors`` to
    the next rank (``(i + 1) % size``) and returns what the previous one
    (``(i - 1) % size``) sent, in the same shapes and dtypes. All of them
    travel as one byte buffer: one send and one receive per rank."""
    import torch.distributed as dist
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    # gloo's sends read host memory only
    host = flat.is_cuda and dist.get_backend(group) == "gloo"
    send = flat.cpu() if host else flat
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + 1) % size), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - 1) % size), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if host:
        recv = recv.to(flat.device)
        STATS["staged_bytes"] += 2 * flat.numel()
    STATS["p2p_calls"] += 1
    STATS["p2p_bytes"] += flat.numel()
    out, o = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        chunk = recv[o:o + n]
        if o % t.element_size():        # a view needs aligned storage
            chunk = chunk.clone()
        out.append(chunk.view(t.dtype).view(t.shape))
        o += n
    return out
