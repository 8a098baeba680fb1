"""Tree helpers of the round (counterpart of the tree half of
``fedml_tpu/core/collectives.py``).

The port's pytrees are nested dicts of tensors (``Params`` and the
optimizers' states and extras). Each helper walks them in the first
tree's key order and runs the leaf arithmetic as multi-tensor
``torch._foreach_*`` ops: a ResNet-56 tree has ~280 leaves, and one op per
leaf would put ~280 small kernels on the card for every line of a server
step or a client's bookkeeping. The collectives over a mesh axis
(``psum_tree`` and its kin) wait for multi-GPU.

:class:`FlatLayout` is the JAX package's flat vector of a parameter tree
(``tree_flatten_to_vector``, ``vector_to_tree_like``, ``stack_to_matrix``):
what privacy noise, attacks and defenses see. The port's own
:func:`tree_leaves` keeps insertion order for everything else.
"""

from __future__ import annotations

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
