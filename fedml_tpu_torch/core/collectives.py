"""Tree helpers of the round (counterpart of the tree half of
``fedml_tpu/core/collectives.py``).

The port's pytrees are nested dicts of tensors (``Params`` and the
optimizers' states and extras). Each helper walks them in the first
tree's key order and runs the leaf arithmetic as multi-tensor
``torch._foreach_*`` ops: a ResNet-56 tree has ~280 leaves, and one op per
leaf would put ~280 small kernels on the card for every line of a server
step or a client's bookkeeping. The collectives over a mesh axis
(``psum_tree`` and its kin) wait for multi-GPU.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

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

    def __init__(self, params: PyTree, extras_zero: PyTree):
        self.update = tree_zeros_like(params)
        self.extras = extras_zero
        self.weight = torch.zeros((), dtype=torch.float32,
                                  device=next(iter(params.values())).device)

    def add(self, out) -> None:
        """Add one ``ClientOutput``'s update and extras at its weight."""
        tree_add_scaled_(self.update, out.update, out.weight)
        tree_add_scaled_(self.extras, out.extras, out.weight)
        self.weight = self.weight + out.weight

    def mean(self):
        """``(update, extras)`` over ``max(Σw, 1e-12)``."""
        return weighted_mean(self.update, self.weight), weighted_mean(
            self.extras, self.weight)


def weighted_mean(total: PyTree, weight: torch.Tensor) -> PyTree:
    """A weighted sum over its weight: ``total / max(weight, 1e-12)``."""
    denom = torch.clamp(weight, min=1e-12)
    return tree_map(lambda v: v / denom, total)
