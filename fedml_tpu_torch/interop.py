"""Parameters, and the selection store's state, between the JAX package
and the port.

A flax parameter tree (nested dicts of numpy arrays, e.g.
``{"BasicBlock_3": {"Conv_1": {"kernel": ...}}}``) maps onto the port's
``state_dict`` by scope path: ``Conv_k`` / ``GroupNorm_k`` / ``BasicBlock_k``
scopes are module attributes of the same names, so the path joined with
``.`` is the state-dict key. The port stores conv kernels HWIO like flax;
the one layout change is the Dense kernel of the CIFAR models, ``[in,
out]`` in flax and ``[out, in]`` (``Dense_0.weight``) in
``torch.nn.Linear``. The causal LM keeps flax's names and layouts
(``layer_0.attn.q.kernel`` ``[h, heads, head_dim]``, ``embed.embedding``,
...), and so do its LoRA adapters (``layer_0.attn.q.lora_a`` ``[in, r]``,
``lora_b`` ``[r, prod(out)]``): they cross path for path, unchanged.

The participant-selection store's state dict (``ClientStatsStore`` /
``SparseClientStatsStore.state_dict()``) has the same keys and numpy
arrays in both packages (the port's store is a copy):
:func:`selection_state_from_jax` only takes each field to numpy, so a
port engine resumes a JAX run's selection history
(``sim.selection.load_state_dict``).

Neither direction imports JAX: both sides are numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _dense_weight(path) -> bool:
    return path[-1] == "kernel" and path[-2].startswith("Dense_")


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested flax params -> flat ``{state_dict key: array}``."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        a = np.asarray(node)
        if _dense_weight(path):
            out[".".join(path[:-1] + ("weight",))] = np.ascontiguousarray(a.T)
        else:
            out[".".join(path)] = a

    walk(tree, ())
    return out


def state_dict_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat ``{state_dict key: tensor or array}`` -> nested flax params
    (numpy), the inverse of :func:`flax_to_state_dict`."""
    tree: Dict[str, Any] = {}
    for key, v in sd.items():
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else \
            np.asarray(v)
        path = key.split(".")
        if path[-1] == "weight" and path[-2].startswith("Dense_"):
            path[-1], a = "kernel", np.ascontiguousarray(a.T)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return tree


def selection_state_from_jax(state: Mapping[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """A JAX selection store's ``state_dict()`` (jax or numpy arrays) as
    the port's: the same keys, numpy arrays of the same dtypes."""
    return {str(k): np.array(v, copy=True) for k, v in state.items()}
