"""Parameters between the JAX package and the port.

A flax parameter tree (nested dicts of numpy arrays, e.g.
``{"BasicBlock_3": {"Conv_1": {"kernel": ...}}}``) maps onto the port's
``state_dict`` by scope path: ``Conv_k`` / ``GroupNorm_k`` / ``BasicBlock_k``
scopes are module attributes of the same names, so the path joined with
``.`` is the state-dict key. The port stores conv kernels HWIO like flax;
the one layout change is the Dense kernel, ``[in, out]`` in flax and
``[out, in]`` (``Dense_0.weight``) in ``torch.nn.Linear``.

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
