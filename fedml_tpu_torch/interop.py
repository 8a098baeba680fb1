"""Parameters, and the selection store's state, between the JAX package
and the port.

A flax parameter tree (nested dicts of numpy arrays, e.g.
``{"BasicBlock_3": {"Conv_1": {"kernel": ...}}}``) maps onto the port's
``state_dict`` by scope path: ``Conv_k`` / ``GroupNorm_k`` / ``BasicBlock_k``
scopes are module attributes of the same names, so the path joined with
``.`` is the state-dict key. The port stores conv kernels HWIO like flax;
the one layout change is the Dense kernel of the CIFAR models, ``[in,
out]`` in flax and ``[out, in]`` (``Dense_0.weight``) in
``torch.nn.Linear`` (the CNNs' ``Dense_k`` too: their ``Dense_0`` follows
an NHWC flatten on both sides, so its rows line up). The CNNs' conv
biases (``Conv_k.bias``), the embeddings (``Embed_0.embedding``) and the
LSTMs' kernels (``OptimizedLSTMCell_k.ii.kernel`` ``[in, h]``, ...,
``OptimizedLSTMCell_k.hi.bias``) keep flax's names and layouts. The causal LM keeps flax's names and layouts
(``layer_0.attn.q.kernel`` ``[h, heads, head_dim]``, ``embed.embedding``,
...), and so do its LoRA adapters (``layer_0.attn.q.lora_a`` ``[in, r]``,
``lora_b`` ``[r, prod(out)]``): they cross path for path, unchanged.

The participant-selection store's state dict (``ClientStatsStore`` /
``SparseClientStatsStore.state_dict()``) has the same keys and numpy
arrays in both packages (the port's store is a copy):
:func:`selection_state_from_jax` only takes each field to numpy, so a
port engine resumes a JAX run's selection history
(``sim.selection.load_state_dict``).

The slice-20 models cross the same way: LeNet, VGG, the finance nets,
the GAN pair, MobileNetV3 (``InvertedResidual_k.Conv_j.kernel``, a
depthwise conv's ``[k, k, 1, C]``; ``SqueezeExcite_0.Dense_j`` is a
Dense layer like any other), EfficientNet (``MBConv_k``; its
squeeze-excite's 1x1 ``Conv_j`` keep HWIO kernels and biases), SegNet
(``ConvTranspose_k.kernel`` carried as flax stores it, unflipped: the
module flips it) and the FedGKT nets. The FedNAS supernet's cells keep
flax's Dense layout under their own names (``cell0.op_linear.kernel``
``[in, out]``, ``op_relu``, ``op_proj``), so they cross path for path,
unchanged; its head is a ``Dense_0``.

The split-learning parts and the vertical-FL party nets are flax
*variables* (``{"params": tree}``) in the JAX package and state dicts of
``Dense_k`` layers in the port: :func:`split_params_from_flax` and
:func:`vfl_params_from_flax` carry them across (the same Dense layout
change).

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


def variables_to_state_dict(variables: Mapping[str, Any]
                            ) -> Dict[str, np.ndarray]:
    """Flax variables (``{"params": tree}``, or the tree itself) -> a
    state dict."""
    tree = variables.get("params", variables) if isinstance(
        variables, Mapping) else variables
    return flax_to_state_dict(tree)


def split_params_from_flax(bottom: Mapping[str, Any],
                           top: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX split-learning parts' variables -> the port's
    ``{"bottom": state dict, "top": state dict}`` (``init_params`` of the
    split simulator and session)."""
    return {"bottom": variables_to_state_dict(bottom),
            "top": variables_to_state_dict(top)}


def vfl_params_from_flax(parties) -> list:
    """The JAX vertical-FL party nets' variables -> the port's state
    dicts, one per party, in party order."""
    return [variables_to_state_dict(p) for p in parties]
