"""A silo's or the server's parameters on the cross-silo wire.

The port keeps parameters as state dicts (``Params``); the wire carries
the JAX package's flax tree (``tree_to_wire``: ``{"Dense_0/kernel":
array, ...}``, Dense kernels ``[in, out]``) and its flat vector
(``core/collectives.py::FlatLayout``), so a port party and a JAX party
decode each other's messages. :mod:`fedml_tpu_torch.interop` maps the
two trees.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.algframe.types import Params
from ..core.collectives import FlatLayout
from ..core.distributed.communication.message import (bf16_wire_to_tree,
                                                       tree_to_wire,
                                                       tree_to_wire_bf16,
                                                       wire_to_tree)
from ..interop import flax_to_state_dict, state_dict_to_flax


def params_to_wire(params: Params) -> Dict[str, np.ndarray]:
    """``tree_to_wire`` of the params' flax tree."""
    return tree_to_wire(state_dict_to_flax(params))


def params_to_wire_bf16(params: Params) -> Dict[str, np.ndarray]:
    """``tree_to_wire_bf16`` of the params' flax tree."""
    return tree_to_wire_bf16(state_dict_to_flax(params))


def _to_params(tree, template: Params) -> Params:
    sd = flax_to_state_dict(tree)
    return {k: torch.from_numpy(np.array(sd[k], copy=True)).to(
        device=v.device, dtype=v.dtype) for k, v in template.items()}


def wire_to_params(wire: Dict[str, Any], template: Params) -> Params:
    """Inverse of :func:`params_to_wire`, on ``template``'s device and in
    its dtypes."""
    return _to_params(wire_to_tree(wire, state_dict_to_flax(template)),
                      template)


def bf16_wire_to_params(wire: Dict[str, Any], template: Params) -> Params:
    """Inverse of :func:`params_to_wire_bf16` (the bf16 rounding, widened
    to ``template``'s dtypes)."""
    return _to_params(bf16_wire_to_tree(wire, state_dict_to_flax(template)),
                      template)


def params_to_vec(params: Params) -> np.ndarray:
    """Host float32 vector of the params in the JAX flat layout."""
    return FlatLayout.of(params).flatten(params).detach().float().cpu() \
        .numpy()


def vec_to_params(vec, template: Params) -> Params:
    """Inverse of :func:`params_to_vec`, on ``template``'s device and in
    its dtypes."""
    v = torch.from_numpy(np.array(vec, np.float32, copy=True))
    dev = next(iter(template.values())).device
    return FlatLayout.of(template).unflatten(v.to(dev), like=template)
