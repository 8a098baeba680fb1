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


def _host(params: Params) -> Dict[str, np.ndarray]:
    """The params as host arrays through one device-to-host copy: a copy
    per leaf waits for the device once per leaf, and on a card that
    processes time-slice each wait can last a slice."""
    flat = torch.cat([v.detach().reshape(-1) for v in params.values()])
    parts = flat.cpu().split([v.numel() for v in params.values()])
    return {k: t.view(v.shape).numpy()
            for (k, v), t in zip(params.items(), parts)}


def params_to_wire(params: Params) -> Dict[str, np.ndarray]:
    """``tree_to_wire`` of the params' flax tree."""
    return tree_to_wire(state_dict_to_flax(_host(params)))


def params_to_wire_bf16(params: Params) -> Dict[str, np.ndarray]:
    """``tree_to_wire_bf16`` of the params' flax tree."""
    return tree_to_wire_bf16(state_dict_to_flax(_host(params)))


def _to_params(tree, template: Params) -> Params:
    """A flax tree of host arrays as params like ``template``: one
    host-to-device copy into one buffer, each leaf a view of it in its
    template's dtype (a cast on the device only where they differ)."""
    sd = flax_to_state_dict(tree)
    flat = np.concatenate([np.asarray(sd[k]).reshape(-1) for k in template])
    dev = next(iter(template.values())).device
    parts = torch.from_numpy(flat).to(dev).split(
        [v.numel() for v in template.values()])
    return {k: t.view(v.shape).to(v.dtype)
            for (k, v), t in zip(template.items(), parts)}


def wire_to_params(wire: Dict[str, Any], template: Params) -> Params:
    """Inverse of :func:`params_to_wire`, on ``template``'s device and in
    its dtypes. ``wire_to_tree`` reads only the template's structure, so
    none of its data is copied off the device."""
    structure = state_dict_to_flax(dict.fromkeys(template, np.zeros(0)))
    return _to_params(wire_to_tree(wire, structure), template)


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


def flat_delta(new_params: Params, params: Params) -> torch.Tensor:
    """``new - old`` of two state dicts as the float32 ``[D]`` vector of
    the JAX flat layout, on their device (a secure-aggregation silo's
    update, before its quantization)."""
    delta = {k: new_params[k] - params[k] for k in params}
    return FlatLayout.of(delta).flatten(delta).float()


def apply_mean_delta(global_params: Params, vec: np.ndarray,
                     wsum: float) -> Params:
    """A secure-aggregation server's step, ``global + vec / wsum``, with
    the JAX package's dtype path: the division in numpy float32 on the
    host, the sum in float32 on the model's device."""
    agg = (vec / max(wsum, 1e-12)).astype(np.float32)
    delta = vec_to_params(agg, global_params)
    return {k: g + delta[k] for k, g in global_params.items()}
