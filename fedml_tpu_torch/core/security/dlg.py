"""Gradient-inversion attack (DLG / "deep leakage from gradients";
counterpart of ``fedml_tpu/core/security/dlg.py``).

Parity target: reference ``core/security/attack/dlg_attack.py`` and
``invert_gradient_attack.py`` — reconstruct a client's training batch from
its shared gradient. The inversion optimizes a dummy batch so that its
gradient matches the target: a gradient of a gradient, through
``torch.autograd.grad(..., create_graph=True)``. The optimizer is the
port's optax-equal Adam (``optimizers/fedopt.py::ServerOptimizer``), so a
run from the same key follows the JAX package's. No engine calls it; it
shows what DP noise and secure aggregation protect.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import prng
from ..collectives import FlatLayout

PyTree = Any


def infer_label_idlg(target_grads: Dict[str, torch.Tensor],
                     num_classes: int) -> Optional[int]:
    """iDLG label inference (Zhao et al.): for softmax cross-entropy with a
    single-sample batch, the bias gradient is p - onehot(y), whose unique
    negative entry sits at the true label. Returns the label or None if no
    bias-shaped leaf with exactly one negative entry is found. Leaves are
    visited in the JAX package's (flax) order."""
    for key in FlatLayout.of(target_grads).keys:
        leaf = target_grads[key]
        if leaf.dim() == 1 and leaf.shape[0] == num_classes:
            if int(torch.sum(leaf < 0)) == 1:
                return int(torch.argmin(leaf))
    return None


def invert_gradient(
    spec,
    params: Dict[str, torch.Tensor],
    target_grads: Dict[str, torch.Tensor],
    x_shape: Tuple[int, ...],
    num_classes: int,
    rng: np.ndarray,
    steps: int = 200,
    lr: float = 0.1,
    tv_weight: float = 0.0,
    objective: str = "l2",
) -> Dict[str, Any]:
    """Optimize dummy (x, soft-y) so their gradient matches ``target_grads``.

    Returns {"x": recovered batch, "y_logits": recovered label logits,
    "match_loss": the objective at the last step, "loss_curve": every
    step's}. ``objective``: "l2" is classic DLG (Zhu et al.); "cosine" is
    Geiping et al.'s inverting-gradients variant. ``rng`` is a
    :mod:`~fedml_tpu_torch.prng` key: the dummy batch is the JAX package's
    draw from the same key.

    Soft-label joint optimization has an exact sign symmetry on linear
    models (x, p-y) -> (-x, y-p); when iDLG label inference succeeds
    (single-sample batch), the label is pinned one-hot, which breaks the
    symmetry and makes reconstruction exact.
    """
    from ...optimizers.fedopt import ServerOptimizer

    dev = next(iter(params.values())).device
    x_rng, y_rng = prng.split(rng)
    bs = x_shape[0]
    dummy_x = torch.from_numpy(prng.normal(x_rng, x_shape)).to(dev)
    known_label = (infer_label_idlg(target_grads, num_classes)
                   if bs == 1 else None)
    if known_label is not None:
        dummy_y = torch.full((bs, num_classes), -20.0, device=dev)
        dummy_y[:, known_label] = 20.0
    else:
        dummy_y = torch.from_numpy(
            prng.normal(y_rng, (bs, num_classes)) * np.float32(0.1)).to(dev)

    layout = FlatLayout.of(params)
    flat_target = layout.flatten({k: v.detach()
                                  for k, v in target_grads.items()})
    t_norm = torch.linalg.norm(flat_target) + 1e-12
    leaves = {k: v.detach() for k, v in params.items()}

    def objective_fn(dx, dy):
        y_soft = torch.softmax(dy, dim=-1)
        p = {k: v.requires_grad_() for k, v in
             ((k, v.clone()) for k, v in leaves.items())}
        logits = spec.apply_fn(p, dx, train=False)
        loss = torch.mean(-torch.sum(y_soft * F.log_softmax(logits, -1),
                                     dim=-1))
        g = torch.autograd.grad(loss, list(p.values()), create_graph=True)
        flat_g = layout.flatten(dict(zip(p, g)))
        if objective == "cosine":
            cos = torch.sum(flat_g * flat_target) / (
                (torch.linalg.norm(flat_g) + 1e-12) * t_norm)
            obj = 1.0 - cos
        else:
            obj = torch.sum((flat_g - flat_target) ** 2)
        if tv_weight > 0.0 and len(x_shape) >= 3:
            tv = torch.mean(torch.abs(torch.diff(dx, dim=1))) + \
                torch.mean(torch.abs(torch.diff(dx, dim=2)))
            obj = obj + tv_weight * tv
        return obj

    adam = ServerOptimizer("adam", lr)
    dummy = {"x": dummy_x, "y": dummy_y}
    state = adam.init(dummy)
    losses = []
    for _ in range(int(steps)):
        dx = dummy["x"].clone().requires_grad_()
        # a pinned label takes no gradient (the JAX stop_gradient)
        dy = dummy["y"].clone().requires_grad_(known_label is None)
        obj = objective_fn(dx, dy)
        wrt = [dx] if known_label is not None else [dx, dy]
        gs = torch.autograd.grad(obj, wrt)
        grads = {"x": gs[0],
                 "y": gs[1] if known_label is None
                 else torch.zeros_like(dummy["y"])}
        updates, state = adam.update(grads, state)
        dummy = {k: dummy[k] + updates[k] for k in dummy}
        losses.append(obj.detach())
    curve = torch.stack(losses) if losses else torch.zeros(0, device=dev)
    return {"x": dummy["x"], "y_logits": dummy["y"],
            "match_loss": curve[-1] if losses else None,
            "loss_curve": curve}
