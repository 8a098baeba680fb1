"""Client-side trainer specs and the inner optimizer (counterpart of
``fedml_tpu/core/algframe/client_trainer.py``).

A trainer is a *spec*: ``loss(params, batch) -> (loss, aux)`` and
``eval_stats(params, batch) -> dict of sums``, both on a ``Params`` dict.
The inner optimizer reproduces optax's update rules term for term, so a
client's local trajectory matches the JAX package's within float rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .types import Params

Batch = Dict[str, torch.Tensor]  # {"x", "y", "mask"}


class TrainerSpec:
    """``apply_fn(params, x, train=...)`` is the model forward."""

    def __init__(self, apply_fn: Callable[..., torch.Tensor]):
        self.apply_fn = apply_fn

    def loss(self, params: Params, batch: Batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def eval_stats(self, params: Params, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class ClassificationTrainer(TrainerSpec):
    """Cross-entropy classification, masked mean over real samples so
    padded slots contribute nothing."""

    def _stats(self, logits, batch):
        labels = batch["y"].long()
        per_ex = F.cross_entropy(logits, labels, reduction="none")
        mask = batch["mask"].to(per_ex.dtype)
        correct = ((logits.argmax(-1) == labels) * mask).sum()
        return per_ex, mask, {"loss_sum": (per_ex * mask).sum(),
                              "correct": correct, "count": mask.sum()}

    def loss(self, params, batch):
        logits = self.apply_fn(params, batch["x"], train=True)
        per_ex, mask, aux = self._stats(logits, batch)
        denom = torch.clamp(mask.sum(), min=1.0)
        return aux["loss_sum"] / denom, aux

    def eval_stats(self, params, batch):
        logits = self.apply_fn(params, batch["x"], train=False)
        return self._stats(logits, batch)[2]


def make_trainer_spec(fed, bundle) -> TrainerSpec:
    task = getattr(fed, "task", "classification")
    if task != "classification":
        raise NotImplementedError(
            f"task={task!r} is not ported to fedml_tpu_torch yet "
            f"(ported: classification)")
    return ClassificationTrainer(bundle.apply)


class InnerOptimizer:
    """The client's inner optimizer with optax's semantics:

    * ``sgd``: ``add_decayed_weights`` (g + wd * p) before the step, then
      optax ``trace`` momentum (t = g + m * t) and ``-lr`` scaling;
    * ``adam``: decayed weights, then ``scale_by_adam`` (bias-corrected
      moments, ``u = mu_hat / (sqrt(nu_hat) + eps)``) and ``-lr``;
    * ``adamw``: ``scale_by_adam``, then decoupled ``+ wd * p``, then
      ``-lr``.

    ``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``; the caller adds the updates to the params.
    """

    def __init__(self, name: str, learning_rate: float, momentum: float = 0.0,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        name = (name or "sgd").lower()
        if name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown client_optimizer {name!r}")
        self.name = name
        self.lr = float(learning_rate)
        self.momentum = float(momentum or 0.0)
        self.wd = float(weight_decay or 0.0)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> Dict[str, object]:
        zeros = lambda: {k: torch.zeros_like(v)  # noqa: E731
                         for k, v in params.items()}
        if self.name == "sgd":
            return {"trace": zeros()} if self.momentum else {}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Params, state, params: Params):
        if self.name == "sgd":
            g = grads
            if self.wd:
                g = {k: g[k] + self.wd * params[k] for k in g}
            if self.momentum:
                g = {k: g[k] + self.momentum * state["trace"][k] for k in g}
                state = {"trace": g}
            return {k: -self.lr * v for k, v in g.items()}, state
        g = grads
        if self.name == "adam" and self.wd:
            g = {k: g[k] + self.wd * params[k] for k in g}
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g[k] + b1 * state["mu"][k] for k in g}
        nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * state["nu"][k] for k in g}
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        u = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
             for k in g}
        if self.name == "adamw" and self.wd:
            u = {k: u[k] + self.wd * params[k] for k in u}
        return ({k: -self.lr * v for k, v in u.items()},
                {"count": count, "mu": mu, "nu": nu})


def make_inner_optimizer(name: str, learning_rate, momentum: float = 0.0,
                         weight_decay: float = 0.0) -> InnerOptimizer:
    """The client's inner optimizer (sgd | adam | adamw)."""
    return InnerOptimizer(name, learning_rate, momentum, weight_decay)
