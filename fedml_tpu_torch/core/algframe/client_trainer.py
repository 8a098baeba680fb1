"""Client-side trainer specs and the inner optimizer (counterpart of
``fedml_tpu/core/algframe/client_trainer.py``).

A trainer is a *spec*: ``loss(params, batch, rng) -> (loss, aux)`` and
``eval_stats(params, batch) -> dict of sums``, both on a ``Params`` dict.
``rng`` is the training step's dropout key (an int64 ``[2]`` tensor, or
None for a model without dropout); the model's forward takes it. Every
trainer sums ``loss_sum`` / ``correct`` / ``count`` over the batch's real
samples as the JAX package's does: the classification, next-token
(``sequence``), multi-hot tag (``multilabel``) and ``regression`` tasks.
The inner optimizer reproduces optax's update rules term for term, so a
client's local trajectory matches the JAX package's within float rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .types import Params

Batch = Dict[str, torch.Tensor]  # {"x", "y", "mask"}


class TrainerSpec:
    """``apply_fn(params, x, rng=..., train=...)`` is the model forward.
    A subclass defines :meth:`_stats` (the masked sums from the logits);
    :meth:`loss` is their ``loss_sum`` over ``max(count, 1)``."""

    def __init__(self, apply_fn: Callable[..., torch.Tensor]):
        self.apply_fn = apply_fn

    def _stats(self, out: torch.Tensor, batch: Batch
               ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def loss(self, params: Params, batch: Batch,
             rng: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out = self.apply_fn(params, batch["x"], rng=rng, train=True)
        aux = self._stats(out, batch)
        return aux["loss_sum"] / torch.clamp(aux["count"], min=1.0), aux

    def eval_stats(self, params: Params, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        return self._stats(self.apply_fn(params, batch["x"], train=False),
                           batch)


class ClassificationTrainer(TrainerSpec):
    """Cross-entropy classification, masked mean over real samples so
    padded slots contribute nothing."""

    def _stats(self, logits, batch):
        labels = batch["y"].long()
        per_ex = F.cross_entropy(logits, labels, reduction="none")
        mask = batch["mask"].to(per_ex.dtype)
        correct = ((logits.argmax(-1) == labels) * mask).sum()
        return {"loss_sum": (per_ex * mask).sum(), "correct": correct,
                "count": mask.sum()}


class SequenceTrainer(TrainerSpec):
    """Per-token cross-entropy for next-token prediction: labels
    ``[bs, L]``, logits ``[bs, L, V]``; the per-sample mask broadcasts over
    the tokens (``[bs, 1]`` over ``[bs, L]``), so every token of a real
    sample counts, padding characters included, as in the JAX package."""

    def _stats(self, logits, batch):
        labels = batch["y"].long()
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  labels.reshape(-1), reduction="none"
                                  ).reshape(labels.shape)
        mask = batch["mask"].to(per_tok.dtype)[:, None]
        correct = ((logits.argmax(-1) == labels) * mask).sum()
        return {"loss_sum": (per_tok * mask).sum(), "correct": correct,
                "count": (mask * torch.ones_like(per_tok)).sum()}


class MultiLabelTrainer(TrainerSpec):
    """Sigmoid-BCE tag prediction (stackoverflow_lr): ``y`` is a multi-hot
    ``[bs, n_tags]`` matrix; the loss is the mean over tags, and
    ``correct`` sums each sample's share of tags predicted right."""

    def _stats(self, logits, batch):
        labels = batch["y"].to(logits.dtype)
        per_ex = F.binary_cross_entropy_with_logits(
            logits, labels, reduction="none").mean(-1)
        mask = batch["mask"].to(per_ex.dtype)
        pred = (logits > 0).to(labels.dtype)
        correct = ((pred == labels).float().mean(-1) * mask).sum()
        return {"loss_sum": (per_ex * mask).sum(), "correct": correct,
                "count": mask.sum()}


class RegressionTrainer(TrainerSpec):
    """Mean squared error; ``correct`` is 0."""

    def _stats(self, preds, batch):
        labels = batch["y"].to(preds.dtype)
        if preds.dim() > labels.dim():
            labels = labels[..., None]
        per_ex = ((preds - labels) ** 2).mean(-1)
        mask = batch["mask"].to(per_ex.dtype)
        return {"loss_sum": (per_ex * mask).sum(),
                "correct": torch.zeros((), device=preds.device),
                "count": mask.sum()}


_TRAINERS = {"sequence": SequenceTrainer, "multilabel": MultiLabelTrainer,
             "regression": RegressionTrainer}


def make_trainer_spec(fed, bundle) -> TrainerSpec:
    """Pick the TrainerSpec from the dataset's declared task. A dataset
    built without one (``classification``) whose labels have a trailing
    axis (``y`` of 4 or more dimensions with the client and batch axes) is
    ``multilabel`` for float labels, else ``sequence``."""
    task = getattr(fed, "task", "classification")
    if task == "classification" and np.ndim(fed.train.y) >= 4:
        task = ("multilabel" if np.issubdtype(np.asarray(fed.train.y).dtype,
                                              np.floating)
                else "sequence")
    if task in ("llm", "causal_lm"):
        from ...llm.trainer import CausalLMTrainer
        return CausalLMTrainer(bundle.apply)
    return _TRAINERS.get(task, ClassificationTrainer)(bundle.apply)


class InnerOptimizer:
    """The client's inner optimizer with optax's semantics:

    * ``sgd``: ``add_decayed_weights`` (g + wd * p) before the step, then
      optax ``trace`` momentum (t = g + m * t) and ``-lr`` scaling;
    * ``adam``: decayed weights, then ``scale_by_adam`` (bias-corrected
      moments, ``u = mu_hat / (sqrt(nu_hat) + eps)``) and ``-lr``;
    * ``adamw``: ``scale_by_adam``, then decoupled ``+ wd * p``, then
      ``-lr``.

    Everything a step reads that changes between steps or clients lives in
    the state as a tensor: the moments, Adam's step ``count`` (and so its
    bias corrections) and ``neg_lr``. :meth:`step_` updates the params
    and the state in place, so one call can be captured into a CUDA graph
    and replayed; the eager loop and the captured step both run it.
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

    @property
    def key(self) -> Tuple:
        """What a captured step bakes in (everything but the state)."""
        return (self.name, self.momentum, self.wd, self.b1, self.b2,
                self.eps)

    def init(self, params: Params) -> Dict[str, object]:
        """Fresh state on the params' device: zero moments and count, and
        ``neg_lr`` = -learning_rate."""
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v)  # noqa: E731
                         for k, v in params.items()}
        state: Dict[str, object] = {"neg_lr": torch.tensor(
            -self.lr, dtype=torch.float32, device=dev)}
        if self.name == "sgd":
            if self.momentum:
                state["trace"] = zeros()
            return state
        state.update(count=torch.zeros((), dtype=torch.float32, device=dev),
                     mu=zeros(), nu=zeros())
        return state

    @torch.no_grad()
    def reset_(self, state, learning_rate: float) -> None:
        """Back to :meth:`init`'s values in place, with this learning
        rate (a client's start)."""
        state["neg_lr"].fill_(-float(learning_rate))
        for k, v in state.items():
            if k == "neg_lr":
                continue
            for t in (v.values() if isinstance(v, dict) else (v,)):
                t.zero_()

    @torch.no_grad()
    def step_(self, params: Params, grads: Params, state) -> None:
        """One step in place: ``params += -lr * direction(grads)``."""
        neg_lr = state["neg_lr"]
        if self.name == "sgd":
            for k, p in params.items():
                g = grads[k]
                if self.wd:
                    g = g + self.wd * p
                if self.momentum:
                    g = state["trace"][k].mul_(self.momentum).add_(g)
                p.add_(neg_lr * g)
            return
        b1, b2 = self.b1, self.b2
        count = state["count"].add_(1.0)
        c1 = 1.0 - torch.pow(torch.full_like(count, b1), count)
        c2 = 1.0 - torch.pow(torch.full_like(count, b2), count)
        for k, p in params.items():
            g = grads[k]
            if self.name == "adam" and self.wd:
                g = g + self.wd * p
            mu = state["mu"][k].mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][k].mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.name == "adamw" and self.wd:
                u = u + self.wd * p
            p.add_(neg_lr * u)


def make_inner_optimizer(name: str, learning_rate, momentum: float = 0.0,
                         weight_decay: float = 0.0) -> InnerOptimizer:
    """The client's inner optimizer (sgd | adam | adamw)."""
    return InnerOptimizer(name, learning_rate, momentum, weight_decay)
