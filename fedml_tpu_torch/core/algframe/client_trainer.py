"""Client-side trainer specs and the inner optimizer (counterpart of
``fedml_tpu/core/algframe/client_trainer.py``).

A trainer is a *spec*: ``loss(params, batch) -> (loss, aux)`` and
``eval_stats(params, batch) -> dict of sums``, both on a ``Params`` dict.
The inner optimizer reproduces optax's update rules term for term, so a
client's local trajectory matches the JAX package's within float rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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
    """Pick the TrainerSpec from the dataset's declared task."""
    task = getattr(fed, "task", "classification")
    if task in ("llm", "causal_lm"):
        from ...llm.trainer import CausalLMTrainer
        return CausalLMTrainer(bundle.apply)
    if task != "classification":
        raise NotImplementedError(
            f"task={task!r} is not ported to fedml_tpu_torch yet "
            f"(ported: classification, llm)")
    return ClassificationTrainer(bundle.apply)


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
