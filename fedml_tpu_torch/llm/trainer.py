"""Causal-LM trainer spec (counterpart of ``fedml_tpu/llm/trainer.py``).

Per-token cross-entropy where prompt and padding positions are excluded
from the loss: ignored positions carry label ``-1`` inside the standard
``{"x", "y", "mask"}`` batch, so the spec composes with ``run_local_sgd``
and the simulator unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.algframe.client_trainer import TrainerSpec


class CausalLMTrainer(TrainerSpec):
    """Next-token CE. Batch: ``x`` [bs, L] int tokens, ``y`` [bs, L] labels
    with ``-1`` = ignore, ``mask`` [bs] per-sample realness."""

    def _stats(self, params, batch, train):
        logits = self.apply_fn(params, batch["x"], train=train)
        labels = batch["y"].long()
        tok_w = ((labels >= 0).float()
                 * batch["mask"].float()[:, None])
        safe = labels.clamp(min=0)
        per_tok = F.cross_entropy(logits.float().flatten(0, -2),
                                  safe.flatten(), reduction="none"
                                  ).reshape(safe.shape)
        loss_sum = (per_tok * tok_w).sum()
        correct = ((logits.argmax(-1) == safe) * tok_w).sum()
        count = tok_w.sum()
        return loss_sum, correct, count

    def loss(self, params, batch, rng=None):
        # the causal LM has no dropout: rng is unused
        loss_sum, correct, count = self._stats(params, batch, True)
        loss = loss_sum / count.clamp(min=1.0)
        return loss, {"loss_sum": loss_sum, "correct": correct,
                      "count": count}

    @torch.no_grad()
    def eval_stats(self, params, batch):
        loss_sum, correct, count = self._stats(params, batch, False)
        return {"loss_sum": loss_sum, "correct": correct, "count": count}
