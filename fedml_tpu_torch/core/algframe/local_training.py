"""The shared local-SGD loop — the hot loop of FL simulation (counterpart of
``fedml_tpu/core/algframe/local_training.py``).

The JAX package runs the loop as a ``lax.while_loop`` over the client's
*dynamic* real-step count, ``ceil(epochs * real_batches * work_scale)``, so
padded all-zero-mask batches cost nothing. PyTorch runs eagerly, so here it
is a Python loop over the same count. The per-epoch batch order is the same
sort trick on the same ``jax.random`` bits (:mod:`fedml_tpu_torch.prng`):
one uniform key per padded slot, padded slots pushed to the end with +2,
stable argsort.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ... import prng
from .client_trainer import InnerOptimizer, TrainerSpec
from .types import ClientData, Params, TrainHyper


def run_local_sgd(spec: TrainerSpec, inner_opt: InnerOptimizer,
                  params: Params, cdata: ClientData, rng: np.ndarray,
                  hyper: TrainHyper
                  ) -> Tuple[Params, int, Dict[str, torch.Tensor]]:
    """Run ``hyper.epochs`` of SGD over one client's padded batches.

    Returns ``(params, steps, metrics)``: the trained params, the number of
    steps run, and metrics summed over all real samples seen
    (loss_sum / correct / count, float32 tensors on the params' device).
    """
    opt_state = inner_opt.init(params)
    # [n_batches] — a batch is real iff it has at least one unmasked sample
    batch_real = (cdata.mask > 0).any(dim=1).cpu().numpy()
    real_batches = int(batch_real.sum())
    total_steps = int(np.ceil(np.float32(hyper.epochs * real_batches)
                              * np.float32(hyper.work_scale)))
    denom = max(real_batches, 1)
    # split(rng)[1] seeds the per-step keys the JAX loop hands the model
    # for dropout; no ported model has dropout, so it is not drawn here
    data_rng = prng.split(rng)[0]
    dev = next(iter(params.values())).device
    metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in ("loss_sum", "correct", "count")}
    params = {k: v.detach() for k, v in params.items()}
    order = None
    for t in range(total_steps):
        if t % denom == 0:
            order = prng.epoch_order(data_rng, t // denom, batch_real)
        idx = int(order[t % denom])
        batch = {"x": cdata.x[idx], "y": cdata.y[idx],
                 "mask": cdata.mask[idx]}
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        loss, aux = spec.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            updates, opt_state = inner_opt.update(
                dict(zip(leaves, grads)), opt_state, params)
            params = {k: (params[k] + updates[k]).detach() for k in params}
            for k in metrics:
                metrics[k] += aux[k].float()
    return params, total_steps, metrics


@torch.no_grad()
def evaluate(spec: TrainerSpec, params: Params, x: torch.Tensor,
             y: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batched evaluation over a [n_batches, bs, ...] dataset; returns
    summed stats (the caller divides by count)."""
    total: Dict[str, torch.Tensor] = {}
    for i in range(x.shape[0]):
        stats = spec.eval_stats(params, {"x": x[i], "y": y[i],
                                         "mask": mask[i]})
        for k, v in stats.items():
            total[k] = total[k] + v if k in total else v
    return total
