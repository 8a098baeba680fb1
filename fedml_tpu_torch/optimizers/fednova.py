"""FedNova: normalised averaging for heterogeneous local work (counterpart
of ``fedml_tpu/optimizers/fednova.py``).

Each client normalises its update by its own effective step budget
``a_i``; the server rescales the average by ``tau_eff = Σ_k p_k a_i``:

    w+ = w + tau_eff * Σ_k p_k (Δ_k / a_i).

For momentum-SGD clients (factor rho) ``a_i = (tau - rho(1-rho^tau)/(1-rho))
/ (1-rho)``; for plain SGD ``a_i = tau``. The normalised delta is the
update and ``a_i`` rides the weighted sum as an extra.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.algframe.local_training import batch_real_of, effective_steps
from ..core.algframe.types import ClientOutput
from ..core.collectives import tree_leaves, tree_sub
from .base import FedOptimizer, _device
from .registry import register


@register
class FedNova(FedOptimizer):
    name = "FedNova"

    def _a_i(self, tau: np.float32) -> np.float32:
        """In float32, as the JAX package computes it."""
        rho = np.float32(self.momentum)
        if not rho > 0:
            return tau
        one = np.float32(1.0)
        return (tau - rho * (one - np.power(rho, tau)) / (one - rho)) / (
            one - rho)

    def local_train(self, global_params, server_state, client_state, cdata,
                    rng, hyper, batch_real=None, programs=None):
        if batch_real is None:
            batch_real = batch_real_of(cdata.mask.cpu())
        params, steps, metrics = self._local_sgd(
            global_params, server_state, client_state, cdata, rng, hyper,
            batch_real, programs)
        delta = tree_sub(params, global_params)
        a_i = self._a_i(effective_steps(batch_real, hyper.epochs,
                                        hyper.work_scale))
        normalized = dict(zip(delta, torch._foreach_div(
            list(delta.values()), float(a_i))))
        return ClientOutput(
            update=normalized, weight=cdata.num_samples.float(),
            client_state=client_state,
            extras={"a": torch.tensor(a_i, dtype=torch.float32,
                                      device=_device(params))},
            metrics=metrics), steps

    def server_extras_zero(self, params):
        return {"a": torch.zeros((), dtype=torch.float32,
                                 device=_device(params))}

    def server_update(self, params, server_state, agg_update, agg_extras,
                      round_idx):
        tau_eff = agg_extras["a"]  # Σ_k p_k a_i (the weighted average)
        new = torch._foreach_add(list(params.values()), torch._foreach_mul(
            tree_leaves(agg_update, params), tau_eff))
        return dict(zip(params, new)), server_state
