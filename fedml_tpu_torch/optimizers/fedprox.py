"""FedProx: proximal-regularised local training (counterpart of
``fedml_tpu/optimizers/fedprox.py``).

Local objective ``F_k(w) + (mu/2)||w - w_t||^2``: the proximal term is a
``grad_transform`` on the shared local step, ``g <- g + mu (w - w_t)``; the
server transform is FedAvg's.
"""

from __future__ import annotations

import torch

from .base import FedOptimizer
from .registry import register


@register
class FedProx(FedOptimizer):
    name = "FedProx"

    def __init__(self, args, spec):
        super().__init__(args, spec)
        self.mu = float(getattr(args, "fedprox_mu", 0.1))

    @property
    def transform_key(self):
        return (type(self).__name__, self.mu)

    def grad_transform(self, grads, params, ctx):
        gp = ctx["global_params"]
        t = torch._foreach_sub([params[k] for k in grads],
                               [gp[k] for k in grads])
        torch._foreach_mul_(t, self.mu)
        torch._foreach_add_(t, list(grads.values()))
        return dict(zip(grads, t))
