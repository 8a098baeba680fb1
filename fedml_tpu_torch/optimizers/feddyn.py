"""FedDyn: dynamic regularisation (counterpart of
``fedml_tpu/optimizers/feddyn.py``).

Client k minimises ``F_k(w) - <h_k, w> + (alpha/2)||w - w_t||^2``, where
``h_k`` is its accumulated first-order correction; after training
``h_k <- h_k - alpha (w_k - w_t)``. The server keeps ``h``:

    h+ = h - alpha (|S|/N) avg_update,   w+ = (w_t + avg_update) - h+/alpha.

``h_k`` is per-client state, the linear and proximal terms a
``grad_transform``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.collectives import tree_leaves, tree_zeros_like
from .base import FedOptimizer
from .registry import register


@register
class FedDyn(FedOptimizer):
    name = "FedDyn"
    has_client_state = True

    def __init__(self, args, spec):
        super().__init__(args, spec)
        self.alpha = float(getattr(args, "feddyn_alpha", 0.01))
        n_total = int(getattr(args, "client_num_in_total", 1))
        n_round = int(getattr(args, "client_num_per_round", n_total))
        self.participation = float(n_round) / float(max(n_total, 1))

    @property
    def transform_key(self):
        return (type(self).__name__, self.alpha)

    def server_init(self, params):
        return {"h": tree_zeros_like(params)}

    def client_state_init(self, params):
        return {"h_i": tree_zeros_like(params)}

    def grad_transform(self, grads, params, ctx):
        gp, h_i = ctx["global_params"], ctx["client_state"]["h_i"]
        t = torch._foreach_sub([params[k] for k in grads],
                               [gp[k] for k in grads])
        torch._foreach_mul_(t, self.alpha)
        torch._foreach_add_(t, list(grads.values()))
        torch._foreach_sub_(t, tree_leaves(h_i, grads))
        return dict(zip(grads, t))

    def local_train(self, global_params, server_state, client_state, cdata,
                    rng, hyper, batch_real=None, programs=None):
        out, steps = super().local_train(
            global_params, server_state, client_state, cdata, rng, hyper,
            batch_real, programs)
        h_i = client_state["h_i"]
        new_h_i = torch._foreach_sub(
            tree_leaves(h_i, out.update),
            torch._foreach_mul(list(out.update.values()),
                               float(np.float32(self.alpha))))
        return out.replace(
            client_state={"h_i": dict(zip(out.update, new_h_i))}), steps

    def server_update(self, params, server_state, agg_update, agg_extras,
                      round_idx):
        alpha = np.float32(self.alpha)
        frac = np.float32(self.participation)
        h = server_state["h"]
        new_h = torch._foreach_sub(list(h.values()), torch._foreach_mul(
            tree_leaves(agg_update, h), float(alpha * frac)))
        w = torch._foreach_add(list(params.values()),
                               tree_leaves(agg_update, params))
        torch._foreach_sub_(w, torch._foreach_div(new_h, float(alpha)))
        return dict(zip(params, w)), {"h": dict(zip(h, new_h))}
