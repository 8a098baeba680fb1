"""SCAFFOLD: stochastic controlled averaging with control variates
(counterpart of ``fedml_tpu/optimizers/scaffold.py``).

Client drift correction ``g <- g + c - c_i``; option-II control-variate
update ``c_i+ = c_i - c + (w_t - w_local)/(K lr)``; server
``x <- x + lr_g avg(dx)``, ``c <- c + (|S|/N) avg(dc)``. ``c`` lives in the
server state, each client's ``c_i`` in the engine's per-client state, the
correction is a ``grad_transform`` on the shared local step, and ``dc_i``
rides the weighted sum as an extra.

The control-variate update assumes a plain-SGD inner optimizer
(``client_optimizer: sgd``, zero momentum).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.algframe.local_training import batch_real_of, effective_steps
from ..core.algframe.types import ClientOutput
from ..core.collectives import tree_leaves, tree_sub, tree_zeros_like
from .base import FedOptimizer
from .registry import register


@register
class SCAFFOLD(FedOptimizer):
    name = "SCAFFOLD"
    has_client_state = True

    def __init__(self, args, spec):
        super().__init__(args, spec)
        self.server_lr = float(getattr(args, "server_lr", 1.0))
        n_total = int(getattr(args, "client_num_in_total", 1))
        n_round = int(getattr(args, "client_num_per_round", n_total))
        self.participation = float(n_round) / float(max(n_total, 1))

    def server_init(self, params):
        return {"c": tree_zeros_like(params)}

    def client_state_init(self, params):
        return {"c_i": tree_zeros_like(params)}

    def server_extras_zero(self, params):
        return {"delta_c": tree_zeros_like(params)}

    def grad_transform(self, grads, params, ctx):
        t = torch._foreach_add(list(grads.values()),
                               tree_leaves(ctx["server_state"]["c"], grads))
        torch._foreach_sub_(t, tree_leaves(ctx["client_state"]["c_i"],
                                           grads))
        return dict(zip(grads, t))

    def local_train(self, global_params, server_state, client_state, cdata,
                    rng, hyper, batch_real=None, programs=None):
        if batch_real is None:
            batch_real = batch_real_of(cdata.mask.cpu())
        params, steps, metrics = self._local_sgd(
            global_params, server_state, client_state, cdata, rng, hyper,
            batch_real, programs)
        update = tree_sub(params, global_params)
        k = effective_steps(batch_real, hyper.epochs, hyper.work_scale)
        inv_klr = np.float32(1.0) / (k * np.float32(hyper.learning_rate))
        c, c_i = server_state["c"], client_state["c_i"]
        # option II: c_i+ = c_i - c - update/(K*lr)
        new = torch._foreach_sub(tree_leaves(c_i, update),
                                 tree_leaves(c, update))
        torch._foreach_sub_(new, torch._foreach_mul(
            list(update.values()), float(inv_klr)))
        new_c_i = dict(zip(update, new))
        return ClientOutput(
            update=update, weight=cdata.num_samples.float(),
            client_state={"c_i": new_c_i},
            extras={"delta_c": tree_sub(new_c_i, c_i)},
            metrics=metrics), steps

    def server_update(self, params, server_state, agg_update, agg_extras,
                      round_idx):
        return self._step(params, server_state, agg_update, agg_extras,
                          np.float32(self.server_lr),
                          np.float32(self.participation))

    def server_update_async(self, params, server_state, agg_update,
                            agg_extras, round_idx, merge_scale, pour_frac):
        """The params step is the damped aggregate (as the base default),
        but the control variate advances by the POURED population fraction
        (``K / N``), not the sync cohort fraction; ``delta_c`` is damped by
        the same ``merge_scale``."""
        ms = np.float32(merge_scale)
        return self._step(params, server_state, agg_update, agg_extras,
                          np.float32(self.server_lr) * ms,
                          np.float32(pour_frac) * ms)

    @staticmethod
    def _step(params, server_state, agg_update, agg_extras, lr, frac):
        new_params = torch._foreach_add(
            list(params.values()),
            torch._foreach_mul(tree_leaves(agg_update, params), float(lr)))
        c = server_state["c"]
        new_c = torch._foreach_add(
            list(c.values()),
            torch._foreach_mul(tree_leaves(agg_extras["delta_c"], c),
                               float(frac)))
        return dict(zip(params, new_params)), {"c": dict(zip(c, new_c))}
