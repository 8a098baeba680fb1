"""Mime (MimeLite): server statistics applied, not updated, locally
(counterpart of ``fedml_tpu/optimizers/mime.py``).

Clients take SGD steps with the server's momentum buffer ``m`` held fixed
(``g' = (1-beta) g + beta m``) and return the full-batch gradient at the
global params; the server refreshes ``m <- (1-beta) avg_full_grad + beta m``
and averages parameters as usual. ``m`` is server state, the
fixed-momentum step a ``grad_transform``, the full-batch gradient an extra.
The local SGD's batch order comes from the first half of ``split(rng)``,
the full-batch pass gets the second.

Assumes a plain-SGD inner optimizer (``client_optimizer: sgd``, zero
client momentum).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..core.algframe.local_training import batch_real_of
from ..core.algframe.types import ClientOutput
from ..core.collectives import tree_add, tree_leaves, tree_sub, \
    tree_zeros_like
from .base import FedOptimizer
from .registry import register


@register
class Mime(FedOptimizer):
    name = "Mime"

    def __init__(self, args, spec):
        super().__init__(args, spec)
        self.beta = float(getattr(args, "server_momentum", 0.9))

    @property
    def transform_key(self):
        return (type(self).__name__, self.beta)

    def server_init(self, params):
        return {"m": tree_zeros_like(params)}

    def server_extras_zero(self, params):
        return {"full_grad": tree_zeros_like(params)}

    def grad_transform(self, grads, params, ctx):
        t = torch._foreach_mul(list(grads.values()), 1.0 - self.beta)
        torch._foreach_add_(t, torch._foreach_mul(
            tree_leaves(ctx["server_state"]["m"], grads), self.beta))
        return dict(zip(grads, t))

    def prepare_programs(self, programs, params, server_state, client_state,
                         cdata, hyper):
        super().prepare_programs(programs, params, server_state,
                                 client_state, cdata, hyper)
        programs.grad_program(cdata).prepare(params, cdata)

    def local_train(self, global_params, server_state, client_state, cdata,
                    rng, hyper, batch_real=None, programs=None):
        if batch_real is None:
            batch_real = batch_real_of(cdata.mask.cpu())
        sgd_rng, grad_rng = prng.split(rng)
        params, steps, metrics = self._local_sgd(
            global_params, server_state, client_state, cdata, sgd_rng, hyper,
            batch_real, programs)
        full_grad, _ = self._full_batch_grad(global_params, cdata, grad_rng,
                                             programs)
        return ClientOutput(
            update=tree_sub(params, global_params),
            weight=cdata.num_samples.float(), client_state=client_state,
            extras={"full_grad": full_grad}, metrics=metrics), steps

    def server_update(self, params, server_state, agg_update, agg_extras,
                      round_idx):
        beta = np.float32(self.beta)
        m = server_state["m"]
        new_m = torch._foreach_mul(
            tree_leaves(agg_extras["full_grad"], m),
            float(np.float32(1.0) - beta))
        torch._foreach_add_(new_m, torch._foreach_mul(list(m.values()),
                                                      float(beta)))
        return tree_add(params, agg_update), {"m": dict(zip(m, new_m))}
