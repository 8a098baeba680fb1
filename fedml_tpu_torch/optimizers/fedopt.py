"""FedOpt: adaptive *server* optimisation over the aggregated
pseudo-gradient, plus the degenerate FedSGD / FedLocalSGD variants
(counterpart of ``fedml_tpu/optimizers/fedopt.py``).

The JAX package's server step is an optax transform; here
:class:`ServerOptimizer` reproduces optax 0.2.6's ``sgd`` (a ``trace`` with
decay ``server_momentum``, none at 0, not Nesterov), ``adam`` (b1 0.9, b2
0.999, eps 1e-8, eps_root 0, bias correction by an int32 count),
``adagrad`` (accumulator 0.1, eps 1e-7, ``where(s > 0, rsqrt(s + eps), 0)``)
and ``yogi`` (accumulators 1e-6, eps 1e-3, the sign update of ``nu``, bias
correction as adam's), each followed by ``-lr``, term for term, as a
functional transform with its state in explicit tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.algframe.local_training import full_batch_grad_sum
from ..core.algframe.types import ClientOutput, Params
from ..core.collectives import tree_leaves, tree_unflatten
from .base import FedOptimizer
from .registry import register

SERVER_OPTIMIZERS = ("sgd", "adam", "adagrad", "yogi")


class ServerOptimizer:
    """``init(params) -> state`` and ``update(grads, state) -> (updates,
    state)``, both on ``Params`` dicts; new tensors, the caller adds the
    updates to the params (optax's ``apply_updates``)."""

    def __init__(self, name: str, lr: float, momentum: float = 0.9):
        name = (name or "sgd").lower()
        if name not in SERVER_OPTIMIZERS:
            raise ValueError(f"unknown server_optimizer {name!r}")
        self.name = name
        self.lr = float(lr)
        self.momentum = float(momentum or 0.0)
        # optax's adam / yogi defaults
        self.b1, self.b2 = 0.9, 0.999
        self.eps = {"adam": 1e-8, "adagrad": 1e-7, "yogi": 1e-3}.get(name)

    def init(self, params: Params) -> Dict[str, Any]:
        def full(v):
            return {k: torch.full_like(t, v) for k, t in params.items()}

        dev = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        if self.name == "sgd":
            return {"trace": full(0.0)} if self.momentum else {}
        if self.name == "adam":
            return {"count": count, "mu": full(0.0), "nu": full(0.0)}
        if self.name == "adagrad":
            return {"sum_of_squares": full(0.1)}
        return {"count": count, "mu": full(1e-6), "nu": full(1e-6)}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any]
               ) -> Tuple[Params, Dict[str, Any]]:
        g = list(grads.values())
        wrap = lambda ts: tree_unflatten(grads, ts)  # noqa: E731
        if self.name == "sgd":
            if not self.momentum:
                return wrap(torch._foreach_mul(g, -self.lr)), {}
            # trace: t = g + decay * t
            t = torch._foreach_mul(tree_leaves(state["trace"], grads),
                                   self.momentum)
            torch._foreach_add_(t, g)
            return wrap(torch._foreach_mul(t, -self.lr)), {"trace": wrap(t)}
        if self.name == "adagrad":
            s = torch._foreach_mul(g, g)
            torch._foreach_add_(s, tree_leaves(state["sum_of_squares"],
                                               grads))
            inv = [torch.where(v > 0, torch.rsqrt(v + self.eps),
                               torch.zeros_like(v)) for v in s]
            u = torch._foreach_mul(inv, g)
            return (wrap(torch._foreach_mul(u, -self.lr)),
                    {"sum_of_squares": wrap(s)})
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu
        mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(
            tree_leaves(state["mu"], grads), b1))
        g2 = torch._foreach_mul(g, g)
        nu_old = tree_leaves(state["nu"], grads)
        if self.name == "adam":
            # nu = (1 - b2) g^2 + b2 nu
            nu = torch._foreach_mul(g2, 1 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(nu_old, b2))
        else:
            # yogi: nu = v - (1 - b2) sign(v - g^2) g^2
            sign = torch._foreach_sub(nu_old, g2)
            sign = [torch.sign(v) for v in sign]
            step = torch._foreach_mul(torch._foreach_mul(sign, 1 - b2), g2)
            nu = torch._foreach_sub(nu_old, step)
        count = state["count"] + 1
        # 1 - decay**count in float32, then divide (optax's bias_correction)
        c = count.float()
        bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
        bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu_hat, denom)
        return (wrap(torch._foreach_mul(u, -self.lr)),
                {"count": count, "mu": wrap(mu), "nu": wrap(nu)})


def make_server_optimizer(name: str, lr: float, momentum: float = 0.9
                          ) -> ServerOptimizer:
    return ServerOptimizer(name, lr, momentum)


def _apply(params: Params, updates: Params) -> Params:
    return tree_unflatten(params, torch._foreach_add(
        list(params.values()), tree_leaves(updates, params)))


@register
class FedOpt(FedOptimizer):
    """``server_optimizer`` (sgd with momentum ``server_momentum``, adam,
    adagrad, yogi; Reddi et al., "Adaptive Federated Optimization") at
    ``server_lr`` on the pseudo-gradient ``-avg(Δ)``."""

    name = "FedOpt"

    def __init__(self, args, spec):
        super().__init__(args, spec)
        self.server_opt = make_server_optimizer(
            getattr(args, "server_optimizer", "sgd"),
            float(getattr(args, "server_lr", 1.0)),
            float(getattr(args, "server_momentum", 0.9)))

    def server_init(self, params):
        return {"opt_state": self.server_opt.init(params)}

    def _step(self, params, server_state, agg_update):
        pseudo_grad = tree_unflatten(agg_update, torch._foreach_neg(
            list(agg_update.values())))
        return self.server_opt.update(pseudo_grad,
                                      server_state["opt_state"])

    def server_update(self, params, server_state, agg_update, agg_extras,
                      round_idx):
        updates, opt_state = self._step(params, server_state, agg_update)
        return _apply(params, updates), {"opt_state": opt_state}

    def server_update_async(self, params, server_state, agg_update,
                            agg_extras, round_idx, merge_scale, pour_frac):
        """Adaptive server optimisers normalise away the input's scale, so
        the APPLIED step is damped by ``merge_scale``; the moments take the
        undamped pseudo-gradient."""
        del pour_frac
        updates, opt_state = self._step(params, server_state, agg_update)
        damped = tree_unflatten(updates, torch._foreach_mul(
            list(updates.values()), float(np.float32(merge_scale))))
        return _apply(params, damped), {"opt_state": opt_state}


@register
class FedSGD(FedOptimizer):
    """One aggregated gradient step per round: clients return their
    full-batch gradient (no local SGD), the server applies it with
    ``server_lr``."""

    name = "FedSGD"
    # every client's gradient is taken at the SAME global params, and the
    # aggregate Σ_k n_k upd_k = -Σ over all reporting samples g_i is
    # additive over samples, so the sampled clients may fold into the
    # batch axis (client_slot_fold)
    folds_client_slots = True

    def __init__(self, args, spec):
        super().__init__(args, spec)
        self.server_lr = float(getattr(args, "server_lr", 1.0))

    def prepare_programs(self, programs, params, server_state, client_state,
                         cdata, hyper):
        programs.grad_program(cdata).prepare(params, cdata)

    def local_train(self, global_params, server_state, client_state, cdata,
                    rng, hyper, batch_real=None, programs=None):
        grads, metrics = self._full_batch_grad(global_params, cdata, rng,
                                               programs)
        update = tree_unflatten(grads, torch._foreach_neg(
            list(grads.values())))
        return ClientOutput(update=update, weight=cdata.num_samples.float(),
                            client_state=client_state, extras={},
                            metrics=metrics), 0

    def local_train_folded(self, global_params, folded_cdata, rng,
                           programs=None):
        """One pass over the sampled clients folded into the batch axis:
        the weight-scaled update SUM ``-Σ_i g_i`` and the summed metrics,
        what the per-client loop's ``Σ_k w_k upd_k`` would hold."""
        if programs is None:
            grad_sum, metrics = full_batch_grad_sum(
                self.spec, global_params, folded_cdata, rng)
        else:
            grad_sum, metrics = programs.grad_program(folded_cdata).run(
                global_params, folded_cdata, rng)
        return tree_unflatten(grad_sum, torch._foreach_neg(
            list(grad_sum.values()))), metrics

    def server_update(self, params, server_state, agg_update, agg_extras,
                      round_idx):
        new = torch._foreach_add(list(params.values()), torch._foreach_mul(
            tree_leaves(agg_update, params),
            float(np.float32(self.server_lr))))
        return tree_unflatten(params, new), server_state


@register
class FedLocalSGD(FedOptimizer):
    """Local SGD with periodic (uniform) parameter averaging: FedAvg with
    equal client weights."""

    name = "FedLocalSGD"

    def local_train(self, global_params, server_state, client_state, cdata,
                    rng, hyper, batch_real=None, programs=None):
        out, steps = super().local_train(
            global_params, server_state, client_state, cdata, rng, hyper,
            batch_real, programs)
        return out.replace(weight=torch.ones(
            (), dtype=torch.float32, device=out.weight.device)), steps
