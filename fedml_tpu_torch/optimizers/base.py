"""Federated optimizer protocol: a (client transform, server transform) pair
(counterpart of ``fedml_tpu/optimizers/base.py``).

The engine (the SP golden loop or the GPU engine) is optimizer-agnostic:
it calls ``local_train`` per scheduled client, sums ``update * weight`` and
``extras * weight``, divides both by ``max(Σw, 1e-12)`` and calls
``server_update``. It keeps each client's persistent state
(``client_state_init``) across rounds, hands it to ``local_train`` and
stores the state it returns.

``local_train`` runs its steps through the engine's programs when it gets
them (``programs``: an object with ``step_program(hyper)`` and
``grad_program(cdata)``, the GPU engine), else through the eager loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.algframe.client_trainer import (InnerOptimizer, TrainerSpec,
                                            make_inner_optimizer)
from ..core.algframe.local_training import (GradProgram, GradTransform,
                                            StepProgram, batch_real_of,
                                            full_batch_grad, run_local_sgd)
from ..core.algframe.types import (ClientData, ClientOutput, Params,
                                   TrainHyper)
from ..core.collectives import tree_add, tree_scale, tree_sub

PyTree = Any


def _device(params: Params) -> torch.device:
    return next(iter(params.values())).device


class StepPrograms(dict):
    """The program protocol ``local_train`` takes (``programs=``) for a
    simulator that trains its clients one after another: one optimizer
    step program per inner optimizer, built at first use from the
    simulator's params and a client's data (captured into a CUDA graph at
    its first client on a card, eager on the CPU)."""

    def __init__(self, opt: "FedOptimizer", params: Params, server_state,
                 cdata: ClientData):
        super().__init__()
        self.opt, self.params = opt, params
        self.server_state, self.cdata = server_state, cdata

    def step_program(self, hyper: TrainHyper) -> StepProgram:
        key = self.opt.make_inner_opt(hyper).key
        if key not in self:
            self[key] = self.opt.make_step_program(
                self.params, self.server_state, self.cdata, hyper)
        return self[key]


class FedOptimizer:
    """Base = FedAvg: weighted average of client models with post-sampling
    ``n_k/Σn`` weights, in delta form ``w <- w + Σ n_k Δ_k / Σ n_k``."""

    name = "FedAvg"
    has_client_state = False
    # True only for optimizers whose client pass evaluates the SHARED
    # global params with no per-client trajectory (FedSGD): the engine may
    # then fold the sampled clients into the batch axis
    # (``client_slot_fold``), because the weighted update sum is additive
    # over samples
    folds_client_slots = False

    def __init__(self, args, spec: TrainerSpec):
        self.args = args
        self.spec = spec
        self.inner_opt_name = getattr(args, "client_optimizer", "sgd")
        self.momentum = getattr(args, "momentum", 0.0) or 0.0
        self.weight_decay = getattr(args, "weight_decay", 0.0) or 0.0

    # --- state constructors -------------------------------------------------
    def server_init(self, params: Params) -> Dict[str, Any]:
        return {}

    def client_state_init(self, params: Params) -> Dict[str, Any]:
        """Per-client persistent state (one client's worth; the GPU engine
        stacks it over all clients)."""
        return {}

    def server_extras_zero(self, params: Params) -> Dict[str, Any]:
        """Zeros in the structure of ``ClientOutput.extras``: the start of
        the weighted sum."""
        return {}

    # --- client transform ---------------------------------------------------
    def make_inner_opt(self, hyper: TrainHyper) -> InnerOptimizer:
        return make_inner_optimizer(
            self.inner_opt_name, hyper.learning_rate,
            momentum=self.momentum, weight_decay=self.weight_decay)

    def grad_transform(self, grads: Params, params: Params,
                       ctx: Dict[str, Any]) -> Params:
        """Rewrite one step's gradients (``ctx``: ``global_params``,
        ``server_state``, ``client_state``). Runs inside the captured step,
        so it reads only ``ctx`` and Python constants."""
        return grads

    @property
    def transform(self) -> Optional[GradTransform]:
        """``grad_transform`` when the class overrides it, else None (the
        step then has no hook and keeps no ``ctx``)."""
        if type(self).grad_transform is FedOptimizer.grad_transform:
            return None
        return self.grad_transform

    @property
    def transform_key(self) -> Tuple:
        """What a captured step bakes in besides the inner optimizer: the
        optimizer and the constants its transform reads."""
        return (type(self).__name__,)

    def _ctx(self, global_params, server_state, client_state):
        return {"global_params": global_params, "server_state": server_state,
                "client_state": client_state}

    def make_step_program(self, params: Params, server_state,
                          cdata: ClientData, hyper: TrainHyper
                          ) -> StepProgram:
        template = (None if self.transform is None else self._ctx(
            params, server_state, self.client_state_init(params)))
        return StepProgram(self.spec, self.make_inner_opt(hyper), params,
                           cdata, grad_transform=self.transform,
                           ctx_template=template)

    def prepare_programs(self, programs, params: Params, server_state,
                         client_state, cdata: ClientData,
                         hyper: TrainHyper) -> None:
        """Build, and on a card capture, each program ``local_train`` runs,
        so their one-time cost falls outside a timed block."""
        ctx = (None if self.transform is None
               else self._ctx(params, server_state, client_state))
        programs.step_program(hyper).prepare(params, cdata, hyper, ctx)

    def _local_sgd(self, global_params, server_state, client_state, cdata,
                   rng, hyper, batch_real, programs):
        """Local SGD from the global params with this optimizer's
        transform: through the engine's step program, or eagerly."""
        ctx = (None if self.transform is None
               else self._ctx(global_params, server_state, client_state))
        if programs is None:
            return run_local_sgd(
                self.spec, self.make_inner_opt(hyper), global_params, cdata,
                rng, hyper, batch_real=batch_real,
                grad_transform=self.transform, ctx=ctx)
        return programs.step_program(hyper).run(
            global_params, cdata, rng, hyper, batch_real, ctx=ctx)

    def _full_batch_grad(self, params, cdata, rng, programs):
        program: Optional[GradProgram] = (
            None if programs is None else programs.grad_program(cdata))
        return full_batch_grad(self.spec, params, cdata, rng, program)

    def local_train(self, global_params: Params, server_state,
                    client_state, cdata: ClientData, rng: np.ndarray,
                    hyper: TrainHyper,
                    batch_real: Optional[np.ndarray] = None, programs=None
                    ) -> Tuple[ClientOutput, int]:
        """One client's round; returns its output and its local SGD step
        count. ``batch_real`` (host bools per batch) saves a read of the
        mask."""
        if batch_real is None:
            batch_real = batch_real_of(cdata.mask.cpu())
        params, steps, metrics = self._local_sgd(
            global_params, server_state, client_state, cdata, rng, hyper,
            batch_real, programs)
        return ClientOutput(
            update=tree_sub(params, global_params),
            weight=cdata.num_samples.float(), client_state=client_state,
            extras={}, metrics=metrics), steps

    # --- server transform ---------------------------------------------------
    def server_update(self, params: Params, server_state,
                      agg_update: Params, agg_extras: Dict[str, Any],
                      round_idx: int) -> Tuple[Params, Any]:
        """``agg_update`` and ``agg_extras`` are already weight-averaged by
        the engine (``Σ n_k x_k / Σ n_k``)."""
        return tree_add(params, agg_update), server_state

    def server_update_async(self, params: Params, server_state,
                            agg_update: Params, agg_extras: Dict[str, Any],
                            round_idx: int, merge_scale, pour_frac
                            ) -> Tuple[Params, Any]:
        """Buffered-async server transform: ``agg_update``/``agg_extras``
        are one poured buffer's staleness-weighted average, ``merge_scale``
        the pour's damping and ``pour_frac`` the poured fraction of the
        population (``K / N``). Default: damp the aggregate and extras by
        ``merge_scale`` and reuse the sync transform (exact for transforms
        linear in the update); optimizers whose server step is not linear
        override it. No engine calls it until the async engine is ported."""
        del pour_frac  # linear transforms need no separate fraction
        s = float(merge_scale)
        return self.server_update(params, server_state,
                                  tree_scale(agg_update, s),
                                  tree_scale(agg_extras, s), round_idx)
