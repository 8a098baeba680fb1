"""Federated optimizer protocol: a (client transform, server transform) pair
(counterpart of ``fedml_tpu/optimizers/base.py``; FedAvg only).

The engine calls ``local_train`` per scheduled client, sums
``update * weight``, divides by the summed weight and calls
``server_update``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.algframe.client_trainer import (InnerOptimizer, TrainerSpec,
                                            make_inner_optimizer)
from ..core.algframe.local_training import StepProgram, run_local_sgd
from ..core.algframe.types import (ClientData, ClientOutput, Params,
                                   TrainHyper)


class FedOptimizer:
    """FedAvg: weighted average of client models with post-sampling
    ``n_k/Σn`` weights, in delta form ``w <- w + Σ n_k Δ_k / Σ n_k``."""

    name = "FedAvg"

    def __init__(self, args, spec: TrainerSpec):
        self.args = args
        self.spec = spec
        self.inner_opt_name = getattr(args, "client_optimizer", "sgd")
        self.momentum = getattr(args, "momentum", 0.0) or 0.0
        self.weight_decay = getattr(args, "weight_decay", 0.0) or 0.0

    def server_init(self, params: Params) -> Dict[str, Any]:
        return {}

    def make_inner_opt(self, hyper: TrainHyper) -> InnerOptimizer:
        return make_inner_optimizer(
            self.inner_opt_name, hyper.learning_rate,
            momentum=self.momentum, weight_decay=self.weight_decay)

    def local_train(self, global_params: Params, server_state,
                    cdata: ClientData, rng: np.ndarray, hyper: TrainHyper,
                    batch_real: Optional[np.ndarray] = None,
                    program: Optional[StepProgram] = None
                    ) -> Tuple[ClientOutput, int]:
        """One client's local SGD; returns its output and its step count.
        With ``program`` (built by :meth:`make_step_program`) the steps run
        through it, else through the eager loop."""
        if program is None:
            params, steps, metrics = run_local_sgd(
                self.spec, self.make_inner_opt(hyper), global_params, cdata,
                rng, hyper, batch_real=batch_real)
        else:
            params, steps, metrics = program.run(
                global_params, cdata, rng, hyper, batch_real)
        update = {k: params[k] - global_params[k] for k in params}
        return ClientOutput(update=update, weight=cdata.num_samples.float(),
                            metrics=metrics), steps

    def make_step_program(self, params: Params, cdata: ClientData,
                          hyper: TrainHyper) -> StepProgram:
        return StepProgram(self.spec, self.make_inner_opt(hyper), params,
                           cdata)

    def server_update(self, params: Params, server_state, agg_update: Params,
                      round_idx: int) -> Tuple[Params, Any]:
        """``agg_update`` is already weight-averaged by the engine."""
        return ({k: params[k] + agg_update[k] for k in params},
                server_state)
