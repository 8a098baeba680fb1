"""Federated serving runner, ``training_type: fedml_serving`` (a copy of
``fedml_tpu/serving/federated.py``; reference ``serving/client/*`` +
``serving/server/*`` and the ``runner.py:137`` dispatch): a federated
session whose end state is a live model endpoint. The silos train
together, the server aggregates and then serves the global model.

The training phase is the cross-silo runtime; this runner chains it with
:class:`FedMLInferenceRunner`, so the aggregate goes live on ``/predict``
the moment the session finishes. Every party runs on ``device``, the
endpoint's :class:`CheckpointPredictor` too.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class FederatedServingRunner:
    """role=server: run the FL session, then serve the aggregate over HTTP
    (blocking unless ``serving_block: false``); role=client: a plain
    silo."""

    def __init__(self, args, dataset, model, client_trainer=None,
                 server_aggregator=None, *, device,
                 init_params: Optional[Dict[str, Any]] = None):
        from ..cross_silo.horizontal.runner import CrossSiloRunner
        self.args = args
        self.fed = dataset
        self.bundle = model
        self.device = device
        self.role = str(getattr(args, "role", "client")).lower()
        self.inner = CrossSiloRunner(args, dataset, model, client_trainer,
                                     server_aggregator, device=device,
                                     init_params=init_params)
        self.inference_runner = None

    def run(self, comm_round: Optional[int] = None) -> Any:
        result = self.inner.run(comm_round)
        if self.role != "server" or not isinstance(result, dict):
            return result
        from . import CheckpointPredictor, FedMLInferenceRunner
        predictor = CheckpointPredictor(self.bundle, result["params"],
                                        device=self.device)
        port = int(getattr(self.args, "serving_port", 0) or 0)
        self.inference_runner = FedMLInferenceRunner(predictor, port=port)
        block = bool(getattr(self.args, "serving_block", False))
        if block:
            logger.info("federated serving: endpoint on :%d",
                        self.inference_runner.port)
            self.inference_runner.run()
        else:
            self.inference_runner.start()
            logger.info("federated serving: endpoint live on :%d",
                        self.inference_runner.port)
        result["serving_port"] = self.inference_runner.port
        return result
