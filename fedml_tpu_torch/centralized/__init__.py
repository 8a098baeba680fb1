"""The centralized (non-FL) baseline trainer (counterpart of
``fedml_tpu/centralized/__init__.py``, ``federated_optimizer:
centralized``).

It pools every client's real samples into one padded batch stream (in
client order, the last batch padded) and trains one model on it with the
local loop the FL engines use, so "FL vs centralized" differs only in the
protocol. Each ``run`` step is one epoch: plain or momentum SGD
(``momentum``) whose state carries from epoch to epoch, key ``fold_in(rng,
epoch)`` (``rng`` the second half of ``split(PRNGKey(seed))``), an
evaluation every ``frequency_of_the_test`` epochs and at the last.

Every epoch runs through one
:class:`~fedml_tpu_torch.core.algframe.local_training.StepProgram`, its
optimizer state kept from epoch to epoch: on a card each step replays
one captured graph (the fused conv block of a ResNet runs inside it, as
in the engine); on the CPU the same step body runs eagerly.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import prng
from ..core.algframe.client_trainer import (make_inner_optimizer,
                                            make_trainer_spec)
from ..core.algframe.local_training import (StepProgram, batch_real_of,
                                            evaluate)
from ..core.algframe.types import ClientData, TrainHyper
from ..simulation.gpu.engine import load_params

logger = logging.getLogger(__name__)


def pool_clients(train: ClientData) -> ClientData:
    """Every client's real samples, in client order, as one padded
    ``[n_batches, bs, ...]`` stream (host numpy)."""
    x, y, m = (np.asarray(a) for a in (train.x, train.y, train.mask))
    bs = x.shape[2]
    real = m.reshape(-1) > 0
    flat_x = x.reshape((-1,) + x.shape[3:])[real]
    flat_y = y.reshape((-1,) + y.shape[3:])[real]
    n = len(flat_x)
    nb = max(1, -(-n // bs))
    pad = nb * bs - n
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    if pad:
        flat_x = np.concatenate(
            [flat_x, np.zeros((pad,) + flat_x.shape[1:], flat_x.dtype)])
        flat_y = np.concatenate(
            [flat_y, np.zeros((pad,) + flat_y.shape[1:], flat_y.dtype)])
    return ClientData(x=flat_x.reshape((nb, bs) + flat_x.shape[1:]),
                      y=flat_y.reshape((nb, bs) + flat_y.shape[1:]),
                      mask=mask.reshape(nb, bs), num_samples=np.float32(n))


class CentralizedTrainer:
    """Train one model on the union of all clients' data."""

    def __init__(self, args, fed_dataset, bundle, spec=None,
                 device: torch.device = None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.bundle = bundle
        self.device = torch.device(device)
        self.spec = spec or make_trainer_spec(fed_dataset, bundle)
        pooled = pool_clients(fed_dataset.train)
        self.batch_real = batch_real_of(pooled.mask)
        self.data = pooled.to(self.device)
        seed = int(getattr(args, "random_seed", 0))
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        if init_params is None:
            self.params = bundle.init(torch.Generator().manual_seed(seed),
                                      self.device)
        else:
            self.params = load_params(bundle, init_params, self.device)
        self.lr = float(getattr(args, "learning_rate", 0.03))
        self.inner = make_inner_optimizer(
            "sgd", self.lr, momentum=float(getattr(args, "momentum", 0.0)
                                           or 0.0))
        self.program = StepProgram(self.spec, self.inner, self.params,
                                   self.data)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fed_dataset.test.items()}
        self.history = []

    def _epoch(self, e: int):
        key = prng.fold_in(self.rng, e)
        hyper = TrainHyper(learning_rate=self.lr, epochs=1)
        params, _, metrics = self.program.run(
            self.params, self.data, key, hyper, self.batch_real,
            reset_opt=e == 0)
        return {k: v.clone() for k, v in params.items()}, metrics

    def run(self, comm_round=None) -> Dict[str, Any]:
        epochs = int(comm_round if comm_round is not None
                     else getattr(self.args, "epochs", 1)
                     * getattr(self.args, "comm_round", 1))
        t0 = time.time()
        for e in range(epochs):
            self.params, metrics = self._epoch(e)
            cnt = max(float(metrics["count"]), 1.0)
            rec = {"epoch": e,
                   "train_loss": float(metrics["loss_sum"]) / cnt,
                   "train_acc": float(metrics["correct"]) / cnt}
            freq = int(getattr(self.args, "frequency_of_the_test", 5) or 5)
            if e % freq == 0 or e == epochs - 1:
                stats = evaluate(self.spec, self.params, self.test["x"],
                                 self.test["y"], self.test["mask"])
                rec["test_acc"] = (float(stats["correct"])
                                   / max(float(stats["count"]), 1.0))
                logger.info("centralized epoch %d: acc=%.4f", e,
                            rec["test_acc"])
            self.history.append(rec)
        last = next((h for h in reversed(self.history) if "test_acc" in h),
                    {})
        return {"params": self.params, "history": self.history,
                "final_test_acc": last.get("test_acc"),
                "wall_time_s": time.time() - t0, "rounds": epochs}
