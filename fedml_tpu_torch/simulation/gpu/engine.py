"""The GPU simulator: an FL round on one CUDA device (counterpart of the
round core of ``fedml_tpu/simulation/tpu/engine.py``, ``TPUSimulator``).

The JAX package runs a round as one SPMD program: a ``lax.scan`` over each
chip's schedule slots, a weighted ``psum`` over the ``client`` mesh axis and
the server transform. On one device the psum is the identity, so the round
here is: each sampled client in schedule order trains from the global
params (its key is ``fold_in(round_key, client_id)``, the JAX engine's
``gcid``), its update is accumulated weighted by ``num_samples``, the sum is
divided by ``max(Σw, 1e-12)`` and ``server_update`` applies it. The test set
is evaluated every ``frequency_of_the_test`` rounds and after the last.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import evaluate
from ...core.algframe.types import Params, TrainHyper
from ..sampling import client_sampling, sampling_stream_from_args

logger = logging.getLogger(__name__)


class GPUSimulator:
    """FedAvg simulation on one device: clients' data resident on the
    device, clients trained one after another."""

    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.bundle = bundle
        self.opt = optimizer
        self.spec = spec
        self.device = device
        seed = int(getattr(args, "random_seed", 0))
        self.seed = seed
        self.stream = sampling_stream_from_args(args)
        # the JAX engine splits PRNGKey(seed) into (init, round stream);
        # parameter init here draws from a torch.Generator instead, so only
        # the round stream is kept
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        self.train = fed_dataset.train.to(device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in fed_dataset.test.items()}
        if init_params is None:
            gen = torch.Generator().manual_seed(seed)
            self.params = bundle.init(gen, device)
        else:
            self.params = self._load_params(init_params)
        self.server_state = optimizer.server_init(self.params)
        self.history: List[Dict[str, Any]] = []

    def _load_params(self, init_params: Dict[str, Any]) -> Params:
        """Start from given parameters (a state dict of tensors or numpy
        arrays under the module's names) instead of a fresh init."""
        self.bundle.module.to(self.device)
        want = self.bundle.module.state_dict()
        if set(init_params) != set(want):
            raise ValueError(
                f"init_params keys differ from the model's: missing "
                f"{sorted(set(want) - set(init_params))}, unexpected "
                f"{sorted(set(init_params) - set(want))}")
        params = {}
        for k, ref in want.items():
            v = init_params[k]
            v = v.detach() if torch.is_tensor(v) else torch.tensor(
                np.asarray(v))
            if tuple(v.shape) != tuple(ref.shape):
                raise ValueError(f"init_params[{k!r}]: shape "
                                 f"{tuple(v.shape)} != {tuple(ref.shape)}")
            params[k] = v.to(self.device, torch.float32).clone()
        return params

    def run_round(self, round_idx: int, hyper: TrainHyper):
        """One FedAvg round; returns (summed metrics, local steps run)."""
        sampled = client_sampling(
            round_idx, self.fed.num_clients,
            int(self.args.client_num_per_round), random_seed=self.seed,
            stream=self.stream)
        round_key = prng.fold_in(self.rng, round_idx)
        acc_u = {k: torch.zeros_like(v) for k, v in self.params.items()}
        acc_w = torch.zeros((), dtype=torch.float32, device=self.device)
        acc_m: Dict[str, torch.Tensor] = {}
        steps = 0
        for cid in sampled:
            cid = int(cid)
            out, n_steps = self.opt.local_train(
                self.params, self.server_state, self.train.client(cid),
                prng.fold_in(round_key, cid), hyper)
            steps += n_steps
            with torch.no_grad():
                for k, u in out.update.items():
                    acc_u[k] += u * out.weight
            acc_w = acc_w + out.weight
            for k, m in out.metrics.items():
                acc_m[k] = acc_m[k] + m if k in acc_m else m
        denom = torch.clamp(acc_w, min=1e-12)
        agg = {k: v / denom for k, v in acc_u.items()}
        self.params, self.server_state = self.opt.server_update(
            self.params, self.server_state, agg, round_idx)
        return acc_m, steps

    def evaluate(self) -> Dict[str, float]:
        stats = evaluate(self.spec, self.params, self.test["x"],
                         self.test["y"], self.test["mask"])
        n = max(float(stats["count"]), 1.0)
        return {"test_acc": float(stats["correct"]) / n,
                "test_loss": float(stats["loss_sum"]) / n}

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(
            args.comm_round)
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        n_test_batches = int(self.test["x"].shape[0])
        t0 = time.time()
        for r in range(rounds):
            t_r = time.time()
            metrics, steps = self.run_round(r, hyper)
            cnt = max(float(metrics["count"]), 1.0)
            rec: Dict[str, Any] = {
                "round": r,
                "train_loss": float(metrics["loss_sum"]) / cnt,
                "train_acc": float(metrics["correct"]) / cnt,
                "local_steps": steps}
            if freq > 0 and (r % freq == 0 or r == rounds - 1):
                rec.update(self.evaluate())
                rec["eval_batches"] = n_test_batches
                logger.info("round %d: test_acc=%.4f", r, rec["test_acc"])
            rec["round_time_s"] = time.time() - t_r
            self.history.append(rec)
        wall = time.time() - t0
        last_eval = next((h for h in reversed(self.history)
                          if "test_acc" in h), None)
        if last_eval is None:
            last_eval = ({"test_acc": None} if freq <= 0
                         else self.evaluate())
        return {"params": self.params, "history": self.history,
                "wall_time_s": wall, "final_test_acc": last_eval["test_acc"],
                "final_test_loss": last_eval.get("test_loss"),
                "rounds": rounds}
