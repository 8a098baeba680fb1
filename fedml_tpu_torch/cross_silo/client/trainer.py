"""Silo-local trainer for the cross-silo runtime (counterpart of
``fedml_tpu/cross_silo/client/trainer.py``).

One silo's local epochs from the received global params, with the
optimizer's inner step and transform, as the JAX package's jitted
``run_local_sgd`` runs them: the same key
(``fold_in(fold_in(split(PRNGKey(seed))[1], round), client)``), the same
batch order and the same step count (``work_scale``, the chaos straggler
knob, truncates it). The steps replay the optimizer's
:class:`~fedml_tpu_torch.core.algframe.local_training.StepProgram`: on a
card one CUDA graph per silo process, captured at the first round and
replayed per step (as the GPU engine's step is); on the CPU the same body
runs eagerly.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import GradProgram, batch_real_of
from ...core.algframe.types import ClientData, TrainHyper
from ..wire import params_to_vec, vec_to_params


class SiloTrainer:
    """Owns this silo's view of the federated dataset (each client's
    shard moves to the device at its first use) and its step programs."""

    def __init__(self, args, fed_dataset, bundle, spec, optimizer, device):
        self.args = args
        self.fed = fed_dataset
        self.bundle = bundle
        self.spec = spec
        self.opt = optimizer
        self.device = torch.device(device)
        seed = int(getattr(args, "random_seed", 0))
        # split(PRNGKey(seed)) = (init, local-training stream), as JAX
        self.rng = prng.split(prng.PRNGKey(seed))[1]
        # the parameter structure (its values are never trained: every
        # round starts from the received global)
        self.params_template = bundle.init(
            torch.Generator().manual_seed(seed), self.device)
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self._data: Dict[int, ClientData] = {}
        self._cdata: ClientData = None
        self.programs: Dict[Tuple, Any] = {}
        # one entry per local training: round, client, steps, host seconds
        self.log: List[Dict[str, Any]] = []

    # --- the engine's program protocol (optimizers/base.py) ----------------
    def step_program(self, hyper: TrainHyper):
        inner = self.opt.make_inner_opt(hyper)
        x = self._cdata.x
        key = ("step", tuple(x.shape[1:]), x.dtype, inner.key,
               self.opt.transform_key)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.opt.make_step_program(self.params_template, {},
                                              self._cdata, hyper)
            self.programs[key] = prog
        return prog

    def grad_program(self, cdata: ClientData) -> GradProgram:
        key = ("grad", tuple(cdata.x.shape[1:]), cdata.x.dtype)
        prog = self.programs.get(key)
        if prog is None:
            prog = GradProgram(self.spec, self.params_template, cdata)
            self.programs[key] = prog
        return prog

    def program_stats(self) -> Dict[str, Any]:
        """``captures``, ``warmup_steps``, ``replays``, ``capture_s``
        summed over this silo's programs."""
        progs = self.programs.values()
        return {k: sum(getattr(p, k) for p in progs)
                for k in ("captures", "warmup_steps", "replays",
                          "capture_s")}

    def _local_sgd(self, params, cdata: ClientData, key, hyper: TrainHyper,
                   batch_real):
        """The local steps: the optimizer's step program over this silo's
        programs. Returns ``(params, steps, metric sums)``."""
        return self.opt._local_sgd(params, {}, {}, cdata, key, hyper,
                                   batch_real, self)

    # --- flat-vector views (wire-efficient update path) ---------------------
    def params_to_vec(self, params) -> np.ndarray:
        """Host float32 vector of a params dict, in the JAX flat layout
        (both FL sides flatten the same structure)."""
        return params_to_vec(params)

    def vec_to_params(self, vec):
        return vec_to_params(vec, self.params_template)

    def _client(self, client_idx: int) -> ClientData:
        cd = self._data.get(client_idx)
        if cd is None:
            cd = self.fed.train.client(client_idx).to(self.device)
            self._data[client_idx] = cd
        return cd

    def train(self, params, client_idx: int, round_idx: int,
              work_scale: float = 1.0, key_index: int = None, key=None
              ) -> Tuple[dict, float, Dict[str, float]]:
        """``key_index`` (default ``client_idx``) is folded into the
        round's key: a gossip node folds in its rank. ``key`` (a prng
        key) replaces the round's key."""
        t0 = time.perf_counter()
        self._cdata = cdata = self._client(int(client_idx))
        hyper = TrainHyper(learning_rate=float(self.args.learning_rate),
                           epochs=int(self.args.epochs),
                           work_scale=float(work_scale))
        if key is None:
            key = prng.fold_in(prng.fold_in(self.rng, round_idx),
                               client_idx if key_index is None
                               else key_index)
        out, steps, metrics = self._local_sgd(
            params, cdata, key, hyper, self.batch_real[int(client_idx)])
        # the program's static tensors are overwritten by the next round
        new_params = {k: v.detach().clone() for k, v in out.items()}
        n = float(np.asarray(self.fed.train.num_samples)[int(client_idx)])
        cnt = max(float(metrics["count"]), 1.0)   # waits for the device
        self.log.append({"round": int(round_idx), "client": int(client_idx),
                         "steps": int(steps),
                         "train_s": time.perf_counter() - t0})
        return new_params, n, {"train_loss": float(metrics["loss_sum"]) / cnt,
                               "train_acc": float(metrics["correct"]) / cnt}
