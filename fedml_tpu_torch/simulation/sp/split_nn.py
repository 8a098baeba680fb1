"""Split learning (SplitNN) (counterpart of
``fedml_tpu/simulation/sp/split_nn.py``, ``federated_optimizer:
split_nn``): the model is cut at a layer; each client owns a bottom
(feature extractor), the server owns the top (head).

Each round trains the clients round-robin: every client takes its local
epochs over its batches in order against the shared head, one plain SGD
step on both parts per batch (an all-padding batch leaves both
unchanged). The accuracy is client 0's bottom under the head. The
message-passing form is :mod:`fedml_tpu_torch.cross_silo.split_learning`.

The parts are ``torch.nn`` modules named as flax names its ``nn.Dense``
scopes (``_Top``'s ``Dense_0`` is the output layer: flax builds it
first), so :func:`fedml_tpu_torch.interop.split_params_from_flax` carries
the JAX package's parameters across. Each part draws its init from a
``torch.Generator`` seeded by its own key of ``split(PRNGKey(seed), 3)``
(bottom, top), as the JAX package splits them.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ... import prng
from ...core.algframe.local_training import batch_real_of
from ...model.cv.resnet import init_dense_

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


class _Bottom(nn.Module):
    """Flatten -> Dense(hidden) -> ReLU: the activation that crosses."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class _Top(nn.Module):
    """Dense(64) -> ReLU -> Dense(num_classes)."""

    def __init__(self, hidden: int, num_classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(64, num_classes)
        self.Dense_1 = nn.Linear(hidden, 64)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(torch.relu(self.Dense_1(h)))


def key_generator(key: np.ndarray) -> torch.Generator:
    """A ``torch.Generator`` seeded by a threefry key's two words."""
    k = np.asarray(key, np.uint32)
    return torch.Generator().manual_seed((int(k[0]) << 32) | int(k[1]))


def init_module(module: nn.Module, key: np.ndarray,
                device: torch.device) -> Params:
    """flax ``nn.Dense``'s initialisers on every layer, drawn from
    ``key``'s generator in the layers' name order."""
    gen = key_generator(key)
    for name in sorted(n for n, _ in module.named_children()):
        init_dense_(getattr(module, name), gen)
    module.to(device)
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def split_keys(seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``split(PRNGKey(seed), 3)``: the bottom's, the top's, the rest."""
    kb, kt, rest = prng.split(prng.PRNGKey(int(seed)), 3)
    return kb, kt, rest


def to_device_params(params: Dict[str, Any], device) -> Params:
    """``init_params`` (tensors or arrays) as float32 tensors on
    ``device``."""
    return {k: (v.detach().clone() if torch.is_tensor(v) else
                torch.from_numpy(np.array(v, np.float32, copy=True)))
            .float().to(device) for k, v in params.items()}


def masked_ce(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """The masked mean cross-entropy and its ``(correct, count)``."""
    labels = y.long()
    per_ex = F.cross_entropy(logits, labels, reduction="none")
    m = mask.to(per_ex.dtype)
    loss = (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)
    correct = ((logits.argmax(-1) == labels) * m).sum()
    return loss, correct, m.sum()


def sgd_(params: Params, grads, lr: float) -> None:
    """``w <- w - lr * g`` in place."""
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(lr * g)


class SplitNNSimulator:
    """Round-robin split training: each round, every client takes its
    local epochs against the shared server head."""

    def __init__(self, args, fed_dataset, bundle=None, optimizer=None,
                 spec=None, device: torch.device = None,
                 init_params: Optional[Dict[str, Params]] = None):
        self.args = args
        self.fed = fed_dataset
        self.device = torch.device(device)
        hidden = int(getattr(args, "splitnn_hidden", 128) or 128)
        x = fed_dataset.train.x
        in_features = int(np.prod(x.shape[3:]))
        self.bottom = _Bottom(in_features, hidden)
        self.top = _Top(hidden, fed_dataset.num_classes)
        kb, kt, _ = split_keys(getattr(args, "random_seed", 0))
        if init_params is None:
            h0 = init_module(self.bottom, kb, self.device)
            self.top_params = init_module(self.top, kt, self.device)
        else:
            h0 = to_device_params(init_params["bottom"], self.device)
            self.top_params = to_device_params(init_params["top"],
                                               self.device)
        self.client_bottoms: List[Params] = [
            {k: v.clone() for k, v in h0.items()}
            for _ in range(fed_dataset.num_clients)]
        self.bottom.to(self.device)
        self.top.to(self.device)
        self.lr = float(args.learning_rate)
        self.train = fed_dataset.train.to(self.device)
        self.batch_real = batch_real_of(fed_dataset.train.mask)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fed_dataset.test.items()}
        self.history: List[Dict[str, Any]] = []

    def _step(self, bp: Params, tp: Params, cid: int) -> None:
        """One epoch of client ``cid`` in place."""
        cdata = self.train.client(cid)
        for b in np.flatnonzero(self.batch_real[cid]):
            leaves_b = {k: v.detach().requires_grad_() for k, v in bp.items()}
            leaves_t = {k: v.detach().requires_grad_() for k, v in tp.items()}
            h = functional_call(self.bottom, leaves_b, (cdata.x[b],))
            logits = functional_call(self.top, leaves_t, (h,))
            loss, _, _ = masked_ce(logits, cdata.y[b], cdata.mask[b])
            grads = torch.autograd.grad(
                loss, list(leaves_b.values()) + list(leaves_t.values()))
            sgd_(bp, grads[:len(bp)], self.lr)
            sgd_(tp, grads[len(bp):], self.lr)

    @torch.no_grad()
    def _eval(self, bp: Params, tp: Params) -> Tuple[float, float]:
        correct = count = 0.0
        for i in range(self.test["x"].shape[0]):
            h = functional_call(self.bottom, bp, (self.test["x"][i],))
            logits = functional_call(self.top, tp, (h,))
            _, c, n = masked_ce(logits, self.test["y"][i],
                                self.test["mask"][i])
            correct += float(c)
            count += float(n)
        return correct, count

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(args.comm_round)
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        t0 = time.time()
        for round_idx in range(rounds):
            for cid in range(self.fed.num_clients):
                for _ in range(int(args.epochs)):
                    self._step(self.client_bottoms[cid], self.top_params,
                               cid)
            rec: Dict[str, Any] = {"round": round_idx}
            if round_idx % freq == 0 or round_idx == rounds - 1:
                # client 0's bottom (any single pair is a valid split model)
                correct, count = self._eval(self.client_bottoms[0],
                                            self.top_params)
                rec["test_acc"] = correct / max(count, 1.0)
                logger.info("splitnn round %d: acc=%.4f", round_idx,
                            rec["test_acc"])
            self.history.append(rec)
        last_eval = next(r for r in reversed(self.history) if "test_acc" in r)
        return {"params": {"bottom": self.client_bottoms[0],
                           "top": self.top_params},
                "history": self.history, "wall_time_s": time.time() - t0,
                "final_test_acc": last_eval["test_acc"], "rounds": rounds}
