"""Classical vertical FL (counterpart of
``fedml_tpu/simulation/sp/vertical_fl.py``, ``federated_optimizer:
classical_vertical`` / ``vertical_fl`` / ``vfl``): parties hold disjoint
feature slices of the same samples; their logit contributions are summed,
and each party updates only its own net.

All clients' data is pooled into one logical dataset and its flattened
features are split contiguously among ``party_num`` parties. A round runs
``N // batch_size`` steps over a ``RandomState(seed)`` permutation (one
draw per round), one plain SGD step on every party per batch. Party ``k``
draws its init from a ``torch.Generator`` seeded by key ``k`` of
``split(PRNGKey(seed), party_num + 1)``, as the JAX package splits them.
The message-passing form is :mod:`fedml_tpu_torch.cross_silo.vertical`.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ... import prng
from .split_nn import init_module, masked_ce, sgd_, to_device_params

logger = logging.getLogger(__name__)


class _PartyNet(nn.Module):
    """One party's net: its features -> Dense(32) -> ReLU -> Dense(classes),
    a logit contribution."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 32):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def pool_train(fed) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All clients' train data pooled: ``[N, feat]`` features, labels,
    mask."""
    x = np.asarray(fed.train.x)
    y = np.asarray(fed.train.y)
    m = np.asarray(fed.train.mask)
    x = x.reshape((-1,) + x.shape[3:])
    feat = int(np.prod(x.shape[1:]))
    return x.reshape(x.shape[0], feat), y.reshape(-1), m.reshape(-1)


def pool_test(fed, feat: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    tx = np.asarray(fed.test["x"])
    ty = np.asarray(fed.test["y"])
    tm = np.asarray(fed.test["mask"])
    tx = tx.reshape((-1,) + tx.shape[2:]).reshape(-1, feat)
    return tx, ty.reshape(-1), tm.reshape(-1)


def party_slices(feat: int, party_num: int) -> List[Tuple[int, int]]:
    """The contiguous feature split."""
    splits = np.linspace(0, feat, party_num + 1).astype(int)
    return [(int(splits[i]), int(splits[i + 1]))
            for i in range(party_num)]


def party_init(args, k: int, party_num: int, net: _PartyNet, device,
               init_params: Optional[Sequence[Dict[str, Any]]] = None):
    """Party ``k``'s parameters: ``init_params[k]``, else drawn from key
    ``k`` of ``split(PRNGKey(seed), party_num + 1)``."""
    if init_params is not None:
        net.to(device)
        return to_device_params(init_params[k], device)
    keys = prng.split(prng.PRNGKey(int(getattr(args, "random_seed", 0))),
                      party_num + 1)
    return init_module(net, keys[k], device)


def accuracy_counts(logits: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[float, float]:
    m = mask.float()
    correct = ((logits.argmax(-1) == y.long()) * m).sum()
    return float(correct), float(m.sum())


class VerticalFLSimulator:
    """``party_num`` parties; features split contiguously among them."""

    def __init__(self, args, fed_dataset, bundle=None, optimizer=None,
                 spec=None, device: torch.device = None,
                 init_params: Optional[Sequence[Dict[str, Any]]] = None):
        self.args = args
        self.fed = fed_dataset
        self.device = torch.device(device)
        self.party_num = int(getattr(args, "party_num", 2) or 2)
        self.lr = float(args.learning_rate)
        x, y, m = pool_train(fed_dataset)
        feat = x.shape[1]
        self.slices = party_slices(feat, self.party_num)
        dev = self.device
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        self.y = torch.from_numpy(y).to(dev)
        self.mask = torch.from_numpy(m).to(dev)
        self.nets = [_PartyNet(e - s, fed_dataset.num_classes)
                     for s, e in self.slices]
        self.party_params = [
            party_init(args, k, self.party_num, net, dev, init_params)
            for k, net in enumerate(self.nets)]
        tx, ty, tm = pool_test(fed_dataset, feat)
        self.test_x = torch.from_numpy(np.ascontiguousarray(tx)).to(dev)
        self.test_y = torch.from_numpy(ty).to(dev)
        self.test_mask = torch.from_numpy(tm).to(dev)
        self.batch_size = int(args.batch_size)
        self.history: List[Dict[str, Any]] = []

    def _logits(self, party_params, x: torch.Tensor) -> torch.Tensor:
        total = None
        for net, p, (s, e) in zip(self.nets, party_params, self.slices):
            contrib = functional_call(net, p, (x[:, s:e],))  # what crosses
            total = contrib if total is None else total + contrib
        return total

    def _step(self, idx: torch.Tensor) -> None:
        leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
                  for p in self.party_params]
        logits = self._logits(leaves, self.x[idx])
        loss, _, _ = masked_ce(logits, self.y[idx], self.mask[idx])
        grads = torch.autograd.grad(
            loss, [v for p in leaves for v in p.values()])
        off = 0
        for p in self.party_params:
            sgd_(p, grads[off:off + len(p)], self.lr)
            off += len(p)

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        rounds = comm_round if comm_round is not None else int(args.comm_round)
        n = self.x.shape[0]
        bs = self.batch_size
        steps = max(n // bs, 1)
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        t0 = time.time()
        rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))
        for round_idx in range(rounds):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for s in range(steps):
                self._step(perm[s * bs:(s + 1) * bs])
            rec: Dict[str, Any] = {"round": round_idx}
            if round_idx % freq == 0 or round_idx == rounds - 1:
                with torch.no_grad():
                    correct, count = accuracy_counts(
                        self._logits(self.party_params, self.test_x),
                        self.test_y, self.test_mask)
                rec["test_acc"] = correct / max(count, 1.0)
                logger.info("vfl round %d: acc=%.4f", round_idx,
                            rec["test_acc"])
            self.history.append(rec)
        last_eval = next(r for r in reversed(self.history) if "test_acc" in r)
        return {"params": self.party_params, "history": self.history,
                "wall_time_s": time.time() - t0,
                "final_test_acc": last_eval["test_acc"], "rounds": rounds}
