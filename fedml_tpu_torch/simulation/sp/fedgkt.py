"""FedGKT, group knowledge transfer (counterpart of
``fedml_tpu/simulation/sp/fedgkt.py``, ``federated_optimizer: FedGKT``).

Each client trains a small edge net (a feature extractor and an
auxiliary classifier) on its batches with cross-entropy plus, from round
1 on, KL distillation from the server's logits; then ships the features
its net extracts, its logits and the labels. The server trains a larger
head on the concatenated feature stream with CE plus KL distillation from
the client logits, and sends its own per-batch logits back. No model is
exchanged: the payload is the stacked feature / logit tensors.

Every epoch takes one SGD step (momentum 0.9, re-initialised every epoch,
``gkt_lr``) per padded batch, all-padding batches included (their masked
loss is 0; the momentum still moves), as the JAX scan does. The accuracy
is client 0's extractor under the head.

Initial parameters: each client's edge net from a ``torch.Generator``
seeded by ``fold_in(ke, c)``, the head by ``kh`` (``ke, kh, rng =
split(PRNGKey(seed), 3)``, the JAX package's keys; flax's distribution,
not its values). ``init_params={"edge": [state dict per client] or one
state dict for all, "head": state dict}`` starts from given ones
(:func:`fedml_tpu_torch.interop.variables_to_state_dict` brings the JAX
simulator's ``edge_params`` / ``head_params``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ... import prng
from ...core.algframe.client_trainer import InnerOptimizer
from ...model.cv.cnn import FlaxInit
from .split_nn import init_module, split_keys, to_device_params

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


class _EdgeNet(FlaxInit):
    """Flatten -> Dense(feat_dim) -> relu (the features h) -> Dense
    (classes); returns ``(h, logits)``."""

    def __init__(self, in_features: int, feat_dim: int, num_classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, feat_dim)
        self.Dense_1 = nn.Linear(feat_dim, num_classes)

    def forward(self, x: torch.Tensor):
        h = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return h, self.Dense_1(h)


class _ServerHead(FlaxInit):
    """Dense(hidden) -> relu -> Dense(hidden) -> relu -> Dense(classes)."""

    def __init__(self, feat_dim: int, num_classes: int, hidden: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(feat_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_classes)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.Dense_0(h))
        return self.Dense_2(torch.relu(self.Dense_1(h)))


def masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(v.dtype)
    return (v * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_ce(logits, y, mask):
    return masked_mean(F.cross_entropy(logits, y.long(), reduction="none"),
                       mask)


def masked_kl(student, teacher, mask, temp: float):
    """``KL(softmax(teacher / T) || softmax(student / T))`` per sample
    with ``log(max(t, 1e-9))``, masked mean."""
    t = torch.softmax(teacher / temp, dim=-1)
    s = torch.log_softmax(student / temp, dim=-1)
    kl = (t * (torch.log(torch.clamp(t, min=1e-9)) - s)).sum(-1)
    return masked_mean(kl, mask)


def _leaves(params: Params) -> Params:
    return {k: v.detach().requires_grad_() for k, v in params.items()}


class FedGKTSimulator:
    def __init__(self, args, fed_dataset, bundle=None, optimizer=None,
                 spec=None, device: torch.device = None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.device = torch.device(device)
        self.temp = float(getattr(args, "gkt_temperature", 3.0) or 3.0)
        self.alpha = float(getattr(args, "gkt_kd_alpha", 1.0) or 1.0)
        self.feat_dim = int(getattr(args, "gkt_feat_dim", 64) or 64)
        self.lr = float(getattr(args, "gkt_lr", 0.01) or 0.01)
        k = fed_dataset.num_classes
        in_features = int(np.prod(fed_dataset.train.x.shape[3:]))
        self.edge = _EdgeNet(in_features, self.feat_dim, k)
        self.head = _ServerHead(self.feat_dim, k)
        n = fed_dataset.num_clients
        if init_params is None:
            ke, kh, _ = split_keys(getattr(args, "random_seed", 0))
            self.edge_params: List[Params] = [
                init_module(self.edge, prng.fold_in(ke, c), self.device)
                for c in range(n)]
            self.head_params = init_module(self.head, kh, self.device)
        else:
            edge = init_params["edge"]
            edge = edge if isinstance(edge, (list, tuple)) else [edge] * n
            self.edge_params = [to_device_params(e, self.device)
                                for e in edge]
            self.head_params = to_device_params(init_params["head"],
                                                self.device)
        self.edge.to(self.device)
        self.head.to(self.device)
        self.train = fed_dataset.train.to(self.device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fed_dataset.test.items()}
        self.history: List[Dict[str, Any]] = []

    def _sgd(self) -> InnerOptimizer:
        return InnerOptimizer("sgd", self.lr, momentum=0.9)

    # --- client side ---------------------------------------------------------
    def _client_epoch(self, params: Params, cdata, server_logits, use_kd):
        """One SGD-momentum step per padded batch; returns the new params
        and the mean loss (a tensor)."""
        opt = self._sgd()
        params = {k: v.detach().clone() for k, v in params.items()}
        state = opt.init(params)
        losses = []
        for b in range(cdata.x.shape[0]):
            leaves = _leaves(params)
            _, logits = functional_call(self.edge, leaves, (cdata.x[b],))
            ce = masked_ce(logits, cdata.y[b], cdata.mask[b])
            kd = masked_kl(logits, server_logits[b], cdata.mask[b],
                           self.temp)
            loss = ce + self.alpha * use_kd * kd
            grads = torch.autograd.grad(loss, list(leaves.values()))
            opt.step_(params, dict(zip(leaves, grads)), state)
            losses.append(loss.detach())
        return params, torch.stack(losses).mean()

    @torch.no_grad()
    def _extract(self, params: Params, cdata):
        out = [functional_call(self.edge, params, (cdata.x[b],))
               for b in range(cdata.x.shape[0])]
        return (torch.stack([h for h, _ in out]),
                torch.stack([lg for _, lg in out]))

    # --- server side ---------------------------------------------------------
    def _server_epoch(self, feats, logits, ys, masks):
        opt = self._sgd()
        params = {k: v.detach().clone() for k, v in self.head_params.items()}
        state = opt.init(params)
        losses = []
        for b in range(feats.shape[0]):
            leaves = _leaves(params)
            slog = functional_call(self.head, leaves, (feats[b],))
            loss = (masked_ce(slog, ys[b], masks[b])
                    + self.alpha * masked_kl(slog, logits[b], masks[b],
                                             self.temp))
            grads = torch.autograd.grad(loss, list(leaves.values()))
            opt.step_(params, dict(zip(leaves, grads)), state)
            losses.append(loss.detach())
        with torch.no_grad():
            server_logits = torch.stack([
                functional_call(self.head, params, (feats[b],))
                for b in range(feats.shape[0])])
        return params, server_logits, torch.stack(losses).mean()

    @torch.no_grad()
    def _evaluate(self) -> float:
        correct = total = 0.0
        p = self.edge_params[0]
        for i in range(self.test["x"].shape[0]):
            h, _ = functional_call(self.edge, p, (self.test["x"][i],))
            slog = functional_call(self.head, self.head_params, (h,))
            m = self.test["mask"][i]
            correct += float(((slog.argmax(-1) == self.test["y"][i].long())
                              * m).sum())
            total += float(m.sum())
        return correct / max(total, 1.0)

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        rounds = int(comm_round if comm_round is not None
                     else self.args.comm_round)
        n_clients = self.fed.num_clients
        t0 = time.time()
        nb, bs = self.train.x.shape[1], self.train.x.shape[2]
        k = self.fed.num_classes
        # each client's cached server logits (zeros: no KD in round 0)
        server_logits = [torch.zeros((nb, bs, k), device=self.device)
                         for _ in range(n_clients)]
        for r in range(rounds):
            use_kd = 0.0 if r == 0 else 1.0
            feats, logits, ys, masks, losses = [], [], [], [], []
            for c in range(n_clients):
                cdata = self.train.client(c)
                self.edge_params[c], loss = self._client_epoch(
                    self.edge_params[c], cdata, server_logits[c], use_kd)
                losses.append(float(loss))
                f, lg = self._extract(self.edge_params[c], cdata)
                feats.append(f)
                logits.append(lg)
                ys.append(cdata.y)
                masks.append(cdata.mask)
            # the server trains on the concatenated feature stream
            self.head_params, slog, sloss = self._server_epoch(
                torch.cat(feats), torch.cat(logits), torch.cat(ys),
                torch.cat(masks))
            # and routes its logits back per client
            server_logits = list(torch.split(slog, [f.shape[0]
                                                    for f in feats]))
            rec = {"round": r, "client_loss": float(np.mean(losses)),
                   "server_loss": float(sloss), "test_acc": self._evaluate()}
            logger.info("fedgkt round %d: %s", r, rec)
            self.history.append(rec)
        return {"params": self.head_params,
                "edge_params": self.edge_params,
                "history": self.history,
                "final_test_acc": self.history[-1]["test_acc"],
                "wall_time_s": time.time() - t0, "rounds": rounds}
