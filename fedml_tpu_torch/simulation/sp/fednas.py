"""FedNAS, federated DARTS-style architecture search (counterpart of
``fedml_tpu/simulation/sp/fednas.py``, ``federated_optimizer: FedNAS``).

Every client holds the supernet: each cell is a ``softmax(alpha)``-
weighted mix of all its candidate ops (linear, relu-linear, a bias-free
projection, zero), computed densely. A client's epoch alternates over its
padded batches: even batches step the weights (SGD, momentum 0.9), odd
batches the architecture parameters alpha (Adam at ``nas_alpha_lr``).
Both gradients come from one backward on every batch; the optimizer that
is not stepping keeps its state, so Adam's count advances on odd batches
only. The loss a batch reports is taken after its step. The server
averages the weights **and** the alphas by the clients' sample counts;
:meth:`derive_architecture` takes each cell's argmax.

The cells' layers keep flax's names and layouts (``cell{i}.op_linear``
/ ``op_relu`` / ``op_proj``: a ``kernel`` ``[in, out]`` and a ``bias``),
so a JAX simulator's ``params`` cross unchanged through
:func:`fedml_tpu_torch.interop.flax_to_state_dict`; only the head is a
``Dense_0`` ``torch.nn.Linear``. Initial parameters come from a
``torch.Generator`` seeded by the init key of ``split(PRNGKey(seed))``,
or from ``init_params={"params": state dict, "alphas": [cells, 4]}``.
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
from ...core.collectives import average_trees
from ...model.cv.resnet import init_dense_, lecun_normal_
from .split_nn import key_generator, to_device_params

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]

OPS = ("linear", "relu_linear", "proj_skip", "zero")


class FlaxDense(nn.Module):
    """flax ``nn.Dense`` in flax's layout: ``kernel`` ``[in, out]`` and,
    with ``use_bias``, ``bias``."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class _MixedCell(nn.Module):
    """One DARTS edge: the ``softmax(alpha)``-weighted sum of the ops."""

    def __init__(self, cin: int, width: int):
        super().__init__()
        self.width = width
        self.op_linear = FlaxDense(cin, width)
        self.op_relu = FlaxDense(cin, width)
        self.op_proj = FlaxDense(cin, width, use_bias=False)

    def forward(self, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        outs = (self.op_linear(x), torch.relu(self.op_relu(x)),
                self.op_proj(x),
                torch.zeros(x.shape[:-1] + (self.width,), dtype=x.dtype,
                            device=x.device))
        w = torch.softmax(alpha, dim=-1)
        # flax's sum(): 0 + w0 o0 + w1 o1 + ...
        y = 0
        for i, o in enumerate(outs):
            y = y + w[i] * o
        return y


class _SuperNet(nn.Module):
    def __init__(self, in_features: int, num_classes: int, width: int = 64,
                 cells: int = 2):
        super().__init__()
        self.cells = cells
        cin = in_features
        for i in range(cells):
            self.add_module(f"cell{i}", _MixedCell(cin, width))
            cin = width
        self.Dense_0 = nn.Linear(width, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, FlaxDense):
                m.reset_parameters(generator)
        init_dense_(self.Dense_0, generator)

    def forward(self, x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for i in range(self.cells):
            h = getattr(self, f"cell{i}")(h, alphas[i])
        return self.Dense_0(h)


class FedNASSimulator:
    def __init__(self, args, fed_dataset, bundle=None, optimizer=None,
                 spec=None, device: torch.device = None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.device = torch.device(device)
        self.cells = int(getattr(args, "nas_cells", 2) or 2)
        in_features = int(np.prod(fed_dataset.train.x.shape[3:]))
        self.net = _SuperNet(in_features, fed_dataset.num_classes,
                             width=int(getattr(args, "nas_width", 64) or 64),
                             cells=self.cells)
        if init_params is None:
            kinit = prng.split(prng.PRNGKey(
                int(getattr(args, "random_seed", 0))))[0]
            self.net.reset_parameters(key_generator(kinit))
            self.params = {k: v.detach().clone().to(self.device)
                           for k, v in self.net.state_dict().items()}
            self.alphas = torch.zeros((self.cells, len(OPS)),
                                      device=self.device)
        else:
            self.params = to_device_params(init_params["params"],
                                           self.device)
            self.alphas = to_device_params(
                {"a": init_params["alphas"]}, self.device)["a"]
        self.net.to(self.device)
        self.lr = float(getattr(args, "learning_rate", 0.05))
        self.alpha_lr = float(getattr(args, "nas_alpha_lr", 3e-2) or 3e-2)
        self.train = fed_dataset.train.to(self.device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fed_dataset.test.items()}
        self.history: List[Dict[str, Any]] = []

    def _loss(self, params, alphas, x, y, mask):
        logits = functional_call(self.net, params, (x, alphas))
        ce = F.cross_entropy(logits, y.long(), reduction="none")
        m = mask.to(ce.dtype)
        loss = (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
        correct = ((logits.argmax(-1) == y.long()) * m).sum()
        return loss, correct

    def _client_round(self, cdata):
        """The alternating bilevel epoch from the global weights and
        alphas; returns ``(params, alphas, mean loss)``."""
        wopt = InnerOptimizer("sgd", self.lr, momentum=0.9)
        aopt = InnerOptimizer("adam", self.alpha_lr)
        params = {k: v.detach().clone() for k, v in self.params.items()}
        arch = {"alphas": self.alphas.detach().clone()}
        wstate, astate = wopt.init(params), aopt.init(arch)
        losses = []
        for i in range(cdata.x.shape[0]):
            x, y, mask = cdata.x[i], cdata.y[i], cdata.mask[i]
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            a = arch["alphas"].detach().requires_grad_()
            loss, _ = self._loss(leaves, a, x, y, mask)
            grads = torch.autograd.grad(loss, list(leaves.values()) + [a])
            if i % 2 == 0:
                wopt.step_(params, dict(zip(leaves, grads[:-1])), wstate)
            else:
                aopt.step_(arch, {"alphas": grads[-1]}, astate)
            with torch.no_grad():
                losses.append(self._loss(params, arch["alphas"], x, y,
                                         mask)[0])
        return params, arch["alphas"], torch.stack(losses).mean()

    def derive_architecture(self) -> List[str]:
        """Each cell's argmax over its alpha (the reference genotype)."""
        a = self.alphas.detach().cpu().numpy()
        return [OPS[int(np.argmax(a[i]))] for i in range(self.cells)]

    @torch.no_grad()
    def _evaluate(self) -> float:
        correct = total = 0.0
        for i in range(self.test["x"].shape[0]):
            _, c = self._loss(self.params, self.alphas, self.test["x"][i],
                              self.test["y"][i], self.test["mask"][i])
            correct += float(c)
            total += float(self.test["mask"][i].sum())
        return correct / max(total, 1.0)

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        rounds = int(comm_round if comm_round is not None
                     else self.args.comm_round)
        n_per_round = int(getattr(self.args, "client_num_per_round",
                                  self.fed.num_clients))
        t0 = time.time()
        for r in range(rounds):
            rs = np.random.RandomState(100 + r)
            sampled = rs.choice(self.fed.num_clients,
                                min(n_per_round, self.fed.num_clients),
                                replace=False)
            ps, als, weights, losses = [], [], [], []
            for cid in sampled:
                cdata = self.train.client(int(cid))
                p, a, loss = self._client_round(cdata)
                ps.append(p)
                als.append(a)
                weights.append(float(cdata.num_samples))
                losses.append(float(loss))
            w = torch.tensor(weights, dtype=torch.float32,
                             device=self.device)
            self.params = average_trees(ps, w)
            self.alphas = average_trees([{"a": a} for a in als], w)["a"]
            rec = {"round": r, "train_loss": float(np.mean(losses)),
                   "test_acc": self._evaluate(),
                   "architecture": self.derive_architecture()}
            logger.info("fednas round %d: %s", r, rec)
            self.history.append(rec)
        return {"params": self.params, "alphas": self.alphas,
                "architecture": self.derive_architecture(),
                "history": self.history,
                "final_test_acc": self.history[-1]["test_acc"],
                "wall_time_s": time.time() - t0, "rounds": rounds}
