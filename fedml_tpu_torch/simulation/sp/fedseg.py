"""FedSeg, federated semantic segmentation (counterpart of
``fedml_tpu/simulation/sp/fedseg.py``, ``federated_optimizer: FedSeg``,
and any dataset of ``task="segmentation"``).

FedAvg of a compact conv encoder-decoder (:class:`SegNet`) trained per
client with pixel-wise cross-entropy: each sampled client (the round's
``RandomState(200 + r)`` draw) takes one SGD step (momentum 0.9,
re-initialised per round) per padded batch, all-padding batches included
as in the JAX scan; the server averages the models by sample count. The
score is the mean IoU (:func:`miou`) averaged over the test batches.

``SegNet`` keeps flax's names and layouts (``Conv_k`` / ``ConvTranspose_k``
HWIO kernels with biases). flax's ``ConvTranspose`` (strides 2, ``SAME``,
the kernel not transposed) is a transposed convolution whose kernel is
*not* flipped; ``torch``'s is the adjoint of a convolution, which flips
it. So the module flips the stored kernel in both spatial axes, runs
``conv_transpose2d(stride=2, padding=0)`` and keeps the first ``2H x 2W``
outputs. Initial parameters come from a ``torch.Generator`` seeded by the
init key of ``split(PRNGKey(seed))``, or from ``init_params`` (a state
dict).
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
from ...model.cv.cnn import Conv, FlaxInit
from ...model.cv.resnet import lecun_normal_
from .split_nn import key_generator, to_device_params

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(cout, (k, k), strides=(s, s))``: ``SAME``
    padding, an HWIO ``kernel`` ``[k, k, cin, cout]`` and a bias."""

    def __init__(self, cin: int, cout: int, ksize: int = 3, strides: int = 2):
        super().__init__()
        self.strides = strides
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, kh * kw * cin, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.strides
        h, w = int(x.shape[1]) * s, int(x.shape[2]) * s
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        kern = self.kernel.to(dt).flip(0, 1).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), kern,
                               self.bias.to(dt), stride=s)
        return y[:, :, :h, :w].permute(0, 2, 3, 1)


class SegNet(FlaxInit):
    """2x down, a bottleneck, 2x up with skips, a per-pixel classifier."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 width: int = 16):
        super().__init__()
        w = width
        self.Conv_0 = Conv(in_channels, w, 3)
        self.Conv_1 = Conv(w, w * 2, 3, strides=2)
        self.Conv_2 = Conv(w * 2, w * 4, 3, strides=2)
        self.Conv_3 = Conv(w * 4, w * 4, 3)
        self.ConvTranspose_0 = ConvTranspose(w * 4, w * 2)
        self.ConvTranspose_1 = ConvTranspose(w * 4, w)
        self.Conv_4 = Conv(w * 2, num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = torch.relu(self.Conv_0(x))
        d1 = torch.relu(self.Conv_1(h1))
        d2 = torch.relu(self.Conv_2(d1))
        b = torch.relu(self.Conv_3(d2))
        u1 = torch.cat([torch.relu(self.ConvTranspose_0(b)), d1], dim=-1)
        u2 = torch.cat([torch.relu(self.ConvTranspose_1(u1)), h1], dim=-1)
        return self.Conv_4(u2)


def pixel_ce(logits, y, mask):
    """Masked mean of the per-pixel cross-entropy (a sample's mask covers
    all its pixels)."""
    ce = F.cross_entropy(logits.permute(0, 3, 1, 2), y.long(),
                         reduction="none")
    m = mask.to(ce.dtype)[:, None, None] * torch.ones_like(ce)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def miou(logits, y, mask, num_classes: int) -> torch.Tensor:
    """Mean intersection-over-union over the classes (a class absent from
    both prediction and label scores 1), over the real samples' pixels."""
    pred = logits.argmax(-1)
    m = (mask[:, None, None] * torch.ones_like(y)).bool()
    ious = []
    for c in range(num_classes):
        pc, yc = (pred == c) & m, (y == c) & m
        inter, union = (pc & yc).sum(), (pc | yc).sum()
        ious.append(torch.where(union > 0,
                                inter / torch.clamp(union, min=1),
                                torch.ones((), device=logits.device)))
    return torch.stack(ious).mean()


class FedSegSimulator:
    def __init__(self, args, fed_dataset, bundle=None, optimizer=None,
                 spec=None, device: torch.device = None,
                 init_params: Optional[Dict[str, Any]] = None):
        self.args = args
        self.fed = fed_dataset
        self.device = torch.device(device)
        self.net = SegNet(fed_dataset.num_classes,
                          in_channels=int(fed_dataset.train.x.shape[-1]),
                          width=int(getattr(args, "seg_width", 16) or 16))
        if init_params is None:
            kinit = prng.split(prng.PRNGKey(
                int(getattr(args, "random_seed", 0))))[0]
            self.net.reset_parameters(key_generator(kinit))
            self.params = {k: v.detach().clone().to(self.device)
                           for k, v in self.net.state_dict().items()}
        else:
            self.params = to_device_params(init_params, self.device)
        self.net.to(self.device)
        self.lr = float(getattr(args, "learning_rate", 0.05))
        self.train = fed_dataset.train.to(self.device)
        self.test = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fed_dataset.test.items()}
        self.history: List[Dict[str, Any]] = []

    def _client_round(self, cdata):
        opt = InnerOptimizer("sgd", self.lr, momentum=0.9)
        params = {k: v.detach().clone() for k, v in self.params.items()}
        state = opt.init(params)
        losses = []
        for b in range(cdata.x.shape[0]):
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            loss = pixel_ce(functional_call(self.net, leaves, (cdata.x[b],)),
                            cdata.y[b], cdata.mask[b])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            opt.step_(params, dict(zip(leaves, grads)), state)
            losses.append(loss.detach())
        return params, torch.stack(losses).mean()

    @torch.no_grad()
    def _evaluate(self) -> float:
        vals = [float(miou(functional_call(self.net, self.params,
                                           (self.test["x"][i],)),
                           self.test["y"][i], self.test["mask"][i],
                           self.fed.num_classes))
                for i in range(self.test["x"].shape[0])]
        return float(np.mean(vals))

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        rounds = int(comm_round if comm_round is not None
                     else self.args.comm_round)
        n_per_round = int(getattr(self.args, "client_num_per_round",
                                  self.fed.num_clients))
        t0 = time.time()
        for r in range(rounds):
            rs = np.random.RandomState(200 + r)
            sampled = rs.choice(self.fed.num_clients,
                                min(n_per_round, self.fed.num_clients),
                                replace=False)
            ps, weights, losses = [], [], []
            for cid in sampled:
                cdata = self.train.client(int(cid))
                p, loss = self._client_round(cdata)
                ps.append(p)
                weights.append(float(cdata.num_samples))
                losses.append(float(loss))
            w = torch.tensor(weights, dtype=torch.float32,
                             device=self.device)
            self.params = average_trees(ps, w)
            score = self._evaluate()
            rec = {"round": r, "train_loss": float(np.mean(losses)),
                   "miou": score, "test_acc": score}
            logger.info("fedseg round %d: %s", r, rec)
            self.history.append(rec)
        return {"params": self.params, "history": self.history,
                "final_miou": self.history[-1]["miou"],
                "final_test_acc": self.history[-1]["miou"],
                "wall_time_s": time.time() - t0, "rounds": rounds}
