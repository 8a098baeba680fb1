"""FedGAN, federated GAN training (counterpart of
``fedml_tpu/simulation/sp/fedgan.py``, ``federated_optimizer: FedGAN``,
or ``model: gan``, whose model hub entry is the (generator,
discriminator) bundle pair).

Each sampled client (``RandomState(r)``) trains the shared pair on its
batches: per padded batch one discriminator step (real samples masked,
fakes from ``z ~ N(0, 1)``) and then one generator step against the new
discriminator, both Adam with ``b1 = 0.5``, re-initialised per round. The
latent draws are the JAX package's: ``rng, kz1, kz2 = split(rng, 3)`` per
batch from the client's ``fold_in(fold_in(rng, r), cid)``, each ``z``
``normal(kz, (bs, latent))`` bit for bit (:mod:`fedml_tpu_torch.prng`,
drawn on the params' device). The server averages both nets by sample
count. ``disc_acc`` (:meth:`_disc_real_vs_fake_acc`) is how well the
discriminator tells 256 real test samples from 256 fakes: it tends to 0.5
as the generator wins; each evaluation takes its keys from, and advances,
the simulator's key, as in the JAX package.

The nets run in float32 through their modules, as the JAX simulator's
``module.apply`` does (the bundles' compute dtype is not applied).
Initial parameters come from ``torch.Generator`` s seeded by ``kg`` and
``kd`` of ``split(PRNGKey(seed), 3)``, or from ``init_params={"gen":
state dict, "disc": state dict}``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ... import prng
from ...core.algframe.client_trainer import InnerOptimizer
from ...core.collectives import average_trees
from .split_nn import key_generator, to_device_params

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax ``sigmoid_binary_cross_entropy``, averaged."""
    return (-targets * F.logsigmoid(logits)
            - (1.0 - targets) * F.logsigmoid(-logits)).mean()


class FedGANSimulator:
    """Clients are data shards; each trains the shared (G, D) locally; the
    server averages both."""

    def __init__(self, args, fed_dataset, bundles, optimizer=None,
                 spec=None, device: torch.device = None,
                 init_params: Optional[Dict[str, Any]] = None):
        if not isinstance(bundles, tuple) or len(bundles) != 2:
            raise ValueError("FedGAN needs the (generator, discriminator) "
                             "bundle pair (model='gan')")
        self.args = args
        self.fed = fed_dataset
        self.device = torch.device(device)
        self.gen, self.disc = (b.module for b in bundles)
        self.latent = int(getattr(args, "gan_latent_dim", 100) or 100)
        kg, kd, self.rng = prng.split(prng.PRNGKey(
            int(getattr(args, "random_seed", 0))), 3)
        self.img_dim = int(np.prod(fed_dataset.input_shape))
        if init_params is None:
            self.gen_params = self._init(self.gen, kg)
            self.disc_params = self._init(self.disc, kd)
        else:
            self.gen_params = to_device_params(init_params["gen"],
                                               self.device)
            self.disc_params = to_device_params(init_params["disc"],
                                                self.device)
        self.gen.to(self.device)
        self.disc.to(self.device)
        self.lr = float(getattr(args, "learning_rate", 2e-4))
        self.train = fed_dataset.train.to(self.device)
        self.test_x = torch.from_numpy(np.ascontiguousarray(
            fed_dataset.test["x"])).to(self.device)
        self.history: List[Dict[str, Any]] = []

    def _init(self, module, key) -> Params:
        module.to("cpu")
        module.reset_parameters(key_generator(key))
        return {k: v.detach().clone().to(self.device)
                for k, v in module.state_dict().items()}

    def _client_round(self, cdata, rng: np.ndarray):
        gopt = InnerOptimizer("adam", self.lr, b1=0.5)
        dopt = InnerOptimizer("adam", self.lr, b1=0.5)
        gp = {k: v.detach().clone() for k, v in self.gen_params.items()}
        dp = {k: v.detach().clone() for k, v in self.disc_params.items()}
        gs, ds = gopt.init(gp), dopt.init(dp)
        d_losses, g_losses = [], []
        for b in range(cdata.x.shape[0]):
            rng, kz1, kz2 = prng.split(rng, 3)
            bs = int(cdata.x.shape[1])
            x = cdata.x[b].reshape(bs, -1)
            m = cdata.mask[b].reshape(bs, 1).to(x.dtype)
            # the discriminator: real -> 1 (masked), fake -> 0
            z = prng.normal_t(kz1, (bs, self.latent), self.device)
            with torch.no_grad():
                fake = functional_call(self.gen, gp, (z,))
            leaves = {k: v.detach().requires_grad_() for k, v in dp.items()}
            real_logit = functional_call(self.disc, leaves, (x,))
            fake_logit = functional_call(self.disc, leaves, (fake,))
            d_loss = (_bce_logits(real_logit * m, m)
                      + _bce_logits(fake_logit, torch.zeros_like(fake_logit)))
            grads = torch.autograd.grad(d_loss, list(leaves.values()))
            dopt.step_(dp, dict(zip(leaves, grads)), ds)
            # the generator against the new discriminator
            z = prng.normal_t(kz2, (bs, self.latent), self.device)
            leaves = {k: v.detach().requires_grad_() for k, v in gp.items()}
            fake_logit = functional_call(
                self.disc, dp, (functional_call(self.gen, leaves, (z,)),))
            g_loss = _bce_logits(fake_logit, torch.ones_like(fake_logit))
            grads = torch.autograd.grad(g_loss, list(leaves.values()))
            gopt.step_(gp, dict(zip(leaves, grads)), gs)
            d_losses.append(d_loss.detach())
            g_losses.append(g_loss.detach())
        return gp, dp, {"d_loss": torch.stack(d_losses).mean(),
                        "g_loss": torch.stack(g_losses).mean()}

    @torch.no_grad()
    def _disc_real_vs_fake_acc(self, n: int = 256) -> float:
        """How well D separates real from generated samples: 0.5 * (share
        of real logits > 0 + share of fake logits <= 0)."""
        key1, _, self.rng = prng.split(self.rng, 3)
        z = prng.normal_t(key1, (n, self.latent), self.device)
        fake = functional_call(self.gen, self.gen_params, (z,))
        xr = self.test_x.reshape(-1, self.img_dim)[:n]
        rl = functional_call(self.disc, self.disc_params, (xr,))
        fl = functional_call(self.disc, self.disc_params, (fake,))
        acc = 0.5 * ((rl > 0).float().mean() + (fl <= 0).float().mean())
        return float(acc)

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        rounds = int(comm_round if comm_round is not None
                     else self.args.comm_round)
        n_per_round = int(getattr(self.args, "client_num_per_round",
                                  self.fed.num_clients))
        t0 = time.time()
        for r in range(rounds):
            rs = np.random.RandomState(r)
            sampled = rs.choice(self.fed.num_clients,
                                min(n_per_round, self.fed.num_clients),
                                replace=False)
            gps, dps, weights, d_losses, g_losses = [], [], [], [], []
            for cid in sampled:
                cdata = self.train.client(int(cid))
                key = prng.fold_in(prng.fold_in(self.rng, r), int(cid))
                gp, dp, losses = self._client_round(cdata, key)
                gps.append(gp)
                dps.append(dp)
                weights.append(float(cdata.num_samples))
                d_losses.append(float(losses["d_loss"]))
                g_losses.append(float(losses["g_loss"]))
            w = torch.tensor(weights, dtype=torch.float32,
                             device=self.device)
            self.gen_params = average_trees(gps, w)
            self.disc_params = average_trees(dps, w)
            rec = {"round": r, "d_loss": sum(d_losses) / len(d_losses),
                   "g_loss": sum(g_losses) / len(g_losses),
                   "disc_acc": self._disc_real_vs_fake_acc()}
            logger.info("fedgan round %d: %s", r, rec)
            self.history.append(rec)
        return {"gen_params": self.gen_params,
                "disc_params": self.disc_params,
                "params": self.gen_params,
                "history": self.history,
                "final_disc_acc": self.history[-1]["disc_acc"],
                "final_test_acc": self.history[-1]["disc_acc"],
                "wall_time_s": time.time() - t0,
                "rounds": rounds}
