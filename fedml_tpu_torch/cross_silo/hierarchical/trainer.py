"""Hierarchical cross-silo: data parallelism inside a silo (counterpart of
``fedml_tpu/cross_silo/hierarchical/trainer.py``; reference
``fedml_client_slave_manager.py:9``, ``fedml_trainer_dist_adapter.py``).

The JAX package shards each batch's sample axis over the silo's devices
and lets XLA insert the gradient all-reduce of one SPMD program. Here the
silo's ranks form a ``torch.distributed`` group and run the port's local
loop (``run_local_sgd``) on their shard of each batch: a rank's loss is its
shard's loss sum over the whole batch's real samples (their count summed
over the silo), so one ``all_reduce(SUM)`` of the ranks' gradients gives
the full batch's mean gradient, as the SPMD program computes it; the
metric sums are reduced once, after the last step. A batch whose size does
not divide by the world size is replicated (as the JAX trainer's
``_place`` replicates such a leaf): every rank trains on whole batches
through the silo's step program, and nothing is reduced.

Rank 0 of the silo is driven by the WAN FSM; it first broadcasts each
training's descriptor and the received parameters, and the other ranks
run the same training in :meth:`HierarchicalSiloTrainer.follow`. At world
size 1 the trainer is :class:`~..client.trainer.SiloTrainer`, captured
step and all.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...core.algframe.local_training import (METRICS, draws_dropout,
                                             run_local_sgd)
from ..client.trainer import SiloTrainer


class _ShardLoss:
    """``spec``'s loss on rows ``lo:hi`` of each batch, over the real
    samples of the whole batch (the count all-reduced over ``group``)."""

    def __init__(self, spec, lo: int, hi: int, group):
        self.spec, self.lo, self.hi, self.group = spec, lo, hi, group
        self.apply_fn = spec.apply_fn

    def loss(self, params, batch, rng=None):
        import torch.distributed as dist
        _, aux = self.spec.loss(
            params, {k: v[self.lo:self.hi] for k, v in batch.items()}, rng)
        count = aux["count"].detach().float().clone()
        dist.all_reduce(count, group=self.group)
        return aux["loss_sum"] / torch.clamp(count, min=1.0), aux


class HierarchicalSiloTrainer(SiloTrainer):
    """A :class:`SiloTrainer` whose local steps run data-parallel over the
    silo's process group (``group``: the default group when it is up)."""

    def __init__(self, args, fed_dataset, bundle, spec, optimizer, device,
                 group=None):
        super().__init__(args, fed_dataset, bundle, spec, optimizer, device)
        import torch.distributed as dist
        self.group = group
        up = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size(group) if up else 1
        self.silo_rank = dist.get_rank(group) if up else 0
        if self.world > 1 and draws_dropout(spec):
            raise ValueError(
                "a multi-rank silo does not take a model with dropout: its "
                "ranks would draw masks for their shards, not the batch's")

    def train(self, params, client_idx: int, round_idx: int,
              work_scale: float = 1.0, key_index: Optional[int] = None
              ) -> Tuple[dict, float, Dict[str, float]]:
        if self.world > 1:
            self._broadcast_work((client_idx, round_idx, work_scale,
                                  key_index))
            params = self._broadcast_params(params)
        return super().train(params, client_idx, round_idx, work_scale,
                             key_index)

    def release(self) -> None:
        """Rank 0: tell the following ranks the session is over."""
        if self.world > 1 and self.silo_rank == 0:
            self._broadcast_work(None)

    def follow(self) -> int:
        """Ranks other than 0: run each training rank 0 broadcasts until it
        releases them; returns the trainings run."""
        n = 0
        while True:
            work = self._broadcast_work(None)
            if work is None:
                return n
            params = self._broadcast_params(None)
            super().train(params, *work)
            n += 1

    # --- collectives --------------------------------------------------------
    def _broadcast_work(self, work):
        import torch.distributed as dist
        box = [work]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self._comm_device())
        return box[0]

    def _broadcast_params(self, params):
        import torch.distributed as dist
        src = params if params is not None else self.params_template
        out = {k: v.detach().clone().to(self.device) for k, v in src.items()}
        for v in out.values():
            dist.broadcast(v, src=0, group=self.group)
        return out

    def _comm_device(self):
        import torch.distributed as dist
        return (self.device if dist.get_backend(self.group) == "nccl"
                else torch.device("cpu"))

    # --- the data-parallel local loop ---------------------------------------
    def _local_sgd(self, params, cdata, key, hyper, batch_real):
        bs = int(cdata.x.shape[1])
        if self.world == 1 or bs % self.world:
            return super()._local_sgd(params, cdata, key, hyper, batch_real)
        import torch.distributed as dist
        opt, group = self.opt, self.group
        lo = self.silo_rank * bs // self.world
        hi = (self.silo_rank + 1) * bs // self.world

        def reduce_grads(grads, p, ctx):
            g = list(grads.values())
            flat = torch.cat([t.reshape(-1).float() for t in g])
            dist.all_reduce(flat, group=group)
            out = dict(zip(grads, (
                v.reshape(t.shape).to(t.dtype)
                for v, t in zip(flat.split([t.numel() for t in g]), g))))
            return out if opt.transform is None else opt.transform(out, p,
                                                                   ctx)

        ctx = None if opt.transform is None else opt._ctx(params, {}, {})
        out, steps, metrics = run_local_sgd(
            _ShardLoss(self.spec, lo, hi, group), opt.make_inner_opt(hyper),
            params, cdata, key, hyper, batch_real=batch_real,
            grad_transform=reduce_grads, ctx=ctx)
        sums = torch.stack([metrics[k] for k in METRICS])
        dist.all_reduce(sums, group=group)
        return out, steps, dict(zip(METRICS, sums))
