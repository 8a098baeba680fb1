"""The shared local-SGD loop — the hot loop of FL simulation (counterpart of
``fedml_tpu/core/algframe/local_training.py``).

The JAX package runs a client's steps as one ``lax.while_loop`` over its
*dynamic* real-step count, ``ceil(epochs * real_batches * work_scale)``, so
padded all-zero-mask batches cost nothing, and the whole round is one XLA
program. Here the same count of steps runs in one of two ways:

* :func:`run_local_sgd`, the eager loop: fresh autograd leaves and a
  Python-driven step each time. The golden loop (``simulation/sp``) runs
  it, and so may any caller that asks for it by name.
* :class:`StepProgram`, the engine's step: it owns static tensors (params,
  optimizer state, one batch, the summed metrics). Each step copies the
  batch the epoch order picks into the static batch and runs forward,
  backward and the update in place. On CUDA that body is captured once
  into a ``torch.cuda.CUDAGraph`` and replayed with no host work in between
  (the counterpart of the JAX package's one dispatch); on the CPU the same
  body runs eagerly through the same static tensors.

Both share the loss, the optimizer's in-place :meth:`~.client_trainer.
InnerOptimizer.step_` and the metric sums, so on the CPU they agree
bitwise. The per-epoch batch order is the same sort trick on the same
``jax.random`` bits (:mod:`fedml_tpu_torch.prng`): one uniform key per
padded slot, padded slots pushed to the end with +2, stable argsort.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ... import prng
from .client_trainer import InnerOptimizer, TrainerSpec
from .types import ClientData, Params, TrainHyper

METRICS = ("loss_sum", "correct", "count")

#: eager runs of the step body on a side stream before capture, as
#: PyTorch asks (lazy library handles, workspaces, autotuning)
WARMUP_STEPS = 3


def batch_real_of(mask) -> np.ndarray:
    """[..., n_batches, bs] mask -> [..., n_batches] bool: a batch is real
    iff it has at least one unmasked sample. Host numpy, so the engine
    computes it once per client when it is built, not per round."""
    return np.any(np.asarray(mask) > 0, axis=-1)


def step_count(batch_real: np.ndarray, hyper: TrainHyper) -> int:
    """``ceil(epochs * real_batches * work_scale)``, in float32 as the JAX
    loop computes it."""
    return int(np.ceil(np.float32(hyper.epochs * int(batch_real.sum()))
                       * np.float32(hyper.work_scale)))


def _batch_schedule(rng: np.ndarray, batch_real: np.ndarray,
                    total_steps: int):
    """Yield the batch index of each of ``total_steps`` steps."""
    denom = max(int(batch_real.sum()), 1)
    # split(rng)[1] seeds the per-step keys the JAX loop hands the model
    # for dropout; no ported model has dropout, so it is not drawn here
    data_rng = prng.split(rng)[0]
    order = None
    for t in range(total_steps):
        if t % denom == 0:
            order = prng.epoch_order(data_rng, t // denom, batch_real)
        yield int(order[t % denom])


def _accumulate(sums: Dict[str, torch.Tensor], aux) -> None:
    for k in METRICS:
        sums[k] += aux[k].float()


def run_local_sgd(spec: TrainerSpec, inner_opt: InnerOptimizer,
                  params: Params, cdata: ClientData, rng: np.ndarray,
                  hyper: TrainHyper, batch_real: Optional[np.ndarray] = None
                  ) -> Tuple[Params, int, Dict[str, torch.Tensor]]:
    """Run ``hyper.epochs`` of SGD over one client's padded batches,
    eagerly.

    ``batch_real`` (host bools per batch, :func:`batch_real_of`) saves a
    device-to-host read of the mask. Returns ``(params, steps, metrics)``:
    the trained params (new tensors), the number of steps run, and metrics
    summed over all real samples seen (loss_sum / correct / count, float32
    tensors on the params' device).
    """
    if batch_real is None:
        batch_real = batch_real_of(cdata.mask.cpu())
    total_steps = step_count(batch_real, hyper)
    params = {k: v.detach().clone() for k, v in params.items()}
    opt_state = inner_opt.init(params)
    dev = next(iter(params.values())).device
    metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in METRICS}
    for idx in _batch_schedule(rng, batch_real, total_steps):
        batch = {"x": cdata.x[idx], "y": cdata.y[idx],
                 "mask": cdata.mask[idx]}
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, aux = spec.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        inner_opt.step_(params, dict(zip(leaves, grads)), opt_state)
        with torch.no_grad():
            _accumulate(metrics, aux)
    return params, total_steps, metrics


class StepProgram:
    """One local SGD step over static tensors: captured into a CUDA graph
    when they are on a CUDA device, run eagerly on them on the CPU.

    Built once per (model, compute dtype, batch shape, inner optimizer)
    and reused across clients and rounds: :meth:`run` loads a client's
    start params and a fresh optimizer state into the static tensors,
    then runs its steps. Counters: ``captures`` (0 or 1), ``capture_s``
    (host seconds of warm-up plus capture), ``warmup_steps`` (eager steps
    the warm-up ran) and ``replays``. A failed capture or replay raises;
    nothing falls back to the eager body on a CUDA device.
    """

    def __init__(self, spec: TrainerSpec, inner_opt: InnerOptimizer,
                 params: Params, cdata: ClientData):
        dev = next(iter(params.values())).device
        self.spec = spec
        self.opt = inner_opt
        self.capture = dev.type == "cuda"
        self.params = {k: torch.empty_like(v) for k, v in params.items()}
        self.opt_state = inner_opt.init(self.params)
        self.batch = {"x": torch.empty_like(cdata.x[0]),
                      "y": torch.empty_like(cdata.y[0]),
                      "mask": torch.empty_like(cdata.mask[0])}
        self.metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                        for k in METRICS}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # kernel launches the graph holds, by wrapper (counted at capture)
        self.graph_launches: Dict[object, int] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.warmup_steps = 0
        self.replays = 0

    def _body(self) -> None:
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self.params.items()}
        loss, aux = self.spec.loss(leaves, self.batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        self.opt.step_(self.params, dict(zip(leaves, grads)),
                       self.opt_state)
        with torch.no_grad():
            _accumulate(self.metrics, aux)

    def _capture(self, cdata: ClientData) -> None:
        """Warm the body up on a side stream, then capture it. The warm-up
        writes the static tensors; :meth:`run` resets them afterwards."""
        from ..kernels import counted_kernels
        t0 = time.perf_counter()
        self._load_batch(cdata, 0)
        side = torch.cuda.Stream(self.batch["x"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body()
        torch.cuda.current_stream().wait_stream(side)
        self.warmup_steps += WARMUP_STEPS
        before = {fn: fn.captured for fn in counted_kernels()}
        # keep_graph: the graph stays inspectable (debug_dump) after
        # instantiation
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            self._body()
        graph.instantiate()
        self.graph_launches = {fn: fn.captured - n
                               for fn, n in before.items()
                               if fn.captured != n}
        self.graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _load_batch(self, cdata: ClientData, idx: int) -> None:
        for k in self.batch:
            self.batch[k].copy_(getattr(cdata, k)[idx])

    def _step(self) -> None:
        if self.graph is None:
            self._body()
            return
        self.graph.replay()
        self.replays += 1
        # a replay launches every kernel the graph holds
        for fn, n in self.graph_launches.items():
            fn.launches += n

    def prepare(self, params: Params, cdata: ClientData,
                hyper: TrainHyper) -> None:
        """Warm up and capture now, if this program captures and has not
        yet (:meth:`run` does it at its first call otherwise)."""
        if self.capture and self.graph is None:
            self._reset(params, hyper)
            self._capture(cdata)

    def run(self, params: Params, cdata: ClientData, rng: np.ndarray,
            hyper: TrainHyper, batch_real: np.ndarray
            ) -> Tuple[Params, int, Dict[str, torch.Tensor]]:
        """One client's local training from ``params``; same contract as
        :func:`run_local_sgd` (the returned params are the static tensors,
        valid until the next call)."""
        self.prepare(params, cdata, hyper)
        self._reset(params, hyper)
        total_steps = step_count(batch_real, hyper)
        for idx in _batch_schedule(rng, batch_real, total_steps):
            self._load_batch(cdata, idx)
            self._step()
        return (self.params, total_steps,
                {k: v.clone() for k, v in self.metrics.items()})

    @torch.no_grad()
    def _reset(self, params: Params, hyper: TrainHyper) -> None:
        for k, v in params.items():
            self.params[k].copy_(v)
        self.opt.reset_(self.opt_state, hyper.learning_rate)
        for v in self.metrics.values():
            v.zero_()


@torch.no_grad()
def evaluate(spec: TrainerSpec, params: Params, x: torch.Tensor,
             y: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batched evaluation over a [n_batches, bs, ...] dataset; returns
    summed stats (the caller divides by count)."""
    total: Dict[str, torch.Tensor] = {}
    for i in range(x.shape[0]):
        stats = spec.eval_stats(params, {"x": x[i], "y": y[i],
                                         "mask": mask[i]})
        for k, v in stats.items():
            total[k] = total[k] + v if k in total else v
    return total
