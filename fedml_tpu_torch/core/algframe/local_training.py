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

Both run one step function (:func:`_sgd_step`: the loss, the optional
``grad_transform`` hook between the gradients and the optimizer, the
optimizer's in-place :meth:`~.client_trainer.InnerOptimizer.step_` and the
metric sums), so on the CPU they agree bitwise. The per-epoch batch order
is the same sort trick on the same ``jax.random`` bits
(:mod:`fedml_tpu_torch.prng`): one uniform key per padded slot, padded
slots pushed to the end with +2, stable argsort.

``grad_transform(grads, params, ctx)`` is how an optimizer customises the
step (FedProx's proximal term, SCAFFOLD's control-variate correction,
FedDyn's linear term, Mime's fixed server momentum). Under a captured step
everything it reads must be the program's own static tensors: ``ctx`` is
copied into them at each client's start, and the transform's Python floats
are frozen into the graph at capture (per-run constants).

The full-batch gradient (:func:`full_batch_grad_sum`, FedSGD, Mime and the
folded round) scans *every* padded batch, all-zero-mask ones included
(their ``count`` weight is 0), as the JAX scan does; :class:`GradProgram`
is its captured counterpart.

A model with dropout (:func:`draws_dropout`) takes a dropout key at each
step, JAX's: the local loop hands step ``t`` the second half of
``split`` of a carried key that starts at ``split(rng)[1]``, and the
full-batch gradient hands batch ``i`` ``fold_in(rng, i)``. The keys live in
int64 tensors on the params' device (:class:`StepKeys`, :class:`BatchKeys`)
and each step derives its key there, so a captured step draws new masks at
every replay: the host writes the client's key once, before its steps.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ... import prng
from ..collectives import tree_copy_, tree_zeros_like
from .client_trainer import InnerOptimizer, TrainerSpec
from .types import ClientData, Params, TrainHyper

METRICS = ("loss_sum", "correct", "count")

#: ``grad_transform(grads, params, ctx) -> grads``
GradTransform = Callable[[Params, Params, Dict[str, Any]], Params]

#: eager runs of the step body on a side stream before capture, as
#: PyTorch asks (lazy library handles, workspaces, autotuning)
WARMUP_STEPS = 3

# one capture at a time per process: the in-proc cross-silo session runs
# each silo's program on a thread of its own, and a capture reads the
# kernel counters' ``captured`` before and after
_CAPTURE_LOCK = threading.Lock()


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


def effective_steps(batch_real: np.ndarray, epochs: int,
                    work_scale: float = 1.0) -> np.float32:
    """The local SGD steps a client runs, as SCAFFOLD's ``1/(K lr)`` and
    FedNova's ``a_i`` use it: ``max(ceil(epochs * real_batches *
    work_scale), 1)`` in float32, as the JAX package computes it from the
    mask (here from its host bools, :func:`batch_real_of`). A client with no
    real batch counts 1, so nothing divides by 0."""
    real = np.float32(np.sum(batch_real))
    return np.maximum(
        np.ceil(np.float32(epochs) * real * np.float32(work_scale)),
        np.float32(1.0))


def draws_dropout(spec: TrainerSpec) -> bool:
    """Whether the model behind ``spec.apply_fn`` (a bundle's ``apply``)
    draws dropout masks in training."""
    return bool(getattr(getattr(spec.apply_fn, "__self__", None),
                        "has_dropout", False))


class StepKeys:
    """The local loop's per-step dropout keys on ``device``: a carried key
    (``split(rng)[1]`` at a client's start) that each :meth:`next` splits
    in place into the next carried key and the step's key."""

    def __init__(self, device):
        self.carry = torch.zeros(2, dtype=torch.int64, device=device)
        self._ctr = torch.arange(2, dtype=torch.int64, device=device)

    def reset_(self, rng: np.ndarray) -> None:
        prng.set_key_(self.carry, prng.split(rng)[1])

    def next(self) -> torch.Tensor:
        blk = prng.split2_t(self.carry, self._ctr)
        self.carry.copy_(blk[0])
        return blk[1]


class BatchKeys:
    """The full-batch gradient's dropout keys on ``device``: batch ``i``'s
    is ``fold_in(rng, i)``, ``i`` a device counter each :meth:`next`
    advances."""

    def __init__(self, device):
        self.base = torch.zeros(2, dtype=torch.int64, device=device)
        self.i = torch.zeros(1, dtype=torch.int64, device=device)

    def reset_(self, rng: np.ndarray) -> None:
        prng.set_key_(self.base, rng)
        self.i.zero_()

    def next(self) -> torch.Tensor:
        key = prng.fold_in_t(self.base, self.i)
        self.i.add_(1)
        return key


def _keys(cls, spec: TrainerSpec, device):
    return cls(device) if draws_dropout(spec) else None


def _batch_schedule(rng: np.ndarray, batch_real: np.ndarray,
                    total_steps: int):
    """Yield the batch index of each of ``total_steps`` steps."""
    denom = max(int(batch_real.sum()), 1)
    data_rng = prng.split(rng)[0]
    order = None
    for t in range(total_steps):
        if t % denom == 0:
            order = prng.epoch_order(data_rng, t // denom, batch_real)
        yield int(order[t % denom])


def _accumulate(sums: Dict[str, torch.Tensor], aux) -> None:
    for k in METRICS:
        sums[k] += aux[k].float()


def _zero_metrics(dev) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=dev)
            for k in METRICS}


def _loss_grads(spec: TrainerSpec, params: Params, batch, keys=None,
                contiguous: bool = False):
    """The loss's gradients at ``params`` (dict, params' order) and its
    aux sums. ``contiguous``: in the params' (contiguous) layout. A conv
    kernel's gradient comes back with the strides of the layout the
    convolution ran in, and a multi-tensor ``_foreach`` op takes its fused
    path only when the tensors it pairs share strides; otherwise it
    launches one kernel per tensor. ``keys`` (:class:`StepKeys` or
    :class:`BatchKeys`) gives the step's dropout key."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    rng = None if keys is None else keys.next()
    loss, aux = spec.loss(leaves, batch, rng)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    if contiguous:
        grads = [g.contiguous() for g in grads]
    return dict(zip(leaves, grads)), aux


def _sgd_step(spec: TrainerSpec, opt: InnerOptimizer, params: Params,
              opt_state, batch, metrics: Dict[str, torch.Tensor],
              grad_transform: Optional[GradTransform], ctx,
              keys: Optional[StepKeys]) -> None:
    """One local step in place: gradients, the optimizer's transform of
    them, the inner optimizer's update, the metric sums. The eager loop and
    the captured step both run this."""
    grads, aux = _loss_grads(spec, params, batch, keys,
                             contiguous=grad_transform is not None)
    with torch.no_grad():
        if grad_transform is not None:
            grads = grad_transform(grads, params, ctx)
        opt.step_(params, grads, opt_state)
        _accumulate(metrics, aux)


def _grad_sum_step(spec: TrainerSpec, params: Params, batch,
                   grad_sum: Params, metrics: Dict[str, torch.Tensor],
                   keys: Optional[BatchKeys]) -> None:
    """One batch of the full-batch gradient in place: ``grad_sum += g *
    count`` (the batch's real samples; 0 for an all-padding batch) and the
    metric sums."""
    grads, aux = _loss_grads(spec, params, batch, keys, contiguous=True)
    with torch.no_grad():
        g = list(grads.values())
        torch._foreach_add_(list(grad_sum.values()),
                            torch._foreach_mul(g, aux["count"].to(g[0].dtype)))
        _accumulate(metrics, aux)


def run_local_sgd(spec: TrainerSpec, inner_opt: InnerOptimizer,
                  params: Params, cdata: ClientData, rng: np.ndarray,
                  hyper: TrainHyper, batch_real: Optional[np.ndarray] = None,
                  grad_transform: Optional[GradTransform] = None,
                  ctx: Optional[Dict[str, Any]] = None
                  ) -> Tuple[Params, int, Dict[str, torch.Tensor]]:
    """Run ``hyper.epochs`` of SGD over one client's padded batches,
    eagerly.

    ``batch_real`` (host bools per batch, :func:`batch_real_of`) saves a
    device-to-host read of the mask. ``grad_transform(grads, params, ctx)``
    rewrites each step's gradients before the optimizer sees them.
    Returns ``(params, steps, metrics)``: the trained params (new tensors),
    the number of steps run, and metrics summed over all real samples seen
    (loss_sum / correct / count, float32 tensors on the params' device).
    """
    if batch_real is None:
        batch_real = batch_real_of(cdata.mask.cpu())
    total_steps = step_count(batch_real, hyper)
    params = {k: v.detach().clone() for k, v in params.items()}
    opt_state = inner_opt.init(params)
    dev = next(iter(params.values())).device
    metrics = _zero_metrics(dev)
    keys = _keys(StepKeys, spec, dev)
    if keys is not None:
        keys.reset_(rng)
    for idx in _batch_schedule(rng, batch_real, total_steps):
        batch = {"x": cdata.x[idx], "y": cdata.y[idx],
                 "mask": cdata.mask[idx]}
        _sgd_step(spec, inner_opt, params, opt_state, batch, metrics,
                  grad_transform, ctx, keys)
    return params, total_steps, metrics


def full_batch_grad_sum(spec: TrainerSpec, params: Params,
                        cdata: ClientData, rng: np.ndarray
                        ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """Masked SUM of per-sample gradients of the loss at ``params``, eagerly:
    each padded batch's mean gradient times its real-sample count, summed
    over every batch. It is exactly additive across clients, which is what
    lets the folded round replace one pass per client with one wide pass.
    Returns ``(grad_sum, metrics)`` (new tensors). Batch ``i`` draws its
    dropout masks from ``fold_in(rng, i)``."""
    params = {k: v.detach() for k, v in params.items()}
    grad_sum = {k: torch.zeros_like(v) for k, v in params.items()}
    dev = next(iter(params.values())).device
    metrics = _zero_metrics(dev)
    keys = _keys(BatchKeys, spec, dev)
    if keys is not None:
        keys.reset_(rng)
    for i in range(cdata.x.shape[0]):
        _grad_sum_step(spec, params, {"x": cdata.x[i], "y": cdata.y[i],
                                      "mask": cdata.mask[i]},
                       grad_sum, metrics, keys)
    return grad_sum, metrics


def full_batch_grad(spec: TrainerSpec, params: Params, cdata: ClientData,
                    rng: np.ndarray, program: Optional["GradProgram"] = None
                    ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """The gradient of the mean loss over all of a client's real samples at
    ``params``: :func:`full_batch_grad_sum` over ``max(count, 1)``. With
    ``program`` the sum runs through it (captured on a card), else eagerly.
    Returns new tensors. FedSGD and Mime use it."""
    if program is None:
        grad_sum, metrics = full_batch_grad_sum(spec, params, cdata, rng)
    else:
        grad_sum, metrics = program.run(params, cdata, rng)
    denom = torch.clamp(metrics["count"], min=1.0)
    g = list(grad_sum.values())
    return (dict(zip(grad_sum, torch._foreach_div(g, denom.to(g[0].dtype)))),
            metrics)


class _Program:
    """Static tensors (params, one batch, metric sums) and one body over
    them: captured into a CUDA graph when they are on a CUDA device, run
    eagerly on them on the CPU.

    Counters: ``captures`` (0 or 1), ``capture_s`` (host seconds of warm-up
    plus capture), ``warmup_steps`` (eager runs of the body the warm-up
    made), ``replays`` and ``steps`` (steps run, replayed or eager: the
    roofline's multiplier). A failed capture or replay raises; nothing
    falls back to the eager body on a CUDA device.
    """

    _key_cls = StepKeys

    def __init__(self, spec: TrainerSpec, params: Params, cdata: ClientData):
        dev = next(iter(params.values())).device
        self.spec = spec
        # the dropout keys, static too: written before a client's steps
        self.keys = _keys(self._key_cls, spec, dev)
        self.capture = dev.type == "cuda"
        self.params = {k: torch.empty_like(v) for k, v in params.items()}
        self.batch = {"x": torch.empty_like(cdata.x[0]),
                      "y": torch.empty_like(cdata.y[0]),
                      "mask": torch.empty_like(cdata.mask[0])}
        self.metrics = _zero_metrics(dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # kernel launches the graph holds, by wrapper (counted at capture)
        self.graph_launches: Dict[object, int] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.warmup_steps = 0
        self.replays = 0
        self.steps = 0

    def _body(self) -> None:
        raise NotImplementedError

    def analysis_step(self) -> None:
        """One step of the body on copies of the static tensors, leaving
        the program as it was: what a roofline capture records
        (``core/obs/roofline.py``; the copying is not recorded)."""
        from ..obs import roofline
        with roofline.unrecorded():
            twin = roofline.program_twin(self)
        twin._body()

    def _capture(self, cdata: ClientData) -> None:
        """Warm the body up on a side stream, then capture it. The warm-up
        writes the static tensors; the caller resets them afterwards.
        Captures are serialised within a process, and each is
        ``thread_local`` (other threads, e.g. the in-proc cross-silo
        session's other parties, keep working on the card meanwhile)."""
        with _CAPTURE_LOCK:
            self._capture_locked(cdata)

    def _capture_locked(self, cdata: ClientData) -> None:
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
        # no automatic garbage collection while capturing: a collection
        # in this thread that frees a dropped program destroys its graph
        # mid-capture, which CUDA refuses and which invalidates the
        # capture (``torch.cuda.graph`` collects once just before)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._body()
        finally:
            if collecting:
                gc.enable()
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
        self.steps += 1
        if self.graph is None:
            self._body()
            return
        self.graph.replay()
        self.replays += 1
        # a replay launches every kernel the graph holds
        for fn, n in self.graph_launches.items():
            fn.launches += n


class StepProgram(_Program):
    """One local SGD step over static tensors (see :class:`_Program`).

    Built once per (model, compute dtype, batch shape, inner optimizer,
    optimizer transform) and reused across clients and rounds: :meth:`run`
    loads a client's start params, a fresh optimizer state and the
    transform's ``ctx`` into the static tensors, then runs its steps.
    ``ctx`` (``global_params``, ``server_state``, ``client_state``) is only
    kept when there is a ``grad_transform``; ``ctx_template`` gives its
    structure.
    """

    def __init__(self, spec: TrainerSpec, inner_opt: InnerOptimizer,
                 params: Params, cdata: ClientData,
                 grad_transform: Optional[GradTransform] = None,
                 ctx_template: Optional[Dict[str, Any]] = None):
        super().__init__(spec, params, cdata)
        self.opt = inner_opt
        self.opt_state = inner_opt.init(self.params)
        self.grad_transform = grad_transform
        self.ctx = (None if grad_transform is None
                    else tree_zeros_like(ctx_template))

    def _body(self) -> None:
        _sgd_step(self.spec, self.opt, self.params, self.opt_state,
                  self.batch, self.metrics, self.grad_transform, self.ctx,
                  self.keys)

    def prepare(self, params: Params, cdata: ClientData,
                hyper: TrainHyper, ctx: Optional[Dict[str, Any]] = None
                ) -> None:
        """Warm up and capture now, if this program captures and has not
        yet (:meth:`run` does it at its first call otherwise)."""
        if self.capture and self.graph is None:
            self._reset(params, hyper, ctx)
            self._capture(cdata)

    def run(self, params: Params, cdata: ClientData, rng: np.ndarray,
            hyper: TrainHyper, batch_real: np.ndarray,
            ctx: Optional[Dict[str, Any]] = None, reset_opt: bool = True
            ) -> Tuple[Params, int, Dict[str, torch.Tensor]]:
        """One client's local training from ``params``; same contract as
        :func:`run_local_sgd` (the returned params are the static tensors,
        valid until the next call). ``reset_opt=False`` keeps the
        optimizer state the previous call left (an epoch of one long run,
        as the centralized trainer's)."""
        self.prepare(params, cdata, hyper, ctx)
        self._reset(params, hyper, ctx, reset_opt)
        if self.keys is not None:
            self.keys.reset_(rng)
        total_steps = step_count(batch_real, hyper)
        for idx in _batch_schedule(rng, batch_real, total_steps):
            self._load_batch(cdata, idx)
            self._step()
        return (self.params, total_steps,
                {k: v.clone() for k, v in self.metrics.items()})

    @torch.no_grad()
    def _reset(self, params: Params, hyper: TrainHyper,
               ctx: Optional[Dict[str, Any]], reset_opt: bool = True) -> None:
        tree_copy_(self.params, params)
        if reset_opt:
            self.opt.reset_(self.opt_state, hyper.learning_rate)
        for v in self.metrics.values():
            v.zero_()
        if self.ctx is not None and ctx is not None:
            tree_copy_(self.ctx, {k: ctx[k] for k in self.ctx})


class GradProgram(_Program):
    """The full-batch gradient sum (:func:`full_batch_grad_sum`) over static
    tensors (see :class:`_Program`): one padded batch per step, its
    gradient at the static params times its real-sample count added into
    static sums. Built once per (model, compute dtype, batch shape); the
    folded round's wider batch gets a program of its own."""

    _key_cls = BatchKeys

    def __init__(self, spec: TrainerSpec, params: Params, cdata: ClientData):
        super().__init__(spec, params, cdata)
        self.grad_sum = {k: torch.zeros_like(v)
                         for k, v in self.params.items()}

    def _body(self) -> None:
        _grad_sum_step(self.spec, self.params, self.batch, self.grad_sum,
                       self.metrics, self.keys)

    def prepare(self, params: Params, cdata: ClientData) -> None:
        if self.capture and self.graph is None:
            self._reset(params)
            self._capture(cdata)

    def run(self, params: Params, cdata: ClientData,
            rng: Optional[np.ndarray] = None
            ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        """:func:`full_batch_grad_sum` of ``cdata`` at ``params`` (dropout
        keys from ``rng``): every padded batch, in order. The returned sums
        are the static tensors, valid until the next call; the metrics are
        copies."""
        self.prepare(params, cdata)
        self._reset(params)
        if self.keys is not None:
            self.keys.reset_(rng)
        for i in range(cdata.x.shape[0]):
            self._load_batch(cdata, i)
            self._step()
        return self.grad_sum, {k: v.clone() for k, v in self.metrics.items()}

    @torch.no_grad()
    def _reset(self, params: Params) -> None:
        tree_copy_(self.params, params)
        for v in list(self.grad_sum.values()) + list(self.metrics.values()):
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
