"""Rank programs of the port's multi-rank tests (``tests/test_torch_mesh.py``,
``test_torch_client_axis.py``, ``test_torch_ring.py``,
``test_torch_sharding.py``): each runs in one rank process started by
``fedml_tpu_torch.core.launch.run_ranks``, on the CPU over gloo, and
imports only ``torch``, numpy and ``fedml_tpu_torch``. Inputs and results
are numpy arrays and plain Python values.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(params):
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# -- the mesh ------------------------------------------------------------------

def mesh_layouts(shapes):
    """``build_mesh`` of each shape over the launch's ranks: the axis
    names, sizes and rank layout, or the error's type and message."""
    from fedml_tpu_torch.core.mesh import build_mesh, init_ranks
    init_ranks("cpu")
    out = []
    for shape in shapes:
        try:
            mesh = build_mesh(shape, "cpu")
        except (ValueError, TypeError) as e:
            out.append((type(e).__name__, str(e)))
            continue
        out.append((list(mesh.mesh_dim_names), list(mesh.mesh.shape),
                    mesh.mesh.tolist()))
    return out


# -- the client axis -------------------------------------------------------------

def simulate(cases, mesh_shape):
    """Each case ``name -> (cfg, init_params)`` through ``run_simulation``
    on this rank with ``mesh_shape``: its params, history and this rank's
    dispatch stats."""
    import fedml_tpu_torch
    out = {}
    for name, (cfg, init) in cases.items():
        r = fedml_tpu_torch.run_simulation(
            device="cpu", enable_tracking=False, mesh_shape=mesh_shape,
            init_params=init, **cfg)
        out[name] = {"params": _np(r["params"]), "history": r["history"],
                     "stats": r["dispatch_stats"]}
    return out


def _runner(cfg, init, mesh_shape, server_aggregator=None):
    """The simulator ``run_simulation`` builds for ``cfg`` on this rank
    (the CPU), kept so a test can read its verdicts and contributions."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.runner import FedMLRunner
    args = fedml_tpu_torch.init(None, device=torch.device("cpu"),
                                backend="gpu", enable_tracking=False,
                                mesh_shape=mesh_shape, **cfg)
    args.training_type = "simulation"
    fed, out_dim = data.load(args)
    bundle = model.create(args, out_dim, fed.input_shape)
    return FedMLRunner(args, device=torch.device("cpu"), dataset=fed,
                       model=bundle, server_aggregator=server_aggregator,
                       init_params=init).runner


class MedianAggregator:
    """A user ``ServerAggregator`` for the rank programs: the coordinate
    median of the rows, their weights floored at 1, scaled by 0.9 after;
    it records the matrix shapes it saw."""

    def __new__(cls):
        from fedml_tpu_torch.core.algframe.server_aggregator import \
            ServerAggregator
        from fedml_tpu_torch.core.security.defense import robust_agg

        class _Median(ServerAggregator):
            def __init__(self):
                self.seen = []

            def on_before_aggregation(self, update_matrix, weights):
                self.seen.append(tuple(update_matrix.shape))
                return update_matrix, torch.clamp(weights, min=1.0)

            def aggregate(self, update_matrix, weights):
                return robust_agg.median0(update_matrix)

            def on_after_aggregation(self, agg_vec):
                return agg_vec * 0.9
        return _Median()


def simulate_robust(cases, mesh_shape):
    """:func:`simulate` of robust cases ``name -> (cfg, init_params,
    with_aggregator)``, adding each run's verdicts, contribution history,
    the matrix shapes a user aggregator saw and the defense's input of
    every round (this rank's feature shard, as ``defend_shard_stateful``
    received it)."""
    import fedml_tpu_torch
    import fedml_tpu_torch.core.security.defense.sharded as sharded
    from fedml_tpu_torch.core import collectives
    seen, real = [], sharded.defend_shard_stateful

    def record(mat, *a, **kw):
        seen.append(mat.detach().clone().numpy())
        return real(mat, *a, **kw)

    sharded.defend_shard_stateful = record
    out = {}
    try:
        for name, (cfg, init, with_agg) in cases.items():
            agg = MedianAggregator() if with_agg else None
            seen.clear()
            collectives.reset_collective_stats()
            sim = _runner(cfg, init, mesh_shape, agg)
            r = sim.run()
            out[name] = {
                "params": _np(r["params"]), "history": r["history"],
                "stats": r["dispatch_stats"],
                "collectives": collectives.collective_stats(),
                "defense_inputs": list(seen),
                "aggregator_saw": None if agg is None else list(agg.seen),
                "verdicts": {k: (list(v[0]), np.asarray(v[1]))
                             for k, v in sim.verdicts.items()},
                "contribution": list(sim.contribution.history)}
    finally:
        sharded.defend_shard_stateful = real
    return out


def simulate_async(cases, mesh_shape):
    """Each buffered-async case ``name -> (cfg, init_params)`` on this
    rank: params, history, ``async_stats``, this rank's dispatch stats,
    every dispatch's cohort (as ``_draw_cohort`` drew it) and the
    verdicts."""
    out = {}
    for name, (cfg, init) in cases.items():
        sim = _runner(cfg, init, mesh_shape)
        cohorts, draw = [], sim._draw_cohort

        def record(target, _draw=draw, _log=cohorts):
            got = _draw(target)
            _log.append(list(got))
            return got

        sim._draw_cohort = record
        r = sim.run()
        out[name] = {"params": _np(r["params"]), "history": r["history"],
                     "async_stats": r["async_stats"],
                     "stats": r["dispatch_stats"], "cohorts": cohorts,
                     "verdicts": {k: (list(v[0]), np.asarray(v[1]))
                                  for k, v in sim.verdicts.items()}}
    return out


def simulate_resumed(cfg, init, mesh_shape, ckpt_dir, split):
    """``cfg`` run to round ``split`` with checkpoints, then resumed to its
    ``comm_round`` from the newest one; and the same run uninterrupted."""
    import fedml_tpu_torch
    kw = dict(device="cpu", enable_tracking=False, mesh_shape=mesh_shape,
              init_params=init)
    ck = dict(cfg, checkpoint_dir=ckpt_dir, checkpoint_every_rounds=1)
    fedml_tpu_torch.run_simulation(**kw, **dict(ck, comm_round=split))
    resumed = fedml_tpu_torch.run_simulation(**kw, **ck)
    whole = fedml_tpu_torch.run_simulation(**kw, **cfg)
    return {"resumed": _np(resumed["params"]), "whole": _np(whole["params"]),
            "rounds": [h["round"] for h in resumed["history"]]}


def refusals(cases, mesh_shape):
    """Each case ``name -> (cfg, init_params)`` that must raise over these
    ranks: the exception's type and message."""
    import fedml_tpu_torch
    out = {}
    for name, (cfg, init) in cases.items():
        try:
            fedml_tpu_torch.run_simulation(
                device="cpu", enable_tracking=False, mesh_shape=mesh_shape,
                init_params=init, **cfg)
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
        else:
            out[name] = None
    return out


# -- ring attention ------------------------------------------------------------------

def _sp_slice(a, index, size):
    s = a.shape[1] // size
    return a[:, index * s:(index + 1) * s]


def ring_attention(cases):
    """Each case ``name -> (q, k, v, mask or None, cotangent)`` (full
    float32 arrays) through
    ``ring_causal_attention`` on this rank's slice of the sequence: the
    output and dQ, dK, dV of ``sum(out * cotangent)``, this rank's
    slices."""
    import torch.distributed as dist
    from fedml_tpu_torch.core.mesh import init_ranks
    from fedml_tpu_torch.llm.attention import ring_causal_attention
    init_ranks("cpu")
    me, size = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, (q, k, v, mask, cot) in cases.items():
        tq, tk, tv = (torch.tensor(_sp_slice(a, me, size)).requires_grad_()
                      for a in (q, k, v))
        tm = None if mask is None else torch.tensor(_sp_slice(mask, me, size))
        o = ring_causal_attention(tq, tk, tv, attn_mask=tm)
        (o * torch.tensor(_sp_slice(cot, me, size))).sum().backward()
        out[name] = tuple(t.detach().numpy() for t in
                          (o, tq.grad, tk.grad, tv.grad))
    return out


def ring_saved_bytes(s, d):
    """The bytes ``saved_tensors_hooks`` sees one ring attention forward
    save on this rank, at sequence ``s`` (split over the ranks), head
    width ``d``, batch 1, one head; then the backward runs."""
    import torch.distributed as dist
    from fedml_tpu_torch.core.mesh import init_ranks
    from fedml_tpu_torch.llm.attention import ring_causal_attention
    init_ranks("cpu")
    s_loc = s // dist.get_world_size()
    gen = torch.Generator().manual_seed(dist.get_rank())
    q, k, v = (torch.randn(1, s_loc, 1, d, generator=gen).requires_grad_()
               for _ in range(3))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ring_causal_attention(q, k, v)
    out.sum().backward()
    return sum(saved)


def _lm_apply(cfg_kw):
    from torch.func import functional_call
    from fedml_tpu_torch.llm.model import CausalLM, LLMConfig
    model = CausalLM(LLMConfig(**cfg_kw))
    return model, lambda p, t, m: functional_call(model, p, (t,),
                                                  {"attn_mask": m})


def ring_forward(cfg_kw, params, tokens, masks):
    """``make_ring_forward`` of the causal LM (``attention_impl='ring'``)
    over the ranks as one ``sp`` axis: this rank's logits slice for each
    mask in ``masks`` (None: no mask)."""
    from fedml_tpu_torch.core.mesh import build_mesh, init_ranks, world_size
    from fedml_tpu_torch.llm.sharding import make_ring_forward
    init_ranks("cpu")
    mesh = build_mesh({"sp": world_size()}, "cpu")
    _, apply = _lm_apply(dict(cfg_kw, attention_impl="ring"))
    fwd = make_ring_forward(apply, mesh)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    t = torch.tensor(tokens)
    with torch.no_grad():
        return [fwd(tp, t, None if m is None else torch.tensor(m)).numpy()
                for m in masks]


# -- the sharded step ------------------------------------------------------------------

def sharded_step(cfg_kw, params, batch, mesh_shape, lr):
    """One SGD step of ``make_sharded_train_step`` over ``mesh_shape``:
    the loss, every updated parameter gathered, and this rank's local
    shard shapes."""
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_inner_optimizer
    from fedml_tpu_torch.core.mesh import build_mesh, init_ranks
    from fedml_tpu_torch.llm.sharding import (llm_param_specs,
                                              make_sharded_train_step,
                                              shard_llm_params)
    from fedml_tpu_torch.llm.trainer import CausalLMTrainer
    init_ranks("cpu")
    mesh = build_mesh(mesh_shape, "cpu")
    _, apply = _lm_apply(cfg_kw)
    spec = CausalLMTrainer(lambda p, x, rng=None, train=False:
                           apply(p, x, None))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    specs = llm_param_specs(tp, mesh)
    sharded = shard_llm_params(tp, mesh, specs)
    step = make_sharded_train_step(spec.loss, make_inner_optimizer("sgd", lr),
                                   mesh, specs)
    new, _, loss = step(sharded, None, {k: torch.tensor(v)
                                        for k, v in batch.items()}, None)
    return (float(loss), {k: v.full_tensor().detach().numpy()
                          for k, v in new.items()},
            {k: tuple(v.to_local().shape) for k, v in new.items()})


def sharded_lora_step(cfg_kw, params, lora, batch, mesh_shape, lr, scale):
    """One SGD step of ``make_sharded_train_step`` over ``mesh_shape`` on
    the base parameters and a LoRA adapter together (the adapter's keys
    beside its kernels', the model's factored side path at ``scale``): the
    loss and every updated base parameter and factor, gathered."""
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_inner_optimizer
    from fedml_tpu_torch.core.mesh import build_mesh, init_ranks
    from fedml_tpu_torch.llm.sharding import (llm_param_specs,
                                              make_sharded_train_step,
                                              shard_llm_params)
    from fedml_tpu_torch.llm.trainer import CausalLMTrainer
    from torch.func import functional_call
    from fedml_tpu_torch.llm.model import CausalLM, LLMConfig
    init_ranks("cpu")
    mesh = build_mesh(mesh_shape, "cpu")
    model = CausalLM(LLMConfig(**cfg_kw))

    def apply(p, x, rng=None, train=False):
        base = {k: v for k, v in p.items() if k not in lora}
        return functional_call(model, base, (x,), {
            "adapters": {k: p[k] for k in lora}, "lora_scale": scale})

    spec = CausalLMTrainer(apply)
    tp = {k: torch.tensor(v) for k, v in {**params, **lora}.items()}
    specs = llm_param_specs(tp, mesh)
    sharded = shard_llm_params(tp, mesh, specs)
    step = make_sharded_train_step(spec.loss, make_inner_optimizer("sgd", lr),
                                   mesh, specs)
    new, _, loss = step(sharded, None, {k: torch.tensor(v)
                                        for k, v in batch.items()}, None)
    return float(loss), {k: v.full_tensor().detach().numpy()
                         for k, v in new.items()}


def ring_suite(attention, forward, saved):
    """One spawn for the ring tests: :func:`ring_attention` of
    ``attention``, :func:`ring_forward` of ``forward`` (``(cfg_kw, params,
    tokens, masks)``) and :func:`ring_saved_bytes` of ``saved`` (``(s,
    d)``)."""
    return {"attention": ring_attention(attention),
            "forward": ring_forward(*forward),
            "saved_bytes": ring_saved_bytes(*saved)}
