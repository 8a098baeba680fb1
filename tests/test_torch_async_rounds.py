"""Buffered-async rounds in the port (``core/async_rounds``,
``simulation/gpu/async_engine.py``, ``simulation/sp/async_fedavg.py``)
against the JAX package, on the CPU; and the two repairs that came with
them (the ``obs_*`` knobs, the argument defaults).

* the copies: the staleness families, ``pour_weights``, the adaptive cap,
  ``client_durations`` / ``faulted_duration`` and the buffer's order,
  counters and state round trip equal the reference's exactly;
* the GPU engine's pours against ``fedml_tpu``'s ``AsyncBufferedSimulator``
  pour by pour (params at the house tolerance ``rtol=2e-4, atol=2e-5``,
  pour records and ledger equal): plain, under chaos, with FedOpt adam
  (the step damped, not the gradient), with SCAFFOLD (extras ride the
  buffer; the control variate advances by the poured fraction) and with
  a rotation of 4 of 8 clients; ResNet-20 with the fused conv block
  (its plain version) against JAX's reference block. The JAX engine runs on the 8 virtual CPU
  devices with 8 clients: one client per device, so its ``_draw_cohort``
  never defers a client and each client's key is its global id — the
  cohort and row order of one card;
* the bootstrap pour leaves the server state untouched; a crash-resumed
  run equals the uninterrupted one bitwise;
* refusals and the runner's dispatch on ``round_mode`` / ``Async_FedAvg``;
  the SP ``Async_FedAvg`` loop against the JAX one;
* ``obs_tracing: false`` gives no span and ``obs_metrics: false`` no
  sample in either package; the shared ``_SCHEMA`` defaults equal the
  reference's, ``backend`` excepted.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core import async_rounds as jar
from fedml_tpu.core.algframe.types import TrainHyper as JHyper
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import async_rounds as tar
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.interop import flax_to_state_dict

from torch_port_support import (LR_BASE, RTOL, ATOL,  # noqa: F401
                                assert_params_close, assert_params_equal,
                                jax_init, jax_params, jax_sim, port_sim,
                                single_torch_thread)

pytestmark = pytest.mark.torch_port

ASYNC = dict(LR_BASE, client_num_per_round=8, comm_round=4,
             round_mode="async_buffered", async_buffer_k=4)
CHAOS = dict(chaos_dropout_prob=0.2, chaos_straggler_prob=0.3,
             chaos_straggler_work=0.4, chaos_seed=7)


def hypers(cfg):
    return (JHyper(learning_rate=jnp.float32(cfg["learning_rate"]),
                   epochs=int(cfg["epochs"])),
            TrainHyper(learning_rate=cfg["learning_rate"],
                       epochs=int(cfg["epochs"])))


def pours(sim):
    return [(p["round_idx"], p["injected"], p["observed"])
            for p in sim.chaos_ledger.pours()]


# --- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["constant", "polynomial", "hinge"])
def test_staleness_families_equal_reference(kind):
    stal = np.arange(0, 40)
    for poly_a, hinge_b, cap in ((0.5, 4, 16), (0.0, 0, 1), (1.7, 2, 2000)):
        ours = tar.make_staleness_fn(kind, poly_a, hinge_b, cap)
        theirs = jar.make_staleness_fn(kind, poly_a, hinge_b, cap)
        np.testing.assert_array_equal(ours(stal), theirs(stal))
    with pytest.raises(ValueError):
        tar.make_staleness_fn("linear")
    with pytest.raises(ValueError):
        tar.make_staleness_fn(kind, poly_a=-1.0)


def test_pour_weights_cap_and_knobs_equal_reference():
    rng = np.random.default_rng(0)
    fn_t = tar.make_staleness_fn("polynomial", 0.5, 4, 8)
    fn_j = jar.make_staleness_fn("polynomial", 0.5, 4, 8)
    for _ in range(5):
        w, s = rng.uniform(1, 50, 6), rng.integers(0, 20, 6)
        a, b = tar.pour_weights(w, s, fn_t, 0.6), jar.pour_weights(
            w, s, fn_j, 0.6)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    for lat, ivl in (([10.0], 1.0), ([3.0, 30.0], 2.0), ([0.1], 10.0),
                     ([1e9], 1e-3), ([], 1.0), ([5.0], 0.0),
                     ([np.inf, 2.0], 0.5)):
        assert (tar.adaptive_staleness_cap(lat, ivl)
                == jar.adaptive_staleness_cap(lat, ivl))
    from fedml_tpu.arguments import Arguments as JArguments
    for kw in ({}, dict(async_alpha=0.0, async_staleness_poly=0.0,
                        async_hinge_b=0, async_staleness_cap=0),
               dict(async_staleness_weighting="hinge",
                    async_staleness_cap=5000)):
        ta, ja = Arguments(**kw), JArguments(**kw)
        assert (tar.weighting_knobs_from_args(ta)
                == jar.weighting_knobs_from_args(ja))
        assert tar.merge_alpha_from_args(ta) == jar.merge_alpha_from_args(ja)
        assert (tar.staleness_cap_from_args(ta)
                == jar.staleness_cap_from_args(ja))


@pytest.mark.parametrize("seed,sigma", [(0, 0.6), (3, 0.0), (2**31 + 5, 1.3)])
def test_durations_equal_reference(seed, sigma):
    np.testing.assert_array_equal(tar.client_durations(40, seed, sigma),
                                  jar.client_durations(40, seed, sigma))
    from fedml_tpu.arguments import Arguments as JArguments
    kw = dict(random_seed=seed, async_duration_sigma=sigma)
    np.testing.assert_array_equal(
        tar.durations_from_args(12, Arguments(**kw)),
        jar.durations_from_args(12, JArguments(**kw)))
    for base, ws in ((2.0, 1.0), (2.0, 0.4), (3.5, 0.0), (1.5, 2.0)):
        assert (tar.faulted_duration(base, ws)
                == jar.faulted_duration(base, ws))


def test_buffer_order_counters_and_state_equal_reference():
    rng = np.random.default_rng(4)
    bt, bj = tar.UpdateBuffer(3), jar.UpdateBuffer(3)
    adds = [(int(c), float(w), int(v), float(t)) for c, w, v, t in zip(
        rng.integers(0, 9, 5), rng.uniform(1, 5, 5), rng.integers(0, 3, 5),
        np.round(rng.uniform(0, 4, 5), 1))]
    adds.append((8, 1.0, 0, adds[0][3]))           # an exact-time tie
    for i, (c, w, v, t) in enumerate(adds):
        bt.add(c, torch.full((2,), float(i)), w, v, t)
        bj.add(c, np.full((2,), float(i), np.float32), w, v, t)
    st_t = bt.state_dict(encode=lambda u: u.numpy(), vec_dim=2)
    st_j = bj.state_dict(encode=np.asarray, vec_dim=2)
    for k in st_j:
        np.testing.assert_array_equal(st_t[k], st_j[k])

    def order(entries):
        return [(e.client_id, e.seq, e.arrival_t, e.staleness(3))
                for e in entries]

    got_t, got_j = bt.pour(3), bj.pour(3)
    assert order(got_t) == order(got_j)
    assert bt.counters == bj.counters == {"added": 6, "poured": 3,
                                          "buffered": 3}
    back_t, back_j = tar.UpdateBuffer(3), jar.UpdateBuffer(3)
    back_t.load_state_dict(st_t, decode=torch.from_numpy)
    back_j.load_state_dict(st_j, decode=np.asarray)
    assert order(back_t._entries) == order(back_j._entries)
    assert len(back_t) == 6
    assert back_t.counters == {"added": 6, "poured": 0, "buffered": 6}
    empty = tar.UpdateBuffer(3).state_dict(encode=lambda u: u.numpy(),
                                           vec_dim=2)
    assert empty["mat"].shape == st_t["mat"].shape == (6, 2)
    assert float(empty["mask"].sum()) == 0.0


def test_round_mode_and_buffer_k_equal_reference():
    from fedml_tpu.arguments import Arguments as JArguments
    for kw, conc in ((dict(), 8), (dict(async_buffer_k=3), 8),
                     (dict(async_buffer_k=0), 1)):
        assert (tar.buffer_k_from_args(Arguments(**kw), conc)
                == jar.buffer_k_from_args(JArguments(**kw), conc))
    with pytest.raises(ValueError, match="exceeds"):
        tar.buffer_k_from_args(Arguments(async_buffer_k=9), 8)
    with pytest.raises(ValueError, match="unknown"):
        tar.round_mode_from_args(Arguments(round_mode="semi_sync"))
    assert tar.round_mode_from_args(Arguments()) == "sync"


# --- the engine against the JAX engine ---------------------------------------

@pytest.mark.parametrize("extra", [
    {}, dict(CHAOS),
    dict(federated_optimizer="FedOpt", server_optimizer="adam",
         server_lr=0.01),
    dict(CHAOS, federated_optimizer="SCAFFOLD"),
    dict(CHAOS, client_num_per_round=4, async_buffer_k=2,
         async_staleness_weighting="hinge", async_hinge_b=1, comm_round=6)],
    ids=["plain", "chaos", "fedopt_adam", "scaffold", "rotation_4_of_8"])
def test_engine_matches_jax_pour_by_pour(extra):
    cfg = dict(ASYNC, **extra)
    p0 = flax_to_state_dict(jax_init(cfg))
    js, ts = jax_sim(cfg), port_sim(cfg, init_params=p0)
    assert type(ts).__name__ == type(js).__name__ == "AsyncBufferedSimulator"
    hj, ht = hypers(cfg)
    js._bootstrap(hj)
    ts._bootstrap(ht)
    for _ in range(cfg["comm_round"]):
        a, b = js._pour_step(hj), ts._pour_step(ht)
        assert (a["poured"], a["staleness_mean"], a["staleness_max"]) == \
            (b["poured"], b["staleness_mean"], b["staleness_max"])
        assert js.virtual_t == ts.virtual_t
        assert_params_close(ts.params, jax_params(js.params))
        np.testing.assert_allclose(
            float(b["metrics"]["loss_sum"]),
            float(jax.device_get(a["metrics"]["loss_sum"])),
            rtol=RTOL, atol=ATOL)
    assert pours(ts) == pours(js)
    assert list(ts._idle) == list(js._idle)
    assert ts.buffer.counters == js.buffer.counters
    if "server_optimizer" in extra:
        # adam's moments took the undamped pseudo-gradient, its count
        # every real pour
        st = ts.server_state["opt_state"]
        assert int(st["count"]) == cfg["comm_round"]
    if extra.get("federated_optimizer") == "SCAFFOLD":
        c_j = jax_params(js.server_state["c"])
        assert_params_close(ts.server_state["c"], c_j)


def test_resnet20_fused_block_pours_match_jax():
    """ResNet-20 with the fused conv block (B1's plain version on the CPU,
    what chip_smoke's phase 10 holds the card's kernel to) against the JAX
    engine's XLA reference block, bootstrap and 2 pours."""
    cfg = dict(dataset="synthetic_cifar10", model="resnet20", batch_size=8,
               client_num_in_total=8, client_num_per_round=8, comm_round=2,
               max_total_samples=64, synthetic_test_size=64, random_seed=3,
               learning_rate=0.01, frequency_of_the_test=-1,
               round_mode="async_buffered", async_buffer_k=4)
    p0 = flax_to_state_dict(jax_init(cfg))
    rj = jax_sim(dict(cfg, fused_conv_block="reference")).run()
    rt = port_sim(dict(cfg, fused_conv_block="pallas"), init_params=p0).run()
    assert_params_close(rt["params"], jax_params(rj["params"]))
    assert [h["virtual_t"] for h in rt["history"]] == \
        [h["virtual_t"] for h in rj["history"]]


def test_run_history_and_result_match_jax():
    cfg = dict(ASYNC, **CHAOS, comm_round=5, frequency_of_the_test=2)
    p0 = flax_to_state_dict(jax_init(cfg))
    rj = jax_sim(cfg).run()
    ts = port_sim(cfg, init_params=p0)
    rt = ts.run()
    keys = ("round", "virtual_t", "poured", "staleness_mean",
            "staleness_max")
    assert [{k: h[k] for k in keys} for h in rt["history"]] == \
        [{k: h[k] for k in keys} for h in rj["history"]]
    for hj, ht in zip(rj["history"], rt["history"]):
        np.testing.assert_allclose(ht["train_loss"], hj["train_loss"],
                                   rtol=RTOL, atol=ATOL)
        assert ("test_acc" in ht) == ("test_acc" in hj)
        if "test_acc" in hj:
            assert ht["test_acc"] == hj["test_acc"]
    for k in ("rounds", "virtual_time_s", "updates_aggregated"):
        assert rt[k] == rj[k], k
    assert_params_close(rt["params"], jax_params(rj["params"]))
    st = rt["async_stats"]
    assert st["dropped"] >= 1 and st["stragglers"] >= 1
    assert st["dispatched"] > st["dropped"]
    assert rt["updates_aggregated"] == sum(h["poured"] for h in rt["history"])
    assert ts.buffer.counters["poured"] == rt["updates_aggregated"]


def test_bootstrap_pour_leaves_server_state_untouched():
    cfg = dict(ASYNC, federated_optimizer="FedOpt", server_optimizer="adam",
               server_lr=0.01)
    sim = port_sim(cfg)
    before = {k: v.clone() for k, v in sim.params.items()}
    count = int(sim.server_state["opt_state"]["count"])
    sim._bootstrap(hypers(cfg)[1])
    assert sim.version == 0 and sim.updates_aggregated == 0
    assert_params_equal(before, sim.params)
    assert int(sim.server_state["opt_state"]["count"]) == count == 0
    assert sim._inflight() == sim.concurrency
    assert len(sim.buffer) == 0


def test_crash_resume_is_bitwise(tmp_path):
    from fedml_tpu_torch.core.chaos import ChaosCrash
    cfg = dict(ASYNC, **CHAOS, comm_round=5, federated_optimizer="SCAFFOLD",
               client_num_per_round=6, async_buffer_k=3)
    full = port_sim(cfg)
    r_full = full.run()
    ck = dict(cfg, checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every_rounds=1, chaos_crash_at_round=2)
    with pytest.raises(ChaosCrash):
        port_sim(ck).run()
    resumed = port_sim(dict(ck, chaos_crash_at_round=None))
    r_res = resumed.run()
    assert [h["round"] for h in r_res["history"]] == [3, 4]
    assert_params_equal(r_full["params"], r_res["params"])
    assert_params_equal(full.client_states["c_i"],
                        resumed.client_states["c_i"])
    assert [h["virtual_t"] for h in r_full["history"][3:]] == \
        [h["virtual_t"] for h in r_res["history"]]
    assert r_res["updates_aggregated"] == r_full["updates_aggregated"]


# --- refusals and dispatch ----------------------------------------------------

@pytest.mark.parametrize("kw,exc,match", [
    (dict(enable_dp=True, dp_type="local_dp"), ValueError, "DP"),
    (dict(contribution_method="loo"), ValueError, "contribution"),
    (dict(enable_defense=True, defense_type="weak_dp"), ValueError,
     "noise-adding"),
    (dict(enable_defense=True, defense_type="crfl"), ValueError,
     "noise-adding"),
    (dict(enable_defense=True, defense_type="krum", sharded_defense=False),
     ValueError, "sharded"),
    (dict(enable_defense=True, defense_type="krum", robust_fused="host"),
     ValueError, "robust_fused"),
    (dict(async_buffer_k=9), ValueError, "exceeds"),
    (dict(federated_optimizer="SCAFFOLD", enable_defense=True,
          defense_type="median"), ValueError, "extras"),
    (dict(backend="sp"), ValueError, "Async_FedAvg"),
    (dict(federated_optimizer="hierarchicalfl"), ValueError,
     "protocol simulator"),
    (dict(federated_optimizer="async_fedavg"), ValueError,
     "protocol simulator"),
    (dict(round_mode="sync", federated_optimizer="Async_FedAvg",
          chaos_dropout_prob=0.2), NotImplementedError,
     "Async_FedAvg loop injects no chaos")],
    ids=["dp", "contribution", "weak_dp", "crfl", "sharded_off",
         "robust_fused_host", "k_too_big", "extras_defended", "sp_backend",
         "protocol_fo", "async_fedavg_fo", "async_fedavg_chaos"])
def test_refusals(kw, exc, match):
    cfg = dict(ASYNC, **kw)
    backend = cfg.pop("backend", "gpu")
    with pytest.raises(exc, match=match):
        port_sim(cfg, backend=backend)


def test_refuses_user_aggregator_and_direct_sync_engine():
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core.algframe.client_trainer import \
        make_trainer_spec
    from fedml_tpu_torch.core.algframe.server_aggregator import \
        ServerAggregator
    from fedml_tpu_torch.optimizers.registry import create_optimizer
    from fedml_tpu_torch.simulation.gpu.engine import GPUSimulator

    class Mean(ServerAggregator):
        def aggregate(self, update_matrix, weights):
            return update_matrix.mean(dim=0)

    with pytest.raises(ValueError, match="ServerAggregator"):
        port_sim(ASYNC, server_aggregator=Mean())
    args = Arguments(**ASYNC)
    fed, out_dim = data.load(args)
    bundle = model.create(args, out_dim, fed.input_shape)
    spec = make_trainer_spec(fed, bundle)
    with pytest.raises(ValueError, match="AsyncBufferedSimulator"):
        GPUSimulator(args, fed, bundle, create_optimizer(args, spec), spec,
                     torch.device("cpu"))
    sim = port_sim(ASYNC)
    with pytest.raises(NotImplementedError, match="barrier"):
        sim.run_rounds_fused(0, 1, hypers(ASYNC)[1])


def test_runner_dispatches_on_round_mode_and_optimizer():
    from fedml_tpu_torch.runner import UNPORTED_KNOBS
    assert "round_mode" not in UNPORTED_KNOBS
    assert type(port_sim(ASYNC)).__name__ == "AsyncBufferedSimulator"
    assert type(port_sim(dict(ASYNC, round_mode="sync"))).__name__ == \
        "GPUSimulator"
    for backend in ("gpu", "sp"):
        sim = port_sim(dict(ASYNC, round_mode="sync",
                            federated_optimizer="Async_FedAvg"),
                       backend=backend)
        assert type(sim).__name__ == "AsyncFedAvgSimulator"
    r = fedml_tpu_torch.run_simulation(device="cpu", **dict(
        ASYNC, comm_round=2))
    assert r["rounds"] == 2 and r["updates_aggregated"] == 8
    assert r["virtual_time_s"] > 0 and np.isfinite(r["final_test_acc"])


@pytest.mark.parametrize("extra", [
    {}, dict(async_staleness_weighting="hinge", async_hinge_b=1,
             async_alpha=0.9, client_num_per_round=5)],
    ids=["polynomial", "hinge"])
def test_sp_async_fedavg_matches_jax(extra):
    cfg = dict(LR_BASE, federated_optimizer="Async_FedAvg", comm_round=7,
               frequency_of_the_test=3, **extra)
    p0 = flax_to_state_dict(jax_init(cfg))
    rj = jax_sim(cfg, backend="sp").run()
    rt = port_sim(cfg, backend="sp", init_params=p0).run()
    assert [h["staleness"] for h in rt["history"]] == \
        [h["staleness"] for h in rj["history"]]
    assert [h.get("test_acc") for h in rt["history"]] == \
        [h.get("test_acc") for h in rj["history"]]
    assert rt["rounds"] == rj["rounds"] == 7
    assert_params_close(rt["params"], jax_params(rj["params"]))


# --- the repairs --------------------------------------------------------------

@pytest.fixture
def obs_defaults():
    from fedml_tpu.core import mlops
    from fedml_tpu.core import obs as jobs
    from fedml_tpu_torch.core import obs as tobs
    yield
    tobs.configure(None)
    tobs.sink.set_sink(None)
    jobs.configure(None)
    mlops.init(fedml_tpu.Arguments(enable_tracking=False))


def _jax_records(tmp_path, run_id, **overrides):
    """Run the JAX package's engine with a JSONL sink; its records."""
    import json
    args = fedml_tpu.Arguments(log_file_dir=str(tmp_path), run_id=run_id,
                               **overrides)
    fedml_tpu.run_simulation(backend="tpu", args=args, **dict(
        LR_BASE, comm_round=1))
    path = os.path.join(str(tmp_path), f"run_{run_id}.jsonl")
    return [json.loads(line) for line in open(path) if line.strip()]


@pytest.mark.parametrize("on", [True, False])
def test_obs_tracing_knob_in_both_packages(tmp_path, obs_defaults, on):
    from fedml_tpu_torch.core.obs import sink
    got = []
    sink.set_sink(got.append)
    fedml_tpu_torch.run_simulation(device="cpu", obs_tracing=on,
                                   **dict(LR_BASE, comm_round=1))
    spans = [r for r in got if r["kind"] == "span"]
    assert bool(spans) == on
    jspans = [r for r in _jax_records(tmp_path, f"tr_{on}", obs_tracing=on)
              if r["kind"] == "span"]
    assert bool(jspans) == on


@pytest.mark.parametrize("on", [True, False])
def test_obs_metrics_knob_in_both_packages(obs_defaults, monkeypatch, on):
    from fedml_tpu.core.obs import metrics as jmetrics
    from fedml_tpu_torch.core.obs import metrics as tmetrics
    # fresh registries for this test only
    monkeypatch.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
    fedml_tpu_torch.init(Arguments(obs_metrics=on))
    fedml_tpu.init(fedml_tpu.Arguments(obs_metrics=on,
                                       enable_tracking=False))
    for m in (tmetrics, jmetrics):
        m.record_pour([0, 1, 3], buffered=2, poured=3)
        m.record_arrival(1.5, rate_mean=0.5)
        m.record_selection("oort", 4, 1)
    snap_t, snap_j = tmetrics.REGISTRY.snapshot(), jmetrics.REGISTRY.snapshot()
    assert bool(snap_t) == bool(snap_j) == on
    if on:
        for name in ("fed_pour_staleness", "fed_buffer_occupancy",
                     "fed_pours_total", "fed_updates_poured_total",
                     "fed_arrival_latency_seconds", "fed_arrival_rate_mean"):
            assert snap_t[name]["values"] == snap_j[name]["values"], name


def test_metrics_flush_cadence_and_pour_records(obs_defaults):
    from fedml_tpu_torch.core.obs import sink
    got = []
    sink.set_sink(got.append)
    r = fedml_tpu_torch.run_simulation(
        device="cpu", obs_metrics_flush_rounds=2, obs_metrics_flush_s=0,
        **dict(ASYNC, **CHAOS, comm_round=5))
    rounds = [x["round_idx"] for x in got if x["kind"] == "round"]
    snaps = [x["step"] for x in got if x["kind"] == "metrics_snapshot"]
    assert rounds == [0, 1, 2, 3, 4]
    assert snaps == [0, 2, 4, 4]       # every 2 rounds, then the final one
    pour_recs = [x for x in got if x["kind"] == "chaos" and "arrivals" in x]
    assert len(pour_recs) == r["rounds"] == 5
    assert [len(x["arrivals"]) for x in pour_recs] == \
        [h["poured"] for h in r["history"]]
    last = [x for x in got if x["kind"] == "metrics_snapshot"][-1]
    assert last["metrics"]["fed_pours_total"]["values"][0]["value"] >= 5


def test_schema_defaults_equal_reference():
    from fedml_tpu.arguments import _SCHEMA as JSCHEMA
    from fedml_tpu_torch.arguments import _SCHEMA as TSCHEMA
    shared = set(JSCHEMA) & set(TSCHEMA)
    for knob in ("dataset", "model", "round_mode", "async_buffer_k",
                 "obs_tracing", "obs_metrics", "obs_metrics_flush_rounds",
                 "obs_metrics_flush_s"):
        assert knob in shared, knob
    assert {k for k in shared if TSCHEMA[k] != JSCHEMA[k]} == {"backend"}
    args = Arguments()
    assert (args.dataset, args.model) == ("synthetic_mnist", "lr")
