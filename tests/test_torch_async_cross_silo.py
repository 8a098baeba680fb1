"""The port's buffered-async cross-silo server against the JAX package's.

* ``AsyncFedMLAggregator`` on the same upload traces as the JAX one, for
  every case of the JAX package's ``test_async_rounds.py::
  TestAsyncAggregator``, ``test_async_robust.py::
  TestCrossSiloDefendedPours`` and ``test_wire.py::TestAsyncEFCarry`` /
  ``::test_async_ef_carry_roundtrip``: undefended pours bitwise (the base
  ring and the buffer are host float32 numpy in both), defended pours
  within the house tolerance with equal verdicts;
* a longer scripted trace (fresh uploads, uploads stale by 1-5 versions,
  one past the ring cap, a ``topk_qsgd`` compressed uplink) undefended
  and krum-defended with a byzantine row;
* an in-proc async LR session that learns with a balanced buffer ledger,
  the same under link faults, and mixed sessions over TCP: a JAX async
  server with port silos and a port async server with JAX silos, at K =
  the cohort (staleness 0: equal to the all-JAX session) and at K 2 (the
  version echo: every upload carries the version its silo was synced
  at).
"""

from __future__ import annotations

import copy
import threading
import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu.cross_silo.horizontal import runner as JR
from fedml_tpu.cross_silo.server import async_server as JAS
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.cross_silo.horizontal import runner as TR
from fedml_tpu_torch.cross_silo.server import async_server as TAS
from fedml_tpu_torch.interop import flax_to_state_dict

from test_torch_comm import free_port_base
from test_torch_cross_silo import (SESSION, _close, _jax_init, _jax_params,
                                   _jax_parts, _port_parts, _run)
from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
ASYNC = dict(round_mode="async_buffered", async_buffer_k=2, async_alpha=1.0,
             async_staleness_cap=4)


def _aggs(global_params, **kw):
    """The JAX and the port aggregator of the same knobs and init."""
    j = JAS.AsyncFedMLAggregator(JArgs(**kw), global_params)
    t = TAS.AsyncFedMLAggregator(Arguments(**kw), global_params,
                                 device="cpu")
    return j, t


def _params(agg):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in agg.global_params.items()}


def _same_state(j, t):
    """Undefended: the same version, base ring and params, bit for bit."""
    assert j.version == t.version
    assert sorted(j._base_ring) == sorted(t._base_ring)
    for v in j._base_ring:
        np.testing.assert_array_equal(t._base_ring[v], j._base_ring[v])
    jp, tp = _params(j), _params(t)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


# --- test_async_rounds.py::TestAsyncAggregator

def _agg_knobs(**kw):
    return dict(client_num_per_round=4, async_staleness_weighting="polynomial",
                async_staleness_poly=1.0, **ASYNC, **kw)


def test_pour_is_staleness_weighted_delta_average():
    j, t = _aggs({"w": np.zeros((2,), np.float32)}, **_agg_knobs())
    trace = [(1, [1.0, 0.0], 1.0, 0, 0.0), (2, [0.0, 1.0], 3.0, 0, 1.0),
             "pour",
             (3, [1.25, 0.75], 1.0, 0, 2.0), (1, [1.25, 0.75], 1.0, 1, 3.0),
             "pour"]
    arrivals = []
    for step in trace:
        if step == "pour":
            a_j, a_t = j.pour(), t.pour()
            assert [a["staleness"] for a in a_t] == \
                [a["staleness"] for a in a_j]
            arrivals.append(a_t)
            _same_state(j, t)
            continue
        rank, w, n, v, at = step
        for agg in (j, t):
            agg.add_async_upload(rank, {"w": np.asarray(w, np.float32)}, n,
                                 up_version=v, arrival_t=at,
                                 compressed=False)
    assert [[a["staleness"] for a in p] for p in arrivals] == [[0, 0], [1, 0]]
    s = 0.5  # (1 + staleness)^-1
    exp = np.asarray([0.25, 0.75]) + (s + 1.0) / 2.0 * (
        s * np.asarray([1.25, 0.75]) + np.asarray([1.0, 0.0])) / (s + 1.0)
    np.testing.assert_allclose(_params(t)["w"], exp, rtol=1e-6)


def test_base_ring_prunes_and_falls_back_to_oldest(caplog):
    j, t = _aggs({"w": np.zeros((2,), np.float32)}, **_agg_knobs())
    for v in range(8):  # 8 pours; cap 4 bounds the ring
        for agg in (j, t):
            agg.add_async_upload(1, {"w": np.full(2, v + 1.0, np.float32)},
                                 1.0, up_version=v, arrival_t=float(v),
                                 compressed=False)
            agg.add_async_upload(2, {"w": np.full(2, -v, np.float32)}, 1.0,
                                 up_version=v, arrival_t=v + 0.5,
                                 compressed=False)
            agg.pour()
    _same_state(j, t)
    assert t.version == 8 and min(t._base_ring) >= 8 - 4
    with caplog.at_level("WARNING"):
        base = t.base_for(0)  # evicted: oldest retained, loudly
    np.testing.assert_array_equal(base, t._base_ring[min(t._base_ring)])
    assert any("base ring" in r.message for r in caplog.records)


def test_refuses_dp_but_composes_with_defenses():
    _, t = _aggs({"w": np.zeros((2,), np.float32)},
                 **_agg_knobs(enable_defense=True, defense_type="krum",
                              byzantine_client_num=1))
    assert t.defender.is_defense_enabled()
    for kw, match in ((dict(enable_dp=True, dp_epsilon=1.0, dp_delta=1e-5,
                            dp_clip=1.0), "async_buffered"),
                      (dict(enable_defense=True, defense_type="weak_dp"),
                       "noise-adding")):
        for pkg_args, cls in ((JArgs, JAS.AsyncFedMLAggregator),
                              (Arguments, TAS.AsyncFedMLAggregator)):
            extra = {} if cls is JAS.AsyncFedMLAggregator else \
                {"device": "cpu"}
            with pytest.raises(ValueError, match=match):
                cls(pkg_args(**_agg_knobs(**kw)),
                    {"w": np.zeros((2,), np.float32)}, **extra)


def test_pour_timeout_never_bottoms_out_at_zero():
    """With neither timeout knob set the liveness valve still arms."""
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    cfg = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
               client_num_per_round=4, comm_round=4,
               training_type="cross_silo", round_mode="async_buffered",
               max_total_samples=64, enable_tracking=False)
    got = []
    for extra in ({}, {"round_timeout_s": 7.0},
                  {"async_pour_timeout_s": 3.0, "round_timeout_s": 7.0}):
        args, fed, bundle = _port_parts(dict(cfg, **extra))
        args.inproc_broker = InProcBroker()
        server = TR.build_server(args, fed, bundle, backend="INPROC",
                                 device="cpu")
        assert isinstance(server, TAS.AsyncFedMLServerManager)
        got.append(server.pour_timeout_s)
    assert got == [TAS.AsyncFedMLServerManager.DEFAULT_POUR_TIMEOUT_S, 7.0,
                   3.0]


def test_aggregator_takes_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TAS.AsyncFedMLAggregator(Arguments(**_agg_knobs()),
                                 {"w": np.zeros((2,), np.float32)})


# --- test_async_robust.py::TestCrossSiloDefendedPours

def _defended_knobs(**kw):
    return dict(client_num_per_round=4, async_staleness_weighting="constant",
                **ASYNC, **kw)


def test_defended_pour_rebases_and_records_verdicts():
    j, t = _aggs({"w": np.zeros((3,), np.float32)},
                 **_defended_knobs(enable_defense=True, defense_type="krum",
                                   byzantine_client_num=1))
    for agg in (j, t):
        agg.add_async_upload(1, {"w": np.asarray([1., 0., 0.], np.float32)},
                             1.0, up_version=0, arrival_t=0.0,
                             compressed=False)
        agg.add_async_upload(2, {"w": np.asarray([1.1, .1, 0.], np.float32)},
                             1.0, up_version=0, arrival_t=1.0,
                             compressed=False)
        agg.pour()
    np.testing.assert_allclose(_params(t)["w"], _params(j)["w"], rtol=RTOL,
                               atol=ATOL)
    v1 = _params(t)["w"].copy()
    up3 = np.asarray([1.0, 0.0, 0.5], np.float32)
    for agg in (j, t):
        agg.add_async_upload(3, {"w": up3}, 1.0, up_version=0,
                             arrival_t=2.0, compressed=False)
        agg.add_async_upload(1, {"w": _params(agg)["w"] + np.asarray(
            [1., 0., 0.], np.float32)}, 1.0, up_version=1, arrival_t=3.0,
            compressed=False)
        agg.pour()
    assert t.version == j.version == 2
    got = _params(t)["w"]
    np.testing.assert_allclose(got, _params(j)["w"], rtol=RTOL, atol=ATOL)
    # krum picked ONE re-based row: the result is v1 + merge_scale * it
    cands = [up3 - v1, np.asarray([1., 0., 0.], np.float32)]
    stal_w = np.asarray(t.staleness_fn(np.asarray([1.0, 0.0])))
    ms = float(np.sum(stal_w)) / 2.0
    assert any(np.allclose(got, v1 + ms * c, rtol=1e-5) for c in cands)
    # the same verdict evidence landed in the silo reputation stream
    for key in ("incl_obs", "excl_obs"):
        np.testing.assert_array_equal(getattr(t.silo_stats, key),
                                      getattr(j.silo_stats, key))
    obs = t.silo_stats.incl_obs + t.silo_stats.excl_obs
    assert float(np.sum(obs)) > 0


def test_silo_reputation_benches_in_select_silos():
    for strategy, want in (("reputation", None), ("uniform", [1, 2, 3])):
        j, t = _aggs({"w": np.zeros((3,), np.float32)},
                     **_defended_knobs(enable_defense=True,
                                       defense_type="krum",
                                       client_selection=strategy))
        for agg in (j, t):
            for _ in range(12):   # brand silo 2 as consistently excluded
                agg.silo_stats.record_verdict([1, 2, 3], [1.0, 0.0, 1.0])
        sel = t.select_silos([1, 2, 3])
        assert sel == j.select_silos([1, 2, 3])
        if want is None:
            assert 2 not in sel and {1, 3} <= set(sel)
        else:
            assert sel == want


def test_defended_refusals():
    for kw, match in ((dict(enable_defense=True, defense_type="weak_dp"),
                       "weak_dp"),
                      (dict(enable_defense=True, defense_type="crfl"),
                       "crfl"),
                      (dict(enable_dp=True, dp_epsilon=1.0, dp_delta=1e-5,
                            dp_clip=1.0), "async_buffered")):
        with pytest.raises(ValueError, match=match):
            TAS.AsyncFedMLAggregator(Arguments(**_defended_knobs(**kw)),
                                     {"w": np.zeros((3,), np.float32)},
                                     device="cpu")


# --- test_wire.py::TestAsyncEFCarry / ::test_async_ef_carry_roundtrip

def test_excluded_row_carried_and_rebased():
    """A defense-excluded compressed sender's re-based row, stored at
    version 0, re-bases onto version 1 to the same target in both."""
    d = 8
    out = []
    for cls in (JAS.AsyncFedMLAggregator, TAS.AsyncFedMLAggregator):
        agg = cls.__new__(cls)
        base0 = np.zeros(d, np.float32)
        base1 = np.full(d, 0.5, np.float32)
        agg._base_ring = {0: base0, 1: base1}
        agg.version = 1
        agg._compressed_senders = {1}
        row = np.full(d, 2.0, np.float32)
        agg._ef_carry = {1: (0, row)}
        base = agg._base_ring[agg.version]
        cv, cres = agg._ef_carry.pop(1)
        rebased = cres - (base - agg.base_for(cv))
        np.testing.assert_allclose(base + rebased, base0 + row)
        out.append(rebased)
    np.testing.assert_array_equal(out[0], out[1])


def test_async_ef_carry_roundtrip(tmp_path):
    """The port's per-sender pour residuals survive a save/restore cycle
    (versions, vectors, compressed-sender set), as the JAX package's do
    (each package reads its own checkpoints)."""
    from fedml_tpu.core.wire import wire_checkpointer as jckpt
    from fedml_tpu_torch.core.wire import wire_checkpointer as tckpt
    d = 16
    carry = np.arange(d, dtype=np.float32)
    got = []
    for cls, ckpt, args_cls in (
            (JAS.AsyncFedMLServerManager, jckpt, JArgs),
            (TAS.AsyncFedMLServerManager, tckpt, Arguments)):
        args = args_cls(checkpoint_dir=str(tmp_path / cls.__module__),
                        checkpoint_every_rounds=1, client_num_in_total=4)

        def stub():
            m = cls.__new__(cls)
            m.args = args
            m.client_num = 4
            m.aggregator = types.SimpleNamespace(
                _base_ring={0: np.zeros(d, np.float32)},
                _ef_carry={}, _compressed_senders=set(), version=0)
            m._wire_ckpt = ckpt(args, "async_server")
            return m

        saver = stub()
        saver.aggregator._ef_carry = {2: (3, carry)}
        saver.aggregator._compressed_senders = {1, 2}
        saver._save_wire_state(5)
        saver._wire_ckpt.close()
        loader = stub()
        loader._restore_wire_state()
        loader._wire_ckpt.close()
        a = loader.aggregator
        assert a._compressed_senders == {1, 2} and set(a._ef_carry) == {2}
        got.append(a._ef_carry[2])
    for cv, cres in got:
        assert cv == 3
        np.testing.assert_array_equal(cres, carry)


# --- a longer scripted trace

def _lr_init(seed=0, d_in=8, d_out=10):
    rng = np.random.RandomState(seed)
    return {"Dense_0": {
        "kernel": (0.1 * rng.randn(d_in, d_out)).astype(np.float32),
        "bias": (0.1 * rng.randn(d_out)).astype(np.float32)}}


def scripted_trace(seed=3, pours=8, k=2, byzantine=None):
    """(rank, version offset, compressed, arrival) per upload: fresh
    uploads, uploads 1-5 versions stale, one past the ring cap (version
    0 at pour 7 under cap 4) and one compressed uplink."""
    rng = np.random.RandomState(seed)
    steps = []
    for p in range(pours):
        for i in range(k):
            lag = 0 if i == 0 else int(rng.randint(0, min(p, 5) + 1))
            if p == pours - 1 and i == k - 1:
                lag = p  # from version 0: past the ring
            steps.append({"rank": 1 + (p * k + i) % 5, "lag": lag,
                          "compressed": p == 2 and i == 0,
                          "byzantine": byzantine is not None
                          and i == byzantine,
                          "t": float(p * k + i)})
        steps.append("pour")
    return steps


def run_trace(j, t, steps, seed=3, scale=0.05):
    """Feed ``steps`` to both aggregators: each upload is its dispatch
    base plus a seeded delta (a byzantine row x 50), the compressed one
    a ``topk_qsgd`` blob of that delta. Returns the pours' arrivals."""
    from fedml_tpu.utils import compression as jcomp
    from fedml_tpu_torch import prng
    from fedml_tpu_torch.utils import compression as tcomp
    rng = np.random.RandomState(seed)
    spec = tcomp.CommCompressionSpec("topk_qsgd", ratio=0.25)
    arrivals = []
    for step in steps:
        if step == "pour":
            a_j, a_t = j.pour(), t.pour()
            assert [(a["client"], a["staleness"]) for a in a_t] == \
                [(a["client"], a["staleness"]) for a in a_j]
            arrivals.append(a_t)
            continue
        v = max(t.version - step["lag"], 0)
        base = t.base_for(v)
        np.testing.assert_array_equal(base, j.base_for(v))
        delta = (scale * rng.randn(base.shape[0])).astype(np.float32)
        if step["byzantine"]:
            delta = delta * np.float32(50.0)
        for agg, pkg in ((j, "jax"), (t, "port")):
            if step["compressed"]:
                blob, _ = tcomp.ef_compress_vec(delta, None, spec,
                                                prng.PRNGKey(5))
                dec = (jcomp.decompress_vec(blob) if pkg == "jax"
                       else tcomp.decompress_vec(blob))
                agg.add_async_upload(step["rank"], dec, 2.0, up_version=v,
                                     arrival_t=step["t"], compressed=True)
            else:
                tree = _jax_tree(j, base + delta)
                payload = tree if pkg == "jax" else {
                    k: torch.from_numpy(v)
                    for k, v in flax_to_state_dict(tree).items()}
                agg.add_async_upload(step["rank"], payload, 2.0,
                                     up_version=v, arrival_t=step["t"],
                                     compressed=False)
    return arrivals


def _jax_tree(j, vec):
    from fedml_tpu.core.collectives import vector_to_tree_like
    return jax.tree_util.tree_map(
        np.asarray, vector_to_tree_like(np.asarray(vec), j.global_params))


@pytest.mark.parametrize("defended", [False, True])
def test_scripted_trace_matches_jax(defended):
    init = _lr_init()
    kw = dict(client_num_per_round=5, round_mode="async_buffered",
              async_buffer_k=4 if defended else 2, async_alpha=0.8,
              async_staleness_weighting="polynomial",
              async_staleness_poly=0.5, async_staleness_cap=4,
              random_seed=11)
    if defended:
        kw.update(enable_defense=True, defense_type="krum",
                  byzantine_client_num=1)
    j = JAS.AsyncFedMLAggregator(JArgs(**kw), init)
    t = TAS.AsyncFedMLAggregator(Arguments(**kw), flax_to_state_dict(init),
                                 device="cpu")
    steps = scripted_trace(k=j.k, byzantine=1 if defended else None)
    arrivals = run_trace(j, t, steps)
    stal = [a["staleness"] for p in arrivals for a in p]
    assert max(stal) >= 5 and t.version == 8
    jp = flax_to_state_dict(jax.device_get(j.global_params))
    tp = _params(t)
    if defended:
        _close(tp, jp)
        for key in ("incl_obs", "excl_obs"):
            np.testing.assert_array_equal(getattr(t.silo_stats, key),
                                          getattr(j.silo_stats, key))
        assert float(np.sum(t.silo_stats.excl_obs)) > 0
    else:
        for k in jp:
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        _same_state_ring(j, t)


def _same_state_ring(j, t):
    assert sorted(j._base_ring) == sorted(t._base_ring)
    for v in j._base_ring:
        np.testing.assert_array_equal(t._base_ring[v], j._base_ring[v])


# --- sessions

ASYNC_SESSION = dict(SESSION, comm_round=12, frequency_of_the_test=3,
                     round_mode="async_buffered", async_pour_timeout_s=20.0)


def _ledger_balances(server):
    c = server.aggregator.buffer.counters
    pours = server.chaos_ledger.pours()
    assert c["added"] == c["poured"] + c["buffered"], c
    assert sum(p["observed"]["poured"] for p in pours) == c["poured"]
    return pours


def test_async_inproc_session_learns():
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    args, fed, bundle = _port_parts(ASYNC_SESSION)
    args.inproc_broker = InProcBroker()
    server = TR.build_server(args, fed, bundle, backend="INPROC",
                             device="cpu")
    clients = [TR.build_client(args, fed, copy.deepcopy(bundle), rank=r,
                               backend="INPROC", device="cpu")
               for r in range(1, 5)]
    r = _run(server, clients)
    assert isinstance(server, TAS.AsyncFedMLServerManager)
    assert len(r["history"]) == 12 and r["final_test_acc"] > 0.6
    pours = _ledger_balances(server)
    assert len(pours) == 12
    assert all("arrivals" in p["injected"] for p in pours)
    assert [t["round"] for t in r["round_times"]] == list(range(12))
    assert all(t["end_s"] >= t["start_s"] for t in r["round_times"])


def test_async_session_under_link_faults_balances():
    """K 2 of 4, the pour-timeout valve and seeded link loss /
    duplication / delay: every pour completes, the buffer ledger
    balances and stale uploads reach the pours."""
    from fedml_tpu_torch.core.distributed.communication.inproc import \
        InProcBroker
    cfg = dict(SESSION, comm_round=16, frequency_of_the_test=8,
               round_mode="async_buffered", async_buffer_k=2,
               async_pour_timeout_s=1.0, chaos_link_loss_prob=0.08,
               chaos_link_dup_prob=0.1, chaos_link_delay_prob=0.1,
               chaos_link_delay_s=0.2, chaos_seed=31)
    args, fed, bundle = _port_parts(cfg)
    args.inproc_broker = InProcBroker()
    server = TR.build_server(args, fed, bundle, backend="INPROC",
                             device="cpu")
    clients = [TR.build_client(args, fed, copy.deepcopy(bundle), rank=r,
                               backend="INPROC", device="cpu")
               for r in range(1, 5)]
    r = _run(server, clients)
    assert len(r["history"]) == 16
    pours = _ledger_balances(server)
    assert len(pours) == 16
    stal = [a["staleness"] for p in pours for a in p["injected"]["arrivals"]]
    assert max(stal) >= 1


def _mixed(server_side, k):
    """A mixed async session over TCP; returns its result, the server and
    each upload's (sender, round tag on the wire, the version the server
    last synced that sender at)."""
    cfg = dict(SESSION, comm_round=6, round_mode="async_buffered",
               async_buffer_k=k, async_pour_timeout_s=20.0,
               tcp_base_port=free_port_base(5))
    jargs, jfed, jbundle = _jax_parts(cfg)
    targs, tfed, tbundle = _port_parts(cfg)
    if server_side == "jax":
        server = JR.build_server(jargs, jfed, jbundle, backend="TCP")
        clients = [TR.build_client(targs, tfed, copy.deepcopy(tbundle),
                                   rank=r, backend="TCP", device="cpu")
                   for r in range(1, 5)]
    else:
        server = TR.build_server(targs, tfed, tbundle, backend="TCP",
                                 device="cpu", init_params=_jax_init(cfg))
        clients = [JR.build_client(jargs, jfed, jbundle, rank=r,
                                   backend="TCP") for r in range(1, 5)]
    tags = []
    handler = server.handle_message_receive_model_from_client

    def spy(msg):
        sender = msg.get_sender_id()
        tags.append((sender, msg.get("round_idx"),
                     server._outstanding.get(sender)))
        handler(msg)

    server.handle_message_receive_model_from_client = spy
    return _run(server, clients), server, tags


@pytest.fixture(scope="module")
def jax_async_k4():
    """The all-JAX in-proc async session at K = the cohort."""
    cfg = dict(SESSION, comm_round=6, round_mode="async_buffered",
               async_buffer_k=4, async_pour_timeout_s=20.0)
    args, fed, bundle = _jax_parts(cfg)
    return JR.run_cross_silo_inproc(args, fed, bundle)


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_mixed_async_session_at_full_k_matches_jax(jax_async_k4,
                                                   server_side):
    """K = 4 of 4: every pour holds the four fresh uploads (staleness 0),
    so the session ends at the all-JAX session's params whatever the
    order of arrival (up to the float order of the pour's sum)."""
    got, _, _ = _mixed(server_side, 4)
    params = (_jax_params(got) if server_side == "jax" else
              {k: v.numpy() for k, v in got["params"].items()})
    _close(params, _jax_params(jax_async_k4))
    assert len(got["history"]) == 6
    assert all(h["staleness_max"] == 0 for h in got["history"])


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_mixed_async_session_echoes_versions(server_side):
    """K 2 of 4: every upload carries, on the wire, the version its silo
    was synced at (the round tag that is the server's staleness signal;
    a silo that omits it would read as fresh), and the pours' records
    carry those dispatch versions."""
    got, server, tags = _mixed(server_side, 2)
    assert len(got["history"]) == 6
    assert len(tags) >= 12
    for sender, tag, synced in tags:
        assert tag is not None, sender
        if synced is not None:   # not a duplicate of a consumed upload
            assert int(tag) == int(synced), (sender, tag, synced)
    pours = server.chaos_ledger.pours()
    for p in pours:
        for a in p["injected"]["arrivals"]:
            assert a["dispatch_version"] <= p["round_idx"]
            assert a["staleness"] == p["round_idx"] - a["dispatch_version"]
    assert sum(len(p["injected"]["arrivals"]) for p in pours) >= 12
