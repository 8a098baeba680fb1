"""The port's serving fleet (``serving/autoscale.py``: policies, Gateway,
ReplicaSet, subprocess replicas) against the JAX package on the CPU.

- exact: each policy's ``desired_replicas`` / ``desired_from_fleet`` /
  ``breaches`` over a seeded trace, the Gateway's routing digest, the
  replica each request lands on around a dead replica, the connection
  drops the gateway's chaos plan injects (ledgered, every request still
  served), the load generator's schedule and prompts;
- behaviour: a rolling update with zero failed requests, the SLO
  autoscaler scaling up on a queue breach, an in-process fleet of the
  tiny LM (d 32, 2 layers) routing follow-ups warm and serving a
  predictor's own tokens, and one subprocess replica on the CPU crashing
  at its request 1: the gateway fails over and ``health_check`` starts a
  new process.

Every replica set is stopped in a ``finally``; every wait has a timeout;
every server binds port 0.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.core import chaos as jchaos
from fedml_tpu.core.distributed.communication import backoff as jbackoff
from fedml_tpu.serving import FedMLPredictor as JPredictorBase
from fedml_tpu.serving import autoscale as jauto
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.core import chaos as tchaos
from fedml_tpu_torch.core.distributed.communication import backoff as tbackoff
from fedml_tpu_torch.serving import FedMLPredictor as TPredictorBase
from fedml_tpu_torch.serving import autoscale as tauto
from fedml_tpu_torch.serving import save_model
from fedml_tpu_torch.serving.llm_template import (CausalLMPredictor,
                                                  ChatCompletionRunner)

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch_port, pytest.mark.serving]

TIMEOUT_S = 60.0
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jauto, jchaos, JPredictorBase),
        "port": (tauto, tchaos, TPredictorBase)}


def _echo_cls(base):
    class Echo(base):
        def __init__(self, tag="v1", health=None):
            self.tag = tag
            self._health = health

        def predict(self, request):
            return {"tag": self.tag, "echo": request}

        def health(self):
            return dict(self._health or {"status": "ok"})

    return Echo


# -------------------------------------------------------- policies ----

def _trace(n=200, seed=0):
    rs = np.random.RandomState(seed)
    qps = np.abs(rs.lognormal(2.0, 1.0, n))
    lat = np.abs(rs.lognormal(-2.0, 1.0, n))
    cur = rs.randint(1, 9, n)
    fleet = [dict(ttft_p99_s=float(rs.lognormal(-1.5, 1.0)),
                  itl_p99_s=float(rs.lognormal(-4.0, 1.0)),
                  queue_depth=int(rs.poisson(6) * (rs.rand() < 0.7)),
                  kv_headroom_min=(None if rs.rand() < 0.2
                                   else int(rs.randint(0, 5))),
                  gateway_p99_s=float(rs.lognormal(-1.0, 1.0)),
                  replicas=int(c)) for c in cur]
    return qps, lat, cur, fleet


def _policies(auto):
    return [auto.EWMPolicy(target_qps_per_replica=7.0, alpha=0.3),
            auto.ConcurrencyPolicy(target_concurrency=3.0),
            auto.ConcurrencyPolicy(target_concurrency=2.0,
                                   latency_signal="p99"),
            auto.LookbackPolicy(target_qps_per_replica=9.0, window=6),
            auto.LookbackPolicy(target_qps_per_replica=9.0, window=4,
                                max_latency_s=0.2),
            auto.SLOPolicy(ttft_p99_s=0.3, itl_p99_s=0.02,
                           queue_depth_per_replica=4.0, kv_headroom_min=1,
                           cooldown_s=0.0),
            auto.SLOPolicy(ttft_p99_s=0.0, queue_depth_per_replica=0.0,
                           kv_headroom_min=2, cooldown_s=0.0)]


def _policy_outputs(auto):
    qps, lat, cur, fleet = _trace()
    out = []
    for pol in _policies(auto):
        rows = []
        for q, l, c, f in zip(qps, lat, cur, fleet):
            row = [pol.desired_replicas(float(q), float(l), int(c))]
            if isinstance(pol, auto.SLOPolicy):
                view = auto.FleetSLOView(**f)
                row += [pol.breaches(view, int(c)),
                        pol.desired_from_fleet(view, int(c))]
            rows.append(row)
        out.append(rows)
    return out


def test_policy_outputs_equal():
    assert _policy_outputs(tauto) == _policy_outputs(jauto)


def test_slo_policy_cooldown_holds_the_count():
    pol = tauto.SLOPolicy(queue_depth_per_replica=1.0, cooldown_s=60.0)
    busy = tauto.FleetSLOView(queue_depth=10, replicas=2)
    assert pol.desired_from_fleet(busy, 2) == 3
    assert pol.desired_from_fleet(busy, 3) == 3   # inside the cooldown


def test_gateway_metrics_unpack_as_the_legacy_pair():
    m = tauto.GatewayMetrics(qps=2.0, latency_s=0.5, p50=0.4, p99=0.9,
                             count=3)
    qps, lat = m
    assert (qps, lat, m.signal("p99")) == (2.0, 0.5, 0.9)


# ------------------------------------------------------- the gateway ----

DIGEST_REQUESTS = [
    {"messages": [{"role": "system", "content": "You are tenant 3. " * 20},
                  {"role": "user", "content": "hello"}]},
    {"messages": [{"role": "user", "content": "short"}]},
    {"messages": [{"content": "a"}, "not a dict", {"content": "ünïcödé"}]},
    {"prompt": "add 2 3"}, {"inputs": [[1, 2, 3]]}, {"prompt": ""},
    {"messages": []}, {}]


@pytest.mark.parametrize("digest_chars", [8, 128])
def test_routing_digest_equal(digest_chars):
    jgw = jauto.Gateway(None, cache_aware=True, digest_chars=digest_chars)
    tgw = tauto.Gateway(None, cache_aware=True, digest_chars=digest_chars)
    for req in DIGEST_REQUESTS:
        assert tgw._routing_digest(req) == jgw._routing_digest(req), req


def _serve_around_dead(pkg):
    auto, _, base = PKGS[pkg]
    echo = _echo_cls(base)
    made = []

    def factory():
        made.append(echo(tag=f"r{len(made)}"))
        return made[-1]

    rs = auto.ReplicaSet(factory, min_replicas=3, max_replicas=3)
    gw = auto.Gateway(rs, window_s=5.0, backoff_seed=0,
                      unhealthy_ttl_s=30.0, max_failovers=3)
    try:
        rs.replicas[1].stop()          # dead but still in the set
        tags = [gw.predict({"i": i}, timeout=TIMEOUT_S)["tag"]
                for i in range(9)]
        return tags, gw._is_quarantined(rs.replicas[1].port)
    finally:
        rs.stop()


def test_failover_around_a_dead_replica_equal():
    """A replica whose server died while still in the set: the gateway
    quarantines it on the failed connect and serves every request from
    its siblings, landing each on the same replica as the JAX gateway."""
    tags, quarantined = _serve_around_dead("port")
    assert (tags, quarantined) == _serve_around_dead("jax")
    assert "r1" not in tags and len(tags) == 9 and quarantined


def _serve_through_drops(pkg):
    auto, chaos, base = PKGS[pkg]
    ledger = chaos.FaultLedger()
    inj = chaos.ServingChaosInjector(
        chaos.FaultPlan(seed=5, serving_conn_drop_prob=0.4), ledger=ledger)
    rs = auto.ReplicaSet(_echo_cls(base), min_replicas=2, max_replicas=2)
    gw = auto.Gateway(rs, window_s=5.0, backoff_seed=0, chaos=inj,
                      unhealthy_ttl_s=0.05, max_failovers=6)
    try:
        outs = [gw.predict({"i": i}, timeout=TIMEOUT_S)["echo"]["i"]
                for i in range(12)]
        return outs, ledger.serving_events(), inj.snapshot()["gateway_seq"]
    finally:
        rs.stop()


def test_connection_drops_are_retried_and_ledgered_equal():
    """The gateway's seeded connection drops (probability 0.4) fail over
    instead of surfacing; the ledger holds the same drops, send for send,
    as the JAX gateway's."""
    got = _serve_through_drops("port")
    assert got == _serve_through_drops("jax")
    outs, drops, sends = got
    assert outs == list(range(12))
    assert drops and all(e["kind"] == "conn_drop" for e in drops)
    assert sends == 12 + len(drops)


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=7, base_s=0.05, factor=2.0, max_s=0.5),
    dict(jitter=False, base_s=0.1, factor=3.0, max_s=1.0)])
def test_backoff_delays_equal(kw):
    """The gateway's failover delays (``backoff_delays``) equal the JAX
    package's, delay for delay, jittered from a seed or not."""
    got = [d for d, _ in zip(tbackoff.backoff_delays(**kw), range(40))]
    assert got == [d for d, _ in zip(jbackoff.backoff_delays(**kw),
                                     range(40))]
    assert all(0.0 <= d <= kw.get("max_s", 2.0) for d in got)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_rolling_update_zero_failed_requests(pkg):
    """Traffic keeps flowing through the gateway while every replica is
    replaced by one built from the new factory, new-up-and-ready before
    old-down: no request fails, and the fleet ends on the new version."""
    auto, _, base = PKGS[pkg]
    echo = _echo_cls(base)
    rs = auto.ReplicaSet(lambda: echo("v1"), min_replicas=2, max_replicas=2)
    gw = auto.Gateway(rs, window_s=5.0, backoff_seed=0, max_failovers=4)
    stop = threading.Event()
    results, errors = [], []

    def traffic():
        while not stop.is_set():
            try:
                results.append(gw.predict({"x": 1}, timeout=TIMEOUT_S)["tag"])
            except Exception as e:  # noqa: BLE001 — counted, asserted on
                errors.append(repr(e))
            time.sleep(0.005)

    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    try:
        time.sleep(0.2)
        rs.rolling_update(lambda: echo("v2"))
        time.sleep(0.2)
    finally:
        stop.set()
        th.join(timeout=TIMEOUT_S)
        after = [gw.predict({"x": 1}, timeout=TIMEOUT_S)["tag"]
                 for _ in range(4)]
        rs.stop()
    assert not errors, errors[:3]
    assert "v1" in results and "v2" in results
    assert after == ["v2"] * 4


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_slo_autoscaler_scales_up_on_queue_breach(pkg):
    """Replicas whose ``/healthz`` reports a deep queue: one autoscaler
    step scrapes the fleet, the SLO policy breaches on queue depth and
    the set grows by one replica (one scale event)."""
    auto, _, base = PKGS[pkg]
    echo = _echo_cls(base)
    health = {"status": "ok", "queue_depth": 9,
              "slo": {"ttft_p99_s": 0.1, "ttft_n": 4, "itl_p99_s": 0.01,
                      "itl_n": 4, "kv_headroom_requests": 3}}
    rs = auto.ReplicaSet(lambda: echo(health=health), min_replicas=2,
                         max_replicas=4)
    gw = auto.Gateway(rs, window_s=5.0)
    asc = auto.Autoscaler(gw, auto.SLOPolicy(queue_depth_per_replica=4.0,
                                             cooldown_s=0.0))
    try:
        assert asc.step() == 3
        assert asc.scale_events == 1 and len(rs) == 3
        view = asc.last_fleet
        assert (view.queue_depth, view.kv_headroom_min, view.replicas) == \
            (18, 3, 2)
    finally:
        rs.stop()
    if pkg == "port":
        from fedml_tpu_torch.core.obs import metrics
        text = metrics.REGISTRY.exposition()
        assert "serving_fleet_scale_events_total" in text
        assert "serving_fleet_replicas" in text


# ------------------------------------------------- LLM replicas ----

def _kw(**over):
    kw = dict(dataset="llm_synthetic", model="causal_lm",
              client_num_in_total=2, client_num_per_round=2, comm_round=1,
              epochs=1, batch_size=4, learning_rate=1e-3, random_seed=3,
              llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
              llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=4,
              llm_attention_impl="dense")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def lora_artifact(tmp_path_factory):
    """A saved LoRA artifact (a seeded, nonzero adapter of the tiny LM at
    seq 128, room for a two-turn chat) and the config that serves it in
    batch mode."""
    from fedml_tpu_torch.llm.federated import build_llm_bundle
    from fedml_tpu_torch.llm.lora import lora_init
    args = TArguments(**_kw(llm_max_seq_len=128,
                            llm_serving_mode="batch", serving_slots=4,
                            serving_kv_block_size=16,
                            serving_prefill_chunk=8,
                            serving_request_timeout_s=TIMEOUT_S))
    bundle, _ = build_llm_bundle(args)
    g = torch.Generator().manual_seed(0)
    adapter = {k: 0.05 * torch.randn(v.shape, generator=g)
               for k, v in lora_init(g, bundle.base_params, rank=4).items()}
    path = str(tmp_path_factory.mktemp("fleet") / "lora.fmtpu")
    save_model(adapter, path)
    return args, path


CHAT = {"messages": [{"role": "user", "content": "add 2 3"}],
        "max_tokens": 6, "temperature": 0}


def test_inprocess_llm_fleet_routes_warm_and_serves_own_tokens(
        lora_artifact):
    """Two in-process replicas of the tiny LM behind a cache-aware
    gateway: three two-turn sessions, each follow-up carrying the first
    reply. Every answer equals a lone predictor's, the follow-ups land
    warm on their session's replica, and the suffix cache aliases the
    replies."""
    args, path = lora_artifact
    single = CausalLMPredictor.from_artifact(args, path, device="cpu",
                                             mode="single")
    built = []

    def factory():
        built.append(CausalLMPredictor(
            single.bundle, single.params, tokenizer=single.tokenizer,
            mode="batch", device="cpu", batch_opts=dict(
                slots=4, block_size=16, prefill_chunk=8,
                request_timeout_s=TIMEOUT_S, prefix_cache=True,
                suffix_cache=True, prefill_batch=2)))
        return built[-1]

    lone = factory()
    rs = tauto.ReplicaSet(predictor_factory=factory, min_replicas=2,
                          max_replicas=2, runner_cls=ChatCompletionRunner)
    gw = tauto.Gateway(rs, window_s=5.0, backoff_seed=0, cache_aware=True,
                       heal_probe=True, digest_chars=32)
    try:
        for s in range(3):
            # the digest reads the first 32 characters: the tenant's
            # system prompt alone, so every turn of a session shares it
            msgs = [{"role": "system", "content": f"tenant {s} " * 4},
                    {"role": "user", "content": f"session {s}: add 2 3"}]
            for turn in range(2):
                req = {"messages": list(msgs), "max_tokens": 16,
                       "temperature": 0}
                out = gw.predict(req, timeout=TIMEOUT_S,
                                 path="/v1/chat/completions")
                want = lone.chat(dict(req))
                reply = out["choices"][0]["message"]["content"]
                assert reply == want["choices"][0]["message"]["content"]
                msgs += [{"role": "assistant", "content": reply},
                         {"role": "user", "content": f"turn {turn + 1}"}]
        hits = sum(r.predictor.engine.scheduler._index.suffix_hits
                   for r in rs.replicas)
        assert gw.route_counts["warm_hit"] >= 3
        assert gw.route_counts["cold"] == 3
        assert hits >= 1
    finally:
        rs.stop()
        for pred in built:
            pred.close()


def test_subprocess_replica_crash_fails_over_and_heals(lora_artifact,
                                                       tmp_path):
    """Two subprocess replicas on the CPU serve the saved LoRA artifact;
    the first carries ``chaos_serving_crash_at_request: 1``. Its request
    1 exits the process (code 23) mid-request: the gateway fails over to
    the sibling (every request answered), and ``health_check`` replaces
    the dead replica with a new process serving the same tokens."""
    args, path = lora_artifact
    crash_args = TArguments(**dict(vars(args),
                                   chaos_serving_crash_at_request=1))
    factories = [tauto.subprocess_replica_factory(
        a, path, output_dim=0, workdir=str(tmp_path / tag), device="cpu",
        kind="causal_lm") for a, tag in ((crash_args, "crash"),
                                          (args, "ok"))]
    made = []

    def factory():
        made.append(factories[min(len(made), 1)]())
        return made[-1]

    want = CausalLMPredictor.from_artifact(args, path, device="cpu")
    rs = tauto.ReplicaSet(replica_factory=factory, min_replicas=2,
                          max_replicas=2)
    gw = tauto.Gateway(rs, window_s=5.0, backoff_seed=0,
                       unhealthy_ttl_s=30.0, max_failovers=3)
    try:
        expect = want.chat(dict(CHAT))["choices"][0]["message"]["content"]
        outs = [gw.predict(dict(CHAT), timeout=TIMEOUT_S,
                           path="/v1/chat/completions")
                for _ in range(3)]
        assert [o["choices"][0]["message"]["content"] for o in outs] == \
            [expect] * 3
        assert made[0].proc.wait(timeout=TIMEOUT_S) == 23
        pids = {r.pid for r in made}
        assert rs.health_check() == 1
        assert len(rs) == 2 and rs.replicas[0].pid not in pids
        out = gw.predict(dict(CHAT), timeout=TIMEOUT_S,
                         path="/v1/chat/completions")
        assert out["choices"][0]["message"]["content"] == expect
    finally:
        rs.stop()
        want.close()
        for r in made:
            r.stop()


def test_replica_asked_for_the_card_without_one_refuses(monkeypatch,
                                                        tmp_path):
    """No fallback: a replica spec asking for CUDA on a host without a
    card raises before anything is served."""
    import json
    import sys
    from fedml_tpu_torch.serving import replica_main
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"args": {}, "params_path": "none",
                                "kind": "causal_lm", "device": "cuda"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["replica_main", str(spec)])
    with pytest.raises(RuntimeError, match="CUDA"):
        replica_main.main()
    factory = tauto.subprocess_replica_factory(
        TArguments(), "model.fmtpu", 1, str(tmp_path / "w"))
    with open(factory().spec_path) as f:
        assert json.load(f)["device"] == "cuda"   # the default


# --------------------------------------------------- load generator ----

def _load_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(_ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


# bench.py's bench_llm_serving_fleet traffic
BENCH_SPEC = dict(tenants=8, sessions_per_tenant=32, turns_per_session=3,
                  seed=0, mean_gap_s=0.002, max_tokens=16, turn_chars=200)


@pytest.mark.parametrize("spec_kw", [
    BENCH_SPEC, dict(tenants=3, sessions_per_tenant=2, turns_per_session=2,
                     seed=5, mean_gap_s=0.0), {}])
def test_load_schedule_and_prompts_equal(spec_kw):
    jload, tload = _load_module("serving_load"), \
        _load_module("serving_load_torch")
    assert tload.build_sessions(tload.LoadSpec(**spec_kw)) == \
        jload.build_sessions(jload.LoadSpec(**spec_kw))


def test_load_run_sends_the_same_requests():
    """``run_load`` plays the same conversations: each request's messages
    and meta, the replies fed back into the next turn."""
    jload, tload = _load_module("serving_load"), \
        _load_module("serving_load_torch")
    spec_kw = dict(tenants=2, sessions_per_tenant=2, turns_per_session=3,
                   seed=1, mean_gap_s=0.0, turn_chars=40)

    def play(mod):
        sent, lock = {}, threading.Lock()

        def send(messages, meta):
            key = (meta["tenant"], meta["session"], meta["turn"])
            with lock:
                sent[key] = (messages, meta)
            return f"reply {key}"

        recs = mod.run_load(send, mod.LoadSpec(**spec_kw), concurrency=3)
        return sent, sorted((r["tenant"], r["session"], r["turn"], r["ok"])
                            for r in recs)

    assert play(tload) == play(jload)
