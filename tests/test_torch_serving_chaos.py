"""Serving chaos in the port against the JAX package on the CPU.

Both packages serve the tiny causal LM of ``tests/test_torch_serving.py``
(d 32, 2 layers, 2 heads, seq 64, dense attention), the port's weights
carried across from the JAX bundle by ``fedml_tpu_torch.interop``.

- exact: the injector's decisions (decode faults for steps 0-199,
  connection drops for sends 0-199, the crash-at-request verdicts) and
  the fault ledger's serving records, for the same plans;
- token-identical: a request interrupted by an injected engine reset
  (NaN poison at decode step k, or a stall cut short by the watchdog)
  equals an uninterrupted run of the same engine, on both packages, and
  the port's tokens equal the JAX engine's under the same plan (the JAX
  engine sealed against its decode-write race, which a test of its own
  pins: the fault behind the old batch-serving flip);
- the knobs: ``chaos=`` on the batch engine, ``FedMLInferenceRunner`` and
  ``ChatCompletionRunner``, the ``chaos_serving_*`` knobs through
  ``from_artifact``, the reset budget parking the engine (``/healthz``
  503).

Every engine is closed in a fixture's teardown or a ``finally``; every
wait has a timeout; the HTTP runners bind port 0.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.core import chaos as jchaos
from fedml_tpu.llm.federated import LLMBundle as JBundle
from fedml_tpu.llm.federated import build_llm_bundle as j_build_bundle
from fedml_tpu.serving.llm_template import CausalLMPredictor as JPredictor
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.core import chaos as tchaos
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.llm.federated import build_llm_bundle as t_build_bundle
from fedml_tpu_torch.serving import (FedMLInferenceRunner, FedMLPredictor,
                                     Overloaded, save_model)
from fedml_tpu_torch.serving.llm_template import (CausalLMPredictor,
                                                  ChatCompletionRunner)

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]

TIMEOUT_S = 60.0
# a 1 s watchdog leash: an injected stall of 5 s is cut short by a reset
BATCH = {"slots": 4, "block_size": 16, "prefill_chunk": 8,
         "request_timeout_s": TIMEOUT_S, "watchdog_s": 1.0,
         "max_resets": 8, "max_requeues": 4}
# the greedy request of the repair test: the full fine-tune's prompt "x",
# 12 new tokens; the seeded sampled request of the JAX package's
# test_serving_resilience.py::TestRecoveryDeterminism
GREEDY = dict(prompt="x", max_new_tokens=12)
SAMPLED = dict(prompt="replay me exactly", max_new_tokens=24,
               temperature=1.3, seed=42)
RESET_STEPS = (1, 2, 6)


def _kw(**over):
    kw = dict(dataset="llm_synthetic", model="causal_lm",
              client_num_in_total=2, client_num_per_round=2, comm_round=1,
              epochs=1, batch_size=4, learning_rate=1e-3, random_seed=3,
              llm_hidden_size=32, llm_num_layers=2, llm_num_heads=2,
              llm_intermediate_size=64, llm_max_seq_len=64, lora_rank=4,
              llm_attention_impl="dense")
    kw.update(over)
    return kw


def _tensors(flat):
    return {k: torch.tensor(np.asarray(v)) for k, v in flat.items()}


def sealed_jax(sched):
    """Make a JAX ``DecodeScheduler`` wait for every program it dispatches
    before its ``_dispatch`` returns; returns ``sched``.

    The JAX package's ``step()`` hands its host mirrors (``_pos``,
    ``_tables``, ``_active``) to the decode-write program, dispatched
    asynchronously and not waited for, and then advances ``_pos`` in
    place. On the CPU backend ``jnp.asarray`` aliases a 64-byte-aligned
    numpy array instead of copying it, so a write program that runs late
    (a loaded machine) scatters K/V at the advanced position and later
    tokens differ (ROADMAP Queue C;
    :func:`test_jax_step_write_reads_its_host_mirror_late`). Waiting
    closes that window; what the programs compute is unchanged. The port
    tests that compare against a JAX batch engine or scheduler
    (``test_torch_serving.py``, ``test_torch_adapter_export.py``, this
    file) use a sealed reference."""
    dispatch = sched._dispatch
    sched._dispatch = lambda name, fn, *args: jax.block_until_ready(
        dispatch(name, fn, *args))
    return sched


@pytest.fixture(scope="module")
def full_art():
    """The full fine-tune of ``tests/test_torch_serving.py`` (lora_rank 0,
    the base moved by seeded noise): the JAX bundle and tree, the port's
    bundle and state dict, the tokenizer."""
    jb, tok = j_build_bundle(JArguments(**_kw()))
    base = jax.device_get(jb.base_params)
    rs = np.random.RandomState(1)
    jparams = jax.tree_util.tree_map(
        lambda l: (np.asarray(l) + 0.02 * rs.randn(*np.shape(l))).astype(
            np.float32), base)
    jfull = JBundle(jb.module, jb.cfg, None, 0, jb.lora_alpha)
    tb, _ = t_build_bundle(TArguments(**_kw(lora_rank=0)))
    return jfull, tb, tok, jparams, _tensors(flax_to_state_dict(jparams))


@pytest.fixture(scope="module")
def engines(full_art):
    """One batch predictor per package over the full fine-tune, each
    with its uninterrupted greedy and sampled outputs (no chaos)."""
    jb, tb, tok, jparams, tparams = full_art
    preds = {"jax": JPredictor(jb, jparams, tokenizer=tok, mode="batch",
                               batch_opts=dict(BATCH)),
             "port": CausalLMPredictor(tb, tparams, tokenizer=tok,
                                       mode="batch", batch_opts=dict(BATCH),
                                       device="cpu")}
    # the JAX reference with its decode-write race closed (Queue C; the
    # race itself: test_jax_step_write_reads_its_host_mirror_late)
    sealed_jax(preds["jax"].engine.scheduler)
    try:
        clean = {pkg: {"greedy": _gen(p, GREEDY), "sampled": _gen(p, SAMPLED)}
                 for pkg, p in preds.items()}
        yield preds, clean
    finally:
        for p in preds.values():
            p.close()


def _gen(pred, req):
    req = dict(req)
    return pred.generate(req.pop("prompt"), **req)


def _arm(pred, pkg, plan_kw, at_step=None):
    """Give the predictor's live engine an injector over a fresh plan;
    ``at_step`` counts decode steps from the engine's current one (the
    engine is idle between requests, so the swap is safe)."""
    mod = jchaos if pkg == "jax" else tchaos
    eng = pred.engine
    kw = dict(plan_kw)
    for key in ("serving_nan_at_step", "serving_stall_at_step"):
        if key in kw:
            kw[key] += int(eng.scheduler.steps_run)
    ledger = mod.FaultLedger()
    eng._chaos = mod.ServingChaosInjector(mod.FaultPlan(**kw),
                                          ledger=ledger)
    eng._last_fault_step = -1
    return ledger


# ------------------------------------- the repair: reset at step k ----

@pytest.mark.parametrize("kind", ["greedy", "sampled"])
@pytest.mark.parametrize("k", RESET_STEPS)
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_reset_at_step_replays_uninterrupted(engines, pkg, k, kind):
    """A NaN injected at decode step k forces one controlled reset: the
    in-flight request is requeued as prompt + tokens so far and
    recomputed. Its text, completion tokens and finish reason equal the
    same engine's uninterrupted run (greedy: the full fine-tune's "x",
    12 tokens; sampled: seed 42 at temperature 1.3, 24 tokens)."""
    preds, clean = engines
    pred = preds[pkg]
    resets0 = pred.engine.resets_total
    ledger = _arm(pred, pkg, {"seed": 1, "serving_nan_at_step": k})
    try:
        got = _gen(pred, GREEDY if kind == "greedy" else SAMPLED)
    finally:
        pred.engine._chaos = None
    want = clean[pkg][kind]
    assert [e["kind"] for e in ledger.serving_events()] == ["nan"]
    assert pred.engine.resets_total == resets0 + 1
    assert (got["text"], got["completion_tokens"], got["finish_reason"]) \
        == (want["text"], want["completion_tokens"], want["finish_reason"])


def test_uninterrupted_runs_equal_across_packages(engines):
    _, clean = engines
    assert clean["port"] == clean["jax"]


def _aligned_copy(a):
    """``a`` copied into 64-byte-aligned memory (where the JAX CPU client's
    ``jnp.asarray`` aliases a numpy array instead of copying it)."""
    buf = np.empty(a.nbytes + 64, np.uint8)
    off = (-buf.ctypes.data) % 64
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def test_jax_step_write_reads_its_host_mirror_late(full_art):
    """The fault behind the batch-serving flip (ROADMAP Queue C), pinned
    without load: the JAX scheduler's ``step()`` dispatches its decode
    write with ``jnp.asarray(self._pos)`` — aliased, not copied, when the
    array is 64-byte aligned — does not wait for it, and advances
    ``_pos`` in place. Run late, after ``step()`` has returned (as a
    loaded machine delays it; here the same call with the same arguments,
    made after the return), the write scatters K/V one position on. The
    sealed reference (:func:`sealed_jax`) returns only
    finished outputs, and the port's scheduler, which runs each step to
    its end, fills its pool as the undisturbed JAX run (house
    tolerance)."""
    from fedml_tpu.serving.batch import DecodeScheduler as JScheduler
    from fedml_tpu_torch.llm.data import BOS, SEP
    from fedml_tpu_torch.serving.batch import DecodeScheduler as TScheduler
    jb, tb, tok, jparams, tparams = full_art
    ids = [BOS] + tok.encode("x") + [SEP]

    def jax_scheduler():
        js = JScheduler(jb.module, jb.cfg, jparams, None, slots=4,
                        block_size=16, prefill_chunk=8)
        js._pos = _aligned_copy(js._pos)
        assert jax.numpy.asarray(js._pos).unsafe_buffer_pointer() == \
            js._pos.ctypes.data
        js.admit(ids, max_new_tokens=8)
        return js

    js = jax_scheduler()
    js.step()
    want = np.asarray(jax.block_until_ready(js._kp))
    late = jax_scheduler()
    write, held = late._step_write_fn, []
    late._step_write_fn = lambda *a: (held.append(a), a[:2])[1]
    late.step()                            # returns; _pos advanced
    got = np.asarray(jax.block_until_ready(write(*held[0])[0]))
    assert not np.array_equal(got, want)
    sealed = sealed_jax(jax_scheduler())
    out = sealed._dispatch("probe", jax.jit(lambda x: x + 1),
                           jax.numpy.zeros(4))
    assert out.is_ready()
    sealed.step()
    np.testing.assert_array_equal(np.asarray(sealed._kp), want)
    ts = TScheduler(tb.module, tb.cfg, tparams, None, slots=4,
                    block_size=16, prefill_chunk=8, device="cpu")
    ts.admit(ids, max_new_tokens=8)
    ts.step()
    np.testing.assert_allclose(ts._kp.numpy(), want, rtol=2e-4, atol=2e-5)


# ------------------------------------------- injector and ledger ----

PLANS = [dict(seed=13, serving_stall_at_step=12, serving_stall_s=5.0,
              serving_nan_at_step=25),
         dict(seed=3, serving_stall_prob=0.05, serving_stall_s=0.5,
              serving_nan_prob=0.03, serving_conn_drop_prob=0.1,
              serving_crash_at_request=7),
         dict(seed=17, serving_conn_drop_prob=0.04),
         dict(seed=0, serving_nan_prob=0.5, serving_nan_at_step=0,
              serving_crash_at_request=0),
         dict()]


def _decisions(mod, plan_kw, hard):
    inj = mod.ServingChaosInjector(mod.FaultPlan(**plan_kw), hard_crash=hard)
    faults = [inj.decode_fault(i) for i in range(200)]
    drops = [inj.connection_drop() for _ in range(200)]
    crashes = [inj.request_crash_due() for _ in range(40)]
    return (faults, drops, crashes, inj.stall_s(), inj.snapshot(),
            inj.ledger.serving_events())


@pytest.mark.parametrize("plan_kw", PLANS)
@pytest.mark.parametrize("hard", [False, True])
def test_injector_decisions_and_ledger_equal(plan_kw, hard):
    want = _decisions(jchaos, plan_kw, hard)
    got = _decisions(tchaos, plan_kw, hard)
    assert got == want


@pytest.mark.parametrize("knobs", [
    {}, {"chaos_serving_nan_at_step": 0},
    {"chaos_serving_stall_prob": 0.2, "chaos_serving_stall_s": 1.5,
     "chaos_seed": 9},
    {"chaos_serving_conn_drop_prob": 0.3, "random_seed": 4},
    {"chaos_serving_crash_at_request": 2}])
def test_from_args_equal(knobs):
    """``from_args`` is None with no serving knob live, else the same plan
    (the same first 200 decisions) as the JAX package's."""
    jinj = jchaos.ServingChaosInjector.from_args(JArguments(**knobs))
    tinj = tchaos.ServingChaosInjector.from_args(TArguments(**knobs))
    assert (jinj is None) == (tinj is None) == (not knobs)
    if knobs:
        assert [tinj.decode_fault(i) for i in range(200)] == \
            [jinj.decode_fault(i) for i in range(200)]
        assert [tinj.request_crash_due() for _ in range(20)] == \
            [jinj.request_crash_due() for _ in range(20)]


def test_ledger_serving_records_reach_the_sink():
    from fedml_tpu_torch.core.obs import sink
    recs = []
    sink.set_sink(recs.append, run_id="t")
    try:
        ledger = tchaos.FaultLedger()
        ledger.record_serving("nan", step_idx=3)
        ledger.record_serving("conn_drop", seq=5)
    finally:
        sink.set_sink(None)
    assert ledger.serving_events() == [{"kind": "nan", "step_idx": 3},
                                       {"kind": "conn_drop", "seq": 5}]
    assert [(r["kind"], r["serving"]) for r in recs] == [
        ("chaos", {"kind": "nan", "step_idx": 3}),
        ("chaos", {"kind": "conn_drop", "seq": 5})]


# ------------------------------------------ the engine under chaos ----

STALL_NAN = dict(seed=13, serving_stall_at_step=3, serving_stall_s=5.0,
                 serving_nan_at_step=7)
CONC_PROMPTS = ["add 2 3", "echo hello world", "x",
                "subtract 19 4 and then explain"]


def _concurrent(pred, n=10):
    with cf.ThreadPoolExecutor(len(CONC_PROMPTS)) as ex:
        futs = [ex.submit(pred.generate, p, max_new_tokens=n)
                for p in CONC_PROMPTS]
        return [f.result(timeout=TIMEOUT_S) for f in futs]


def test_stall_and_nan_plan_every_request_completes(engines):
    """A stall at step 3 (cut short by the watchdog's reset: the leash is
    1 s, the stall 5 s) and a NaN at step 7 while four greedy requests are
    in flight: on each package every request completes with the tokens of
    the same engine's chaos-free run, with two resets and the stall seen
    by the watchdog; and the port's outputs equal the JAX engine's."""
    preds, _ = engines
    outs = {}
    for pkg, pred in preds.items():
        eng = pred.engine
        want = _concurrent(pred)
        trips0, resets0 = eng.watchdog.trips, eng.resets_total
        ledger = _arm(pred, pkg, STALL_NAN)
        try:
            got = _concurrent(pred)
        finally:
            eng._chaos = None
        assert got == want, pkg
        assert all(o["finish_reason"] in ("stop", "length") for o in got)
        assert [e["kind"] for e in ledger.serving_events()] == \
            ["stall", "nan"], pkg
        assert eng.resets_total == resets0 + 2, pkg
        assert eng.watchdog.trips >= trips0 + 1, pkg
        assert eng.health()["status"] == "ok", pkg
        outs[pkg] = got
    assert outs["port"] == outs["jax"]


def test_reset_budget_parks_engine_and_healthz_503(full_art):
    """Poison on every step with a budget of one reset: the first reset
    requeues, the second poison parks the engine unhealthy; the request
    resolves "preempted" with the tokens it had, ``/healthz`` answers
    503, and a new request is refused with Overloaded."""
    _, tb, tok, _, tparams = full_art
    inj = tchaos.ServingChaosInjector(
        tchaos.FaultPlan(seed=0, serving_nan_prob=1.0))
    pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                             device="cpu", batch_opts=dict(
                                 BATCH, max_resets=1, chaos=inj))
    runner = ChatCompletionRunner(pred, port=0)
    port = runner.start()
    try:
        out = pred.generate("x", max_new_tokens=12)
        assert out["finish_reason"] == "preempted"
        assert 0 < out["completion_tokens"] < 12
        eng = pred.engine
        assert eng.resets_total == 1 and eng.health()["status"] == "failed"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=TIMEOUT_S)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "failed"
        with pytest.raises(Overloaded):
            pred.generate("x", max_new_tokens=4)
    finally:
        runner.stop()
        pred.close()


# -------------------------------------------------------- the knobs ----

class _Echo(FedMLPredictor):
    def predict(self, request):
        return {"tag": "ok", "echo": request}


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("runner_kind", ["inference", "chat"])
def test_runner_crash_at_request_severs_the_connection(full_art,
                                                       runner_kind):
    """``chaos=`` on the runners: request 2 (0-based) is severed the way a
    killed process would be, the others are served, and the ledger holds
    the one crash."""
    ledger = tchaos.FaultLedger()
    inj = tchaos.ServingChaosInjector(
        tchaos.FaultPlan(seed=2, serving_crash_at_request=2), ledger=ledger)
    pred = None
    if runner_kind == "inference":
        runner = FedMLInferenceRunner(_Echo(), port=0, chaos=inj)
    else:
        _, tb, tok, _, tparams = full_art
        pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                                 batch_opts=dict(BATCH), device="cpu")
        runner = ChatCompletionRunner(pred, port=0, chaos=inj)
    port = runner.start()
    body = {"prompt": "x", "max_new_tokens": 3}
    try:
        served = []
        for i in range(4):
            try:
                served.append(bool(_post(port, "/predict", body)))
            except (urllib.error.URLError, ConnectionError):
                served.append(False)
        assert served == [True, True, False, True]
        assert ledger.serving_events() == [
            {"kind": "replica_crash", "request_idx": 2, "hard": False}]
    finally:
        runner.stop()
        if pred is not None:
            pred.close()


def test_chaos_knobs_reach_the_engine_through_from_artifact(tmp_path,
                                                            full_art):
    """The seven ``chaos_serving_*`` knobs are ported: ``from_artifact``
    gives the engine an injector when one is live (none otherwise), and
    the NaN it schedules resets the engine without changing the text."""
    _, _, _, jparams, _ = full_art
    path = str(tmp_path / "full.fmtpu")
    save_model(_tensors(flax_to_state_dict(jparams)), path)
    base = dict(_kw(lora_rank=0), llm_serving_mode="batch", serving_slots=2)
    off = CausalLMPredictor.from_artifact(TArguments(**base), path,
                                          device="cpu")
    on = CausalLMPredictor.from_artifact(
        TArguments(**base, chaos_serving_nan_at_step=2), path, device="cpu")
    try:
        assert off.engine._chaos is None
        assert on.engine._chaos is not None
        want = off.generate("x", max_new_tokens=8)
        assert on.generate("x", max_new_tokens=8) == want
        assert on.engine.resets_total == 1
    finally:
        off.close()
        on.close()
