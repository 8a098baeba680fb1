"""The port's continuous-batching serving path against the JAX package on
the CPU.

Both packages serve the same tiny causal LM (d 32, 2 layers, 2 heads, seq
64, as ``tests/test_serving_batch.py``): the port's base weights and
adapters are the JAX bundle's, carried across by
``fedml_tpu_torch.interop``. Dense attention on both sides (the JAX
package's CPU default).

- exact: seeded sampling (``sample``) on identical logits rows;
- house tolerance (``rtol=2e-4, atol=2e-5``): the model's ``kv_view``
  path with shared and per-slot adapters, and the logits of
  ``decode_step``, ``prefill_chunk`` and ``prefill_wave``;
- token-identical: each mode of the port against the same mode of the
  JAX package (single mode merges LoRA, batch mode applies it factored,
  so single ≡ batch is pinned only on a full fine-tune), batching never
  changing a request, adapter isolation.

Every engine is closed in a fixture's teardown or a ``finally``; every
wait has a timeout; the HTTP runner binds port 0.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.llm.federated import build_llm_bundle as j_build_bundle
from fedml_tpu.serving.batch import DecodeScheduler as JScheduler
from fedml_tpu.serving.llm_template import CausalLMPredictor as JPredictor
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.llm.federated import build_llm_bundle as t_build_bundle
from fedml_tpu_torch.serving import Overloaded, save_model
from fedml_tpu_torch.serving.batch import AdapterBank as TBank
from fedml_tpu_torch.serving.batch import DecodeScheduler as TScheduler
from fedml_tpu_torch.serving.llm_template import (CausalLMPredictor,
                                                  ChatCompletionRunner)

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
TIMEOUT_S = 60.0
PROMPTS = ["add 2 3", "echo hello world", "x",
           "subtract 19 4 and then explain"]
BATCH = {"slots": 4, "block_size": 16, "prefill_chunk": 8,
         "request_timeout_s": TIMEOUT_S}


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


def _perturbed(tree, seed, scale):
    """``tree`` (nested, numpy) plus seeded normal noise: adapters with a
    NONZERO ``lora_b`` (lora_init zeroes it, which would make every adapter
    a no-op and isolation vacuous), or a full fine-tune's weights."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda l: (np.asarray(l) + scale * rs.randn(*np.shape(l))).astype(
            np.float32), tree)


def _rand_adapter(template, seed, scale=0.3):
    return _perturbed(jax.tree_util.tree_map(np.zeros_like, template), seed,
                      scale)


@pytest.fixture(scope="module")
def base_pair():
    """The JAX LoRA bundle, the port's over the same base, the tokenizer."""
    jb, tok = j_build_bundle(JArguments(**_kw()))
    base = jax.device_get(jb.base_params)
    tb, _ = t_build_bundle(TArguments(**_kw()),
                           base_params=flax_to_state_dict(base))
    return jb, tb, tok, base


@pytest.fixture(scope="module")
def lora_art(base_pair):
    """A LoRA artifact with a nonzero adapter: the JAX tree and the port's
    flat dict."""
    jb, tb, tok, _ = base_pair
    jparams = _rand_adapter(jax.device_get(jb.init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))), 21, scale=0.05)
    return jb, tb, tok, jparams, _tensors(flax_to_state_dict(jparams))


@pytest.fixture(scope="module")
def full_art(base_pair):
    """A full fine-tune artifact (lora_rank 0): the params ARE the model
    (the base moved by seeded noise)."""
    from fedml_tpu.llm.federated import LLMBundle as JBundle
    jb, _, tok, base = base_pair
    jfull = JBundle(jb.module, jb.cfg, None, 0, jb.lora_alpha)
    jparams = _perturbed(base, 1, 0.02)
    tb, _ = t_build_bundle(TArguments(**_kw(lora_rank=0)))
    return jfull, tb, tok, jparams, _tensors(flax_to_state_dict(jparams))


@pytest.fixture(scope="module")
def port_batch(lora_art):
    _, tb, tok, _, tparams = lora_art
    pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                             batch_opts=BATCH, device="cpu")
    yield pred
    pred.close()


def _texts(pred, n=12, **kw):
    return [pred.generate(p, max_new_tokens=n, **kw) for p in PROMPTS]


# ------------------------------------------------------- model kv_view ----

@pytest.fixture(scope="module")
def lm_pairs():
    """A JAX causal LM and the port's with the same weights, as multi-head
    attention and as GQA (one K/V head for two query heads)."""
    from fedml_tpu.llm import model as jmodel
    from fedml_tpu_torch.llm import model as tmodel
    out = {}
    for variant, kv_heads in (("mha", None), ("gqa", 1)):
        kw = dict(vocab_size=259, hidden_size=32, intermediate_size=64,
                  num_layers=2, num_heads=2, max_seq_len=64,
                  num_kv_heads=kv_heads)
        jm, jp = jmodel.init_llm(jmodel.LLMConfig(**kw),
                                 jax.random.PRNGKey(4))
        jp = jax.device_get(jp)
        tm = tmodel.CausalLM(tmodel.LLMConfig(**kw))
        tm.load_state_dict(_tensors(flax_to_state_dict(jp)))
        out[variant] = (jm, jp, tm)
    return out


@pytest.mark.parametrize("variant,adapters", [
    ("mha", "none"), ("mha", "shared"), ("mha", "per_slot"),
    ("gqa", "none")])
def test_kv_view_forward_matches(lora_art, lm_pairs, variant, adapters):
    """The cache-aware forward: the current tokens written into the view at
    their positions (a padded row at the sentinel dropped), cached
    attention, the new K/V returned; adapters shared or per slot."""
    from fedml_tpu.llm.lora import lora_select as jselect
    from fedml_tpu.llm.lora import lora_stack as jstack
    from fedml_tpu_torch.llm.lora import lora_select, lora_stack
    jm, jp, tm = lm_pairs[variant]
    jad = lora_art[3]
    rs = np.random.RandomState(5)
    b, s, t, kvh = 2, 3, 64, tm.cfg.kv_heads
    tokens = rs.randint(0, 200, (b, s)).astype(np.int32)
    positions = np.array([[10, 11, 12], [40, 41, 64]], np.int32)
    views = [(rs.randn(b, t, kvh, 16).astype(np.float32),
              rs.randn(b, t, kvh, 16).astype(np.float32)) for _ in range(2)]
    jadapt = tadapt = None
    if adapters != "none":
        trees = [_rand_adapter(jad, 30 + i, 0.1) for i in range(3)]
        flat = [_tensors(flax_to_state_dict(tr)) for tr in trees]
        idx = np.array([2, 0], np.int32) if adapters == "per_slot" else 1
        jadapt = jselect(jstack(trees), jnp.asarray(idx))
        tadapt = lora_select(lora_stack(flat), torch.from_numpy(
            np.asarray(idx)).long() if adapters == "per_slot" else idx)
    jl, jkv = jm.apply({"params": jp}, jnp.asarray(tokens),
                       positions=jnp.asarray(positions),
                       kv_view=[(jnp.asarray(k), jnp.asarray(v))
                                for k, v in views],
                       adapters=jadapt, lora_scale=4.0)
    with torch.no_grad():
        tl, tkv = tm(torch.from_numpy(tokens),
                     positions=torch.from_numpy(positions),
                     kv_view=[(torch.from_numpy(k), torch.from_numpy(v))
                              for k, v in views],
                     adapters=tadapt, lora_scale=4.0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                                   atol=ATOL)


# ------------------------------------------------- scheduler programs ----

@pytest.fixture(scope="module")
def schedulers(lora_art):
    """A JAX and a port scheduler over the same base and a 3-adapter bank,
    each with the same two requests admitted (one greedy, one sampled)."""
    from fedml_tpu.serving.batch import AdapterBank as JBank
    jb, tb, tok, jad, _ = lora_art
    trees = [_rand_adapter(jad, 40 + i, 0.1) for i in range(2)]
    jbank = JBank(jad, alpha=jb.lora_alpha, capacity=4)
    tbank = TBank(_tensors(flax_to_state_dict(jad)),
                  alpha=tb.lora_alpha, capacity=4)
    for i, tr in enumerate(trees):
        jbank.add(f"a{i}", tr)
        tbank.add(f"a{i}", _tensors(flax_to_state_dict(tr)))
    base = tb.base_params
    js = JScheduler(jb.module, jb.cfg, jb.base_params, jbank, slots=3,
                    block_size=16, prefill_chunk=8, prefill_batch=2)
    ts = TScheduler(tb.module, tb.cfg, base, tbank, slots=3, block_size=16,
                    prefill_chunk=8, prefill_batch=2, device="cpu")
    reqs = [([1] + tok.encode("echo hello world, twice") + [3],
             dict(adapter_idx=1, temperature=0.0, seed=0)),
            ([1] + tok.encode("add 2 3") + [3],
             dict(adapter_idx=2, temperature=0.9, seed=7))]
    firsts = []
    for sched in (js, ts):
        firsts.append([sched.admit(ids, max_new_tokens=8, **o)
                       for ids, o in reqs])
    return js, ts, reqs, firsts


def test_admission_first_tokens_and_state_match(schedulers):
    js, ts, _, firsts = schedulers
    assert firsts[0] == firsts[1]
    for name in ("_active", "_tables", "_pos", "_last", "_temp", "_seed",
                 "_aidx"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    np.testing.assert_allclose(ts._kp.numpy(), np.asarray(js._kp),
                               rtol=RTOL, atol=ATOL)
    assert ts.kv_pool_stats() == js.kv_pool_stats()


def _jax_decode_logits(js):
    """The JAX decode step's logits (its program returns tokens only): the
    same module call on the same gathered views, jitted as the program
    is."""
    from fedml_tpu.llm import kv_cache as jkv
    from fedml_tpu.llm.lora import lora_select
    cc = js.cache_cfg

    def logits_of(params, stack, kp, vp, tables, pos, active, aidx, last):
        views = [(jkv.gather_view(kp[i], tables),
                  jkv.gather_view(vp[i], tables))
                 for i in range(js.cfg.num_layers)]
        q_pos = jnp.where(active, pos, cc.max_blocks_per_slot
                          * cc.block_size)
        logits, _ = js.module.apply(
            {"params": params}, last[:, None], positions=q_pos[:, None],
            kv_view=views, adapters=lora_select(stack, aidx),
            lora_scale=js.bank.scale)
        return logits[:, 0]

    return np.asarray(jax.jit(logits_of)(
        js.params, js._stack(), js._kp, js._vp, jnp.asarray(js._tables),
        jnp.asarray(js._pos), jnp.asarray(js._active),
        jnp.asarray(js._aidx), jnp.asarray(js._last)))


def test_decode_step_logits_and_tokens_match(schedulers):
    js, ts, _, _ = schedulers
    want = _jax_decode_logits(js)
    with torch.no_grad():
        nxt, finite, _, _, row = ts._step_fn(
            ts.params, ts._stack(), ts._kp, ts._vp, ts._dev(ts._tables),
            ts._dev(ts._pos), ts._dev(ts._active), ts._dev(ts._aidx).long(),
            ts._dev(ts._last), *ts._sampling(ts._temp, ts._seed,
                                             ts._pos + 1))
    active = ts._active
    np.testing.assert_allclose(row.numpy()[active], want[active], rtol=RTOL,
                               atol=ATOL)
    assert bool(finite)
    # three steps of both schedulers: the same tokens, the same pools
    for _ in range(3):
        assert ts.step() == js.step()
    np.testing.assert_allclose(ts._vp.numpy(), np.asarray(js._vp),
                               rtol=RTOL, atol=ATOL)


def test_prefill_chunk_and_wave_logits_match(schedulers):
    """The two prefill programs on a fresh slot's row, chunk by chunk,
    without writing: same logits as the JAX programs."""
    js, ts, _, _ = schedulers
    row = np.array([9, 10, 11, 12], np.int32)
    toks = np.array([1, 65, 66, 67, 68, 3, 0, 0], np.int32)
    jl, _, _ = js._prefill_fn(js.params, js._stack(), js._kp, js._vp,
                              jnp.asarray(row), jnp.asarray(toks),
                              jnp.int32(0), jnp.int32(6), jnp.int32(1))
    with torch.no_grad():
        tl, _, _ = ts._prefill_fn(ts.params, ts._stack(), ts._kp, ts._vp,
                                  torch.from_numpy(row),
                                  torch.from_numpy(toks), 0, 6, 1)
    np.testing.assert_allclose(tl.numpy()[:6], np.asarray(jl)[:6],
                               rtol=RTOL, atol=ATOL)
    rows = np.stack([row, np.full(4, 12, np.int32)])
    wtoks = np.stack([toks, np.zeros(8, np.int32)])
    p0, nv, aidx = (np.array([0, 0], np.int32), np.array([6, 0], np.int32),
                    np.array([2, 0], np.int32))
    jl, _, _ = js._prefill_wave_fn(js.params, js._stack(), js._kp, js._vp,
                                   jnp.asarray(rows), jnp.asarray(wtoks),
                                   jnp.asarray(p0), jnp.asarray(nv),
                                   jnp.asarray(aidx))
    with torch.no_grad():
        tl, _, _ = ts._prefill_wave_fn(
            ts.params, ts._stack(), ts._kp, ts._vp, torch.from_numpy(rows),
            torch.from_numpy(wtoks), torch.from_numpy(p0),
            torch.from_numpy(nv), torch.from_numpy(aidx).long())
    np.testing.assert_allclose(tl.numpy()[0, :6], np.asarray(jl)[0, :6],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,position,temp", [
    (0, 1, 0.0), (7, 9, 0.7), (123, 40, 1.0), (2 ** 31 - 1, 63, 1.3),
    (5, 0, 1e-7)])
def test_sample_exact(schedulers, seed, position, temp):
    js, ts, _, _ = schedulers
    rows = np.random.RandomState(seed % 997).randn(
        2, ts.cfg.vocab_size).astype(np.float32) * 3
    for row in rows:
        want = int(js._sample_fn(jnp.asarray(row), jnp.float32(temp),
                                 jnp.int32(seed), jnp.int32(position)))
        got = int(ts._sample_fn(torch.from_numpy(row)[None],
                                *ts._sampling([temp], [seed],
                                              [position]))[0])
        assert got == want


# --------------------------------------------------- token identity ----

def test_batch_greedy_tokens_match_jax_lora(lora_art, port_batch):
    jb, _, tok, jparams, _ = lora_art
    jpred = JPredictor(jb, jparams, tokenizer=tok, mode="batch",
                       batch_opts=BATCH)
    try:
        want = _texts(jpred)
        sampled = jpred.generate("add 4 5", max_new_tokens=10,
                                 temperature=1.2, seed=77)
    finally:
        jpred.close()
    assert _texts(port_batch) == want
    assert port_batch.generate("add 4 5", max_new_tokens=10,
                               temperature=1.2, seed=77) == sampled


def test_single_tokens_match_jax_lora(lora_art):
    jb, tb, tok, jparams, tparams = lora_art
    jsingle = JPredictor(jb, jparams, tokenizer=tok)
    single = CausalLMPredictor(tb, tparams, tokenizer=tok, device="cpu")
    assert _texts(single, n=10) == _texts(jsingle, n=10)
    assert single.generate("x y", max_new_tokens=6, temperature=0.8,
                           seed=3) == jsingle.generate(
        "x y", max_new_tokens=6, temperature=0.8, seed=3)


def test_full_ft_batch_matches_jax_and_port_single(full_art):
    jb, tb, tok, jparams, tparams = full_art
    jpred = JPredictor(jb, jparams, tokenizer=tok, mode="batch",
                       batch_opts=BATCH)
    tpred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                              batch_opts=BATCH, device="cpu")
    try:
        want = _texts(jpred, n=10)
        got = _texts(tpred, n=10)
    finally:
        jpred.close()
        tpred.close()
    single = CausalLMPredictor(tb, tparams, tokenizer=tok, device="cpu")
    assert got == want
    assert _texts(single, n=10) == got


def test_batching_never_changes_a_request(port_batch):
    """A seeded request's output is invariant to what else is in flight:
    solo == submitted alongside 3 concurrent neighbours."""
    solo = port_batch.generate("add 4 5", max_new_tokens=10,
                               temperature=1.2, seed=77)
    with cf.ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(port_batch.generate, "add 4 5",
                          max_new_tokens=10, temperature=1.2, seed=77)]
        futs += [ex.submit(port_batch.generate, f"noise {i} blah blah",
                           max_new_tokens=10, temperature=0.8, seed=i)
                 for i in range(3)]
        crowded = futs[0].result(timeout=TIMEOUT_S)
        for f in futs[1:]:
            f.result(timeout=TIMEOUT_S)
    assert crowded == solo


def test_eight_concurrent_clients_four_slots(port_batch):
    prompts = [f"client {i} says hi" for i in range(8)]
    solo = [port_batch.generate(p, max_new_tokens=8) for p in prompts]
    with cf.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(port_batch.generate, p, max_new_tokens=8)
                for p in prompts]
        crowd = [f.result(timeout=TIMEOUT_S) for f in futs]
    assert crowd == solo
    assert port_batch.engine.health()["status"] == "ok"


def test_adapter_isolation_four_adapter_bank(lora_art):
    """Two requests for two different adapters, side by side in one step,
    each equal their solo runs; the adapters really differ."""
    jb, tb, tok, jad, tparams = lora_art
    bank = TBank(tparams, alpha=tb.lora_alpha, capacity=6)
    for i in range(4):
        bank.add(f"silo_{i}", _tensors(flax_to_state_dict(
            _rand_adapter(jad, 50 + i))))
    pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                             batch_opts=BATCH, adapter_bank=bank,
                             device="cpu")
    try:
        solo = {a: pred.generate("echo hello", max_new_tokens=10, adapter=a)
                for a in ("silo_1", "silo_3")}
        with cf.ThreadPoolExecutor(2) as ex:
            futs = {a: ex.submit(pred.generate, "echo hello",
                                 max_new_tokens=10, adapter=a)
                    for a in solo}
            pair = {a: f.result(timeout=TIMEOUT_S) for a, f in futs.items()}
        assert pair == solo
        assert solo["silo_1"]["text"] != solo["silo_3"]["text"]
        with pytest.raises(KeyError, match="unknown adapter"):
            pred.generate("hi", adapter="nope")
    finally:
        pred.close()


def test_prefix_cache_and_waves_keep_tokens(lora_art, port_batch):
    """The shared-prefix cache and piggybacked prefill change where KV
    lives and how prompts are prefilled, never the tokens."""
    _, tb, tok, _, tparams = lora_art
    sys_p = "you are a helpful assistant. "
    prompts = [sys_p + q for q in ("add 2 3", "echo hi", "x")]
    want = [port_batch.generate(p, max_new_tokens=6) for p in prompts]
    pred = CausalLMPredictor(
        tb, tparams, tokenizer=tok, mode="batch", device="cpu",
        batch_opts=dict(BATCH, prefix_cache=True, prefill_batch=3,
                        suffix_cache=True))
    try:
        first = pred.generate(prompts[0], max_new_tokens=6)
        with cf.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda p: pred.generate(p, max_new_tokens=6),
                              prompts, timeout=TIMEOUT_S))
        state = pred.debug_state()["scheduler"]["prefix_cache"]
    finally:
        pred.close()
    assert [g["text"] for g in got] == [w["text"] for w in want]
    assert first["text"] == want[0]["text"]
    assert state["hits"] >= 1 and state["tokens_reused"] > 0


# ------------------------------------------------------ HTTP and engine ----

def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        return r.status, r.headers, r.read()


def test_chat_runner_over_http(port_batch):
    runner = ChatCompletionRunner(port_batch, port=0)
    port = runner.start()
    try:
        body = {"messages": [{"role": "user", "content": "add 2 3"}],
                "max_tokens": 6, "temperature": 0}
        code, _, raw = _post(port, "/v1/chat/completions", body)
        out = json.loads(raw)
        assert code == 200 and out["object"] == "chat.completion"
        assert out["choices"][0]["message"]["content"] == \
            port_batch.generate("add 2 3", max_new_tokens=6)["text"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=TIMEOUT_S) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=TIMEOUT_S) as r:
            assert b"llm_requests_admitted_total" in r.read()
        code, _, raw = _post(port, "/predict",
                             {"prompt": "x", "max_new_tokens": 3})
        assert code == 200 and "text" in json.loads(raw)
    finally:
        runner.stop()


def test_sse_stream_equals_plain_completion(lora_art, port_batch):
    _, tb, tok, _, tparams = lora_art
    pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                             batch_opts=BATCH, stream=True, device="cpu")
    try:
        stream = pred.chat({"messages": [{"content": "echo hello"}],
                            "max_tokens": 8, "stream": True, "seed": 1})
        frames = list(stream.events)
    finally:
        pred.close()
    text = "".join(f["choices"][0]["delta"].get("content", "")
                   for f in frames)
    assert frames[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert text == port_batch.generate("echo hello", max_new_tokens=8)["text"]


def test_step_failure_resolves_every_waiter(lora_art):
    """An exception in step() fails every in-flight and queued request
    promptly (no waiter wedges), and stop() joins the worker thread."""
    _, tb, tok, _, tparams = lora_art
    pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                             batch_opts=dict(BATCH, slots=1), device="cpu")
    engine = pred.engine

    def boom():
        raise RuntimeError("injected step failure")

    engine.scheduler.step = boom
    try:
        futs = [engine.submit([1, 65, 66, 3], max_new_tokens=4)
                for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="step failed"):
                f.result(timeout=TIMEOUT_S)
    finally:
        pred.close()
    assert not engine._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        engine.submit([1, 2], max_new_tokens=2)


def test_shed_and_unported_knobs_raise(lora_art, monkeypatch, tmp_path):
    _, tb, tok, _, tparams = lora_art
    pred = CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                             batch_opts=dict(BATCH, shed_queue_depth=1),
                             device="cpu")
    try:
        pred.engine.queue_depth = lambda: 5
        with pytest.raises(Overloaded):
            pred.generate("x", max_new_tokens=2)
    finally:
        pred.close()
    # the artifact codec works: from_artifact loads a saved adapter...
    path = str(tmp_path / "a.fmtpu")
    save_model(tparams, path)
    loaded = CausalLMPredictor.from_artifact(TArguments(**_kw()), path,
                                             device="cpu")
    for k, v in tparams.items():
        assert torch.equal(loaded.params[k], v), k
    # ...and refuses the serving-chaos knobs, which are not ported
    with pytest.raises(NotImplementedError, match="chaos_serving_nan"):
        CausalLMPredictor.from_artifact(
            TArguments(**_kw(chaos_serving_nan_at_step=3)), path,
            device="cpu")
    with pytest.raises(NotImplementedError, match="chaos"):
        CausalLMPredictor(tb, tparams, tokenizer=tok, mode="batch",
                          batch_opts=dict(BATCH, chaos=object()),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="roofline"):
        TScheduler(tb.module, tb.cfg, tb.base_params, roofline=True)
    # watch_dir polls a directory (nothing exported there yet) and stops
    bank = TBank(tparams)
    bank.watch_dir(str(tmp_path / "adapters"), poll_s=0.01)
    thread = bank._watch_thread
    assert thread.is_alive()
    bank.stop_watch()
    assert not thread.is_alive() and bank.swaps == 0
    # the entry point runs on CUDA unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CausalLMPredictor(tb, tparams, tokenizer=tok)
