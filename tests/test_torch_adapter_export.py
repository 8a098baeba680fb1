"""The federated-LoRA adapter export and the adapter bank it feeds, across
the two packages: ``llm/federated.py``'s ``save_adapter_artifacts`` /
``load_adapter_artifacts`` / ``personalize_adapter`` /
``export_silo_adapters`` and ``run_federated_llm``'s export, and
``serving/batch/adapter_bank.py``'s ``from_artifacts`` / ``watch_dir``.

Both packages start from the same flax-drawn base and adapters (carried by
``fedml_tpu_torch.interop``). Written files are byte-equal; personalised
adapters agree within the house tolerance ``rtol=2e-4, atol=2e-5`` (a few
SGD steps of float32 arithmetic in different orders: the port's flash
attention's plain version against the JAX package's dense attention);
greedy tokens served from an exported directory are identical.
"""

from __future__ import annotations

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.llm import federated as jfed
from fedml_tpu.llm import lora as jlora
from fedml_tpu.serving.batch import AdapterBank as JBank
from fedml_tpu.serving.llm_template import CausalLMPredictor as JPredictor
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.llm import federated as tfed
from fedml_tpu_torch.serving.batch import AdapterBank as TBank
from fedml_tpu_torch.serving.llm_template import CausalLMPredictor

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
TIMEOUT_S = 60.0
CFG = dict(dataset="llm_synth", model="causal_lm", client_num_in_total=2,
           client_num_per_round=2, comm_round=1, epochs=1, batch_size=8,
           learning_rate=5e-2, llm_corpus_size=48, llm_max_seq_len=48,
           llm_hidden_size=32, llm_num_layers=1, llm_num_heads=2,
           llm_intermediate_size=64, lora_rank=4, random_seed=7,
           frequency_of_the_test=1, llm_adapter_personalize_steps=3)
BATCH = {"slots": 4, "block_size": 16, "prefill_chunk": 8,
         "request_timeout_s": TIMEOUT_S}
PROMPTS = ["add 2 3", "echo hello world", "x"]


def _noisy(tree, seed, scale=0.05):
    """``tree`` plus seeded noise: an adapter whose ``lora_b`` is not zero
    (``lora_init`` zeroes it, which would make every adapter a no-op)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda l: (np.asarray(l) + scale * rs.randn(*np.shape(l))).astype(
            np.float32), tree)


def _tensors(tree):
    return {k: torch.tensor(np.asarray(v))
            for k, v in flax_to_state_dict(tree).items()}


@pytest.fixture(scope="module")
def pair():
    """The JAX build (fed, bundle, spec) and the port's over the JAX base,
    plus a trained-looking global adapter (nested numpy)."""
    jargs = JArguments(backend="tpu", llm_attention_impl="dense", **CFG)
    jbuilt = jfed.build_llm(jargs)[:3]
    base = jax.device_get(jbuilt[1].base_params)
    targs = TArguments(**CFG)
    tbuilt = tfed.build_llm(targs, base_params=flax_to_state_dict(base))[:3]
    key = jax.random.PRNGKey(CFG["random_seed"])
    lora = jlora.lora_init(jax.random.split(key)[0], base,
                           rank=CFG["lora_rank"])
    return jargs, jbuilt, targs, tbuilt, _noisy(jax.device_get(lora), 3)


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_save_adapter_artifacts_byte_equal(tmp_path, pair):
    *_, glob = pair
    adapters = {"global": glob, "silo_0": _noisy(glob, 4),
                "team a/b": _noisy(glob, 5)}
    jfed.save_adapter_artifacts(adapters, str(tmp_path / "j"), lora_rank=4,
                                lora_alpha=16.0)
    tfed.save_adapter_artifacts(
        {k: _tensors(v) for k, v in adapters.items()}, str(tmp_path / "t"),
        lora_rank=4, lora_alpha=16.0)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert manifest["format"] == "fedml_tpu_adapter_bank_v1"
    assert manifest["adapters"]["team a/b"] == "team_a_b.fmtpu"
    for loaded in (jfed.load_adapter_artifacts(str(tmp_path / "t")),
                   tfed.load_adapter_artifacts(str(tmp_path / "j"))):
        assert sorted(loaded) == sorted(adapters)
        for name, tree in adapters.items():
            got = flax_to_state_dict(loaded[name])
            for k, v in flax_to_state_dict(tree).items():
                np.testing.assert_array_equal(got[k], v)


def test_safe_name_keeps_files_inside_the_dir(tmp_path, pair):
    *_, glob = pair
    for name in ("../escape", "a/../../b", "..", "ok-name_1.2"):
        assert tfed._safe_name(name) == jfed._safe_name(name)
        assert "/" not in tfed._safe_name(name)
    for mod in (tfed, jfed):
        with pytest.raises(ValueError, match="empty"):
            mod._safe_name("")
    out = tmp_path / "export"
    tfed.save_adapter_artifacts({"../escape": _tensors(glob)}, str(out))
    assert sorted(os.listdir(out)) == [".._escape.fmtpu", "manifest.json"]
    assert sorted(os.listdir(tmp_path)) == ["export"]
    (out / "manifest.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not an adapter-bank manifest"):
        tfed.load_adapter_artifacts(str(out))


def _assert_close(got, want):
    got, want = flax_to_state_dict(got), flax_to_state_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_personalize_adapter_matches_jax(pair):
    jargs, (jf, _, jspec), _, (tf, _, tspec), glob = pair
    silo = {k: np.asarray(getattr(jf.train, k)[1]) for k in ("x", "y",
                                                             "mask")}
    want, _ = jfed.personalize_adapter(jspec, glob, silo,
                                       learning_rate=0.05, steps=5)
    got = tfed.personalize_adapter(
        tspec, _tensors(glob), {k: torch.from_numpy(v.copy())
                                for k, v in silo.items()},
        learning_rate=0.05, steps=5)
    _assert_close({k: v.numpy() for k, v in got.items()},
                  jax.device_get(want))
    moved = max(float((got[k] - _tensors(glob)[k]).abs().max())
                for k in got)
    assert moved > 1e-4


def test_export_silo_adapters_matches_jax(tmp_path, pair):
    jargs, jbuilt, targs, tbuilt, glob = pair
    jfed.export_silo_adapters(jargs, str(tmp_path / "j"),
                              result={"params": glob}, prebuilt=jbuilt)
    tfed.export_silo_adapters(targs, str(tmp_path / "t"),
                              result={"params": _tensors(glob)},
                              prebuilt=tbuilt)
    jm = json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert json.loads((tmp_path / "t" / "manifest.json").read_text()) == jm
    assert sorted(jm["adapters"]) == ["global", "silo_0", "silo_1"]
    assert ((tmp_path / "t" / "global.fmtpu").read_bytes()
            == (tmp_path / "j" / "global.fmtpu").read_bytes())
    ja = jfed.load_adapter_artifacts(str(tmp_path / "j"))
    ta = tfed.load_adapter_artifacts(str(tmp_path / "t"))
    for name in ("silo_0", "silo_1"):
        _assert_close(ta[name], ja[name])


def test_run_federated_llm_exports_and_refuses_rank_zero(tmp_path,
                                                         monkeypatch):
    out = tmp_path / "adapters"
    args = TArguments(**dict(CFG, llm_corpus_size=24,
                             llm_adapter_export_dir=str(out)))
    r = tfed.run_federated_llm(args, device="cpu")
    ta = tfed.load_adapter_artifacts(str(out))
    held = r["adapter_export"]["adapters"]
    assert r["adapter_export"]["manifest"] == str(out / "manifest.json")
    assert sorted(ta) == sorted(held) == ["global", "silo_0", "silo_1"]
    assert held["global"] is r["params"]
    for name, tree in ta.items():   # every file reloads bitwise
        for k, v in flax_to_state_dict(tree).items():
            assert torch.equal(torch.from_numpy(np.array(v)),
                               held[name][k]), (name, k)
    assert any(not np.array_equal(flax_to_state_dict(ta["silo_0"])[k],
                                  flax_to_state_dict(ta["global"])[k])
               for k in r["params"])

    def never(*a, **k):
        raise AssertionError("the run started")

    monkeypatch.setattr(tfed, "build_llm", never)
    with pytest.raises(ValueError, match="lora_rank > 0"):
        tfed.run_federated_llm(TArguments(**dict(
            CFG, lora_rank=0, llm_adapter_export_dir=str(out))),
            device="cpu")


def _texts(pred, adapter):
    return [pred.generate(p, max_new_tokens=10, adapter=adapter)["text"]
            for p in PROMPTS]


@pytest.fixture(scope="module")
def exports(tmp_path_factory, pair):
    """A directory exported by the JAX package and one by the port, of the
    same adapters."""
    *_, glob = pair
    adapters = {"global": glob, "silo_0": _noisy(glob, 11, 0.3),
                "silo_1": _noisy(glob, 12, 0.3)}
    d = tmp_path_factory.mktemp("exports")
    jfed.save_adapter_artifacts(adapters, str(d / "j"), lora_rank=4)
    tfed.save_adapter_artifacts({k: _tensors(v) for k, v in
                                 adapters.items()}, str(d / "t"),
                                lora_rank=4)
    return d / "j", d / "t", adapters


def _bank_tokens(sched_cls, bundle, bank, tok, **kw):
    """Greedy tokens of PROMPTS for each of global / silo_0 / silo_1, the
    bank's rows, through a decode scheduler stepped on this thread (no
    engine thread, watchdog or requeue between the two packages)."""
    from fedml_tpu_torch.llm.data import BOS, SEP
    out = {}
    for name in ("global", "silo_0", "silo_1"):
        sched = sched_cls(bundle.module, bundle.cfg, bundle.base_params,
                          bank, slots=len(PROMPTS), block_size=16,
                          prefill_chunk=8, **kw)
        seqs = {}
        for p in PROMPTS:
            slot, first = sched.admit([BOS] + tok.encode(p) + [SEP],
                                      adapter_idx=bank.index(name),
                                      max_new_tokens=10)
            seqs[slot] = [first]
        for _ in range(9):
            for slot, t in sched.step().items():
                seqs[slot].append(int(t))
        out[name] = [seqs[s] for s in sorted(seqs)]
    return out


def test_exported_dirs_serve_the_jax_banks_tokens(pair, exports):
    """Each package's export loads into the other's bank unchanged (names,
    rows and values bitwise) and serves the JAX bank's greedy tokens."""
    from fedml_tpu.serving.batch import DecodeScheduler as JScheduler
    from fedml_tpu_torch.llm.data import ByteTokenizer
    from fedml_tpu_torch.serving.batch import DecodeScheduler as TScheduler
    _, (_, jb, _), _, (_, tb, _), _ = pair
    jdir, tdir, _ = exports
    tok = ByteTokenizer()
    for src, dst in ((jdir, tdir), (tdir, jdir)):
        jbank = JBank.from_artifacts(str(dst), alpha=jb.lora_alpha)
        tbank = TBank.from_artifacts(str(src), alpha=tb.lora_alpha)
        assert tbank.capacity == jbank.capacity == 64
        assert tbank.names() == jbank.names()
        want = flax_to_state_dict(jax.device_get(jbank.stack()))
        got = tbank.stack()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert (_bank_tokens(TScheduler, tb, tbank, tok, device="cpu")
                == _bank_tokens(JScheduler, jb, jbank, tok))
    assert TBank.from_artifacts(str(tdir), capacity=3).capacity == 5


def test_watch_dir_hot_swaps_a_reexport(tmp_path, pair, exports):
    _, _, _, (_, tb, _), glob = pair
    *_, adapters = exports
    d = tmp_path / "watched"
    tfed.save_adapter_artifacts({k: _tensors(v) for k, v in
                                 adapters.items()}, str(d))
    bank = TBank.from_artifacts(str(d), alpha=tb.lora_alpha, capacity=8)
    pred = CausalLMPredictor(tb, _tensors(glob), mode="batch",
                             batch_opts=BATCH, adapter_bank=bank,
                             device="cpu")
    try:
        before = _texts(pred, "silo_0")
        # a request in flight holds its row through the swap
        row = bank.acquire("silo_0")
        held = [h[row].copy() for h in bank._host]
        bank.watch_dir(str(d), poll_s=0.02)
        with pytest.raises(RuntimeError, match="already watching"):
            bank.watch_dir(str(d), poll_s=0.02)
        new = _noisy(adapters["silo_0"], 99, 0.3)
        time.sleep(0.05)   # past the filesystem's mtime tick
        tfed.save_adapter_artifacts({"silo_0": _tensors(new)}, str(d))
        deadline = time.time() + TIMEOUT_S
        while bank.swaps < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert bank.swaps == 1
        assert bank.index("silo_0") != row
        for h, old in zip(bank._host, held):
            np.testing.assert_array_equal(h[row], old)
        bank.release_row(row)
        after = _texts(pred, "silo_0")
        fresh = TBank(_tensors(glob), alpha=tb.lora_alpha, capacity=4)
        fresh.add("silo_0", _tensors(new))
        ref = CausalLMPredictor(tb, _tensors(glob), mode="batch",
                                batch_opts=BATCH, adapter_bank=fresh,
                                device="cpu")
        try:
            assert after == _texts(ref, "silo_0")
        finally:
            ref.close()
        assert after != before
        thread = bank._watch_thread
    finally:
        pred.close()
    assert thread is not None and not thread.is_alive()
    assert bank._watch_thread is None
