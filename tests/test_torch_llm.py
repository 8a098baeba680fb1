"""The port's causal LM, LoRA, trainer, LLM data and HF import against the
JAX package on the CPU.

Parameters are drawn by flax and carried across by
``fedml_tpu_torch.interop`` (the port keeps flax's names and layouts, so
the mapping is path for path); inputs are numpy. Logits and gradients must
agree within the house float32 tolerance; the data arrays and the HF
import must be exactly equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.data.bundled.shakespeare import PASSAGES as J_PASSAGES
from fedml_tpu.llm import data as jdata
from fedml_tpu.llm import hf as jhf
from fedml_tpu.llm import lora as jlora
from fedml_tpu.llm import model as jmodel
from fedml_tpu.llm.trainer import CausalLMTrainer as JTrainer
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.data.bundled.shakespeare import PASSAGES as T_PASSAGES
from fedml_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from fedml_tpu_torch.llm import data as tdata
from fedml_tpu_torch.llm import hf as thf
from fedml_tpu_torch.llm import lora as tlora
from fedml_tpu_torch.llm import model as tmodel
from fedml_tpu_torch.llm.trainer import CausalLMTrainer as TTrainer

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4, max_seq_len=16)
VARIANTS = {"tied": {}, "untied_gqa": dict(num_kv_heads=2,
                                           tie_embeddings=False)}


def _cfgs(variant, impl="dense", dtype="float32"):
    kw = dict(SMALL, **VARIANTS[variant], dtype=dtype)
    return (jmodel.LLMConfig(**kw, attention_impl="dense"),
            tmodel.LLMConfig(**kw, attention_impl=impl))


def _tensors(sd):
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _tokens(seed, b=2, s=12, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def flax_lm(request):
    jcfg, _ = _cfgs(request.param)
    model, params = jmodel.init_llm(jcfg, jax.random.PRNGKey(0))
    return request.param, model, jax.device_get(params)


def test_init_names_shapes_and_counts_match_flax(flax_lm):
    variant, _, params = flax_lm
    _, tcfg = _cfgs(variant)
    _, tparams = tmodel.init_llm(tcfg, torch.Generator().manual_seed(0))
    want = {k: v.shape for k, v in flax_to_state_dict(params).items()}
    assert {k: tuple(v.shape) for k, v in tparams.items()} == want
    assert tmodel.count_params(tparams) == jmodel.count_params(params) \
        == tcfg.param_count()
    assert tcfg.flops_per_token() == _cfgs(variant)[0].flops_per_token()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_and_grads_match_flax(flax_lm, impl):
    """The port's dense and flash attention (plain versions on CPU) inside
    the whole model, against the flax model with dense attention."""
    variant, model, params = flax_lm
    _, tcfg = _cfgs(variant, impl)
    x = _tokens(1)
    # a small cotangent, like a loss averaged over the vocabulary: the tied
    # embedding's gradient sums every position's contribution, and at unit
    # scale its f32 cancellation error exceeds the house atol
    cot = (0.05 * np.random.RandomState(2).randn(2, 12, 64)).astype(
        np.float32)

    def jloss(p):
        return (model.apply({"params": p}, jnp.asarray(x)) * cot).sum()

    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    want_g = flax_to_state_dict(jax.device_get(jax.grad(jloss)(params)))
    tm = tmodel.CausalLM(tcfg)
    leaves = {k: v.requires_grad_() for k, v in
              _tensors(flax_to_state_dict(params)).items()}
    logits = functional_call(tm, leaves, (torch.from_numpy(x),))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    grads = torch.autograd.grad((logits * torch.from_numpy(cot)).sum(),
                                list(leaves.values()))
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_bf16_compute_matches_flax_bf16(flax_lm):
    """bfloat16 compute on the same weights (norm scales at 1.5, which
    bf16 holds exactly, so only the per-op casts differ): f32 logits,
    within 2% of the largest logit of flax's bf16 run. bf16 keeps 8
    significant bits (0.4% per rounding) and XLA and PyTorch round an
    elementwise chain at different points; two layers of it measured 1.1%
    here, where either bf16 run is 1.9-2.6% from the f32 run."""
    variant, _, params = flax_lm
    jcfg, tcfg = _cfgs(variant, "flash", "bfloat16")
    x = _tokens(3)
    sd = _tensors(flax_to_state_dict(params))
    sd = {k: (v * 1.5 if k.endswith("scale") else v) for k, v in sd.items()}
    want = np.asarray(jmodel.CausalLM(jcfg).apply(
        {"params": state_dict_to_flax(sd)}, jnp.asarray(x)))
    got = functional_call(tmodel.CausalLM(tcfg), sd,
                          (torch.from_numpy(x),))
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - want).max() < 2e-2 * np.abs(
        want).max()


def test_rope_and_rmsnorm_match_flax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3, 8).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32)[None], (2, 5))
    np.testing.assert_allclose(
        tmodel._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                     10000.0).numpy(),
        np.asarray(jmodel._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=RTOL, atol=ATOL)
    h = rng.randn(2, 5, 16).astype(np.float32)
    scale = rng.rand(16).astype(np.float32) + 0.5
    norm = tmodel.RMSNorm(16)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    want = jmodel.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}},
                                  jnp.asarray(h))
    np.testing.assert_allclose(norm(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_serving_paths_raise():
    """The cache-aware path and the factored adapters belong to the serving
    slice; they raised until it was ported and now run. Over an empty cache
    view the ``kv_view`` forward is the plain causal forward and returns the
    new K/V per layer; an empty adapter dict changes nothing. Parity with
    the JAX package: tests/test_torch_serving.py."""
    _, tcfg = _cfgs("tied")
    tm, _ = tmodel.init_llm(tcfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_tokens(3, b=1, s=4)).long()
    with torch.no_grad():
        plain = tm(x)
        view = torch.zeros(1, tcfg.max_seq_len, tcfg.kv_heads, tcfg.head_dim)
        logits, kvs = tm(x, positions=torch.arange(4)[None],
                         kv_view=[(view, view)] * tcfg.num_layers)
        np.testing.assert_allclose(logits.numpy(), plain.numpy(), rtol=RTOL,
                                   atol=ATOL)
        assert len(kvs) == tcfg.num_layers
        assert tuple(kvs[0][0].shape) == (1, 4, tcfg.kv_heads, tcfg.head_dim)
        assert torch.equal(tm(x, adapters={}), plain)


# ------------------------------------------------------------------ LoRA --


def _jax_lora(params, rank=4, bump=0.0):
    lora = jax.device_get(jlora.lora_init(jax.random.PRNGKey(2), params,
                                          rank=rank))
    if bump:
        lora = jax.tree_util.tree_map(
            lambda a: a + bump * np.cos(np.arange(a.size, dtype=np.float32)
                                        ).reshape(a.shape), lora)
    return lora


def test_lora_shapes_zero_effect_and_merge(flax_lm):
    variant, model, params = flax_lm
    _, tcfg = _cfgs(variant)
    base = _tensors(flax_to_state_dict(params))
    jl = _jax_lora(params)
    # same names and shapes as the JAX adapter tree
    tl = tlora.lora_init(torch.Generator().manual_seed(0), base, rank=4)
    assert {k: tuple(v.shape) for k, v in tl.items()} == {
        k: v.shape for k, v in flax_to_state_dict(jl).items()}
    assert tlora.lora_param_count(tl) == jlora.lora_param_count(jl)
    assert all(torch.all(v == 0) for k, v in tl.items()
               if k.endswith("lora_b"))
    tm = tmodel.CausalLM(tcfg)
    x = torch.from_numpy(_tokens(5))
    base_out = functional_call(tm, base, (x,))
    merged_out = functional_call(tm, tlora.lora_merge(base, tl), (x,))
    assert torch.equal(base_out, merged_out)  # b = 0: zero effect
    bumped = _jax_lora(params, bump=0.1)
    want = flax_to_state_dict(jax.device_get(jlora.lora_merge(params,
                                                              bumped)))
    got = tlora.lora_merge(base, _tensors(flax_to_state_dict(bumped)))
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    zero = tlora.lora_zero_like(tl)
    assert set(zero) == set(tl) and all(torch.all(v == 0)
                                        for v in zero.values())


def test_trainer_loss_aux_and_adapter_grads_match_jax(flax_lm):
    """CausalLMTrainer through make_lora_apply: ignored labels (-1), a
    masked-out sample, loss, aux sums and the adapter gradients."""
    variant, model, params = flax_lm
    _, tcfg = _cfgs(variant, "flash")
    lora = _jax_lora(params, bump=0.05)
    rng = np.random.RandomState(6)
    x = _tokens(7, b=3)
    y = rng.randint(0, 64, x.shape).astype(np.int32)
    y[:, :4] = -1
    y[1, 9:] = -1
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jspec = JTrainer(jlora.make_lora_apply(
        lambda p, x, rng=None, train=False: model.apply({"params": p}, x),
        params))
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    (jloss, jaux), jg = jax.value_and_grad(jspec.loss, has_aux=True)(
        lora, jb, None)
    jev = jspec.eval_stats(lora, jb)
    tm = tmodel.CausalLM(tcfg)
    base = _tensors(flax_to_state_dict(params))
    tspec = TTrainer(tlora.make_lora_apply(
        lambda p, x, train=False: functional_call(tm, p, (x,)), base))
    leaves = {k: v.requires_grad_() for k, v in
              _tensors(flax_to_state_dict(lora)).items()}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
          "mask": torch.from_numpy(mask)}
    tloss, taux = tspec.loss(leaves, tb)
    tev = tspec.eval_stats(leaves, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(float(tev[k]), float(jev[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(taux["count"]) == float((y[:2] >= 0).sum())
    want_g = flax_to_state_dict(jax.device_get(jg))
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# ------------------------------------------------------------------ data --


def test_bundled_passages_are_a_copy():
    assert T_PASSAGES == J_PASSAGES


@pytest.mark.parametrize("corpus", ["synthetic", "shakespeare"])
def test_tokenized_corpus_is_exactly_equal(corpus):
    if corpus == "synthetic":
        rows_j = jdata.synthetic_instruction_corpus(40, seed=3)
        rows_t = tdata.synthetic_instruction_corpus(40, seed=3)
    else:
        rows_j = jdata.shakespeare_instruction_corpus()
        rows_t = tdata.shakespeare_instruction_corpus()
    assert rows_t == rows_j
    for seq, completion in ((48, True), (200, False)):
        xj, yj = jdata.tokenize_examples(rows_j, jdata.ByteTokenizer(), seq,
                                         completion)
        xt, yt = tdata.tokenize_examples(rows_t, tdata.ByteTokenizer(), seq,
                                         completion)
        assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


def test_tokenizers_round_trip_like_jax():
    text = "héllo wörld\n"
    for jt, tt in ((jdata.ByteTokenizer(), tdata.ByteTokenizer()),
                   (jdata.RoundTripByteTokenizer(),
                    tdata.RoundTripByteTokenizer())):
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert tt.decode(ids + [255]) == jt.decode(ids + [255])
    assert tdata.ByteTokenizer.vocab_size == jdata.ByteTokenizer.vocab_size


@pytest.mark.parametrize("fallback", ["synthetic", "shakespeare"])
def test_llm_federated_dataset_is_exactly_equal(fallback):
    cfg = dict(client_num_in_total=3, batch_size=4, random_seed=2,
               llm_corpus_size=30, llm_corpus_fallback=fallback)
    fj, _ = jdata.build_llm_federated(JArguments(**cfg), 3, 40)
    ft, _ = tdata.build_llm_federated(TArguments(**cfg), 3, 40)
    assert ft.task == fj.task == "llm"
    assert ft.provenance == fj.provenance
    for name in ("x", "y", "mask", "num_samples"):
        a = np.asarray(getattr(fj.train, name))
        b = getattr(ft.train, name)
        assert a.dtype.kind == b.dtype.kind, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("x", "y", "mask"):
        np.testing.assert_array_equal(ft.test[name],
                                      np.asarray(fj.test[name]))
    np.testing.assert_array_equal(ft.client_num_samples,
                                  fj.client_num_samples)


# -------------------------------------------------------------- HF import --


def _llama_state_dict(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvd = cfg.kv_heads * cfg.head_dim
    sd = {"model.embed_tokens.weight": torch.randn(v, h, generator=g),
          "model.norm.weight": torch.rand(h, generator=g) + 0.5}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = torch.randn(v, h, generator=g)
    for n in range(cfg.num_layers):
        p = f"model.layers.{n}."
        for name, shape in (("input_layernorm.weight", (h,)),
                            ("post_attention_layernorm.weight", (h,)),
                            ("self_attn.q_proj.weight", (h, h)),
                            ("self_attn.k_proj.weight", (kvd, h)),
                            ("self_attn.v_proj.weight", (kvd, h)),
                            ("self_attn.o_proj.weight", (h, h)),
                            ("mlp.gate_proj.weight", (i, h)),
                            ("mlp.up_proj.weight", (i, h)),
                            ("mlp.down_proj.weight", (h, i))):
            sd[p + name] = torch.randn(*shape, generator=g) * 0.2
    return sd


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hf_llama_import_matches_jax(variant, tmp_path):
    """A fabricated Llama-named state dict: the port's import equals the
    JAX import exactly, loads into CausalLM, and gives the flax logits;
    ``load_hf_llama`` reads it back from a checkpoint file."""
    jcfg, tcfg = _cfgs(variant)
    sd = _llama_state_dict(tcfg)
    got = thf.convert_llama_state_dict(sd, tcfg)
    want = flax_to_state_dict(jax.device_get(
        jhf.convert_llama_state_dict(sd, jcfg)))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    torch.save(sd, tmp_path / "model.pt")
    again = thf.load_hf_llama(str(tmp_path), tcfg)
    assert all(torch.equal(again[k], got[k]) for k in got)
    tm = tmodel.CausalLM(tcfg)
    tm.load_state_dict(got)
    x = _tokens(8)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmodel.CausalLM(jcfg).apply(
            {"params": state_dict_to_flax(got)}, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_hf_import_refuses_untied_head_on_tied_config():
    _, tcfg = _cfgs("tied")
    sd = _llama_state_dict(tcfg)
    sd["lm_head.weight"] = torch.randn(64, 32)
    with pytest.raises(ValueError, match="tie_embeddings"):
        thf.convert_llama_state_dict(sd, tcfg)
