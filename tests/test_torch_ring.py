"""Sequence-parallel ring attention (``llm/attention.py::ring_causal_attention``,
``llm/sharding.py::make_ring_forward``) against the JAX package's, on the
CPU: the port's ranks are gloo processes (``core/launch.py::run_ranks``),
the JAX ring runs under ``shard_map`` over the same number of virtual CPU
devices (the pattern of ``tests/test_llm.py``).

* the forward at sp = 2 and 4, with and without a key-padding mask,
  against JAX's ring (atol 1e-5); rows whose visible keys are all padded
  are exact zeros in both;
* dQ, dK, dV of ``sum(out * cotangent)`` against JAX's ring and against
  dense attention (atol 2e-4, ``tests/test_llm.py``'s bound);
* the training-memory contract: the bytes ``saved_tensors_hooks`` sees one
  rank's forward save stay under ``s²·4 / 2`` at s = 4096, d = 64, and
  fall from sp = 2 to sp = 4;
* ``make_ring_forward`` of a 2-layer causal LM against JAX's (atol 2e-4),
  with a padded row compared on its real positions;
* ``causal_attention(impl="ring")`` outside the context raises JAX's
  ``RuntimeError``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fedml_tpu.core.jax_compat import shard_map
from fedml_tpu.core.mesh import build_mesh as jbuild_mesh
from fedml_tpu.llm import attention as jattn
from fedml_tpu.llm import model as jmodel
from fedml_tpu.llm.sharding import make_ring_forward as jring_forward
from fedml_tpu_torch.core.launch import run_ranks
from fedml_tpu_torch.interop import flax_to_state_dict
from fedml_tpu_torch.llm import attention as tattn

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(os.path.abspath(__file__))
LM = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
          num_heads=4, max_seq_len=32)
MEM_S, MEM_D = 4096, 64


def _inputs():
    rng = np.random.default_rng(5)
    q, k, v, cot = (rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
                    for _ in range(4))
    mask = (rng.uniform(size=(2, 32)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0                       # every query sees a live key
    dead = np.ones((2, 32), np.float32)
    dead[:, :4] = 0.0                      # queries 0..3 see none
    return {"nomask": (q, k, v, None, cot), "mask": (q, k, v, mask, cot),
            "dead": (q, k, v, dead, cot)}


CASES = _inputs()


def _lm_inputs():
    model, params = jmodel.init_llm(jmodel.LLMConfig(**LM),
                                    jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32),
                                           0, 64), np.int32)
    pad = np.ones((2, 32), np.int32)
    pad[0, 24:] = 0
    return model, jax.device_get(params), tokens, pad


@pytest.fixture(scope="module")
def lm():
    return _lm_inputs()


@pytest.fixture(scope="module")
def port(lm):
    """Every sp's ranks, once: the attention cases, the model's ring
    forward and the saved bytes."""
    _, params, tokens, pad = lm
    fwd = (LM, flax_to_state_dict(params), tokens, [None, pad])
    return {sp: run_ranks("torch_rank_programs:ring_suite", sp,
                          dict(attention=CASES, forward=fwd,
                               saved=(MEM_S, MEM_D)),
                          timeout=240.0, sys_path=[HERE])
            for sp in (2, 4)}


def _gathered(runs, name, i):
    return np.concatenate([r["attention"][name][i] for r in runs], axis=1)


def _jax_ring(sp, q, k, v, mask, cot):
    mesh = jbuild_mesh({"sp": sp}, devices=jax.devices()[:sp])
    m = jnp.ones(q.shape[:2], jnp.float32) if mask is None else mask
    fn = shard_map(
        lambda q, k, v, m: jattn.ring_causal_attention(q, k, v, "sp", sp,
                                                       attn_mask=m),
        mesh=mesh, in_specs=(P(None, "sp"),) * 4, out_specs=P(None, "sp"),
        check_vma=False)

    @jax.jit
    def run(q, k, v, m):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, m), q, k, v)
        return (out,) + vjp(jnp.asarray(cot))
    return [np.asarray(a) for a in run(q, k, v, m)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_forward_and_grads_match_jax_ring(port, sp, case):
    want = _jax_ring(sp, *CASES[case])
    for i, tol in zip(range(4), (1e-5, 2e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(_gathered(port[sp], case, i), want[i],
                                   atol=tol, err_msg=f"{case} output {i}")
    if case == "dead":
        out = _gathered(port[sp], case, 0)
        assert np.all(out[:, :4] == 0.0) and np.all(want[0][:, :4] == 0.0)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", ["nomask", "mask"])
def test_ring_grads_match_dense(port, sp, case):
    q, k, v, mask, cot = CASES[case]
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return (jattn.dense_causal_attention(q, k, v, attn_mask=m)
                * cot).sum()

    want = [np.asarray(jattn.dense_causal_attention(q, k, v, attn_mask=m))]
    want += [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        q, k, v)]
    for i in range(4):
        np.testing.assert_allclose(_gathered(port[sp], case, i), want[i],
                                   atol=2e-4 if i else 1e-5,
                                   err_msg=f"{case} output {i}")


def test_ring_saves_linear_memory(port):
    """JAX's training-memory contract (``test_llm.py``'s
    ``test_ring_bwd_residuals_stay_linear_in_s``): a step saves O(s_loc·d),
    never an ``[s_loc, s_loc]`` block."""
    bound = MEM_S * MEM_S * 4 // 2
    sp2 = [r["saved_bytes"] for r in port[2]]
    sp4 = [r["saved_bytes"] for r in port[4]]
    assert max(sp2) < bound, (sp2, bound)
    assert max(sp4) < min(sp2), (sp4, sp2)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_forward_of_the_model_matches_jax(port, lm, sp):
    model, params, tokens, pad = lm
    ring_model = jmodel.CausalLM(jmodel.LLMConfig(**LM, attention_impl="ring"))
    mesh = jbuild_mesh({"sp": sp}, devices=jax.devices()[:sp])
    fwd = jax.jit(jring_forward(lambda p, t, m: ring_model.apply(
        {"params": p}, t, attn_mask=m), mesh))
    got = [np.concatenate([r["forward"][i] for r in port[sp]], axis=1)
           for i in range(2)]
    np.testing.assert_allclose(
        got[0], np.asarray(fwd(params, tokens, jnp.ones((2, 32), jnp.int32))),
        atol=2e-4)
    real = pad.astype(bool)
    want = np.asarray(fwd(params, tokens, jnp.asarray(pad)))
    np.testing.assert_allclose(got[1][real], want[real], atol=2e-4)
    # and the dense forward on the real positions
    dense = np.asarray(model.apply({"params": params}, tokens,
                                   attn_mask=jnp.asarray(pad)))
    np.testing.assert_allclose(got[1][real], dense[real], atol=2e-4)


def test_ring_outside_its_context_raises_like_jax():
    q = np.zeros((1, 8, 1, 4), np.float32)
    with pytest.raises(RuntimeError) as jerr:
        jattn.causal_attention(jnp.asarray(q), jnp.asarray(q),
                               jnp.asarray(q), impl="ring")
    t = torch.tensor(q)
    with pytest.raises(RuntimeError) as terr:
        tattn.causal_attention(t, t, t, impl="ring")
    assert str(terr.value) == str(jerr.value)
