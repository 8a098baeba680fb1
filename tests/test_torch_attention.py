"""The flash-attention kernels' plain versions (B2-B4) and the port's
attention functions against the JAX package on the CPU.

``fedml_tpu.llm.attention._flash_fwd`` / ``_flash_bwd`` run their Pallas
kernels in interpret mode at blocks of 8; the port's ``flash_fwd`` /
``flash_dq`` / ``flash_dkv`` take their plain versions on CPU tensors
(the CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
to these plain versions). Same numpy-seeded q/k/v/mask/dO on both sides;
O, LSE, dQ, dK and dV must agree within the house f32 tolerance, including
rows whose every visible key is masked (O exactly 0, LSE about -1e30) and
masked keys (dK = dV = 0 exactly).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import attention as jattn
from fedml_tpu_torch.core.kernels import flash_attention as fa
from fedml_tpu_torch.llm import attention as tattn

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
B, S, H, D = 2, 32, 2, 8


def _inputs(seed, b=B, s=S, h=H, d=D, mask="none"):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    if mask == "none":
        m = None
    elif mask == "random":
        m = (rng.rand(b, s) > 0.3).astype(np.float32)
        m[:, 0] = 1.0  # key 0 live so every query sees a key
    elif mask == "prefix":  # queries 0..3 see only masked keys
        m = np.ones((b, s), np.float32)
        m[:, :4] = 0.0
    return q, k, v, g, m


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(scope="module", params=["none", "random", "prefix"])
def case(request):
    """Inputs and the JAX kernels' outputs (interpret mode, blocks of 8)."""
    q, k, v, g, m = _inputs(0, mask=request.param)
    jm = jnp.ones((B, S, 1), jnp.float32) if m is None else jnp.asarray(
        m)[:, :, None]
    o, lse = jattn._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jm, 8, 8)
    dq, dk, dv = jattn._flash_bwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jm, o, lse,
                                  jnp.asarray(g), 8, 8)
    want = {n: np.asarray(a) for n, a in dict(o=o, dq=dq, dk=dk,
                                                dv=dv).items()}
    want["lse"] = np.asarray(lse).reshape(B, H, S)
    return request.param, (q, k, v, g, m), want


def test_fwd_plain_matches_pallas(case):
    name, (q, k, v, _, m), want = case
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), _t(m))
    assert o.dtype == torch.float32 and tuple(lse.shape) == (B, H, S)
    np.testing.assert_allclose(o.numpy(), want["o"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want["lse"], rtol=RTOL,
                               atol=ATOL)
    if name == "prefix":
        assert np.all(o.numpy()[:, :4] == 0.0)
        assert np.all(lse.numpy()[:, :, :4] < -1e29)


def test_bwd_plain_matches_pallas(case):
    """B3 and B4's plain versions on the JAX forward's O and LSE."""
    name, (q, k, v, g, m), want = case
    o, lse = torch.tensor(want["o"]), torch.tensor(want["lse"])
    dd = (_t(g) * o).sum(-1)
    args = (_t(q), _t(k), _t(v), _t(m), _t(g), lse, dd)
    dq = fa.flash_dq(*args)
    dk, dv = fa.flash_dkv(*args)
    for got, key in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        np.testing.assert_allclose(got.numpy(), want[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    if m is not None:
        dead = m == 0
        assert np.all(dk.numpy()[dead] == 0) and np.all(dv.numpy()[dead] == 0)
    if name == "prefix":
        assert np.all(dq.numpy()[:, :4] == 0.0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, g, m = _inputs(1, mask="random")
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), _t(m))
    ro, rlse = fa.reference_fwd(_t(q), _t(k), _t(v), _t(m))
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    dd = (_t(g) * o).sum(-1)
    fa.flash_dq(_t(q), _t(k), _t(v), _t(m), _t(g), lse, dd)
    fa.flash_dkv(_t(q), _t(k), _t(v), _t(m), _t(g), lse, dd)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == before


def test_bf16_plain_rounds_once():
    """In bf16 the plain version computes in f32 and rounds O once: it
    equals the f32 result on the same (bf16-rounded) inputs, rounded."""
    q, k, v, _, m = _inputs(2, mask="random")
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    o, lse = fa.flash_fwd(qb, kb, vb, _t(m))
    o32, lse32 = fa.flash_fwd(qb.float(), kb.float(), vb.float(), _t(m))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, o32.bfloat16()) and torch.equal(lse, lse32)


@pytest.mark.parametrize("mask", ["none", "random"])
def test_flash_and_dense_match_jax_at_s100(mask):
    """s=100 is not a multiple of the TPU wrapper's 128-row padding nor of
    the CUDA kernels' 64-row tiles. Output and gradients of the port's
    flash (autograd Function over the plain versions) and dense attention
    against the JAX ones."""
    import jax

    q, k, v, g, m = _inputs(3, s=100, mask=mask)
    jm = None if m is None else jnp.asarray(m)

    def jloss(fn):
        return lambda q, k, v: (fn(q, k, v, attn_mask=jm) * g).sum()

    for jfn, tfn in ((jattn.flash_causal_attention,
                      tattn.flash_causal_attention),
                     (jattn.dense_causal_attention,
                      tattn.dense_causal_attention)):
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        want_o = np.asarray(jfn(jq, jk, jv, attn_mask=jm))
        want_g = jax.grad(jloss(jfn), argnums=(0, 1, 2))(jq, jk, jv)
        leaves = [_t(a).clone().requires_grad_() for a in (q, k, v)]
        out = tfn(*leaves, attn_mask=_t(m))
        got_g = torch.autograd.grad((out * _t(g)).sum(), leaves)
        np.testing.assert_allclose(out.detach().numpy(), want_o, rtol=RTOL,
                                   atol=ATOL, err_msg=tfn.__name__)
        for a, b_, n in zip(got_g, want_g, "qkv"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{tfn.__name__} d{n}")


def test_dispatch_and_unported_impls():
    q, k, v, _, m = _inputs(4, mask="random")
    tq, tk, tv = _t(q), _t(k), _t(v)
    np.testing.assert_allclose(
        tattn.causal_attention(tq, tk, tv, impl="flash",
                               attn_mask=_t(m)).numpy(),
        tattn.causal_attention(tq, tk, tv, impl="dense",
                               attn_mask=_t(m)).numpy(),
        rtol=RTOL, atol=ATOL)
    # ported: outside its sequence-parallel context ring attention raises
    # the JAX package's RuntimeError
    with pytest.raises(RuntimeError, match="sequence-parallel context"):
        tattn.causal_attention(tq, tk, tv, impl="ring")
    with pytest.raises(ValueError, match="attention_impl"):
        tattn.causal_attention(tq, tk, tv, impl="sparse")


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """The argument checks a CUDA launch goes through (here on CPU
    tensors): head_dim over 128, another dtype, mismatched shapes."""
    q = torch.zeros(1, 8, 1, 160)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check(q, q, q, None)
    h = torch.zeros(1, 8, 1, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check(h, h, h, None)
    a, b = torch.zeros(1, 8, 1, 16), torch.zeros(1, 9, 1, 16)
    with pytest.raises(ValueError, match="k:"):
        fa._check(a, b, a, None)
    with pytest.raises(ValueError, match="mask"):
        fa._check(a, a, a, torch.ones(1, 9))
