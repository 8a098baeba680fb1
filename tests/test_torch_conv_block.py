"""The port's fused conv block against the JAX package's, on the CPU.

``fedml_tpu_torch.core.kernels.conv_block``: the plain ``reference_block``
against JAX's ``reference_block``, and ``fused_block`` (on a CPU tensor: the
plain forward inside the autograd Function whose backward recomputes the
reference) against JAX's ``fused_block`` (the Pallas kernel in interpret
mode, its custom_vjp backward). Shapes follow ``tests/test_conv_block.py``.
Inputs come from a numpy seed and go to both packages. The CUDA kernel
itself is checked against ``reference_block`` on the card by
``chip_smoke.py``.

Tolerances: float32 uses the house ``rtol=2e-4, atol=2e-5``; bfloat16 uses
0.06, the JAX package's own bound for the block (bf16 keeps ~3 significant
digits and the two frameworks round intermediates at different places).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.kernels import conv_block as jcb
from fedml_tpu_torch.core.kernels import conv_block as tcb

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5


def _params(seed, cin, cout, proj):
    rs = np.random.RandomState(seed)
    p = {"w1": rs.randn(3, 3, cin, cout) * 0.2,
         "g1_scale": 1.0 + 0.1 * rs.randn(cout),
         "g1_bias": 0.1 * rs.randn(cout),
         "w2": rs.randn(3, 3, cout, cout) * 0.2,
         "g2_scale": 1.0 + 0.1 * rs.randn(cout),
         "g2_bias": 0.1 * rs.randn(cout)}
    if proj:
        p["wp"] = rs.randn(1, 1, cin, cout) * 0.2
        p["gp_scale"] = 1.0 + 0.1 * rs.randn(cout)
        p["gp_bias"] = 0.1 * rs.randn(cout)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_jax(x, p, dtype=jnp.float32):
    return (jnp.asarray(x, dtype),
            {k: jnp.asarray(v, dtype) for k, v in p.items()})


def _to_torch(x, p, dtype=torch.float32):
    return (torch.tensor(x).to(dtype),
            {k: torch.tensor(v).to(dtype) for k, v in p.items()})


CASES = {
    # name: (n, h, w, cin, cout, strides)
    "width16": (2, 8, 8, 16, 16, 1),
    "width32": (2, 8, 8, 32, 32, 1),
    "width64": (2, 8, 8, 64, 64, 1),
    "odd_7x9_s1": (2, 7, 9, 16, 16, 1),
    "odd_7x7_s2": (2, 7, 7, 16, 32, 2),
    "odd_9x8_s2": (2, 9, 8, 16, 32, 2),
    "projection_s2": (2, 8, 8, 16, 32, 2),
    "channel_change_s1": (2, 8, 8, 16, 32, 1),
    "batch_not_multiple_of_block": (jcb.DEFAULT_BLOCK_N + 3, 8, 8, 16, 16, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    n, h, w, cin, cout, s = CASES[case]
    proj = s != 1 or cin != cout
    x, p = _x(1, (n, h, w, cin)), _params(7, cin, cout, proj)
    xj, pj = _to_jax(x, p)
    xt, pt = _to_torch(x, p)
    ref_j = np.asarray(jcb.reference_block(xj, pj, strides=s, groups=8))
    ref_t = tcb.reference_block(xt, pt, strides=s, groups=8)
    assert tuple(ref_t.shape) == ref_j.shape == (
        n, -(-h // s), -(-w // s), cout)
    np.testing.assert_allclose(ref_t.numpy(), ref_j, rtol=RTOL, atol=ATOL)
    launches = tcb.fused_block.launches
    fus_t = tcb.fused_block(xt, pt, strides=s, groups=8)
    assert tcb.fused_block.launches == launches  # CPU: the plain version
    fus_j = np.asarray(jcb.fused_block(xj, pj, strides=s, groups=8))
    np.testing.assert_allclose(fus_t.numpy(), fus_j, rtol=RTOL, atol=ATOL)
    assert np.isfinite(fus_t.numpy()).all()


def test_bf16_matches_jax():
    x, p = _x(11, (4, 8, 8, 16)), _params(10, 16, 16, False)
    xj, pj = _to_jax(x, p, jnp.bfloat16)
    xt, pt = _to_torch(x, p, torch.bfloat16)
    fus_t = tcb.fused_block(xt, pt)
    assert fus_t.dtype == torch.bfloat16
    for fn in (jcb.fused_block, jcb.reference_block):
        np.testing.assert_allclose(
            fus_t.float().numpy(), np.asarray(fn(xj, pj), np.float32),
            rtol=0.06, atol=0.06)


@pytest.mark.parametrize("case", ["projection_s2", "width16", "odd_9x8_s2"])
def test_gradients_match_jax(case):
    """Gradients for x and every parameter leaf: the port's autograd
    Function (reference-recompute backward) against JAX's custom_vjp, with
    a fixed random cotangent. Bound 1e-4: weight gradients sum over every
    pixel, so entries reach O(10) and the two frameworks' summation orders
    differ by more than the house atol in absolute terms."""
    n, h, w, cin, cout, s = CASES[case]
    proj = s != 1 or cin != cout
    x, p = _x(13, (1, h, w, cin)), _params(12, cin, cout, proj)
    ho, wo = -(-h // s), -(-w // s)
    cot = _x(14, (1, ho, wo, cout))
    xj, pj = _to_jax(x, p)

    def loss_j(x_, p_):
        return jnp.sum(jcb.fused_block(x_, p_, strides=s, groups=8) * cot)

    gx_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(xj, pj)
    xt, pt = _to_torch(x, p)
    xt.requires_grad_()
    for v in pt.values():
        v.requires_grad_()
    for fn in (tcb.fused_block, tcb.reference_block):
        out = fn(xt, pt, strides=s, groups=8)
        leaves = [xt, *pt.values()]
        grads = torch.autograd.grad((out * torch.tensor(cot)).sum(), leaves)
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                                   rtol=1e-4, atol=1e-4)
        for k, g in zip(pt, grads[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(gp_j[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_resnet56_geometries_fit_shared_memory():
    """Every ResNet-56 block keeps one sample's intermediates in one SM's
    shared memory; the 32x32x16 stage is the tightest (~213 KB)."""
    for h, cin, cout, s in ((32, 16, 16, 1), (32, 16, 32, 2),
                            (16, 32, 32, 1), (16, 32, 64, 2),
                            (8, 64, 64, 1)):
        assert tcb.smem_bytes(h, h, cin, cout, s, 8) <= tcb.MAX_SMEM_BYTES
        assert tcb.threads_for(cout) % cout == 0
    assert tcb.smem_bytes(32, 32, 16, 16, 1, 8) > 210_000


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, p = _to_torch(_x(1, (2, 8, 8, 16)), _params(2, 16, 16, False))
    with pytest.raises(TypeError):
        tcb._check(x.double(), p, 1, 8)
    with pytest.raises(ValueError, match="projection"):
        tcb._check(x, p, 2, 8)
    with pytest.raises(ValueError, match="groups"):
        tcb._check(x, p, 1, 5)
    bad = dict(p, w2=p["w2"][:, :, :8])
    with pytest.raises(ValueError, match="w2"):
        tcb._check(x, bad, 1, 8)
    big = torch.zeros(1, 64, 64, 16)
    with pytest.raises(ValueError, match="shared memory"):
        tcb._check(big, p, 1, 8)
    with pytest.raises(ValueError, match="cuda"):
        tcb.fused_block(x.to("meta"), {k: v.to("meta") for k, v in p.items()})
