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


@pytest.mark.parametrize("s", [1, 2])
def test_bf16_plain_rounds_y1_before_conv2(s):
    """In bfloat16 the plain version rounds y1 = relu(GN1(conv1(x))) to
    bf16 before conv2 (GroupNorm casts back to x's type), as JAX's
    ``reference_block`` does; the bf16 kernel rounds y1 at the same place,
    as conv2's A operand. Both packages' y1 are bf16 and agree within
    bf16 rounding of the conv's output."""
    cin, cout = 16, 32 if s == 2 else 16
    x, p = _x(21, (2, 8, 8, cin)), _params(20, cin, cout, s == 2)
    xj, pj = _to_jax(x, p, jnp.bfloat16)
    xt, pt = _to_torch(x, p, torch.bfloat16)
    y1_t = torch.relu(tcb._group_norm(
        tcb._conv_same(xt, pt["w1"], s), pt["g1_scale"], pt["g1_bias"], 8,
        tcb.GN_EPS))
    y1_j = jax.nn.relu(jcb._group_norm(
        jcb._conv_same(xj, pj["w1"], s), pj["g1_scale"], pj["g1_bias"], 8,
        jcb.GN_EPS))
    assert y1_t.dtype == torch.bfloat16 and y1_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(y1_t.float().numpy(),
                               np.asarray(y1_j, np.float32),
                               rtol=2 ** -6, atol=2 ** -6)


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


# ResNet-56's block geometries at batch 32, (h, cin, cout, strides), and the
# odd shapes of the on-card checks, (n, h, w, cin, cout, strides)
FLAGSHIP = ((32, 16, 16, 1), (32, 16, 32, 2), (16, 32, 32, 1),
            (16, 32, 64, 2), (8, 64, 64, 1))
ODD = ((2, 7, 9, 16, 16, 1), (2, 7, 7, 16, 32, 2), (2, 9, 8, 16, 32, 2),
       (2, 8, 8, 16, 32, 1), (11, 8, 8, 16, 16, 1))


def test_resnet56_geometries_fit_shared_memory():
    """float32: one CTA keeps a whole sample's f32 intermediates, the
    32x32x16 stage the tightest (~213 KB). bfloat16: a CTA keeps only its
    band (bf16 x and y1 with halos, the weights), at batch 32 small enough
    for two CTAs per SM; the 32x32x16 stage, with 4 CTAs per sample, takes
    under 32 KB."""
    for h, cin, cout, s in FLAGSHIP:
        assert tcb.smem_bytes(h, h, cin, cout, s, 8) <= tcb.MAX_SMEM_BYTES
        assert tcb.threads_for(cout) % cout == 0
        k = tcb.cluster_for(32, h, h, cout, s)
        assert k == 4
        bf = tcb.smem_bytes(h, h, cin, cout, s, 8, torch.bfloat16, k)
        assert 2 * bf <= tcb.MAX_SMEM_BYTES
        # a CTA's band with its halo rows, at most, plus the weights
        ho = -(-h // s)
        assert bf >= 2 * ((ho // k - 1) * s + 3) * (h + 2) * cin
    assert tcb.smem_bytes(32, 32, 16, 16, 1, 8) > 210_000
    assert tcb.smem_bytes(32, 32, 16, 16, 1, 8, torch.bfloat16, 4) < 32_768


@pytest.mark.parametrize(
    "shape", [(32, h, h, cin, cout, s) for h, cin, cout, s in FLAGSHIP]
    + list(ODD) + [(1000, 32, 32, 16, 16, 1), (1, 16, 16, 32, 64, 2),
                   (4, 3, 3, 16, 16, 1), (200, 1, 5, 32, 32, 2)],
    ids=str)
def test_bands_cover_each_output_row_once(shape):
    """The bfloat16 kernel's cluster: 1-8 CTAs, at most one per output row
    (ho may be below the cluster the batch alone would pick), and bands
    that cover each output row exactly once, in rank order, each within
    the warps' register budget."""
    n, h, w, cin, cout, s = shape
    ho, wo = -(-h // s), -(-w // s)
    k = tcb.cluster_for(n, h, w, cout, s)
    assert 1 <= k <= min(tcb.MAX_CLUSTER, ho)
    if k > 1 and n * k > tcb.NUM_SMS:  # raised for the registers alone
        rows = -(-ho // (k - 1))
        assert -(-rows * wo // 16) * (cout // 16) > (
            tcb.MMA_WARPS * tcb.MMA_UNITS)
    rows = [r for start, stop in tcb.bands(ho, k) for r in range(start, stop)]
    assert rows == list(range(ho))
    for start, stop in tcb.bands(ho, k):
        assert stop > start
        units = -(-(stop - start) * wo // 16) * (cout // 16)
        assert units <= tcb.MMA_WARPS * tcb.MMA_UNITS


def test_bf16_wrapper_refuses_what_its_kernel_does_not_take():
    """bfloat16 takes 16, 32 or 64 channels in and out, and a band whose
    output fits the warps' registers; float32 (the CUDA-core kernel) takes
    the same block at 8 channels."""
    x, p = _to_torch(_x(1, (2, 8, 8, 8)), _params(2, 8, 8, False))
    assert tcb._check(x, p, 1, 8) == 1
    xb, pb = x.bfloat16(), {k: v.bfloat16() for k, v in p.items()}
    with pytest.raises(ValueError, match="bfloat16 kernel takes"):
        tcb._check(xb, pb, 1, 8)
    x, p = _to_torch(_x(1, (2, 8, 8, 16)), _params(2, 16, 16, False))
    xb, pb = x.bfloat16(), {k: v.bfloat16() for k, v in p.items()}
    assert tcb._check(xb, pb, 1, 8) == 8
    wide = torch.zeros(1, 2, 4096, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="registers"):
        tcb._check(wide, pb, 1, 8)


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
