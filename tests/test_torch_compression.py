"""The cross-silo wire's compression and pipeline against the JAX package.

* ``utils/compression.py``: every method's ``ef_compress_vec`` blob and
  residual equal the JAX package's bit for bit (the same indices in the
  same order, ``int8`` levels, scale and index dtype), over several seeds
  and widths, tied magnitudes and ``d`` above 65,535 (``int32`` indices)
  included; ``decompress_vec`` and the top-k sparsifier's tie order;
* ``prng.permutation_t`` equal to ``jax.random.permutation``;
* ``core/wire``: ``encode_update``'s payload bytes (``dumps_tree``), the
  copies ``adaptive``, ``field_quant`` and ``state`` pinned by behaviour.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import wire as jwire
from fedml_tpu.core.distributed.communication.message import \
    dumps_tree as jdumps
from fedml_tpu.utils import compression as J
from fedml_tpu_torch import prng
from fedml_tpu_torch.core import wire as twire
from fedml_tpu_torch.core.distributed.communication.message import \
    dumps_tree as tdumps
from fedml_tpu_torch.utils import compression as T

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

METHODS = ("topk", "randk", "qsgd", "topk_qsgd", "randk_qsgd")


def _vector(d, seed, kind):
    rs = np.random.RandomState(1000 * seed + d)
    v = rs.randn(d).astype(np.float32)
    if kind == "ties":       # magnitudes tie in whole groups, both signs
        v = (np.round(v * 2) / 2).astype(np.float32)
        v[::3] = -v[::3]
    res = None if kind == "ties" or seed == 0 else \
        (0.1 * rs.randn(d)).astype(np.float32)
    return v, res


def _same_blob(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("d,seed,kind", [
    (5, 0, "randn"), (650, 1, "randn"), (7850, 2, "randn"),
    (7850, 3, "ties"), (70001, 4, "randn"), (70001, 5, "ties")])
def test_ef_compress_vec_blob_bit_equal(method, d, seed, kind):
    v, res = _vector(d, seed, kind)
    ratio = 0.05 if d > 100 else 0.4
    jb, jr = J.ef_compress_vec(v, res, J.CommCompressionSpec(
        method=method, ratio=ratio), jax.random.PRNGKey(seed + 7))
    tb, tr = T.ef_compress_vec(v, res, T.CommCompressionSpec(
        method=method, ratio=ratio), prng.PRNGKey(seed + 7))
    _same_blob(jb, tb)
    assert np.asarray(jr).tobytes() == tr.tobytes()
    if "i" in tb:
        assert tb["i"].dtype == (np.uint16 if d <= 65535 else np.int32)
    np.testing.assert_array_equal(T.decompress_vec(tb), J.decompress_vec(jb))


def test_error_feedback_chain_bit_equal():
    """Five rounds of one sender, the residual fed back each round, the
    key folded by round (the client manager's use)."""
    rs = np.random.RandomState(3)
    spec_j = J.CommCompressionSpec(method="topk_qsgd", ratio=0.1, levels=15)
    spec_t = T.CommCompressionSpec(method="topk_qsgd", ratio=0.1, levels=15)
    kj = jax.random.fold_in(jax.random.PRNGKey(97), 2)
    kt = prng.fold_in(prng.PRNGKey(97), 2)
    rj = rt = None
    for r in range(5):
        v = rs.randn(3000).astype(np.float32)
        jb, rj = J.ef_compress_vec(v, rj, spec_j, jax.random.fold_in(kj, r))
        tb, rt = T.ef_compress_vec(v, rt, spec_t, prng.fold_in(kt, r))
        _same_blob(jb, tb)
        assert np.asarray(rj).tobytes() == rt.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("d", [1, 2, 17, 1625, 1626, 40000])
def test_permutation_equals_jax(d, seed):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), d))
    got = prng.permutation_t(prng.PRNGKey(seed), d, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (d,)))
    assert (prng.uniform_t(prng.PRNGKey(seed), d, "cpu").numpy()
            .view(np.uint32) == u.view(np.uint32)).all()


def test_sparsifiers_and_tree_helpers():
    rs = np.random.RandomState(0)
    v = rs.randn(300).astype(np.float32)
    v[10] = v[20] = 9.0     # a tie at the top: the lower index first
    jv, ji = J.topk_compress(jnp.asarray(v), 7)
    tv, ti = T.topk_compress(torch.from_numpy(v), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(ti[0]) == 10 and int(ti[1]) == 20


@pytest.mark.parametrize("knobs", [
    {}, {"comm_compression": "topk_qsgd"},
    {"comm_compression": "none", "comm_compression_broadcast": "bf16"},
    {"comm_compression": "randk", "comm_compression_ratio": 0.3,
     "comm_quantize_levels": 31, "comm_compression_broadcast": "compress"}])
def test_spec_from_args_equal(knobs):
    from types import SimpleNamespace
    args = SimpleNamespace(**knobs)
    assert (T.spec_from_args(args) is None) == (J.spec_from_args(args)
                                                 is None)
    if T.spec_from_args(args) is not None:
        a, b = T.spec_from_args(args), J.spec_from_args(args)
        assert (a.method, a.ratio, a.levels, a.broadcast, a.quantized) == (
            b.method, b.ratio, b.levels, b.broadcast, b.quantized)
    for bad in (dict(method="nope"), dict(method="topk", ratio=0.0),
                dict(method="qsgd", levels=200),
                dict(method=None, broadcast="compress")):
        with pytest.raises(ValueError):
            T.CommCompressionSpec(**bad)
        with pytest.raises(ValueError):
            J.CommCompressionSpec(**bad)


@pytest.mark.parametrize("method", METHODS)
def test_encode_update_payload_bytes_equal(method):
    rs = np.random.RandomState(8)
    vec = rs.randn(5000).astype(np.float32)
    base = rs.randn(5000).astype(np.float32)
    res = (0.01 * rs.randn(5000)).astype(np.float32)
    je = jwire.encode_update(vec, base=base, spec=J.CommCompressionSpec(
        method=method, ratio=0.1), residual=res,
        rng=jax.random.PRNGKey(11), msg_type=3)
    te = twire.encode_update(vec, base=base, spec=T.CommCompressionSpec(
        method=method, ratio=0.1), residual=res, rng=prng.PRNGKey(11),
        msg_type=3)
    assert tdumps(te.payload) == jdumps(je.payload)
    assert (te.raw_bytes, te.payload_bytes) == (je.raw_bytes,
                                                je.payload_bytes)
    assert te.residual.tobytes() == np.asarray(je.residual).tobytes()
    np.testing.assert_array_equal(
        twire.decode_update(te.payload, base=base),
        jwire.decode_update(je.payload, base=base))
    # no spec: the dense path, byte accounting only
    assert twire.encode_update(vec).payload is None
    with pytest.raises(ValueError):
        twire.decode_update({"not": "a blob"})


def test_wire_state_and_adaptive_copies():
    d = 6
    for vec in (None, np.arange(d, dtype=np.float32)):
        for a, b in zip(twire.pack_optional_vec(vec, d),
                        jwire.pack_optional_vec(vec, d)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ta = twire.wire_state_template(d, ("residual",), {"rows": 3})
    ja = jwire.wire_state_template(d, ("residual",), {"rows": 3})
    assert sorted(ta) == sorted(ja)
    for k in ta:
        assert ta[k].shape == ja[k].shape and ta[k].dtype == ja[k].dtype
    from fedml_tpu.core.selection import ClientStatsStore as JStore
    from fedml_tpu_torch.core.selection import ClientStatsStore as TStore
    stores = (TStore(5, drop_prior=(1.0, 4.0)), JStore(5, drop_prior=(1.0,
                                                                      4.0)))
    for st in stores:
        st.record_latency(1, 3.0)
        st.record_latency(2, 9.0)
        st.record_availability(2, participated=False)
    for budget in (None, 6.0):
        got = twire.adaptive_keep_ratio(
            twire.AdaptiveRatioBounds(0.02, 0.1, budget), stores[0], [1, 2])
        want = jwire.adaptive_keep_ratio(
            jwire.AdaptiveRatioBounds(0.02, 0.1, budget), stores[1], [1, 2])
        assert got == want
    with pytest.raises(ValueError):
        twire.AdaptiveRatioBounds(0.2, 0.1)


@pytest.mark.parametrize("bits,k", [(4, 4), (8, 16)])
def test_field_quant_copy(bits, k):
    rs = np.random.RandomState(bits)
    xs = [rs.randn(37).astype(np.float32) * 0.5 for _ in range(k)]
    tp, jp = twire.plan_for(bits, k), jwire.plan_for(bits, k)
    assert (tp.width, tp.lanes, tp.offset, tp.qmax, tp.to_wire()) == (
        jp.width, jp.lanes, jp.offset, jp.qmax, jp.to_wire())
    scale = twire.suggest_scale(float(np.abs(xs[0]).max()), tp)
    assert scale == jwire.suggest_scale(float(np.abs(xs[0]).max()), jp)
    packed, res = [], None
    for i, x in enumerate(xs):
        pt, rt = twire.field_encode(x, scale, tp, res,
                                    np.random.default_rng(i))
        pj, rj = jwire.field_encode(x, scale, jp, res,
                                    np.random.default_rng(i))
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(rt, rj)
        packed.append(pt)
    total = np.sum(np.asarray(packed, np.uint64), axis=0) % twire.FIELD_P
    np.testing.assert_array_equal(
        twire.lane_dequantize_sum(total, k, scale, tp, 37),
        jwire.lane_dequantize_sum(total, k, scale, jp, 37))
    with pytest.raises(ValueError):
        twire.lane_unpack_sum(total, k + 1, tp, 37)
