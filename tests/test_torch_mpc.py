"""The port's secure-aggregation math (``fedml_tpu_torch/core/mpc``)
against the JAX package's ``fedml_tpu/core/mpc``, bit for bit:

* the field ops (``ff_add`` / ``ff_sub`` / ``ff_neg`` / ``ff_mul``) on
  seeded pairs and the edge values, against JAX and against Python
  integers;
* ``quantize`` / ``dequantize`` (ties at half a quantum, values past the
  clip, signed values that round in the float32 conversion), ``sum_mod_p``
  (K = 1, 4, 64) and ``ff_random`` against the same key;
* ``mask_vector``, Shamir sharing, ``expand_mask``, ``pairwise_seed`` and
  ``lagrange_coeffs_at``;
* ``SecAggClient``'s masked vectors and ``secagg_unmask`` with 0, 1 and 2
  clients dropped, under the same seeds;
* LightSecAgg's ``mask_encoding`` / ``aggregate_encoded`` /
  ``decode_aggregate_mask`` and ``lcc_encode`` / ``lcc_decode``.

None of it needs the ``cryptography`` package.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import mpc as J
from fedml_tpu.core.mpc import field_ops as JF
from fedml_tpu_torch.core import mpc as T
from fedml_tpu_torch.core.mpc import field_ops as TF

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

_P = int(J.P)
EDGE = np.asarray([0, 1, 2, 2**16 - 1, 2**16, 2**16 + 1, 2**30, 2**30 + 1,
                   2**31 - 2, _P - 1], np.uint32)


def _pairs(n=20000, seed=0):
    rng = np.random.RandomState(seed)
    # every edge value against every edge value, then seeded pairs
    a = np.concatenate([np.repeat(EDGE, len(EDGE)),
                        rng.randint(0, _P, n).astype(np.uint32)])
    b = np.concatenate([np.tile(EDGE, len(EDGE)),
                        rng.randint(0, _P, n).astype(np.uint32)])
    return a, b


def _port(x):
    """A port result as the wire's uint32 array."""
    return TF.to_uint32(x)


@pytest.mark.parametrize("op,ref", [
    ("ff_add", lambda a, b: (a + b) % _P),
    ("ff_sub", lambda a, b: (a - b) % _P),
    ("ff_mul", lambda a, b: (a * b) % _P),
    ("ff_neg", lambda a, b: (-a) % _P)])
def test_field_ops_bitwise(op, ref):
    a, b = _pairs()
    unary = op == "ff_neg"
    args_j = (jnp.asarray(a),) if unary else (jnp.asarray(a), jnp.asarray(b))
    args_t = (TF.lanes(a),) if unary else (TF.lanes(a), TF.lanes(b))
    got = _port(getattr(T, op)(*args_t))
    np.testing.assert_array_equal(got, np.asarray(getattr(J, op)(*args_j)))
    want = ref(a.astype(object), b.astype(object))
    np.testing.assert_array_equal(got.astype(object), want)
    assert got.dtype == np.uint32


def test_fold31_and_lanes_take_any_integer_input():
    x = np.concatenate([EDGE, [2**31, 2**32 - 1]]).astype(np.uint32)
    np.testing.assert_array_equal(_port(TF._fold31(TF.lanes(x))),
                                  np.asarray(JF._fold31(jnp.asarray(x))))
    # a numpy uint32 array, an int64 tensor and a Python list: one result
    want = np.asarray(J.ff_add(jnp.asarray(EDGE), jnp.asarray(EDGE)))
    for src in (EDGE, torch.from_numpy(EDGE.astype(np.int64)), EDGE.tolist()):
        np.testing.assert_array_equal(_port(T.ff_add(src, src)), want)


def _quant_inputs():
    rng = np.random.RandomState(2)
    q = 2.0 ** -16
    ties = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5],
                      np.float32) * np.float32(q)
    past = np.asarray([2.0 ** 13, -(2.0 ** 13), 1e9, -1e9, np.inf, -np.inf,
                       0.0, -0.0], np.float32)
    return np.concatenate([ties, past, (rng.randn(50000) * 4).astype(
        np.float32), (rng.randn(2000) * 1e-5).astype(np.float32)])


def test_quantize_bitwise():
    x = _quant_inputs()
    got = _port(T.quantize(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(J.quantize(jnp.asarray(x))))
    # ties round half to even; the clip is +-2^29
    assert list(got[:3]) == [0, 2, 2] and got[3] == 0
    assert got[8] == 2**29 and got[9] == _P - 2**29


def test_dequantize_bitwise():
    rng = np.random.RandomState(3)
    # signed values up to 2^30 (the float32 conversion rounds above 2^24)
    mags = np.concatenate([rng.randint(0, 2**30, 30000), np.asarray(
        [2**24 + 1, 2**25 + 3, 2**30 - 1, 0, 1])])
    q = np.concatenate([mags, _P - mags[mags > 0]]).astype(np.uint32)
    got = T.dequantize(TF.lanes(q)).numpy()
    want = np.asarray(J.dequantize(jnp.asarray(q)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantize_roundtrip_of_a_scaled_update():
    """The silo's path: a float32 delta times its sample count (float32
    on the tensor's device) quantized, the sum dequantized."""
    rng = np.random.RandomState(4)
    vec = (rng.randn(4096) * 1e-3).astype(np.float32)
    n = 1234.0
    got = _port(T.quantize(torch.from_numpy(vec) * n))
    np.testing.assert_array_equal(got, np.asarray(J.quantize(jnp.asarray(
        vec * np.float32(n)))))
    back = T.dequantize(TF.lanes(got)).numpy()
    np.testing.assert_allclose(back, vec * np.float32(n), atol=2.0 ** -16)


@pytest.mark.parametrize("k", [1, 4, 64])
def test_sum_mod_p_bitwise(k):
    rng = np.random.RandomState(k)
    m = rng.randint(0, _P, size=(k, 3000)).astype(np.uint32)
    m[:, :len(EDGE)] = EDGE
    got = _port(T.sum_mod_p(TF.lanes(m)))
    np.testing.assert_array_equal(got, np.asarray(J.sum_mod_p(jnp.asarray(m))))
    np.testing.assert_array_equal(got.astype(object),
                                  np.sum(m.astype(object), axis=0) % _P)


@pytest.mark.parametrize("shape", [(1,), (1000,), (7, 33)])
def test_ff_random_bitwise(shape):
    key = jax.random.PRNGKey(11)
    got = _port(T.ff_random(np.asarray(key), shape))
    want = np.asarray(J.ff_random(key, shape))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.max() < _P


def test_mask_vector_bitwise():
    rng = np.random.RandomState(5)
    q, b, s1, s2 = (rng.randint(0, _P, 5000).astype(np.uint32)
                    for _ in range(4))
    got = _port(T.mask_vector(*(TF.lanes(v) for v in (q, b, s1, s2))))
    want = np.asarray(J.mask_vector(*(jnp.asarray(v) for v in (q, b, s1, s2))))
    np.testing.assert_array_equal(got, want)


def test_shamir_expand_pairwise_and_lagrange_equal():
    for secret, n, t in ((123456789, 7, 4), (_P - 1, 5, 3), (0, 4, 2)):
        sj = J.shamir_share(secret, n, t, np.random.RandomState(n))
        st = T.shamir_share(secret, n, t, np.random.RandomState(n))
        assert sj == st
        assert T.shamir_reconstruct(st[:t]) == secret
        assert T.shamir_reconstruct(st[-t:]) == J.shamir_reconstruct(sj[-t:])
    xs = np.asarray([3, 9, 1, 14], np.uint64)
    for x0 in (0, 5, 17):
        np.testing.assert_array_equal(TF.lagrange_coeffs_at(xs, x0),
                                      JF.lagrange_coeffs_at(xs, x0))
    np.testing.assert_array_equal(TF.np_inv(xs), JF.np_inv(xs))
    for seed in (0, 7, 2**127 + 5, (1 << 256) - 1):
        for d in (1, 8, 13, 1001):
            np.testing.assert_array_equal(T.expand_mask(seed, d),
                                          J.expand_mask(seed, d))
    assert T.pairwise_seed(11, 99) == J.pairwise_seed(99, 11)


def _secagg_round(mod, n, t, drop, vecs):
    clients = [mod.SecAggClient(i, n, t, seed=100 + i) for i in range(n)]
    publics = {c.cid: c.public_key for c in clients}
    for c in clients:
        c.receive_publics(publics)
    seed_shares = {i: [] for i in range(n)}
    key_shares = {i: [] for i in range(n)}
    for c in clients:
        for j, (ss, ks) in c.make_shares().items():
            seed_shares[c.cid].append(ss)
            key_shares[c.cid].append(ks)
    surviving = [i for i in range(n) if i not in drop]
    masked = {i: clients[i].masked_update(vecs[i]) for i in surviving}
    total = np.zeros(len(vecs[0]), np.uint64)
    for m in masked.values():
        total = (total + m) % _P
    unmasked = mod.secagg_unmask(
        total.astype(np.uint32), surviving, list(drop),
        {i: seed_shares[i][:t] for i in surviving},
        {i: key_shares[i][:t] for i in drop}, publics, len(vecs[0]))
    return masked, unmasked, surviving


@pytest.mark.parametrize("n,t,drop", [(5, 3, ()), (5, 3, (2,)),
                                      (6, 3, (1, 4))])
def test_secagg_client_and_unmask_bitwise(n, t, drop):
    rng = np.random.RandomState(0)
    vecs = [(rng.randn(300) * 0.5).astype(np.float32) for _ in range(n)]
    jm, ju, surviving = _secagg_round(J, n, t, drop, [jnp.asarray(v)
                                                      for v in vecs])
    tm, tu, _ = _secagg_round(T, n, t, drop, [torch.from_numpy(v)
                                              for v in vecs])
    for i in surviving:
        np.testing.assert_array_equal(tm[i], jm[i])
        assert tm[i].dtype == np.uint32
    np.testing.assert_array_equal(tu, ju)
    # the unmasked sum is the survivors' quantized sum, exactly
    plain = T.sum_mod_p(torch.stack([T.quantize(torch.from_numpy(vecs[i]))
                                     for i in surviving]))
    np.testing.assert_array_equal(tu, _port(plain))


def test_lsa_coding_bitwise():
    n, t_priv, t_split, d = 6, 2, 2, 40
    rng = np.random.RandomState(0)
    masks = [rng.randint(0, _P, d).astype(np.uint64) for _ in range(n)]
    coded = {}
    for mod in (J, T):
        coded[mod] = [mod.mask_encoding(masks[i], n, t_priv, t_split,
                                        np.random.RandomState(50 + i))
                      for i in range(n)]
    for a, b in zip(coded[J], coded[T]):
        np.testing.assert_array_equal(a, b)
    surviving = [0, 1, 2, 4, 5]
    responses = [T.aggregate_encoded([coded[T][i][j] for i in surviving])
                 for j in surviving]
    np.testing.assert_array_equal(responses[0], J.aggregate_encoded(
        [coded[J][i][0] for i in surviving]))
    got = T.decode_aggregate_mask(responses, surviving, n, t_priv, t_split, d)
    np.testing.assert_array_equal(got, J.decode_aggregate_mask(
        responses, surviving, n, t_priv, t_split, d))
    want = np.zeros(d, np.uint64)
    for i in surviving:
        want = (want + masks[i]) % _P
    np.testing.assert_array_equal(got % _P, want)
    data = rng.randint(0, _P, size=(3, 10)).astype(np.uint64)
    cj = J.lcc_encode(data, 5, 1, np.random.RandomState(9))
    ct = T.lcc_encode(data, 5, 1, np.random.RandomState(9))
    np.testing.assert_array_equal(cj, ct)
    pts = [4, 0, 2, 3]
    np.testing.assert_array_equal(
        T.lcc_decode(ct[pts], pts, 3, 5, 1),
        J.lcc_decode(cj[pts], pts, 3, 5, 1))
    np.testing.assert_array_equal(T.lcc_decode(ct[pts], pts, 3, 5, 1), data)
