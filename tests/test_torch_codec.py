"""The port's msgpack wire codec against the JAX package's
(``core/distributed/communication/message.py`` in both).

Byte equality, not value equality: the same tree must serialize to the same
bytes in both packages, so an artifact, an adapter export or a message one
writes is the other's, bit for bit. The trees mix what the JAX package's
``dumps_tree`` normalises (unsorted nested keys, tuples, ``None``, Python
and numpy scalars, 0-d and empty arrays, non-contiguous views) and every
leaf dtype the system writes, bf16 included (a ``torch.bfloat16`` tensor on
the port's side, an ml_dtypes bfloat16 array on the JAX side). Inputs come
from numpy seeds, and a hypothesis property covers generated trees.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fedml_tpu.core.distributed.communication import message as jmsg
from fedml_tpu_torch.core.distributed.communication import message as tmsg

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

BF16 = np.dtype(jnp.bfloat16)
DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_)


def _array(rs, dtype, shape):
    if dtype == np.bool_:
        return np.asarray(rs.rand(*shape) > 0.5)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rs.randint(max(info.min, -1000), min(info.max, 1000),
                          size=shape).astype(dtype)
    return np.asarray(rs.randn(*shape)).astype(dtype)


def _to_torch(tree):
    """The port's side of a tree: numpy leaves as CPU tensors, ml_dtypes
    bf16 leaves as ``torch.bfloat16`` tensors with the same bits; the rest
    (scalars, None, strings) as they are."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        if tree.dtype == BF16:
            return torch.from_numpy(
                np.ascontiguousarray(tree).view(np.int16)).view(
                    torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


def _mixed_tree(seed):
    rs = np.random.RandomState(seed)
    base = rs.randn(6, 8).astype(np.float32)
    return {
        "zeta": {"b": _array(rs, np.float32, (3, 4)),
                 "a": [_array(rs, np.int64, (5,)), None,
                       (_array(rs, np.uint8, (2, 2)), 7)]},
        "alpha": 1.5, "count": 3, "flag": True,
        "np_f32": np.float32(2.25), "np_i64": np.int64(-9),
        "np_f64": np.float64(0.125),
        "zero_d": np.asarray(np.float32(4.0)), "empty": np.zeros((0, 3)),
        "strided": base[::2, 1::3], "transposed": base.T,
        "bf16": rs.randn(4, 3).astype(BF16),
        "dtypes": {np.dtype(d).name: _array(rs, d, (2, 3)) for d in DTYPES},
        "name": "silo_0",
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dumps_tree_is_byte_equal(seed):
    tree = _mixed_tree(seed)
    blob = jmsg.dumps_tree(tree)
    assert tmsg.dumps_tree(tree) == blob            # numpy leaves
    assert tmsg.dumps_tree(_to_torch(tree)) == blob  # tensor leaves


def test_each_package_loads_the_others_blob():
    tree = _mixed_tree(4)
    jblob, tblob = jmsg.dumps_tree(tree), tmsg.dumps_tree(_to_torch(tree))
    a, b = jmsg.loads_tree(tblob), tmsg.loads_tree(jblob)
    fa, fb = jmsg.tree_to_wire(a), tmsg.tree_to_wire(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k
    # what the normalisation does, as both load it back
    assert b["zero_d"].shape == (1,) and b["np_f64"].dtype == np.float64
    assert b["zeta"]["a"][1] is None and isinstance(b["zeta"]["a"][2], list)


def test_bf16_leaf_is_written_as_V2_and_loads_as_void():
    bits = np.array([0x3F80, 0xC000, 0x7FC0, 0x0001, 0xFF80], np.uint16)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    blob = tmsg.dumps_tree({"w": t})
    assert b"<V2" in blob
    assert blob == jmsg.dumps_tree({"w": bits.view(BF16)})
    for loads in (jmsg.loads_tree, tmsg.loads_tree):
        leaf = loads(blob)["w"]
        assert leaf.dtype == np.dtype("|V2")
        assert leaf.tobytes() == bits.tobytes()
    back = tmsg.array_to_tensor(tmsg.loads_tree(blob)["w"])
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_large_maps_and_long_strings(n):
    """msgpack's fixmap / map16 / map32 and str8 / str16 / str32 headers."""
    rs = np.random.RandomState(n)
    tree = {f"k{i:06d}": i % 7 for i in rs.permutation(n)}
    tree["s"] = "x" * (n + 200)
    tree["arr"] = rs.randn(n % 97).astype(np.float32)
    assert tmsg.dumps_tree(tree) == jmsg.dumps_tree(tree)
    m = {"msg_type": 3, "big": {str(i): i for i in range(n)},
         "text": "y" * n}
    jm, tm = jmsg.Message(3, 1, 2), tmsg.Message(3, 1, 2)
    for k, v in m.items():
        jm.add(k, v)
        tm.add(k, v)
    assert tm.encode() == jm.encode()


def test_message_encode_decode_and_wire_stats():
    rs = np.random.RandomState(5)
    w = rs.randn(3, 5).astype(np.float32)
    payload = {"model_params": {"Dense_0": {"kernel": w,
                                            "bias": np.zeros(5, np.float32)}},
               "num_samples": np.int64(40), "lr": np.float32(0.1),
               "weight": np.float64(0.5), "ids": [1, 2, 3],
               "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
               "nested": {"z": 1, "a": None}}
    jm, tm = jmsg.Message(7, 0, 3), tmsg.Message(7, 0, 3)
    for k, v in payload.items():
        jm.add_params(k, v)
        tm.add_params(k, v)
    jmsg.WIRE_STATS.reset()
    tmsg.WIRE_STATS.reset()
    jb = jm.encode()
    # the port's payload carries tensors where the JAX one has arrays
    tm.add_params("model_params",
                  {"Dense_0": {"kernel": torch.from_numpy(w),
                               "bias": torch.zeros(5)}})
    tb = tm.encode()
    assert tb == jb
    assert tmsg.WIRE_STATS.snapshot() == jmsg.WIRE_STATS.snapshot()
    assert tmsg.WIRE_STATS.total_bytes == len(jb)
    for dec in (jmsg.Message.decode(tb), tmsg.Message.decode(jb)):
        got = dec.get("model_params")["Dense_0"]["kernel"]
        np.testing.assert_array_equal(got, w)
        assert dec.get_type() == 7 and dec.get_receiver_id() == 3
        # np.float64 is a Python float: a msgpack float; np.int64 and
        # np.float32 go through the array hook
        assert dec.get("weight") == 0.5
        assert dec.get("num_samples").shape == (1,)
    tm.add_params("bad", object())
    with pytest.raises(TypeError, match="cannot serialize"):
        tm.encode()


def _wire_tree(seed):
    rs = np.random.RandomState(seed)
    return {"layer_1": {"kernel": rs.randn(4, 3).astype(np.float32),
                        "bias": rs.randn(3).astype(np.float32)},
            "layer_0": [rs.randn(2, 2).astype(np.float32),
                        rs.randn(5).astype(np.float64)],
            "skip": None, "step": np.asarray(np.float32(3.0))}


def test_tree_to_wire_and_back():
    tree = _wire_tree(6)
    jw, tw = jmsg.tree_to_wire(tree), tmsg.tree_to_wire(_to_torch(tree))
    assert list(tw) == list(jw)
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k])
        assert tw[k].dtype == jw[k].dtype and tw[k].shape == jw[k].shape
    back = tmsg.wire_to_tree(tw, tree)
    assert jmsg.dumps_tree(back) == jmsg.dumps_tree(
        jmsg.wire_to_tree(jw, tree))


# float32 bit patterns where rounding to bf16 is delicate: NaNs with
# payloads and signs, infinities, signed zeros, subnormals, values exactly
# halfway between two bf16 numbers (ties to even, both parities), just
# above and below halfway, the largest finite value (rounds to inf)
EDGE_BITS = np.array([
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF, 0xFFFFFFFF,
    0x7F800000, 0xFF800000, 0x00000000, 0x80000000, 0x00000001, 0x80000001,
    0x00008000, 0x00018000, 0x007FFFFF, 0x00800000, 0x3F808000, 0x3F818000,
    0x3F808001, 0x3F807FFF, 0xBF808000, 0xBF818000, 0x7F7FFFFF, 0x7F7F8000,
    0x7F7F7FFF, 0x3F800000], np.uint32)


@pytest.mark.parametrize("source", ["edges", "random_bits", "random_f64"])
def test_bf16_wire_rounding_matches_ml_dtypes(source):
    rs = np.random.RandomState(7)
    if source == "edges":
        vals = EDGE_BITS.view(np.float32)
    elif source == "random_bits":
        vals = rs.randint(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    else:   # f64 leaves round through f32 in both
        vals = rs.randn(50_000) * (1 + 2.0 ** -8) + 2.0 ** -40
    tree = {"w": vals, "z": np.asarray(np.float32(1.0 + 2 ** -8))}
    with np.errstate(invalid="ignore", over="ignore"):
        jw = jmsg.tree_to_wire_bf16(tree)
    tw = tmsg.tree_to_wire_bf16(tree)
    for k in jw:
        assert tw[k].dtype == jw[k].dtype == np.uint16
        assert tw[k].shape == jw[k].shape
        bad = np.flatnonzero(tw[k] != jw[k])
        assert bad.size == 0, (k, [hex(int(b)) for b in
                                   np.asarray(vals).view(np.uint32)[bad[:4]]]
                               if k == "w" and source != "random_f64" else bad)
    jt = jmsg.bf16_wire_to_tree(jw, tree)
    tt = tmsg.bf16_wire_to_tree(tw, _to_torch(tree))
    for k in jt:
        assert tt[k].dtype == jt[k].dtype
        assert tt[k].tobytes() == jt[k].tobytes(), k


_leaf = st.builds(
    lambda seed, dt, shape: _array(np.random.RandomState(seed), dt, shape),
    st.integers(0, 2 ** 16), st.sampled_from(DTYPES),
    st.lists(st.integers(0, 3), max_size=3).map(tuple))
_scalar = st.one_of(st.none(), st.booleans(), st.integers(-2 ** 40, 2 ** 40),
                    st.floats(allow_nan=False), st.text(max_size=20))
_trees = st.recursive(
    st.one_of(_leaf, _scalar),
    lambda kids: st.one_of(
        st.lists(kids, max_size=4),
        st.lists(kids, max_size=3).map(tuple),
        st.dictionaries(st.text(min_size=1, max_size=8), kids, max_size=5)),
    max_leaves=12)


# generation may be slow on a loaded CPU; the property itself is exact
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_trees)
def test_property_dumps_tree_byte_equal(tree):
    blob = jmsg.dumps_tree(tree)
    assert tmsg.dumps_tree(tree) == blob
    assert tmsg.dumps_tree(_to_torch(tree)) == blob
    assert tmsg.dumps_tree(tmsg.loads_tree(blob)) == blob
