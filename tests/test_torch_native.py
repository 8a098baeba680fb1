"""The port's native device core (``fedml_tpu_torch/native``: the JAX
package's ``mobilenn.cpp`` and C ABI built with the same ``g++`` flags
into the checkout's ``build/``) against the JAX binding, bit for bit: the
field masks, masking and unmasking, the linear and CNN trainers and
evaluators, LightSecAgg's coding, and a core that does not build."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from fedml_tpu import native as jnative
from fedml_tpu_torch import native

pytestmark = pytest.mark.torch_port


def test_same_source_and_build_dir():
    with open(native._SRC, "rb") as f, open(jnative._SRC, "rb") as g:
        assert f.read() == g.read()
    assert native.available()
    assert native._cache_path().startswith(str(native.BUILD_DIR))


@pytest.mark.parametrize("n,seed", [(1, 0), (500, 11), (4097, 2 ** 40 + 3)])
def test_gen_mask_equal(n, seed):
    np.testing.assert_array_equal(native.gen_mask(n, seed),
                                  jnative.gen_mask(n, seed))


@pytest.mark.parametrize("scale,seed", [(65536.0, 5), (2.0 ** 20, 77),
                                        (1.0, 0)])
def test_mask_and_unmask_equal(scale, seed):
    v = np.random.RandomState(seed).randn(1000).astype(np.float32) * 3
    m = native.mask_vector(v, scale, seed)
    np.testing.assert_array_equal(m, jnative.mask_vector(v, scale, seed))
    u = native.unmask_vector(m, scale, seed)
    np.testing.assert_array_equal(u, jnative.unmask_vector(m, scale, seed))
    np.testing.assert_allclose(u, v, atol=1.0 / scale)


def _digits():
    from sklearn.datasets import load_digits
    ds = load_digits()
    return (ds.data / 16.0).astype(np.float32), ds.target.astype(np.int32)


@pytest.mark.parametrize("batch,epochs,lr,seed", [(32, 2, 0.3, 1),
                                                  (7, 1, 0.05, 9)])
def test_linear_trainer_equal(batch, epochs, lr, seed):
    x, y = _digits()
    rs = np.random.RandomState(seed)
    params = {"Dense_0": {"kernel": rs.randn(64, 10).astype(np.float32)
                          * 0.01, "bias": np.zeros(10, np.float32)}}
    p, loss = native.NativeLinearTrainer().train(
        copy.deepcopy(params), x[:600], y[:600], epochs=epochs,
        batch_size=batch, lr=lr, seed=seed)
    jp, jloss = jnative.NativeLinearTrainer().train(
        copy.deepcopy(params), x[:600], y[:600], epochs=epochs,
        batch_size=batch, lr=lr, seed=seed)
    assert loss == jloss
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(p["Dense_0"][k], jp["Dense_0"][k])
    assert native.NativeLinearTrainer().evaluate(p, x[600:], y[600:]) == \
        jnative.NativeLinearTrainer().evaluate(jp, x[600:], y[600:])


def test_cnn_trainer_equal():
    x, y = _digits()
    x = x.reshape(-1, 8, 8, 1)
    rs = np.random.RandomState(4)
    params = {"Conv_0": {"kernel": rs.randn(3, 3, 1, 8).astype(np.float32)
                         * 0.3, "bias": np.zeros(8, np.float32)},
              "Conv_1": {"kernel": rs.randn(3, 3, 8, 16).astype(np.float32)
                         * 0.1, "bias": np.zeros(16, np.float32)},
              "Dense_0": {"kernel": rs.randn(64, 10).astype(np.float32)
                          * 0.1, "bias": np.zeros(10, np.float32)}}
    p, loss = native.NativeCNNTrainer().train(
        copy.deepcopy(params), x[:256], y[:256], epochs=1, batch_size=32,
        lr=0.1, seed=3)
    jp, jloss = jnative.NativeCNNTrainer().train(
        copy.deepcopy(params), x[:256], y[:256], epochs=1, batch_size=32,
        lr=0.1, seed=3)
    assert loss == jloss
    for layer in p:
        for leaf in p[layer]:
            np.testing.assert_array_equal(p[layer][leaf], jp[layer][leaf])
    assert native.NativeCNNTrainer().evaluate(p, x[256:], y[256:]) == \
        jnative.NativeCNNTrainer().evaluate(jp, x[256:], y[256:])


def test_lsa_encode_equal():
    z = np.random.RandomState(2).randint(0, native.PRIME, size=24).astype(
        np.uint32)
    np.testing.assert_array_equal(native.lsa_mask_encode(z, 5, 2, 3, seed=9),
                                  jnative.lsa_mask_encode(z, 5, 2, 3, seed=9))
    with pytest.raises(ValueError, match="divide"):
        native.lsa_mask_encode(z[:23], 5, 2, 3, seed=9)


def test_a_core_that_does_not_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a core that does not compile raises wherever it
    is used, and the torch-engine device is never substituted."""
    bad = tmp_path / "mobilenn.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    with pytest.raises(native.NativeBuildError, match="build failed"):
        native.NativeLinearTrainer()
    with pytest.raises(native.NativeBuildError):
        native.gen_mask(4, 1)
