"""The port's CIFAR-10 loader against ``fedml_tpu.data.load``: client arrays,
masks, sample counts and the test set must be exactly equal."""

from __future__ import annotations

import numpy as np
import pytest

import fedml_tpu.data as jdata
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch.arguments import Arguments as TArguments

pytestmark = pytest.mark.torch_port


def _both(**cfg):
    fj, odj = jdata.load(JArguments(**cfg))
    ft, odt = tdata.load(TArguments(**cfg))
    assert odj == odt == 10
    return fj, ft


def _assert_same(fj, ft):
    for name in ("x", "y", "mask", "num_samples"):
        a = np.asarray(getattr(fj.train, name))
        b = getattr(ft.train, name)
        # JAX holds integers in 32 bits by default; the values must agree
        assert a.dtype.kind == b.dtype.kind, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("x", "y", "mask"):
        np.testing.assert_array_equal(ft.test[name],
                                      np.asarray(fj.test[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(ft.client_num_samples,
                                  fj.client_num_samples)
    assert ft.num_clients == fj.num_clients
    assert ft.input_shape == fj.input_shape
    assert ft.provenance == fj.provenance


@pytest.mark.parametrize("cfg", [
    dict(client_num_in_total=4, batch_size=8, random_seed=0,
         max_total_samples=96, synthetic_test_size=40),
    dict(client_num_in_total=6, batch_size=16, random_seed=5,
         max_total_samples=200, synthetic_test_size=300,
         partition_alpha=0.1),
    dict(client_num_in_total=3, batch_size=4, random_seed=2,
         max_total_samples=30, synthetic_test_size=16,
         partition_method="homo"),
], ids=["hetero", "skewed", "homo"])
def test_synthetic_cifar10_exactly_equal(cfg):
    fj, ft = _both(dataset="synthetic_cifar10", model="resnet20", **cfg)
    _assert_same(fj, ft)
    assert ft.provenance == "synthetic"
    # uneven clients: the padded tail batches are masked out
    counts = ft.client_num_samples
    assert ft.train.mask.sum(axis=(1, 2)).tolist() == counts.tolist()


def test_cifar10_npz_cache_exactly_equal(tmp_path):
    """A real-data cache (uint8 pixels, like the Keras archive) is read,
    scaled to [0, 1] and partitioned exactly as the JAX loader does."""
    rs = np.random.RandomState(0)
    np.savez(tmp_path / "cifar10.npz",
             x_train=rs.randint(0, 256, (120, 32, 32, 3), dtype=np.uint8),
             y_train=rs.randint(0, 10, 120).astype(np.int64),
             x_test=rs.randint(0, 256, (20, 32, 32, 3), dtype=np.uint8),
             y_test=rs.randint(0, 10, 20).astype(np.int64))
    fj, ft = _both(dataset="cifar10", model="resnet20",
                   data_cache_dir=str(tmp_path), client_num_in_total=4,
                   batch_size=8, random_seed=1)
    _assert_same(fj, ft)
    assert ft.provenance == "real"
    assert 0.0 <= ft.train.x.min() and ft.train.x.max() <= 1.0


def test_missing_cache_needs_opt_in(tmp_path, monkeypatch):
    monkeypatch.delenv("FEDML_TPU_ALLOW_SYNTHETIC", raising=False)
    cfg = dict(dataset="cifar10", model="resnet20",
               data_cache_dir=str(tmp_path), client_num_in_total=2,
               batch_size=8, max_total_samples=32, synthetic_test_size=8)
    with pytest.raises(tdata.DatasetUnavailableError):
        tdata.load(TArguments(**cfg))
    fed, _ = tdata.load(TArguments(allow_synthetic=True, **cfg))
    assert fed.provenance == "synthetic"
    # the stand-in is the same generator the synthetic_ name draws from
    fs, _ = tdata.load(TArguments(**{**cfg, "dataset": "synthetic_cifar10"}))
    np.testing.assert_array_equal(fed.train.x, fs.train.x)


def test_unported_dataset_raises():
    # digits is ported (bundled); the FedNLP reader is not
    with pytest.raises(NotImplementedError, match="dataset"):
        tdata.load(TArguments(dataset="fednlp_agnews"))
