"""The port's new dataset paths against ``fedml_tpu.data.load``: client
arrays, masks, sample counts, the test set and the provenance must be
exactly equal.

* ``digits``, ``wine`` and ``breast_cancer``: the JAX loader imports
  scikit-learn's tables (and caches them as ``<name>.npz``); the port reads
  its bundled ``sklearn_bundled.npz`` and applies the same recipe.
* ``shakespeare``: both materialise the bundled text as a LEAF split.
* the synthetic ``sequences``, ``multilabel`` / ``stackoverflow_lr`` and
  LEAF-style ``synthetic_alpha_beta`` sets.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest

import fedml_tpu.data as jdata
from fedml_tpu.arguments import Arguments as JArguments
from fedml_tpu.data.bundled import materialize_mini_shakespeare as j_mat
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch.arguments import Arguments as TArguments
from fedml_tpu_torch.data import acquire as tacquire
from fedml_tpu_torch.data.bundled import materialize_mini_shakespeare as t_mat

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(tmp_path, **cfg):
    """Each package loads from a cache dir of its own (the JAX loader
    writes its scikit-learn tables there)."""
    fj, odj = jdata.load(JArguments(data_cache_dir=str(tmp_path / "j"),
                                    **cfg))
    ft, odt = tdata.load(TArguments(data_cache_dir=str(tmp_path / "t"),
                                    **cfg))
    assert odj == odt
    for name in ("x", "y", "mask", "num_samples"):
        a = np.asarray(getattr(fj.train, name))
        b = getattr(ft.train, name)
        assert a.dtype.kind == b.dtype.kind, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("x", "y", "mask"):
        np.testing.assert_array_equal(ft.test[name],
                                      np.asarray(fj.test[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(ft.client_num_samples,
                                  fj.client_num_samples)
    assert ft.input_shape == fj.input_shape
    assert ft.task == fj.task
    assert ft.provenance == fj.provenance
    assert ft.num_classes == fj.num_classes
    return fj, ft


@pytest.mark.parametrize("name,model", [
    ("digits", "lr"), ("digits", "cnn"), ("wine", "lr"),
    ("breast_cancer", "mlp")])
def test_bundled_real_tables_equal_jax(tmp_path, name, model):
    _, ft = _both(tmp_path, dataset=name, model=model,
                  client_num_in_total=10, batch_size=32, random_seed=0)
    assert ft.provenance == "real"
    # the port writes nothing into its cache: it reads the bundled copy
    assert not os.path.exists(tmp_path / "t" / f"{name}.npz")


def test_npz_cache_comes_first(tmp_path):
    """An offline ``digits.npz`` in the cache dir wins over the bundled
    copy, in both packages."""
    rs = np.random.RandomState(0)
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    arrays = dict(x_train=rs.randint(0, 17, (60, 8, 8)).astype(np.float32),
                  y_train=rs.randint(0, 10, 60),
                  x_test=rs.randint(0, 17, (20, 8, 8)).astype(np.float32),
                  y_test=rs.randint(0, 10, 20))
    for side in ("j", "t"):
        np.savez(tmp_path / side / "digits.npz", **arrays)
    _, ft = _both(tmp_path, dataset="digits", model="lr",
                  client_num_in_total=3, batch_size=8)
    assert ft.train.num_samples.sum() == 60


def test_bundled_npz_equals_a_fresh_sklearn_export():
    """The committed tables are scikit-learn's, raw: digits as uint8
    pixels 0-16, the other two as float32 features, int64 targets."""
    spec = importlib.util.spec_from_file_location(
        "export_sklearn_bundled",
        os.path.join(ROOT, "scripts", "export_sklearn_bundled.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.export()
    with np.load(tacquire.BUNDLED_NPZ) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    assert fresh["digits_x"].dtype == np.uint8
    assert fresh["wine_x"].dtype == fresh["breast_cancer_x"].dtype \
        == np.float32
    assert os.path.getsize(tacquire.BUNDLED_NPZ) < 128 * 1024


@pytest.mark.parametrize("name", ["digits", "wine", "breast_cancer"])
def test_sklearn_recipe_equals_jax(name):
    from fedml_tpu.data.acquire import _sklearn_bundled
    want = _sklearn_bundled(name)
    got = tacquire.sklearn_bundled(name)
    for (a, b), (c, d) in zip(got, want):
        assert a.dtype == c.dtype and b.dtype == d.dtype
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_materialized_shakespeare_equals_jax(tmp_path):
    dj, dt = j_mat(str(tmp_path / "j")), t_mat(str(tmp_path / "t"))
    for split in ("train", "test"):
        with open(os.path.join(dj, split, "data.json")) as f:
            a = json.load(f)
        with open(os.path.join(dt, split, "data.json")) as f:
            b = json.load(f)
        assert a == b
    # idempotent
    assert t_mat(str(tmp_path / "t")) == dt


@pytest.mark.parametrize("cfg", [
    dict(dataset="shakespeare", client_num_in_total=10, batch_size=16),
    dict(dataset="fed_shakespeare", client_num_in_total=4, batch_size=8),
], ids=["shakespeare", "fed_shakespeare_4"])
def test_shakespeare_leaf_equals_jax(tmp_path, cfg):
    _, ft = _both(tmp_path, model="rnn", **cfg)
    assert ft.task == "sequence" and ft.provenance == "real"
    assert ft.train.x.dtype == np.int32 and ft.train.y.shape[-1] == 80


@pytest.mark.parametrize("cfg", [
    dict(dataset="sequences", model="rnn"),
    dict(dataset="synthetic_shakespeare", model="rnn"),
    dict(dataset="synthetic_multilabel", model="lr"),
    dict(dataset="stackoverflow_lr", model="lr", allow_synthetic=True),
    dict(dataset="synthetic", model="lr"),
    dict(dataset="synthetic_1_1", model="lr"),
    dict(dataset="synthetic_0_0", model="lr"),
    dict(dataset="synthetic_0.5_0.5", model="lr"),
    dict(dataset="synthetic_iid", model="lr"),
    dict(dataset="synthetic_femnist", model="cnn", max_total_samples=300,
         synthetic_test_size=50),
    dict(dataset="synthetic_cinic10", model="simple_cnn",
         max_total_samples=300, synthetic_test_size=50),
    dict(dataset="celeba", model="lr", allow_synthetic=True),
])
def test_synthetic_sets_equal_jax(tmp_path, cfg):
    _both(tmp_path, client_num_in_total=5, batch_size=8, random_seed=3,
          **cfg)


def test_stand_ins_stay_gated(tmp_path):
    for name in ("stackoverflow_lr", "reddit", "femnist", "wine_x"):
        with pytest.raises(tdata.DatasetUnavailableError):
            tdata.load(TArguments(dataset=name, client_num_in_total=2,
                                  data_cache_dir=str(tmp_path)))


@pytest.mark.parametrize("name", [
    "fednlp_agnews", "imagenet", "landmarks", "lending_club", "nus_wide",
    "pascal_voc", "segmentation"])
def test_unported_readers_raise(tmp_path, name):
    with pytest.raises(NotImplementedError, match="not ported"):
        tdata.load(TArguments(dataset=name, client_num_in_total=2,
                              data_cache_dir=str(tmp_path)))


def test_tff_shards_on_disk_raise(tmp_path):
    """With a TFF directory on disk the JAX loader reads its HDF5 shards;
    the port has no reader for them and says so (with none on disk it
    takes the synthetic stand-in, as the JAX loader does)."""
    os.makedirs(tmp_path / "stackoverflow_lr")
    with pytest.raises(NotImplementedError, match="tff_h5"):
        tdata.load(TArguments(dataset="stackoverflow_lr",
                              client_num_in_total=2, allow_synthetic=True,
                              data_cache_dir=str(tmp_path)))
