"""The port's copies of the JAX package's last data readers, and the
loader branches that reach them, against the JAX package's on the same
files: ``data/tff_h5.py`` (the checked-in TFF fixtures), ``fednlp_h5.py``
(an HDF5 pair written with h5py), ``images.py`` (an ImageNet folder tree
and a Landmarks mapping of PNGs written with PIL), ``finance.py`` (a
loan CSV and the NUS-WIDE CSVs) and ``edge_case.py``. Every array is
equal, dtype for dtype; so is each ``data.load`` of the names that reach
them, the segmentation stand-in's, and the synthetic gates.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import pytest

from fedml_tpu import data as jdata
from fedml_tpu.arguments import Arguments as JArgs
from fedml_tpu_torch import data as tdata
from fedml_tpu_torch.arguments import Arguments

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _same(a, b):
    """Equal values and shapes, and dtypes; integer arrays of the same
    kind only (the JAX package's containers hold them in 32 bits)."""
    a, b = np.asarray(a), np.asarray(b)
    same_dtype = (a.dtype.kind == b.dtype.kind if a.dtype.kind in "iu"
                  else a.dtype == b.dtype)
    assert same_dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape,
                                               b.shape)
    np.testing.assert_array_equal(a, b)


def _same_fed(j, t):
    for k in ("x", "y", "mask", "num_samples"):
        _same(getattr(j.train, k), getattr(t.train, k))
    for k in ("x", "y", "mask"):
        _same(j.test[k], t.test[k])
    assert (j.num_classes, tuple(j.input_shape), j.num_clients, j.task,
            getattr(j, "provenance", None)) == (
        t.num_classes, tuple(t.input_shape), t.num_clients, t.task,
        getattr(t, "provenance", None))


def _both_load(**cfg):
    """``data.load`` of both packages: their results, or the exception
    type each raised."""
    out = []
    for load, Args in ((jdata.load, JArgs), (tdata.load, Arguments)):
        try:
            out.append(load(Args(**cfg)))
        except Exception as e:  # compared below
            out.append(type(e).__name__)
    return out


def _write_img(path, rgb, size=24):
    from PIL import Image
    Image.fromarray(np.full((size, size, 3), rgb, np.uint8)).save(path)


def _imagenet(root, seed=0):
    rng = np.random.RandomState(seed)
    for split, n in (("train", 5), ("val", 2)):
        for wnid in ("n01", "n02", "n03"):
            d = root / split / wnid
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                _write_img(str(d / f"img_{i}.png"), rng.randint(0, 255, 3))


def _landmarks(root, with_test):
    (root / "images").mkdir(parents=True)
    rng = np.random.RandomState(1)
    rows = []
    for u in range(3):
        for i in range(3):
            img = f"u{u}_{i}"
            _write_img(str(root / "images" / f"{img}.jpg"),
                       rng.randint(0, 255, 3))
            rows.append((f"user_{u}", img, f"c{i % 2}"))
    with open(root / "federated_train.csv", "w") as f:
        f.write("user_id,image_id,class\n")
        f.writelines(",".join(r) + "\n" for r in rows)
    if with_test:
        with open(root / "test.csv", "w") as f:
            f.write("user_id,image_id,class\nx,u0_0,c0\nx,u1_1,c1\n")


def _fednlp(d):
    import h5py
    texts = ["the cat sat", "stocks rallied", "goal scored late",
             "rain tomorrow", "new phone launch", "court ruling",
             "a long text " * 20]
    labels = ["pets", "finance", "sports", "weather", "tech", "law", "pets"]
    with h5py.File(d / "tiny_data.h5", "w") as f:
        f["attributes"] = json.dumps({"num_labels": 6, "label_vocab": {
            lab: i for i, lab in enumerate(sorted(set(labels)))}})
        for i, (x, y) in enumerate(zip(texts, labels)):
            f[f"X/{i}"] = x
            f[f"Y/{i}"] = y
    with h5py.File(d / "tiny_partition.h5", "w") as f:
        pd = f.create_group("uniform").create_group("partition_data")
        pd.create_group("0")["train"] = [0, 1, 6]
        pd["0"]["test"] = [2]
        pd.create_group("1")["train"] = [3, 4]
        pd["1"]["test"] = [5]


def _loan_csv(d):
    from fedml_tpu.data.finance import LENDING_CLUB_FEATURES
    d.mkdir()
    rng = np.random.RandomState(0)
    with open(d / "loan.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(LENDING_CLUB_FEATURES) + ["loan_status"])
        for i in range(120):
            row = [f"{v:.3f}" for v in rng.randn(len(LENDING_CLUB_FEATURES))]
            w.writerow(row + [("Fully Paid", "Charged Off", "Current",
                               "In Grace")[i % 4]])


def _nus_wide(d):
    d.mkdir()
    rng = np.random.RandomState(2)
    np.savetxt(d / "features.csv", rng.randn(40, 6), delimiter=",")
    np.savetxt(d / "tags.csv", rng.randint(0, 2, (40, 5)), delimiter=",")
    np.savetxt(d / "labels.csv", rng.randint(0, 3, 40), delimiter=",",
               fmt="%d")


# -- the readers ----------------------------------------------------------

@pytest.mark.parametrize("name", ["fed_cifar100", "stackoverflow_nwp",
                                  "stackoverflow_lr"])
def test_tff_h5_reader(name):
    from fedml_tpu.data.tff_h5 import load_tff_dataset as J
    from fedml_tpu_torch.data.tff_h5 import load_tff_dataset as T
    d = os.path.join(FIXTURES, name)
    (jf, jo), (tf, to) = J(name, d, 4, max_clients=3), T(name, d, 4,
                                                       max_clients=3)
    assert jo == to
    _same_fed(jf, tf)
    assert T(name, os.path.join(FIXTURES, "absent"), 4) is None


def test_fednlp_h5_reader(tmp_path):
    from fedml_tpu.data.fednlp_h5 import \
        load_fednlp_text_classification as J
    from fedml_tpu_torch.data.fednlp_h5 import \
        load_fednlp_text_classification as T
    _fednlp(tmp_path)
    (jf, jo), (tf, to) = J(str(tmp_path), 2), T(str(tmp_path), 2)
    assert jo == to == 6
    _same_fed(jf, tf)
    assert T(str(tmp_path / "absent"), 2) is None


def test_image_folder_reader(tmp_path):
    from fedml_tpu.data.images import load_image_folder as J
    from fedml_tpu_torch.data.images import load_image_folder as T
    _imagenet(tmp_path)
    j, t = J(str(tmp_path), image_size=16), T(str(tmp_path), image_size=16)
    assert j[2] == t[2] == 3
    for a, b in zip(j[0] + j[1], t[0] + t[1]):
        _same(a, b)
    assert T(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("with_test", [True, False])
def test_landmarks_reader(tmp_path, with_test):
    from fedml_tpu.data.images import load_landmarks as J
    from fedml_tpu_torch.data.images import load_landmarks as T
    _landmarks(tmp_path, with_test)
    j = J(str(tmp_path), image_size=16, max_clients=2)
    t = T(str(tmp_path), image_size=16, max_clients=2)
    assert j[4] == t[4]
    for a, b in zip(j[0] + j[1] + [j[2], j[3]], t[0] + t[1] + [t[2], t[3]]):
        _same(a, b)


def test_finance_readers(tmp_path):
    from fedml_tpu.data import finance as J
    from fedml_tpu_torch.data import finance as T
    _loan_csv(tmp_path / "lending_club")
    _nus_wide(tmp_path / "nus_wide")
    for fn in ("load_lending_club", "load_nus_wide"):
        for a, b in zip(getattr(J, fn)(str(tmp_path)),
                        getattr(T, fn)(str(tmp_path))):
            _same(a, b)
    for fn, kw in (("synthetic_lending_club", dict(n=300, seed=4)),
                   ("synthetic_nus_wide", dict(n=200, seed=5))):
        for a, b in zip(getattr(J, fn)(**kw), getattr(T, fn)(**kw)):
            _same(a, b)
    assert T.LENDING_CLUB_FEATURES == J.LENDING_CLUB_FEATURES


@pytest.mark.parametrize("flat", [True, False])
def test_edge_case_set(flat):
    from fedml_tpu.data import edge_case as J
    from fedml_tpu_torch.data import edge_case as T
    rs = np.random.RandomState(3)
    x = rs.rand(60, 64).astype(np.float32) if flat else \
        rs.rand(60, 8, 8, 1).astype(np.float32)
    y = rs.randint(0, 3, 60)
    j = J.build_edge_case_set(x, y, 1, 2, seed=7)
    t = T.build_edge_case_set(x, y, 1, 2, seed=7)
    for k in ("x_poison", "x_eval", "source_label", "target_label"):
        _same(getattr(j, k), getattr(t, k))

    def predict(v):
        return (np.asarray(v).reshape(len(v), -1).sum(-1) > 30).astype(int)

    assert J.attack_success_rate(predict, j) == T.attack_success_rate(
        predict, t)
    cfg = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
               batch_size=16, max_total_samples=200)
    fed, _ = tdata.load(Arguments(**cfg))
    edge = T.build_edge_case_set(fed.test["x"].reshape(-1, 784),
                                 fed.test["y"].reshape(-1), 1, 2)
    byz = np.array([1, 0, 1, 0])
    jp = J.inject_edge_cases(jdata.load(JArgs(**cfg))[0],
                             J.EdgeCaseSet(**vars(edge)), byz)
    tp = T.inject_edge_cases(fed, edge, byz)
    _same(jp.train.x, tp.train.x)
    _same(jp.train.y, tp.train.y)


# -- the loader's branches ------------------------------------------------

LOAD = dict(client_num_in_total=3, batch_size=4, random_seed=0,
            model="cnn")


@pytest.mark.parametrize("name", ["fed_cifar100", "stackoverflow_nwp",
                                  "stackoverflow_lr"])
def test_load_tff_names(name):
    j, t = _both_load(dataset=name, data_cache_dir=FIXTURES, **LOAD)
    assert j[1] == t[1]
    _same_fed(j[0], t[0])


def test_load_fednlp_imagenet_landmarks(tmp_path):
    (tmp_path / "fednlp_tiny").mkdir()
    _fednlp(tmp_path / "fednlp_tiny")
    _imagenet(tmp_path / "tiny_imagenet")
    _landmarks(tmp_path / "gld23k", with_test=False)
    for name in ("fednlp_tiny", "tiny_imagenet", "gld23k"):
        j, t = _both_load(dataset=name, data_cache_dir=str(tmp_path),
                          partition_method="homo", **LOAD)
        assert j[1] == t[1], name
        _same_fed(j[0], t[0])


@pytest.mark.parametrize("name,synthetic", [
    ("lending_club", False), ("nus_wide", False), ("loan", True),
    ("nus_wide", True)])
def test_load_finance_names(tmp_path, name, synthetic):
    if not synthetic:
        _loan_csv(tmp_path / "lending_club")
        _nus_wide(tmp_path / "nus_wide")
    j, t = _both_load(dataset=name, data_cache_dir=str(tmp_path),
                      allow_synthetic=synthetic, **dict(LOAD, model="lr"))
    assert j[1] == t[1]
    _same_fed(j[0], t[0])
    assert t[0].provenance == ("synthetic" if synthetic else "real")


@pytest.mark.parametrize("name", ["seg", "segmentation", "synthetic_seg",
                                  "pascal_voc", "coco_seg"])
def test_load_segmentation_names(name):
    j, t = _both_load(dataset=name, allow_synthetic=True, **LOAD)
    assert j[1] == t[1] == 3
    _same_fed(j[0], t[0])
    assert t[0].task == "segmentation"


@pytest.mark.parametrize("name", ["fednlp_agnews", "imagenet", "gld160k",
                                  "lending_club", "nus_wide", "pascal_voc"])
def test_absent_real_data_stays_gated(tmp_path, name):
    """No files and no ``allow_synthetic``: both loaders refuse (as the
    JAX one does after its download fails)."""
    j, t = _both_load(dataset=name, data_cache_dir=str(tmp_path), **LOAD)
    assert j == t == "DatasetUnavailableError"
