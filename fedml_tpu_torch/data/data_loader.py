"""Dataset dispatch: ``fedml_tpu_torch.data.load(args)`` (counterpart of
``fedml_tpu/data/data_loader.py``), in the reference's order:

1. Local caches of the reference's on-disk formats, each read when its
   files are present: the TFF HDF5 shards (``fed_cifar100``,
   ``stackoverflow_nwp``, ``stackoverflow_lr``; :mod:`.tff_h5`), the
   FedNLP HDF5 pair (``fednlp*``; :mod:`.fednlp_h5`), an ImageNet-style
   folder tree (``imagenet``, ``ilsvrc2012``, ``tiny_imagenet``) and the
   Landmarks CSV mappings (``landmarks``, ``gld23k``, ``gld160k``;
   :mod:`.images`), under ``<data_cache_dir>/<name>/``.
2. LEAF natural partitions (``femnist``, ``shakespeare``,
   ``fed_shakespeare``, ``celeba``, ``sent140``, ``reddit``) from
   ``<data_cache_dir>/<name>/{train,test}/*.json``; with no LEAF split on
   disk, ``shakespeare`` materialises the bundled real text (client =
   speaking role).
3. The LEAF-style ``synthetic``, ``synthetic_1_1``, ``synthetic_0_0``,
   ``synthetic_0.5_0.5`` and ``synthetic_iid`` sets (per-client logistic
   models, Li et al.).
4. ``stackoverflow_lr`` / ``multilabel``: the synthetic multilabel
   tag-prediction stand-in (``task="multilabel"``).
5. The image and tabular tables: an offline ``<name>.npz`` cache
   (``x_train``/``y_train``/``x_test``/``y_test``; :func:`.acquire.
   import_archive` writes one), then for ``digits`` / ``wine`` /
   ``breast_cancer`` the bundled copy (:mod:`.acquire`), else the
   labelled synthetic stand-in.
6. The finance tables (``lending_club``, ``lending_club_loan``, ``loan``,
   ``nus_wide``: preprocessed CSVs, :mod:`.finance`) and the segmentation
   stand-in (``pascal_voc``, ``coco_seg``, ``seg``, ``segmentation``;
   ``task="segmentation"``, which the runner sends to FedSeg).
7. The synthetic next-token ``sequences`` (``task="sequence"``), which
   ``shakespeare``, ``fed_shakespeare``, ``stackoverflow_nwp`` and
   ``reddit`` fall back to with no data.
8. Anything else: the MNIST-shaped synthetic set.

A stand-in for a named real dataset is used only when ``allow_synthetic``
(or ``$FEDML_TPU_ALLOW_SYNTHETIC``) is set, loudly, and the dataset's
``provenance`` says ``synthetic``. The port has no download code: a
reader whose files are absent falls through, as the JAX loader's does
after a failed download.

Every path produces exactly the JAX loader's padded client arrays, masks,
sample counts and test set. Linear models (``lr``, ``logistic_regression``,
``mlp``) take flat input.
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Tuple

import numpy as np

from . import synthetic
from .containers import (FederatedDataset, build_federated_dataset,
                         from_central_arrays)

logger = logging.getLogger(__name__)

_IMAGE_DATASETS = {
    "mnist": ((28, 28, 1), 10),
    "femnist": ((28, 28, 1), 62),
    "fashionmnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
    "cifar100": ((32, 32, 3), 100),
    "fed_cifar100": ((32, 32, 3), 100),
    "cinic10": ((32, 32, 3), 10),
    "digits": ((8, 8, 1), 10),     # real, bundled
}

# real tabular UCI sets, bundled: (n_features, n_classes)
_TABULAR_DATASETS = {
    "wine": (13, 3),
    "breast_cancer": (30, 2),
}

_LEAF = ("femnist", "shakespeare", "fed_shakespeare", "celeba", "sent140",
         "reddit")

_SYNTHETIC_AB = {"synthetic": (1.0, 1.0), "synthetic_1_1": (1.0, 1.0),
                 "synthetic_0_0": (0.0, 0.0),
                 "synthetic_0.5_0.5": (0.5, 0.5),
                 "synthetic_iid": (0.0, 0.0)}

class DatasetUnavailableError(FileNotFoundError):
    pass


def default_cache_dir() -> str:
    """The cache dir used when no ``data_cache_dir`` is configured (the
    default target of :func:`.acquire.import_archive`)."""
    return os.path.expanduser(os.environ.get(
        "FEDML_TPU_DATA_DIR", "~/.cache/fedml_tpu/data"))


def _synthetic_allowed(args, raw_name: str) -> bool:
    if raw_name.startswith("synthetic"):
        return True
    if getattr(args, "allow_synthetic", False):
        return True
    env = os.environ.get("FEDML_TPU_ALLOW_SYNTHETIC", "").strip().lower()
    return env not in ("", "0", "false", "no", "off")


def _synthetic_fallback(args, raw_name: str, name: str):
    """Gate + loud warning for substituting generated data for a real
    task. Explicitly-synthetic names are fine and silent."""
    if raw_name.startswith("synthetic"):
        return
    if not _synthetic_allowed(args, raw_name):
        raise DatasetUnavailableError(
            f"dataset {name!r} is not cached under "
            f"{getattr(args, 'data_cache_dir', '.')!r} as {name}.npz. To run "
            f"on a generated stand-in instead, name the dataset "
            f"'synthetic_{name}' or set allow_synthetic: true (env "
            f"FEDML_TPU_ALLOW_SYNTHETIC=1).")
    logger.warning(
        "SYNTHETIC STAND-IN: dataset %r is not available; training on "
        "generated data shaped like it. Metrics do NOT reflect the real "
        "task.", name)


def _cap_train(xtr, ytr, args, seed: int):
    """Deterministically subsample the training set when the caller bounds
    total samples (``max_total_samples``)."""
    cap = int(getattr(args, "max_total_samples", 0) or 0)
    if cap and len(xtr) > cap:
        logger.warning("training set capped to %d of %d samples "
                       "(max_total_samples)", cap, len(xtr))
        idx = np.random.RandomState(seed ^ 0x5EED).permutation(
            len(xtr))[:cap]
        return xtr[idx], ytr[idx]
    return xtr, ytr


def _try_npz(cache_dir: str, name: str):
    path = os.path.join(os.path.expanduser(cache_dir or "."), f"{name}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return (z["x_train"], z["y_train"]), (z["x_test"], z["y_test"])
    return None


def load(args) -> Tuple[FederatedDataset, int]:
    raw_name = str(getattr(args, "dataset", "synthetic_mnist")).lower()
    name = raw_name.removeprefix("synthetic_")
    num_clients = int(args.client_num_in_total)
    bs = int(args.batch_size)
    seed = int(getattr(args, "random_seed", 0))
    method = getattr(args, "partition_method", "hetero")
    alpha = float(getattr(args, "partition_alpha", 0.5))
    # linear models take flat input
    flat = str(getattr(args, "model", "lr")).lower() in (
        "lr", "logistic_regression", "mlp")
    cache_dir = os.path.expanduser(getattr(args, "data_cache_dir", None)
                                   or ".")
    real = not raw_name.startswith("synthetic")

    if name in ("fed_cifar100", "stackoverflow_nwp", "stackoverflow_lr") \
            and real:
        from .tff_h5 import load_tff_dataset
        got = load_tff_dataset(name, os.path.join(cache_dir, name), bs,
                               max_clients=num_clients)
        if got is not None:
            return got
    if name.startswith("fednlp") and real:
        from .fednlp_h5 import load_fednlp_text_classification
        got = load_fednlp_text_classification(
            os.path.join(cache_dir, name), bs, max_clients=num_clients,
            partition_method=getattr(args, "partition_method", None))
        if got is not None:
            return got
    if name in ("imagenet", "ilsvrc2012", "tiny_imagenet") and real:
        from .images import load_image_folder
        got = load_image_folder(os.path.join(cache_dir, name))
        if got is not None:
            (xtr, ytr), (xte, yte), n_classes = got
            fed = from_central_arrays(xtr, ytr, xte, yte, num_clients, bs,
                                      n_classes, partition_method=method,
                                      partition_alpha=alpha, seed=seed)
            fed.provenance = "real"
            return fed, n_classes
    if name in ("landmarks", "gld23k", "gld160k") and real:
        from .images import load_landmarks
        got = load_landmarks(os.path.join(cache_dir, name),
                             max_clients=num_clients)
        if got is not None:
            cxs, cys, test_x, test_y, n_classes = got
            fed = build_federated_dataset(cxs, cys, test_x, test_y, bs,
                                          n_classes)
            fed.provenance = "real"
            return fed, n_classes

    if name in _LEAF:
        from .leaf import load_leaf_dataset
        n_classes = {"femnist": 62, "celeba": 2, "sent140": 2}.get(name, 90)
        task = ("sequence" if name in ("shakespeare", "fed_shakespeare",
                                       "reddit") else "classification")
        leaf_dir = os.path.join(cache_dir, name)
        if (name in ("shakespeare", "fed_shakespeare")
                and not os.path.isdir(os.path.join(leaf_dir, "train"))
                and not raw_name.startswith("synthetic")):
            # no LEAF split on disk: the bundled REAL text (client = role)
            from .bundled import materialize_mini_shakespeare
            leaf_dir = materialize_mini_shakespeare(
                os.path.join(cache_dir, "bundled"))
        leaf = load_leaf_dataset(leaf_dir, bs, n_classes,
                                 max_clients=num_clients, task=task)
        if leaf is not None:
            return leaf, n_classes

    if raw_name in _SYNTHETIC_AB:
        alpha_s, beta_s = _SYNTHETIC_AB[raw_name]
        cxs, cys, tx, ty = synthetic.synthetic_federated(
            alpha_s, beta_s, num_clients=num_clients, seed=seed)
        fed = build_federated_dataset(cxs, cys, tx, ty, bs, 10)
        fed.provenance = "synthetic"
        return fed, 10

    if name in ("stackoverflow_lr", "multilabel"):
        if not raw_name.startswith("synthetic"):
            _synthetic_fallback(args, raw_name, name)
        (xtr, ytr), (xte, yte) = synthetic.synthetic_multilabel(
            n_train=max(num_clients * 2 * bs, 2000), seed=seed)
        # multilabel labels cannot drive a label partitioner: homo split
        idxs = np.array_split(np.random.RandomState(seed).permutation(
            len(xtr)), num_clients)
        fed = build_federated_dataset(
            [xtr[i] for i in idxs], [ytr[i] for i in idxs], xte, yte, bs,
            ytr.shape[1], task="multilabel")
        return fed, ytr.shape[1]

    # an explicit synthetic_* name must NEVER silently pick up real data
    cached = None if raw_name.startswith("synthetic") else _try_npz(
        cache_dir, name)
    if cached is None and not raw_name.startswith("synthetic"):
        from .acquire import BUNDLED_REAL, sklearn_bundled
        if name in BUNDLED_REAL:
            cached = sklearn_bundled(name)
    if name in _IMAGE_DATASETS:
        shape, n_classes = _IMAGE_DATASETS[name]
        if cached is not None:
            (xtr, ytr), (xte, yte) = cached
            xtr = xtr.astype(np.float32)
            xte = xte.astype(np.float32)
            if xtr.max() > 2.0:
                xtr, xte = xtr / 255.0, xte / 255.0
            if flat:
                xtr = xtr.reshape(len(xtr), -1)
                xte = xte.reshape(len(xte), -1)
            elif xtr.ndim == 3:
                xtr, xte = xtr[..., None], xte[..., None]
            provenance = "real"
        else:
            _synthetic_fallback(args, raw_name, name)
            n_feat = int(np.prod(shape))
            gen_seed = seed + zlib.crc32(name.encode()) % 1000
            n_train = max(num_clients * 2 * bs, 4000,
                          int(getattr(args, "synthetic_size", 0) or 0))
            n_test = int(getattr(args, "synthetic_test_size", 0) or 1000)
            x, y = synthetic.make_classification(
                n_train + n_test, n_feat, n_classes,
                seed=gen_seed, noise=2.5, flat=flat, image_shape=shape)
            xtr, ytr = x[:-n_test], y[:-n_test]
            xte, yte = x[-n_test:], y[-n_test:]
            provenance = "synthetic"
        xtr, ytr = _cap_train(xtr, ytr, args, seed)
        fed = from_central_arrays(xtr, ytr, xte, yte, num_clients, bs,
                                  n_classes, method, alpha, seed)
        fed.provenance = provenance
        return fed, n_classes
    if name in _TABULAR_DATASETS:
        n_feat, n_classes = _TABULAR_DATASETS[name]
        if cached is None:
            _synthetic_fallback(args, raw_name, name)
            x, y = synthetic.make_classification(
                max(num_clients * 2 * bs, 2000) + 400, n_feat, n_classes,
                seed=seed, noise=2.0, flat=True)
            xtr, ytr, xte, yte = x[:-400], y[:-400], x[-400:], y[-400:]
            provenance = "synthetic"
        else:
            (xtr, ytr), (xte, yte) = cached
            xtr, xte = xtr.astype(np.float32), xte.astype(np.float32)
            provenance = "real"
        fed = from_central_arrays(xtr, ytr, xte, yte, num_clients, bs,
                                  n_classes, method, alpha, seed)
        fed.provenance = provenance
        return fed, n_classes
    if name in ("lending_club", "lending_club_loan", "loan", "nus_wide"):
        # the feature order is the vertical column split the VFL runs use
        from . import finance
        try:
            if name == "nus_wide":
                x, y = finance.load_nus_wide(cache_dir)
            else:
                x, y = finance.load_lending_club(cache_dir)
            provenance = "real"
        except (OSError, ValueError) as e:
            logger.info("no cached %s (%s)", name, e)
            _synthetic_fallback(args, raw_name, name)
            make = (finance.synthetic_nus_wide if name == "nus_wide"
                    else finance.synthetic_lending_club)
            x, y = make(max(num_clients * 2 * bs, 2000) + 400, seed=seed)
            provenance = "synthetic"
        n_classes = int(y.max()) + 1
        n_test = max(len(x) // 6, 1)
        xtr, ytr = _cap_train(x[:-n_test], y[:-n_test], args, seed)
        fed = from_central_arrays(xtr, ytr, x[-n_test:], y[-n_test:],
                                  num_clients, bs, n_classes, method, alpha,
                                  seed)
        fed.provenance = provenance
        return fed, n_classes
    if name in ("pascal_voc", "coco_seg", "seg", "segmentation"):
        if real and name not in ("seg", "segmentation"):
            _synthetic_fallback(args, raw_name, name)
        n_classes = 3
        (xtr, ytr), (xte, yte) = synthetic.synthetic_segmentation(
            n_train=max(num_clients * 2 * bs, 400), seed=seed)
        fed = from_central_arrays(xtr, ytr, xte, yte, num_clients, bs,
                                  n_classes, "homo", alpha, seed,
                                  task="segmentation")
        fed.provenance = "synthetic"
        return fed, n_classes
    if name in ("shakespeare", "fed_shakespeare", "stackoverflow_nwp",
                "sequences", "reddit"):
        if not raw_name.startswith("synthetic") and name != "sequences":
            _synthetic_fallback(args, raw_name, name)
        (xtr, ytr), (xte, yte) = synthetic.synthetic_sequences(
            n_train=max(num_clients * 2 * bs, 2000), seed=seed)
        vocab = 64
        fed = from_central_arrays(xtr, ytr, xte, yte, num_clients, bs,
                                  vocab, "homo", alpha, seed, task="sequence")
        fed.provenance = "synthetic"
        return fed, vocab
    # default: mnist-shaped synthetic
    if not raw_name.startswith("synthetic"):
        _synthetic_fallback(args, raw_name, name)
    (xtr, ytr), (xte, yte) = synthetic.synthetic_mnist(
        n_train=max(num_clients * 2 * bs, 4000), seed=seed, flat=flat)
    fed = from_central_arrays(xtr, ytr, xte, yte, num_clients, bs, 10,
                              method, alpha, seed)
    fed.provenance = "synthetic"
    return fed, 10
