"""Image-directory dataset readers: ImageNet folder layout + Landmarks (a
copy of ``fedml_tpu/data/images.py``; ``PIL`` is imported inside the
reader functions).

Parity targets:
- ``ImageNet``: reference ``data/ImageNet/data_loader.py:1-411`` — an
  ImageFolder tree (``train/<wnid>/*.JPEG``, ``val/<wnid>/*.JPEG``)
  consumed through torchvision; here the tree is read with PIL straight
  into the framework's padded arrays, then federated with the standard
  partitioners (the reference also partitions centrally-loaded ImageNet).
- ``Landmarks`` (gld23k/gld160k): reference
  ``data/Landmarks/data_loader.py:123-151`` — CSV mappings with
  ``user_id,image_id,class`` rows give the NATURAL per-user federated
  partition; images live under ``<data_dir>/images/<image_id>.jpg``.

Both read a LOCAL cache dir only (no egress — drop the dataset under
``<data_cache_dir>/<name>/``); images are decoded once, resized to a
square ``image_size`` and normalized to [0, 1] float32.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _load_image(path: str, image_size: int) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB").resize((image_size, image_size))
        return np.asarray(im, np.float32) / 255.0


# in-memory budget for eagerly-decoded image datasets: above this, refuse
# loudly instead of silently OOMing the host mid-decode. Full ILSVRC2012
# at 64px float32 would need ~63 GB; that scale needs a streaming/HDF5
# pipeline, not this eager loader.
MAX_EAGER_BYTES = 8 << 30


def _folder_split(root: str, image_size: int,
                  class_to_id: Optional[Dict[str, int]] = None):
    """One ImageFolder split: class subdirs -> (x, y, class_to_id)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if class_to_id is None:
        class_to_id = {c: i for i, c in enumerate(classes)}
    paths, ys = [], []
    for c in classes:
        cid = class_to_id.get(c)
        if cid is None:
            continue
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_IMG_EXTS):
                paths.append(os.path.join(cdir, fname))
                ys.append(cid)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    need = len(paths) * image_size * image_size * 3 * 4
    if need > MAX_EAGER_BYTES:
        raise MemoryError(
            f"{root}: {len(paths)} images at {image_size}px need "
            f"~{need / 2**30:.0f} GiB decoded — beyond the eager loader's "
            f"{MAX_EAGER_BYTES >> 30} GiB budget. Use a class/sample "
            "subset of the tree, a smaller image_size, or a streaming "
            "pipeline for full-scale ImageNet.")
    xs = [_load_image(p, image_size) for p in paths]
    return np.stack(xs), np.asarray(ys, np.int64), class_to_id


def load_image_folder(data_dir: str, image_size: int = 64):
    """ImageNet-style tree -> ((xtr, ytr), (xte, yte), n_classes), or None
    when the tree is absent. ``val``/``test`` both accepted for the eval
    split; missing eval split falls back to a held-out tail of train."""
    train_dir = os.path.join(data_dir, "train")
    if not os.path.isdir(train_dir):
        return None
    xtr, ytr, cmap = _folder_split(train_dir, image_size)
    for split in ("val", "test"):
        sdir = os.path.join(data_dir, split)
        if os.path.isdir(sdir):
            xte, yte, _ = _folder_split(sdir, image_size, cmap)
            break
    else:
        n_te = max(1, len(xtr) // 10)
        rs = np.random.RandomState(0)
        order = rs.permutation(len(xtr))
        te, tr = order[:n_te], order[n_te:]
        xtr, ytr, xte, yte = xtr[tr], ytr[tr], xtr[te], ytr[te]
    logger.info("image folder %s: %d train / %d eval images, %d classes",
                data_dir, len(xtr), len(xte), len(cmap))
    return (xtr, ytr), (xte, yte), len(cmap)


def _read_mapping(path: str) -> "OrderedDict[str, List[dict]]":
    """user_id -> rows, preserving file order (reference
    ``Landmarks/data_loader.py:123-151``)."""
    per_user: "OrderedDict[str, List[dict]]" = OrderedDict()
    with open(path) as f:
        reader = csv.DictReader(f)
        cols = set(reader.fieldnames or ())
        if not {"user_id", "image_id", "class"} <= cols:
            raise ValueError(
                f"{path}: mapping must have user_id,image_id,class "
                f"columns (got {sorted(cols)})")
        for row in reader:
            per_user.setdefault(row["user_id"], []).append(row)
    return per_user


def _find_image(images_dir: str, image_id: str) -> Optional[str]:
    for ext in _IMG_EXTS:
        p = os.path.join(images_dir, image_id + ext)
        if os.path.exists(p):
            return p
    return None


def load_landmarks(data_dir: str, image_size: int = 64,
                   max_clients: Optional[int] = None):
    """Google-Landmarks-style federated dataset from a local cache:
    ``federated_train.csv`` (+ optional ``test.csv``) mappings + an
    ``images/`` dir. Returns (client_xs, client_ys, test_x, test_y,
    n_classes) with the NATURAL per-user partition, or None if the
    mapping files are absent."""
    train_csv = None
    for cand in ("federated_train.csv", "mini_gld_train_split.csv",
                 "train.csv"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            train_csv = p
            break
    if train_csv is None:
        return None
    images_dir = os.path.join(data_dir, "images")
    per_user = _read_mapping(train_csv)
    users = list(per_user)
    if max_clients:
        users = users[:max_clients]
    classes = sorted({row["class"] for u in users for row in per_user[u]})
    class_id = {c: i for i, c in enumerate(classes)}
    client_xs, client_ys = [], []
    for u in users:
        xs, ys = [], []
        for row in per_user[u]:
            p = _find_image(images_dir, row["image_id"])
            if p is None:
                logger.warning("landmarks: missing image %s",
                               row["image_id"])
                continue
            xs.append(_load_image(p, image_size))
            ys.append(class_id[row["class"]])
        if xs:
            client_xs.append(np.stack(xs))
            client_ys.append(np.asarray(ys, np.int64))
    test_csv = None
    for cand in ("test.csv", "mini_gld_test.csv"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            test_csv = p
            break
    xs, ys = [], []
    if test_csv is not None:
        with open(test_csv) as f:
            for row in csv.DictReader(f):
                p = _find_image(images_dir, row["image_id"])
                if p is not None and row["class"] in class_id:
                    xs.append(_load_image(p, image_size))
                    ys.append(class_id[row["class"]])
        if not xs:
            logger.warning(
                "landmarks: %s matched no usable rows (missing images or "
                "classes outside the train mapping) — falling back to "
                "held-out per-client test samples", test_csv)
    if xs:
        test_x, test_y = np.stack(xs), np.asarray(ys, np.int64)
    else:
        # no test mapping: hold out ONE sample per multi-image client.
        # Single-image clients contribute nothing — duplicating their only
        # sample into both splits would evaluate on training data.
        test_x = np.stack([cx[-1] for cx in client_xs if len(cx) > 1])
        test_y = np.asarray([cy[-1] for cx, cy in
                             zip(client_xs, client_ys) if len(cx) > 1],
                            np.int64)
        if len(test_x) == 0:
            raise ValueError(
                f"{data_dir}: cannot build a test split — no test csv and "
                "every user has a single image")
        client_xs = [cx[:-1] if len(cx) > 1 else cx for cx in client_xs]
        client_ys = [cy[:-1] if len(cy) > 1 else cy for cy in client_ys]
    logger.info("landmarks %s: %d users, %d classes", data_dir,
                len(client_xs), len(class_id))
    return client_xs, client_ys, test_x, test_y, len(class_id)
