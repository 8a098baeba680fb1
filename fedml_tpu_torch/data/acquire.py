"""Real datasets without a network (the offline part of
``fedml_tpu/data/acquire.py``).

* :func:`sklearn_bundled`: the UCI ``digits``, ``wine`` and
  ``breast_cancer`` sets. The JAX package imports them from scikit-learn;
  the port reads the same raw tables from ``bundled/sklearn_bundled.npz``
  (written by ``scripts/export_sklearn_bundled.py``) and applies the JAX
  recipe's transforms to them: digits as 8x8 images scaled x255/16,
  z-scored tabular features, and the 80/20 split drawn from
  ``RandomState(0)``. The arrays equal the JAX recipe's bit for bit.
* :func:`import_archive`: caches a raw archive the user already has
  (CIFAR's python tarball, or an ``.npz``) as ``<cache_dir>/<name>.npz``.

The port has no download recipe.
"""

from __future__ import annotations

import logging
import os
import pickle
import tarfile
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]

BUNDLED_REAL = ("digits", "wine", "breast_cancer")

BUNDLED_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bundled", "sklearn_bundled.npz")


def sklearn_bundled(name: str) -> Arrays:
    """The JAX recipe's ``_sklearn_bundled(name)`` arrays, from the bundled
    tables: ``((x_train, y_train), (x_test, y_test))``."""
    if name not in BUNDLED_REAL:
        raise ValueError(f"{name!r} is not bundled ({BUNDLED_REAL})")
    with np.load(BUNDLED_NPZ) as z:
        x = np.asarray(z[f"{name}_x"], np.float32)
        y = np.asarray(z[f"{name}_y"], np.int64)
    if name == "digits":
        x = x.reshape(-1, 8, 8) * (255.0 / 16.0)  # to image convention
    else:  # z-score tabular features
        x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    # deterministic 80/20 split
    order = np.random.RandomState(0).permutation(len(x))
    n_te = max(1, len(x) // 5)
    te, tr = order[:n_te], order[n_te:]
    return ((x[tr], y[tr]), (x[te], y[te]))


def _parse_local_archive(name: str, path: str) -> Arrays:
    """Parse a locally provided raw archive into arrays. A CIFAR tarball
    holds python pickles: import only archives you trust."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return ((z["x_train"], z["y_train"]), (z["x_test"], z["y_test"]))
    if name in ("cifar10", "cifar100"):
        label_key = b"fine_labels" if name == "cifar100" else b"labels"
        xs_tr, ys_tr = [], []
        x_te = y_te = None
        with tarfile.open(path, mode="r:gz") as tf:
            for m in tf.getmembers():
                base = os.path.basename(m.name)
                is_train = base.startswith("data_batch") or base == "train"
                is_test = base.startswith("test_batch") or base == "test"
                if not (is_train or is_test):
                    continue
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                y = np.asarray(d[label_key], np.int64)
                if is_train:
                    xs_tr.append(x)
                    ys_tr.append(y)
                else:
                    x_te, y_te = x, y
        return ((np.concatenate(xs_tr), np.concatenate(ys_tr)),
                (x_te, y_te))
    raise IOError(f"no offline parser for {name} archive {path!r}")


def import_archive(name: str, path: str,
                   cache_dir: Optional[str] = None) -> str:
    """Cache a locally provided raw archive (e.g. CIFAR-10's
    ``cifar-10-python.tar.gz``, or a pre-built ``.npz``) as
    ``<cache_dir>/<name>.npz``, so every later ``load()`` reads it as real
    data. Returns the cached path."""
    from .data_loader import default_cache_dir
    cache_dir = os.path.expanduser(cache_dir or default_cache_dir())
    (xtr, ytr), (xte, yte) = _parse_local_archive(name, path)
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"{name}.npz")
    tmp = out + ".tmp.npz"
    np.savez_compressed(tmp, x_train=xtr, y_train=ytr, x_test=xte,
                        y_test=yte)
    os.replace(tmp, out)
    logger.info("imported %s archive %s -> %s", name, path, out)
    return out
