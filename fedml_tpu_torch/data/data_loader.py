"""Dataset dispatch: ``fedml_tpu_torch.data.load(args)`` (counterpart of
``fedml_tpu/data/data_loader.py``, ported for the CIFAR-10 slice).

Two sources:

1. ``cifar10`` from an offline ``cifar10.npz`` cache under
   ``args.data_cache_dir`` (keys ``x_train``/``y_train``/``x_test``/
   ``y_test``). The port has no download code.
2. ``synthetic_cifar10``: the JAX package's labelled stand-in with the same
   shape and class count. A plain ``cifar10`` with no cache falls back to it
   only when ``allow_synthetic`` (or ``$FEDML_TPU_ALLOW_SYNTHETIC``) is set,
   loudly, and the dataset's ``provenance`` says ``synthetic``.

Both produce exactly the JAX loader's padded client arrays, masks and
sample counts.
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Tuple

import numpy as np

from . import synthetic
from .containers import FederatedDataset, from_central_arrays

logger = logging.getLogger(__name__)

_IMAGE_DATASETS = {"cifar10": ((32, 32, 3), 10)}


class DatasetUnavailableError(FileNotFoundError):
    pass


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
    raw_name = str(getattr(args, "dataset", "synthetic_cifar10")).lower()
    name = raw_name.removeprefix("synthetic_")
    if name not in _IMAGE_DATASETS:
        raise NotImplementedError(
            f"dataset={raw_name!r} is not ported to fedml_tpu_torch yet "
            f"(ported: cifar10 from an offline npz, synthetic_cifar10)")
    num_clients = int(args.client_num_in_total)
    bs = int(args.batch_size)
    seed = int(getattr(args, "random_seed", 0))
    method = getattr(args, "partition_method", "hetero")
    alpha = float(getattr(args, "partition_alpha", 0.5))
    # linear models take flat input; every ported model is a conv net
    flat = str(getattr(args, "model", "")).lower() in (
        "lr", "logistic_regression", "mlp")
    cache_dir = os.path.expanduser(getattr(args, "data_cache_dir", None)
                                   or ".")
    # an explicit synthetic_* name must NEVER silently pick up real data
    cached = None if raw_name.startswith("synthetic") else _try_npz(
        cache_dir, name)
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
