"""LEAF-format federated dataset reader (a copy of
``fedml_tpu/data/leaf.py``, which imports no JAX; ``tests/test_torch_copies.py``
pins it). LEAF json layout::

    {"users": [...], "num_samples": [...],
     "user_data": {user: {"x": [...], "y": [...]}}}

Files live under ``<root>/train/*.json`` and ``<root>/test/*.json``. Natural
(per-user) partitions are preserved — these are the datasets whose
non-IIDness is real rather than synthesized by a partitioner.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .containers import FederatedDataset, build_federated_dataset


# LEAF shakespeare's character vocabulary (80 printable chars); index 0 is
# reserved for out-of-vocabulary/padding
_LEAF_VOCAB = ("\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "[]abcdefghijklmnopqrstuvwxyz}")
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(_LEAF_VOCAB)}


def _encode(values) -> np.ndarray:
    """Numeric LEAF data -> float32; text LEAF data (shakespeare/sent140
    store strings in x/y) -> int32 char-id sequences."""
    if len(values) and isinstance(values[0], str):
        seqs = [[_CHAR_TO_ID.get(c, 0) for c in s] for s in values]
        length = max(len(s) for s in seqs)
        out = np.zeros((len(seqs), length), np.int32)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s
        return out
    return np.asarray(values, np.float32)


def _read_split(split_dir: str) -> Optional[Dict[str, Tuple[np.ndarray,
                                                            np.ndarray]]]:
    if not os.path.isdir(split_dir):
        return None
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for fname in sorted(os.listdir(split_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(split_dir, fname)) as f:
            blob = json.load(f)
        for user in blob.get("users", []):
            ud = blob["user_data"][user]
            ys = ud["y"]
            y = (_encode(ys) if len(ys) and isinstance(ys[0], str)
                 else np.asarray(ys))
            out[user] = (_encode(ud["x"]), y)
    return out or None


def load_leaf_dataset(
    root: str,
    batch_size: int,
    num_classes: int,
    max_clients: Optional[int] = None,
    task: str = "classification",
) -> Optional[FederatedDataset]:
    """Build a FederatedDataset from a LEAF directory, or None if absent."""
    train = _read_split(os.path.join(root, "train"))
    if train is None:
        return None
    test = _read_split(os.path.join(root, "test"))
    users: List[str] = sorted(train)
    if max_clients:
        users = users[:max_clients]
    cxs = [train[u][0] for u in users]
    cys = [train[u][1] for u in users]
    if test:
        tx = np.concatenate([test[u][0] for u in sorted(test)])
        ty = np.concatenate([test[u][1] for u in sorted(test)])
    else:  # held-out fallback: last 10% of each user's data
        tx = np.concatenate([x[int(len(x) * 0.9):] for x in cxs])
        ty = np.concatenate([y[int(len(y) * 0.9):] for y in cys])
        cxs = [x[:int(len(x) * 0.9)] for x in cxs]
        cys = [y[:int(len(y) * 0.9)] for y in cys]
    return build_federated_dataset(cxs, cys, tx, ty, batch_size, num_classes,
                                   dtype=(np.int32 if task == "sequence"
                                          else np.float32),
                                   task=task)
