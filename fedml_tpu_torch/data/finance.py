"""Finance / vertical-FL datasets: lending-club loans and NUS-WIDE (a copy of
``fedml_tpu/data/finance.py``; no JAX in it).

Parity targets: reference ``data/lending_club_loan/`` (loan table,
``loan_status`` label, features column-split between parties for the VFL
classifier ``model/finance/vfl_classifier.py``) and ``data/NUS_WIDE/``
(634-d low-level image features for party A, 1000-d tag vector for party
B, concept labels).

Acquisition policy matches the rest of ``data/``: these sets cannot be
bundled (licensed / hundreds of MB), so the loaders read preprocessed CSVs
from the disk cache — ``<cache>/lending_club/loan.csv`` with the label in
a ``loan_status`` (or last) column, ``<cache>/nus_wide/{features,tags,
labels}.csv`` — and only fall back to a loudly-labeled schema-matched
synthetic stand-in when the caller opted in (``allow_synthetic``).
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)

# the reference's numeric feature schema for lending club (a stable subset
# of lending_club_loan/loan_processed.py) — used both to read real CSVs and
# to shape the synthetic stand-in
LENDING_CLUB_FEATURES = (
    "loan_amnt", "int_rate", "installment", "annual_inc", "dti",
    "delinq_2yrs", "fico_range_low", "open_acc", "pub_rec", "revol_bal",
    "revol_util", "total_acc",
)
NUS_WIDE_LOW_LEVEL_DIM = 634
NUS_WIDE_TAG_DIM = 1000


def _read_csv_table(path: str):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    return header, rows


def load_lending_club(cache_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """``<cache>/lending_club/loan.csv`` -> (x [n, d] float32 standardized,
    y [n] int {0: fully paid, 1: charged off}). Label column:
    ``loan_status`` if present (string statuses mapped), else the last
    column (numeric)."""
    path = os.path.join(cache_dir, "lending_club", "loan.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    header, rows = _read_csv_table(path)
    cols = {c.strip().lower(): i for i, c in enumerate(header)}
    if "loan_status" in cols:
        li = cols["loan_status"]
        feat_idx = [cols[c] for c in LENDING_CLUB_FEATURES if c in cols]
        if not feat_idx:  # arbitrary numeric table: all non-label columns
            feat_idx = [i for i in range(len(header)) if i != li]
    else:
        li = len(header) - 1
        feat_idx = list(range(len(header) - 1))

    def label_of(v: str) -> int:
        v = v.strip().lower()
        if v in ("charged off", "default", "1", "late (31-120 days)"):
            return 1
        if v in ("fully paid", "0", "current"):
            return 0
        return -1  # unmapped status: dropped

    xs, ys = [], []
    for r in rows:
        lab = label_of(r[li])
        if lab < 0:
            continue
        try:
            xs.append([float(r[i] or 0.0) for i in feat_idx])
        except ValueError:
            continue
        ys.append(lab)
    x = np.asarray(xs, np.float32)
    y = np.asarray(ys, np.int32)
    mu, sd = x.mean(0, keepdims=True), x.std(0, keepdims=True) + 1e-6
    return (x - mu) / sd, y


def load_nus_wide(cache_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """``<cache>/nus_wide/`` -> (x = [low-level features | tags] float32,
    y [n] int concept). The column concatenation IS the vertical split:
    party A gets the first 634 columns, party B the tag block — matching
    the reference's two-party NUS-WIDE experiment."""
    d = os.path.join(cache_dir, "nus_wide")
    feats = np.loadtxt(os.path.join(d, "features.csv"), delimiter=",",
                       dtype=np.float32, ndmin=2)
    tags = np.loadtxt(os.path.join(d, "tags.csv"), delimiter=",",
                      dtype=np.float32, ndmin=2)
    labels = np.loadtxt(os.path.join(d, "labels.csv"), delimiter=",",
                        dtype=np.int64, ndmin=1).astype(np.int32)
    if not (len(feats) == len(tags) == len(labels)):
        raise ValueError("nus_wide: features/tags/labels row counts differ")
    x = np.concatenate([feats, tags], axis=1)
    mu, sd = x.mean(0, keepdims=True), x.std(0, keepdims=True) + 1e-6
    return (x - mu) / sd, labels


def synthetic_lending_club(n: int = 4000, seed: int = 0):
    """Schema-matched stand-in: default risk is a noisy logistic function
    of rate/dti/income — same column meanings, same label semantics."""
    rng = np.random.RandomState(seed)
    d = len(LENDING_CLUB_FEATURES)
    x = rng.randn(n, d).astype(np.float32)
    logits = 1.2 * x[:, 1] + 0.8 * x[:, 4] - 0.9 * x[:, 3] + \
        0.4 * rng.randn(n)
    y = (logits > 0).astype(np.int32)
    return x, y


def synthetic_nus_wide(n: int = 2000, n_concepts: int = 5, seed: int = 0,
                       feat_dim: int = 64, tag_dim: int = 96):
    """Stand-in with the two-block vertical structure (scaled-down dims so
    tests stay fast); label depends on BOTH blocks, so a single party
    cannot solve the task alone — the property VFL experiments need."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_concepts, size=n).astype(np.int32)
    proto_f = rng.randn(n_concepts, feat_dim).astype(np.float32)
    proto_t = rng.randn(n_concepts, tag_dim).astype(np.float32)
    feats = proto_f[y] + 1.2 * rng.randn(n, feat_dim).astype(np.float32)
    tags = (proto_t[y] + 1.2 * rng.randn(n, tag_dim).astype(np.float32))
    return np.concatenate([feats, tags], axis=1), y
