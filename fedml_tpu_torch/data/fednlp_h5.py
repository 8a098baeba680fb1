"""Reader for the FedNLP HDF5 on-disk format the reference consumes (a copy
of ``fedml_tpu/data/fednlp_h5.py``, on the port's ``llm/data.py``
``ByteTokenizer``; ``h5py`` is imported inside the reader).

Parity target: ``data/fednlp/base/raw_data/base_raw_data_loader.py:38-45``
(the data file: ``attributes`` JSON + per-example ``X/<idx>`` text and
``Y/<idx>`` label datasets) and
``base/data_manager/base_data_manager.py:53-127`` (the partition file:
``<method>/n_clients`` + ``<method>/partition_data/<client>/{train,test}``
index lists). Datasets in this format: 20news, agnews, sst_2, semeval —
the reference's text-classification FedNLP tasks.

Redesign: instead of the reference's HF-tokenizer preprocessing
pipeline (network-dependent), texts are byte-tokenized to a fixed
``max_len`` (the same zero-egress tokenizer the LLM stack uses), producing
the framework-standard padded ``FederatedDataset`` so every simulator and
WAN runner consumes FedNLP shards unchanged. Drop the reference's
``<task>_data.h5`` + ``<task>_partition.h5`` under
``<data_cache_dir>/fednlp_<task>/`` — read locally, no network. A tiny
checked-in fixture pins the exact on-disk format.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

MAX_LEN = 128


def _byte_ids(text: str, max_len: int) -> List[int]:
    """THE LLM stack's ByteTokenizer id space (one tokenizer for the
    whole framework — FedNLP shards stay directly consumable by
    LLM-stack components), truncated and padded with its pad id."""
    from ..llm.data import ByteTokenizer
    tok = ByteTokenizer()
    ids = tok.encode(text)[:max_len]
    return ids + [tok.pad_id] * (max_len - len(ids))


def load_fednlp_text_classification(data_dir: str, batch_size: int,
                                    max_clients: Optional[int] = None,
                                    partition_method: Optional[str] = None,
                                    max_len: int = MAX_LEN):
    """(FederatedDataset, num_labels) from a local FedNLP cache, or None
    when the files are absent. ``data_dir`` holds ``<task>_data.h5`` and
    ``<task>_partition.h5`` (any single task per dir)."""
    try:
        names = sorted(os.listdir(data_dir))
    except OSError:
        return None
    data_files = [n for n in names if n.endswith("_data.h5")]
    part_files = [n for n in names if n.endswith("_partition.h5")]
    if not data_files or not part_files:
        return None
    import contextlib

    import h5py

    from .containers import build_federated_dataset
    with contextlib.ExitStack() as stack:
        try:
            data_f = stack.enter_context(
                h5py.File(os.path.join(data_dir, data_files[0]), "r"))
            part_f = stack.enter_context(
                h5py.File(os.path.join(data_dir, part_files[0]), "r"))
        except OSError as e:  # corrupt/truncated cache: not-present
            logger.warning("unusable FedNLP cache in %s: %s", data_dir, e)
            return None
        attrs = json.loads(data_f["attributes"][()])
        label_vocab = attrs.get("label_vocab") or {}
        if not label_vocab:  # derive from the labels present
            seen = sorted({_as_str(data_f["Y"][k][()])
                           for k in data_f["Y"]})
            label_vocab = {lab: i for i, lab in enumerate(seen)}
        num_labels = int(attrs.get("num_labels") or len(label_vocab))

        def label_id(lab: str) -> int:
            """An INCOMPLETE declared vocab (partial/corrupt cache) would
            KeyError on the first undeclared label — extend the vocab on
            the fly instead (ids after the declared ones; num_labels is
            re-widened below before it is used). Lazy so the healthy
            complete-vocab path never pays a full Y scan."""
            idx = label_vocab.get(lab)
            if idx is None:
                idx = max(label_vocab.values(), default=-1) + 1
                label_vocab[lab] = idx
                logger.warning(
                    "FedNLP label_vocab in %s lacks label %r present in "
                    "Y; extending the vocab (id %d)", data_files[0], lab,
                    idx)
            return idx

        avail = list(part_f.keys())
        if partition_method and partition_method in part_f:
            method = partition_method
        else:
            method = avail[0]
            if partition_method and partition_method != method:
                logger.warning(
                    "FedNLP partition method %r not in %s (available: "
                    "%s); using %r", partition_method, part_files[0],
                    avail, method)
        part = part_f[method]["partition_data"]
        client_ids = sorted(part.keys(), key=lambda s: int(s))
        if max_clients:
            client_ids = client_ids[:int(max_clients)]

        def read(idx_list):
            if not idx_list:  # sparse niid partitions can leave a client
                # empty — keep the (0, max_len) shape so stacking works
                return (np.zeros((0, max_len), np.int32),
                        np.zeros((0,), np.int64))
            xs = np.asarray([_byte_ids(_as_str(data_f["X"][str(i)][()]),
                                       max_len) for i in idx_list],
                            np.int32)
            ys = np.asarray([label_id(_as_str(data_f["Y"][str(i)][()]))
                             for i in idx_list], np.int64)
            return xs, ys

        cxs, cys, test_chunks = [], [], []
        for cid in client_ids:
            tr_idx = list(part[cid]["train"][()])
            te_idx = list(part[cid]["test"][()])
            x, y = read(tr_idx)
            cxs.append(x)
            cys.append(y)
            if te_idx:
                test_chunks.append(read(te_idx))
        if not test_chunks:
            return None
        max_id = max(label_vocab.values(), default=-1)
        if num_labels <= max_id:  # every id must fit the output dim
            num_labels = max_id + 1
        test_x = np.concatenate([c[0] for c in test_chunks])
        test_y = np.concatenate([c[1] for c in test_chunks])
        fed = build_federated_dataset(cxs, cys, test_x, test_y,
                                      batch_size, num_labels,
                                      dtype=np.int32)
        fed.provenance = "real"
        logger.info("loaded FedNLP %s from %s: %d clients, %d labels",
                    data_files[0], data_dir, len(client_ids), num_labels)
        return fed, num_labels


def _as_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):  # utf8-typed scalar arrays
        return _as_str(v.item() if v.shape == () else v.tolist()[0])
    return str(v)
