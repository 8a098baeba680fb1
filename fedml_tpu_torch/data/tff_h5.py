"""Readers for the TFF-style HDF5 on-disk formats the reference consumes (a
copy of ``fedml_tpu/data/tff_h5.py``; ``h5py`` is imported inside the
reader functions).

Parity targets:
- ``fed_cifar100``: reference ``data/fed_cifar100/data_loader.py:1-202`` —
  TFF HDF5 pair (``fed_cifar100_train.h5`` / ``fed_cifar100_test.h5``)
  with groups ``examples/<client_id>/{image,label}``; client = the natural
  TFF partition.
- ``stackoverflow_nwp``: reference ``data/stackoverflow_nwp/`` — HDF5
  ``examples/<client_id>/tokens`` (space-separated sentences) plus the
  ``stackoverflow.word_count`` vocab file; preprocessing follows the TFF
  recipe exactly (top-10k vocab, bos/eos/pad + 1 oov bucket, windows of
  seq_len + 1, next-word labels).
- ``stackoverflow_lr``: reference ``data/stackoverflow_lr/`` — same HDF5
  shape plus ``stackoverflow.tag_count`` (json); input = mean bag-of-words
  over the top-10k vocab, target = multi-hot over the top-500 tags.

The readers consume a LOCAL cache dir only (no egress — drop the reference
dataset files under ``<data_cache_dir>/<name>/``); they produce the
framework-standard padded ``FederatedDataset`` so every simulator and WAN
runner uses them unchanged. Tiny checked-in fixtures
(``tests/fixtures/``) pin the exact on-disk format.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

NWP_VOCAB = 10_000
NWP_SEQ_LEN = 20
LR_VOCAB = 10_000
LR_TAGS = 500


def _h5_pair(data_dir: str, train_name: str, test_name: str):
    tr, te = (os.path.join(data_dir, n) for n in (train_name, test_name))
    if not (os.path.exists(tr) and os.path.exists(te)):
        return None
    import h5py
    return h5py.File(tr, "r"), h5py.File(te, "r")


def _client_keys(h5, max_clients: Optional[int]) -> List[str]:
    """Client group names, capped BEFORE any data is read — the real TFF
    StackOverflow shard has ~342k clients; a 4-client run must not parse
    them all."""
    keys = sorted(h5["examples"].keys())
    return keys[:max_clients] if max_clients else keys


def _top_words(path: str, k: int) -> List[str]:
    """First token of the first ``k`` non-blank lines of a TFF
    ``*.word_count`` file (most frequent first)."""
    words: List[str] = []
    with open(path) as f:
        for line in f:
            if len(words) >= k:
                break
            if line.strip():
                words.append(line.split()[0])
    return words


# --------------------------------------------------------------- cifar100 --

def load_fed_cifar100(data_dir: str, batch_size: int,
                      max_clients: Optional[int] = None):
    """TFF federated CIFAR-100: natural client partition from the HDF5
    groups. Returns (FederatedDataset, 100) or None if files absent."""
    pair = _h5_pair(data_dir, "fed_cifar100_train.h5", "fed_cifar100_test.h5")
    if pair is None:
        return None
    from .containers import build_federated_dataset
    tr, te = pair
    try:
        cxs = [np.asarray(tr["examples"][c]["image"][()],
                          np.float32) / 255.0
               for c in _client_keys(tr, max_clients)]
        cys = [np.asarray(tr["examples"][c]["label"][()]).reshape(-1)
               .astype(np.int64) for c in _client_keys(tr, max_clients)]
        test_keys = _client_keys(te, None)
        test_x = np.concatenate(
            [np.asarray(te["examples"][c]["image"][()], np.float32) / 255.0
             for c in test_keys])
        test_y = np.concatenate(
            [np.asarray(te["examples"][c]["label"][()]).reshape(-1)
             .astype(np.int64) for c in test_keys])
        fed = build_federated_dataset(cxs, cys, test_x, test_y,
                                      batch_size, 100)
        fed.provenance = "real"
        return fed, 100
    finally:
        tr.close()
        te.close()


# ------------------------------------------------------- stackoverflow nwp --

def _nwp_vocab(data_dir: str, vocab_size: int) -> dict:
    """word -> id, TFF layout: [pad] + top-k words + [bos] + [eos]; OOV
    hashes into 1 bucket after that (reference utils.py:57-62)."""
    words = _top_words(os.path.join(data_dir, "stackoverflow.word_count"),
                       vocab_size)
    vocab = {"<pad>": 0}
    for i, w in enumerate(words):
        vocab[w] = i + 1
    vocab["<bos>"] = len(vocab)
    vocab["<eos>"] = len(vocab)
    return vocab


def _nwp_to_ids(sentence: str, vocab: dict, seq_len: int) -> List[int]:
    """TFF tokenization (reference ``stackoverflow_nwp/utils.py:54-79``):
    truncate to seq_len words, map OOV to the single bucket after eos,
    append eos when room, prepend bos, pad to seq_len + 1."""
    oov = len(vocab)
    toks = [vocab.get(w, oov) for w in sentence.split(" ")[:seq_len]]
    if len(toks) < seq_len:
        toks = toks + [vocab["<eos>"]]
    toks = [vocab["<bos>"]] + toks
    toks += [vocab["<pad>"]] * (seq_len + 1 - len(toks))
    return toks[:seq_len + 1]


def load_stackoverflow_nwp(data_dir: str, batch_size: int,
                           max_clients: Optional[int] = None,
                           vocab_size: int = NWP_VOCAB,
                           seq_len: int = NWP_SEQ_LEN):
    """Next-word prediction over the TFF StackOverflow shard: x = ids[:-1],
    y = ids[1:] (per-token labels, sequence task). Returns
    (FederatedDataset, vocab_size + 4) or None if files absent."""
    pair = _h5_pair(data_dir, "stackoverflow_train.h5",
                    "stackoverflow_test.h5")
    if pair is None:
        return None
    from .containers import build_federated_dataset
    tr, te = pair
    try:
        vocab = _nwp_vocab(data_dir, vocab_size)
        n_ids = len(vocab) + 1  # + oov bucket

        def client_ids(h5, cap):
            xs, ys = [], []
            ex = h5["examples"]
            for cid in _client_keys(h5, cap):
                sents = [s.decode() if isinstance(s, bytes) else str(s)
                         for s in ex[cid]["tokens"][()]]
                ids = np.asarray([_nwp_to_ids(s, vocab, seq_len)
                                  for s in sents], np.int32)
                xs.append(ids[:, :-1])
                ys.append(ids[:, 1:])
            return xs, ys

        cxs, cys = client_ids(tr, max_clients)
        txs, tys = client_ids(te, None)
        fed = build_federated_dataset(
            cxs, cys, np.concatenate(txs), np.concatenate(tys),
            batch_size, n_ids, dtype=np.int32, task="sequence")
        fed.provenance = "real"
        return fed, n_ids
    finally:
        tr.close()
        te.close()


# -------------------------------------------------------- stackoverflow lr --

def load_stackoverflow_lr(data_dir: str, batch_size: int,
                          max_clients: Optional[int] = None,
                          vocab_size: int = LR_VOCAB,
                          tag_size: int = LR_TAGS):
    """Tag prediction (multilabel logistic regression) over the TFF
    StackOverflow shard: input = mean bag-of-words of the post tokens over
    the top-``vocab_size`` words, target = multi-hot over the top-
    ``tag_size`` tags (reference ``stackoverflow_lr/utils.py:68-107``).
    Returns (FederatedDataset, tag_size) or None if files absent."""
    pair = _h5_pair(data_dir, "stackoverflow_train.h5",
                    "stackoverflow_test.h5")
    if pair is None:
        return None
    from .containers import build_federated_dataset
    tr, te = pair
    try:
        words = _top_words(
            os.path.join(data_dir, "stackoverflow.word_count"), vocab_size)
        word_id = {w: i for i, w in enumerate(words)}
        with open(os.path.join(data_dir, "stackoverflow.tag_count")) as f:
            tag_id = {t: i for i, t in
                      enumerate(list(json.load(f).keys())[:tag_size])}
        n_words, n_tags = len(word_id), len(tag_id)

        def bow(sentence: str) -> np.ndarray:
            # mean one-hot over tokens; OOV occupies a dropped overflow
            # column, exactly the reference's [:vocab_size] slice
            v = np.zeros(n_words + 1, np.float32)
            toks = sentence.split(" ")
            for t in toks:
                v[word_id.get(t, n_words)] += 1.0
            return v[:n_words] / max(len(toks), 1)

        def multihot(tags: str) -> np.ndarray:
            v = np.zeros(n_tags + 1, np.float32)
            for t in tags.split("|"):
                v[tag_id.get(t, n_tags)] = 1.0
            return v[:n_tags]

        def client_arrays(h5, cap):
            xs, ys = [], []
            ex = h5["examples"]
            for cid in _client_keys(h5, cap):
                sents = [s.decode() if isinstance(s, bytes) else str(s)
                         for s in ex[cid]["tokens"][()]]
                tags = [s.decode() if isinstance(s, bytes) else str(s)
                        for s in ex[cid]["tags"][()]]
                xs.append(np.stack([bow(s) for s in sents]))
                ys.append(np.stack([multihot(t) for t in tags]))
            return xs, ys

        cxs, cys = client_arrays(tr, max_clients)
        txs, tys = client_arrays(te, None)
        fed = build_federated_dataset(
            cxs, cys, np.concatenate(txs), np.concatenate(tys),
            batch_size, n_tags, task="multilabel")
        fed.provenance = "real"
        return fed, n_tags
    finally:
        tr.close()
        te.close()


_LOADERS = {
    "fed_cifar100": load_fed_cifar100,
    "stackoverflow_nwp": load_stackoverflow_nwp,
    "stackoverflow_lr": load_stackoverflow_lr,
}


def load_tff_dataset(name: str, data_dir: str, batch_size: int,
                     max_clients: Optional[int] = None):
    """Dispatch: (FederatedDataset, output_dim) from a local cache of the
    reference's on-disk files, or None when the files are not present."""
    fn = _LOADERS.get(name)
    if fn is None:
        return None
    got = fn(data_dir, batch_size, max_clients)
    if got is not None:
        logger.info("loaded %s from local TFF cache %s (%d clients)",
                    name, data_dir, int(got[0].num_clients))
    return got
