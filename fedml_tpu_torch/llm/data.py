"""LLM data utilities: tokenizer, instruction formatting, packing
(counterpart of ``fedml_tpu/llm/data.py``, of which this is a copy; the
JAX module imports no JAX, and ``tests/test_torch_llm.py`` pins the arrays
exactly equal).

Parity target: reference ``train/llm/dataset_utils.py`` +
``modeling_utils.py:28`` (completion-only collator: loss only on response
tokens) and the UnitedLLM databricks-dolly pipeline. Without network
egress, the default tokenizer is byte-level (no vocab download) and the
default corpus is a locally generated instruction set; real corpora are
read from ``data_cache_dir`` when present (jsonl with
``instruction``/``response`` fields, the dolly schema).

Everything returns the framework-standard padded arrays so LLM federated
runs ride the same containers as every other task: ``x`` [n, L] tokens,
``y`` [n, L] next-token labels with ``-1`` on prompt/pad positions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, BOS, EOS, SEP = 0, 1, 2, 3
SPECIAL_TOKENS = 4
BYTE_VOCAB = 256 + SPECIAL_TOKENS


class ByteTokenizer:
    """Byte-level tokenizer: token = byte value + SPECIAL_TOKENS offset.
    Zero-dependency stand-in for the HF tokenizer the reference downloads
    (``ModelArguments.get_tokenizer_kwargs``, ``configurations.py:343``)."""

    vocab_size = BYTE_VOCAB
    pad_id, bos_id, eos_id, sep_id = PAD, BOS, EOS, SEP

    def encode(self, text: str) -> List[int]:
        return [b + SPECIAL_TOKENS for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - SPECIAL_TOKENS for i in ids
                     if i >= SPECIAL_TOKENS).decode("utf-8", "replace")


class RoundTripByteTokenizer(ByteTokenizer):
    """Round-trip-exact variant: ``encode(decode(ids)) == ids`` for every
    byte-token sequence, including invalid UTF-8. ``decode`` maps
    undecodable bytes to lone surrogates (``surrogateescape``) instead of
    U+FFFD, and ``encode`` inverts them back to the original bytes; valid
    UTF-8 text encodes identically to :class:`ByteTokenizer`. Lone
    surrogates survive the JSON wire because ``json.dumps`` (default
    ``ensure_ascii=True``) escapes them to ``\\udcXX`` and ``json.loads``
    restores them. The suffix-cache chat surface needs this exactness:
    a follow-up request re-encodes the assistant reply it was served, and
    the re-encoded ids must equal the generated ids for the stored
    decode-origin KV blocks to alias."""

    def encode(self, text: str) -> List[int]:
        return [b + SPECIAL_TOKENS
                for b in text.encode("utf-8", "surrogateescape")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - SPECIAL_TOKENS for i in ids
                     if i >= SPECIAL_TOKENS).decode("utf-8",
                                                    "surrogateescape")


def synthetic_instruction_corpus(n: int, seed: int = 0
                                 ) -> List[Dict[str, str]]:
    """Deterministic toy instruction/response pairs (arithmetic, echo,
    sorting) — learnable structure so fine-tune loss curves are meaningful
    without any downloaded corpus."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            a, b = rng.randint(0, 50, 2)
            out.append({"instruction": f"add {a} {b}",
                        "response": str(a + b)})
        elif kind == 1:
            word = "".join(rng.choice(list("abcdef"), 5))
            out.append({"instruction": f"echo {word}", "response": word})
        else:
            nums = rng.randint(0, 9, 4)
            out.append({"instruction": "sort " + " ".join(map(str, nums)),
                        "response": " ".join(map(str, sorted(nums)))})
    return out


def shakespeare_instruction_corpus(window: int = 96,
                                   stride: int = 48
                                   ) -> List[Dict[str, str]]:
    """REAL-language instruction corpus built from the bundled
    public-domain Shakespeare passages (``data/bundled/shakespeare.py``):
    each row asks the model to continue a text window — a completion task
    over genuine natural language, the zero-egress counterpart of the
    dolly corpus the reference's UnitedLLM pipeline downloads."""
    from ..data.bundled.shakespeare import PASSAGES
    rows = []
    for role, text in PASSAGES.items():
        for start in range(0, max(len(text) - window, 1), stride):
            chunk = text[start:start + window]
            cut = max(window // 3, 1)
            rows.append({"instruction": f"Continue: {chunk[:cut]}",
                         "response": chunk[cut:]})
    return rows


def load_instruction_corpus(path: Optional[str], n_fallback: int = 256,
                            seed: int = 0,
                            fallback: str = "synthetic"
                            ) -> List[Dict[str, str]]:
    """jsonl with instruction/response (dolly schema: ``instruction`` +
    ``response``). No file: ``fallback='shakespeare'`` uses the bundled
    REAL text corpus; ``'synthetic'`` (default) uses the toy generator
    with a loud notice."""
    if path and os.path.exists(path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    rows.append({"instruction": r["instruction"],
                                 "response": r["response"]})
        return rows
    if fallback == "shakespeare":
        return shakespeare_instruction_corpus()
    import logging
    logging.getLogger(__name__).warning(
        "no instruction corpus at %r — using the SYNTHETIC fallback corpus",
        path)
    return synthetic_instruction_corpus(n_fallback, seed)


def tokenize_examples(corpus: Sequence[Dict[str, str]],
                      tokenizer: ByteTokenizer, seq_len: int,
                      completion_only: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (x [n, L], y [n, L]) with next-token labels; ``-1`` marks positions
    whose loss is excluded (prompt tokens when ``completion_only``, and all
    padding) — the collator semantics of ``modeling_utils.py:28``."""
    xs, ys = [], []
    for ex in corpus:
        prompt = tokenizer.encode(ex["instruction"]) + [SEP]
        resp = tokenizer.encode(ex["response"]) + [EOS]
        ids = ([BOS] + prompt + resp)[:seq_len + 1]
        x = ids[:-1]
        labels = ids[1:]
        if completion_only:
            # label positions that predict prompt tokens are ignored;
            # x[i] predicts labels[i], prompt spans x[0..len(prompt)]
            n_prompt = min(len(prompt), len(labels))
            labels = [-1] * n_prompt + labels[n_prompt:]
        pad = seq_len - len(x)
        xs.append(x + [PAD] * pad)
        ys.append(labels + [-1] * pad)
    return (np.asarray(xs, np.int32), np.asarray(ys, np.int32))


def build_llm_federated(args, n_silos: int, seq_len: int,
                        tokenizer: Optional[ByteTokenizer] = None):
    """Partition an instruction corpus across silos into the standard
    FederatedDataset (so simulators/cross-silo consume it unchanged)."""
    from ..data.containers import build_federated_dataset

    tokenizer = tokenizer or ByteTokenizer()
    corpus = load_instruction_corpus(
        getattr(args, "llm_corpus_path", None),
        n_fallback=int(getattr(args, "llm_corpus_size", 256)),
        seed=int(getattr(args, "random_seed", 0)),
        fallback=str(getattr(args, "llm_corpus_fallback", "synthetic")))
    x, y = tokenize_examples(corpus, tokenizer, seq_len)
    n = x.shape[0]
    rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))
    order = rng.permutation(n)
    n_test = max(4, n // 10)
    test_idx, train_idx = order[:n_test], order[n_test:]
    shards = np.array_split(train_idx, n_silos)
    client_x = [x[s] for s in shards]
    client_y = [y[s] for s in shards]
    fed = build_federated_dataset(
        client_x, client_y, x[test_idx], y[test_idx],
        batch_size=int(getattr(args, "batch_size", 8)),
        num_classes=tokenizer.vocab_size, dtype=np.int32, task="llm")
    corpus_path = getattr(args, "llm_corpus_path", None)
    fed.provenance = (
        "real" if (corpus_path and os.path.exists(corpus_path))
        or str(getattr(args, "llm_corpus_fallback", "synthetic"))
        == "shakespeare" else "synthetic")
    return fed, tokenizer
