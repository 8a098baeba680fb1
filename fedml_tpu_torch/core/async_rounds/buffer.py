"""UpdateBuffer — staleness-tagged client updates awaiting a pour (a copy
of ``fedml_tpu/core/async_rounds/buffer.py``).

The server-side half of buffered-async rounds: producers (the GPU engine's
arrival simulation) ``add`` updates as they
arrive; whenever ``ready()`` (>= K buffered) the owner ``pour``s — there is
no round barrier anywhere. Entries carry the model version the client was
DISPATCHED with, so staleness at pour time is ``current_version -
entry.version``: an honest per-update number, not a cohort-level guess.

The buffer is deliberately agnostic about what an ``update`` is (the GPU
engine stores device ``[D]`` tensors, tests plain floats) — it owns ordering, capacity, staleness
arithmetic, and fixed-shape persistence, nothing else.

Persistence: ``state_dict`` pads the entries to ``capacity_k`` rows with a
validity mask so the checkpoint template shape never depends on how full
the buffer happened to be at the save — that is what lets the async server
state ride :class:`~fedml_tpu_torch.core.checkpoint.RoundCheckpointer`
(it restores against a fixed template) and crash-resume replay identical pours.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclass
class BufferedUpdate:
    """One arrived client update, staleness-tagged."""

    client_id: int
    update: Any            # opaque payload (device vec / np vec / model)
    weight: float          # sample weight (n_k)
    version: int           # model version the client trained FROM
    arrival_t: float       # arrival timestamp (simulated or wall clock)
    seq: int = 0           # arrival tiebreaker: total order even at equal t
    # trace context of the producing upload/dispatch span (core/obs):
    # the pour span LINKS every poured entry's context, staleness per
    # link. Observability only — not persisted (a crash-resumed pour
    # replays identical math, just without links to pre-crash spans).
    trace: Any = None

    def staleness(self, current_version: int) -> int:
        return max(int(current_version) - int(self.version), 0)


class UpdateBuffer:
    """FIFO-by-arrival buffer of at most ``2 * capacity_k`` updates (a
    pour drains ``capacity_k``; the slack absorbs a burst of arrivals
    between the trigger and the pour without dropping anyone — beyond
    that, the OLDEST entries pour first anyway so the bound never drops a
    fresh update). Thread-safe: a server may add from transport threads while
    the pour runs on another."""

    def __init__(self, capacity_k: int):
        self.k = int(capacity_k)
        if self.k < 1:
            raise ValueError("async_buffer_k must be >= 1")
        # staleness CLAMPING deliberately lives in the weighting fn, not
        # here: the buffer tags versions, the decay interprets them
        self._entries: List[BufferedUpdate] = []
        self._seq = 0
        self._added = 0
        self._poured = 0
        self._lock = threading.Lock()

    # --- producers ----------------------------------------------------------
    def add(self, client_id: int, update: Any, weight: float, version: int,
            arrival_t: float, trace: Any = None) -> BufferedUpdate:
        with self._lock:
            e = BufferedUpdate(int(client_id), update, float(weight),
                               int(version), float(arrival_t), self._seq,
                               trace)
            self._seq += 1
            self._added += 1
            self._entries.append(e)
            # arrival order is the pour order; seq breaks exact-time ties
            # so a rerun with the same trace pours identically
            self._entries.sort(key=lambda x: (x.arrival_t, x.seq))
            return e

    # --- consumers ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def ready(self) -> bool:
        return len(self) >= self.k

    def pour(self, current_version: int,
             max_n: Optional[int] = None) -> List[BufferedUpdate]:
        """Drain the oldest ``min(len, max_n or k)`` entries in arrival
        order. Staleness is computed against ``current_version`` and
        CLAMPED to the cap by the weighting fn downstream — entries are
        never discarded for age (down-weighted, not dropped)."""
        n = self.k if max_n is None else int(max_n)
        with self._lock:
            take, self._entries = self._entries[:n], self._entries[n:]
            self._poured += len(take)
        return take

    # --- accounting (the soak test's ledger-balance assertion) --------------
    @property
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"added": self._added, "poured": self._poured,
                    "buffered": len(self._entries)}

    # --- persistence --------------------------------------------------------
    def state_dict(self, encode: Callable[[Any], np.ndarray],
                   pad_rows: Optional[int] = None,
                   vec_dim: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Fixed-shape snapshot: ``encode`` maps each opaque update payload
        to a 1-D f32 vector (all the same length); rows are padded to
        ``pad_rows`` (default ``2 * k``, the buffer's hard bound) with a
        validity mask. Pass ``vec_dim`` so an EMPTY buffer still snapshots
        at the template's [rows, d] shape (a checkpoint restores against a fixed
        template built from a fresh, empty instance)."""
        with self._lock:
            entries = list(self._entries)
            seq, added, poured = self._seq, self._added, self._poured
        rows = int(pad_rows) if pad_rows is not None else 2 * self.k
        if len(entries) > rows:
            raise ValueError(f"buffer holds {len(entries)} > pad_rows "
                             f"{rows} entries")
        vecs = [np.asarray(encode(e.update), np.float32) for e in entries]
        d = int(vec_dim) if vec_dim is not None else (
            vecs[0].shape[0] if vecs else 0)
        mat = np.zeros((rows, d), np.float32)
        for i, v in enumerate(vecs):
            mat[i] = v
        meta = np.zeros((rows, 5), np.float64)  # cid, weight, version, t, seq
        for i, e in enumerate(entries):
            meta[i] = (e.client_id, e.weight, e.version, e.arrival_t, e.seq)
        return {"mat": mat,
                "meta": meta,
                "mask": np.asarray([1.0] * len(entries)
                                   + [0.0] * (rows - len(entries)),
                                   np.float32),
                "counters": np.asarray([seq, added, poured], np.int64)}

    def load_state_dict(self, state: Dict[str, np.ndarray],
                        decode: Callable[[np.ndarray], Any]) -> None:
        mask = np.asarray(state["mask"], np.float32)
        meta = np.asarray(state["meta"], np.float64)
        mat = np.asarray(state["mat"], np.float32)
        ctr = np.asarray(state["counters"], np.int64)
        with self._lock:
            self._entries = []
            for i in range(mask.shape[0]):
                if mask[i] <= 0.0:
                    continue
                cid, w, ver, t, seq = meta[i]
                self._entries.append(BufferedUpdate(
                    int(cid), decode(mat[i]), float(w), int(ver), float(t),
                    int(seq)))
            self._entries.sort(key=lambda x: (x.arrival_t, x.seq))
            self._seq, self._added, self._poured = (int(ctr[0]), int(ctr[1]),
                                                    int(ctr[2]))
