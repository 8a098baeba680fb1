"""Local analyzers + server aggregators for each FA task.

Parity target: reference ``fa/local_analyzer/*`` + ``fa/aggregator/*`` —
average, frequency estimation, set intersection, union, k-percentile, and
heavy-hitter discovery (TrieHH lives in :mod:`.triehh`).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .base_frame import FAClientAnalyzer, FAServerAggregator


# --- average ---------------------------------------------------------------

class AvgClientAnalyzer(FAClientAnalyzer):
    def local_analyze(self, train_data, args=None) -> Tuple[float, int]:
        arr = np.asarray(train_data, dtype=np.float64)
        return float(arr.sum()), int(arr.size)


class AvgAggregator(FAServerAggregator):
    def aggregate(self, submissions: List[Tuple[float, int]]) -> float:
        total = sum(s for s, _ in submissions)
        n = sum(n for _, n in submissions)
        self.server_data = total / max(n, 1)
        return self.server_data


# --- frequency estimation ---------------------------------------------------

class FrequencyClientAnalyzer(FAClientAnalyzer):
    def local_analyze(self, train_data, args=None) -> Dict[Any, int]:
        return dict(Counter(list(np.asarray(train_data).ravel().tolist())))


class FrequencyAggregator(FAServerAggregator):
    def __init__(self, args=None):
        super().__init__(args)
        self.server_data = Counter()

    def aggregate(self, submissions: List[Dict[Any, int]]) -> Dict[Any, int]:
        for sub in submissions:
            self.server_data.update(sub)
        return dict(self.server_data)


# --- intersection / union ---------------------------------------------------

class IntersectionClientAnalyzer(FAClientAnalyzer):
    def local_analyze(self, train_data, args=None) -> set:
        return set(np.asarray(train_data).ravel().tolist())


class IntersectionAggregator(FAServerAggregator):
    def aggregate(self, submissions: List[set]) -> set:
        out = submissions[0]
        for s in submissions[1:]:
            out = out & s
        self.server_data = out
        return out


class UnionAggregator(FAServerAggregator):
    def aggregate(self, submissions: List[set]) -> set:
        out = set()
        for s in submissions:
            out |= s
        self.server_data = out
        return out


# --- k-percentile -----------------------------------------------------------

class KPercentileClientAnalyzer(FAClientAnalyzer):
    """Client reports its count below/above the server's current pivot —
    the interactive binary-search protocol of the reference (clients never
    reveal raw values)."""

    def local_analyze(self, train_data, args=None):
        pivot = self.init_msg
        arr = np.asarray(train_data, dtype=np.float64).ravel()
        return int((arr <= pivot).sum()), int(arr.size)


class KPercentileAggregator(FAServerAggregator):
    """Server drives a bisection on the pivot until the global rank of the
    pivot matches k%."""

    def __init__(self, args=None, k: float = 50.0, lo: float = -1e9,
                 hi: float = 1e9):
        super().__init__(args)
        self.k = k
        self.lo, self.hi = lo, hi
        self.pivot = 0.5 * (lo + hi)

    def get_init_msg(self):
        return self.pivot

    def aggregate(self, submissions: List[Tuple[int, int]]) -> float:
        below = sum(b for b, _ in submissions)
        total = sum(n for _, n in submissions)
        if total and (below / total) * 100.0 < self.k:
            self.lo = self.pivot
        else:
            self.hi = self.pivot
        self.pivot = 0.5 * (self.lo + self.hi)
        self.server_data = self.pivot
        return self.pivot
