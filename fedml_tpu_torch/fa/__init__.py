"""Federated analytics (reference ``fa/``, 2.6k LoC): the FL skeleton minus
models — client analyzers + server aggregators for average, frequency,
intersection, union, k-percentile, and TrieHH heavy hitters, with an SP
simulator (cross-silo FA runs over the same WAN FSM as FL).

Usage parity with ``fa.init`` / ``FARunner``:

    from fedml_tpu_torch import fa
    result = fa.run_fa("avg", client_datas, args)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from .analyzers import (AvgAggregator, AvgClientAnalyzer,
                        FrequencyAggregator, FrequencyClientAnalyzer,
                        IntersectionAggregator, IntersectionClientAnalyzer,
                        KPercentileAggregator, KPercentileClientAnalyzer,
                        UnionAggregator)
from .base_frame import FAClientAnalyzer, FAServerAggregator
from .simulation import FASimulator
from .triehh import Trie, TrieHHAggregator, TrieHHClientAnalyzer

FA_TASK_AVG = "avg"
FA_TASK_FREQ = "frequency_estimation"
FA_TASK_INTERSECTION = "intersection"
FA_TASK_UNION = "union"
FA_TASK_K_PERCENTILE = "k_percentile"
FA_TASK_HEAVY_HITTER_TRIEHH = "heavy_hitter_triehh"


def create_fa_pair(task: str, args=None):
    """(analyzer, aggregator) per FA task (reference ``fa/fa_runner`` +
    per-task creators)."""
    t = str(task).lower()
    if t == FA_TASK_AVG:
        return AvgClientAnalyzer(args), AvgAggregator(args)
    if t in (FA_TASK_FREQ, "freq"):
        return FrequencyClientAnalyzer(args), FrequencyAggregator(args)
    if t == FA_TASK_INTERSECTION:
        return IntersectionClientAnalyzer(args), IntersectionAggregator(args)
    if t == FA_TASK_UNION:
        return IntersectionClientAnalyzer(args), UnionAggregator(args)
    if t == FA_TASK_K_PERCENTILE:
        k = float(getattr(args, "k_percentile", 50) or 50) if args else 50.0
        return (KPercentileClientAnalyzer(args),
                KPercentileAggregator(args, k=k))
    if t in (FA_TASK_HEAVY_HITTER_TRIEHH, "heavy_hitter"):
        theta = int(getattr(args, "triehh_theta", 2) or 2) if args else 2
        return (TrieHHClientAnalyzer(args),
                TrieHHAggregator(args, theta=theta))
    raise ValueError(f"unknown FA task {task!r}")


def run_fa(task: str, client_datas: Sequence[Sequence], args=None,
           comm_round: Optional[int] = None) -> Dict[str, Any]:
    analyzer, aggregator = create_fa_pair(task, args)
    sim = FASimulator(args or _DefaultArgs(len(client_datas)), client_datas,
                      analyzer, aggregator)
    return sim.run(comm_round)


class _DefaultArgs:
    def __init__(self, n_clients: int):
        self.comm_round = 1
        self.client_num_per_round = n_clients


__all__ = ["FAClientAnalyzer", "FAServerAggregator", "FASimulator",
           "create_fa_pair", "run_fa", "Trie", "TrieHHAggregator",
           "TrieHHClientAnalyzer"]
