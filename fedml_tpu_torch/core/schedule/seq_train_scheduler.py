"""Workload-aware client -> device scheduling.

Parity target: reference ``core/schedule/seq_train_scheduler.py:9``
(``SeqTrainScheduler.DP_schedule`` — dynamic-programming assignment of
heterogeneous client workloads to workers minimizing the makespan) and
``runtime_estimate.py:16`` (``t_sample_fit`` — per-(client, device) runtime
regression from observed history), used by ``fedavg_seq``
(``simulation/mpi/fedavg_seq/FedAVGAggregator.py:126-188``) and the NCCL
simulator's ``client_schedule``.

On TPU the per-client cost is nearly uniform *per step* (XLA compiles one
program), so cost ~ #batches x epochs; the scheduler still matters when
client datasets are heavily non-IID in size: the default round-robin
schedule puts a 10x-data client next to a 1x one and the lax.scan padding
wastes (10x - 1x) of every other chip's time. LPT (longest-processing-time)
greedy is within 4/3 of optimal and O(n log n) — the DP formulation of the
reference is kept for exact small cases.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class RuntimeEstimator:
    """Per-client runtime model fit from observed round times (reference
    ``t_sample_fit``): t(c, d) ~ alpha_d * n_c + beta_d, least-squares over
    the history of (client sample count, observed seconds) per device."""

    def __init__(self):
        self._obs: Dict[int, List[Tuple[float, float]]] = {}

    def record(self, device: int, n_samples: float, seconds: float) -> None:
        self._obs.setdefault(device, []).append((float(n_samples),
                                                 float(seconds)))

    def fit(self, device: int) -> Tuple[float, float]:
        """Returns (alpha, beta) for the device; (1, 0) before any data."""
        obs = self._obs.get(device, [])
        if len(obs) < 2:
            return 1.0, 0.0
        x = np.asarray([o[0] for o in obs])
        y = np.asarray([o[1] for o in obs])
        a, b = np.polyfit(x, y, 1)
        return float(max(a, 1e-9)), float(max(b, 0.0))

    def predict(self, device: int, n_samples: float) -> float:
        a, b = self.fit(device)
        return a * float(n_samples) + b


class SeqTrainScheduler:
    """Assign sampled clients (with per-client costs) to ``n_workers`` so
    the slowest worker finishes earliest."""

    def __init__(self, workloads: Sequence[float], n_workers: int,
                 mode: str = "lpt"):
        self.workloads = np.asarray(workloads, np.float64)
        self.n_workers = int(n_workers)
        self.mode = mode

    def schedule(self) -> Tuple[List[List[int]], float]:
        """Returns (per-worker client-index lists, makespan estimate)."""
        if self.mode == "dp" and len(self.workloads) <= 16 and self.n_workers == 2:
            return self._dp_two_workers()
        return self._lpt()

    def _lpt(self) -> Tuple[List[List[int]], float]:
        order = np.argsort(-self.workloads)
        loads = np.zeros(self.n_workers)
        out: List[List[int]] = [[] for _ in range(self.n_workers)]
        for i in order:
            w = int(np.argmin(loads))
            out[w].append(int(i))
            loads[w] += self.workloads[i]
        return out, float(loads.max())

    def _dp_two_workers(self) -> Tuple[List[List[int]], float]:
        """Exact partition for 2 workers via subset-sum DP (the reference's
        DP_schedule specialization that is actually optimal)."""
        total = self.workloads.sum()
        scale = 1000.0 / max(total, 1e-9)
        w = np.round(self.workloads * scale).astype(int)
        target = int(w.sum()) // 2
        reach = {0: []}
        for i, wi in enumerate(w):
            new = {}
            for s, items in reach.items():
                s2 = s + int(wi)
                if s2 <= target and s2 not in reach and s2 not in new:
                    new[s2] = items + [i]
            reach.update(new)
        best = max(reach)
        a = reach[best]
        b = [i for i in range(len(w)) if i not in a]
        la = float(self.workloads[a].sum()) if a else 0.0
        lb = float(self.workloads[b].sum()) if b else 0.0
        return [a, b], max(la, lb)


def balanced_schedule(
    sampled: Sequence[int],
    client_costs: Sequence[float],
    n_devices: int,
) -> List[List[int]]:
    """LPT-balance sampled clients over devices by cost; returns per-device
    global-client-id lists (the engine maps them to local slots)."""
    costs = [float(client_costs[c]) for c in sampled]
    sched, _ = SeqTrainScheduler(costs, n_devices).schedule()
    return [[int(sampled[i]) for i in dev] for dev in sched]
