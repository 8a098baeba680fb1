"""Seeded client-arrival model — the clock the async benches run on (a
copy of ``fedml_tpu/core/async_rounds/arrivals.py``).

Async federated rounds only beat the barrier when clients ARRIVE at
different times, so the simulators need a latency model. This is the one
shared definition (the SP ``async_fedavg`` toy and the GPU engine's
``async_buffered`` mode both draw from it): heterogeneous per-client base
durations, lognormal around 1.0 (the toy's historical distribution), drawn
from the seeded sampling stream ``default_rng((random_seed, tag))`` —
a pure function of the seed, so two processes (or a crash-resumed run)
agree on every client's speed with zero coordination, and different seeds
actually produce different speed profiles (the old toy-local RandomState
respected the seed but lived outside the shared stream discipline).

Chaos maps onto arrivals the only way that makes sense for async:

* a STRAGGLER does its FULL local work, slowly — duration is divided by
  its work fraction (half-speed straggler = 2x duration). (The sync
  barrier path instead truncates local work via ``sched_work`` — there
  the round ends on the barrier regardless; here time IS the fault.)
* a DROPPED client never arrives — its update is lost and the client
  returns to the idle pool after its duration elapses (the reconnect /
  redemption event).
"""

from __future__ import annotations

import numpy as np

# domain-separation tag for the duration stream (arbitrary, distinct from
# the chaos plan's tags and the sampling streams' (seed, round) tuples)
_DURATION_TAG = 977


def client_durations(num_clients: int, random_seed: int = 0,
                     sigma: float = 0.6) -> np.ndarray:
    """[n] per-client base round durations (simulated seconds):
    ``1 + LogNormal(0, sigma)`` — heterogeneous, strictly positive,
    heavy-tailed enough that arrival order is genuinely scrambled."""
    gen = np.random.default_rng((int(random_seed), _DURATION_TAG))
    return 1.0 + gen.lognormal(0.0, float(sigma), size=int(num_clients))


def durations_from_args(num_clients: int, args) -> np.ndarray:
    # sigma=0 is a legitimate control config (homogeneous client speeds),
    # so absence — not falsiness — selects the default
    sigma = getattr(args, "async_duration_sigma", None)
    return client_durations(
        num_clients, random_seed=int(getattr(args, "random_seed", 0) or 0),
        sigma=float(0.6 if sigma is None else sigma))


def faulted_duration(base_s: float, work_scale: float) -> float:
    """Arrival-time semantics of a chaos work fraction: full work at
    ``work_scale`` speed. ``work_scale == 0`` (dropped) returns the base
    duration — that is when the client REDEEMS (rejoins the idle pool),
    not when an update arrives."""
    ws = float(work_scale)
    if ws <= 0.0:
        return float(base_s)
    return float(base_s) / min(ws, 1.0)
