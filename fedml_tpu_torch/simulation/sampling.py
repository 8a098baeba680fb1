"""Per-round client sampling and device schedules.

A copy of ``fedml_tpu/simulation/sampling.py``, so the port draws the same
cohort as the JAX package every round.

Parity targets: ``_client_sampling`` (reference ``sp/fedavg/fedavg_api.py:127``
— seeded ``np.random.choice`` per round, deterministic given round index) and
the NCCL simulator's ``client_schedule`` (``nccl/base_framework/Server.py:111``
— ``np.array_split`` of sampled clients over workers). Here the schedule is a
*tensor* ([n_devices, n_slots] local indices + active mask) consumed inside
the jitted round, replacing the broadcast ``client_schedule{i}`` params.

RNG streams: the reference (and this repo's seed state) sampled via
``np.random.seed(round_idx)`` + global ``np.random.choice`` — which clobbers
the PROCESS-GLOBAL NumPy RNG every round and ignores ``args.random_seed``
(every run samples identically). ``stream="legacy"`` reproduces that exact
sequence WITHOUT touching global state (a fresh ``RandomState(round_idx)``
is bit-compatible with the global-seed path) and stays the default so
existing schedules are bit-identical; ``stream="seeded"`` is the fixed
stream — a ``np.random.default_rng((random_seed, round_idx))`` Generator, so
different seeds sample different cohorts and the draw is still a pure
function of ``(seed, round)``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SAMPLING_STREAMS = ("legacy", "seeded")

# population size past which the seeded stream stops materializing and
# permuting a full [N] id array per draw (np.random's replace=False path)
# and samples ids via the generator directly. The two paths draw
# DIFFERENT (equally valid, equally deterministic) cohorts, so the
# switch is pinned to a fixed threshold — small-N draws stay
# bit-identical to every recorded schedule.
FAST_SAMPLE_MIN_N = 65536


def sample_ids_streaming(gen: np.random.Generator, n: int,
                         k: int) -> np.ndarray:
    """Uniform k-of-n id sample WITHOUT materializing the population.

    Floyd's algorithm: k draws from the generator, O(k) memory, exact
    uniform subset — then a k-element shuffle so the placement order is
    also uniform (callers treat sample order as schedule order). A pure
    function of the generator's state, so draws stay replayable."""
    k = min(int(k), int(n))
    if k <= 0:
        return np.empty(0, np.int64)
    chosen: set = set()
    order = []
    for j in range(n - k, n):
        t = int(gen.integers(0, j + 1))
        pick = t if t not in chosen else j
        chosen.add(pick)
        order.append(pick)
    out = np.asarray(order, np.int64)
    gen.shuffle(out)
    return out


def sampling_stream_from_args(args) -> str:
    """The ``sampling_stream`` knob, validated. ``legacy`` (default) keeps
    the reference's per-round stream bit-identical; ``seeded`` folds
    ``random_seed`` in."""
    stream = str(getattr(args, "sampling_stream", "legacy")
                 or "legacy").lower()
    if stream not in SAMPLING_STREAMS:
        raise ValueError(f"sampling_stream {stream!r} unknown; choose from "
                         f"{SAMPLING_STREAMS}")
    return stream


def client_sampling(round_idx: int, client_num_in_total: int,
                    client_num_per_round: int, random_seed: int = 0,
                    stream: str = "legacy") -> List[int]:
    if stream not in SAMPLING_STREAMS:  # same contract as the args knob
        raise ValueError(f"sampling_stream {stream!r} unknown; choose from "
                         f"{SAMPLING_STREAMS}")
    if client_num_in_total == client_num_per_round:
        return list(range(client_num_in_total))
    num = min(client_num_per_round, client_num_in_total)
    if stream == "legacy":
        # bit-compatible with the reference's np.random.seed(round_idx) +
        # global np.random.choice, but via a PRIVATE RandomState — the
        # process-global RNG is no longer clobbered every round
        rng = np.random.RandomState(round_idx)
        return list(rng.choice(range(client_num_in_total), num,
                               replace=False))
    gen = np.random.default_rng((int(random_seed), int(round_idx)))
    if client_num_in_total >= FAST_SAMPLE_MIN_N:
        # huge-population fast path: O(k) draws via the generator, no
        # [N] permutation (Generator.choice with replace=False builds
        # one) — still a pure function of (seed, round)
        return [int(c) for c in
                sample_ids_streaming(gen, client_num_in_total, num)]
    return [int(c) for c in gen.choice(client_num_in_total, num,
                                       replace=False)]


def build_schedule(
    sampled: List[int],
    n_devices: int,
    clients_per_device: int,
    max_slots: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Map sampled *global* client ids to per-device slots.

    Clients are owned by device ``cid // clients_per_device`` (their data
    shard lives there), so a sampled client trains where its data is — no
    cross-device data motion. Returns ``(local_idx[n_devices, S] int32,
    active[n_devices, S] float32)`` with padded slots masked out.

    The slot count S is bucketed to a power of two (capped at ``max_slots``)
    so the jitted round function sees at most log2 distinct schedule shapes
    across training instead of recompiling whenever the per-round max
    clients-on-one-device changes.
    """
    per_dev: List[List[int]] = [[] for _ in range(n_devices)]
    for cid in sampled:
        d = cid // clients_per_device
        per_dev[d].append(cid % clients_per_device)
    need = max(1, max(len(p) for p in per_dev))
    n_slots = 1
    while n_slots < need:
        n_slots *= 2
    if max_slots is not None:
        n_slots = min(max(n_slots, need), max(max_slots, need))
    idx = np.zeros((n_devices, n_slots), np.int32)
    active = np.zeros((n_devices, n_slots), np.float32)
    for d, locs in enumerate(per_dev):
        for s, li in enumerate(locs):
            idx[d, s] = li
            active[d, s] = 1.0
    return idx, active
