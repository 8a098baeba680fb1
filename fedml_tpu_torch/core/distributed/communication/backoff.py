"""Exponential backoff + jitter: the delays of the retry policy (a copy of
``backoff_delays`` from ``fedml_tpu/core/distributed/communication/backoff.py``;
the serving gateway's failover paces itself on it). The reference's
``retry_with_backoff`` and ``retry_policy_from_args`` (the ``comm_retry_*``
knobs) come with the transports that call them.

Full jitter (delay drawn uniformly in ``[0, base * factor**attempt]``,
AWS-style) de-synchronizes retry storms when many silos hit the same dead
server; the jitter stream is seeded so a chaos run's retry timing is as
reproducible as its fault schedule.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def backoff_delays(base_s: float = 0.2, factor: float = 2.0,
                   max_s: float = 2.0, jitter: bool = True,
                   seed: Optional[int] = None) -> Iterator[float]:
    """Infinite iterator of backoff delays: ``min(base * factor**k, max)``,
    full-jittered (uniform in ``(0, cap]``) unless ``jitter=False``."""
    rng = np.random.default_rng(seed)
    k = 0
    while True:
        cap = min(base_s * (factor ** k), max_s)
        yield float(rng.uniform(0.0, cap)) if jitter else cap
        if base_s * (factor ** k) < max_s:
            k += 1

