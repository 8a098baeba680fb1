"""Exponential backoff + jitter — the one retry policy of every transport
(a copy of ``fedml_tpu/core/distributed/communication/backoff.py``): the
TCP and gRPC sends retry through :func:`retry_with_backoff` under the
``comm_retry_*`` knobs (:func:`retry_policy_from_args`), and the serving
gateway's failover paces itself on :func:`backoff_delays`.

Full jitter (delay drawn uniformly in ``[0, base * factor**attempt]``,
AWS-style) de-synchronizes retry storms when many silos hit the same dead
server; the jitter stream is seeded so a chaos run's retry timing is as
reproducible as its fault schedule.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterator, Optional, Tuple, Type

import numpy as np

logger = logging.getLogger(__name__)


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


def retry_with_backoff(
    fn: Callable[[], None],
    max_attempts: int = 4,
    base_s: float = 0.2,
    factor: float = 2.0,
    max_s: float = 2.0,
    deadline_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    seed: Optional[int] = None,
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
):
    """Run ``fn`` with up to ``max_attempts`` retries after the first try
    (``max_attempts=0`` = fail fast, the pre-chaos behavior). Stops early
    when ``deadline_s`` (wall seconds from the first attempt) is already
    exceeded or would be by the next delay — the check counts time SPENT
    INSIDE ``fn`` too, so a slow failing call (connect timeout) cannot
    stretch the budget by arriving at the check late. Re-raises the last
    failure.

    ``on_retry(attempt, delay_s, exc)`` fires before each retry sleep —
    the observability seam: transports attach a span event per retry so
    a trace shows WHERE a round's wall time went when the wire flapped.
    Hook failures are swallowed (observability never breaks the send)."""
    delays = backoff_delays(base_s, factor, max_s, seed=seed)
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            delay = next(delays)
            expired = (deadline_s is not None
                       and time.monotonic() - t0 + delay > deadline_s)
            if attempt > max_attempts or expired:
                raise
            logger.debug("%s failed (%s: %s); retry %d/%d in %.2fs",
                         describe, type(e).__name__, e, attempt,
                         max_attempts, delay)
            if on_retry is not None:
                try:
                    on_retry(attempt, delay, e)
                except Exception:
                    logger.debug("on_retry hook failed", exc_info=True)
            sleep(delay)


def retry_policy_from_args(args) -> dict:
    """The transport-level retry knobs (``comm_retry_*``) as kwargs for
    :func:`retry_with_backoff`; a single reading so TCP/gRPC/decentralized
    can't drift apart on defaults.

    ``comm_retry_deadline_s`` caps the TOTAL elapsed retry budget (wall
    seconds from the first attempt) on top of the attempt count: without
    it, a long per-try timeout times ``max_attempts`` can stall a caller
    — an async pour most of all — far past the point where retrying is
    useful. 0 (the default) keeps the legacy attempt-count-only bound."""
    deadline = float(getattr(args, "comm_retry_deadline_s", 0.0)
                     if args is not None else 0.0)
    return {
        "max_attempts": int(getattr(args, "comm_retry_max_attempts", 4)
                            if args is not None else 4),
        "base_s": float(getattr(args, "comm_retry_base_s", 0.2)
                        if args is not None else 0.2),
        "max_s": float(getattr(args, "comm_retry_max_s", 2.0)
                       if args is not None else 2.0),
        "deadline_s": deadline if deadline > 0 else None,
    }
