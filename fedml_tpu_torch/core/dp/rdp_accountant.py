"""Renyi-DP accountant for the subsampled Gaussian mechanism.

A copy of ``fedml_tpu/core/dp/rdp_accountant.py`` (numpy only; the port keeps
its own copy and a parity test pins the two). Parity target there: the
reference ``core/dp/budget_accountant/rdp_accountant.py`` (178
LoC) + ``rdp_analysis.py`` (220) — track cumulative RDP over FL rounds and
convert to (epsilon, delta). Implementation is the standard
Mironov/Abadi-moments math (log-space binomial expansion for integer orders,
the Wang et al. subsampling bound), written fresh in numpy.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

DEFAULT_ORDERS: Tuple[float, ...] = tuple(
    [2.0] + list(range(3, 64)) + [128.0, 256.0, 512.0])


def _log_add(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    hi, lo = max(a, b), min(a, b)
    return hi + math.log1p(math.exp(lo - hi))


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def _rdp_gaussian(sigma: float, alpha: float) -> float:
    """RDP of the (unsubsampled) Gaussian mechanism: alpha / (2 sigma^2)."""
    return alpha / (2.0 * sigma * sigma)


def _rdp_subsampled_int(q: float, sigma: float, alpha: int) -> float:
    """RDP of the Poisson-subsampled Gaussian at integer order alpha
    (Mironov et al. 2019 binomial-sum bound, computed in log space)."""
    log_terms = []
    for k in range(alpha + 1):
        log_b = _log_comb(alpha, k)
        if q == 0:
            log_q = -np.inf if k > 0 else 0.0
        else:
            log_q = k * math.log(q) + (alpha - k) * math.log1p(-q)
        rdp_k = k * (k - 1) / (2.0 * sigma * sigma)
        log_terms.append(log_b + log_q + rdp_k)
    acc = -np.inf
    for t in log_terms:
        acc = _log_add(acc, t)
    return acc / (alpha - 1) if alpha > 1 else acc


def compute_rdp(q: float, noise_multiplier: float, steps: int,
                orders: Sequence[float] = DEFAULT_ORDERS) -> np.ndarray:
    """Cumulative RDP over ``steps`` rounds of the subsampled Gaussian with
    sampling rate ``q`` and noise multiplier sigma (noise_std / sensitivity)."""
    sigma = noise_multiplier
    rdp = []
    for a in orders:
        if q >= 1.0:
            val = _rdp_gaussian(sigma, a)
        elif float(a).is_integer() and a >= 2:
            val = _rdp_subsampled_int(q, sigma, int(a))
        elif a <= 1.0:
            raise ValueError(f"RDP orders must be > 1, got {a}")
        else:
            # Fractional orders: RDP(alpha) is non-decreasing in alpha, so the
            # value at ceil(alpha) is a sound upper bound. (Linear interpolation
            # between integer orders is NOT an upper bound for the subsampled
            # Gaussian and would under-report epsilon.)
            hi = max(int(math.ceil(a)), 2)
            val = _rdp_subsampled_int(q, sigma, hi)
        rdp.append(val * steps)
    return np.asarray(rdp)


def get_privacy_spent(orders: Sequence[float], rdp: np.ndarray,
                      target_delta: float) -> Tuple[float, float]:
    """(epsilon, optimal_order) via the improved conversion of Balle et al.:
    eps = rdp - (log(delta) + log(alpha)) / (alpha - 1) + log1p(-1/alpha)."""
    orders = np.asarray(orders, dtype=np.float64)
    rdp = np.asarray(rdp, dtype=np.float64)
    mask = orders > 1.0000001
    a = orders[mask]
    r = rdp[mask]
    eps = r - (np.log(target_delta) + np.log(a)) / (a - 1.0) + np.log1p(-1.0 / a)
    i = int(np.argmin(eps))
    return float(max(eps[i], 0.0)), float(a[i])


class RDPAccountant:
    """Accumulates per-round RDP (the reference accountant's ``add_step`` /
    ``get_epsilon`` shape)."""

    def __init__(self, orders: Sequence[float] = DEFAULT_ORDERS):
        self.orders = tuple(orders)
        self._rdp = np.zeros(len(self.orders))

    def step(self, noise_multiplier: float, sample_rate: float,
             num_steps: int = 1) -> None:
        self._rdp = self._rdp + compute_rdp(sample_rate, noise_multiplier,
                                            num_steps, self.orders)

    def get_epsilon(self, delta: float) -> float:
        eps, _ = get_privacy_spent(self.orders, self._rdp, delta)
        return eps
