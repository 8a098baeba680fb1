"""Differential privacy (counterpart of ``fedml_tpu/core/dp/``): calibrated
mechanisms, local/central DP frames, NbAFL, and an RDP accountant.

``FedMLDifferentialPrivacy`` is what the simulators consult: under LDP (and
NbAFL) each client update is clipped and noised before aggregation; under
CDP each client update is clipped and the aggregate is noised on the server
side. The accountant tracks the (epsilon, delta) spent across rounds for
the subsampled Gaussian. The DP type comes from ``dp_type``;
``enable_dp_ldp`` is a schema key the JAX package reads nowhere else, and
neither does the port.
"""

from __future__ import annotations

import numpy as np

from ...utils.confval import get_float
from .mechanisms import (Gaussian, Laplace, Tree, add_gaussian_noise,
                         add_laplace_noise, clip_by_global_norm,
                         create_mechanism, gaussian_sigma, laplace_scale)
from .rdp_accountant import RDPAccountant, compute_rdp, get_privacy_spent

DP_TYPE_LOCAL = "local_dp"   # aka LDP frame (reference frames/ldp.py)
DP_TYPE_CENTRAL = "central_dp"  # aka CDP frame (reference frames/cdp.py)
DP_TYPE_NBAFL = "nbafl"      # noise before+after aggregation (frames/NbAFL.py)


class FedMLDifferentialPrivacy:

    def __init__(self, args):
        self.args = args
        self.enabled = bool(getattr(args, "enable_dp", False))
        self.dp_type = str(getattr(args, "dp_type", DP_TYPE_LOCAL)
                           or DP_TYPE_LOCAL).lower()
        self.epsilon = get_float(args, "dp_epsilon", 10.0)
        self.delta = get_float(args, "dp_delta", 1e-5)
        # the clip norm IS the sensitivity: the clip enforces the bound the
        # noise is calibrated to, so the reported (epsilon, delta) matches
        # the mechanism run
        self.clip_norm = float(
            getattr(args, "dp_clip_norm", None)
            or getattr(args, "dp_sensitivity", None) or 1.0)
        self.sensitivity = self.clip_norm
        self.mechanism = create_mechanism(
            getattr(args, "dp_mechanism", "gaussian"),
            self.epsilon, self.delta, self.sensitivity) if self.enabled else None
        self.accountant = RDPAccountant()
        self._laplace_rounds = 0

    def is_dp_enabled(self) -> bool:
        return self.enabled

    def is_local_dp_enabled(self) -> bool:
        return self.enabled and self.dp_type in (DP_TYPE_LOCAL, DP_TYPE_NBAFL)

    def is_global_dp_enabled(self) -> bool:
        return self.enabled and self.dp_type in (DP_TYPE_CENTRAL, DP_TYPE_NBAFL)

    # --- transforms on parameter dicts --------------------------------------
    def add_local_noise(self, update: Tree, rng: np.ndarray) -> Tree:
        """Clip to sensitivity then noise, per client before aggregation
        (LDP / NbAFL uplink noise)."""
        clipped = clip_by_global_norm(update, self.clip_norm)
        return self.mechanism.add_noise(clipped, rng)

    def clip_update(self, update: Tree) -> Tree:
        """Per-client sensitivity bound: applied to every client update on
        the CDP path too, or the calibrated noise under-covers a single
        outlier contribution."""
        return clip_by_global_norm(update, self.clip_norm)

    def add_global_noise(self, agg: Tree, rng: np.ndarray) -> Tree:
        """Server-side noise on the aggregate (CDP / NbAFL downlink)."""
        return self.mechanism.add_noise(agg, rng)

    # --- accounting ---------------------------------------------------------
    def record_round(self, sample_rate: float) -> None:
        if not self.enabled:
            return
        sigma = getattr(self.mechanism, "sigma", None)
        if sigma is not None:
            self.accountant.step(sigma / max(self.sensitivity, 1e-12),
                                 sample_rate)
        else:
            # Laplace: pure-DP basic composition (epsilons add per round)
            self._laplace_rounds += 1

    def get_epsilon_spent(self) -> float:
        if self._laplace_rounds:
            return self.epsilon * self._laplace_rounds
        return self.accountant.get_epsilon(self.delta)

    # --- checkpointable accounting state ------------------------------------
    def state_dict(self):
        return {"rdp": np.asarray(self.accountant._rdp),
                "laplace_rounds": np.int64(self._laplace_rounds)}

    def load_state_dict(self, st) -> None:
        self.accountant._rdp = np.asarray(st["rdp"])
        self._laplace_rounds = int(st["laplace_rounds"])


__all__ = ["FedMLDifferentialPrivacy", "Gaussian", "Laplace",
           "add_gaussian_noise", "add_laplace_noise", "clip_by_global_norm",
           "create_mechanism", "gaussian_sigma", "laplace_scale",
           "RDPAccountant", "compute_rdp", "get_privacy_spent",
           "DP_TYPE_LOCAL", "DP_TYPE_CENTRAL", "DP_TYPE_NBAFL"]
