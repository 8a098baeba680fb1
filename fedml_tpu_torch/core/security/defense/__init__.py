"""Defense dispatch (counterpart of
``fedml_tpu/core/security/defense/__init__.py``): ``FedMLDefender`` and
its host kernels (:mod:`.robust_agg`).

The defender consumes the round's client updates as the ``[K, D]``
float32 matrix of the JAX package's flat layout (``stack_to_matrix``) plus
their weights, and returns the defended aggregate. The kernels run on the
matrix's device. Cross-round state (FoolsGold history, cclip momentum,
SLSGD's previous global, cross-round's previous updates) is held by the
instance between rounds, as tensors on that device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .... import prng
from ...collectives import FlatLayout, stack_to_matrix
from ....utils.confval import get_float, get_int
from . import robust_agg

Tree = Dict[str, torch.Tensor]

DEFENSE_TYPES = (
    "krum", "multi_krum", "bulyan", "coordinate_median", "median",
    "trimmed_mean", "rfa", "geometric_median", "norm_clip", "cclip",
    "weak_dp", "crfl", "foolsgold", "three_sigma", "outlier_detection",
    "residual_reweight", "slsgd", "robust_learning_rate", "rlr",
    "soteria", "wbc", "cross_round",
)


def verdict_from_info(info, k: int) -> Optional[np.ndarray]:
    """Map a host defense kernel's info dict to the [K] per-client verdict
    (selection masks / keep flags / continuous weights). None when the
    defense exposes no per-client notion.

    ``selected``/``kept`` must be BINARY masks — host bulyan's
    ``selected`` carries top-theta row INDICES, which would pass a
    shape-only check (theta == k when byzantine_count == 0) and brand
    arbitrary clients. Continuous keys must already live in [0, 1]."""
    if not isinstance(info, dict):
        return None
    for key, binary in (("selected", True), ("kept", True),
                        ("fg_weights", False), ("confidence", False)):
        v = info.get(key)
        if v is None:
            continue
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
        v = np.asarray(v, np.float32)
        if v.shape != (k,):
            continue
        if binary and not np.all((v == 0.0) | (v == 1.0)):
            continue  # an index list, not an inclusion mask
        if not binary and (np.min(v) < 0.0 or np.max(v) > 1.0):
            continue
        return v
    return None


class FedMLDefender:
    """Configured from args; applied by the simulators when
    ``args.enable_defense`` (the reference's before/on/after-aggregation
    hooks collapse into one call, since the kernels fuse selection and
    aggregation)."""


    def __init__(self, args):
        self.args = args
        self.defense_type = str(getattr(args, "defense_type", None) or "").lower()
        self.enabled = bool(getattr(args, "enable_defense", False)) and \
            self.defense_type in DEFENSE_TYPES
        self.byzantine_count = get_int(args, "byzantine_client_num", 0)
        self.krum_param_m = get_int(args, "krum_param_m", 1)
        self.trim_fraction = get_float(args, "beta", 0.1)
        self.norm_bound = get_float(args, "norm_bound", 5.0)
        self.cclip_tau = get_float(args, "tau", 10.0)
        self.dp_stddev = get_float(args, "stddev", 0.002)
        self.alpha = get_float(args, "alpha", 1.0)
        self.rfa_iters = get_int(args, "rfa_iters", 8)
        # rfa_tol > 0: convergence-based Weiszfeld stop (rfa_iters becomes
        # a budget, not a trip count); 0 keeps the fixed count
        self.rfa_tol = get_float(args, "rfa_tol", 0.0)
        # cross-round state, held between rounds
        self._fg_history: Optional[torch.Tensor] = None
        self._cclip_momentum = None
        self._prev_global = None
        self._cr_prev: Dict[int, torch.Tensor] = {}
        self._round = 0

    def is_defense_enabled(self) -> bool:
        return self.enabled

    # -----------------------------------------------------------------------
    def defend_matrix(self, mat: torch.Tensor, weights,
                      rng: Optional[np.ndarray] = None,
                      client_ids=None) -> Tuple[torch.Tensor, Dict]:
        """[K, D] update matrix -> defended aggregate vector [D] (the
        entry point the simulators use)."""
        rng = rng if rng is not None else prng.PRNGKey(self._round)
        w = torch.as_tensor(weights, device=mat.device).float()
        vec, info = self._dispatch(mat, w, rng, client_ids)
        self._round += 1
        return vec, info

    def defend(self, stacked_update: Tree, weights,
               rng: Optional[np.ndarray] = None,
               client_ids=None) -> Tuple[Tree, Dict]:
        """Stacked client updates (leaves ``[K, ...]``) -> defended
        aggregate update (a parameter dict)."""
        layout = FlatLayout.of(stacked_update, stacked=True)
        vec, info = self.defend_matrix(stack_to_matrix(stacked_update),
                                       weights, rng, client_ids)
        like = {k: v[0] for k, v in stacked_update.items()}
        return layout.unflatten(vec, like=like), info

    def _dispatch(self, mat, weights, rng, client_ids):
        d = self.defense_type
        if d == "krum":
            return robust_agg.krum(mat, weights, self.byzantine_count, 1)
        if d == "multi_krum":
            return robust_agg.krum(mat, weights, self.byzantine_count,
                                   self.krum_param_m)
        if d == "bulyan":
            return robust_agg.bulyan(mat, weights, self.byzantine_count)
        if d in ("coordinate_median", "median"):
            return robust_agg.coordinate_median(mat, weights)
        if d == "trimmed_mean":
            return robust_agg.trimmed_mean(mat, weights, self.trim_fraction)
        if d in ("rfa", "geometric_median"):
            return robust_agg.geometric_median(mat, weights,
                                               iters=self.rfa_iters,
                                               tol=self.rfa_tol)
        if d == "norm_clip":
            return robust_agg.norm_clip(mat, weights, self.norm_bound)
        if d == "cclip":
            out, info = robust_agg.centered_clip(
                mat, weights, self.cclip_tau, momentum=self._cclip_momentum)
            self._cclip_momentum = out
            return out, info
        if d == "weak_dp":
            return robust_agg.weak_dp(mat, weights, rng, self.dp_stddev)
        if d == "crfl":
            agg = robust_agg.weighted_mean(mat, weights)
            return robust_agg.crfl_clip_and_perturb(
                agg, rng, self.norm_bound, self.dp_stddev), {}
        if d == "foolsgold":
            hist = self._update_fg_history(mat, client_ids)
            return robust_agg.foolsgold(mat, weights, hist)
        if d == "three_sigma":
            return robust_agg.three_sigma(mat, weights)
        if d == "outlier_detection":
            return robust_agg.outlier_detection(mat, weights)
        if d == "residual_reweight":
            return robust_agg.residual_reweight(mat, weights)
        if d == "slsgd":
            out, info = robust_agg.slsgd(
                mat, weights, trim_b=max(self.byzantine_count, 1),
                alpha=self.alpha, prev_global=self._prev_global)
            self._prev_global = out
            return out, info
        if d in ("robust_learning_rate", "rlr"):
            return robust_agg.robust_learning_rate(mat, weights)
        if d == "soteria":
            return robust_agg.soteria(mat, weights,
                                      get_float(self.args, "soteria_frac",
                                                0.5))
        if d == "wbc":
            return robust_agg.wbc(mat, weights)
        if d == "cross_round":
            prev, has_prev = self._cross_round_state(mat, client_ids)
            return robust_agg.cross_round_filter(
                mat, weights, prev, has_prev,
                get_float(self.args, "cross_round_threshold", -0.5))
        raise ValueError(f"unknown defense_type {self.defense_type!r}")

    @staticmethod
    def _ids(mat, client_ids) -> np.ndarray:
        return np.asarray(np.arange(mat.shape[0]) if client_ids is None
                          else client_ids, np.int64)

    def _cross_round_state(self, mat: torch.Tensor, client_ids):
        """Per-client previous-round updates for the cross-round defense
        (keyed by true client id; absent history passes through)."""
        ids = self._ids(mat, client_ids)
        prev = torch.zeros_like(mat)
        has = torch.zeros(mat.shape[0], dtype=torch.float32,
                          device=mat.device)
        for row, cid in enumerate(ids):
            if int(cid) in self._cr_prev:
                prev[row] = self._cr_prev[int(cid)]
                has[row] = 1.0
        for row, cid in enumerate(ids):
            self._cr_prev[int(cid)] = mat[row].clone()
        return prev, has

    def _update_fg_history(self, mat: torch.Tensor, client_ids
                           ) -> torch.Tensor:
        """FoolsGold needs per-client *accumulated* history across rounds."""
        ids = torch.as_tensor(self._ids(mat, client_ids), device=mat.device)
        n_total = int(getattr(self.args, "client_num_in_total",
                              mat.shape[0]))
        if self._fg_history is None:
            self._fg_history = torch.zeros((n_total, mat.shape[1]),
                                           dtype=torch.float32,
                                           device=mat.device)
        self._fg_history.index_add_(0, ids, mat)
        return self._fg_history.index_select(0, ids)
