"""The defense kernels of the fused robust round, on one card (counterpart
of ``fedml_tpu/core/security/defense/sharded.py``).

The JAX package runs every defense SPMD over a feature-sharded ``[K, D/n]``
matrix: per-coordinate statistics stay on their shard, ``[K, K]`` Gram
products and ``[K]`` row norms are ``psum`` s of per-shard partials, and
cross-round state (FoolsGold's history, cclip's momentum, SLSGD's previous
global, cross-round's previous updates) is a device-resident pytree the
fused multi-round program threads through. On one card there is one
feature shard: every ``psum`` is the identity, the shard index is 0 and
``D`` needs no padding. So each kernel here is its JAX body with those
three facts applied, on the whole ``[K, D]`` matrix on the device, and the
state is a dict of device tensors updated in place. Where the body differs
from the host kernel (:mod:`.robust_agg`), this keeps the body's form:
krum slices ``[1:closest+1]`` of the sorted distances instead of adding
``1e30`` on the diagonal, row norms are ``sqrt`` of summed squares, RFA
starts from the plain weighted sum, and the stochastic kernels and attacks
fold the shard index 0 into their key (``fold_in(key, 0)``), as JAX does on
a one-device mesh.

The JAX package's partial-pour row masks (the buffered-async engine's
defended pours) are not here: that engine is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .... import prng
from ..attack import apply_model_attack
from . import robust_agg as ra

Arr = torch.Tensor

# canonical kernel name per accepted alias (mirrors FedMLDefender._dispatch)
_ALIASES = {
    "median": "coordinate_median",
    "geometric_median": "rfa",
    "robust_learning_rate": "rlr",
}

_SHARDED = (
    # selection / per-coordinate statistics (exact)
    "krum", "multi_krum", "bulyan", "coordinate_median", "median",
    "trimmed_mean", "mean", "three_sigma", "rfa", "geometric_median",
    "norm_clip", "outlier_detection", "residual_reweight",
    "robust_learning_rate", "rlr", "wbc", "soteria",
    # stateful (device-resident cross-round state, see defense_state_init)
    "foolsgold", "cclip", "slsgd", "cross_round",
    # stochastic (noise keyed by the shard index)
    "weak_dp", "crfl",
)

# defenses that carry cross-round device state
_STATEFUL = ("foolsgold", "cclip", "slsgd", "cross_round")


def _canon(defense_type: str) -> str:
    return _ALIASES.get(defense_type, defense_type)


def supports_sharded(defense_type: str) -> bool:
    return defense_type in _SHARDED


def sharded_defense_names() -> str:
    """Stable, human-readable list of the sharded-capable defenses."""
    return ", ".join(sorted(set(_SHARDED)))


def is_stateful(defense_type: str) -> bool:
    return _canon(defense_type) in _STATEFUL


@dataclass(frozen=True)
class DefenseHP:
    """Hyper-parameters of the kernels. Defaults equal the host kernels'
    defaults in :mod:`.robust_agg`."""

    byzantine_count: int = 0
    multi_k: int = 1
    trim_fraction: float = 0.1
    norm_bound: float = 5.0
    tau: float = 10.0
    stddev: float = 0.002
    alpha: float = 1.0
    rfa_iters: int = 8
    rfa_tol: float = 0.0
    cclip_iters: int = 3
    wbc_iters: int = 8
    soteria_frac: float = 0.5
    cr_threshold: float = -0.5
    z_threshold: float = 2.5
    resid_lam: float = 2.0
    rlr_threshold: int = 2

    @classmethod
    def from_defender(cls, dfd) -> "DefenseHP":
        from ....utils.confval import get_float
        return cls(
            byzantine_count=int(dfd.byzantine_count),
            multi_k=int(dfd.krum_param_m),
            trim_fraction=float(dfd.trim_fraction),
            norm_bound=float(dfd.norm_bound),
            tau=float(dfd.cclip_tau),
            stddev=float(dfd.dp_stddev),
            alpha=float(dfd.alpha),
            rfa_iters=int(getattr(dfd, "rfa_iters", 8)),
            rfa_tol=float(getattr(dfd, "rfa_tol", 0.0)),
            soteria_frac=get_float(dfd.args, "soteria_frac", 0.5),
            cr_threshold=get_float(dfd.args, "cross_round_threshold", -0.5),
        )


# ---------------------------------------------------------------------------
# cross-round defense state
# ---------------------------------------------------------------------------

def defense_state_init(defense_type: str, n_total: int, d: int,
                       device) -> Dict[str, Arr]:
    """Zero cross-round state for a stateful defense on ``device``
    (``n_total``: the client population, per-client state is keyed by
    client id). Empty for stateless defenses. Zeros reproduce the host
    kernels' cold start: FoolsGold/cross_round accumulate from nothing,
    cclip's momentum starts at the origin, SLSGD's ``has`` flag skips the
    prev-global mix."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    d_ = _canon(defense_type)
    if d_ == "foolsgold":
        return {"history": z(n_total, d)}
    if d_ == "cclip":
        return {"momentum": z(d)}
    if d_ == "slsgd":
        return {"prev": z(d), "has": z()}
    if d_ == "cross_round":
        return {"prev": z(n_total, d), "has": z(n_total)}
    return {}


# ---------------------------------------------------------------------------
# attack injection (on the device)
# ---------------------------------------------------------------------------

def apply_attack(attack_type: str, mat: Arr, byz_mask: Arr,
                 key: np.ndarray, scale: float) -> Arr:
    """Model poisoning on the update matrix, the shard index 0 folded
    into the key (the JAX body's ``fold_in(key, axis_index)``)."""
    return apply_model_attack(attack_type, mat, byz_mask,
                              prng.fold_in(key, 0), scale)


# ---------------------------------------------------------------------------
# kernel bodies (one shard)
# ---------------------------------------------------------------------------

def _sq_norms(mat: Arr) -> Arr:
    """The psum'd per-row sums of squares, as ``sqrt``-able [K]."""
    return torch.sum(mat * mat, dim=1)


def _row_norms(mat: Arr) -> Arr:
    return torch.sqrt(_sq_norms(mat))


def _dist_to_median(mat: Arr) -> Arr:
    return torch.sqrt(torch.sum((mat - ra.median0(mat)[None]) ** 2, dim=1))


def _krum_selection(dists: Arr, weights: Arr, byzantine_count: int,
                    m: int) -> Tuple[Arr, Arr]:
    k = dists.shape[0]
    closest = max(k - byzantine_count - 2, 1)
    sorted_d = torch.sort(dists, dim=1).values
    scores = torch.sum(sorted_d[:, 1:closest + 1], dim=1)
    sel = ra.mask_of(ra.smallest(scores, m), k, dists)
    return sel * weights, sel


def _bulyan(mat, hp: DefenseHP):
    f = hp.byzantine_count
    theta = max(mat.shape[0] - 2 * f, 1)
    scores = ra.krum_scores_from_dists(ra.pairwise_sq_dists(mat), f)
    sel = ra.smallest(scores, theta)
    return ra.bulyan_trim(mat[sel], f), ra.mask_of(sel, mat.shape[0], mat)


def _rfa(mat, weights, hp: DefenseHP):
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    v, _ = ra.weiszfeld(
        mat, w, ra.wsum(w, mat), hp.rfa_iters, hp.rfa_tol,
        moved_of=lambda a, b: torch.sqrt(torch.sum((a - b) ** 2)))
    return v


def _three_sigma(mat, weights):
    scores = _dist_to_median(mat)
    mu, sd = ra.robust_band(scores)
    keep = (scores <= mu + 3.0 * sd).to(weights.dtype)
    return ra.weighted_mean(mat, weights * keep), keep


def _outlier(mat, weights, hp: DefenseHP):
    norms = _row_norms(mat)
    mu, sd = ra.robust_band(norms)
    keep = (torch.abs(norms - mu) <= hp.z_threshold * sd).to(mat.dtype)
    return ra.weighted_mean(mat, weights * keep), keep


def _noisy(vec: Arr, hp: DefenseHP, key: np.ndarray) -> Arr:
    return vec + hp.stddev * prng.normal_t(prng.fold_in(key, 0),
                                           tuple(vec.shape), vec.device)


def _crfl(mat, weights, hp: DefenseHP, key):
    agg = ra.weighted_mean(mat, weights)
    norm = torch.sqrt(torch.sum(agg * agg))
    clipped = agg * torch.clamp(
        hp.norm_bound / torch.clamp(norm, min=1e-12), max=1.0)
    return _noisy(clipped, hp, key)


def _foolsgold(mat, weights, state, ids):
    """Add this round's (post-attack) rows into the clients' history
    FIRST — the host kernel scores similarities on the updated history —
    then down-weight mutually-similar clients."""
    hist_rows = state["history"].index_select(0, ids) + mat
    state["history"].index_copy_(0, ids, hist_rows)
    wv = ra.foolsgold_weights(hist_rows, norms_of=_row_norms)
    return ra.weighted_mean(mat, weights * wv), wv


def _cclip(mat, weights, hp: DefenseHP, state):
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    v = ra.cclip_steps(mat, w, state["momentum"], hp.tau, hp.cclip_iters,
                       norms_of=_row_norms)
    state["momentum"] = v
    return v


def _slsgd(mat, hp: DefenseHP, state):
    """Round 0 (``has == 0``) skips the mix exactly like the host kernel's
    ``prev_global is None``."""
    k = mat.shape[0]
    agg = ra.sorted_trim_mean(mat, min(max(hp.byzantine_count, 1),
                                       (k - 1) // 2))
    mixed = torch.where(state["has"] > 0,
                        (1.0 - hp.alpha) * state["prev"] + hp.alpha * agg,
                        agg)
    state["prev"] = mixed
    state["has"] = torch.ones_like(state["has"])
    return mixed


def _cross_round(mat, weights, hp: DefenseHP, state, ids):
    prev = state["prev"].index_select(0, ids)
    has = state["has"].index_select(0, ids)
    cos = torch.sum(mat * prev, dim=1) / (_row_norms(mat) * _row_norms(prev)
                                          + 1e-12)
    keep = torch.where(has > 0, (cos >= hp.cr_threshold).to(mat.dtype), 1.0)
    state["prev"].index_copy_(0, ids, mat)
    state["has"].index_fill_(0, ids, 1.0)
    return ra.weighted_mean(mat, weights * keep), keep


# ---------------------------------------------------------------------------
# the unified kernel
# ---------------------------------------------------------------------------

def defend_shard_stateful(
    mat: Arr,
    weights: Arr,
    defense_type: str,
    hp: Optional[DefenseHP] = None,
    state: Optional[Dict[str, Arr]] = None,
    ids: Optional[Arr] = None,
    key: Optional[np.ndarray] = None,
) -> Tuple[Arr, Dict[str, Arr], Arr]:
    """``[K, D]`` matrix + ``[K]`` weights (+ the cross-round ``state``,
    updated in place, the sampled client ``ids`` and the noise ``key``)
    -> (defended aggregate ``[D]``, state, ``[K]`` verdict). The ONE
    implementation of the fused robust round and of
    :func:`defend_matrix_sharded`.

    The **verdict** is each client's effective inclusion in [0, 1]: the
    krum/bulyan selection mask, three_sigma/outlier/wbc/cross_round keep
    flags, residual confidences, foolsgold weights. Coordinate-wise and
    norm-shaping defenses (median, trimmed_mean, rfa, norm_clip, soteria,
    weak_dp, crfl, cclip, slsgd) report all-ones."""
    hp = hp or DefenseHP()
    state = state if state is not None else {}
    ones = torch.ones(mat.shape[0], dtype=torch.float32, device=mat.device)
    d = _canon(defense_type)
    if d == "mean":
        return ra.weighted_mean(mat, weights), state, ones
    if d == "coordinate_median":
        return ra.median0(mat), state, ones
    if d == "trimmed_mean":
        return ra.trimmed_mean(mat, weights, hp.trim_fraction)[0], state, ones
    if d == "three_sigma":
        vec, keep = _three_sigma(mat, weights)
        return vec, state, keep
    if d == "bulyan":
        vec, sel = _bulyan(mat, hp)
        return vec, state, sel
    if d == "rfa":
        return _rfa(mat, weights, hp), state, ones
    if d == "norm_clip":
        scale = torch.clamp(hp.norm_bound / torch.clamp(_row_norms(mat),
                                                        min=1e-12), max=1.0)
        return ra.weighted_mean(mat * scale[:, None], weights), state, ones
    if d == "outlier_detection":
        vec, keep = _outlier(mat, weights, hp)
        return vec, state, keep
    if d == "residual_reweight":
        conf = ra.residual_confidence(_dist_to_median(mat), hp.resid_lam)
        return ra.weighted_mean(mat, weights * conf), state, conf
    if d == "rlr":
        return (ra.robust_learning_rate(mat, weights, hp.rlr_threshold)[0],
                state, ones)
    if d == "wbc":
        keep = ra.two_means_keep(mat, ra.pairwise_sq_dists(mat),
                                 hp.wbc_iters)
        return ra.weighted_mean(mat, weights * keep), state, keep
    if d == "soteria":
        return ra.soteria(mat, weights, hp.soteria_frac)[0], state, ones
    if d == "weak_dp":
        return _noisy(ra.weighted_mean(mat, weights), hp, key), state, ones
    if d == "crfl":
        return _crfl(mat, weights, hp, key), state, ones
    if d == "foolsgold":
        vec, wv = _foolsgold(mat, weights, state, ids)
        return vec, state, wv
    if d == "cclip":
        return _cclip(mat, weights, hp, state), state, ones
    if d == "slsgd":
        return _slsgd(mat, hp, state), state, ones
    if d == "cross_round":
        vec, keep = _cross_round(mat, weights, hp, state, ids)
        return vec, state, keep
    if d not in ("krum", "multi_krum"):
        raise ValueError(f"unknown defense_type {defense_type!r}")
    sel_w, sel = _krum_selection(ra.pairwise_sq_dists(mat), weights,
                                 hp.byzantine_count,
                                 1 if d == "krum" else hp.multi_k)
    return ra.weighted_mean(mat, sel_w), state, sel


def defend_matrix_sharded(
    mat: Arr,
    weights: Arr,
    defense_type: str,
    byzantine_count: int = 0,
    multi_k: int = 1,
    trim_fraction: float = 0.1,
    attack_type: Optional[str] = None,
    attack_scale: float = 1.0,
    byz_mask: Optional[Arr] = None,
    attack_key: Optional[np.ndarray] = None,
    hp: Optional[DefenseHP] = None,
    state: Optional[Dict[str, Arr]] = None,
    ids: Optional[Arr] = None,
    defense_key: Optional[np.ndarray] = None,
    return_verdict: bool = False,
):
    """``[K, D]`` -> defended aggregate ``[D]``, the model attack (when
    ``attack_type`` is set) injected on the device first: the JAX
    package's ``defend_matrix_sharded`` on a one-device mesh, with the
    same returns — ``vec`` for stateless defenses, ``(vec, new_state)``
    for stateful ones (a cold start over the largest id when ``state`` is
    None), the ``[K]`` verdict appended last with ``return_verdict``."""
    if not supports_sharded(defense_type):
        raise ValueError(
            f"defense_type {defense_type!r} has no sharded kernel; host "
            f"fallback required. Sharded defenses: "
            f"{sharded_defense_names()}")
    if hp is None:
        hp = DefenseHP(byzantine_count=byzantine_count, multi_k=multi_k,
                       trim_fraction=float(trim_fraction))
    k, d = mat.shape
    dev = mat.device
    if ids is None:
        ids = torch.arange(k, device=dev)
    ids = torch.as_tensor(ids, device=dev).long()
    if attack_type is not None:
        if byz_mask is None:
            byz_mask = torch.zeros(k, device=dev)
        mat = apply_attack(attack_type, mat,
                           torch.as_tensor(byz_mask, device=dev),
                           prng.PRNGKey(0) if attack_key is None
                           else attack_key, float(attack_scale))
    stateful = is_stateful(defense_type)
    if stateful and state is None:
        state = defense_state_init(defense_type,
                                   max(k, int(ids.max()) + 1), d, dev)
    vec, new_state, verdict = defend_shard_stateful(
        mat, torch.as_tensor(weights, device=dev).float(), defense_type, hp,
        state=state if stateful else {}, ids=ids,
        key=prng.PRNGKey(0) if defense_key is None else defense_key)
    result = (vec,)
    if stateful:
        result = result + (new_state,)
    if return_verdict:
        result = result + (verdict,)
    return result[0] if len(result) == 1 else result
