"""The feature-sharded defense kernels of the robust round (counterpart of
``fedml_tpu/core/security/defense/sharded.py``).

The JAX package runs every defense SPMD over a feature-sharded ``[K, D/n]``
matrix: per-coordinate statistics stay on their shard, ``[K, K]`` Gram
products and ``[K]`` row norms are ``psum`` s of per-shard partials, and
cross-round state (FoolsGold's history, cclip's momentum, SLSGD's previous
global, cross-round's previous updates) is a device-resident pytree the
fused multi-round program threads through. Here each kernel takes a
:class:`ShardAxis`: this rank's shard index, the shard count and the
process group its partials are summed over (``core/collectives.py``).
Over W client ranks each rank holds the ``[K, D_pad / W]`` column block of
its index and its block of the state; on one card (:data:`ONE`) there is
one shard: every ``psum`` is the identity, the index is 0 and ``D`` needs
no padding. One implementation serves both. The state is a dict of device
tensors updated in place. Where the body differs from the host kernel
(:mod:`.robust_agg`), this keeps the body's form: krum slices
``[1:closest+1]`` of the sorted distances instead of adding ``1e30`` on the
diagonal, row norms are ``sqrt`` of summed squares, RFA starts from the
plain weighted sum, and the stochastic kernels and attacks fold the shard
index into their key (``fold_in(key, index)``), so W ranks draw what W JAX
devices draw.

``row_mask`` (a ``[K]`` validity mask, 1 = a real row) is the buffered-
async engine's partial pour: its ``[K]`` buffer shape is fixed, so a pour
of fewer than K arrivals pads with zero rows. The masked semantics per
kernel family are the JAX package's, and ``row_mask=None`` (every sync
path) runs the unmasked code unchanged:

* weight-folded kernels (mean, norm_clip, rfa, cclip, soteria, rlr) are
  mask-exact already: padded rows carry weight 0 (and ``sign(0) = 0`` in
  rlr's votes);
* coordinate sorts (median, trimmed_mean, slsgd) sort padded rows to
  +inf and take the valid prefix (:func:`_masked_median`,
  :func:`_masked_sorted_window_mean`);
* robust statistics (three_sigma, outlier_detection, residual_reweight)
  take their median / MAD over valid rows only;
* Gram selections (krum, multi_krum, bulyan, wbc) add 1e30 to every
  pair involving a padded row (wbc: -1, out of the seeding), so padding
  is never preferred;
* stateful scatters (foolsgold, cross_round) write nothing for padded
  rows: the caller pads ``ids`` with ids disjoint from the valid rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .... import prng
from ...collectives import all_gather_tiled, psum_packed
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

#: the state leaves laid out over the feature shards, on their last dim
#: (the JAX package's ``defense_state_spec``); the others are replicated
FEATURE_LEAVES = ("history", "momentum", "prev")


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


@dataclass(frozen=True)
class ShardAxis:
    """The feature axis a kernel runs over: this rank's shard ``index`` of
    ``size`` and the process ``group`` whose ranks hold the other shards
    (None: one shard, every sum the identity)."""

    group: Any = None
    index: int = 0
    size: int = 1

    def psum(self, t: Arr) -> Arr:
        """``jax.lax.psum`` of a per-shard partial."""
        return t if self.group is None else psum_packed([t],
                                                        self.group)[0]

    def all_gather(self, t: Arr) -> Arr:
        """``jax.lax.all_gather(t, axis, tiled=True)``."""
        return t if self.group is None else all_gather_tiled(t, self.group)


#: one card: one feature shard
ONE = ShardAxis()


# ---------------------------------------------------------------------------
# cross-round defense state
# ---------------------------------------------------------------------------

def defense_state_init(defense_type: str, n_total: int, d: int,
                       device) -> Dict[str, Arr]:
    """Zero cross-round state for a stateful defense on ``device``
    (``n_total``: the client population, per-client state is keyed by
    client id; ``d``: the feature shard's width, the ``[*, D]`` leaves are
    feature-sharded as the JAX package's ``defense_state_spec`` lays them
    out). Empty for stateless defenses. Zeros reproduce the host
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
                 key: np.ndarray, scale: float, ax: ShardAxis = ONE) -> Arr:
    """Model poisoning on a feature shard of the update matrix, the shard
    index folded into the key (the JAX body's ``fold_in(key,
    axis_index)``)."""
    return apply_model_attack(attack_type, mat, byz_mask,
                              prng.fold_in(key, ax.index), scale)


# ---------------------------------------------------------------------------
# kernel bodies (one shard)
# ---------------------------------------------------------------------------

def _row_norms(mat: Arr, ax: ShardAxis) -> Arr:
    """``[K]`` euclidean row norms from the psum'd per-shard squares."""
    return torch.sqrt(ax.psum(torch.sum(mat * mat, dim=1)))


def _dists(mat: Arr, ax: ShardAxis) -> Arr:
    """The ``[K, K]`` squared-distance Gram from per-shard partials."""
    return ax.psum(ra.pairwise_sq_dists(mat))


def _dist_to(mat: Arr, med: Arr, ax: ShardAxis) -> Arr:
    """``[K]`` distances of the rows to the per-coordinate ``med``."""
    return torch.sqrt(ax.psum(torch.sum((mat - med[None]) ** 2, dim=1)))


def _masked_median(x: Arr, mask: Arr) -> Arr:
    """Median over rows with ``mask > 0`` (dim 0; ``[K]`` or ``[K, D]``):
    invalid rows sort to +inf and the two middle entries of the valid
    prefix are indexed on the device."""
    key = mask if x.dim() == 1 else mask[:, None]
    s = torch.sort(torch.where(key > 0, x, float("inf")), dim=0).values
    n = torch.clamp(torch.sum(mask).to(torch.int64), min=1)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _masked_sorted_window_mean(mat: Arr, mask: Arr, b) -> Arr:
    """Per-coordinate mean of the sorted valid rows with ``b`` trimmed
    from each side (``b``: an int or a device scalar, clamped to the
    valid count): the masked trimmed mean and SLSGD core."""
    k = mat.shape[0]
    s = torch.sort(torch.where(mask[:, None] > 0, mat, float("inf")),
                   dim=0).values
    n = torch.clamp(torch.sum(mask).to(torch.int64), min=1)
    b = torch.minimum(torch.clamp(torch.as_tensor(b, device=mat.device)
                                  .to(torch.int64), min=0), (n - 1) // 2)
    idx = torch.arange(k, device=mat.device)[:, None]
    keep = ((idx >= b) & (idx < n - b)).to(mat.dtype)
    s = torch.where(torch.isfinite(s), s, 0.0)
    return (torch.sum(s * keep, dim=0)
            / torch.clamp(torch.sum(keep, dim=0), min=1.0))


def _mask_dists(dists: Arr, mask: Optional[Arr]) -> Arr:
    """+1e30 on every pair involving an invalid row: the valid rows'
    score tails inflate alike (their order kept), invalid rows are never
    selected."""
    if mask is None:
        return dists
    return dists + (1.0 - mask[:, None] * mask[None, :]) * 1e30


def _masked_band(scores: Arr, mask: Arr) -> Tuple[Arr, Arr]:
    """:func:`robust_agg.robust_band` over the valid rows."""
    mu = _masked_median(scores, mask)
    return mu, 1.4826 * _masked_median(torch.abs(scores - mu), mask) + 1e-12


def _krum_selection(dists: Arr, weights: Arr, byzantine_count: int,
                    m: int) -> Tuple[Arr, Arr]:
    k = dists.shape[0]
    closest = max(k - byzantine_count - 2, 1)
    sorted_d = torch.sort(dists, dim=1).values
    scores = torch.sum(sorted_d[:, 1:closest + 1], dim=1)
    sel = ra.mask_of(ra.smallest(scores, m), k, dists)
    return sel * weights, sel


def _bulyan(mat, hp: DefenseHP, ax: ShardAxis, mask=None):
    """Under a partial-pour ``mask`` padded rows are never preferred; a
    theta above the valid count pulls the trimmed mean toward the zero
    padding (a smaller step), as in JAX."""
    f = hp.byzantine_count
    theta = max(mat.shape[0] - 2 * f, 1)
    scores = ra.krum_scores_from_dists(_mask_dists(_dists(mat, ax), mask),
                                       f)
    sel = ra.smallest(scores, theta)
    return ra.bulyan_trim(mat[sel], f), ra.mask_of(sel, mat.shape[0], mat)


def _rfa(mat, weights, hp: DefenseHP, ax: ShardAxis):
    """Weiszfeld's [D]-sized estimate stays on the shard: each iteration
    sums the rows' squared-distance partials (and, with ``rfa_tol``, the
    movement's) over the shards."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    v, _ = ra.weiszfeld(
        mat, w, ra.wsum(w, mat), hp.rfa_iters, hp.rfa_tol,
        moved_of=lambda a, b: torch.sqrt(ax.psum(torch.sum((a - b) ** 2))),
        sq_reduce=ax.psum)
    return v


def _three_sigma(mat, weights, ax: ShardAxis, mask=None):
    if mask is None:
        scores = _dist_to(mat, ra.median0(mat), ax)
        mu, sd = ra.robust_band(scores)
        keep = (scores <= mu + 3.0 * sd).to(weights.dtype)
    else:
        scores = _dist_to(mat, _masked_median(mat, mask), ax)
        mu, sd = _masked_band(scores, mask)
        keep = ((scores <= mu + 3.0 * sd) & (mask > 0)).to(weights.dtype)
    return ra.weighted_mean(mat, weights * keep), keep


def _outlier(mat, weights, hp: DefenseHP, ax: ShardAxis, mask=None):
    norms = _row_norms(mat, ax)
    if mask is None:
        mu, sd = ra.robust_band(norms)
        keep = (torch.abs(norms - mu) <= hp.z_threshold * sd).to(mat.dtype)
    else:
        mu, sd = _masked_band(norms, mask)
        keep = ((torch.abs(norms - mu) <= hp.z_threshold * sd)
                & (mask > 0)).to(mat.dtype)
    return ra.weighted_mean(mat, weights * keep), keep


def _residual(mat, weights, hp: DefenseHP, ax: ShardAxis, mask=None):
    if mask is None:
        conf = ra.residual_confidence(_dist_to(mat, ra.median0(mat), ax),
                                      hp.resid_lam)
    else:
        resid = _dist_to(mat, _masked_median(mat, mask), ax)
        mad = _masked_median(torch.abs(resid - _masked_median(resid, mask)),
                             mask) + 1e-12
        conf = torch.clamp(hp.resid_lam * mad / torch.clamp(resid, min=1e-12),
                           0.0, 1.0) * mask
    return ra.weighted_mean(mat, weights * conf), conf


def _wbc_keep(mat, iters: int, ax: ShardAxis, valid=None) -> Arr:
    """WBC's 2-means over the rows with feature-sharded ``[2, D/n]``
    centroids: assignments from psum'd squared distances, the centroid
    update a local mean. Under a partial-pour mask (``valid``) padded rows
    stay out of the seeding (their pairs score -1), the centroid means
    and the majority vote (the JAX body's masked form)."""
    sq_dist_to = lambda c: ax.psum(  # noqa: E731
        torch.sum((mat - c) ** 2, dim=1))
    if valid is None:
        return ra.two_means_keep(mat, _dists(mat, ax), iters,
                                 sq_dist_to=sq_dist_to)
    k = mat.shape[0]
    dists = torch.where(valid[:, None] * valid[None, :] > 0,
                        _dists(mat, ax), -1.0)
    flat_idx = torch.argmax(dists)   # first maximum, as jnp.argmax
    c = mat.index_select(0, torch.stack([flat_idx // k, flat_idx % k]))

    def assign_to(c):
        return torch.argmin(torch.stack([sq_dist_to(c[0]),
                                         sq_dist_to(c[1])]), dim=0)

    for _ in range(iters):
        one = ((assign_to(c) == 1).to(mat.dtype) * valid)[:, None]
        zero = (valid - one[:, 0])[:, None]
        n1 = torch.clamp(torch.sum(one), min=1.0)
        n0 = torch.clamp(torch.sum(zero), min=1.0)
        c = torch.stack([torch.sum(mat * zero, dim=0) / n0,
                         torch.sum(mat * one, dim=0) / n1])
    assign = assign_to(c)
    majority = (torch.sum(assign * valid)
                > torch.sum(valid) / 2).to(assign.dtype)
    return (assign == majority).to(mat.dtype) * valid


def _noisy(vec: Arr, hp: DefenseHP, key: np.ndarray, ax: ShardAxis) -> Arr:
    """Gaussian noise drawn per shard, the shard index folded into the
    key."""
    return vec + hp.stddev * prng.normal_t(prng.fold_in(key, ax.index),
                                           tuple(vec.shape), vec.device)


def _crfl(mat, weights, hp: DefenseHP, key, ax: ShardAxis):
    agg = ra.weighted_mean(mat, weights)
    norm = torch.sqrt(ax.psum(torch.sum(agg * agg)))
    clipped = agg * torch.clamp(
        hp.norm_bound / torch.clamp(norm, min=1e-12), max=1.0)
    return _noisy(clipped, hp, key, ax)


def _soteria(mat, weights, hp: DefenseHP, ax: ShardAxis, true_d: int):
    """The per-row magnitude quantile needs the whole row: over shards one
    row is gathered at a time (peak memory ``O(D)``, never ``O(K D)``), its
    padding cut (``true_d``), then each shard prunes locally."""
    mag = torch.abs(mat)
    if ax.group is None:
        cuts = ra.quantile_linear(mag[:, :true_d], hp.soteria_frac, dim=1)
    else:
        cuts = torch.cat([ra.quantile_linear(
            torch.abs(ax.all_gather(mat[i]))[None, :true_d],
            hp.soteria_frac, dim=1) for i in range(mat.shape[0])])
    return ra.weighted_mean(torch.where(mag >= cuts, mat, 0.0), weights)


def _foolsgold(mat, weights, state, ids, ax: ShardAxis, mask=None):
    """Add this round's (post-attack) rows into the clients' history
    FIRST — the host kernel scores similarities on the updated history —
    then down-weight mutually-similar clients. Masked rows add nothing
    (their ids are disjoint from the valid rows')."""
    add = mat if mask is None else mask[:, None] * mat
    hist_rows = state["history"].index_select(0, ids) + add
    state["history"].index_copy_(0, ids, hist_rows)
    wv = ra.foolsgold_weights(hist_rows,
                              norms_of=lambda h: _row_norms(h, ax),
                              gram_reduce=ax.psum)
    return ra.weighted_mean(mat, weights * wv), wv


def _cclip(mat, weights, hp: DefenseHP, state, ax: ShardAxis):
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    v = ra.cclip_steps(mat, w, state["momentum"], hp.tau, hp.cclip_iters,
                       norms_of=lambda m: _row_norms(m, ax))
    state["momentum"] = v
    return v


def _slsgd(mat, hp: DefenseHP, state, mask=None):
    """Round 0 (``has == 0``) skips the mix exactly like the host kernel's
    ``prev_global is None``. Masked: the trim window covers the sorted
    valid rows only."""
    k = mat.shape[0]
    if mask is None:
        agg = ra.sorted_trim_mean(mat, min(max(hp.byzantine_count, 1),
                                           (k - 1) // 2))
    else:
        agg = _masked_sorted_window_mean(mat, mask,
                                         max(hp.byzantine_count, 1))
    mixed = torch.where(state["has"] > 0,
                        (1.0 - hp.alpha) * state["prev"] + hp.alpha * agg,
                        agg)
    state["prev"] = mixed
    state["has"] = torch.ones_like(state["has"])
    return mixed


def _cross_round(mat, weights, hp: DefenseHP, state, ids, ax: ShardAxis,
                 mask=None):
    """Masked rows neither write their (zero) row into the state nor mark
    history as present (their ids are disjoint from the valid rows')."""
    prev = state["prev"].index_select(0, ids)
    has = state["has"].index_select(0, ids)
    cos = ax.psum(torch.sum(mat * prev, dim=1)) / (
        _row_norms(mat, ax) * _row_norms(prev, ax) + 1e-12)
    keep = torch.where(has > 0, (cos >= hp.cr_threshold).to(mat.dtype), 1.0)
    if mask is None:
        state["prev"].index_copy_(0, ids, mat)
        state["has"].index_fill_(0, ids, 1.0)
    else:
        keep = keep * mask
        state["prev"].index_copy_(
            0, ids, torch.where(mask[:, None] > 0, mat, prev))
        state["has"].index_copy_(0, ids, torch.maximum(mask, has))
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
    row_mask: Optional[Arr] = None,
    ax: ShardAxis = ONE,
    true_d: Optional[int] = None,
) -> Tuple[Arr, Dict[str, Arr], Arr]:
    """``[K, D/n]`` feature shard + ``[K]`` weights (+ the cross-round
    ``state``'s shard, updated in place, the sampled client ``ids`` and the
    noise ``key``) -> (defended aggregate shard ``[D/n]``, state, ``[K]``
    verdict, replicated over the shards). The ONE implementation of the
    fused robust round, the defended async pour and
    :func:`defend_matrix_sharded`, on one card (``ax`` :data:`ONE`, the
    whole ``[K, D]``) and over client ranks. ``true_d`` is the unpadded
    feature width (soteria's quantile; default: the shard's own).
    ``row_mask`` (``[K]``, 1 = a real row) marks a partial pour's padding
    (see the module notes); None runs the unmasked kernels.

    The **verdict** is each client's effective inclusion in [0, 1]: the
    krum/bulyan selection mask, three_sigma/outlier/wbc/cross_round keep
    flags, residual confidences, foolsgold weights. Coordinate-wise and
    norm-shaping defenses (median, trimmed_mean, rfa, norm_clip, soteria,
    weak_dp, crfl, cclip, slsgd) report all-ones."""
    hp = hp or DefenseHP()
    state = state if state is not None else {}
    ones = torch.ones(mat.shape[0], dtype=torch.float32, device=mat.device)
    mask = row_mask
    d = _canon(defense_type)
    if d == "mean":
        return ra.weighted_mean(mat, weights), state, ones
    if d == "coordinate_median":
        if mask is None:
            return ra.median0(mat), state, ones
        return _masked_median(mat, mask), state, ones
    if d == "trimmed_mean":
        if mask is None:
            return (ra.trimmed_mean(mat, weights, hp.trim_fraction)[0],
                    state, ones)
        b = torch.floor(torch.sum(mask) * np.float32(hp.trim_fraction)
                        + 1e-6)
        return _masked_sorted_window_mean(mat, mask, b), state, ones
    if d == "three_sigma":
        vec, keep = _three_sigma(mat, weights, ax, mask)
        return vec, state, keep
    if d == "bulyan":
        vec, sel = _bulyan(mat, hp, ax, mask)
        return vec, state, sel
    if d == "rfa":
        return _rfa(mat, weights, hp, ax), state, ones
    if d == "norm_clip":
        scale = torch.clamp(hp.norm_bound / torch.clamp(
            _row_norms(mat, ax), min=1e-12), max=1.0)
        return ra.weighted_mean(mat * scale[:, None], weights), state, ones
    if d == "outlier_detection":
        vec, keep = _outlier(mat, weights, hp, ax, mask)
        return vec, state, keep
    if d == "residual_reweight":
        vec, conf = _residual(mat, weights, hp, ax, mask)
        return vec, state, conf
    if d == "rlr":
        return (ra.robust_learning_rate(mat, weights, hp.rlr_threshold)[0],
                state, ones)
    if d == "wbc":
        keep = _wbc_keep(mat, hp.wbc_iters, ax, mask)
        return ra.weighted_mean(mat, weights * keep), state, keep
    if d == "soteria":
        return (_soteria(mat, weights, hp, ax,
                         mat.shape[1] if true_d is None else int(true_d)),
                state, ones)
    if d == "weak_dp":
        return (_noisy(ra.weighted_mean(mat, weights), hp, key, ax), state,
                ones)
    if d == "crfl":
        return _crfl(mat, weights, hp, key, ax), state, ones
    if d == "foolsgold":
        vec, wv = _foolsgold(mat, weights, state, ids, ax, mask)
        return vec, state, wv
    if d == "cclip":
        return _cclip(mat, weights, hp, state, ax), state, ones
    if d == "slsgd":
        return _slsgd(mat, hp, state, mask), state, ones
    if d == "cross_round":
        vec, keep = _cross_round(mat, weights, hp, state, ids, ax, mask)
        return vec, state, keep
    if d not in ("krum", "multi_krum"):
        raise ValueError(f"unknown defense_type {defense_type!r}")
    sel_w, sel = _krum_selection(
        _mask_dists(_dists(mat, ax), mask), weights,
        hp.byzantine_count, 1 if d == "krum" else hp.multi_k)
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
    row_mask: Optional[Arr] = None,
):
    """``[K, D]`` -> defended aggregate ``[D]``, the model attack (when
    ``attack_type`` is set) injected on the device first: the JAX
    package's ``defend_matrix_sharded`` on a one-device mesh (``row_mask``
    marks a partial pour's padding), with the same returns — ``vec`` for stateless defenses, ``(vec, new_state)``
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
        key=prng.PRNGKey(0) if defense_key is None else defense_key,
        row_mask=(None if row_mask is None else torch.as_tensor(
            row_mask, device=dev).float()))
    result = (vec,)
    if stateful:
        result = result + (new_state,)
    if return_verdict:
        result = result + (verdict,)
    return result[0] if len(result) == 1 else result
