"""Robust aggregation kernels — Byzantine-tolerant alternatives to FedAvg
(counterpart of ``fedml_tpu/core/security/defense/robust_agg.py``: the
host kernels that ``FedMLDefender`` dispatches, the SP golden loop and the
engine's ``sharded_defense: false`` path run).

Each defense is a function over ``(updates, weights)``: ``updates`` is the
``[K, D]`` float32 matrix of flattened client updates on the device, rows
in sampled-client order, columns in the JAX package's flat layout.

All functions return ``(aggregated_vector [D], info dict)``.

Where torch and ``jax.numpy`` differ, these follow JAX: the median of an
even count averages the two middle values (``torch.median`` returns the
lower one), a selection of the m smallest breaks ties toward the lower
index (a stable argsort, as ``jax.lax.top_k`` of the negation and
``jnp.argsort``; never ``torch.topk``), the quantile is ``jnp.quantile``'s
linear rule, and the Gram products run in full float32 (:func:`f32_matmul`;
TF32 would round their inputs to 10 mantissa bits). A loop that ends when
its estimate stops moving runs its full trip count with the estimate
frozen once it stops, so no step reads the device from the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .... import prng

Arr = torch.Tensor


def f32_matmul(a: Arr, b: Arr) -> Arr:
    """``a @ b`` in full float32 on the card: TF32 off for this product
    whatever the process set (the CPU has no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _normalize(weights: Arr) -> Arr:
    return weights / torch.clamp(torch.sum(weights), min=1e-12)


def wsum(w: Arr, updates: Arr) -> Arr:
    """``einsum("k,kd->d", w, updates)``."""
    return f32_matmul(w[None, :], updates)[0]


def weighted_mean(updates: Arr, weights: Arr) -> Arr:
    return wsum(_normalize(weights), updates)


def median0(x: Arr) -> Arr:
    """``jnp.median(x, axis=0)``: the mean of the two middle values when
    the count is even."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def quantile_linear(x: Arr, q: float, dim: int) -> Arr:
    """``jnp.quantile(x, q, axis=dim, keepdims=True)`` (method "linear"),
    its index arithmetic in float32 as JAX does it."""
    n = x.shape[dim]
    pos = np.float32(q) * np.float32(n - 1)
    lo_i = int(min(max(np.floor(pos), 0), n - 1))
    hi_i = int(min(max(np.ceil(pos), 0), n - 1))
    hw = np.float32(pos - np.floor(pos))
    lw = np.float32(1) - hw
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, lo_i, 1)
    hi = s.narrow(dim, hi_i, 1)
    return lo * float(lw) + hi * float(hw)


def smallest(scores: Arr, m: int) -> Arr:
    """Indices of the ``m`` smallest scores, ties toward the lower index
    (``jax.lax.top_k(-scores, m)``)."""
    return torch.argsort(scores, stable=True)[:m]


def row_norms(updates: Arr) -> Arr:
    return torch.linalg.vector_norm(updates, dim=1)


# ---------------------------------------------------------------------------
# distance / score based selection
# ---------------------------------------------------------------------------

def pairwise_sq_dists(updates: Arr) -> Arr:
    """[K, K] squared euclidean distances (``sq_i + sq_j - 2 U Uᵀ``)."""
    sq = torch.sum(updates * updates, dim=1)
    return torch.clamp(sq[:, None] + sq[None, :]
                       - 2.0 * f32_matmul(updates, updates.t()), min=0.0)


def krum_scores_from_dists(dists: Arr, byzantine_count: int) -> Arr:
    """Krum scoring on an already-computed [K, K] squared-distance matrix
    (shared with the sharded bulyan kernel)."""
    k = dists.shape[0]
    closest = max(k - byzantine_count - 2, 1)
    d = dists + torch.eye(k, device=dists.device) * 1e30  # exclude self
    sorted_d = torch.sort(d, dim=1).values
    return torch.sum(sorted_d[:, :closest], dim=1)


def krum_scores(updates: Arr, byzantine_count: int) -> Arr:
    """Krum score per client: sum of its K - f - 2 smallest squared distances
    to other clients (Blanchard et al.; reference
    ``defense/krum_defense.py``)."""
    return krum_scores_from_dists(pairwise_sq_dists(updates),
                                  byzantine_count)


def mask_of(idx: Arr, k: int, like: Arr) -> Arr:
    return torch.zeros(k, dtype=torch.float32, device=like.device).index_fill_(
        0, idx, 1.0)


def krum(updates: Arr, weights: Arr, byzantine_count: int = 0,
         multi_k: int = 1) -> Tuple[Arr, Dict]:
    """Krum (multi_k=1) / Multi-Krum (multi_k=m): select the m lowest-score
    updates and average them."""
    scores = krum_scores(updates, byzantine_count)
    sel_mask = mask_of(smallest(scores, max(int(multi_k), 1)),
                        updates.shape[0], updates)
    w = weights * sel_mask
    return weighted_mean(updates, w), {"scores": scores, "selected": sel_mask}


def coordinate_median(updates: Arr, weights: Arr) -> Tuple[Arr, Dict]:
    """Coordinate-wise median (Yin et al.; reference
    ``defense/coordinate_wise_median_defense.py``)."""
    return median0(updates), {}


def trimmed_mean(updates: Arr, weights: Arr, trim_fraction: float = 0.1
                 ) -> Tuple[Arr, Dict]:
    """Coordinate-wise beta-trimmed mean (reference
    ``defense/coordinate_wise_trimmed_mean_defense.py``): drop the highest
    and lowest ``trim_fraction`` of values per coordinate, average the rest."""
    k = updates.shape[0]
    b = min(int(k * trim_fraction), (k - 1) // 2)
    s = torch.sort(updates, dim=0).values
    kept = s[b:k - b] if b > 0 else s
    return torch.mean(kept, dim=0), {"trimmed_each_side": b}


def weiszfeld(updates: Arr, w: Arr, v: Arr, iters: int, tol: float,
              eps: float = 1e-8, moved_of=None) -> Tuple[Arr, Arr]:
    """``iters`` smoothed Weiszfeld steps from ``v`` with normalized
    weights ``w``; with ``tol > 0`` the estimate freezes once a step moves
    it by at most ``tol`` (``moved_of(new, old)``, euclidean by default).
    Returns the estimate and the steps taken."""
    moved_of = moved_of or (lambda a, b: torch.linalg.vector_norm(a - b))
    ran = torch.zeros((), dtype=torch.int32, device=updates.device)
    live = torch.ones((), dtype=torch.bool, device=updates.device)
    for _ in range(iters):
        dist = torch.sqrt(torch.sum((updates - v[None]) ** 2, dim=1) + eps)
        beta = w / torch.clamp(dist, min=eps)
        beta = beta / torch.clamp(torch.sum(beta), min=1e-12)
        new = wsum(beta, updates)
        if tol <= 0.0:
            v = new
            continue
        v_next = torch.where(live, new, v)
        ran = ran + live.int()
        live = live & (moved_of(new, v) > tol)
        v = v_next
    if tol <= 0.0:
        ran = ran + iters
    return v, ran


def geometric_median(updates: Arr, weights: Arr, iters: int = 8,
                     eps: float = 1e-8, tol: float = 0.0) -> Tuple[Arr, Dict]:
    """RFA — smoothed Weiszfeld iteration for the weighted geometric median
    (Pillutla et al.; reference ``defense/RFA_defense.py``). ``tol > 0``
    (the ``rfa_tol`` knob) turns the fixed trip count into a budget: the
    estimate stops once it moves less than ``tol``, and ``info`` reports
    the steps taken."""
    w = _normalize(weights)
    v, ran = weiszfeld(updates, w, weighted_mean(updates, w), iters, tol,
                       eps)
    return v, {"iters_run": ran}


def bulyan(updates: Arr, weights: Arr, byzantine_count: int = 0
           ) -> Tuple[Arr, Dict]:
    """Bulyan (El Mhamdi et al.; reference ``defense/bulyan_defense.py``):
    iterative Multi-Krum selection of theta = K - 2f updates, then
    coordinate-wise trimmed mean keeping theta - 2f values per coordinate."""
    sel = smallest(krum_scores(updates, byzantine_count),
                   max(updates.shape[0] - 2 * byzantine_count, 1))
    return bulyan_trim(updates[sel], byzantine_count), {"selected": sel}


def bulyan_trim(chosen: Arr, byzantine_count: int) -> Arr:
    """Bulyan's second stage: per coordinate, the mean of the
    ``theta - 2f`` chosen values nearest the coordinate median."""
    theta = chosen.shape[0]
    beta = max(theta - 2 * byzantine_count, 1)
    dist_to_med = torch.abs(chosen - median0(chosen)[None])
    nearest = torch.sort(dist_to_med.t(), dim=1,
                         stable=True).indices[:, :beta]        # [D, beta]
    vals = torch.gather(chosen.t(), 1, nearest)
    return torch.mean(vals, dim=1)


# ---------------------------------------------------------------------------
# clipping / noise
# ---------------------------------------------------------------------------

def norm_clip(updates: Arr, weights: Arr, max_norm: float = 1.0
              ) -> Tuple[Arr, Dict]:
    """Norm-bounded aggregation (reference ``defense/norm_diff_clipping_defense.py``):
    scale each update to at most ``max_norm`` before weighted averaging."""
    norms = row_norms(updates)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return weighted_mean(updates * scale[:, None], weights), {"norms": norms}


def cclip_steps(updates: Arr, w: Arr, v: Arr, tau: float, iters: int,
                norms_of=row_norms) -> Arr:
    """``iters`` centered-clipping steps ``v <- v + Σ_k w_k clip(u_k - v,
    tau)`` from ``v`` (``w`` normalized)."""
    for _ in range(iters):
        diff = updates - v[None]
        scale = torch.clamp(tau / torch.clamp(norms_of(diff), min=1e-12),
                            max=1.0)
        v = v + wsum(w, diff * scale[:, None])
    return v


def centered_clip(updates: Arr, weights: Arr, tau: float = 1.0,
                  iters: int = 3, momentum: Arr = None) -> Tuple[Arr, Dict]:
    """Centered clipping (Karimireddy et al.; reference
    ``defense/cclip_defense.py``): v <- v + mean_k clip(u_k - v, tau)."""
    v = (torch.zeros(updates.shape[1], device=updates.device)
         if momentum is None else momentum)
    return cclip_steps(updates, _normalize(weights), v, tau, iters), {}


def weak_dp(updates: Arr, weights: Arr, rng: np.ndarray,
            stddev: float = 0.002) -> Tuple[Arr, Dict]:
    """Weak differential privacy defense (reference
    ``defense/weak_dp_defense.py``): plain weighted mean + gaussian noise."""
    agg = weighted_mean(updates, weights)
    return agg + stddev * prng.normal_t(rng, tuple(agg.shape),
                                        agg.device), {}


def crfl_clip_and_perturb(global_vec: Arr, rng: np.ndarray,
                          clip_norm: float = 15.0, stddev: float = 0.002
                          ) -> Arr:
    """CRFL (reference ``defense/crfl_defense.py``) post-aggregation step:
    clip the global model norm then add smoothing noise."""
    norm = torch.linalg.vector_norm(global_vec)
    clipped = global_vec * torch.clamp(
        clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return clipped + stddev * prng.normal_t(rng, tuple(global_vec.shape),
                                            global_vec.device)


# ---------------------------------------------------------------------------
# similarity / statistics based reweighting
# ---------------------------------------------------------------------------

def foolsgold_weights(history: Arr, eps: float = 1e-5,
                      norms_of=None) -> Arr:
    """FoolsGold (Fung et al.; reference ``defense/foolsgold_defense.py``):
    down-weight clients whose *historical* aggregate updates are mutually
    similar (sybils collude). ``history`` is [K, D] accumulated updates;
    returns per-client learning weights in [0, 1]."""
    norms = (torch.linalg.vector_norm(history, dim=1, keepdim=True)
             if norms_of is None else norms_of(history)[:, None])
    normed = history / torch.clamp(norms, min=eps)
    cs = f32_matmul(normed, normed.t()) - torch.eye(history.shape[0],
                                                    device=history.device)
    maxcs = torch.max(cs, dim=1).values
    # pardoning: rescale similarity of honest clients
    pard = torch.where(maxcs[None, :] > maxcs[:, None],
                       cs * maxcs[:, None]
                       / torch.clamp(maxcs[None, :], min=eps), cs)
    wv = torch.clamp(1.0 - torch.max(pard, dim=1).values, 0.0, 1.0)
    # logit rescale emphasises separation
    wv = wv / torch.clamp(torch.max(wv), min=eps)
    wv = torch.clamp(wv, eps, 1.0 - eps)
    logit = torch.log(wv / (1.0 - wv)) + 0.5
    return torch.clamp(logit, 0.0, 1.0)


def foolsgold(updates: Arr, weights: Arr, history: Arr) -> Tuple[Arr, Dict]:
    wv = foolsgold_weights(history)
    return weighted_mean(updates, weights * wv), {"fg_weights": wv}


def robust_band(scores: Arr) -> Tuple[Arr, Arr]:
    """Median and 1.4826·MAD (+1e-12) of ``scores``."""
    mu = median0(scores)
    return mu, 1.4826 * median0(torch.abs(scores - mu)) + 1e-12


def three_sigma(updates: Arr, weights: Arr, sigma_factor: float = 3.0
                ) -> Tuple[Arr, Dict]:
    """3-sigma outlier rejection (reference ``defense/three_sigma_defense.py``
    family): score = distance to the coordinate median vector; drop clients
    more than ``sigma_factor`` robust-sigma above the median score (median +
    MAD statistics, so the byzantine scores cannot inflate the threshold)."""
    scores = row_norms(updates - median0(updates)[None])
    mu, sd = robust_band(scores)
    keep = (scores <= mu + sigma_factor * sd).to(updates.dtype)
    return weighted_mean(updates, weights * keep), {"scores": scores,
                                                    "kept": keep}


def outlier_detection(updates: Arr, weights: Arr, z_threshold: float = 2.5
                      ) -> Tuple[Arr, Dict]:
    """Norm-based robust z-score filter (reference
    ``defense/outlier_detection.py``); median/MAD statistics so outliers
    cannot inflate their own acceptance threshold."""
    norms = row_norms(updates)
    mu, sd = robust_band(norms)
    keep = (torch.abs(norms - mu) <= z_threshold * sd).to(updates.dtype)
    return weighted_mean(updates, weights * keep), {"kept": keep}


def residual_confidence(resid: Arr, lam: float) -> Arr:
    """Huber-style factor ``clip(lam · MAD / resid, 0, 1)``."""
    mad = median0(torch.abs(resid - median0(resid))) + 1e-12
    return torch.clamp(lam * mad / torch.clamp(resid, min=1e-12), 0.0, 1.0)


def residual_reweight(updates: Arr, weights: Arr, lam: float = 2.0
                      ) -> Tuple[Arr, Dict]:
    """Residual-based reweighting (Fu et al.; reference
    ``defense/residual_based_reweighting_defense.py``, simplified to its
    IRLS core): weight each client by a Huber-style factor of its residual
    to the coordinate-median model."""
    conf = residual_confidence(row_norms(updates - median0(updates)[None]),
                               lam)
    return weighted_mean(updates, weights * conf), {"confidence": conf}


def sorted_trim_mean(updates: Arr, b: int) -> Arr:
    """Per-coordinate mean after dropping ``b`` values from each end."""
    k = updates.shape[0]
    s = torch.sort(updates, dim=0).values
    return torch.mean(s[b:k - b] if b > 0 else s, dim=0)


def slsgd(updates: Arr, weights: Arr, trim_b: int = 1, alpha: float = 1.0,
          prev_global: Arr = None) -> Tuple[Arr, Dict]:
    """SLSGD (Xie et al.; reference ``defense/slsgd_defense.py``):
    trimmed-mean aggregation mixed with the previous global model:
    ``(1-alpha) * prev + alpha * trmean``."""
    agg = sorted_trim_mean(updates, min(trim_b, (updates.shape[0] - 1) // 2))
    if prev_global is not None:
        agg = (1.0 - alpha) * prev_global + alpha * agg
    return agg, {}


def robust_learning_rate(updates: Arr, weights: Arr, threshold: int = 2
                         ) -> Tuple[Arr, Dict]:
    """RLR (Ozdayi et al.; reference ``defense/robust_learning_rate_defense.py``):
    per-coordinate sign vote — coordinates where fewer than ``threshold``
    clients agree in sign get their learning rate flipped."""
    sign_sum = torch.abs(torch.sum(torch.sign(updates), dim=0))
    lr_sign = torch.where(sign_sum >= threshold, 1.0, -1.0)
    return weighted_mean(updates, weights) * lr_sign, {"lr_sign": lr_sign}


def soteria(updates: Arr, weights: Arr, frac: float = 0.5
            ) -> Tuple[Arr, Dict]:
    """Soteria-style representation pruning (reference
    ``soteria_defense.py``): before aggregation, zero the smallest-magnitude
    ``frac`` of each client's update coordinates — the perturbed
    representation defends against gradient-inversion reconstruction while
    keeping the dominant directions."""
    mag = torch.abs(updates)
    cut = quantile_linear(mag, frac, dim=1)
    pruned = torch.where(mag >= cut, updates, 0.0)
    return weighted_mean(pruned, weights), {"pruned_frac": frac}


def two_means_keep(updates: Arr, dists: Arr, iters: int,
                   sq_dist_to=None) -> Arr:
    """WBC's 2-means: centroids seeded at the two most distant rows,
    ``iters`` Lloyd steps, then the keep flag of the LARGER cluster (the
    presumed-honest majority; cluster 1 wins iff it holds > K/2 rows)."""
    k = updates.shape[0]
    sq_dist_to = sq_dist_to or (
        lambda c: torch.sum((updates - c) ** 2, dim=1))
    flat_idx = torch.argmax(dists)   # first maximum, as jnp.argmax
    c = updates.index_select(0, torch.stack([flat_idx // k, flat_idx % k]))

    def assign_to(c):
        return torch.argmin(torch.stack([sq_dist_to(c[0]),
                                         sq_dist_to(c[1])]), dim=0)

    for _ in range(iters):
        one = (assign_to(c) == 1).to(updates.dtype)[:, None]
        n1 = torch.clamp(torch.sum(one), min=1.0)
        n0 = torch.clamp(torch.sum(1.0 - one), min=1.0)
        c = torch.stack([torch.sum(updates * (1 - one), dim=0) / n0,
                         torch.sum(updates * one, dim=0) / n1])
    assign = assign_to(c)
    majority = (torch.sum(assign) > k / 2).to(assign.dtype)
    return (assign == majority).to(updates.dtype)


def wbc(updates: Arr, weights: Arr, iters: int = 8) -> Tuple[Arr, Dict]:
    """White-Blood-Cell clustering defense (reference ``wbc_defense.py``
    shape): 2-means over the update vectors; only the LARGER cluster (the
    presumed-honest majority) is aggregated."""
    keep = two_means_keep(updates, pairwise_sq_dists(updates), iters)
    return (weighted_mean(updates, weights * keep),
            {"kept": torch.sum(keep)})


def cross_round_keep(updates: Arr, prev: Arr, has_prev: Arr,
                     sim_threshold: float) -> Tuple[Arr, Arr]:
    """(keep flags, cosines) of each row against its previous round's."""
    dot = torch.sum(updates * prev, dim=1)
    cos = dot / (row_norms(updates) * row_norms(prev) + 1e-12)
    keep = torch.where(has_prev > 0,
                       (cos >= sim_threshold).to(updates.dtype), 1.0)
    return keep, cos


def cross_round_filter(updates: Arr, weights: Arr, prev: Arr,
                       has_prev: Arr, sim_threshold: float = -0.5
                       ) -> Tuple[Arr, Dict]:
    """Cross-round consistency defense (reference
    ``cross_round_defense.py`` shape): a client whose update direction
    REVERSES versus its own previous round (cosine < threshold) is
    suspicious (oscillating / adaptive poisoning) and dropped this round.
    Clients without history pass through."""
    keep, cos = cross_round_keep(updates, prev, has_prev, sim_threshold)
    return (weighted_mean(updates, weights * keep),
            {"kept": torch.sum(keep), "mean_cos": torch.mean(cos)})
