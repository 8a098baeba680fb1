"""Client contribution metrics over one FL round (counterpart of
``fedml_tpu/core/contribution/contribution_assessor.py``).

Parity targets: reference ``core/contribution/gtg_shapley_value.py`` (150 —
truncated Monte-Carlo Shapley with within-round truncation + between-round
convergence), ``leave_one_out.py`` (127).

The round utility v(S) = metric(params + weighted average of S's updates)
is one function of a client *inclusion mask*
(:func:`_make_subset_value_fn`): the masked weighted mean of the round's
updates and the evaluation run on the updates' device, and only the
scalar value comes back to the host. The Monte-Carlo permutation loop
stays on the host. The LOO/GTG drivers only ever see ``v(mask) -> float``
(:func:`leave_one_out_values` / :func:`gtg_shapley_values`), with the JAX
package's permutation stream (``np.random.RandomState(seed)``), truncation
and convergence tests, so the same values give the same evaluations.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

PyTree = Any


def masked_mean(stacked: torch.Tensor, weights: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """``Σ_k (w_k m_k / max(Σ w m, 1e-12)) x_k`` over the leading axis of
    ``stacked`` ([K, ...]): the weighted mean of the clients the mask
    keeps."""
    w = weights * mask
    ww = w / torch.clamp(torch.sum(w), min=1e-12)
    return torch.sum(stacked * ww.to(stacked.dtype).reshape(
        (-1,) + (1,) * (stacked.dim() - 1)), dim=0)


def _make_subset_value_fn(eval_fn: Callable[[PyTree], torch.Tensor]):
    """v(mask): aggregate the masked subset of updates onto the global
    params and evaluate. The mask is the only input that changes between
    coalitions."""

    @torch.no_grad()
    def value(params, stacked_updates, weights, mask):
        mask = torch.as_tensor(np.asarray(mask, np.float32)).to(
            weights.device)
        cand = {k: params[k] + masked_mean(stacked_updates[k], weights,
                                           mask)
                for k in params}
        return eval_fn(cand)

    return value


def leave_one_out_values(value_of_mask: Callable[[np.ndarray], float],
                         k: int) -> np.ndarray:
    """LOO contribution over an opaque coalition-value callable
    ``value_of_mask([K] 0/1 mask) -> float``: v(N) - v(N \\ {i}) per
    client. The callable owns all device work."""
    full = float(value_of_mask(np.ones(k, np.float32)))
    out = np.zeros(k)
    for i in range(k):
        mask = np.ones(k, np.float32)
        mask[i] = 0.0
        out[i] = full - float(value_of_mask(mask))
    return out


def leave_one_out(params: PyTree, stacked_updates: PyTree,
                  weights: torch.Tensor,
                  eval_fn: Callable[[PyTree], torch.Tensor]) -> np.ndarray:
    """LOO over stacked update trees (builds the subset-value fn and
    defers to :func:`leave_one_out_values`)."""
    k = int(weights.shape[0])
    vfn = _make_subset_value_fn(eval_fn)
    return leave_one_out_values(
        lambda mask: vfn(params, stacked_updates, weights, mask), k)


def gtg_shapley_values(
    value_of_mask: Callable[[np.ndarray], float],
    k: int,
    max_perms: int = 20,
    truncation_eps: float = 1e-4,
    convergence_eps: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Guided-truncated-gradient Shapley (reference
    ``gtg_shapley_value.py``) over an opaque coalition-value callable:
    Monte-Carlo over permutations with within-permutation truncation (stop
    scanning once the remaining marginal gain is below ``truncation_eps``)
    and between-permutation convergence (stop when the running Shapley
    estimate moves < ``convergence_eps``)."""
    vfn = lambda mask: float(value_of_mask(mask))
    v_empty = vfn(np.zeros(k, np.float32))
    v_full = vfn(np.ones(k, np.float32))
    rng = np.random.RandomState(seed)
    phi = np.zeros(k)
    count = 0
    prev = None
    for t in range(max_perms):
        # guided: first permutation is the round order; later ones random
        perm = np.arange(k) if t == 0 else rng.permutation(k)
        mask = np.zeros(k, np.float32)
        v_prev = v_empty
        for pos, i in enumerate(perm):
            if abs(v_full - v_prev) < truncation_eps:
                # truncation: remaining clients get zero marginal this pass
                break
            mask[i] = 1.0
            v_cur = vfn(mask.copy())
            phi[i] += v_cur - v_prev
            v_prev = v_cur
        count += 1
        est = phi / count
        if prev is not None and np.max(np.abs(est - prev)) < convergence_eps:
            break
        prev = est
    return phi / max(count, 1)


def gtg_shapley(
    params: PyTree,
    stacked_updates: PyTree,
    weights: torch.Tensor,
    eval_fn: Callable[[PyTree], torch.Tensor],
    max_perms: int = 20,
    truncation_eps: float = 1e-4,
    convergence_eps: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """GTG-Shapley over stacked update trees (builds the subset-value fn
    and defers to :func:`gtg_shapley_values`)."""
    k = int(weights.shape[0])
    vfn = _make_subset_value_fn(eval_fn)
    return gtg_shapley_values(
        lambda mask: vfn(params, stacked_updates, weights, mask), k,
        max_perms=max_perms, truncation_eps=truncation_eps,
        convergence_eps=convergence_eps, seed=seed)


class ContributionAssessorManager:
    """Configured from args; called by the simulators after the round's
    attack (reference ``ServerAggregator.assess_contribution``).
    ``evaluations`` counts the coalition values computed, over the run."""

    def __init__(self, args):
        self.args = args
        self.method = str(getattr(args, "contribution_method", None)
                          or "").lower()
        self.enabled = self.method in ("loo", "leave_one_out", "gtg",
                                       "gtg_shapley", "shapley")
        self.history: List[Dict[str, Any]] = []
        self.evaluations = 0

    def assess_values(
        self,
        value_of_mask: Callable[[np.ndarray], float],
        k: int,
        client_ids: Optional[Sequence[int]] = None,
        round_idx: int = 0,
    ) -> Optional[np.ndarray]:
        """Assess over an opaque coalition-value callable."""
        if not self.enabled:
            return None

        def counted(mask):
            self.evaluations += 1
            return value_of_mask(mask)

        if self.method in ("loo", "leave_one_out"):
            vals = leave_one_out_values(counted, k)
        else:
            vals = gtg_shapley_values(counted, k,
                                      max_perms=int(getattr(
                                          self.args, "shapley_max_perms",
                                          20) or 20))
        return self._record(vals, client_ids, round_idx)

    def assess(
        self,
        params: PyTree,
        stacked_updates: PyTree,
        weights: torch.Tensor,
        eval_fn: Callable[[PyTree], torch.Tensor],
        client_ids: Optional[Sequence[int]] = None,
        round_idx: int = 0,
    ) -> Optional[np.ndarray]:
        if not self.enabled:
            return None
        vfn = _make_subset_value_fn(eval_fn)
        return self.assess_values(
            lambda mask: vfn(params, stacked_updates, weights, mask),
            int(weights.shape[0]), client_ids=client_ids,
            round_idx=round_idx)

    def _record(self, vals: np.ndarray, client_ids, round_idx: int
                ) -> np.ndarray:
        self.history.append({
            "round": round_idx,
            "client_ids": list(client_ids) if client_ids is not None
            else list(range(len(vals))),
            "contributions": vals.tolist(),
        })
        logger.info("round %d contributions: %s", round_idx,
                    np.round(vals, 4).tolist())
        return vals
