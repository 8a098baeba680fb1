"""Buffered-async federated rounds on the GPU engine (counterpart of
``fedml_tpu/simulation/tpu/async_engine.py``, ``AsyncBufferedSimulator``).

``round_mode: async_buffered`` removes the round barrier: the server pours
a staleness-weighted buffer of K client updates whenever the K-th arrives
(FedBuff, Nguyen et al. AISTATS 2022; decay families from FedAsync, Xie et
al. 2019), so one slow or dead client caps nothing — it is down-weighted
when it finally lands and redeemed back into the rotation, never waited on.

* **Arrival time is simulated.** Clients get seeded heterogeneous base
  durations (``core/async_rounds/arrivals.py``); the chaos plan is the
  adversary — a straggler does full work slowly (duration / work fraction)
  and a dropped client never delivers, rejoining the idle pool after its
  duration (the redemption event). A virtual clock and an event heap order
  arrivals; everything is a pure function of the seeds, so runs (and
  crash-resumes) replay identical pours.

* **A pour.** The host absorbs arrivals to K, draws the freed clients from
  the idle rotation and trains them, one after another through the
  engine's captured step, on the PRE-pour params (each client's update ‖
  extras becomes a row of a ``[n, row_d]`` matrix on the device, in the
  JAX flat layout); then it pours the buffer: ``pour_weights`` on the host
  gives the ``[K]`` relative mix and the merge scale, the rows' weighted
  sum goes through ``server_update_async`` with the poured fraction of the
  population. The JAX package runs both halves as one program and XLA
  overlaps them; here they run in that order on one stream. The pour's
  key is ``fold_in(rng, dispatch_seq)``, each client's ``fold_in(key,
  cid)``, and the optimizer's round index is the model version.

* **A client trains on the model it was handed.** Its update is computed
  at dispatch (identical to computing it at arrival, since the base is
  fixed then) but enters the buffer only when the virtual clock says it
  arrived — staleness is the honest count of pours in between. A dropped
  client trains nothing.

* **Defended pours.** Buffered updates were trained from different
  versions, so before a defense compares them each row is re-based onto
  the current version: the engine keeps a per-version base-delta ring
  ``[R, D]`` on the device (slot ``v mod R`` holds ``params_{v+1} −
  params_v``; R = the staleness cap, 64 when it is adaptive), and row k
  loses ``drift_mask[k] @ ring``, the movement it missed. The model attack
  hits the re-based rows, then ``defend_shard_stateful`` runs with the
  staleness decay in the row weights and a ``[K]`` row mask for a partial
  pour (padded ids disjoint from the poured ones, so stateful scatters
  write nothing for them). At staleness 0 the correction is exactly zero:
  a defended pour equals the sync defense on the same rows. Verdicts go
  to the selection store; ``reputation`` benches clients out of the
  rotation, ``oort`` / ``power_of_choice`` rank the idle pool.

The async control state (buffer, in-flight events, virtual clock, idle
rotation, latency EMAs, the ring) joins the round checkpoint as the
``async_rounds`` leaf, at fixed shapes. ``comm_round`` counts pours.
"""

from __future__ import annotations

import heapq
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import prng
from ...core.algframe.local_training import METRICS
from ...core.algframe.types import TrainHyper
from ...core.async_rounds import (UpdateBuffer, adaptive_staleness_cap,
                                  buffer_k_from_args, durations_from_args,
                                  faulted_duration, make_staleness_fn,
                                  merge_alpha_from_args, pour_weights,
                                  staleness_cap_from_args,
                                  weighting_knobs_from_args)
from ...core.chaos import ChaosCrash
from ...core.collectives import FlatLayout
from ...core.obs import metrics as obs_metrics
from ...core.obs import sink as obs_sink
from ...core.obs import trace as obs_trace
from ...core.security.defense import sharded as sharded_defense
from ...core.security.defense.robust_agg import f32_matmul, wsum
from ...core.selection import slot_placement
from .engine import ATTACK_FOLD, DEFENSE_FOLD, GPUSimulator

logger = logging.getLogger(__name__)

_ARRIVE = 0
_REDEEM = 1

# domain-separation tag for the idle-pool rotation order (distinct from
# the chaos and duration tags)
_ROTATION_TAG = 1013


class _ExtrasLayout:
    """An optimizer's extras (``{name: params-like dict or scalar}``) as one
    float32 vector after the update in a buffer row: names sorted (JAX's
    key order), a params-like entry in the JAX flat layout."""

    def __init__(self, zero: Dict[str, Any]):
        self.parts = []
        for name in sorted(zero):
            v = zero[name]
            if isinstance(v, dict):
                lay = FlatLayout.of(v)
                self.parts.append((name, lay, lay.size, None))
            else:
                self.parts.append((name, None, int(v.numel()),
                                   tuple(v.shape)))
        self.size = sum(p[2] for p in self.parts)

    def flatten_into(self, extras: Dict[str, Any], out: torch.Tensor) -> None:
        o = 0
        for name, lay, size, _ in self.parts:
            if lay is not None:
                lay.flatten_into(extras[name], out[o:o + size])
            else:
                out[o:o + size].copy_(extras[name].reshape(-1))
            o += size

    def unflatten(self, vec: torch.Tensor, like: Dict[str, Any]
                  ) -> Dict[str, Any]:
        out, o = {}, 0
        for name, lay, size, shape in self.parts:
            if lay is not None:
                out[name] = lay.unflatten(vec[o:o + size], like=like[name])
            else:
                out[name] = vec[o:o + size].reshape(shape).to(
                    like[name].dtype)
            o += size
        return out


class AsyncBufferedSimulator(GPUSimulator):
    """The GPU engine in ``round_mode: async_buffered``. ``comm_round``
    counts POURS (global model versions), the async analog of rounds.

    ``async_stats``: local steps run (the bootstrap's included), clients
    dispatched, dropped and straggling. ``verdicts[version]``: the poured
    client ids and the defense's ``[n]`` verdict (a device tensor)."""

    def __init__(self, args, fed_dataset, bundle, optimizer, spec,
                 device: torch.device,
                 init_params: Optional[Dict[str, Any]] = None,
                 server_aggregator=None):
        super().__init__(args, fed_dataset, bundle, optimizer, spec, device,
                         init_params=init_params,
                         server_aggregator=server_aggregator)
        # --- config guards: fail loudly, never silently degrade ----------
        if self.contribution.enabled or self.server_aggregator is not None:
            raise ValueError(
                "round_mode: async_buffered composes with attacks/defenses "
                "(defended pours re-base the buffer onto the current "
                "version), but not yet with contribution assessment or "
                "user ServerAggregators — both consume a same-version "
                "host-ordered update matrix; use round_mode: sync")
        if self.dp.is_dp_enabled():
            raise ValueError(
                "round_mode: async_buffered does not yet compose with DP "
                "(per-pour accounting under stale mixed cohorts is an open "
                "design); use round_mode: sync with DP")
        self._defended = (self.defender.is_defense_enabled()
                          or self.attacker.is_model_attack())
        if self.defender.is_defense_enabled():
            if self.defender.defense_type in ("weak_dp", "crfl"):
                raise ValueError(
                    "round_mode: async_buffered refuses defense_type "
                    f"{self.defender.defense_type!r}: noise-adding "
                    "defenses are DP by another name, and per-pour noise "
                    "accounting over a mixed-staleness buffer is the same "
                    "open design that keeps async+DP refused; use "
                    "round_mode: sync")
            if not self._sharded:
                raise ValueError(
                    "round_mode: async_buffered runs the defense INSIDE "
                    "the pour and needs the sharded defense path; "
                    "sharded_defense: false configs must use round_mode: "
                    "sync")
            pref = str(getattr(args, "robust_fused", "auto")
                       or "auto").lower()
            if pref in ("false", "0", "no", "host"):
                raise ValueError(
                    "robust_fused: host has no meaning under round_mode: "
                    "async_buffered — the defended pour is one fused "
                    "step by construction; use robust_fused: auto")
        if self.selection.adaptive:
            # no per-round cohort to over-sample: the in-flight
            # concurrency is fixed and dropped arrivals are redeemed by
            # the rotation — pin rather than refuse, loudly
            self.selection.pin_adaptive(
                "async_buffered has no per-round cohort to over-sample "
                "(fixed in-flight concurrency; drops redeem via the "
                "rotation)")
        n = int(fed_dataset.num_clients)
        self.concurrency = min(int(args.client_num_per_round), n)
        self.k = buffer_k_from_args(args, self.concurrency)
        self.merge_alpha = merge_alpha_from_args(args)
        (self._weighting_kind, self._poly_a,
         self._hinge_b) = weighting_knobs_from_args(args)
        self._cap_adaptive = int(getattr(args, "async_staleness_cap", 16)
                                 or 0) == 0
        self.staleness_cap = staleness_cap_from_args(args)
        # validate the weighting knobs NOW, not at the first pour
        make_staleness_fn(self._weighting_kind, self._poly_a, self._hinge_b,
                          self.staleness_cap)
        self.buffer = UpdateBuffer(self.k)
        self.durations = durations_from_args(n, args)
        self._n_k = np.asarray(self.fed.train.num_samples, np.float64)

        # a buffer row: update ‖ extras
        self._true_d = self.layout.size
        self._extras = _ExtrasLayout(self.opt.server_extras_zero(self.params))
        self._row_d = self._true_d + self._extras.size
        if self._defended:
            # check_extras_compat (base __init__) refuses extras-carrying
            # optimizers in robust mode, so a defended row is exactly the
            # [D] model delta. The ring covers the staleness cap (the
            # adaptive cap can grow to its 64 ceiling); staleness beyond
            # it re-bases over the retained movement only, loudly once
            self._ring_r = int(np.clip(
                64 if self._cap_adaptive else self.staleness_cap, 1, 64))
            self._ring = torch.zeros((self._ring_r, self._true_d),
                                     dtype=torch.float32, device=device)
            self._ring_fallback_logged = False
            self._defense_hp = sharded_defense.DefenseHP.from_defender(
                self.defender)

        # virtual clock + event heap: (t, seq, kind, cid, version, weight,
        # duration, row, trace ctx) — row is the client's [row_d] update on
        # the device for arrivals, None for redemptions; seq is unique, so
        # the heap never compares the trailing fields
        self.version = 0
        self.virtual_t = 0.0
        self.updates_aggregated = 0
        self._dispatch_seq = 0
        self._evseq = 0
        self._events: List[Any] = []
        self._pour_interval_ema: Optional[float] = None
        self._last_pour_t = 0.0
        # per-client observed arrival latency EMA (simulated seconds): the
        # arrival-rate signal behind the adaptive staleness cap, with
        # running sums so the per-arrival rate gauge costs O(1)
        self._lat_ema = np.zeros(n, np.float64)
        self._lat_seen = np.zeros(n, np.float64)
        self._lat_ema_sum = 0.0
        self._lat_seen_n = 0
        self._last_arrival_t = np.full(n, -1.0, np.float64)
        # idle rotation: a seeded permutation, the (seed, tag) stream
        order = np.random.default_rng(
            (int(getattr(args, "random_seed", 0) or 0),
             _ROTATION_TAG)).permutation(n)
        self._idle = deque(int(c) for c in order)
        self._bootstrapped = False
        self._zero_row = torch.zeros(self._row_d, dtype=torch.float32,
                                     device=device)
        self.async_stats = {"local_steps": 0, "dispatched": 0, "dropped": 0,
                            "stragglers": 0}

    # ------------------------------------------------------------------
    def _staleness_fn(self):
        if self._cap_adaptive:
            seen = self._lat_seen > 0
            self.staleness_cap = adaptive_staleness_cap(
                self._lat_ema[seen], self._pour_interval_ema or 0.0)
        return make_staleness_fn(self._weighting_kind, self._poly_a,
                                 self._hinge_b, self.staleness_cap)

    def _inflight(self) -> int:
        return len(self._events)

    def _rank_idle(self) -> None:
        """Async-aware dispatch (``oort`` / ``power_of_choice``): there is
        no per-round cohort to strategize over, so the strategy decides
        WHO the freed capacity goes to next by reordering the idle
        rotation: statistical utility × arrival-rate posterior (clients
        with no observed arrival score the observed mean rate). ``uniform``
        never calls this; ``reputation`` benches by exclusion instead
        (:meth:`_benched_now`)."""
        idle = list(self._idle)
        if len(idle) <= 1:
            return
        self.selection.flush()
        st = self.selection.store
        if self.selection.strategy_name == "power_of_choice":
            util = st.last_loss()  # +inf for unobserved: explore first
        else:  # oort
            util = self.selection.strategy._utility(self.version)
        rate = st.arrival_rate()
        # rate == 0 iff never observed
        seen = rate > 0
        fill = (float(np.mean(rate[seen])) if bool(np.any(seen)) else 1.0)
        rate = np.where(seen, rate, max(fill, 1e-9))
        score = np.asarray([float(util[c]) * float(rate[c])
                            if np.isfinite(util[c]) else np.inf
                            for c in idle])
        order = np.argsort(-score, kind="stable")
        self._idle = deque(idle[i] for i in order)

    def _benched_now(self) -> set:
        """The ``reputation`` strategy's benched set: clients whose
        defense-verdict reputation fell below the threshold sit idle
        (burning no compute, poisoning no pour). The shared ``cap_bench``
        floor keeps at least ``max(K, min_keep_frac × population)``
        clients dispatchable."""
        if self.selection.strategy_name != "reputation":
            return set()
        from ...core.selection.strategies import cap_bench, rep_bench_knobs
        self.selection.flush()
        rep = self.selection.store.reputation
        thresh, keep_frac = rep_bench_knobs(self.args)
        n = self.fed.num_clients
        flagged = [c for c in range(n) if rep[c] < thresh]
        return set(cap_bench(n, flagged, badness=lambda c: -rep[c],
                             keep_frac=keep_frac, quorum=self.k))

    def _draw_cohort(self, target: int) -> List[int]:
        """Pop up to ``target`` idle clients; reputation-benched clients
        are skipped (they stay idle, at the head of the rotation), and
        non-uniform strategies rank the pool first. (The JAX engine also
        defers a client whose device filled its slot width; with every
        client on one card no draw is ever deferred for that.)"""
        benched = self._benched_now()
        if self.selection.strategy_name not in ("uniform", "reputation"):
            self._rank_idle()
        cohort: List[int] = []
        deferred: List[int] = []
        while self._idle and len(cohort) < target:
            cid = self._idle.popleft()
            if cid in benched:
                deferred.append(cid)
                continue
            cohort.append(cid)
        self._idle.extendleft(reversed(deferred))
        return cohort

    def _dispatch_plan(self, cohort: List[int]):
        """Chaos verdicts for one dispatch: per client ``(cid, work_scale,
        duration)``. Work is 0 only for a dropped client (a straggler does
        FULL work slowly in async; the fault is its arrival time)."""
        self._dispatch_seq += 1
        inj = self.chaos.injects_availability
        plan = []
        for cid in cohort:
            ws = self.chaos.work_scale(self._dispatch_seq, cid) if inj \
                else 1.0
            plan.append((cid, ws, faulted_duration(self.durations[cid], ws)))
        return plan

    def _defended_pour_data(self, entries):
        """Host-side data of one defended pour: per-update drift masks over
        the base-delta ring, the [K] partial-pour row mask, the pour's
        client ids (padded with ids DISJOINT from the poured clients, so
        the stateful defenses' masked scatters are exact no-ops), and the
        byzantine mask of the model attack."""
        k, r, v = self.k, self._ring_r, self.version
        dmask = np.zeros((k, r), np.float32)
        row_mask = np.zeros((k,), np.float32)
        for i, e in enumerate(entries):
            row_mask[i] = 1.0
            u = int(e.version)
            if u < v - r and not self._ring_fallback_logged:
                self._ring_fallback_logged = True
                logger.warning(
                    "defended pour: staleness %d exceeds the base-delta "
                    "ring (%d slots) — re-basing over the retained server "
                    "movement only; the update's staleness weight is "
                    "saturated anyway", v - u, r)
            for j in range(max(u, v - r), v):
                dmask[i, j % r] = 1.0
        poured = {int(e.client_id) for e in entries}
        ids = [int(e.client_id) for e in entries]
        ids += [c for c in range(self.fed.num_clients)
                if c not in poured][:k - len(ids)]
        ids = np.asarray(ids, np.int64)
        if self.attacker.is_model_attack():
            byz = np.asarray(self.attacker.byzantine_mask(ids),
                             np.float32) * row_mask
        else:
            byz = np.zeros(k, np.float32)
        return dmask, row_mask, ids, byz

    def _defended_aggregate(self, buf_mat: torch.Tensor, buf_nw: torch.Tensor,
                            entries, round_key: np.ndarray):
        """Re-base the buffer onto the current version, inject the model
        attack and run the defense: ``(aggregate [D], [K] verdict)``. The
        defense's cross-round state is updated in place."""
        dmask, row_mask, ids, byz = self._defended_pour_data(entries)
        drift = f32_matmul(self._to_device(dmask), self._ring)
        mat = buf_mat - drift
        if self.attacker.is_model_attack():
            mat = sharded_defense.apply_attack(
                self.attacker.attack_type, mat, self._to_device(byz),
                prng.fold_in(round_key, ATTACK_FOLD),
                float(self.attacker.attack_scale))
        defense = (self.defender.defense_type
                   if self.defender.is_defense_enabled() else "mean")
        vec, _, verdict = sharded_defense.defend_shard_stateful(
            mat, buf_nw, defense, self._defense_hp,
            state=self._defense_state, ids=self._to_device(ids),
            key=prng.fold_in(round_key, DEFENSE_FOLD),
            row_mask=self._to_device(row_mask))
        return vec, verdict

    def _push_events(self, plan, rows: torch.Tensor, ctx=None) -> None:
        """Turn a dispatch plan into future events: an arrival carries the
        client's update row (computed at dispatch, delivered at arrival), a
        drop becomes a redemption event. ``ctx`` is the dispatching pour
        span's trace context: it rides the event to the buffer entry, so
        the pour that consumes the update links back to its dispatch."""
        t0 = self.virtual_t
        dropped = []
        for k, (cid, ws, dur) in enumerate(plan):
            if ws <= 0.0:
                kind, vec = _REDEEM, None
                dropped.append(cid)
            else:
                kind, vec = _ARRIVE, rows[k].clone()
            heapq.heappush(self._events,
                           (t0 + dur, self._evseq, kind, cid, self.version,
                            float(self._n_k[cid]), dur, vec, ctx))
            self._evseq += 1
        if dropped:
            obs_sink.log_chaos(round_idx=self._dispatch_seq,
                               injected={"dropped": dropped})

    def _absorb_until(self, n: int) -> bool:
        """Advance the virtual clock until ``n`` updates are buffered.
        False when the event heap drains first (everything idle)."""
        while len(self.buffer) < n:
            if not self._events:
                return False
            (t, _, kind, cid, ver, w, dur, vec,
             ctx) = heapq.heappop(self._events)
            self.virtual_t = max(self.virtual_t, t)
            if kind == _ARRIVE:
                self.buffer.add(cid, vec, weight=w, version=ver,
                                arrival_t=t, trace=ctx)
                # observed arrival latency = the FAULTED duration (a
                # straggler's slowness is the signal, not its base speed)
                self._note_arrival(cid, dur)
                if self._last_arrival_t[cid] >= 0:
                    self.selection.note_arrival(
                        cid, t - self._last_arrival_t[cid])
                self._last_arrival_t[cid] = t
            self._idle.append(cid)
        return True

    def _note_arrival(self, cid: int, latency_s: float) -> None:
        a = 0.2
        old = float(self._lat_ema[cid])
        if self._lat_seen[cid] > 0:
            self._lat_ema[cid] = (1 - a) * old + a * float(latency_s)
            self._lat_ema_sum += float(self._lat_ema[cid]) - old
        else:
            self._lat_ema[cid] = float(latency_s)
            self._lat_seen[cid] = 1.0
            self._lat_ema_sum += float(latency_s)
            self._lat_seen_n += 1
        self.selection.note_latency(int(cid), float(latency_s))
        mean_lat = (self._lat_ema_sum / self._lat_seen_n
                    if self._lat_seen_n else 0.0)
        obs_metrics.record_arrival(
            float(latency_s),
            rate_mean=(1.0 / mean_lat) if mean_lat > 0 else None)

    # ------------------------------------------------------------------
    def _pour_step(self, hyper: TrainHyper) -> Dict[str, Any]:
        """One pour: absorb arrivals to K, train the freed clients on the
        pre-pour params, pour the buffer. The pour is its own trace,
        linking each consumed update back to the pour span of the
        dispatch that produced it, staleness per link."""
        with obs_trace.tracer.span(
                "pour", root=True,
                attrs={"role": "engine", "version": self.version}) as psp:
            with obs_trace.span("wait.arrivals",
                                attrs={"version": self.version}):
                self._absorb_until(self.k)
                entries = self.buffer.pour(self.version)
            psp.set_attr("poured", len(entries))
            for e in entries:
                if e.trace is not None:
                    psp.add_link(e.trace, client=int(e.client_id),
                                 staleness=int(e.staleness(self.version)),
                                 dispatch_version=int(e.version))
            return self._pour_step_traced(hyper, entries, psp)

    def _pour_step_traced(self, hyper: TrainHyper, entries,
                          psp) -> Dict[str, Any]:
        with obs_trace.span("host.input", attrs={"version": self.version}):
            fn = self._staleness_fn()
            stal = np.asarray([e.staleness(self.version) for e in entries],
                              np.float64)
            pad = self.k - len(entries)
            if entries:
                # the ONE staleness implementation: relative mix + absolute
                # merge scale from core/async_rounds.pour_weights (padded
                # rows carry weight 0)
                norm_w, merge_scale = pour_weights(
                    [e.weight for e in entries], stal, fn, self.merge_alpha)
                buf_nw = np.concatenate([norm_w, np.zeros(pad, np.float32)])
            target = max(0, self.concurrency - self._inflight()
                         - len(self.buffer))
            cohort = self._draw_cohort(target)
            plan = self._dispatch_plan(cohort)
            round_key = prng.fold_in(self.rng, self._dispatch_seq)
        rows = torch.empty((len(cohort), self._row_d), dtype=torch.float32,
                           device=self.device)
        works = [1.0 if ws > 0.0 else 0.0 for _, ws, _ in plan]

        def dispatch_and_pour():
            # training first, on the pre-pour params (the rows stay on the
            # device), then the pour
            out = self._train_cohort(
                cohort, works, round_key, hyper, rows=rows,
                extras_into=(self._extras.flatten_into
                             if self._extras.size else None))
            verdict = None
            if entries:
                buf_mat = torch.stack([e.update for e in entries]
                                      + [self._zero_row] * pad)
                verdict = self._pour(entries, buf_mat,
                                     self._to_device(buf_nw), merge_scale,
                                     round_key)
            return out, verdict

        (metrics, steps, slots), verdict = self._traced(
            "async_pour_defended" if self._defended else "async_pour", 1,
            dispatch_and_pour)
        with obs_trace.span("host.close", attrs={"version": self.version}):
            self._push_events(plan, rows, ctx=psp.context)
            self.async_stats["local_steps"] += steps
            self.async_stats["dispatched"] += len(cohort)
            self.async_stats["dropped"] += sum(ws <= 0.0 for _, ws, _ in plan)
            self.async_stats["stragglers"] += sum(0.0 < ws < 1.0
                                                  for _, ws, _ in plan)
            if self.selection.track:
                if verdict is not None:
                    # the verdict is about the POURED clients: reputation
                    # evidence, so the rotation stops re-dispatching
                    # benched byzantine clients
                    self.selection.note_results(
                        self.version, [e.client_id for e in entries], [],
                        verdict=verdict[:len(entries)])
                self.selection.note_results(
                    self.version, cohort,
                    slot_placement(cohort, 1, self.fed.num_clients),
                    slot_metrics=self._slot_metrics(slots))
            poured = len(entries)
            self.updates_aggregated += poured
            if poured:
                if verdict is not None:
                    self.verdicts[self.version] = (
                        [e.client_id for e in entries], verdict[:poured])
                # pour-interval EMA: the clock the adaptive staleness cap
                # converts arrival latencies into version lag with
                dt = self.virtual_t - self._last_pour_t
                self._last_pour_t = self.virtual_t
                self._pour_interval_ema = (dt
                                           if self._pour_interval_ema is None
                                           else 0.8 * self._pour_interval_ema
                                           + 0.2 * dt)
                self.chaos_ledger.record_pour(
                    self.version,
                    arrivals=[{"client": e.client_id,
                               "staleness": e.staleness(self.version),
                               "arrival_t": e.arrival_t,
                               "dispatch_version": e.version}
                              for e in entries],
                    observed={"poured": poured,
                              "buffered": len(self.buffer),
                              "staleness_cap": self.staleness_cap,
                              "virtual_t": self.virtual_t})
                self.version += 1
        return {"metrics": metrics, "poured": poured, "local_steps": steps,
                "staleness_mean": float(np.mean(stal)) if poured else 0.0,
                "staleness_max": int(np.max(stal)) if poured else 0}

    def _pour(self, entries, buf_mat: torch.Tensor, buf_nw: torch.Tensor,
              merge_scale: float, round_key: np.ndarray):
        """Apply one non-empty pour: the staleness-weighted aggregate (or,
        defended, the defense's over the re-based rows) through
        ``server_update_async`` with the poured fraction of the
        population; a defended pour writes its movement into the ring's
        slot ``version mod R``. Returns the defense's verdict or None."""
        verdict = None
        true_d = self._true_d
        if self._defended:
            vec, verdict = self._defended_aggregate(buf_mat, buf_nw, entries,
                                                    round_key)
            agg_extras = {}
        else:
            vec = wsum(buf_nw, buf_mat)
            agg_extras = (self._extras.unflatten(
                vec[true_d:], self.opt.server_extras_zero(self.params))
                if self._extras.size else {})
        agg = self.layout.unflatten(vec[:true_d], like=self.params)
        n_total = np.float32(max(self.fed.num_clients, 1))
        old = self.params
        self.params, self.server_state = self.opt.server_update_async(
            self.params, self.server_state, agg, agg_extras, self.version,
            np.float32(merge_scale), np.float32(len(entries)) / n_total)
        if self._defended:
            torch.sub(self.layout.flatten(self.params),
                      self.layout.flatten(old),
                      out=self._ring[self.version % self._ring_r])
        return verdict

    def _bootstrap(self, hyper: TrainHyper) -> None:
        """Dispatch the initial in-flight cohort (empty buffer: a no-op
        pour, the params and the server state untouched)."""
        if self._bootstrapped:
            return
        self._bootstrapped = True
        self._pour_step(hyper)

    # ------------------------------------------------------------------
    # sync-engine entry points that make no sense without a barrier
    def run_round(self, round_idx, hyper):
        raise NotImplementedError(
            "async_buffered has no per-round barrier; use run()")

    def run_rounds_fused(self, start_round, n_rounds, hyper):
        raise NotImplementedError(
            "async_buffered has no per-round barrier; use run()")

    def run(self, comm_round: Optional[int] = None) -> Dict[str, Any]:
        args = self.args
        pours = comm_round if comm_round is not None \
            else int(args.comm_round)
        hyper = TrainHyper(learning_rate=float(args.learning_rate),
                           epochs=int(args.epochs))
        t0 = time.time()
        restored = self._ckpt_latest() if self.ckpt.enabled else None
        if restored is not None:
            step, st = restored
            self._load_ckpt_state(st)
            logger.info("resumed async state from checkpoint at pour %d "
                        "(version %d)", step, self.version)
        freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        n_test_batches = int(self.test["x"].shape[0])
        self._ensure_flops_model(hyper)
        self._bootstrap(hyper)
        stalls = 0
        while self.version < pours:
            rec_in = self._pour_step(hyper)
            if rec_in["poured"] == 0:
                # nothing buffered AND nothing in flight produced an
                # arrival — one redispatch retry, then refuse to spin
                stalls += 1
                if stalls > 2:
                    raise RuntimeError(
                        "async pour stalled: no updates in flight "
                        f"(concurrency={self.concurrency}, k={self.k})")
                continue
            stalls = 0
            v = self.version - 1  # the pour that just completed
            m = torch.stack([rec_in["metrics"][k] for k in METRICS]).cpu()
            metrics = dict(zip(METRICS, m.tolist()))
            rec: Dict[str, Any] = {"round": v,
                                   "virtual_t": self.virtual_t,
                                   "poured": rec_in["poured"],
                                   "staleness_mean": rec_in["staleness_mean"],
                                   "staleness_max": rec_in["staleness_max"],
                                   "local_steps": rec_in["local_steps"]}
            cnt = max(metrics["count"], 1.0)
            rec["train_loss"] = metrics["loss_sum"] / cnt
            rec["train_acc"] = metrics["correct"] / cnt
            if freq > 0 and (v % freq == 0 or v == pours - 1):
                with obs_trace.span("eval", root=True,
                                    attrs={"role": "engine",
                                           "round_idx": v}):
                    rec.update(self.evaluate())
                rec["eval_batches"] = n_test_batches
                logger.info("pour %d (staleness mean %.2f): test_acc=%.4f",
                            v, rec["staleness_mean"], rec["test_acc"])
            self.history.append(rec)
            if self.ckpt.enabled:
                self.ckpt.maybe_save(v, self.ckpt_state())
            obs_sink.log_round_info(pours, v)
            if self.chaos.crash_due(v):
                self.ckpt.flush()
                raise ChaosCrash(v)
        self.ckpt.flush()
        obs_metrics.flush_final(step=self.version - 1)
        wall = time.time() - t0
        last_eval = next((r for r in reversed(self.history)
                          if "test_acc" in r), None)
        if last_eval is None:
            last_eval = ({"test_acc": None} if freq <= 0
                         else self.evaluate())
        return {"params": self.params, "history": self.history,
                "wall_time_s": wall,
                "final_test_acc": last_eval["test_acc"],
                "final_test_loss": last_eval.get("test_loss"),
                "rounds": self.version,
                "virtual_time_s": self.virtual_t,
                "updates_aggregated": self.updates_aggregated,
                "async_stats": dict(self.async_stats),
                "dispatch_stats": dict(self.dispatch_stats)}

    # ------------------------------------------------------------------
    # checkpointing: the async control state rides RoundCheckpointer next
    # to params / server_state / client_states, at fixed shapes (buffer
    # padded to its hard bound, events to the concurrency)
    _OPTIONAL_CKPT_KEYS = GPUSimulator._OPTIONAL_CKPT_KEYS + (
        "async_rounds",)

    def ckpt_state(self) -> Dict[str, Any]:
        st = super().ckpt_state()
        st["async_rounds"] = self._async_state_dict()
        return st

    def _load_ckpt_state(self, st: Dict[str, Any]) -> None:
        super()._load_ckpt_state(st)
        if "async_rounds" in st:
            self._async_load_state(st["async_rounds"])
        else:
            logger.warning(
                "checkpoint has no async_rounds leaf — async control "
                "state (buffer, in-flight cohort, virtual clock) resumes "
                "cold from the restored model")

    def _async_state_dict(self) -> Dict[str, Any]:
        n = self.fed.num_clients
        ev = sorted(self._events, key=lambda e: e[:2])
        e_rows = self.concurrency
        if len(ev) > e_rows:  # cannot happen by construction; be loud
            raise RuntimeError(f"{len(ev)} in-flight events > concurrency")
        ev_meta = np.zeros((e_rows, 7), np.float64)  # t,seq,kind,cid,ver,w,dur
        ev_vecs = np.zeros((e_rows, self._row_d), np.float32)
        ev_mask = np.zeros((e_rows,), np.float32)
        # the trailing trace context (observability only) is not
        # persisted: a resumed run replays identical pours, just without
        # links to spans from before the crash
        for i, (t, seq, kind, cid, ver, w, dur, vec, _ctx) in enumerate(ev):
            ev_meta[i] = (t, seq, kind, cid, ver, w, dur)
            if vec is not None:
                ev_vecs[i] = vec.detach().cpu().numpy()
            ev_mask[i] = 1.0
        idle = np.full((n,), -1, np.int64)
        for i, cid in enumerate(self._idle):
            idle[i] = cid
        out = {
            "scalars": np.asarray(
                [self.version, self.virtual_t, self._dispatch_seq,
                 self._evseq,
                 -1.0 if self._pour_interval_ema is None
                 else self._pour_interval_ema,
                 self._last_pour_t, self.updates_aggregated,
                 1.0 if self._bootstrapped else 0.0,
                 self.staleness_cap], np.float64),
            "buffer": self.buffer.state_dict(
                encode=lambda v: v.detach().cpu().numpy(),
                pad_rows=2 * self.k, vec_dim=self._row_d),
            "ev_meta": ev_meta, "ev_vecs": ev_vecs, "ev_mask": ev_mask,
            "idle": idle,
            "lat_ema": self._lat_ema.copy(),
            "lat_seen": self._lat_seen.copy(),
            "last_arrival_t": self._last_arrival_t.copy(),
        }
        if self._defended:
            # the ring must survive a crash, or a resumed run would re-base
            # the restored buffer's stale rows against a zeroed movement
            # history and leave the uninterrupted trajectory
            out["ring"] = self._ring
        return out

    def _async_load_state(self, st: Dict[str, Any]) -> None:
        dev = self.device
        sc = np.asarray(st["scalars"], np.float64)
        (self.version, self.virtual_t, self._dispatch_seq, self._evseq,
         pie, self._last_pour_t, self.updates_aggregated) = (
            int(sc[0]), float(sc[1]), int(sc[2]), int(sc[3]), float(sc[4]),
            float(sc[5]), int(sc[6]))
        self._bootstrapped = sc[7] > 0.0
        self.staleness_cap = int(sc[8])
        self._pour_interval_ema = None if pie < 0 else pie
        self.buffer.load_state_dict(
            dict(st["buffer"]),
            decode=lambda a: torch.from_numpy(np.array(a)).to(dev))
        self._events = []
        mask = np.asarray(st["ev_mask"], np.float32)
        meta = np.asarray(st["ev_meta"], np.float64)
        vecs = np.asarray(st["ev_vecs"], np.float32)
        for i in range(mask.shape[0]):
            if mask[i] <= 0.0:
                continue
            t, seq, kind, cid, ver, w, dur = meta[i]
            vec = (torch.from_numpy(np.array(vecs[i])).to(dev)
                   if int(kind) == _ARRIVE else None)
            heapq.heappush(self._events, (float(t), int(seq), int(kind),
                                          int(cid), int(ver), float(w),
                                          float(dur), vec, None))
        self._idle = deque(int(c) for c in np.asarray(st["idle"], np.int64)
                           if c >= 0)
        self._lat_ema = np.asarray(st["lat_ema"], np.float64).copy()
        self._lat_seen = np.asarray(st["lat_seen"], np.float64).copy()
        # rebuild the O(1) running aggregates from the restored arrays
        seen = self._lat_seen > 0
        self._lat_ema_sum = float(np.sum(self._lat_ema[seen]))
        self._lat_seen_n = int(np.sum(seen))
        self._last_arrival_t = np.asarray(st["last_arrival_t"],
                                          np.float64).copy()
        if self._defended and "ring" in st:
            self._ring = st["ring"]
