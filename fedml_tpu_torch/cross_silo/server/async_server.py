"""Cross-silo buffered-async server — no round barrier, ever (counterpart
of ``fedml_tpu/cross_silo/server/async_server.py``).

``round_mode: async_buffered`` replaces the all-received barrier of the
sync FSM (:mod:`.fedml_server_manager`) with a FedBuff pour loop: the
server aggregates whenever K staleness-weighted uploads are buffered, and
``comm_round`` counts POURS (global model versions). The sync FSM's
round timers, quorum, grace intervals and stale-upload drops are replaced
by:

* **Stale uploads are down-weighted, never dropped.** Every sync/upload
  carries the model version it was trained from; staleness at pour time
  is ``server_version - upload_version``, weighted by the shared
  ``core/async_rounds`` decay. A per-version base ring (bounded by the
  staleness cap) forms each silo's DELTA against the exact base it
  trained from, dense and compressed uplinks alike.
* **Crashed silos simply stop contributing.** The pour-timeout valve
  (``async_pour_timeout_s``) pours a partial buffer (>= 1 update); an
  empty fire re-broadcasts the current model (the nudge that recovers
  link-lost syncs); a silo that re-announces ONLINE mid-session is handed
  the current model (redemption).
* **Arrival-rate posteriors feed the staleness cap.** Per-silo upload
  latencies (sync to receipt, clocked per silo) land in the stats store;
  with ``async_staleness_cap: 0`` the cap tracks observed latency / pour
  interval.
* **Defended pours.** At pour time every buffered delta is re-based onto
  the current version (the base ring gives the server movement it
  missed), the staleness decay folds into the row weights, and
  ``defend_matrix`` aggregates the rows on the aggregator's device with
  the key ``fold_in(PRNGKey(seed + 71), version)``. Verdicts feed the
  silos' reputation; an excluded compressed row is carried per sender
  (the server-side error-feedback loop) and folded into its next row.
  ``weak_dp`` / ``crfl`` and DP stay refused.

The base ring and the buffer are host float32 numpy vectors in the JAX
package's flat layout (:func:`..wire.params_to_vec`), so an undefended
pour's arithmetic is the JAX package's bit for bit; the defense and the
global parameters live on the aggregator's device (the card unless the
caller asks for the CPU). Per-update arrival records go to
``FaultLedger.record_pour`` (mirrored to the records by
``mlops.log_chaos``). ``round_times`` holds one record per pour: its
wait, aggregate, eval and broadcast (re-sync) seconds and ``start_s`` /
``end_s`` (``perf_counter`` at the end of the previous pour, or of the
init broadcast's start, and after this pour's re-sync).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import prng
from ...core import mlops
from ...core.async_rounds import (UpdateBuffer, adaptive_staleness_cap,
                                  buffer_k_from_args, make_staleness_fn,
                                  merge_alpha_from_args, pour_weights,
                                  staleness_cap_from_args,
                                  staleness_fn_from_args,
                                  weighting_knobs_from_args)
from ...core.distributed.communication.message import Message
from ...core.obs import trace as obs_trace
from ...core.security.defense import verdict_from_info
from ...core.wire import wire_checkpointer, wire_state_template
from ...device import get_device
from ...utils.compression import decompress_vec, is_compressed_payload
from ..message_define import MyMessage
from ..wire import params_to_vec, params_to_wire, vec_to_params, \
    wire_to_params
from .fedml_aggregator import FedMLAggregator
from .fedml_server_manager import FedMLServerManager

logger = logging.getLogger(__name__)


def _tensors(tree, device=None) -> Dict[str, torch.Tensor]:
    """A flat parameter dict of tensors or arrays as tensors (on
    ``device`` when given)."""
    out = {}
    for k, v in tree.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(
            np.array(v, copy=True))
        out[k] = t if device is None else t.to(device)
    return out


class AsyncFedMLAggregator(FedMLAggregator):
    """Buffered-async aggregation state: an :class:`UpdateBuffer` of silo
    deltas plus the per-version base ring they are formed against.
    ``device``: where the global parameters and the defense live (CUDA
    unless ``"cpu"``; no CUDA and no ``"cpu"`` raises)."""

    def __init__(self, args, global_params, eval_fn=None, device=None):
        self.device = get_device(device)
        super().__init__(args, _tensors(global_params, self.device),
                         eval_fn=eval_fn)
        if self.dp.is_dp_enabled():
            raise ValueError(
                "round_mode: async_buffered does not yet compose with DP "
                "on the cross-silo server (per-pour accounting under "
                "stale mixed cohorts is an open design); use "
                "round_mode: sync")
        if (self.defender.is_defense_enabled()
                and self.defender.defense_type in ("weak_dp", "crfl")):
            raise ValueError(
                "round_mode: async_buffered refuses defense_type "
                f"{self.defender.defense_type!r}: noise-adding defenses "
                "are DP by another name, and per-pour noise accounting "
                "over a mixed-staleness buffer is the same open design "
                "that keeps async+DP refused; use round_mode: sync")
        # defended pours draw their defense keys from a dedicated seeded
        # stream (one fold per pour — deterministic for a given trace)
        self._defense_key = prng.PRNGKey(
            int(getattr(args, "random_seed", 0) or 0) + 71)
        self.version = 0
        self.k = buffer_k_from_args(args, self.client_num)
        self.merge_alpha = merge_alpha_from_args(args)
        self.staleness_fn = staleness_fn_from_args(args)
        self.staleness_cap = staleness_cap_from_args(args)
        self._cap_adaptive = int(getattr(args, "async_staleness_cap", 16)
                                 or 0) == 0
        self._weighting_args = args
        self.buffer = UpdateBuffer(self.k)
        self._pour_interval_ema: Optional[float] = None
        self._last_pour_t: Optional[float] = None
        # version -> host f32 model vector. Ring-bounded by the staleness
        # cap: uploads older than the ring fall back to the OLDEST
        # retained base — the residual base drift is folded into an update
        # whose staleness weight is already saturated-tiny
        self._base_ring: Dict[int, np.ndarray] = {
            0: params_to_vec(self.global_params)}
        # defended pours over COMPRESSED uplinks: a compressed upload is a
        # delta the silo's error-feedback already committed — a defense
        # exclusion silently loses that movement and the silo never
        # re-sends it. An excluded re-based row is carried per sender
        # (stamped with the version it was re-based to), re-based again
        # onto the pour's version, and folded into the sender's NEXT row
        # before the defense re-judges it; a kept verdict clears it.
        # Dense uploads stay uncarried — their next upload is absolute.
        self._ef_carry: Dict[int, tuple] = {}
        self._compressed_senders: set = set()

    # --- uploads ------------------------------------------------------------
    def base_for(self, version: int) -> np.ndarray:
        ring = self._base_ring
        if int(version) in ring:
            return ring[int(version)]
        oldest = min(ring)
        logger.warning(
            "async upload from version %s predates the base ring "
            "(oldest retained: %d) — using the oldest base; the update's "
            "staleness weight is saturated anyway", version, oldest)
        return ring[oldest]

    def add_async_upload(self, rank: int, payload, sample_num: float,
                         up_version: int, arrival_t: float,
                         compressed: bool, trace=None) -> int:
        """Buffer one silo upload as a delta vs its dispatch base.
        ``payload``: the decompressed delta (``compressed``), else the
        uploaded model as a host f32 vector in the flat layout or a flat
        parameter dict. Returns the buffered count. ``trace`` is the
        upload span's context — the pour span links it."""
        if compressed:
            # a compressed upload IS the delta vs the broadcast the silo
            # holds — exactly its dispatch base; no reconstruction needed
            delta = np.asarray(payload, np.float32)
            self._compressed_senders.add(int(rank))
        else:
            vec = (np.asarray(payload, np.float32)
                   if isinstance(payload, np.ndarray)
                   else params_to_vec(_tensors(payload)))
            delta = vec - self.base_for(up_version)
        self.buffer.add(int(rank), delta, weight=float(sample_num),
                        version=int(up_version), arrival_t=float(arrival_t),
                        trace=trace)
        return len(self.buffer)

    # --- the pour -----------------------------------------------------------
    def pour(self, max_n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Aggregate up to K buffered deltas: staleness-weighted average,
        damped by the merge scale, applied to the current global. Returns
        the per-update arrival records (empty list = nothing to pour)."""
        entries = self.buffer.pour(self.version, max_n=max_n)
        if not entries:
            return []
        if self._cap_adaptive:
            # arrival-rate posteriors -> staleness cap: observed silo
            # latency over the pour interval is how many versions a
            # routine upload lags
            self.staleness_cap = adaptive_staleness_cap(
                self.silo_stats.ema_latency[self.silo_stats.has_latency > 0],
                self._pour_interval_ema or 0.0)
            kind, poly_a, hinge_b = weighting_knobs_from_args(
                self._weighting_args)
            self.staleness_fn = make_staleness_fn(kind, poly_a, hinge_b,
                                                  self.staleness_cap)
        stal = np.asarray([e.staleness(self.version) for e in entries],
                          np.float64)
        w = np.asarray([e.weight for e in entries], np.float64)
        norm_w, merge_scale = pour_weights(w, stal, self.staleness_fn,
                                           self.merge_alpha)
        base = self._base_ring[self.version]
        if self.defender.is_defense_enabled():
            # DEFENDED pour: re-base every row onto the CURRENT version by
            # subtracting the server movement it missed, fold the
            # staleness decay into the row weights (norm_w), and let the
            # defense aggregate on the device. At staleness 0 the
            # correction is zero: the sync defended round's math.
            rows = []
            for e in entries:
                row = (np.asarray(e.update, np.float32)
                       - (base - self.base_for(e.version)))
                carry = self._ef_carry.pop(int(e.client_id), None)
                if carry is not None:
                    # the stored row satisfied base_{v_s} + row = target;
                    # re-expressing it against the CURRENT base subtracts
                    # the server movement since v_s
                    cv, cres = carry
                    row = row + (cres - (base - self.base_for(cv)))
                rows.append(row)
            ranks = np.asarray([e.client_id for e in entries], np.int32)
            vec, info = self.defender.defend_matrix(
                torch.from_numpy(np.stack(rows)).to(self.device),
                torch.as_tensor(np.asarray(norm_w, np.float32),
                                device=self.device),
                rng=prng.fold_in(self._defense_key, self.version),
                client_ids=ranks)
            agg = vec.detach().float().cpu().numpy()
            verdict = verdict_from_info(info, len(entries))
            if verdict is not None:
                for i, e in enumerate(entries):
                    rid = int(e.client_id)
                    if verdict[i] < 0.5 and rid in self._compressed_senders:
                        self._ef_carry[rid] = (self.version,
                                               np.asarray(rows[i],
                                                          np.float32))
                # defense verdicts are the silo reputation stream —
                # select_silos benches silos the defenses keep excluding
                # (bounds-guarded: an out-of-range rank must not kill the
                # pour thread)
                keep = [i for i, r in enumerate(ranks)
                        if 0 <= int(r) < self.silo_stats.n]
                if keep:
                    self.silo_stats.record_verdict(
                        [int(ranks[i]) for i in keep], verdict[keep])
        else:
            agg = np.zeros(entries[0].update.shape, np.float32)
            for nw, e in zip(norm_w, entries):
                agg = agg + np.asarray(e.update, np.float32) * np.float32(nw)
        new_vec = base + np.float32(merge_scale) * agg
        self.global_params = vec_to_params(new_vec, self.global_params)
        self.version += 1
        self._base_ring[self.version] = np.asarray(new_vec, np.float32)
        for v in [v for v in self._base_ring
                  if v < self.version - self.staleness_cap]:
            del self._base_ring[v]
        now = time.time()
        if self._last_pour_t is not None:
            dt = now - self._last_pour_t
            self._pour_interval_ema = (
                dt if self._pour_interval_ema is None
                else 0.8 * self._pour_interval_ema + 0.2 * dt)
        self._last_pour_t = now
        return [{"client": e.client_id, "staleness": int(s),
                 "arrival_t": e.arrival_t, "dispatch_version": e.version,
                 "weight": e.weight, "norm_weight": float(nw),
                 "merge_scale": float(merge_scale),
                 # the producing upload span's traceparent (None when the
                 # header was stripped): the pour span links it
                 "trace": (e.trace.traceparent()
                           if e.trace is not None else None)}
                for e, s, nw in zip(entries, stal, norm_w)]


class AsyncFedMLServerManager(FedMLServerManager):
    """Rank 0 of an async session. The sync FSM's round machinery is
    inert here — this class overrides the two seams that drove it (the
    upload handler and the post-aggregation sync) with the pour loop."""

    DEFAULT_POUR_TIMEOUT_S = 30.0

    def __init__(self, args, aggregator, comm=None, rank: int = 0,
                 size: int = 0, backend: str = "INPROC"):
        super().__init__(args, aggregator, comm=comm, rank=rank, size=size,
                         backend=backend)
        if not isinstance(aggregator, AsyncFedMLAggregator):
            raise ValueError("AsyncFedMLServerManager needs an "
                             "AsyncFedMLAggregator")
        if self.cc_spec is not None \
                and str(getattr(self.cc_spec, "broadcast", "full")) != "full":
            raise ValueError(
                "round_mode: async_buffered needs a dense broadcast "
                "(comm_compression_broadcast: full): bf16/compressed "
                "downlinks track ONE shared client reconstruction, but "
                "async silos are synced at different versions")
        self._pour_lock = threading.Lock()
        # timer cancel/replace must be atomic: an upload thread re-arming
        # after a pour races the timer thread re-arming after an empty
        # fire
        self._timer_lock = threading.Lock()
        self._pour_timer: Optional[threading.Timer] = None
        self._done = False
        # per-silo sync timestamps: upload latency is clocked against the
        # silo's OWN sync. _outstanding tracks silos with a sync awaiting
        # an upload — a re-sync of such a silo keeps the FIRST timestamp
        self._sync_t: Dict[int, float] = {}
        self._outstanding: Dict[int, int] = {}
        self._empty_fires = 0
        self._last_arrival: Dict[int, float] = {}
        # the host template dense uploads decode into (a CPU copy of the
        # global's names, shapes and dtypes: no device round trip)
        self._host_template = {
            k: torch.empty(v.shape, dtype=v.dtype)
            for k, v in aggregator.global_params.items()}
        self._times_lock = threading.Lock()
        self._cycle_start: Optional[float] = None
        # liveness valve fallback chain: async_pour_timeout_s ->
        # round_timeout_s -> a positive default. It must NOT bottom out at
        # 0 (both knobs default to 0): with K silos crashed the pour
        # trigger can never fire, and without a timer the session hangs
        t = float(getattr(args, "async_pour_timeout_s", 0.0) or 0.0)
        self.pour_timeout_s = (t if t > 0 else self.round_timeout_s
                               if self.round_timeout_s > 0
                               else self.DEFAULT_POUR_TIMEOUT_S)
        # async wire state: the sync manager's slot holds broadcast EF
        # state, which async never has (dense broadcasts only) — replace
        # it with this mode's own namespace carrying the defended-pour
        # per-sender EF residuals
        self._wire_ckpt = wire_checkpointer(args, "async_server")
        if self._wire_ckpt is not None:
            self._restore_wire_state()

    # --- wire-state checkpointing (per-sender pour residuals) ---------------
    def _wire_template(self) -> dict:
        n = int(getattr(self.args, "client_num_in_total",
                        self.client_num)) + 1
        d = int(self.aggregator._base_ring[
            min(self.aggregator._base_ring)].shape[0])
        t = wire_state_template(d, (), matrices={"ef_residual": n})
        t["ef_version"] = np.zeros((n,), np.int32)
        t["compressed"] = np.zeros((n,), np.int32)
        return t

    def _save_wire_state(self, completed_round: int) -> None:
        if self._wire_ckpt is None or not self._wire_ckpt.enabled:
            return
        st = self._wire_template()
        st["round"] = np.asarray(completed_round, np.int32)
        n = st["compressed"].shape[0]
        for rid in self.aggregator._compressed_senders:
            if 0 <= rid < n:
                st["compressed"][rid] = 1
        for rid, (cv, cres) in self.aggregator._ef_carry.items():
            if 0 <= rid < n:
                st["ef_residual_set"][rid] = 1
                st["ef_version"][rid] = cv
                st["ef_residual"][rid] = cres
        self._wire_ckpt.maybe_save(completed_round, st)

    def _restore_wire_state(self) -> None:
        if self._wire_ckpt is None or not self._wire_ckpt.enabled:
            return
        got = self._wire_ckpt.latest(self._wire_template())
        if got is None:
            return
        _, st = got
        agg = self.aggregator
        agg._compressed_senders = {
            int(r) for r in np.flatnonzero(np.asarray(st["compressed"]))}
        agg._ef_carry = {
            int(r): (int(st["ef_version"][r]),
                     np.asarray(st["ef_residual"][r], np.float32))
            for r in np.flatnonzero(np.asarray(st["ef_residual_set"]))}
        logger.info("async server: restored wire EF state for %d senders",
                    len(agg._ef_carry))

    # --- handshake + redemption ---------------------------------------------
    def handle_message_client_status_update(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        already = bool(self.client_online_status.get(sender))
        super().handle_message_client_status_update(msg)
        if self.is_initialized and already and not self._done:
            # a silo re-announcing ONLINE mid-session is a reconnect
            # (crash-recovered process, healed link): hand it the current
            # model so it rejoins the rotation — redemption, not a replay
            logger.info("async server: silo %s reconnected — syncing "
                        "version %d", sender, self.aggregator.version)
            self._sync_ranks([sender])

    def send_init_msg(self) -> None:
        self._cycle_start = time.perf_counter()
        client_indexes = self.aggregator.client_selection(
            0, int(self.args.client_num_in_total), self.client_num)
        wire = params_to_wire(self.aggregator.global_params)
        self._round_targets = sorted(self.client_online_status)
        now = time.time()
        assign = self.aggregator.assign_data_indices(self._round_targets,
                                                     client_indexes)
        with obs_trace.tracer.span(
                "async.sync", root=True,
                attrs={"role": "server", "version": self.aggregator.version,
                       "targets": len(self._round_targets),
                       "init": True}) as ssp:
            for rank in self._round_targets:
                msg = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.rank,
                              rank)
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, wire)
                msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                               assign[rank])
                msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX,
                               self.aggregator.version)
                obs_trace.inject(msg, ssp)
                self._sync_t[rank] = now
                self._outstanding[rank] = self.aggregator.version
                self.send_message(msg)
        self._arm_pour_timer()

    # --- the async upload seam ----------------------------------------------
    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        if self._done:
            return
        sender = msg.get_sender_id()
        if sender not in self._outstanding:
            # replay guard: every sync to a silo expects exactly ONE
            # upload (popped below on first receipt). A second copy —
            # link duplication, a transport retry, a slow silo answering
            # both the original sync and a timeout nudge — would double
            # that silo's weight in the pour
            logger.warning(
                "async server: dropping upload from silo %s with no "
                "outstanding sync (duplicate or replayed copy)", sender)
            return
        recv_t = time.time()
        n = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, 1.0))
        update = msg.get(MyMessage.MSG_ARG_KEY_MODEL_UPDATE)
        up_version = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        up_version = (self.aggregator.version if up_version is None
                      else int(up_version))
        # deserialize + flatten OUTSIDE the pour lock: full-model wire
        # decodes are model-sized work; only the base-ring read + buffer
        # add (cheap) need the lock
        if is_compressed_payload(update):
            payload, compressed = decompress_vec(update), True
        else:
            wire = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
            payload = params_to_vec(wire_to_params(wire,
                                                   self._host_template))
            compressed = False
        with self._pour_lock:
            buffered = self.aggregator.add_async_upload(
                sender, payload, n, up_version, recv_t,
                compressed=compressed, trace=obs_trace.extract(msg))
        # arrival-rate observations: latency vs this silo's OWN sync,
        # inter-arrival gap (the arrival-rate posterior), and
        # participation evidence for the dropout posterior
        t0 = self._sync_t.get(sender)
        if t0 is not None:
            self.aggregator.observe_upload(sender, recv_t - t0)
            from ...core.obs import metrics as obs_metrics
            obs_metrics.record_arrival(recv_t - t0)
        self._outstanding.pop(sender, None)
        prev = self._last_arrival.get(sender)
        if prev is not None and 0 <= int(sender) < \
                self.aggregator.silo_stats.n:
            self.aggregator.silo_stats.record_arrival(sender,
                                                      recv_t - prev)
        self.aggregator.observe_round([sender], [sender])
        self._last_arrival[sender] = recv_t
        if buffered >= self.aggregator.k:
            self._pour(reason="buffer")

    # --- the pour loop ------------------------------------------------------
    def _arm_pour_timer(self) -> None:
        if self.pour_timeout_s <= 0 or self._done:
            return
        with self._timer_lock:
            if self._done:
                return
            if self._pour_timer is not None:
                self._pour_timer.cancel()
            self._pour_timer = threading.Timer(self.pour_timeout_s,
                                               self._on_pour_timeout)
            self._pour_timer.daemon = True
            self._pour_timer.start()

    def _on_pour_timeout(self) -> None:
        if self._done:
            return
        if len(self.aggregator.buffer) >= 1:
            # liveness valve: a decimated fleet (crashes, drops) may never
            # fill K — pour what arrived rather than stalling the session
            self._pour(reason="timeout")
        else:
            # empty fire: silos with NO outstanding sync are idle for lack
            # of a model — re-sync them always; silos with a sync
            # outstanding are slow or lost it to the link — nudge those
            # only every SECOND empty fire
            self._empty_fires += 1
            online = sorted(self.client_online_status)
            idle = [r for r in online if r not in self._outstanding]
            nudge = idle if self._empty_fires % 2 else online
            logger.warning(
                "async server: pour timeout with empty buffer at version "
                "%d — re-syncing %s (of %d online, %d outstanding)",
                self.aggregator.version, nudge, len(online),
                len(self._outstanding))
            self._sync_ranks(nudge)
            self._arm_pour_timer()

    def _pour(self, reason: str) -> None:
        t_pour = time.perf_counter()
        # the pour is its own trace: it consumes uploads from MANY sync
        # traces, so LINKS to the K contributing upload spans express the
        # fan-in, staleness attached per link
        psp = obs_trace.tracer.start_span(
            "pour", root=True,
            attrs={"role": "server", "reason": reason,
                   "version": self.aggregator.version})
        with psp:
            with self._pour_lock:
                if self._done:
                    return
                with obs_trace.span("aggregate",
                                    attrs={"reason": reason}):
                    arrivals = self.aggregator.pour()
                if not arrivals:
                    psp.set_attr("empty", True)
                    self._arm_pour_timer()
                    return
                version = self.aggregator.version  # post-pour version
                self.chaos_ledger.record_pour(
                    version - 1, arrivals,
                    observed={"poured": len(arrivals),
                              "buffered": len(self.aggregator.buffer),
                              "reason": reason,
                              "staleness_cap":
                                  self.aggregator.staleness_cap})
                contributors = sorted({int(a["client"]) for a in arrivals})
                self._save_wire_state(version - 1)
            t_agg = time.perf_counter()
            psp.set_attr("poured", len(arrivals))
            for a in arrivals:
                if a.get("trace"):
                    psp.add_link(a["trace"], client=int(a["client"]),
                                 staleness=int(a["staleness"]),
                                 dispatch_version=int(
                                     a["dispatch_version"]))
            freq = int(getattr(self.args, "frequency_of_the_test", 5)
                       or 5)
            rec: Dict[str, Any] = {
                "round": version - 1, "poured": len(arrivals),
                "staleness_mean": float(np.mean([a["staleness"]
                                                 for a in arrivals])),
                "staleness_max": int(max(a["staleness"]
                                         for a in arrivals)),
            }
            if freq > 0 and ((version - 1) % freq == 0
                             or version >= self.round_num):
                with obs_trace.span("eval",
                                    attrs={"version": version - 1}):
                    stats = self.aggregator.test_on_server()
                if stats:
                    rec.update(stats)
                    logger.info("async server pour %d (staleness mean "
                                "%.2f): %s", version - 1,
                                rec["staleness_mean"], stats)
            t_eval = time.perf_counter()
            with obs_trace.span("host.close",
                                attrs={"version": version - 1}):
                self.history.append(rec)
                mlops.log_round_info(self.round_num, version - 1)
        if version >= self.round_num:
            self._record_pour_times(version - 1, t_pour, t_agg, t_eval)
            self.finish_session()
            return
        # non-uniform strategies bench flaky/byzantine silos here: a
        # benched contributor gets no fresh sync, but the empty-fire nudge
        # still reaches every online silo (the probation path). uniform
        # (default): select_silos returns everyone, unchanged.
        survivors = self.aggregator.select_silos(contributors)
        if len(survivors) < len(contributors):
            logger.info(
                "async server: benching silos %s after pour %d "
                "(reputation/dropout posterior)",
                sorted(set(contributors) - set(survivors)), version - 1)
        self._sync_ranks(survivors)
        self._arm_pour_timer()
        self._record_pour_times(version - 1, t_pour, t_agg, t_eval)

    def _record_pour_times(self, pour: int, t_pour: float, t_agg: float,
                           t_eval: float) -> None:
        """One ``round_times`` record: the cycle from the previous pour's
        end (the wait for this pour's K-th upload) to this pour's re-sync
        (the broadcast)."""
        end = time.perf_counter()
        with self._times_lock:
            start = (self._cycle_start if self._cycle_start is not None
                     else t_pour)
            self.round_times.append({
                "round": pour, "start_s": start,
                "wait_s": max(t_pour - start, 0.0),
                "aggregate_s": t_agg - t_pour,
                "eval_s": t_eval - t_agg,
                "broadcast_s": end - t_eval, "end_s": end})
            self._cycle_start = end

    def _sync_ranks(self, ranks: List[int]) -> None:
        """Hand the CURRENT model to the given silos (the ones whose
        updates were just consumed, a reconnecting silo, or — on an empty
        timeout — everyone). Version rides every sync; uploads echo it."""
        if not ranks:
            return
        version = self.aggregator.version
        client_indexes = self.aggregator.client_selection(
            version, int(self.args.client_num_in_total), self.client_num)
        wire = params_to_wire(self.aggregator.global_params)
        now = time.time()
        assign = self.aggregator.assign_data_indices(ranks, client_indexes)
        # one sync span per batch, a fresh trace per model version: each
        # silo's train/upload joins THIS version's trace, and the pour
        # that eventually consumes the upload links back to it
        with obs_trace.tracer.span(
                "async.sync", root=True,
                attrs={"role": "server", "version": version,
                       "targets": len(ranks)}) as ssp:
            for rank in ranks:
                msg = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                              self.rank, rank)
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, wire)
                msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                               assign[rank])
                msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, version)
                obs_trace.inject(msg, ssp)
                if rank not in self._outstanding:
                    # first sync of this outstanding period wins the
                    # clock: a timeout-nudge re-sync must not re-zero a
                    # slow silo's observed latency
                    self._sync_t[rank] = now
                self._outstanding[rank] = version
                self.send_message(msg)

    def _finish_step(self) -> int:
        return int(self.aggregator.version)

    def finish_session(self) -> None:
        self._done = True
        with self._timer_lock:
            if self._pour_timer is not None:
                self._pour_timer.cancel()
                self._pour_timer = None
        super().finish_session()
