"""Cross-silo FL server FSM (counterpart of
``fedml_tpu/cross_silo/server/fedml_server_manager.py``).

Client ONLINE handshake before round 0, ``send_init_msg``, collect models
-> aggregate -> re-sample -> sync, FINISH broadcast; the round timer, the
quorum grace, the chaos ledger, the adaptive keep-ratio and the
compressed broadcast with its server-side residual, as in the JAX
package. Runs over any transport backend (in-proc for tests, TCP/gRPC for
real WANs); the wire is the JAX package's (:mod:`..wire`), the keys
``PRNGKey(seed + 17)`` (aggregation) and ``PRNGKey(seed + 53)``
(broadcast compression). ``round_times`` holds each round's broadcast,
wait, aggregate and eval seconds and its ``start_s`` / ``end_s`` (the
host's ``perf_counter`` at the round's first send and after its close:
the round's wall time holds what the pieces leave out); the session's
result carries them, and the batches of one server evaluation
(``eval_batches``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import numpy as np

from ... import prng
from ...core import mlops
from ...core.obs import trace as obs_trace
from ...core.chaos import FaultLedger, FaultPlan
from ...core.distributed.communication.message import (WIRE_DTYPE_BF16,
                                                       WIRE_STATS, Message)
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.wire import (AdaptiveRatioBounds, adaptive_keep_ratio,
                          decode_update, encode_update, pack_optional_vec,
                          unpack_optional_vec, wire_checkpointer,
                          wire_state_template)
from ...utils.compression import is_compressed_payload, spec_from_args
from ..message_define import MyMessage
from ..wire import (bf16_wire_to_params, params_to_vec, params_to_wire,
                    params_to_wire_bf16, wire_to_params)

logger = logging.getLogger(__name__)


class FedMLServerManager(FedMLCommManager):
    """Rank 0. Client ranks are 1..N."""

    # class-level fallbacks: a disabled plan + quorum 1, so FSM methods
    # stay callable on partially-constructed instances (tests via __new__)
    chaos = FaultPlan()
    quorum = 1
    _timeout_graced = False
    _wire_ckpt = None
    _cc_adaptive = None
    _bcast_t0 = None
    _round_targets: list = []
    _round_selected: list = []
    # tracing: one trace per round — the ROOT span covers broadcast →
    # wait → aggregate; WAIT is the explicit straggler-time span between
    # broadcast end and round close (upload receipts land on it as
    # events), so trace_report can attribute the round's wall time
    _round_span = obs_trace.NOOP_SPAN
    _wait_span = obs_trace.NOOP_SPAN

    def __init__(self, args, aggregator, comm=None, rank: int = 0,
                 size: int = 0, backend: str = "INPROC"):
        super().__init__(args, comm, rank, size, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 1))
        self.round_idx = 0
        self.client_num = int(getattr(args, "client_num_per_round", size - 1))
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self._root_key = prng.PRNGKey(
            int(getattr(args, "random_seed", 0)) + 17)
        self.result: Optional[dict] = None
        self.history = []
        self.round_timeout_s = float(getattr(args, "round_timeout_s", 0) or 0)
        self._round_lock = threading.Lock()
        self._round_timer: Optional[threading.Timer] = None
        # chaos: the server holds the same seeded plan as the clients (it
        # is stateless), so the fault ledger can reconcile what was
        # INJECTED (scheduled dropouts) against what it OBSERVED (silos
        # that actually reported before the round closed)
        self.chaos = FaultPlan.from_args(args)
        self.chaos_ledger = FaultLedger()
        # quorum for the timeout path: below it, grant ONE grace interval
        # before degrading (single source of truth: FedMLAggregator.quorum
        # — read LIVE in _complete_round, because silo selection scales it
        # per round via set_round_expected; a snapshot here would diverge)
        self.quorum = self.aggregator.quorum
        self._timeout_graced = False
        # wire-efficient updates: clients upload compressed deltas that
        # handle_message_receive_model_from_client decompresses; the
        # sync broadcast optionally ships bf16 or (with its own server-side
        # error-feedback residual) a compressed global delta.
        self.cc_spec = spec_from_args(args)
        self._bcast_prev_vec = None   # what the CLIENTS have reconstructed
        self._bcast_residual = None
        self._cc_rng = prng.PRNGKey(
            int(getattr(args, "random_seed", 0)) + 53)
        # adaptive keep-ratio schedule (core/wire/adaptive): the stats
        # store's observed upload latency + dropout posterior pick each
        # round's ratio within configured bounds; the chosen ratio rides
        # the sync so client uplinks agree. Off by default.
        self._cc_adaptive = None
        if (getattr(args, "comm_compression_adaptive", False)
                and self.cc_spec is not None
                and self.cc_spec.method is not None):
            rmax = float(getattr(args, "comm_compression_ratio_max", None)
                         or self.cc_spec.ratio)
            rmin = float(getattr(args, "comm_compression_ratio_min", None)
                         or max(rmax / 4.0, 1e-4))
            budget = getattr(args, "comm_compression_latency_budget_s", None)
            self._cc_adaptive = AdaptiveRatioBounds(
                rmin, rmax, float(budget) if budget else None)
        # crash-resume: the broadcast base + server-side EF residual join
        # the round checkpoint (core/wire/state) — see the client manager
        self._wire_ckpt = None
        if self.cc_spec is not None and self.cc_spec.method is not None:
            self._wire_ckpt = wire_checkpointer(args, "server")
            self._restore_wire_state()
        # bytes-on-wire ledger mark for per-round accounting (counts this
        # process's encodes: all S2C traffic; in-proc sessions also count
        # the client threads' uploads, which is what the bench wants)
        self._wire_mark = WIRE_STATS.total_bytes
        # silo selection (core/selection): the broadcast timestamp clocks
        # per-silo upload latencies; _round_targets is the rank set the
        # round expects (all online ranks at default knobs — byte-
        # identical FSM; non-uniform strategies may bench flaky silos)
        self._bcast_t0: Optional[float] = None
        self._round_targets: list = []
        # per completed round: broadcast / wait / aggregate / eval seconds
        self.round_times: list = []
        self._t_mark: Dict[str, float] = {}

    def _global_f32_vec(self) -> np.ndarray:
        """The global model flattened to a host f32 vector — the SINGLE
        definition of the base-tracking representation the compressed-delta
        protocol hangs on (clients flatten the same way via params_to_vec;
        any divergence in dtype/ordering silently corrupts every delta)."""
        return params_to_vec(self.aggregator.global_params)

    # --- wire-state checkpointing -------------------------------------------
    def _save_wire_state(self, completed_round: int) -> None:
        if self._wire_ckpt is None or not self._wire_ckpt.enabled:
            return
        d = int(self._global_f32_vec().shape[0])
        bf, bv = pack_optional_vec(self._bcast_prev_vec, d)
        rf, res = pack_optional_vec(self._bcast_residual, d)
        self._wire_ckpt.maybe_save(completed_round, {
            "round": np.asarray(completed_round, np.int32),
            "bcast_prev_vec_set": bf, "bcast_prev_vec": bv,
            "bcast_residual_set": rf, "bcast_residual": res})

    def _restore_wire_state(self) -> None:
        if self._wire_ckpt is None or not self._wire_ckpt.enabled:
            return
        got = self._wire_ckpt.latest(wire_state_template(
            int(self._global_f32_vec().shape[0]),
            ("bcast_prev_vec", "bcast_residual")))
        if got is None:
            return
        step, st = got
        self._bcast_prev_vec = unpack_optional_vec(
            st["bcast_prev_vec_set"], st["bcast_prev_vec"])
        self._bcast_residual = unpack_optional_vec(
            st["bcast_residual_set"], st["bcast_residual"])
        logger.info("server: restored wire state from round %d", step)

    # --- FSM wiring ---------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS,
            self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client)

    def handle_message_client_status_update(self, msg: Message) -> None:
        status = msg.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        if status == MyMessage.MSG_CLIENT_STATUS_ONLINE:
            self.client_online_status[msg.get_sender_id()] = True
        all_online = len(self.client_online_status) >= self.client_num
        logger.info("server: %d/%d clients online",
                    len(self.client_online_status), self.client_num)
        if all_online and not self.is_initialized:
            self.is_initialized = True
            mlops.log_aggregation_status("RUNNING")
            self.send_init_msg()

    def send_init_msg(self) -> None:
        """(reference :48-86) ship round-0 model + data-silo index. Always
        dense: the init model is the common reference both sides compute
        deltas against (a ``compress`` broadcast needs every client to hold
        the exact vector the server tracks in ``_bcast_prev_vec``)."""
        self._begin_round_trace()
        client_indexes = self.aggregator.client_selection(
            self.round_idx, int(self.args.client_num_in_total),
            self.client_num)
        bsp = obs_trace.tracer.start_span(
            "broadcast", parent=self._round_span,
            attrs={"round_idx": self.round_idx})
        self._t_mark = {"bcast0": time.perf_counter()}
        with bsp:  # payload build INSIDE the span: prep time is broadcast
            # time, and a prep exception still emits the span (error attr)
            wire = params_to_wire(self.aggregator.global_params)
            if self.cc_spec is not None and self.cc_spec.method is not None:
                # whenever clients upload deltas the server must track the
                # base they refer to (what the clients reconstruct) — for
                # EVERY broadcast mode, including dense 'full': the upload
                # handler captures this base under _round_lock, so a
                # round-timeout aggregation racing a late upload cannot
                # swap the base mid-flight. After a dense init it is the
                # exact global vector. Broadcast-only specs (method None)
                # get no deltas: skip.
                self._bcast_prev_vec = self._global_f32_vec()
            self._round_targets = sorted(self.client_online_status)
            self._round_selected = list(self._round_targets)
            self._bcast_t0 = time.time()
            assign = self.aggregator.assign_data_indices(
                self._round_targets, client_indexes)
            bsp.set_attr("targets", len(self._round_targets))
            for rank in self._round_targets:
                msg = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.rank,
                              rank)
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, wire)
                msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                               assign[rank])
                msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX,
                               self.round_idx)
                # the broadcast span's context rides every sync: each
                # silo's train/upload spans join THIS round's trace
                obs_trace.inject(msg, bsp)
                self.send_message(msg)
        self._t_mark["bcast1"] = time.perf_counter()
        self._begin_wait_span()
        if self.chaos.enabled:
            # under chaos the whole round's uploads can vanish — the
            # timeout must run from the broadcast, not from an upload
            # that may never come
            self._arm_round_timer()

    # --- round tracing (core/obs) -------------------------------------------
    def _begin_round_trace(self) -> None:
        """Open a fresh trace for the round about to broadcast (root=True:
        round boundaries are trace boundaries)."""
        self._end_round_trace()  # a skipped round may have left one open
        self._round_span = obs_trace.tracer.start_span(
            "round", root=True, attrs={"role": "server",
                                       "round_idx": self.round_idx})

    def _begin_wait_span(self) -> None:
        """The straggler-time span: broadcast done → round close. Upload
        receipts land on it as events (from transport threads — the span
        is internally locked)."""
        self._wait_span = obs_trace.tracer.start_span(
            "wait.uploads", parent=self._round_span,
            attrs={"round_idx": self.round_idx})

    def _end_round_trace(self, **attrs) -> None:
        self._wait_span.end()
        self._wait_span = obs_trace.NOOP_SPAN
        for k, v in attrs.items():
            self._round_span.set_attr(k, v)
        self._round_span.end()
        self._round_span = obs_trace.NOOP_SPAN

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        recv_t = time.time()
        # receipt lands on the wait span: an event with the sender plus a
        # link to the silo's upload span (its context rode the wire), so
        # the round trace shows WHEN each straggler finally reported.
        # Recorded only after the stale check resolves: a chaos-delayed
        # upload from a timed-out round belongs to the OLD round's trace,
        # and must not read as a receipt the current round consumed.
        up_ctx = obs_trace.extract(msg)

        def _record_receipt(stale: bool) -> None:
            # a silo fast enough to upload while the server is still
            # inside the broadcast send loop beats _begin_wait_span(); the
            # receipt then falls back to the ROUND span (live since before
            # the broadcast) instead of vanishing into the NOOP wait span
            sp = self._wait_span
            if sp is obs_trace.NOOP_SPAN:
                sp = self._round_span
            sp.add_event("upload", sender=int(sender), stale=bool(stale))
            if up_ctx is not None:
                sp.add_link(up_ctx, sender=int(sender), stale=bool(stale))

        n = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, 1.0))
        update = msg.get(MyMessage.MSG_ARG_KEY_MODEL_UPDATE)
        if is_compressed_payload(update):  # delta vs the broadcast model
            up_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
            delta = decode_update(update)  # stateless: outside the lock
            with self._round_lock:
                stale = (up_round is not None
                         and int(up_round) != self.round_idx)
                if not stale:
                    # the add must share the stale check's lock
                    # acquisition: a round-timeout aggregation slipping
                    # between them would advance the round and let this
                    # round's model land in the NEXT round's pool
                    self.aggregator.add_local_trained_delta(
                        sender, delta, n, base_vec=self._bcast_prev_vec)
            if stale:
                # a straggler from a timed-out round: its delta refers
                # to a base the server already advanced past —
                # reconstructing against the new base would store a
                # model that is neither the sender's nor anyone's
                logger.warning(
                    "server: dropping stale compressed update from silo "
                    "%s (round %s, now %d)", sender, up_round,
                    self.round_idx)
                _record_receipt(stale=True)
                return
        else:
            wire = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
            params = wire_to_params(wire, self.aggregator.global_params)
            up_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
            with self._round_lock:
                # the round tag rides dense uploads only under link chaos
                # (delayed/duplicated copies can outlive their round);
                # check-and-add shares one lock acquisition like the
                # compressed path, so a racing timeout aggregation cannot
                # advance the round between them
                stale = (up_round is not None
                         and int(up_round) != self.round_idx)
                if not stale:
                    self.aggregator.add_local_trained_result(sender, params,
                                                             n)
            if stale:
                logger.warning(
                    "server: dropping stale upload from silo %s "
                    "(round %s, now %d)", sender, up_round, self.round_idx)
                _record_receipt(stale=True)
                return
        _record_receipt(stale=False)
        if self._bcast_t0 is not None:
            # broadcast→receipt wall time: the silo-selection latency
            # signal (the silo's train time + both wire hops — what the
            # round critical path pays for this silo). Recorded only for
            # CURRENT-round uploads: a chaos-delayed duplicate from a
            # past round would log a bogus cross-round latency and skew
            # which silos a non-uniform strategy benches.
            self.aggregator.observe_upload(sender, recv_t - self._bcast_t0)
        if not self.aggregator.check_whether_all_receive():
            # elastic rounds (capability beyond the reference, SURVEY §5.3):
            # a dead silo must not stall the barrier forever — arm a
            # timeout that aggregates whatever arrived
            self._arm_round_timer()
            return
        self._complete_round()

    def _arm_round_timer(self) -> None:
        """Idempotent per round: arm the elastic-round timeout (legacy
        seam: the first upload; chaos seam: the broadcast itself, because
        under injected dropout/link loss a round can produce ZERO uploads
        and a timer armed only by uploads would never fire)."""
        if self.round_timeout_s > 0 and self._round_timer is None:
            this_round = self.round_idx
            self._round_timer = threading.Timer(
                self.round_timeout_s,
                lambda: self._on_round_timeout(this_round))
            self._round_timer.daemon = True
            self._round_timer.start()

    def _on_round_timeout(self, round_when_armed: int) -> None:
        # round-validity is re-checked inside _complete_round under the SAME
        # lock acquisition that aggregates — checking here and aggregating in
        # a second acquisition would race a normal completion in the gap and
        # prematurely aggregate the next round's early arrivals.
        self._complete_round(expected_round=round_when_armed,
                             from_timeout=True)

    def _complete_round(self, expected_round: Optional[int] = None,
                        from_timeout: bool = False) -> None:
        skipped_round: Optional[int] = None
        with self._round_lock:
            if expected_round is not None and self.round_idx != expected_round:
                return  # round already completed normally
            if self._round_timer is not None:
                self._round_timer.cancel()
                self._round_timer = None
            reported = len(self.aggregator.model_dict)
            # read the aggregator's CURRENT quorum: silo selection may
            # have scaled it to this round's shrunken expected cohort
            quorum_now = getattr(getattr(self, "aggregator", None),
                                 "quorum", None) or self.quorum
            if from_timeout:
                if reported < quorum_now and not self._timeout_graced:
                    # tolerance: below quorum (or zero reports), grant ONE
                    # grace interval — stragglers and compile-skewed
                    # first rounds beat averaging a sliver of the cohort.
                    # One interval only: under injected dropout a missing
                    # silo stays missing for THIS round forever, so
                    # unbounded re-arming would stall the session.
                    self._timeout_graced = True
                    logger.warning(
                        "server round %d: timeout with %d/%d models — "
                        "below quorum %d, granting one grace interval",
                        self.round_idx, reported,
                        self.aggregator.client_num, quorum_now)
                    this_round = self.round_idx
                    self._round_timer = threading.Timer(
                        self.round_timeout_s,
                        lambda: self._on_round_timeout(this_round))
                    self._round_timer.daemon = True
                    self._round_timer.start()
                    return
                if reported == 0:
                    if not self.chaos.enabled:
                        # legacy seam: without chaos the timer is armed by
                        # the first upload, so a later upload will re-arm
                        # — keep waiting rather than advancing past a
                        # round nobody saw
                        return
                    # chaos: the whole round's uploads vanished (every
                    # silo dropped / every upload lost) — skip the round:
                    # the global model is unchanged, re-broadcasting the
                    # SAME round would deterministically re-drop the same
                    # silos, so advance and let the next round's plan roll
                    skipped_round = self.round_idx
                    self.chaos_ledger.record_round(
                        skipped_round,
                        injected={"dropped": sorted(
                            self.client_online_status)},
                        observed={"expected": self.aggregator.client_num,
                                  "reported": 0, "timeout": True,
                                  "skipped": True})
                    self._timeout_graced = False
                    self.round_idx += 1
                    self._end_round_trace(skipped=True, reported=0)
                else:
                    logger.warning(
                        "server round %d: timeout with %d/%d models — "
                        "aggregating the silos that reported",
                        self.round_idx, reported,
                        self.aggregator.client_num)
            if skipped_round is None:
                if not self.aggregator.model_dict:
                    return  # already aggregated by a racing path
                if self.chaos.enabled:
                    ranks = sorted(self.client_online_status)
                    faults = self.chaos.round_faults(self.round_idx, ranks)
                    self.chaos_ledger.record_round(
                        self.round_idx,
                        injected={"dropped": list(faults.dropped),
                                  "stragglers": dict(faults.work_scale)},
                        observed={"expected": self.aggregator.client_num,
                                  "reported": reported,
                                  "timeout": bool(from_timeout)})
                # quorum history for silo selection: which of the
                # SELECTED silos actually reported before the round
                # closed (benched silos losing the shrunken barrier's
                # race is not dropout evidence — but a benched silo that
                # reports anyway heals: the redemption path)
                self.aggregator.observe_round(
                    list(self.aggregator.model_dict),
                    self._round_selected
                    or sorted(self.client_online_status))
                round_key = prng.fold_in(self._root_key, self.round_idx)
                t_agg = time.perf_counter()
                # the wait is over: everything from here is server work
                self._wait_span.set_attr("reported", reported)
                self._wait_span.set_attr("from_timeout",
                                         bool(from_timeout))
                self._wait_span.end()
                self._wait_span = obs_trace.NOOP_SPAN
                with obs_trace.tracer.span(
                        "aggregate", parent=self._round_span,
                        attrs={"round_idx": self.round_idx,
                               "reported": reported}):
                    self.aggregator.aggregate(round_key)
                t_agg_end = time.perf_counter()
                # close the round under the SAME lock acquisition that
                # aggregates: a straggler arriving during the (slow) server
                # eval below must already see the new round_idx, or its
                # compressed delta would pass the stale check and be
                # reconstructed against the advanced base
                completed_round = self.round_idx
                self.round_idx += 1
                self._timeout_graced = False
        if skipped_round is not None:
            logger.warning("server round %d: zero uploads after grace — "
                           "skipping the round", skipped_round)
            if self.round_idx >= self.round_num:
                self.finish_session()
            else:
                self.sync_model_to_clients()
            return
        with obs_trace.tracer.span("eval", parent=self._round_span,
                                   attrs={"round_idx": completed_round}):
            stats = self.aggregator.test_on_server()
        mark = self._t_mark
        self.round_times.append({
            "round": completed_round,
            "broadcast_s": mark.get("bcast1", t_agg) - mark.get("bcast0",
                                                                 t_agg),
            "wait_s": t_agg - mark.get("bcast1", t_agg),
            "aggregate_s": t_agg_end - t_agg,
            "eval_s": time.perf_counter() - t_agg_end,
            "start_s": mark.get("bcast0", t_agg)})
        with obs_trace.tracer.span("host.close", parent=self._round_span,
                                   attrs={"round_idx": completed_round}):
            rec = {"round": completed_round}
            if stats:
                rec.update(stats)
                logger.info("server round %d: %s", completed_round, stats)
            # bytes-on-wire this round (diff of the process-wide ledger)
            total = WIRE_STATS.total_bytes
            rec["wire_bytes"] = total - self._wire_mark
            self._wire_mark = total
            mlops.log_comm_round(completed_round, rec["wire_bytes"],
                                 compression=getattr(self.cc_spec,
                                                     "method", None))
            self.history.append(rec)
            mlops.log_round_info(self.round_num, completed_round)
            self._save_wire_state(completed_round)
        self._end_round_trace(reported=len(self._round_selected),
                              wire_bytes=rec["wire_bytes"])
        self.round_times[-1]["end_s"] = time.perf_counter()
        if self.round_idx >= self.round_num:
            self.finish_session()
            return
        self.sync_model_to_clients()

    def _round_ratio(self) -> Optional[float]:
        """The adaptive schedule's keep-ratio for the round about to
        broadcast (None when the knob is off — nothing rides the wire)."""
        if self._cc_adaptive is None:
            return None
        return adaptive_keep_ratio(
            self._cc_adaptive,
            getattr(self.aggregator, "silo_stats", None),
            self._round_targets or sorted(self.client_online_status))

    def _sync_payload(self):
        """Build the per-round sync payload once (shared by every client):
        list of (param_key, value) pairs added to each sync message."""
        spec = self.cc_spec
        ratio = self._round_ratio()
        extra = []
        if ratio is not None:
            import dataclasses
            spec = dataclasses.replace(spec, ratio=ratio)
            extra = [(MyMessage.MSG_ARG_KEY_CC_RATIO, float(ratio))]
        if (spec is not None and spec.broadcast == "compress"
                and self._bcast_prev_vec is not None):
            # ship the compressed delta of the global model vs what the
            # clients currently hold; the server's own error-feedback
            # residual carries the truncated mass — and _bcast_prev_vec
            # advances by the DECODED delta so it keeps tracking the
            # clients' reconstruction, not the exact global. The
            # decompress_vec of our own blob is deliberate: it is the
            # same host routine every client runs, so the tracked base
            # is BIT-identical to theirs — the algebraic shortcut
            # (comp - residual) is not bit-exact in f32 and would let
            # the bases drift apart by an accumulating rounding gap
            enc = encode_update(
                self._global_f32_vec(), base=self._bcast_prev_vec,
                spec=spec, residual=self._bcast_residual,
                rng=prng.fold_in(self._cc_rng, self.round_idx),
                msg_type=MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
            self._bcast_residual = enc.residual
            self._bcast_prev_vec = decode_update(enc.payload,
                                                 base=self._bcast_prev_vec)
            return [(MyMessage.MSG_ARG_KEY_MODEL_UPDATE, enc.payload)] + extra
        if spec is not None and spec.broadcast == "bf16":
            wire = params_to_wire_bf16(self.aggregator.global_params)
            if spec.method is not None:
                # the clients reconstruct the bf16 ROUNDING of the global —
                # track that as the base their compressed deltas refer to
                # (adding deltas to the exact f32 global instead would fold
                # the broadcast's rounding gap into every aggregate).
                # Decode the wire payload with the same routine the clients
                # run, so the tracked base is definitionally what they hold
                self._bcast_prev_vec = params_to_vec(bf16_wire_to_params(
                    wire, self.aggregator.global_params))
            return [(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, wire),
                    (MyMessage.MSG_ARG_KEY_WIRE_DTYPE, WIRE_DTYPE_BF16)] \
                + extra
        if spec is not None and spec.method is not None:
            # dense 'full' broadcast with compressed uplinks: the clients
            # will train from (and delta against) the exact f32 global —
            # refresh the tracked base now, before any client can reply
            self._bcast_prev_vec = self._global_f32_vec()
        return [(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                 params_to_wire(self.aggregator.global_params))] + extra

    def sync_model_to_clients(self) -> None:
        self._begin_round_trace()
        client_indexes = self.aggregator.client_selection(
            self.round_idx, int(self.args.client_num_in_total),
            self.client_num)
        online = sorted(self.client_online_status)
        selected = self.aggregator.select_silos(online)
        if len(selected) < len(online):
            # non-uniform strategy benched flaky silos: shrink this
            # round's all-received barrier so it does not wait out the
            # timeout for silos the history says will not report. The
            # broadcast still goes to EVERYONE — a benched silo that does
            # report is aggregated and heals its posterior (redemption),
            # it just no longer holds the round hostage.
            self.aggregator.set_round_expected(len(selected))
            logger.info(
                "server round %d: silo selection benched %s (of %d online)",
                self.round_idx, sorted(set(online) - set(selected)),
                len(online))
        mlops.log_selection(
            round_idx=self.round_idx,
            strategy=self.aggregator.selection_strategy,
            sampled=selected,
            excluded=sorted(set(online) - set(selected)),
            target_n=len(selected))
        self._round_targets = online
        self._round_selected = selected
        bsp = obs_trace.tracer.start_span(
            "broadcast", parent=self._round_span,
            attrs={"round_idx": self.round_idx, "targets": len(online)})
        self._t_mark = {"bcast0": time.perf_counter()}
        with bsp:  # payload build INSIDE the span: prep time is broadcast
            # time, and a prep exception still emits the span (error attr)
            payload = self._sync_payload()
            self._bcast_t0 = time.time()
            # DATA-index assignment: legacy round-robin by default; the
            # `scored` knob routes the first-sampled indices to the silos
            # the stats store scores most deliverable (assign_data_indices)
            assign = self.aggregator.assign_data_indices(online,
                                                         client_indexes)
            for rank in online:
                msg = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                              self.rank, rank)
                for key, value in payload:
                    msg.add_params(key, value)
                msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                               assign[rank])
                msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX,
                               self.round_idx)
                obs_trace.inject(msg, bsp)  # see send_init_msg
                self.send_message(msg)
        self._t_mark["bcast1"] = time.perf_counter()
        self._begin_wait_span()
        if self.chaos.enabled:
            self._arm_round_timer()  # see send_init_msg

    def _finish_step(self) -> int:
        """Step stamped on the end-of-run metrics snapshot (the async
        manager progresses by aggregator version, not round_idx)."""
        return int(self.round_idx)

    def finish_session(self) -> None:
        self._end_round_trace()  # a timeout-skipped final round leaves one
        # final metrics snapshot before the FINISH broadcast: the run log
        # must carry the whole session's instruments, not just the last
        # cadence boundary's
        from ...core.obs import metrics as obs_metrics
        obs_metrics.flush_final(step=self._finish_step())
        for rank in sorted(self.client_online_status):
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH,
                                      self.rank, rank))
        last_eval = next((r for r in reversed(self.history) if "test_acc" in r),
                         {})
        self.result = {"params": self.aggregator.global_params,
                       "history": self.history,
                       "final_test_acc": last_eval.get("test_acc"),
                       "rounds": self.round_num,
                       "round_times": list(self.round_times),
                       "eval_batches": getattr(self.aggregator.eval_fn,
                                               "batches", None)}
        mlops.log_aggregation_status("FINISHED")
        # flush pending wire-state saves before teardown: an unawaited
        # write races interpreter shutdown and loses the final round's
        # residual state
        if self._wire_ckpt is not None:
            self._wire_ckpt.close()
        self.finish()
