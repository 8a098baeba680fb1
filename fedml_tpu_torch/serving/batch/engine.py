"""BatchingEngine — threaded request queue over the DecodeScheduler
(counterpart of ``fedml_tpu/serving/batch/engine.py``; the host loop is a
copy, the scheduler under it runs torch on the card). ``chaos=`` takes a
:class:`~fedml_tpu_torch.core.chaos.ServingChaosInjector`, consulted once
per decode step index before the step runs.

The serving surface (HTTP handler threads) submits requests and blocks on
per-request futures; ONE worker thread owns the scheduler and runs the
admit → step → evict loop. Iteration-level scheduling: a finishing
request frees its slot at the very next step boundary and a queued
request is admitted into it — no batch barriers, no head-of-line
blocking behind long generations (Orca's core idea).

Deadlines: a request past its deadline is EVICTED at the next step
boundary and resolves with what it has, ``finish_reason: "deadline"`` —
tail-latency control the autoscaler's p99 policies can rely on, and a
reason clients can tell apart from an honest ``"length"`` budget stop.

Fault tolerance (crash-only recovery, Candea & Fox): a watchdog trip
(NaN/inf logits, or a decode stall the loop can observe — an injected
chaos stall, or any wedge between steps) triggers a CONTROLLED RESET
instead of a permanent 503 — every in-flight request is snapshotted
(prompt, tokens so far, remaining budget, seed, adapter index), the slot
matrix + paged KV pool + scheduler state are rebuilt (same geometry),
and the snapshots are requeued at the queue front for
recompute-from-prompt. A step that hard-hangs INSIDE a device call
cannot be interrupted from this thread: /healthz stays 503 "stalled"
and recovery is the replica level's job (gateway routes around it,
``ReplicaSet.health_check``/drain-restart replaces the process) — and a
slow step that eventually RETURNS is progress, so its stale trip is
deliberately dropped rather than resetting a healthy engine. Sampling is stateless per (seed, position), so a replayed
sampled decode regenerates bit-identical tokens. Resets are budgeted
(``max_resets`` per ``reset_window_s``); past the budget the engine
stays unhealthy, dumps its flight ring, and resolves survivors with
``finish_reason: "preempted"`` (partial progress) or the same
Overloaded 503 a fresh submit gets (zero tokens — an empty "success"
would dodge the gateway's failover). Graceful degradation: when the queue
head starves past ``preempt_after_s`` the YOUNGEST slot is preempted and
requeued (it keeps its progress), and past ``shed_queue_depth`` submits
fail fast with :class:`~fedml_tpu_torch.serving.Overloaded` (HTTP 503 +
``Retry-After``) instead of wedging.

Observability (the full request lifecycle through the ``core/obs``
planes):

* one trace per request — ``serving.request`` (child of the HTTP
  surface's span when one is active, so an inbound W3C ``traceparent``
  joins the caller's trace) containing ``serving.queue`` (submit →
  admission), ``serving.prefill`` (chunked prefill), and
  ``serving.decode`` (first token → finish/evict, decode progress as
  step-bucketed events, never per-token);
* shared engine-side ``serving.decode_steps`` spans — one per block of
  decode steps, LINKING the in-flight request spans they advanced (the
  fan-in idiom async pours use for their contributing uploads);
* SLO metrics — TTFT, inter-token latency (one observation per decode
  STEP), per-request tokens/s + queue wait, KV block-pool occupancy/
  fragmentation/admission headroom, evictions and rejections by reason;
* a black-box :class:`~fedml_tpu_torch.core.obs.flight.FlightRecorder` ring of
  the last N lifecycle/step records, dumped on engine crash or when the
  :class:`~fedml_tpu_torch.core.obs.flight.Watchdog` trips (no decode progress
  for ``watchdog_s`` while occupancy > 0, or NaN/inf decode logits).
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

from ...core.obs import flight as obs_flight
from ...core.obs import metrics as obs_metrics
from ...core.obs import trace as obs_trace
from ...llm.data import EOS

logger = logging.getLogger(__name__)

# decode progress lands on the request span every this-many tokens (an
# event per token would make span records O(completion) large)
PROGRESS_EVERY_TOKENS = 16
# one shared serving.decode_steps span per this-many decode steps
DECODE_SPAN_STEPS = 32


class _Request:
    __slots__ = ("ids", "max_new", "temperature", "seed", "adapter_idx",
                 "deadline_ts", "future", "span", "out_ids", "slot",
                 "submitted_ts", "queue_span", "decode_span", "admit_ts",
                 "decode_ts", "requeues", "admit_seq", "queue_wait_start",
                 "stream_q", "adapter_pinned")

    def __init__(self, ids, max_new, temperature, seed, adapter_idx,
                 deadline_ts, span):
        self.ids = ids
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.adapter_idx = int(adapter_idx)
        self.deadline_ts = deadline_ts
        self.future: Future = Future()
        self.span = span
        self.out_ids: List[int] = []
        self.slot: Optional[int] = None
        self.submitted_ts = time.time()
        self.queue_span = None
        self.decode_span = None
        self.admit_ts: Optional[float] = None   # queue end (prefill start)
        self.decode_ts: Optional[float] = None  # first token (decode start)
        self.requeues = 0       # reset/preempt recompute cycles so far
        self.admit_seq = -1     # admission order stamp; max = youngest
        # starvation clock: when THIS queue wait began (reset on every
        # requeue, else a once-preempted request instantly reads as
        # starved and preempts its preemptor — ping-pong)
        self.queue_wait_start = self.submitted_ts
        # SSE streaming: tokens are pushed here as they decode; a
        # requeue/recovery replays transparently (the kept prefix is
        # never re-emitted — only genuinely new tokens flow)
        self.stream_q = None
        # hot-swap safety: a pinned adapter row is never reused while
        # this request (including its requeued replays) is in flight
        self.adapter_pinned = False


class BatchingEngine:
    """Continuous-batching front over one :class:`DecodeScheduler`."""

    def __init__(self, scheduler, default_deadline_s: float = 0.0,
                 rate_window_s: float = 2.0, watchdog_s: float = 30.0,
                 flight_records: int = 256,
                 flight_dir: Optional[str] = None,
                 max_resets: int = 3, reset_window_s: float = 300.0,
                 max_requeues: int = 2, preempt_after_s: float = 0.0,
                 shed_queue_depth: int = 0, chaos=None):
        self.scheduler = scheduler
        self.default_deadline_s = float(default_deadline_s)
        self.rate_window_s = float(rate_window_s)
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._pending: Deque[_Request] = collections.deque()
        self._inflight: Dict[int, _Request] = {}
        self._tokens: Deque = collections.deque()   # (ts, n) for tokens/s
        self._running = True
        # --- fault tolerance ----------------------------------------------
        self.max_resets = int(max_resets)
        self.reset_window_s = float(reset_window_s)
        self.max_requeues = int(max_requeues)
        self.preempt_after_s = float(preempt_after_s)
        self.shed_queue_depth = int(shed_queue_depth)
        self._chaos = chaos      # optional ServingChaosInjector
        self._reset_requested: Optional[str] = None   # watchdog -> loop
        self._reset_times: List[float] = []
        self._last_reset_ts = 0.0
        self.resets_total = 0
        self._failed: Optional[str] = None   # reset budget exhausted
        self._last_fault_step = -1   # one plan consult per step index
        self._admit_counter = 0
        self._wave_seq = 0       # piggybacked-prefill wave stamp
        self._req_wall_ema: Optional[float] = None   # Retry-After input
        # SLO instruments for /healthz: trailing exact-percentile TTFT /
        # ITL windows the autoscaler's SLOPolicy and the gateway's
        # saturation check read without Prometheus parsing
        self._ttft_window = obs_metrics.LatencyWindow(window_s=30.0)
        self._itl_window = obs_metrics.LatencyWindow(window_s=10.0)
        # --- black box + watchdog ------------------------------------------
        self.flight = obs_flight.FlightRecorder(
            "serving_engine", capacity=int(flight_records))
        self._flight_path = None
        if flight_dir:
            # the fallback dir is args.log_file_dir, whose schema default
            # is '~/...' — without expansion the dump lands in a literal
            # './~/' directory and the post-mortem artifact goes missing
            self._flight_path = os.path.join(
                os.path.expanduser(flight_dir),
                f"flight_serving_engine_{os.getpid()}.jsonl")
        self.last_progress_ts = time.time()
        self.watchdog = obs_flight.Watchdog(
            "serving_engine", self._watchdog_probe, recorder=self.flight,
            stall_s=float(watchdog_s), dump_path=self._flight_path,
            on_trip=self._on_watchdog_trip)
        self.watchdog.start()
        # shared decode-step block span (bare handle, worker thread only)
        self._steps_span = None
        self._steps_in_span = 0
        self._span_tokens = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-batch-engine")
        self._thread.start()

    # ------------------------------------------------------------- submit --
    def submit(self, prompt_ids, max_new_tokens: int = 64,
               temperature: float = 0.0, seed: int = 0,
               adapter_idx: int = 0,
               deadline_s: Optional[float] = None,
               parent: Any = None, stream_q=None,
               adapter_pre_pinned: bool = False) -> Future:
        """Enqueue one request; the future resolves to ``{"ids",
        "finish_reason", "prompt_tokens", "completion_tokens"}``.

        ``parent`` optionally parents the request trace (a Span,
        SpanContext, or raw traceparent string — e.g. an inbound HTTP
        header); with no parent the request joins the submitting
        thread's current span (the HTTP surface's ``serving.http``) or
        roots a fresh trace.

        ``stream_q``: an optional queue; each generated token is put as
        ``("token", id)`` the step it decodes, followed by one
        ``("finish", reason)`` after the future resolves (``("error",
        msg)`` on failure). A preempt/reset replay is transparent
        mid-stream: the kept prefix is never re-emitted.

        ``adapter_pre_pinned``: the caller already holds the adapter
        row's pin (an atomic name-resolve + retain — the template's
        hot-swap-safe path); ownership transfers to the request and is
        released at resolution. Raises before the request object exists
        (stopped/failed/shed) leave the pin with the caller."""
        if not self._running:
            obs_metrics.record_llm_reject("engine_stopped")
            raise RuntimeError("engine stopped")
        if self._failed is not None:
            # typed 503, not a bare RuntimeError: the HTTP runner maps
            # Overloaded to 503 + Retry-After, which is what lets the
            # gateway quarantine this replica and route around it — a
            # 500 here would surface to the client as a replica answer
            from .. import Overloaded
            obs_metrics.record_llm_reject("engine_failed")
            raise Overloaded(
                f"engine unhealthy (reset budget exhausted after "
                f"{self._failed}); drain and restart the replica",
                retry_after_s=30.0)
        if self.shed_queue_depth > 0:
            depth = self.queue_depth()
            if depth >= self.shed_queue_depth:
                # overload is a SIGNAL: fail fast with a Retry-After
                # hint derived from queue depth and KV admission
                # headroom instead of wedging the caller in the queue
                from .. import Overloaded
                retry_after = self._retry_after_s(depth)
                obs_metrics.record_llm_reject("overloaded")
                self.flight.note("shed", queue_depth=depth,
                                 retry_after_s=round(retry_after, 3))
                raise Overloaded(
                    f"queue depth {depth} >= shed bound "
                    f"{self.shed_queue_depth}",
                    retry_after_s=retry_after)
        span = obs_trace.tracer.start_span(
            "serving.request", parent=parent,
            attrs={"prompt_tokens": len(prompt_ids),
                   "adapter_idx": int(adapter_idx)})
        dl = self.default_deadline_s if deadline_s is None \
            else float(deadline_s)
        req = _Request(list(map(int, prompt_ids)), max_new_tokens,
                       temperature, seed, adapter_idx,
                       time.time() + dl if dl > 0 else None, span)
        req.stream_q = stream_q
        # from here on the request owns the caller's pin: every early
        # resolution below (_finish/_reject) releases it
        req.adapter_pinned = bool(adapter_pre_pinned)
        if req.max_new <= 0 or not req.ids:
            self._finish(req, "length")
            return req.future
        if len(req.ids) >= self.scheduler.cfg.max_seq_len:
            err = ValueError(
                f"prompt of {len(req.ids)} tokens >= max_seq_len "
                f"{self.scheduler.cfg.max_seq_len}")
            self._reject(req, "prompt_too_long", err)
            return req.future
        ccfg = self.scheduler.cache_cfg
        need = ccfg.blocks_needed(min(len(req.ids) + req.max_new,
                                      ccfg.max_seq_len))
        if need > ccfg.num_blocks:
            # can_admit() would be False forever: failing it now beats
            # wedging the queue head until the caller's timeout
            err = ValueError(
                f"request needs {need} KV blocks, pool has only "
                f"{ccfg.num_blocks} (raise num_blocks or shrink the "
                "request)")
            self._reject(req, "kv_pool_too_small", err)
            return req.future
        req.queue_span = obs_trace.tracer.start_span(
            "serving.queue", parent=span)
        # stitch: the queue phase starts when the request does — the
        # microseconds between the two start_span calls must not read as
        # unattributed wall in the waterfall
        if req.queue_span.span_id is not None:
            req.queue_span.start_ts = span.start_ts
        # pin the adapter row for the request's whole lifetime (incl.
        # requeued replays): a hot-swap repoints the NAME to a new row,
        # but this row is not reused until the pin drops — in-flight
        # requests keep the version they started with. (A pre-pinned
        # caller already did this atomically with name resolution.)
        if not req.adapter_pinned:
            bank = getattr(self.scheduler, "bank", None)
            if bank is not None and hasattr(bank, "retain_row"):
                bank.retain_row(req.adapter_idx)
                req.adapter_pinned = True
        self.flight.note("submit", prompt_tokens=len(req.ids),
                         max_new=req.max_new, adapter_idx=req.adapter_idx,
                         trace_id=span.trace_id)
        self._q.put(req)
        return req.future

    def _reject(self, req: _Request, reason: str, err: Exception) -> None:
        obs_metrics.record_llm_reject(reason)
        self.flight.note("reject", reason=reason)
        req.span.set_attr("error", reason).end()
        self._release_adapter_pin(req)
        self._stream_error(req, err)
        req.future.set_exception(err)

    def _release_adapter_pin(self, req: _Request) -> None:
        if not req.adapter_pinned:
            return
        req.adapter_pinned = False
        bank = getattr(self.scheduler, "bank", None)
        if bank is not None and hasattr(bank, "release_row"):
            try:
                bank.release_row(req.adapter_idx)
            except Exception:  # noqa: BLE001 — resolution must not raise
                logger.exception("adapter pin release failed")

    @staticmethod
    def _stream_error(req: _Request, err: Exception) -> None:
        if req.stream_q is not None:
            try:
                req.stream_q.put(("error", str(err)))
            except Exception:  # noqa: BLE001
                pass

    def queue_depth(self) -> int:
        return self._q.qsize() + len(self._pending)

    # --------------------------------------------------------------- loop --
    def _loop(self) -> None:
        while self._running:
            try:
                if self._reset_requested is not None:
                    self._recover(self._reset_requested)
                    continue
                if self._failed is not None:
                    # unhealthy but alive: answer /healthz, resolve any
                    # racing submits, never wedge a caller
                    self._drain_queue()
                    while self._pending:
                        self._resolve_parked(self._pending.popleft())
                    time.sleep(0.05)
                    continue
                self._drain_queue()
                self._admit()
                self._evict_deadlines()
                if not self._inflight:
                    self._close_steps_span()  # idle: don't span the wait
                    if not self._pending:
                        try:
                            self._pending.append(self._q.get(timeout=0.05))
                        except queue.Empty:
                            pass
                    else:
                        # pending but unadmittable (pool too small for the
                        # request) with nothing in flight: don't busy-spin
                        time.sleep(0.005)
                    continue
                if self._chaos is not None and not self._inject_chaos():
                    continue   # injected fault aborted this step
                self.last_progress_ts = time.time()  # entering the step:
                # only a step that HANGS past stall_s reads as a stall,
                # not a slow one that returns
                t0 = time.perf_counter()
                toks = self.scheduler.step()
                if not self.scheduler.last_step_finite:
                    # poisoned step: the tokens are garbage — discard
                    # them and run the controlled reset (requeue +
                    # recompute); a persistent poison source exhausts the
                    # reset budget and parks the engine unhealthy
                    self.flight.note("poisoned_step",
                                     step=int(self.scheduler.steps_run))
                    self._recover("nan_logits")
                    continue
                self._observe_step(len(toks), time.perf_counter() - t0)
                self._collect(toks)
            except Exception:  # noqa: BLE001 — serving loop must survive
                logger.exception("batch engine step failed")
                self.flight.note("engine_crash")
                self.flight.dump(self._flight_path, reason="crash")
                self._fail_all(RuntimeError("batch engine step failed"))
        # drain on shutdown
        self._close_steps_span()
        self._fail_all(RuntimeError("engine stopped"))

    def _inject_chaos(self) -> bool:
        """Consult the serving fault plan for the NEXT decode step.
        Returns False when the injected fault aborted the step (stall
        interrupted by a watchdog-requested reset, or NaN poison).

        One consult per step INDEX: a reset doesn't advance
        ``steps_run`` (the aborted step never ran), so without the
        latch the same scheduled fault would re-fire on every recovery
        attempt and a single injected NaN would read as a permanent
        poison source."""
        step_idx = int(self.scheduler.steps_run)
        if step_idx == self._last_fault_step:
            return True
        self._last_fault_step = step_idx
        kind = self._chaos.decode_fault(step_idx)
        if kind is None:
            return True
        if kind == "nan":
            # poison the step flag exactly like non-finite logits would
            # (the flag the step's one device->host copy carries): the
            # loop's finite check turns this into a controlled reset
            self.flight.note("chaos_nan",
                             step=int(self.scheduler.steps_run))
            self.scheduler.last_step_finite = False
            self._recover("nan_logits")
            return False
        # stall: wedge interruptibly — last_progress_ts stops moving, the
        # watchdog trips, and its reset request cuts the stall short the
        # way a process restart would. A stall shorter than the watchdog
        # leash just rides out (tolerated without a reset).
        stall_s = self._chaos.stall_s()
        self.flight.note("chaos_stall", step=int(self.scheduler.steps_run),
                         stall_s=stall_s)
        deadline = time.time() + stall_s
        while (time.time() < deadline and self._running
               and self._reset_requested is None):
            time.sleep(0.01)
        return self._reset_requested is None and self._running

    def _drain_queue(self) -> None:
        while True:
            try:
                self._pending.append(self._q.get_nowait())
            except queue.Empty:
                return

    def _admit(self) -> None:
        wave_w = int(getattr(self.scheduler, "prefill_batch", 0) or 0)
        use_wave = wave_w > 1 and hasattr(self.scheduler, "begin_admit")
        wave: List[tuple] = []   # (req, pending, dequeue_ts, span)
        while self._pending:
            req = self._pending[0]
            now = time.time()
            if req.deadline_ts is not None and now > req.deadline_ts:
                self._pending.popleft()
                obs_metrics.record_llm_evict("deadline_queued")
                req.span.add_event("evict", reason="deadline_queued")
                self.flight.note("evict", reason="deadline_queued")
                self._finish(req, "deadline")
                continue
            # recompute-from-prompt: a requeued request re-prefills its
            # prompt PLUS the tokens it already generated — sampling is
            # stateless per (seed, absolute position), so the remaining
            # decode replays bit-identically; the budget shrinks by the
            # prefix it keeps
            admit_ids = req.ids + req.out_ids
            remaining = req.max_new - len(req.out_ids)
            if remaining <= 0:   # requeued at exactly its budget edge
                self._pending.popleft()
                self._finish(req, "length")
                continue
            if not self.scheduler.can_admit(len(admit_ids), remaining):
                if wave:
                    break   # flush the collected wave; retry next pass
                if not self._maybe_preempt_for(req, now):
                    break
                if not self.scheduler.can_admit(len(admit_ids),
                                                remaining):
                    break
            if not use_wave:
                self._pending.popleft()
                self._admit_one(req, admit_ids, remaining)
                continue
            # piggybacked admission: reserve now, prefill as one wave
            self._pending.popleft()
            dequeue_ts = time.time()
            if req.queue_span is not None:
                req.queue_span.end()
                req.queue_span = None
            prefill_span = obs_trace.tracer.start_span(
                "serving.prefill", parent=req.span,
                attrs={"prompt_tokens": len(admit_ids)})
            if prefill_span.span_id is not None:
                prefill_span.start_ts = dequeue_ts  # stitch to queue end
            try:
                pending = self.scheduler.begin_admit(
                    admit_ids, adapter_idx=req.adapter_idx,
                    temperature=req.temperature, seed=req.seed,
                    max_new_tokens=remaining)
            except Exception as e:  # noqa: BLE001
                prefill_span.set_attr("error", type(e).__name__).end()
                req.span.set_attr("error", type(e).__name__).end()
                self._release_adapter_pin(req)
                self._stream_error(req, e)
                req.future.set_exception(e)
                continue
            if pending is None:   # raced out of space since can_admit
                prefill_span.end()
                self._requeue_front(req)
                break
            wave.append((req, pending, dequeue_ts, prefill_span))
            if len(wave) >= wave_w:
                self._flush_wave(wave)
                wave = []
        if wave:
            self._flush_wave(wave)

    def _requeue_front(self, req: _Request) -> None:
        """Put an unadmittable dequeued head back where it was, with a
        fresh queue span so the renewed wait stays attributed."""
        req.queue_span = obs_trace.tracer.start_span(
            "serving.queue", parent=req.span)
        self._pending.appendleft(req)

    def _admit_one(self, req: _Request, admit_ids: List[int],
                   remaining: int) -> None:
        """The serial (non-wave) admission path — one chunked prefill
        per request, today's default."""
        dequeue_ts = time.time()
        if req.queue_span is not None:
            req.queue_span.end()
            req.queue_span = None
        prefill_span = obs_trace.tracer.start_span(
            "serving.prefill", parent=req.span,
            attrs={"prompt_tokens": len(admit_ids)})
        if prefill_span.span_id is not None:
            prefill_span.start_ts = dequeue_ts  # stitch to queue end
        try:
            slot, first = self.scheduler.admit(
                admit_ids, adapter_idx=req.adapter_idx,
                temperature=req.temperature, seed=req.seed,
                max_new_tokens=remaining)
        except Exception as e:  # noqa: BLE001
            prefill_span.set_attr("error", type(e).__name__).end()
            req.span.set_attr("error", type(e).__name__).end()
            self._release_adapter_pin(req)
            self._stream_error(req, e)
            req.future.set_exception(e)
            return
        info = getattr(self.scheduler, "last_admit_info", None)
        self._post_admit(req, slot, first, dequeue_ts, prefill_span,
                         info)

    def _flush_wave(self, wave: List[tuple]) -> None:
        """Run one piggybacked prefill over the collected admissions and
        complete their per-request bookkeeping."""
        self._wave_seq += 1
        obs_metrics.record_llm_prefill_wave(len(wave))
        try:
            firsts = self.scheduler.finish_admits(
                [pending for _, pending, _, _ in wave])
        except Exception as e:  # noqa: BLE001
            logger.exception("piggybacked prefill wave failed")
            for req, pending, _, span in wave:
                try:
                    self.scheduler.abort_admit(pending)
                except Exception:  # noqa: BLE001
                    pass
                span.set_attr("error", type(e).__name__).end()
                req.span.set_attr("error", type(e).__name__).end()
                self._release_adapter_pin(req)
                self._stream_error(req, e)
                req.future.set_exception(e)
            return
        for (req, pending, dequeue_ts, span), first in zip(wave, firsts):
            self._post_admit(req, pending.slot, first, dequeue_ts, span,
                             pending.info, wave_id=self._wave_seq,
                             wave_size=len(wave))

    def _post_admit(self, req: _Request, slot: int, first: int,
                    dequeue_ts: float, prefill_span,
                    info: Optional[Dict[str, Any]],
                    wave_id: Optional[int] = None,
                    wave_size: int = 1) -> None:
        now = time.time()
        self.last_progress_ts = now  # a slow prefill is not a stall
        prefill_span.set_attr("slot", slot)
        if info:
            # the serving_report waterfall's prefix-cache annotation:
            # tokens served from resident blocks vs actually prefilled
            prefill_span.set_attr("cached_tokens",
                                  int(info.get("cached_tokens", 0)))
            prefill_span.set_attr("novel_tokens",
                                  int(info.get("novel_tokens", 0)))
        if wave_id is not None:
            prefill_span.set_attr("wave", int(wave_id))
            prefill_span.set_attr("wave_size", int(wave_size))
        first_admit = req.decode_ts is None
        req.slot = slot
        self._admit_counter += 1
        req.admit_seq = self._admit_counter
        if first_admit:
            req.admit_ts = dequeue_ts
            req.decode_ts = now
            # first token exists the moment prefill returns: TTFT is
            # submit -> here (queue wait + chunked prefill, Orca's
            # SLO). A RE-admission keeps the original TTFT — the
            # user saw their first token before the reset.
            req.span.set_attr("ttft_s",
                              round(now - req.submitted_ts, 6))
            obs_metrics.record_llm_ttft(now - req.submitted_ts)
            self._ttft_window.observe(now - req.submitted_ts)
        req.span.add_event("admit", slot=slot,
                           recompute=not first_admit)
        obs_metrics.record_llm_admit()
        self._note_kv_pool()
        note = {"slot": slot, "recompute": not first_admit,
                "queue_wait_s": round(dequeue_ts - req.submitted_ts, 6)}
        if info:
            note["cached_tokens"] = int(info.get("cached_tokens", 0))
            note["aliased_blocks"] = int(info.get("aliased_blocks", 0))
        self.flight.note("admit", **note)
        self._inflight[slot] = req
        req.decode_span = obs_trace.tracer.start_span(
            "serving.decode", parent=req.span, attrs={"slot": slot})
        if req.decode_span.span_id is not None:
            req.decode_span.start_ts = now  # stitch to prefill end
        prefill_span.end()
        self._note_tokens(1)
        if not self._append_token(req, first):
            self._retire(req)

    def _maybe_preempt_for(self, starved: _Request, now: float) -> bool:
        """Graceful degradation: when the queue head has starved past
        ``preempt_after_s``, preempt-and-requeue the YOUNGEST slot (it
        keeps its generated prefix and recomputes later) instead of
        letting the head deadline-expire in the queue. Returns True when
        a slot was freed."""
        if (self.preempt_after_s <= 0 or not self._inflight
                or now - starved.queue_wait_start < self.preempt_after_s):
            return False
        # ping-pong between two long requests is bounded by the per-
        # request requeue budget: a victim past it resolves "preempted"
        # instead of cycling forever
        victim = max(self._inflight.values(), key=lambda r: r.admit_seq)
        obs_metrics.record_llm_evict("preempted")
        victim.span.add_event("preempt", slot=victim.slot,
                              for_queue_wait_s=round(
                                  now - starved.queue_wait_start, 3))
        self.flight.note("preempt", slot=victim.slot,
                         tokens_kept=len(victim.out_ids))
        self._inflight.pop(victim.slot, None)
        # suffix-seam release: the victim's generated blocks stay warm,
        # so its requeue re-admits against its own cached chain
        self._release_slot(victim)
        victim.slot = None
        self._note_kv_pool()
        if self._requeue(victim, "pressure"):
            # _requeue appendlefts; the starved head must stay at
            # the front — rotate the victim to just behind it
            self._pending.popleft()           # the victim
            head = self._pending.popleft()    # the starved request
            self._pending.appendleft(victim)
            self._pending.appendleft(head)
        return True

    def _append_token(self, req: _Request, token: int) -> bool:
        """Append one generated token; False when the request finished."""
        if token == EOS:
            self._finish(req, "stop")
            return False
        req.out_ids.append(int(token))
        if req.stream_q is not None:
            req.stream_q.put(("token", int(token)))
        if (len(req.out_ids) % PROGRESS_EVERY_TOKENS == 0
                and req.decode_span is not None):
            req.decode_span.add_event("decode.progress",
                                      tokens=len(req.out_ids))
        if (len(req.out_ids) >= req.max_new
                or (req.slot is not None
                    and self.scheduler.slot_position(req.slot) + 1
                    >= self.scheduler.cfg.max_seq_len)):
            self._finish(req, "length")
            return False
        return True

    def _collect(self, toks: Dict[int, int]) -> None:
        self._note_tokens(len(toks))
        for slot, token in toks.items():
            req = self._inflight.get(slot)
            if req is None:
                continue
            if not self._append_token(req, token):
                self._retire(req)

    def _evict_deadlines(self) -> None:
        now = time.time()
        for slot, req in list(self._inflight.items()):
            if req.deadline_ts is not None and now > req.deadline_ts:
                obs_metrics.record_llm_evict("deadline")
                req.span.add_event("evict", reason="deadline", slot=slot)
                self.flight.note("evict", reason="deadline", slot=slot)
                self._finish(req, "deadline")
                self._retire(req)

    # ----------------------------------------------------------- recovery --
    def _on_watchdog_trip(self, reason: str) -> None:
        """Watchdog thread → worker loop: request a controlled reset.
        The flag (not the recovery itself) crosses the thread boundary;
        the worker owns every piece of scheduler state."""
        if self.max_resets > 0 and self._failed is None:
            self._reset_requested = reason

    def _recover(self, reason: str) -> None:
        """The controlled reset: snapshot in-flight requests, rebuild the
        scheduler (slot matrix + paged KV pool, same geometry),
        requeue the snapshots at the queue FRONT for recompute-from-
        prompt. Bounded by ``max_resets`` per ``reset_window_s``."""
        self._reset_requested = None
        now = time.time()
        # drop a STALE watchdog trip that raced a recovery the loop
        # already ran: if the condition the trip fired on no longer
        # holds (logits finite again / progress since resumed), a second
        # reset would only burn budget and requeue healthy work
        if reason == "nan_logits" and self.scheduler.last_step_finite:
            return
        if reason == "stalled" \
                and now - self.last_progress_ts < self.watchdog.stall_s:
            return
        self._reset_times = [t for t in self._reset_times
                             if now - t < self.reset_window_s]
        if len(self._reset_times) >= self.max_resets:
            self._give_up(reason)
            return
        self._reset_times.append(now)
        self._last_reset_ts = now
        self.resets_total += 1
        obs_metrics.record_llm_reset(reason)
        self.flight.note("engine_reset", reason=reason,
                         resets_in_window=len(self._reset_times),
                         inflight=len(self._inflight))
        # post-mortem of this episode first — the dump path gets a
        # monotonic suffix, so earlier episodes survive on disk
        self.flight.dump(self._flight_path, reason=f"reset:{reason}")
        self._close_steps_span()
        # youngest requeued first so the OLDEST lands at the queue head
        # (each _requeue appendlefts): admission order is preserved
        victims = sorted(self._inflight.values(),
                         key=lambda r: r.admit_seq, reverse=True)
        self._inflight.clear()
        requeued = 0
        for req in victims:
            req.slot = None
            if self._requeue(req, reason):
                requeued += 1
        self.scheduler.reset()
        self._note_kv_pool()
        self.flight.note("engine_reset_done", requeued=requeued)
        self.last_progress_ts = time.time()   # progress resumed: re-arm

    def _requeue(self, req: _Request, reason: str) -> bool:
        """Snapshot one in-flight request back into the pending queue
        (front, caller preserves order) for recompute-from-prompt; a
        request past its requeue budget resolves ``"preempted"`` with
        the tokens it has. Returns True when requeued."""
        if req.decode_span is not None:
            req.decode_span.set_attr("requeued", reason)
            req.decode_span.set_attr("completion_tokens",
                                     len(req.out_ids))
            req.decode_span.end()
            req.decode_span = None
        if req.requeues >= self.max_requeues:
            obs_metrics.record_llm_evict("requeue_exhausted")
            req.span.add_event("evict", reason="requeue_exhausted")
            self.flight.note("evict", reason="requeue_exhausted",
                             requeues=req.requeues)
            self._finish(req, "preempted")
            return False
        req.requeues += 1
        obs_metrics.record_llm_requeue(reason)
        req.span.add_event("requeue", reason=reason,
                           requeues=req.requeues,
                           tokens_kept=len(req.out_ids))
        self.flight.note("requeue", reason=reason,
                         requeues=req.requeues,
                         tokens_kept=len(req.out_ids))
        # the re-wait is queue time again — open a fresh queue span so
        # the waterfall attributes the recovery gap instead of losing it
        req.queue_span = obs_trace.tracer.start_span(
            "serving.queue", parent=req.span)
        req.queue_wait_start = time.time()
        self._pending.appendleft(req)
        return True

    def _give_up(self, reason: str) -> None:
        """Reset budget exhausted: park the engine unhealthy (/healthz
        503), dump the ring, and resolve every survivor ``"preempted"``
        — degraded, never wedged."""
        self._failed = reason
        logger.error("batch engine: reset budget exhausted (%d resets "
                     "in %.0fs window) after %s — staying unhealthy",
                     len(self._reset_times), self.reset_window_s, reason)
        self.flight.note("engine_failed", reason=reason,
                         resets_in_window=len(self._reset_times))
        self.flight.dump(self._flight_path,
                         reason="reset_budget_exhausted")
        self._close_steps_span()
        for req in list(self._inflight.values()):
            self._retire(req)
            self._resolve_parked(req)
        self._drain_queue()
        while self._pending:
            self._resolve_parked(self._pending.popleft())

    def _resolve_parked(self, req: _Request) -> None:
        """Close out one request on a parked engine: partial progress
        resolves ``"preempted"`` (the tokens it has are real work worth
        returning), but a ZERO-token request gets the same Overloaded
        503 a fresh submit would — an empty 200 "success" would read as
        a served completion and the gateway would never fail it over."""
        if req.future.done():
            return
        if req.out_ids:
            self._finish(req, "preempted")
            return
        from .. import Overloaded
        obs_metrics.record_llm_reject("engine_failed")
        self.flight.note("reject", reason="engine_failed")
        self._end_spans_on_error(req)
        err = Overloaded(
            f"engine unhealthy (reset budget exhausted after "
            f"{self._failed}); drain and restart the replica",
            retry_after_s=30.0)
        self._release_adapter_pin(req)
        self._stream_error(req, err)
        req.future.set_exception(err)

    def _retry_after_s(self, depth: int) -> float:
        """Retry-After from the live gauges: how long until the queue
        ahead of a new arrival drains, estimated as (depth / admission
        headroom) request-walls. Headroom comes from the KV pool's
        worst-case admission gauge; the wall EMA from finished
        requests."""
        wall = self._req_wall_ema if self._req_wall_ema else 1.0
        try:
            headroom = max(
                int(self.scheduler.kv_pool_stats()["headroom_requests"]),
                1)
        except Exception:  # noqa: BLE001 — shedding must never raise
            headroom = 1
        waves = max(float(depth) / float(headroom), 1.0)
        return min(max(waves * wall, 0.5), 60.0)

    def _retire(self, req: _Request) -> None:
        if req.slot is not None:
            self._inflight.pop(req.slot, None)
            self._release_slot(req)
            req.slot = None
            self._note_kv_pool()

    def _release_slot(self, req: _Request) -> None:
        """Release through the suffix-cache seam when the scheduler has
        one: the full token chain (prompt + generated) rides along so
        fully-written decode blocks get indexed for follow-up/requeued
        aliasing. getattr-gated — stub schedulers keep their single-arg
        ``release``."""
        if getattr(self.scheduler, "suffix_cache", False):
            self.scheduler.release(req.slot,
                                   final_ids=req.ids + req.out_ids)
        else:
            self.scheduler.release(req.slot)

    def _finish(self, req: _Request, reason: str) -> None:
        if req.future.done():
            return
        now = time.time()
        req.span.set_attr("completion_tokens", len(req.out_ids))
        req.span.set_attr("finish_reason", reason)
        if req.admit_ts is not None:
            queue_wait = req.admit_ts - req.submitted_ts
            decode_wall = max(now - (req.decode_ts or req.admit_ts), 1e-9)
            tps = len(req.out_ids) / decode_wall
            req.span.set_attr("queue_wait_s", round(queue_wait, 6))
            req.span.set_attr("tokens_per_s", round(tps, 2))
            obs_metrics.record_llm_request(tps, queue_wait)
            # request-wall EMA feeds the load-shed Retry-After estimate
            wall = now - req.submitted_ts
            self._req_wall_ema = (wall if self._req_wall_ema is None
                                  else 0.3 * wall
                                  + 0.7 * self._req_wall_ema)
        # the request span ends FIRST: the still-open phase span's end_ts
        # then lands at-or-after the request's, and the report's clipping
        # attributes the request window tail to it instead of leaving the
        # span-emission write latency unexplained
        req.span.end()
        if req.queue_span is not None:  # evicted before admission
            req.queue_span.end()
            req.queue_span = None
        if req.decode_span is not None:
            req.decode_span.set_attr("completion_tokens", len(req.out_ids))
            req.decode_span.end()
            req.decode_span = None
        self.flight.note("finish", reason=reason,
                         completion_tokens=len(req.out_ids))
        self._release_adapter_pin(req)
        req.future.set_result({
            "ids": list(req.out_ids), "finish_reason": reason,
            "prompt_tokens": len(req.ids),
            "completion_tokens": len(req.out_ids)})
        if req.stream_q is not None:
            # after set_result: the stream consumer reading the finish
            # frame can immediately collect the resolved usage totals
            req.stream_q.put(("finish", reason))

    def _fail_all(self, err: Exception) -> None:
        self._drain_queue()   # a submit racing stop() must fail too
        for req in list(self._inflight.values()):
            self._retire(req)
            if not req.future.done():
                self._end_spans_on_error(req)
                self._release_adapter_pin(req)
                self._stream_error(req, err)
                req.future.set_exception(err)
        for req in list(self._pending):
            if not req.future.done():
                self._end_spans_on_error(req)
                self._release_adapter_pin(req)
                self._stream_error(req, err)
                req.future.set_exception(err)
        self._pending.clear()

    @staticmethod
    def _end_spans_on_error(req: _Request) -> None:
        for sp in (req.queue_span, req.decode_span):
            if sp is not None:
                sp.set_attr("error", "engine_failure").end()
        req.queue_span = req.decode_span = None
        req.span.set_attr("error", "engine_failure").end()

    # ------------------------------------------------------------ metrics --
    def _note_tokens(self, n: int) -> None:
        now = time.time()
        self._tokens.append((now, n))
        cutoff = now - self.rate_window_s
        while self._tokens and self._tokens[0][0] < cutoff:
            self._tokens.popleft()

    def tokens_per_s(self) -> float:
        now = time.time()
        total = sum(n for ts, n in self._tokens
                    if ts >= now - self.rate_window_s)
        return total / self.rate_window_s

    def _note_kv_pool(self) -> None:
        st = self.scheduler.kv_pool_stats()
        obs_metrics.record_llm_kv_pool(
            st["used_blocks"], st["free_blocks"],
            st["headroom_requests"], st["fragmentation"],
            aliased_blocks=st.get("aliased_blocks"),
            cached_blocks=st.get("cached_blocks"))

    def _observe_step(self, tokens_out: int, wall_s: float) -> None:
        self.last_progress_ts = time.time()
        obs_metrics.record_llm_serving_step(
            tokens_out=tokens_out,
            occupancy=self.scheduler.active_count(),
            queue_depth=self.queue_depth(),
            tokens_per_s=self.tokens_per_s())
        # one ITL observation per STEP: every in-flight request
        # experienced this inter-token gap (per-step, not per-slot, so
        # the hot loop stays one bisect regardless of occupancy)
        obs_metrics.record_llm_itl(wall_s)
        self._itl_window.observe(wall_s)
        self.flight.note("step", tokens=tokens_out,
                         occupancy=self.scheduler.active_count(),
                         queue_depth=self.queue_depth(),
                         wall_s=round(wall_s, 6),
                         finite=bool(self.scheduler.last_step_finite))
        self._advance_steps_span(tokens_out)

    # shared decode-step block spans: the engine's side of the request
    # trace — each block span LINKS the request spans it advanced, the
    # same fan-in idiom async pours use for their contributing uploads
    def _advance_steps_span(self, tokens_out: int) -> None:
        if self._steps_span is None:
            self._steps_span = obs_trace.tracer.start_span(
                "serving.decode_steps", root=True)
            self._steps_in_span = 0
            self._span_tokens = 0
            for req in self._inflight.values():
                self._steps_span.add_link(req.span, slot=req.slot)
        else:
            # requests admitted since the block opened fan in too
            linked = {ln["span_id"]
                      for ln in getattr(self._steps_span, "links", ())}
            for req in self._inflight.values():
                ctx = req.span.context
                if ctx is not None and ctx.span_id not in linked:
                    self._steps_span.add_link(req.span, slot=req.slot)
        self._steps_in_span += 1
        self._span_tokens += tokens_out
        if self._steps_in_span >= DECODE_SPAN_STEPS:
            self._close_steps_span()

    def _close_steps_span(self) -> None:
        if self._steps_span is None:
            return
        self._steps_span.set_attr("steps", self._steps_in_span)
        self._steps_span.set_attr("tokens", self._span_tokens)
        self._steps_span.end()
        self._steps_span = None

    # ------------------------------------------------------------- health --
    def _watchdog_probe(self) -> Dict[str, Any]:
        return {"occupancy": self.scheduler.active_count(),
                "queue_depth": self.queue_depth(),
                "last_progress_ts": self.last_progress_ts,
                "poisoned": not self.scheduler.last_step_finite}

    def health(self) -> Dict[str, Any]:
        """Liveness summary for ``/healthz``: ``status`` is ``ok`` until
        the watchdog has tripped without progress since."""
        now = time.time()
        age = now - self.last_progress_ts
        status = "ok"
        if not self._running:
            status = "stopped"
        elif self._failed is not None:
            status = "failed"
        elif not self.scheduler.last_step_finite:
            status = "nan_logits"
        elif (self.watchdog.stall_s > 0
              and self.scheduler.active_count() > 0
              and age > self.watchdog.stall_s):
            status = "stalled"
        out = {"status": status,
               "occupancy": self.scheduler.active_count(),
               "queue_depth": self.queue_depth(),
               "last_step_age_s": round(age, 3),
               "steps_run": int(self.scheduler.steps_run),
               "tokens_per_s": round(self.tokens_per_s(), 2),
               "watchdog_trips": int(self.watchdog.trips),
               "resets": int(self.resets_total),
               "reset_budget_remaining": max(
                   self.max_resets - len(self._reset_times), 0),
               "flight_records": len(self.flight)}
        # the fleet-control payload: exact trailing percentiles + KV
        # admission headroom in one cheap scrape — what the SLOPolicy
        # autoscaler and the cache-aware gateway's spill check consume
        _, _, _, ttft_p99, ttft_n = self._ttft_window.stats()
        _, _, _, itl_p99, itl_n = self._itl_window.stats()
        try:
            headroom = int(
                self.scheduler.kv_pool_stats()["headroom_requests"])
        except Exception:  # noqa: BLE001 — health must answer, not raise
            headroom = -1
        out["slo"] = {"ttft_p99_s": round(ttft_p99, 6),
                      "ttft_n": int(ttft_n),
                      "itl_p99_s": round(itl_p99, 6),
                      "itl_n": int(itl_n),
                      "kv_headroom_requests": headroom}
        if self._failed is not None:
            out["failed_reason"] = self._failed
        return out

    def debug_state(self) -> Dict[str, Any]:
        """``/debug/state`` payload: the scheduler's slot matrix +
        block-table summary and a snapshot of the waiting queue."""
        # the engine thread mutates _pending concurrently; copying a
        # deque mid-mutation raises RuntimeError in CPython, and exactly
        # a busy queue is when the operator wants this endpoint
        for _ in range(8):
            try:
                head = list(self._pending)[:32]
                break
            except RuntimeError:
                continue
        else:
            head = []
        pending = [{"prompt_tokens": len(r.ids), "max_new": r.max_new,
                    "adapter_idx": r.adapter_idx,
                    "waiting_s": round(time.time() - r.submitted_ts, 3)}
                   for r in head]
        return {"engine": self.health(),
                "scheduler": self.scheduler.debug_state(),
                "queue": {"depth": self.queue_depth(),
                          "pending_head": pending}}

    # ------------------------------------------------------------- control --
    def stop(self) -> None:
        self._running = False
        self.watchdog.stop()
        self._thread.join(timeout=5.0)
        # serving has no round boundary: without this final snapshot a
        # short session's TTFT/ITL histograms never reach the run log
        # (the wall-clock flusher only covers sessions longer than its
        # cadence)
        obs_metrics.flush_final()
