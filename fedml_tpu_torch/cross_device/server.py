"""Cross-device FL server (Beehive analogue; counterpart of
``fedml_tpu/cross_device/server.py``).

Parity target: reference ``cross_device/server_mnn/fedml_server_manager.py:14``
(device ONLINE handshake, start-train broadcast, model-file collection,
FINISH) and ``fedml_aggregator.py:17,63`` (reads each device's uploaded
model file, weighted-averages, evaluates the global model server-side).

The server keeps the global model as a state dict on its device (the
card): ``DeviceAggregator.aggregate`` reads each uploaded artifact (a
dense flax tree, or a compressed delta blob decoded against the round's
global through ``core/wire.decode_update``, the add on the card), and
sums ``params * (n / Σn)`` in float32 in sorted device order, the JAX
package's numpy order and precision (a float32 array times a Python
float stays float32 there too); evaluation runs on the card. The device
side stays file-based (devices upload params artifacts; the wire message
carries the artifact path + sample count). Transport is any
``FedMLCommManager`` backend (in-proc for tests, TCP/gRPC across a
LAN/WAN). ``round_times`` holds each round's wait (dispatch to the
round's close), aggregate and eval seconds.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core import mlops
from ..core.collectives import tree_flatten_to_vector, vector_to_tree_like
from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..core.wire import decode_update
from ..utils.compression import is_compressed_payload
from ..simulation.sampling import FAST_SAMPLE_MIN_N, sample_ids_streaming
from ..serving import check_model_magic, load_model, save_model
from ..interop import flax_to_state_dict
from ..utils.paths import confine_path
from .message_define import DeviceMessage

logger = logging.getLogger(__name__)


class DeviceAggregator:
    """Server state: device model files -> weighted average -> eval
    (reference ``fedml_aggregator.py:63`` reads MNN files and averages).
    ``global_params``: a state dict; the aggregate runs on its device."""

    def __init__(self, args, global_params, eval_fn=None):
        self.args = args
        self.global_params = global_params
        self.device = next(iter(global_params.values())).device
        self.eval_fn = eval_fn
        self.client_num = int(getattr(args, "client_num_per_round", 1))
        self._expected = self.client_num
        self.model_files: Dict[int, str] = {}
        self.sample_nums: Dict[int, float] = {}

    def set_round_expected(self, n: int) -> None:
        """Per-round barrier width (cohort assembly over-samples the
        dispatch but closes on the WANTED cohort — Bonawitz pace
        steering: first k reports win, the rest are straggler slack)."""
        self._expected = max(int(n), 1)

    def add_device_result(self, device_id: int, model_file: str,
                          num_samples: float) -> None:
        self.model_files[device_id] = model_file
        self.sample_nums[device_id] = float(num_samples)

    def all_received(self) -> bool:
        return len(self.model_files) >= self._expected

    def decode_upload(self, blob, base_vec: torch.Tensor):
        """A compressed delta blob (the device's
        ``device_wire_compression``) decoded against ``base_vec``, the
        round's global as a flat float32 vector on the server's device:
        the blob's delta on the host, the add on the device."""
        delta = torch.from_numpy(decode_update(blob)).to(self.device)
        return vector_to_tree_like(base_vec + delta, self.global_params)

    def aggregate(self):
        # compressed uplinks (device_wire_compression): artifacts are
        # delta blobs vs the round's dispatched global — still this
        # round's ``global_params``, which aggregate() only replaces at
        # the end. Flatten that base once, lazily.
        base_vec = None
        loaded = []
        for did, path in sorted(self.model_files.items()):
            try:
                # artifacts were magic-validated at receive time; a file
                # that still fails here (deleted/truncated in between) is
                # skipped, never fatal to the round-closing thread
                params = load_model(path)
                if is_compressed_payload(params):
                    if base_vec is None:
                        base_vec = tree_flatten_to_vector(
                            self.global_params).float()
                    params = self.decode_upload(params, base_vec)
                else:
                    params = {k: torch.tensor(np.asarray(v, np.float32),
                                              device=self.device)
                              for k, v in flax_to_state_dict(params).items()}
                loaded.append((self.sample_nums[did], params))
            except (ValueError, OSError) as e:
                logger.warning("aggregate: skipping device %d: %s", did, e)
        self.model_files.clear()
        self.sample_nums.clear()
        if not loaded:  # dead round: keep the previous global
            return self.global_params
        total = sum(n for n, _ in loaded) or 1.0
        acc = None
        for n, params in loaded:
            w = n / total
            scaled = {k: v.float() * w for k, v in params.items()}
            acc = scaled if acc is None else {
                k: acc[k] + scaled[k] for k in acc}
        self.global_params = acc
        return self.global_params

    def test_on_server(self) -> Optional[Dict[str, float]]:
        if self.eval_fn is None:
            return None
        return self.eval_fn(self.global_params)


class DeviceServerManager(FedMLCommManager):
    """Rank 0; devices register with their own ids (ranks 1..N)."""

    def __init__(self, args, aggregator: DeviceAggregator, comm=None,
                 rank: int = 0, size: int = 0, backend: str = "INPROC"):
        super().__init__(args, comm, rank, size, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 1))
        self.round_idx = 0
        self.expected_devices = int(getattr(args, "client_num_per_round", 1))
        self.devices_online: Dict[int, Dict] = {}
        self.is_initialized = False
        self.cache_dir = os.path.expanduser(
            getattr(args, "model_file_cache_dir", None)
            or "~/.cache/fedml_tpu/device_models")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.history = []
        # per round: wait (dispatch to the round's close), aggregate and
        # eval seconds
        self.round_times: list = []
        self._t_marks: Dict[str, float] = {}
        self.result: Optional[dict] = None
        self._lock = threading.Lock()
        # elastic rounds (mirrors the cross-silo server): a dead device
        # must not stall the all-received barrier forever
        self.round_timeout_s = float(getattr(args, "round_timeout_s", 0)
                                     or 0)
        self._timer: Optional[threading.Timer] = None
        self._timer_gen = 0
        # guards the timer-vs-last-arrival race: set under the lock when a
        # round's collection closes, so a timer thread that was already
        # blocked on the lock bails instead of double-advancing
        self._round_closed = False
        # did -> on-device accuracy of the round's global model (native
        # devices report it; cleared per round)
        self._device_accs: dict = {}
        # --- streaming cohort assembly (cohort_assembly knob; off =
        # every online device trains every round, the legacy behavior).
        # Population-plane pieces: sparse-capable stats store over device
        # ids, handshake eligibility predicates, chunked top-k assembler,
        # and Oort's deadline pacer driving the straggler timer + the
        # over-sampled dispatch width.
        self.cohort_enabled = bool(getattr(args, "cohort_assembly", False))
        self.stats = None
        self.assembler = None
        self.pacer = None
        self._cohort: list = []
        self._barrier = self.expected_devices
        self._dispatch_ts = 0.0
        if self.cohort_enabled:
            from ..core.selection import (DeadlinePacer,
                                          StreamingCohortAssembler,
                                          make_stats_store,
                                          required_eligibility)
            # +1: device ids are 1-based ranks
            population = max(int(getattr(args, "client_num_in_total",
                                         self.expected_devices)),
                             self.expected_devices) + 1
            self.stats = make_stats_store(args, population)
            self.assembler = StreamingCohortAssembler(args, self.stats,
                                                      population)
            self.pacer = DeadlinePacer.from_args(args)
            self.required_elig = required_eligibility(args)
            self.cohort_k = int(getattr(args, "cohort_size", 0) or 0) \
                or self.expected_devices
        self._round_k = getattr(self, "cohort_k", self.expected_devices)
        self._round_utility = 0.0
        # per-round (round_idx, cohort) trail — restart-and-resume tests
        # assert a restarted server replays these identically
        self.cohort_log: list = []
        # --- durable fleet plane (fleet_registry knob; off = the
        # in-memory single-tenant path above, bit-identical). The sqlite
        # registry remembers every device across restarts, the fairness
        # tables arbitrate concurrent tasks sharing the file, and the
        # checkpointed stats/pacer posture makes a restarted server
        # resume the learned fleet posture instead of re-learning it.
        self.fleet = None
        self.fleet_task = str(getattr(args, "fleet_task_id", "") or "train")
        reg_path = getattr(args, "fleet_registry", None)
        if reg_path:
            from ..core.fleet import DeviceRegistry
            self.fleet = DeviceRegistry(str(reg_path))
            self.fleet_cap = int(getattr(args,
                                         "fleet_max_rounds_per_window", 0)
                                 or 0)
            self.fleet_window_s = float(getattr(
                args, "fleet_fairness_window_s", 3600.0) or 3600.0)
            if self.cohort_enabled:
                self._fleet_restore()

    # --- durable fleet plane -----------------------------------------------
    def _fleet_restore(self) -> None:
        """Resume the persisted control-plane posture: the fleet-wide
        stats snapshot, this task's pacer, and its round cursor. A fresh
        registry has none of them — start cold, exactly like fleet-off."""
        st = self.fleet.load_state("fleet:stats")
        if st is not None:
            try:
                self.stats.load_state_dict(st)
            except ValueError as e:
                logger.warning("fleet: persisted stats incompatible with "
                               "this population (%s) — resuming cold", e)
        pst = self.fleet.load_state(f"fleet:pacer:{self.fleet_task}")
        if pst is not None:
            self.pacer.load_state_dict(pst)
        sst = self.fleet.load_state(f"fleet:server:{self.fleet_task}")
        if sst is not None:
            self.round_idx = int(sst["round_idx"])
            if "model" in sst:
                from ..core.distributed.communication.message import \
                    loads_tree
                dev = self.aggregator.device
                self.aggregator.global_params = {
                    k: torch.tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in flax_to_state_dict(
                        loads_tree(sst["model"].tobytes())).items()}
            logger.info(
                "fleet: task %r resumes at round %d (%d devices "
                "remembered)", self.fleet_task, self.round_idx,
                self.fleet.device_count())

    def _fleet_save(self) -> None:
        """Checkpoint the control plane after every closed round — a
        crash between rounds restarts into the NEXT round with the
        learned posture AND the aggregated global model intact (the
        model rides along as a wire-codec blob, never pickle)."""
        from ..core.distributed.communication.message import dumps_tree
        from ..interop import state_dict_to_flax
        self.fleet.save_state("fleet:stats", self.stats.state_dict())
        self.fleet.save_state(f"fleet:pacer:{self.fleet_task}",
                              self.pacer.state_dict())
        blob = np.frombuffer(
            dumps_tree(state_dict_to_flax(self.aggregator.global_params)),
            dtype=np.uint8)
        self.fleet.save_state(f"fleet:server:{self.fleet_task}",
                              {"round_idx": np.int64(self.round_idx),
                               "model": blob})

    # --- FSM ---------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            DeviceMessage.MSG_TYPE_D2S_REGISTER, self.handle_register)
        self.register_message_receive_handler(
            DeviceMessage.MSG_TYPE_D2S_MODEL, self.handle_device_model)

    def handle_register(self, msg: Message) -> None:
        # idempotent: a device re-registering under the same id (network
        # flap, app restart) refreshes its eligibility in place — the
        # online-table slot is keyed by id, the registry write is an
        # UPSERT preserving first_seen/participation, and the
        # is_initialized guard below keeps a re-register from dispatching
        # a second session. Its stats history is keyed by id in the
        # stats store and is never touched here.
        did = int(msg.get(DeviceMessage.ARG_DEVICE_ID))
        self.devices_online[did] = {
            "os": msg.get(DeviceMessage.ARG_DEVICE_OS, "?"),
            "engine": msg.get(DeviceMessage.ARG_DEVICE_ENGINE, "?"),
            # eligibility analogues (absent = True: a device that
            # predates the handshake fields stays schedulable)
            "charging": bool(msg.get(DeviceMessage.ARG_DEVICE_CHARGING,
                                     True)),
            "idle": bool(msg.get(DeviceMessage.ARG_DEVICE_IDLE, True)),
            "unmetered": bool(msg.get(DeviceMessage.ARG_DEVICE_UNMETERED,
                                      True)),
        }
        if self.fleet is not None:
            self.fleet.register(did, self.devices_online[did])
        logger.info("server: device %d online (%s/%s), %d/%d", did,
                    self.devices_online[did]["os"],
                    self.devices_online[did]["engine"],
                    len(self.devices_online), self.expected_devices)
        if (len(self.devices_online) >= self.expected_devices
                and not self.is_initialized):
            self.is_initialized = True
            if self.round_idx >= self.round_num:
                # fleet-resumed past the final round: the session this
                # registry remembers already completed
                logger.info("fleet: session already complete at round %d",
                            self.round_idx)
                self.finish_session()
                return
            mlops.log_aggregation_status("RUNNING")
            self._dispatch_round(DeviceMessage.MSG_TYPE_S2D_INIT)

    def _global_model_file(self) -> str:
        path = os.path.join(self.cache_dir,
                            f"global_round_{self.round_idx}.npk")
        save_model(self.aggregator.global_params, path)
        return path

    def _round_cohort(self) -> list:
        """The devices this round trains: every online device (legacy),
        or the streaming-assembled cohort — eligibility predicates over
        the handshake metadata, utility scoring from observed history,
        pacer-over-sampled dispatch width."""
        online = sorted(self.devices_online)
        if not self.cohort_enabled:
            return online
        from ..core import mlops
        from ..core.obs import metrics as obs_metrics
        from ..core.selection.cohort import eligible_mask
        k = self.pacer.paced_cohort(self.cohort_k)
        self._round_k = k
        target = self.pacer.target_cohort(k, ceiling=len(online))
        ids = np.asarray(online, np.int64)
        metas = [self.devices_online[d] for d in online]
        mask = eligible_mask(metas, self.required_elig)

        def elig(chunk: np.ndarray) -> np.ndarray:
            # the online table is one in-memory chunk here; the fleet
            # path below pages the persistent registry instead
            pos = np.searchsorted(ids, chunk)
            return mask[pos]

        candidates = [ids]
        eligible_fn = elig
        if self.fleet is not None:
            # registry-backed candidates: page every device the fleet
            # has EVER heard from (chunked — the population is never
            # materialized), sieved by liveness (must be online right
            # now to receive a dispatch), the handshake predicate, and
            # the trailing-window fairness cap
            candidates = self.fleet.iter_id_chunks(self.assembler.chunk)

            def fleet_elig(chunk: np.ndarray) -> np.ndarray:
                pos = np.searchsorted(ids, chunk)
                pos = np.minimum(pos, max(len(ids) - 1, 0))
                m = (len(ids) > 0) & (ids[pos] == chunk) & mask[pos]
                if self.fleet_cap and m.any():
                    counts = self.fleet.participation_counts(
                        chunk[m], self.fleet_window_s)
                    keep = counts < self.fleet_cap
                    m[np.flatnonzero(m)] = keep
                return m

            eligible_fn = fleet_elig
        res = self.assembler.assemble(
            self.round_idx, target, candidates, eligible_fn=eligible_fn,
            deadline_s=self.pacer.deadline_s,
            over_sample=self.pacer.over_sample)
        cohort = sorted(res.cohort)
        self._round_utility = (float(np.sum(res.scores))
                               if res.scores is not None
                               and len(res.scores) else 0.0)
        if self.fleet is not None and cohort:
            # atomic multi-tenant arbitration: a concurrent task sharing
            # the registry cannot co-schedule a device this round
            granted, busy, capped = self.fleet.claim(
                self.fleet_task, cohort, self.round_idx,
                cap=self.fleet_cap, window_s=self.fleet_window_s)
            obs_metrics.record_fleet_round(self.fleet_task, len(granted),
                                           busy, capped)
            if busy or capped:
                logger.info(
                    "fleet round %d: %d denied busy, %d denied by the "
                    "participation cap", self.round_idx, busy, capped)
            cohort = sorted(granted)
        if not cohort:
            if self.fleet is not None:
                # fairness denials are binding — never bulldoze the cap
                # by falling back to the whole online table; the dead-
                # round leash closes this round and the next one retries
                logger.warning(
                    "fleet round %d: no claimable device — empty round",
                    self.round_idx)
                self.cohort_log.append((self.round_idx, []))
                return []
            logger.warning(
                "cohort assembly round %d: no eligible device of %d "
                "online — dispatching to every online device",
                self.round_idx, len(online))
            cohort = online
        self.stats.record_selected(self.round_idx, cohort)
        mlops.log_selection(
            round_idx=self.round_idx, strategy="cohort",
            sampled=cohort, excluded=[],
            target_n=target,
            dropout_posterior=round(
                self.stats.population_dropout_mean(), 5))
        logger.info(
            "cohort round %d: %d/%d online eligible, dispatching %d "
            "(deadline %.1fs, over-sample %.2f, assembly %.2fms)",
            self.round_idx, res.eligible, len(online), len(cohort),
            self.pacer.deadline_s, self.pacer.over_sample, res.wall_ms)
        self.cohort_log.append((self.round_idx, list(cohort)))
        return cohort

    def _round_deadline_s(self) -> float:
        """Straggler budget for the CURRENT round: the pacer's live
        deadline under cohort assembly, else the static knob."""
        if self.cohort_enabled:
            return float(self.pacer.deadline_s)
        return self.round_timeout_s

    def _dispatch_round(self, msg_type: str) -> None:
        """Write the global artifact once, point every cohort device at
        it (reference start_train JSON with the global model S3 path)."""
        path = self._global_model_file()
        cohort = self._round_cohort()
        with self._lock:
            self._round_closed = False
            self._cohort = list(cohort)
            # cohort mode: the barrier closes on the WANTED k (the
            # pacer-scaled live k, when cohort adaptation is on), not
            # the over-sampled dispatch width — first k reports win
            self._barrier = (min(self._round_k, len(cohort))
                             if self.cohort_enabled
                             else self.aggregator.client_num)
            self.aggregator.set_round_expected(self._barrier)
        self._dispatch_ts = time.time()
        self._t_marks = {"dispatch": time.perf_counter()}
        # dead-round leash: if NO device ever reports this round (all
        # crashed post-registration), the tight first-arrival timer in
        # handle_device_model never arms and the round would hang forever.
        # Arm a generous 3x leash now; the first arrival swaps it for the
        # tight straggler timer (mirrors SecAggServerManager._start_round).
        deadline = self._round_deadline_s()
        if deadline > 0:
            self._arm_timer(3.0 * deadline)
        n_total = int(getattr(self.args, "client_num_in_total",
                              self.expected_devices))
        if n_total <= len(cohort):
            silos = np.arange(len(cohort))
        elif n_total >= FAST_SAMPLE_MIN_N:
            # population-scale silo draw: O(cohort) via the streaming
            # sampler instead of RandomState.choice's [n_total]
            # permutation (still a pure function of the round index)
            silos = sample_ids_streaming(
                np.random.default_rng((1000, self.round_idx)),
                n_total, len(cohort))
        else:
            rs = np.random.RandomState(1000 + self.round_idx)
            silos = rs.choice(n_total, len(cohort), replace=False)
        for i, did in enumerate(cohort):
            msg = Message(msg_type, self.rank, did)
            msg.add_params(DeviceMessage.ARG_MODEL_FILE, path)
            msg.add_params(DeviceMessage.ARG_ROUND_IDX, self.round_idx)
            msg.add_params(DeviceMessage.ARG_DATA_SILO_IDX, int(silos[i]))
            self.send_message(msg)

    def _arm_timer(self, seconds: float) -> None:
        """(Re-)arm the round timer. ``Timer.cancel()`` is a no-op once the
        callback has started, so a leash timer that already fired and is
        blocked on the lock cannot be cancelled — the generation counter
        lets such a stale callback recognize it was superseded (e.g. by the
        tight straggler timer) and bail instead of closing the round."""
        if self._timer is not None:
            self._timer.cancel()
        self._timer_gen += 1
        this_round, this_gen = self.round_idx, self._timer_gen
        self._timer = threading.Timer(
            seconds, lambda: self._on_round_timeout(this_round, this_gen))
        self._timer.daemon = True
        self._timer.start()

    def handle_device_model(self, msg: Message) -> None:
        did = int(msg.get(DeviceMessage.ARG_DEVICE_ID))
        # peer-supplied fields: a bad message is dropped, not raised — a
        # handler exception would kill the receive loop (one malicious peer
        # must not take the server down). TypeError covers a missing path
        # (confine_path(None)); ValueError covers escape attempts, a bad
        # magic, and non-numeric round indices.
        try:
            path = confine_path(msg.get(DeviceMessage.ARG_MODEL_FILE),
                                self.cache_dir)
            # validate the artifact NOW (existence + magic header only —
            # aggregate() does the full parse once), not at aggregate()
            # time where a failure would crash the round-closing thread
            check_model_magic(path)
            msg_round = int(msg.get(DeviceMessage.ARG_ROUND_IDX,
                                    self.round_idx))
        except (TypeError, ValueError, OSError) as e:
            logger.warning("server: dropping model from device %d: %s",
                           did, e)
            return
        with self._lock:
            # a straggler's model for an already-closed round must not
            # fold into the current round (same stale-round rule as the
            # FA server). _round_closed covers the window where the timer
            # closed the round but round_idx has not advanced yet.
            if self._round_closed or msg_round != self.round_idx:
                logger.warning(
                    "server: dropping stale round model from device %d",
                    did)
                return
            self.aggregator.add_device_result(
                did, path,
                float(msg.get(DeviceMessage.ARG_NUM_SAMPLES, 1.0)))
            if self.cohort_enabled and self._dispatch_ts > 0:
                # dispatch→upload wall clock: the utility scorer's
                # system-latency signal and the pacer's raw material
                self.stats.record_latency(did,
                                          time.time() - self._dispatch_ts)
            acc = msg.get(DeviceMessage.ARG_DEVICE_EVAL_ACC)
            if acc is not None:  # on-device eval of the global model
                self._device_accs[did] = float(acc)
            if not self.aggregator.all_received():
                deadline = self._round_deadline_s()
                if (deadline > 0
                        and len(self.aggregator.model_files) == 1):
                    # first arrival: swap the dead-round leash for the
                    # tight straggler timeout
                    self._arm_timer(deadline)
                return
            self._finish_collect_locked()
        self._advance_round()

    def _on_round_timeout(self, armed_round: int, armed_gen: int) -> None:
        with self._lock:
            if (self.round_idx != armed_round or self._round_closed
                    or self._timer_gen != armed_gen):
                return  # round completed or timer re-armed in the meantime
            n = len(self.aggregator.model_files)
            logger.warning(
                "device server round %d: timeout with %d/%d device models "
                "— %s", self.round_idx, n, self.aggregator.client_num,
                "aggregating the devices that reported" if n
                else "no device reported; keeping the previous global model")
            self._finish_collect_locked()
        self._advance_round()

    def _finish_collect_locked(self) -> None:
        self._round_closed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self.cohort_enabled and self._cohort:
            # the round's outcome feeds the control plane BEFORE
            # aggregate() clears the report table: availability evidence
            # per dispatched device (reported vs not — the Beta dropout
            # posterior), then the pacer's deadline/over-sample step
            reported = set(self.aggregator.model_files)
            for did in self._cohort:
                self.stats.record_availability(did,
                                               participated=did in reported)
            # the pacer measures delivery against the round's BARRIER
            # (the wanted k), not the over-sampled dispatch width — a
            # round that closed on k early reports is a SUCCESS even
            # though the straggler slack never reported (Bonawitz pace
            # steering: the slack exists to be discarded)
            self.pacer.observe_round(
                completed=len(reported),
                expected=self._barrier,
                wall_s=max(time.time() - self._dispatch_ts, 0.0))
            # cohort-size adaptation (pacer_adapt_cohort; no-op off):
            # the assembled cohort's aggregate utility is the
            # saturation signal that grows/shrinks the live k
            self.pacer.observe_utility(self._round_utility)
            if self.fleet is not None:
                # close the fleet round: claims released, participation
                # recorded for the devices that actually served,
                # last_heard refreshed
                served = sorted(reported)
                self.fleet.release(self.fleet_task, self.round_idx,
                                   served)
                if served:
                    self.fleet.touch(served)
        self._t_marks["close"] = time.perf_counter()
        self.aggregator.aggregate()
        if self.aggregator.device.type == "cuda":
            # the aggregate's time, not its enqueue
            torch.cuda.synchronize(self.aggregator.device)
        self._t_marks["aggregated"] = time.perf_counter()

    def _advance_round(self) -> None:
        stats = self.aggregator.test_on_server()
        m = self._t_marks
        self.round_times.append({
            "round": self.round_idx,
            "wait_s": m["close"] - m.get("dispatch", m["close"]),
            "aggregate_s": m["aggregated"] - m["close"],
            "eval_s": time.perf_counter() - m["aggregated"]})
        rec = {"round": self.round_idx}
        if stats:
            rec.update(stats)
            logger.info("server round %d: %s", self.round_idx, stats)
        if self._device_accs:  # on-device evals of this round's global
            rec["device_eval_acc"] = (sum(self._device_accs.values())
                                      / len(self._device_accs))
            rec["device_eval_count"] = len(self._device_accs)
            self._device_accs = {}
        self.history.append(rec)
        mlops.log_round_info(self.round_num, self.round_idx)
        self.round_idx += 1
        if self.fleet is not None and self.cohort_enabled:
            self._fleet_save()
        if self.round_idx >= self.round_num:
            self.finish_session()
            return
        self._dispatch_round(DeviceMessage.MSG_TYPE_S2D_SYNC)

    def finish_session(self) -> None:
        for did in sorted(self.devices_online):
            self.send_message(Message(DeviceMessage.MSG_TYPE_S2D_FINISH,
                                      self.rank, did))
        last_eval = next((r for r in reversed(self.history)
                          if "test_acc" in r), {})
        self.result = {"params": self.aggregator.global_params,
                       "history": self.history,
                       "round_times": list(self.round_times),
                       "final_test_acc": last_eval.get("test_acc"),
                       "rounds": self.round_num}
        mlops.log_aggregation_status("FINISHED")
        self.finish()
