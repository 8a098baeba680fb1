"""FA over the WAN FSM — cross-silo federated analytics.

Parity target: reference ``fa/cross_silo/`` (the FL cross-silo skeleton
minus models: server broadcasts the round's init message, clients run
``local_analyze`` on their raw local data and ship a *submission*, the
server folds submissions with the ``FAServerAggregator``). Transport is
any ``FedMLCommManager`` backend; the in-proc session helper mirrors the
FL one so an analytics session is testable without a cluster.

Cohort assembly (``cohort_assembly`` knob; off = every online client
analyzes every round, the legacy behavior) rides the SAME machinery as
the training plane: clients report the charging/idle/unmetered
handshake analogues on their ONLINE message, the server sieves
eligibility and streams a utility-scored cohort per round, and Oort's
deadline pacer steers the over-sample. Same handshake, different
payloads — an analytics task is just another tenant of the fleet, and
with ``fleet_registry`` set it registers and claims devices through the
shared :class:`~fedml_tpu.core.fleet.DeviceRegistry` so a concurrent
training task never co-schedules a device.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager

logger = logging.getLogger(__name__)


class FAMessage:
    C2S_ONLINE = "fa_online"
    S2C_INIT = "fa_init"          # round start: init_msg + round idx
    C2S_SUBMISSION = "fa_submission"
    S2C_FINISH = "fa_finish"

    KEY_INIT = "init_msg"
    KEY_ROUND = "round"
    KEY_SUBMISSION = "submission"
    KEY_ELIGIBILITY = "eligibility"  # handshake dict on C2S_ONLINE


class FAClientManager(FedMLCommManager):
    """One analytics party: raw local data + a client analyzer."""

    def __init__(self, args, analyzer, local_data: Sequence, comm=None,
                 rank: int = 1, size: int = 0, backend: str = "INPROC",
                 eligibility: Optional[dict] = None):
        super().__init__(args, comm, rank, size, backend)
        self.analyzer = analyzer
        self.local_data = local_data
        # charging/idle/unmetered analogues, reported on the handshake
        # (absent keys default True server-side — same convention as the
        # training plane's DeviceMessage handshake)
        self.eligibility = dict(eligibility or {})

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(FAMessage.S2C_INIT,
                                              self.on_init)
        self.register_message_receive_handler(FAMessage.S2C_FINISH,
                                              self.on_finish)

    def run(self) -> None:
        self.register_message_receive_handlers()
        online = Message(FAMessage.C2S_ONLINE, self.rank, 0)
        online.add_params(FAMessage.KEY_ELIGIBILITY, self.eligibility)
        self.send_message(online)
        self.com_manager.handle_receive_message()

    def on_init(self, msg: Message) -> None:
        self.analyzer.set_init_msg(msg.get(FAMessage.KEY_INIT))
        submission = self.analyzer.local_analyze(self.local_data, self.args)
        out = Message(FAMessage.C2S_SUBMISSION, self.rank, 0)
        out.add_params(FAMessage.KEY_SUBMISSION, submission)
        out.add_params(FAMessage.KEY_ROUND, msg.get(FAMessage.KEY_ROUND))
        self.send_message(out)

    def on_finish(self, msg: Message) -> None:
        self.finish()


class FAServerManager(FedMLCommManager):
    def __init__(self, args, aggregator, comm=None, rank: int = 0,
                 size: int = 0, backend: str = "INPROC"):
        super().__init__(args, comm, rank, size, backend)
        self.aggregator = aggregator
        self.n_clients = size - 1
        self.round_num = int(getattr(args, "comm_round", 1))
        self.round_idx = 0
        # rank -> handshake eligibility meta (empty dict = all-True)
        self.online: Dict[int, Dict] = {}
        # keyed by sender id: a client retry must not count twice, and a
        # late previous-round submission must not fold into this round
        # (mirrors the SecAgg/LSA masked-input bookkeeping)
        self.submissions: Dict[int, Any] = {}
        self.history: List[Any] = []
        self.result: Optional[dict] = None
        self._lock = threading.Lock()
        self._started = False
        # --- cohort assembly (same knob + machinery as the training
        # plane; off = broadcast to every online client, bit-identical)
        self.cohort_enabled = bool(getattr(args, "cohort_assembly", False))
        self.stats = None
        self.assembler = None
        self.pacer = None
        self._cohort: List[int] = []
        self._barrier = self.n_clients
        self._round_k = self.n_clients
        self._round_utility = 0.0
        self._dispatch_ts = 0.0
        self.cohort_log: list = []
        if self.cohort_enabled:
            from ..core.selection import (DeadlinePacer,
                                          StreamingCohortAssembler,
                                          make_stats_store,
                                          required_eligibility)
            population = max(self.n_clients, 1) + 1  # 1-based ranks
            self.stats = make_stats_store(args, population)
            self.assembler = StreamingCohortAssembler(args, self.stats,
                                                      population)
            self.pacer = DeadlinePacer.from_args(args)
            self.required_elig = required_eligibility(args)
            self.cohort_k = int(getattr(args, "cohort_size", 0) or 0) \
                or self.n_clients
        # --- fleet tenancy (fleet_registry knob): the FA task registers
        # its parties and claims its cohorts through the shared registry
        self.fleet = None
        self.fleet_task = str(getattr(args, "fleet_task_id", "") or "fa")
        reg_path = getattr(args, "fleet_registry", None)
        if reg_path:
            from ..core.fleet import DeviceRegistry
            self.fleet = DeviceRegistry(str(reg_path))
            self.fleet_cap = int(getattr(args,
                                         "fleet_max_rounds_per_window", 0)
                                 or 0)
            self.fleet_window_s = float(getattr(
                args, "fleet_fairness_window_s", 3600.0) or 3600.0)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(FAMessage.C2S_ONLINE,
                                              self.on_online)
        self.register_message_receive_handler(FAMessage.C2S_SUBMISSION,
                                              self.on_submission)

    def on_online(self, msg: Message) -> None:
        rank = msg.get_sender_id()
        meta = msg.get(FAMessage.KEY_ELIGIBILITY) or {}
        self.online[rank] = dict(meta) if isinstance(meta, dict) else {}
        if self.fleet is not None:
            self.fleet.register(int(rank), self.online[rank])
        if len(self.online) >= self.n_clients and not self._started:
            self._started = True
            self._start_round()

    def _round_cohort(self) -> List[int]:
        """The parties this round analyzes: every online client
        (legacy), or the streaming-assembled cohort — the training
        plane's eligibility sieve with analytics payloads."""
        online = sorted(self.online)
        if not self.cohort_enabled:
            return online
        from ..core.selection.cohort import eligible_mask
        k = self.pacer.paced_cohort(self.cohort_k)
        self._round_k = k
        target = self.pacer.target_cohort(k, ceiling=len(online))
        ids = np.asarray(online, np.int64)
        metas = [self.online[r] for r in online]
        mask = eligible_mask(metas, self.required_elig)

        def elig(chunk: np.ndarray) -> np.ndarray:
            pos = np.searchsorted(ids, chunk)
            return mask[pos]

        res = self.assembler.assemble(
            self.round_idx, target, [ids], eligible_fn=elig,
            deadline_s=self.pacer.deadline_s,
            over_sample=self.pacer.over_sample)
        cohort = sorted(res.cohort)
        self._round_utility = (float(np.sum(res.scores))
                               if res.scores is not None
                               and len(res.scores) else 0.0)
        if self.fleet is not None and cohort:
            from ..core.obs import metrics as obs_metrics
            granted, busy, capped = self.fleet.claim(
                self.fleet_task, cohort, self.round_idx,
                cap=self.fleet_cap, window_s=self.fleet_window_s)
            obs_metrics.record_fleet_round(self.fleet_task, len(granted),
                                           busy, capped)
            cohort = sorted(granted)
        if not cohort and self.fleet is None:
            logger.warning(
                "fa cohort round %d: no eligible client of %d online — "
                "broadcasting to every online client",
                self.round_idx, len(online))
            cohort = online
        self.stats.record_selected(self.round_idx, cohort)
        self.cohort_log.append((self.round_idx, list(cohort)))
        logger.info("fa cohort round %d: dispatching %d/%d online",
                    self.round_idx, len(cohort), len(online))
        return cohort

    def _start_round(self) -> None:
        init_msg = self.aggregator.get_init_msg()
        cohort = self._round_cohort()
        self._cohort = list(cohort)
        self._barrier = (max(min(self._round_k, len(cohort)), 1)
                         if self.cohort_enabled else self.n_clients)
        self._dispatch_ts = time.time()
        for rank in cohort:
            out = Message(FAMessage.S2C_INIT, 0, rank)
            out.add_params(FAMessage.KEY_INIT, init_msg)
            out.add_params(FAMessage.KEY_ROUND, self.round_idx)
            self.send_message(out)

    def _close_round_locked(self) -> None:
        """Cohort-mode round close under the lock: control-plane
        evidence (availability per dispatched party, dispatch→submit
        latency already recorded, pacer step) + the fleet release."""
        if not self.cohort_enabled or not self._cohort:
            return
        reported = set(self.submissions)
        for rank in self._cohort:
            self.stats.record_availability(rank,
                                           participated=rank in reported)
        self.pacer.observe_round(
            completed=len(reported), expected=self._barrier,
            wall_s=max(time.time() - self._dispatch_ts, 0.0))
        self.pacer.observe_utility(self._round_utility)
        if self.fleet is not None:
            self.fleet.release(self.fleet_task, self.round_idx,
                               sorted(reported))

    def on_submission(self, msg: Message) -> None:
        # the whole round close (aggregate + round_idx advance) stays under
        # the lock: a retransmit arriving mid-aggregation must see the NEW
        # round index, or it would be folded into the next round
        with self._lock:
            if int(msg.get(FAMessage.KEY_ROUND, -1)) != self.round_idx:
                return  # stale round (WAN reorder) / retry — drop
            rank = msg.get_sender_id()
            self.submissions[rank] = msg.get(FAMessage.KEY_SUBMISSION)
            if self.cohort_enabled and self._dispatch_ts > 0:
                self.stats.record_latency(rank,
                                          time.time() - self._dispatch_ts)
            if len(self.submissions) < self._barrier:
                return
            self._close_round_locked()
            subs = [self.submissions[k] for k in sorted(self.submissions)]
            self.submissions = {}
            result = self.aggregator.aggregate(subs)
            self.history.append(result)
            logger.info("fa server round %d done", self.round_idx)
            self.round_idx += 1
            done = self.round_idx >= self.round_num
        if done:
            for rank in sorted(self.online):
                self.send_message(Message(FAMessage.S2C_FINISH, 0, rank))
            self.result = {"result": self.aggregator.get_server_data(),
                           "history": self.history,
                           "rounds": self.round_num}
            self.finish()
            return
        self._start_round()


def run_fa_cross_silo_inproc(args, client_datas: Sequence[Sequence],
                             analyzer_factory, aggregator,
                             eligibility: Optional[Dict[int, dict]] = None
                             ) -> Dict[str, Any]:
    """Server + one FA client per data shard as threads over the in-proc
    broker (the FL session helper's analytics twin). ``eligibility``
    maps rank -> handshake overrides for cohort-assembly sessions."""
    from ..core.distributed.communication.inproc import InProcBroker

    broker = InProcBroker()
    args.inproc_broker = broker
    n = len(client_datas)
    server = FAServerManager(args, aggregator, rank=0, size=n + 1,
                             backend="INPROC")
    clients = [FAClientManager(args, analyzer_factory(), client_datas[i],
                               rank=i + 1, size=n + 1, backend="INPROC",
                               eligibility=(eligibility or {}).get(i + 1))
               for i in range(n)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.run()
    for t in threads:
        t.join(timeout=30.0)
    return server.result
