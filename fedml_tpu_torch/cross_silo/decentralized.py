"""Decentralized (gossip) FL as a distributed runtime with no server
(counterpart of ``fedml_tpu/cross_silo/decentralized.py``): every node
trains locally and exchanges parameters with its topology neighbors as
Messages over the comm stack (INPROC threads, TCP, gRPC, ...).

Each node derives the same row-stochastic mixing matrix from the
deterministic topology manager, ships its trained parameters to every
neighbor, and applies ``p_i <- sum_j W[i,j] p_j`` once every neighbor's
parameters for the round have arrived: early rounds wait in ``_inbox``,
so a fast neighbor can run a round ahead. The mix accumulates in
float32, own term first, then the neighbors in ascending rank, and casts
back to each leaf's dtype. The SP simulator
(:mod:`fedml_tpu_torch.simulation.sp.decentralized`) mixes the same round
in one contraction, so the two agree up to float reassociation.

A node trains through
:class:`~fedml_tpu_torch.cross_silo.client.trainer.SiloTrainer` (plain
FedAvg local SGD, key ``fold_in(fold_in(rng, round), rank)``): on a card
its step is one CUDA graph, captured at round 0 and replayed per step, so
with ``fused_conv_block`` on the fused block kernel runs inside it.

``gossip_compression`` (a ``comm_compression`` method; ratio and levels
from ``comm_compression_ratio`` / ``comm_quantize_levels``): after a dense
round 0, a node ships one error-feedback compressed delta per round
against its own previous broadcast reconstruction; receivers keep a
reconstruction per sender and decode in round order at mix time (the
compression key is ``fold_in(PRNGKey(seed + 131), rank)``, folded with
the round).

Rank 0 reports the session: after the last round every node sends it its
final model; it publishes the average model's accuracy and the consensus
distance. Under injected link faults a resend loop retransmits the recent
rounds' wires whenever progress stalls (receivers are idempotent).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import prng
from ..core.algframe.client_trainer import make_trainer_spec
from ..core.chaos import FaultPlan
from ..core.distributed.communication.backoff import (backoff_delays,
                                                      retry_with_backoff)
from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..core.kernels import launch_counts
from ..core.wire import decode_update, encode_update
from ..optimizers.registry import create_optimizer
from ..simulation.gpu.engine import load_params
from ..simulation.sp.decentralized import (consensus_distance, mixing_matrix,
                                           node_average)
from ..utils.compression import CommCompressionSpec, is_compressed_payload
from .client.trainer import SiloTrainer
from .wire import params_to_vec, params_to_wire, vec_to_params, wire_to_params

logger = logging.getLogger(__name__)


class GossipMsg:
    N2N_PARAMS = 301   # trained params -> each neighbor, tagged with round
    N2Z_FINAL = 302    # final params -> rank 0 for the session result
    Z2N_FINISH = 303   # rank 0 -> all: session done

    K_PARAMS = "params"
    K_ROUND = "round_idx"


class GossipNodeManager(FedMLCommManager):
    """One gossip node (rank == node index == data silo index), on
    ``device``, starting from ``init_params`` (a state dict) or the
    bundle's seeded init."""

    def __init__(self, args, fed, bundle, comm=None, rank: int = 0,
                 size: int = 0, backend: str = "INPROC", *, device,
                 init_params: Optional[Dict[str, Any]] = None, spec=None):
        super().__init__(args, comm, rank, size, backend)
        self.fed = fed
        self.n = size
        self.device = torch.device(device)
        self.rounds = int(getattr(args, "comm_round", 1))
        spec = spec if spec is not None else make_trainer_spec(fed, bundle)
        self.spec = spec
        inner = copy.copy(args)
        inner.federated_optimizer = "FedAvg"  # the local step is plain SGD
        self.trainer = SiloTrainer(inner, fed, bundle, spec,
                                   create_optimizer(inner, spec),
                                   self.device)
        self.W = mixing_matrix(args, self.n)
        # peers i mixes FROM (row) == peers that need i's params (symmetric)
        self.neighbors = sorted(
            j for j in range(self.n)
            if self.W[self.rank, j] > 0 and j != self.rank)
        self._w_self = np.float32(self.W[self.rank, self.rank])
        self._neighbor_w = [np.float32(self.W[self.rank, j])
                            for j in self.neighbors]
        seed = int(getattr(args, "random_seed", 0))
        if init_params is None:
            # the trainer's template is the bundle's seeded init (drawing
            # it again would draw into the module, now on the device)
            p0 = {k: v.clone()
                  for k, v in self.trainer.params_template.items()}
        else:
            p0 = load_params(bundle, init_params, self.device)
        self.params = p0
        self._template = p0
        self.cid = min(self.rank, fed.num_clients - 1)
        self.round_idx = 0
        # round -> {sender: wire}; buffers early arrivals from fast peers
        self._inbox: Dict[int, Dict[int, Any]] = {}
        self._trained: Optional[Dict[str, torch.Tensor]] = None
        self._finals: Dict[int, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self.result: Optional[dict] = None
        # one record per round: steps; train, send (encode + sends), wait,
        # decode and mix seconds; the wall clock at its start and end
        # (comparable across processes)
        self.log: List[Dict[str, Any]] = []
        self._sent_at = 0.0
        self._eval_fn = None
        self.launches_before_eval = self.eval_launches = None
        # chaos tolerance: gossip has no server to time out a round, so a
        # lost N2N_PARAMS frame would deadlock both endpoints; under
        # injected link faults a monitor thread retransmits recent rounds
        self.chaos_plan = FaultPlan.from_args(args)
        self._stop_resend = threading.Event()
        self._sent_wires: Dict[int, Any] = {}  # recent rounds' own wires
        self._final_wire: Optional[Any] = None
        method = getattr(args, "gossip_compression", None)
        self.gc_spec: Optional[CommCompressionSpec] = None
        if method:
            self.gc_spec = CommCompressionSpec(
                method=str(method),
                ratio=float(getattr(args, "comm_compression_ratio", 0.1)),
                levels=int(getattr(args, "comm_quantize_levels", 127)))
        self._gc_sent_recon: Optional[np.ndarray] = None  # neighbors' copy
        self._gc_residual: Optional[np.ndarray] = None
        self._gc_recv_recon: Dict[int, np.ndarray] = {}   # my copy of each
        self._gc_rng = prng.fold_in(prng.PRNGKey(seed + 131), self.rank)

    def _mix(self, own, neighbor_params):
        """``W[i,i] * own + sum_j W[i,j] * p_j`` in float32, neighbors in
        ascending rank, cast back to ``own``'s dtypes; each step one
        multi-tensor launch over all leaves."""
        keys = list(own)
        acc = torch._foreach_mul([own[k].float() for k in keys],
                                 float(self._w_self))
        for pj, w in zip(neighbor_params, self._neighbor_w):
            torch._foreach_add_(acc, torch._foreach_mul(
                [pj[k].float() for k in keys], float(w)))
        return {k: a.to(own[k].dtype) for k, a in zip(keys, acc)}

    # --- FSM ----------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(GossipMsg.N2N_PARAMS,
                                              self._on_params)
        self.register_message_receive_handler(GossipMsg.N2Z_FINAL,
                                              self._on_final)
        self.register_message_receive_handler(GossipMsg.Z2N_FINISH,
                                              self._on_finish)

    def run(self) -> None:
        self.register_message_receive_handlers()
        if self.chaos_plan.injects_link_faults:
            threading.Thread(target=self._resend_loop, daemon=True).start()
        try:
            self._kick_round()
            self.com_manager.handle_receive_message()
        finally:
            self._stop_resend.set()

    def _kick_round(self) -> None:
        """Train locally and ship the trained params to every neighbor."""
        start_t = time.time()
        t0 = time.perf_counter()
        self._trained, _, _ = self.trainer.train(
            self.params, self.cid, self.round_idx, key_index=self.rank)
        train_s = time.perf_counter() - t0
        self.log.append({"round": self.round_idx,
                         "steps": self.trainer.log[-1]["steps"],
                         "train_s": train_s, "start_t": start_t})
        t0 = time.perf_counter()
        if self.gc_spec is not None and self._gc_sent_recon is not None:
            # compressed rounds: the EF-compressed delta of this round's
            # params against what the neighbors hold; our tracked copy
            # advances by decoding our own blob, as every receiver does
            enc = encode_update(
                params_to_vec(self._trained), base=self._gc_sent_recon,
                spec=self.gc_spec, residual=self._gc_residual,
                rng=prng.fold_in(self._gc_rng, self.round_idx),
                msg_type=GossipMsg.N2N_PARAMS)
            self._gc_residual = enc.residual
            self._gc_sent_recon = decode_update(enc.payload,
                                                base=self._gc_sent_recon)
            wire = enc.payload
        else:
            wire = params_to_wire(self._trained)
            if self.gc_spec is not None:
                # dense seed round: every neighbor now holds exactly this
                self._gc_sent_recon = params_to_vec(self._trained)
        # retransmission cache: a slow neighbor may still need our round-r
        # params after we advanced (its copy was lost)
        self._sent_wires[self.round_idx] = wire
        for r in sorted(self._sent_wires):
            if r < self.round_idx - 2:
                del self._sent_wires[r]
        for j in self.neighbors:
            m = Message(GossipMsg.N2N_PARAMS, self.rank, j)
            m.add_params(GossipMsg.K_PARAMS, wire)
            m.add_params(GossipMsg.K_ROUND, self.round_idx)
            self._send_with_retry(m)
        self._sent_at = time.perf_counter()
        self.log[-1]["send_s"] = self._sent_at - t0
        self._try_mix()

    def _resend_loop(self) -> None:
        """Chaos-link tolerance: when no progress happens for a (jittered,
        backoff-growing) interval, retransmit the cached recent rounds'
        wires to every neighbor (and a finished node's final model to rank
        0); fresh sends draw fresh link-fault decisions."""
        def fresh():
            return backoff_delays(base_s=0.5, factor=2.0, max_s=4.0,
                                  seed=(self.rank + 1) * 7919)

        delays = fresh()
        marker = None
        while not self._stop_resend.wait(next(delays)):
            cur = (self.round_idx, len(self._inbox.get(self.round_idx, {})),
                   self._final_wire is not None, len(self._finals))
            if cur != marker:
                marker = cur
                delays = fresh()
                continue
            try:
                # a snapshot: _kick_round trims the dict on the main thread
                for r, wire in sorted(list(self._sent_wires.items())):
                    for j in self.neighbors:
                        m = Message(GossipMsg.N2N_PARAMS, self.rank, j)
                        m.add_params(GossipMsg.K_PARAMS, wire)
                        m.add_params(GossipMsg.K_ROUND, r)
                        self.send_message(m)
                if self._final_wire is not None and self.rank != 0:
                    m = Message(GossipMsg.N2Z_FINAL, self.rank, 0)
                    m.add_params(GossipMsg.K_PARAMS, self._final_wire)
                    self.send_message(m)
                logger.info("gossip node %d: stalled at round %d, "
                            "retransmitted params to neighbors", self.rank,
                            self.round_idx)
            except Exception as e:
                logger.debug("gossip node %d resend failed: %s", self.rank,
                             e)

    def _send_with_retry(self, msg: Message, timeout_s: float = 60.0) -> None:
        """Nodes come up at their own pace and no server sequences the
        start: a send retries until the neighbor's listener is reachable."""
        retry_with_backoff(
            lambda: self.send_message(msg),
            max_attempts=1_000_000,  # deadline-bound, not attempt-bound
            base_s=0.2, max_s=2.0, deadline_s=timeout_s,
            describe=f"gossip node {self.rank} send to "
                     f"{msg.get_receiver_id()}")

    def _on_params(self, msg: Message) -> None:
        r = int(msg.get(GossipMsg.K_ROUND))
        if r < self.round_idx:
            return  # a stale retransmission of a round already mixed
        # the raw wire waits and is decoded at mix time: compressed deltas
        # form a per-sender chain applied in round order exactly once
        self._inbox.setdefault(r, {})[msg.get_sender_id()] = msg.get(
            GossipMsg.K_PARAMS)
        self._try_mix()

    def _decode_neighbor(self, sender: int, wire):
        """Inbox wire -> params, advancing the per-sender reconstruction
        when the sender ships compressed deltas."""
        if is_compressed_payload(wire):
            base = self._gc_recv_recon.get(sender)
            if base is None:
                raise RuntimeError(
                    f"gossip node {self.rank}: compressed params from "
                    f"{sender} before its dense seed round")
            vec = decode_update(wire, base=base)
            self._gc_recv_recon[sender] = vec
            return vec_to_params(vec, self._template)
        params = wire_to_params(wire, self._template)
        if self.gc_spec is not None:
            self._gc_recv_recon[sender] = params_to_vec(params)
        return params

    def _try_mix(self) -> None:
        box = self._inbox.get(self.round_idx, {})
        if self._trained is None or len(box) < len(self.neighbors):
            return
        t0 = time.perf_counter()
        ordered = [self._decode_neighbor(j, box[j]) for j in sorted(box)]
        t1 = time.perf_counter()
        self.params = self._mix(self._trained, ordered)
        if self.device.type == "cuda":
            # this thread's stream only: a device-wide synchronize would
            # also wait on another node thread's stream while it captures
            # its step (thread-local capture), and invalidate the capture
            torch.cuda.current_stream(self.device).synchronize()
        self.log[-1].update(wait_s=t0 - self._sent_at, decode_s=t1 - t0,
                            mix_s=time.perf_counter() - t1,
                            end_t=time.time())
        del self._inbox[self.round_idx]
        self._trained = None
        if self.rank == 0 and self.round_idx < self.rounds - 1:
            # the last round's record is the final report's
            self.history.append({"round": self.round_idx})
        self.round_idx += 1
        if self.round_idx >= self.rounds:
            self._finalize()
            return
        self._kick_round()

    def _finalize(self) -> None:
        if self.rank != 0:
            self._final_wire = params_to_wire(self.params)
            m = Message(GossipMsg.N2Z_FINAL, self.rank, 0)
            m.add_params(GossipMsg.K_PARAMS, self._final_wire)
            self.send_message(m)
            return  # wait for FINISH (the resend loop replays a lost one)
        self._finals[0] = self.params
        self._maybe_report()

    def _on_final(self, msg: Message) -> None:
        self._finals[msg.get_sender_id()] = wire_to_params(
            msg.get(GossipMsg.K_PARAMS), self._template)
        self._maybe_report()

    def eval_fn(self):
        """The average model's evaluation on the test set (its
        ``batches`` attribute: forward passes per evaluation)."""
        if self._eval_fn is None:
            from .horizontal.runner import _make_eval_fn
            self._eval_fn = _make_eval_fn(self.spec, self.fed, self.device)
        return self._eval_fn

    def _maybe_report(self) -> None:
        if self.rank != 0 or len(self._finals) < self.n:
            return
        if self.result is not None:
            return  # a duplicated final frame after the report went out
        stacked = {k: torch.stack([self._finals[i][k]
                                   for i in range(self.n)])
                   for k in self._template}
        avg = node_average(stacked)
        before = launch_counts()
        acc = self.eval_fn()(avg)["test_acc"]
        # the kernel launches before node 0's evaluation and within it
        self.launches_before_eval = before
        self.eval_launches = {k: v - before[k]
                              for k, v in launch_counts().items()}
        consensus = consensus_distance(stacked)
        logger.info("gossip session: avg-model acc=%.4f consensus=%.4f",
                    acc, consensus)
        self.history.append({"round": self.rounds - 1, "test_acc": acc,
                             "consensus_dist": consensus})
        self.result = {"params": avg, "history": self.history,
                       "final_test_acc": acc,
                       "consensus_dist": consensus, "rounds": self.rounds}
        for j in range(1, self.n):
            self.send_message(Message(GossipMsg.Z2N_FINISH, self.rank, j))
        self.finish()

    def _on_finish(self, msg: Message) -> None:
        logger.info("gossip node %d: finish", self.rank)
        self.finish()


def run_gossip_inproc(args, fed, bundle, device=None,
                      init_params: Optional[Dict[str, Any]] = None,
                      spec=None) -> Dict[str, Any]:
    """All ``client_num_in_total`` gossip nodes as threads over the
    in-proc broker, on ``device`` (CUDA unless ``"cpu"``); node 0 reports
    the session result. Each node gets its own copy of ``bundle``."""
    from ..device import get_device
    from . import run_inproc_session
    device = get_device(device)
    n = int(getattr(args, "client_num_in_total", fed.num_clients))
    return run_inproc_session(args, lambda: [
        GossipNodeManager(args, fed, copy.deepcopy(bundle), rank=r, size=n,
                          backend="INPROC", device=device,
                          init_params=init_params, spec=spec)
        for r in range(n)])
