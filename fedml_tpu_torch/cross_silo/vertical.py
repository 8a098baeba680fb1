"""Classical vertical FL as a distributed session over the comm stack
(counterpart of ``fedml_tpu/cross_silo/vertical.py``): parties hold
disjoint feature slices of the same samples; the label party (rank 0)
schedules the batches, sums the logit contributions and returns only
d(loss)/d(logits) to each party.

The joint gradient factors through d(loss)/d(total logits), the one
tensor that crosses the party boundary, so the session equals the SP
simulator (:mod:`fedml_tpu_torch.simulation.sp.vertical_fl`) up to float
rounding. The server sums the contributions in rank order, as the SP
simulator sums them in party order.

Ordering: every server -> party broadcast carries ``K_SEQ``, one number
per broadcast from a single counter; parties replay the server's order
exactly, so a transport that reorders back-to-back sends (TCP opens a
connection per message) cannot make a party apply a gradient against the
wrong batch.

Privacy boundary: features never leave a party; labels never leave the
server; only logit contributions (forward) and the shared logit gradient
(backward) cross.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..simulation.sp.split_nn import masked_ce, sgd_
from ..simulation.sp.vertical_fl import (_PartyNet, accuracy_counts,
                                         party_init, party_slices, pool_test,
                                         pool_train)
from .split_learning import from_wire, host_array

logger = logging.getLogger(__name__)


class VFLMsg:
    # party -> server
    P2S_ONLINE = 201
    P2S_CONTRIB = 202       # logit contribution for the current batch
    P2S_EVAL_CONTRIB = 203  # logit contribution over the test set
    # server -> party
    S2P_BATCH = 211         # sample indices of the next batch
    S2P_GRAD = 212          # d(loss)/d(total_logits) for that batch
    S2P_EVALUATE = 213
    S2P_FINISH = 214

    K_IDX = "batch_idx"
    K_LOGITS = "logits"
    K_GRAD = "dlogits"
    K_ROUND = "round_idx"
    K_SEQ = "seq"  # the server's total order; parties replay it exactly


class VFLServerManager(FedMLCommManager):
    """Rank 0, the label party: holds labels and mask only, draws the batch
    schedule (the SP simulator's ``RandomState`` stream), sums the
    contributions and broadcasts the logit gradient."""

    def __init__(self, args, fed, comm=None, rank: int = 0, size: int = 0,
                 backend: str = "INPROC", *, device):
        super().__init__(args, comm, rank, size, backend)
        self.device = torch.device(device)
        self.party_num = size - 1
        x, y, m = pool_train(fed)
        self.y = torch.from_numpy(y).to(self.device)
        self.mask = torch.from_numpy(m).to(self.device)
        _, ty, tm = pool_test(fed, x.shape[1])
        self.test_y = torch.from_numpy(ty).to(self.device)
        self.test_mask = torch.from_numpy(tm).to(self.device)
        self.n = int(y.shape[0])
        self.bs = int(args.batch_size)
        self.steps = max(self.n // self.bs, 1)
        self.rounds = int(getattr(args, "comm_round", 1))
        self.freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        self._rng = np.random.RandomState(
            int(getattr(args, "random_seed", 0)))
        self.round_idx = 0
        self.step_idx = 0
        self._perm: Optional[np.ndarray] = None
        self._cur_idx: Optional[np.ndarray] = None
        self._online: List[int] = []
        self._contribs: Dict[int, torch.Tensor] = {}
        self._eval_contribs: Dict[int, torch.Tensor] = {}
        self._out_seq = 0  # one counter over every broadcast
        self.history: List[Dict[str, Any]] = []
        self.result: Optional[dict] = None

    def _total(self, contribs: Dict[int, torch.Tensor]) -> torch.Tensor:
        total = None
        for r in sorted(contribs):
            total = contribs[r] if total is None else total + contribs[r]
        return total

    # --- FSM ----------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(VFLMsg.P2S_ONLINE,
                                              self._on_online)
        self.register_message_receive_handler(VFLMsg.P2S_CONTRIB,
                                              self._on_contrib)
        self.register_message_receive_handler(VFLMsg.P2S_EVAL_CONTRIB,
                                              self._on_eval_contrib)

    def _on_online(self, msg: Message) -> None:
        rank = msg.get_sender_id()
        if rank not in self._online:
            self._online.append(rank)
        logger.info("vfl server: %d/%d parties online", len(self._online),
                    self.party_num)
        if len(self._online) >= self.party_num:
            self._online.sort()
            self._start_round()

    def _start_round(self) -> None:
        self._perm = self._rng.permutation(self.n)
        self.step_idx = 0
        self._send_batch()

    def _broadcast(self, msg_type, **params) -> None:
        """One logical broadcast = one seq number."""
        seq = self._out_seq
        self._out_seq += 1
        for rank in self._online:
            m = Message(msg_type, self.rank, rank)
            for key, val in params.items():
                m.add_params(key, val)
            m.add_params(VFLMsg.K_SEQ, seq)
            self.send_message(m)

    def _send_batch(self) -> None:
        idx = self._perm[self.step_idx * self.bs:
                         (self.step_idx + 1) * self.bs]
        self._contribs = {}
        self._cur_idx = idx
        self._broadcast(VFLMsg.S2P_BATCH, **{
            VFLMsg.K_IDX: np.asarray(idx),
            VFLMsg.K_ROUND: self.round_idx})

    def _on_contrib(self, msg: Message) -> None:
        self._contribs[msg.get_sender_id()] = from_wire(
            msg.get(VFLMsg.K_LOGITS), self.device)
        if len(self._contribs) < self.party_num:
            return
        total = self._total(self._contribs).requires_grad_()
        idx = torch.from_numpy(np.asarray(self._cur_idx)).to(self.device)
        loss, _, _ = masked_ce(total, self.y[idx], self.mask[idx])
        (dlogits,) = torch.autograd.grad(loss, [total])
        self._broadcast(VFLMsg.S2P_GRAD,
                        **{VFLMsg.K_GRAD: host_array(dlogits)})
        self.step_idx += 1
        if self.step_idx < self.steps:
            self._send_batch()
            return
        # round complete (freq <= 0: never evaluate in-loop)
        if self.freq > 0 and (self.round_idx % self.freq == 0
                              or self.round_idx == self.rounds - 1):
            self._eval_contribs = {}
            self._broadcast(VFLMsg.S2P_EVALUATE)
            return
        self.history.append({"round": self.round_idx})
        self._advance()

    def _on_eval_contrib(self, msg: Message) -> None:
        self._eval_contribs[msg.get_sender_id()] = from_wire(
            msg.get(VFLMsg.K_LOGITS), self.device)
        if len(self._eval_contribs) < self.party_num:
            return
        correct, count = accuracy_counts(self._total(self._eval_contribs),
                                         self.test_y, self.test_mask)
        acc = correct / max(count, 1.0)
        logger.info("vfl server round %d: acc=%.4f", self.round_idx, acc)
        self.history.append({"round": self.round_idx, "test_acc": acc})
        self._advance()

    def _advance(self) -> None:
        self.round_idx += 1
        if self.round_idx >= self.rounds:
            self._broadcast(VFLMsg.S2P_FINISH)
            last = next((r for r in reversed(self.history)
                         if "test_acc" in r), {})
            self.result = {"history": self.history,
                           "final_test_acc": last.get("test_acc"),
                           "rounds": self.rounds}
            self.finish()
            return
        self._start_round()


class VFLPartyManager(FedMLCommManager):
    """Rank k >= 1: holds feature slice ``k - 1``; applies the shared logit
    gradient through its own net. Its parameters never leave."""

    def __init__(self, args, fed, comm=None, rank: int = 1, size: int = 0,
                 backend: str = "INPROC", *, device,
                 init_params: Optional[Sequence[Dict[str, Any]]] = None):
        super().__init__(args, comm, rank, size, backend)
        self.device = torch.device(device)
        self.party_num = size - 1
        x, _, _ = pool_train(fed)
        feat = x.shape[1]
        k = self.rank - 1
        s, e = party_slices(feat, self.party_num)[k]
        self.x = torch.from_numpy(np.ascontiguousarray(x[:, s:e])).to(
            self.device)
        tx, _, _ = pool_test(fed, feat)
        self.test_x = torch.from_numpy(np.ascontiguousarray(tx[:, s:e])).to(
            self.device)
        self.net = _PartyNet(e - s, fed.num_classes)
        self.params = party_init(args, k, self.party_num, self.net,
                                 self.device, init_params)
        self.lr = float(args.learning_rate)
        self._cur_idx: Optional[torch.Tensor] = None
        # in-order delivery: out-of-order arrivals wait here
        self._pending: Dict[int, tuple] = {}
        self._next_seq = 0

    def register_message_receive_handlers(self) -> None:
        for t, h in ((VFLMsg.S2P_BATCH, self._on_batch),
                     (VFLMsg.S2P_GRAD, self._on_grad),
                     (VFLMsg.S2P_EVALUATE, self._on_evaluate),
                     (VFLMsg.S2P_FINISH, self._on_finish)):
            self.register_message_receive_handler(
                t, functools.partial(self._in_order, h))

    def _in_order(self, handler, msg: Message) -> None:
        """Process the server's messages strictly in its send order."""
        seq = msg.get(VFLMsg.K_SEQ)
        if seq is None:  # a direct (non-broadcast) message: run it now
            handler(msg)
            return
        self._pending[int(seq)] = (handler, msg)
        while self._next_seq in self._pending:
            h, m = self._pending.pop(self._next_seq)
            self._next_seq += 1
            h(m)

    def run(self) -> None:
        self.send_message(Message(VFLMsg.P2S_ONLINE, self.rank, 0))
        super().run()

    @torch.no_grad()
    def _on_batch(self, msg: Message) -> None:
        self._cur_idx = from_wire(msg.get(VFLMsg.K_IDX), self.device)
        c = functional_call(self.net, self.params, (self.x[self._cur_idx],))
        out = Message(VFLMsg.P2S_CONTRIB, self.rank, 0)
        out.add_params(VFLMsg.K_LOGITS, host_array(c))
        self.send_message(out)

    def _on_grad(self, msg: Message) -> None:
        dlogits = from_wire(msg.get(VFLMsg.K_GRAD), self.device)
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self.params.items()}
        c = functional_call(self.net, leaves, (self.x[self._cur_idx],))
        grads = torch.autograd.grad(c, list(leaves.values()),
                                    grad_outputs=dlogits)
        sgd_(self.params, grads, self.lr)

    @torch.no_grad()
    def _on_evaluate(self, msg: Message) -> None:
        c = functional_call(self.net, self.params, (self.test_x,))
        out = Message(VFLMsg.P2S_EVAL_CONTRIB, self.rank, 0)
        out.add_params(VFLMsg.K_LOGITS, host_array(c))
        self.send_message(out)

    def _on_finish(self, msg: Message) -> None:
        logger.info("vfl party rank %d: finish", self.rank)
        self.finish()


def run_vfl_inproc(args, fed, device=None,
                   init_params: Optional[Sequence[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
    """Server + ``party_num`` feature parties as threads over the in-proc
    broker, on ``device`` (CUDA unless ``"cpu"``); ``init_params`` is one
    state dict per party. The result adds each party's final
    parameters (``party_params``, in party order)."""
    from ..device import get_device
    from . import run_inproc_session
    device = get_device(device)
    n = int(getattr(args, "party_num", 2) or 2)
    parties: List[VFLPartyManager] = []

    def build():
        parties.extend(
            VFLPartyManager(args, fed, rank=r, size=n + 1, backend="INPROC",
                            device=device, init_params=init_params)
            for r in range(1, n + 1))
        return [VFLServerManager(args, fed, size=n + 1, backend="INPROC",
                                 device=device), *parties]

    result = run_inproc_session(args, build)
    if result is not None:
        result["party_params"] = [p.params for p in parties]
    return result
