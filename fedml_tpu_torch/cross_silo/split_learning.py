"""Split learning (SplitNN) as a distributed session over the comm stack
(counterpart of ``fedml_tpu/cross_silo/split_learning.py``): the model is
cut at a layer, and the parties exchange only activations (forward) and
activation gradients (backward) across the process boundary.

The server (rank 0) owns the head and trains the clients round-robin, in
rank order. The active client sends one batch of cut-layer activations
(with its labels and mask) at a time; the server steps its head and
returns d(loss)/d(activations); the client recomputes its cut layer and
takes its step through ``torch.autograd.grad`` with those gradients, so
no autograd graph lives across messages. All-padding batches are skipped
(they are no-op steps in the SP simulator). The result equals the SP
simulator (:mod:`fedml_tpu_torch.simulation.sp.split_nn`) up to float
rounding: the chain rule does not care where the socket sits.

Privacy boundary: raw features never leave the client; labels travel
with the activations (the label-sharing variant, as in the reference).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..simulation.sp.split_nn import (_Bottom, _Top, init_module, masked_ce,
                                      sgd_, split_keys, to_device_params)

logger = logging.getLogger(__name__)


class SplitMsg:
    # client -> server
    C2S_ONLINE = 101
    C2S_ACTS = 102        # one batch of cut-layer activations (+ labels)
    C2S_DONE = 103        # client finished its local epochs
    C2S_EVAL_ACTS = 104   # test-set activations for server-side eval
    # server -> client
    S2C_ACTIVATE = 111    # your turn: run local epochs
    S2C_GRADS = 112       # d(loss)/d(activations) for the batch just sent
    S2C_EVALUATE = 113    # stream your test activations
    S2C_FINISH = 114

    K_ACTS = "acts"
    K_GRADS = "grads"
    K_LABELS = "labels"
    K_MASK = "mask"
    K_ROUND = "round_idx"


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as the host array a Message carries."""
    return t.detach().cpu().numpy()


def from_wire(value, device) -> torch.Tensor:
    """A received array as a tensor on ``device`` (a copy: decoded
    buffers are read-only)."""
    return torch.from_numpy(np.array(value, copy=True)).to(device)


class SplitNNServerManager(FedMLCommManager):
    """Rank 0: owns the head. Builds it from the width of the first
    activation, drawing its init from the top's key (or takes
    ``init_params``, the head's state dict)."""

    def __init__(self, args, output_dim: int, comm=None, rank: int = 0,
                 size: int = 0, backend: str = "INPROC", *, device,
                 init_params: Optional[Dict[str, Any]] = None):
        super().__init__(args, comm, rank, size, backend)
        self.device = torch.device(device)
        self.output_dim = int(output_dim)
        _, self._kt, _ = split_keys(getattr(args, "random_seed", 0))
        self._init_params = init_params
        self.top: Optional[_Top] = None
        self.top_params: Optional[Dict[str, torch.Tensor]] = None
        self.lr = float(args.learning_rate)
        self.rounds = int(getattr(args, "comm_round", 1))
        self.freq = int(getattr(args, "frequency_of_the_test", 5) or 5)
        self.round_idx = 0
        self.client_num = size - 1
        self._online: List[int] = []
        self._active_pos = 0  # index into the sorted client order
        self.history: List[Dict[str, Any]] = []
        self.result: Optional[dict] = None

    def _tensor(self, msg: Message, key: str) -> torch.Tensor:
        return from_wire(msg.get(key), self.device)

    def _ensure_top(self, hidden: int) -> None:
        if self.top is not None:
            return
        self.top = _Top(hidden, self.output_dim)
        if self._init_params is None:
            self.top_params = init_module(self.top, self._kt, self.device)
        else:
            self.top.to(self.device)
            self.top_params = to_device_params(self._init_params,
                                               self.device)

    # --- FSM ----------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(SplitMsg.C2S_ONLINE,
                                              self._on_online)
        self.register_message_receive_handler(SplitMsg.C2S_ACTS,
                                              self._on_acts)
        self.register_message_receive_handler(SplitMsg.C2S_DONE,
                                              self._on_done)
        self.register_message_receive_handler(SplitMsg.C2S_EVAL_ACTS,
                                              self._on_eval_acts)

    def _on_online(self, msg: Message) -> None:
        rank = msg.get_sender_id()
        if rank not in self._online:
            self._online.append(rank)
        logger.info("splitnn server: %d/%d parties online",
                    len(self._online), self.client_num)
        if len(self._online) >= self.client_num:
            self._online.sort()  # round-robin in rank order, as the SP sim
            self._activate(self._online[0])

    def _activate(self, rank: int) -> None:
        m = Message(SplitMsg.S2C_ACTIVATE, self.rank, rank)
        m.add_params(SplitMsg.K_ROUND, self.round_idx)
        self.send_message(m)

    def _on_acts(self, msg: Message) -> None:
        h = self._tensor(msg, SplitMsg.K_ACTS)
        self._ensure_top(int(h.shape[1]))
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self.top_params.items()}
        h = h.requires_grad_()
        logits = functional_call(self.top, leaves, (h,))
        loss, _, _ = masked_ce(logits, self._tensor(msg, SplitMsg.K_LABELS),
                               self._tensor(msg, SplitMsg.K_MASK))
        grads = torch.autograd.grad(loss, list(leaves.values()) + [h])
        sgd_(self.top_params, grads[:-1], self.lr)
        out = Message(SplitMsg.S2C_GRADS, self.rank, msg.get_sender_id())
        out.add_params(SplitMsg.K_GRADS, host_array(grads[-1]))
        self.send_message(out)

    def _on_done(self, msg: Message) -> None:
        self._active_pos += 1
        if self._active_pos < len(self._online):
            self._activate(self._online[self._active_pos])
            return
        self._active_pos = 0
        if self.freq > 0 and (self.round_idx % self.freq == 0
                              or self.round_idx == self.rounds - 1):
            # evaluate with the first party's bottom (the SP sim's client 0)
            self.send_message(Message(SplitMsg.S2C_EVALUATE, self.rank,
                                      self._online[0]))
            return
        self.history.append({"round": self.round_idx})
        self._advance()

    @torch.no_grad()
    def _on_eval_acts(self, msg: Message) -> None:
        h = self._tensor(msg, SplitMsg.K_ACTS)
        self._ensure_top(int(h.shape[1]))
        logits = functional_call(self.top, self.top_params, (h,))
        _, correct, count = masked_ce(
            logits, self._tensor(msg, SplitMsg.K_LABELS),
            self._tensor(msg, SplitMsg.K_MASK))
        acc = float(correct) / max(float(count), 1.0)
        logger.info("splitnn server round %d: acc=%.4f", self.round_idx, acc)
        self.history.append({"round": self.round_idx, "test_acc": acc})
        self._advance()

    def _advance(self) -> None:
        self.round_idx += 1
        if self.round_idx >= self.rounds:
            for rank in self._online:
                self.send_message(Message(SplitMsg.S2C_FINISH, self.rank,
                                          rank))
            last = next((r for r in reversed(self.history)
                         if "test_acc" in r), {})
            self.result = {"params": {"top": self.top_params},
                           "history": self.history,
                           "final_test_acc": last.get("test_acc"),
                           "rounds": self.rounds}
            self.finish()
            return
        self._activate(self._online[0])


class SplitNNClientManager(FedMLCommManager):
    """Rank k >= 1: owns the bottom for data silo ``k - 1``. Handlers run
    on the receive thread, so each GRADS reply sends the next batch."""

    def __init__(self, args, fed, comm=None, rank: int = 1, size: int = 0,
                 backend: str = "INPROC", *, device,
                 init_params: Optional[Dict[str, Any]] = None):
        super().__init__(args, comm, rank, size, backend)
        self.device = torch.device(device)
        hidden = int(getattr(args, "splitnn_hidden", 128) or 128)
        self.bottom = _Bottom(int(np.prod(fed.train.x.shape[3:])), hidden)
        kb, _, _ = split_keys(getattr(args, "random_seed", 0))
        if init_params is None:
            self.params = init_module(self.bottom, kb, self.device)
        else:
            self.bottom.to(self.device)
            self.params = to_device_params(init_params, self.device)
        self.lr = float(args.learning_rate)
        cid = min(self.rank - 1, fed.num_clients - 1)
        self.cdata = fed.train.client(cid).to(self.device)
        self.test = fed.test
        self.epochs = int(getattr(args, "epochs", 1))
        # batches with at least one live sample, in order
        self._real = [int(i) for i in np.flatnonzero(
            np.asarray(fed.train.mask[cid]).sum(axis=-1) > 0)]
        self._epoch = 0
        self._pos = 0

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(SplitMsg.S2C_ACTIVATE,
                                              self._on_activate)
        self.register_message_receive_handler(SplitMsg.S2C_GRADS,
                                              self._on_grads)
        self.register_message_receive_handler(SplitMsg.S2C_EVALUATE,
                                              self._on_evaluate)
        self.register_message_receive_handler(SplitMsg.S2C_FINISH,
                                              self._on_finish)

    def run(self) -> None:
        self.send_message(Message(SplitMsg.C2S_ONLINE, self.rank, 0))
        super().run()

    def _on_activate(self, msg: Message) -> None:
        self._epoch = 0
        self._pos = 0
        self._send_next()

    def _send_next(self) -> None:
        if self._pos >= len(self._real):
            self._epoch += 1
            self._pos = 0
        if self._epoch >= self.epochs or not self._real:
            self.send_message(Message(SplitMsg.C2S_DONE, self.rank, 0))
            return
        b = self._real[self._pos]
        with torch.no_grad():
            h = functional_call(self.bottom, self.params, (self.cdata.x[b],))
        out = Message(SplitMsg.C2S_ACTS, self.rank, 0)
        out.add_params(SplitMsg.K_ACTS, host_array(h))
        out.add_params(SplitMsg.K_LABELS, host_array(self.cdata.y[b]))
        out.add_params(SplitMsg.K_MASK, host_array(self.cdata.mask[b]))
        self.send_message(out)

    def _on_grads(self, msg: Message) -> None:
        dh = from_wire(msg.get(SplitMsg.K_GRADS), self.device)
        b = self._real[self._pos]
        # recompute the cut layer; its vjp with the server's gradients
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self.params.items()}
        h = functional_call(self.bottom, leaves, (self.cdata.x[b],))
        grads = torch.autograd.grad(h, list(leaves.values()),
                                    grad_outputs=dh)
        sgd_(self.params, grads, self.lr)
        self._pos += 1
        self._send_next()

    @torch.no_grad()
    def _on_evaluate(self, msg: Message) -> None:
        tx = torch.as_tensor(np.asarray(self.test["x"])).to(self.device)
        h = functional_call(self.bottom, self.params,
                            (tx.reshape((-1,) + tuple(tx.shape[2:])),))
        out = Message(SplitMsg.C2S_EVAL_ACTS, self.rank, 0)
        out.add_params(SplitMsg.K_ACTS, host_array(h))
        out.add_params(SplitMsg.K_LABELS,
                       np.asarray(self.test["y"]).reshape(-1))
        out.add_params(SplitMsg.K_MASK,
                       np.asarray(self.test["mask"]).reshape(-1))
        self.send_message(out)

    def _on_finish(self, msg: Message) -> None:
        logger.info("splitnn client rank %d: finish", self.rank)
        self.finish()


def run_splitnn_inproc(args, fed, device=None,
                       init_params: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Server + N party clients as threads over the in-proc broker, on
    ``device`` (CUDA unless ``"cpu"``); ``init_params`` is
    ``{"bottom": ..., "top": ...}`` (every client starts from the same
    bottom)."""
    from ..device import get_device
    from . import run_inproc_session
    device = get_device(device)
    init = init_params or {}
    n = int(getattr(args, "client_num_per_round",
                    getattr(args, "client_num_in_total", 2)))
    return run_inproc_session(args, lambda: [
        SplitNNServerManager(args, fed.num_classes, size=n + 1,
                             backend="INPROC", device=device,
                             init_params=init.get("top")),
        *[SplitNNClientManager(args, fed, rank=r, size=n + 1,
                               backend="INPROC", device=device,
                               init_params=init.get("bottom"))
          for r in range(1, n + 1)]])
