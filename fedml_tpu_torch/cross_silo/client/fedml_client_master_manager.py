"""Cross-silo FL client FSM (counterpart of
``fedml_tpu/cross_silo/client/fedml_client_master_manager.py``).

Send ONLINE on start, handle S2C_INIT, train, C2S model, S2C_SYNC loop,
S2C_FINISH. Local training runs on this silo's device through the
:class:`~.trainer.SiloTrainer`'s captured step. The wire is the JAX
package's: dense uploads are the flax tree of the trained params
(:mod:`..wire`), compressed ones the same blob under the same keys
(``fold_in(PRNGKey(seed + 97), rank)`` folded by round).
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from ... import prng
from ...core import mlops
from ...core.obs import trace as obs_trace
from ...core.chaos import FaultPlan
from ...core.distributed.communication.message import (WIRE_DTYPE_BF16,
                                                       Message)
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.wire import (decode_update, encode_update, pack_optional_vec,
                          unpack_optional_vec, wire_checkpointer,
                          wire_state_template)
from ...utils.compression import is_compressed_payload, spec_from_args
from ..message_define import MyMessage
from ..wire import bf16_wire_to_params, params_to_wire, wire_to_params

logger = logging.getLogger(__name__)


class ClientMasterManager(FedMLCommManager):
    # class-level fallbacks: a disabled plan, so FSM methods stay
    # callable on partially-constructed instances (tests via __new__)
    chaos = FaultPlan()
    _wire_ckpt = None

    def __init__(self, args, trainer, comm=None, rank: int = 1,
                 size: int = 0, backend: str = "INPROC"):
        super().__init__(args, comm, rank, size, backend)
        self.trainer = trainer
        self.round_idx = 0
        self.server_rank = 0
        # wire-efficient updates: when a spec is configured the upload is
        # the compressed delta vs the RECEIVED global model, with this
        # client's error-feedback residual carried across rounds so the
        # biased sparsifier still converges. None = dense path, unchanged.
        self.cc_spec = spec_from_args(args)
        # chaos: seeded per-(round, rank) dropout/straggler schedule —
        # a dropped silo silently skips its report (the server's
        # timeout/quorum tolerance takes it from there); a straggler
        # trains a reduced fraction of its local steps
        self.chaos = FaultPlan.from_args(args)
        self._cc_residual = None
        self._global_vec = None   # f32 vector of the last received global
        self._cc_rng = prng.fold_in(
            prng.PRNGKey(int(getattr(args, "random_seed", 0)) + 97),
            self.rank)
        # crash-resume: the EF residual and the broadcast base join the
        # round checkpoint (core/wire/state) — losing either silently
        # drops accumulated compression error or corrupts later deltas.
        # Gated on the session's checkpoint knobs AND an active spec.
        self._wire_ckpt = None
        if self.cc_spec is not None and self.cc_spec.method is not None:
            self._wire_ckpt = wire_checkpointer(args, f"client_{self.rank}")
            self._restore_wire_state()

    # --- wire-state checkpointing -------------------------------------------
    def _wire_dim(self) -> int:
        return int(np.asarray(self.trainer.params_to_vec(
            self.trainer.params_template)).shape[0])

    def _wire_state(self, d: int) -> dict:
        rf, res = pack_optional_vec(self._cc_residual, d)
        gf, gv = pack_optional_vec(self._global_vec, d)
        return {"round": np.asarray(self.round_idx, np.int32),
                "residual_set": rf, "residual": res,
                "global_vec_set": gf, "global_vec": gv}

    def _save_wire_state(self) -> None:
        if self._wire_ckpt is None or not self._wire_ckpt.enabled:
            return
        d = self._wire_dim()
        self._wire_ckpt.maybe_save(self.round_idx, self._wire_state(d))

    def _restore_wire_state(self) -> None:
        if self._wire_ckpt is None or not self._wire_ckpt.enabled:
            return
        got = self._wire_ckpt.latest(
            wire_state_template(self._wire_dim(), ("residual", "global_vec")))
        if got is None:
            return
        step, st = got
        self._cc_residual = unpack_optional_vec(st["residual_set"],
                                                st["residual"])
        self._global_vec = unpack_optional_vec(st["global_vec_set"],
                                               st["global_vec"])
        logger.info("client rank %d: restored wire state from round %d",
                    self.rank, step)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            self.handle_message_receive_model_from_server)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    def run(self) -> None:
        # announce (reference: CONNECTION_READY -> ONLINE status). The
        # handshake is re-announced with backoff until the server's first
        # message arrives: a single lost ONLINE frame (flaky WAN, chaos
        # link loss) must degrade to a late join, not a stalled session.
        self._server_heard = threading.Event()
        self.send_client_status(self.server_rank,
                                MyMessage.MSG_CLIENT_STATUS_ONLINE)
        mlops.log_training_status("ONLINE")

        def reannounce():
            delay = 2.0
            while not self._server_heard.wait(timeout=delay):
                logger.info("client rank %d: re-announcing ONLINE "
                            "(no server message yet)", self.rank)
                try:
                    self.send_client_status(
                        self.server_rank, MyMessage.MSG_CLIENT_STATUS_ONLINE)
                except Exception as e:
                    logger.debug("rank %d ONLINE re-announce failed: %s",
                                 self.rank, e)
                delay = min(delay * 2.0, 15.0)

        t = threading.Thread(target=reannounce, daemon=True)
        t.start()
        super().run()
        self._server_heard.set()  # release the re-announce thread

    def send_client_status(self, receiver_id: int, status: str) -> None:
        msg = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.rank,
                      receiver_id)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_STATUS, status)
        self.send_message(msg)

    def handle_message_init(self, msg: Message) -> None:
        self._train_and_report(msg)

    def handle_message_receive_model_from_server(self, msg: Message) -> None:
        self._train_and_report(msg)

    def _receive_global(self, msg: Message):
        """Reassemble the server's sync payload: dense f32 (default),
        dense bf16 (``wire_dtype`` tag), or a compressed delta vs the last
        received global (``comm_compression_broadcast: compress``)."""
        update = msg.get(MyMessage.MSG_ARG_KEY_MODEL_UPDATE)
        if is_compressed_payload(update):
            if self._global_vec is None:
                raise RuntimeError(
                    "compressed sync before a dense init model")
            self._global_vec = decode_update(update, base=self._global_vec)
            return self.trainer.vec_to_params(self._global_vec)
        wire = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        if msg.get(MyMessage.MSG_ARG_KEY_WIRE_DTYPE) == WIRE_DTYPE_BF16:
            params = bf16_wire_to_params(wire, self.trainer.params_template)
        else:
            params = wire_to_params(wire, self.trainer.params_template)
        if self.cc_spec is not None and self.cc_spec.method is not None:
            self._global_vec = self.trainer.params_to_vec(params)
        return params

    def _train_and_report(self, msg: Message) -> None:
        if hasattr(self, "_server_heard"):
            self._server_heard.set()
        client_idx = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, 0))
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX, 0))
        # join the server's round trace: the sync carried the broadcast
        # span's traceparent, so this silo's train/upload spans nest
        # under it — ONE tree per round across processes
        with obs_trace.tracer.span(
                "silo.round", parent=obs_trace.extract(msg),
                attrs={"role": "client", "rank": self.rank,
                       "round_idx": self.round_idx}) as rsp:
            self._train_and_report_traced(msg, client_idx, rsp)

    def _train_and_report_traced(self, msg: Message, client_idx: int,
                                 rsp) -> None:
        # ALWAYS consume the broadcast, even when dropping out below: a
        # compressed sync is a delta vs the last reconstruction — skipping
        # it would leave _global_vec one delta behind and corrupt every
        # later round's base (and round-0 init must seed _global_vec)
        params = self._receive_global(msg)
        if self.chaos.is_dropped(self.round_idx, self.rank):
            # injected dropout: stay reachable (and base-synced) for the
            # next round but train/report nothing this round
            logger.warning("chaos: silo %d drops out of round %d",
                           self.rank, self.round_idx)
            rsp.set_attr("dropped", True)
            mlops.log_chaos(round_idx=self.round_idx,
                            injected={"dropped": [self.rank]})
            return
        work_scale = self.chaos.work_scale(self.round_idx, self.rank)
        with mlops.event("train", round_idx=self.round_idx):
            if work_scale < 1.0:
                new_params, n_samples, metrics = self.trainer.train(
                    params, client_idx, self.round_idx,
                    work_scale=work_scale)
            else:
                # healthy path: the pre-chaos trainer call signature, so
                # user trainer subclasses without the kwarg keep working
                new_params, n_samples, metrics = self.trainer.train(
                    params, client_idx, self.round_idx)
        out = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank,
                      self.server_rank)
        if self.cc_spec is not None and self.cc_spec.method is not None:
            # broadcast-only specs (method None, e.g. bf16 downlink) keep
            # the dense uplink below. The uplink runs through the shared
            # core/wire pipeline: delta vs the received global, then EF
            # sparsify/quantize. When the server's adaptive schedule
            # tagged the sync with a keep-ratio, this round honors it.
            spec = self.cc_spec
            ratio = msg.get(MyMessage.MSG_ARG_KEY_CC_RATIO)
            if ratio is not None:
                import dataclasses
                spec = dataclasses.replace(spec, ratio=float(ratio))
            enc = encode_update(
                self.trainer.params_to_vec(new_params),
                base=self._global_vec, spec=spec,
                residual=self._cc_residual,
                rng=prng.fold_in(self._cc_rng, self.round_idx),
                msg_type=MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
            self._cc_residual = enc.residual
            out.add_params(MyMessage.MSG_ARG_KEY_MODEL_UPDATE, enc.payload)
            # a delta is only meaningful against the round's broadcast
            # base — tag it so the server can drop stragglers from a
            # timed-out round instead of reconstructing against the
            # wrong base (dense path omits this: byte-identical wire)
            out.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
        else:
            out.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                           params_to_wire(new_params))
            if self.chaos.enabled:
                # under chaos an upload can outlive its round (delayed or
                # duplicated link copies, post-grace degraded aggregation
                # racing a straggler) — tag it so the server can drop the
                # stale copy instead of polluting the next round's pool.
                # Otherwise the default wire stays byte-identical.
                out.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX,
                               self.round_idx)
        out.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, float(n_samples))
        out.add_params(MyMessage.MSG_ARG_KEY_CLIENT_METRICS,
                       {k: float(v) for k, v in (metrics or {}).items()})
        with obs_trace.tracer.span(
                "upload", attrs={"rank": self.rank,
                                 "round_idx": self.round_idx}) as usp:
            # the UPLOAD span's context rides the upload: the server
            # links these spans off its wait span
            obs_trace.inject(out, usp)
            self.send_message(out)
        self._save_wire_state()

    def handle_message_finish(self, msg: Message) -> None:
        if hasattr(self, "_server_heard"):
            self._server_heard.set()
        logger.info("client rank %d: finish", self.rank)
        mlops.log_training_status("FINISHED")
        if self._wire_ckpt is not None:
            self._wire_ckpt.close()
        self.finish()
