"""Simulated device client (Beehive device analogue; counterpart of
``fedml_tpu/cross_device/client.py``).

Parity target: the reference's on-device stack — Android service + MobileNN
C++ trainers (``android/fedmlsdk/MobileNN``, ``FedMLClientManager``) driven
over MQTT+S3 file exchange. Here a *device* is a process/thread speaking the
same registration → train-on-file → upload-file protocol over any
transport; its training engine is selectable:

* ``torch`` — the port's local SGD on the device's card (the optimizer's
  step program, :class:`~fedml_tpu_torch.cross_silo.client.trainer.
  SiloTrainer`: one CUDA graph per device, captured at its first round and
  replayed per step; eager on the CPU); ``jax``, the JAX package's
  default, names the same engine, so a config written for it runs
  unchanged. Works for every model;
* ``native`` — the C++ core (:mod:`fedml_tpu_torch.native`, the MobileNN
  analogue) for linear models and the device CNN, with ctypes in place of
  JNI. A core that does not build raises here; nothing falls back to
  another engine.

The round's key is ``fold_in(fold_in(PRNGKey(seed + 31), device_id),
round)`` and the uplink compression's ``fold_in(fold_in(PRNGKey(seed +
977), device_id), round)``, as the JAX device draws them.
"""

from __future__ import annotations

import logging
import os
import platform
from typing import Optional

import numpy as np
import torch

from .. import prng
from ..core.collectives import tree_flatten_to_vector
from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..core.wire import encode_update
from ..cross_silo.client.trainer import SiloTrainer
from ..interop import flax_to_state_dict
from ..serving import load_model, save_model
from ..utils.compression import CommCompressionSpec
from ..utils.paths import confine_path
from .message_define import DeviceMessage

logger = logging.getLogger(__name__)

# the device_engine values: the JAX package's default names this engine
TORCH_ENGINES = ("torch", "jax")


def engine_name(engine: Optional[str]) -> str:
    """``torch`` (also for ``jax``) or ``native``; any other name
    raises."""
    e = str(engine or "torch").lower()
    if e in TORCH_ENGINES:
        return "torch"
    if e == "native":
        return e
    raise ValueError(f"device_engine {engine!r}: expected one of torch "
                     f"(jax names the same engine) or native")


def flat_vector(tree) -> np.ndarray:
    """Host float32 vector of a flax-layout params tree (an artifact's),
    in the JAX package's flat order."""
    sd = {k: torch.tensor(np.asarray(v, np.float32))
          for k, v in flax_to_state_dict(tree).items()}
    return tree_flatten_to_vector(sd).numpy()


class DeviceClientManager(FedMLCommManager):
    """One simulated device; ``rank`` doubles as its device id (>= 1).
    The torch engine trains on ``device``."""

    def __init__(self, args, fed, bundle, spec, optimizer, device_id: int,
                 comm=None, backend: str = "INPROC",
                 engine: Optional[str] = None,
                 eligibility: Optional[dict] = None, *, device):
        size = int(getattr(args, "client_num_per_round", 1)) + 1
        super().__init__(args, comm, device_id, size, backend)
        self.fed = fed
        self.bundle = bundle
        self.spec = spec
        self.opt = optimizer
        self.device_id = int(device_id)
        self.device = torch.device(device)
        self.engine = engine_name(
            engine or getattr(args, "device_engine", "torch"))
        # eligibility analogues the registration handshake carries
        # (charging/idle/unmetered); a real device SDK would read the
        # platform battery/network managers — the simulated device reads
        # per-device overrides, then args knobs, defaulting to eligible
        elig = dict(eligibility or {})
        self.eligibility = {
            k: bool(elig.get(k, getattr(args, f"device_{k}", True)))
            for k in ("charging", "idle", "unmetered")}
        self.cache_dir = os.path.expanduser(
            getattr(args, "model_file_cache_dir", None)
            or "~/.cache/fedml_tpu/device_models")
        os.makedirs(self.cache_dir, exist_ok=True)
        seed = int(getattr(args, "random_seed", 0))
        self.rng = prng.fold_in(prng.PRNGKey(seed + 31), self.device_id)
        # uplink wire compression (device_wire_compression; off = dense
        # artifacts, byte-identical). The device always has the round's
        # base in hand — the global it just trained from — so only the
        # error-feedback residual persists across rounds.
        method = getattr(args, "device_wire_compression", None)
        self._wire_spec = None
        self._wire_residual: Optional[np.ndarray] = None
        if method:
            self._wire_spec = CommCompressionSpec(
                method=str(method),
                ratio=float(getattr(args, "comm_compression_ratio", 0.1)),
                levels=int(getattr(args, "comm_quantize_levels", 127)))
            self._wire_rng = prng.fold_in(prng.PRNGKey(seed + 977),
                                          self.device_id)
        self.trainer = None
        self._native = None
        if self.engine == "native":
            from .. import native
            # trainer chosen by the MODEL's param tree: the CNN engine
            # for DeviceCNN-shaped trees, the linear engine otherwise
            # (reference MobileNN dispatches MNN vs torch engines)
            model = str(getattr(args, "model", "lr")).lower()
            if model in ("device_cnn", "mobile_cnn"):
                self._native = native.NativeCNNTrainer()
            else:
                self._native = native.NativeLinearTrainer()
        else:
            self.trainer = SiloTrainer(args, fed, bundle, spec, optimizer,
                                       self.device)

    # --- FSM ---------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            DeviceMessage.MSG_TYPE_S2D_INIT, self.handle_round)
        self.register_message_receive_handler(
            DeviceMessage.MSG_TYPE_S2D_SYNC, self.handle_round)
        self.register_message_receive_handler(
            DeviceMessage.MSG_TYPE_S2D_FINISH, self.handle_finish)

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.send_register()
        self.com_manager.handle_receive_message()

    def send_register(self) -> None:
        msg = Message(DeviceMessage.MSG_TYPE_D2S_REGISTER, self.device_id, 0)
        msg.add_params(DeviceMessage.ARG_DEVICE_ID, self.device_id)
        msg.add_params(DeviceMessage.ARG_DEVICE_OS, platform.system())
        msg.add_params(DeviceMessage.ARG_DEVICE_ENGINE, self.engine)
        msg.add_params(DeviceMessage.ARG_DEVICE_CHARGING,
                       self.eligibility["charging"])
        msg.add_params(DeviceMessage.ARG_DEVICE_IDLE,
                       self.eligibility["idle"])
        msg.add_params(DeviceMessage.ARG_DEVICE_UNMETERED,
                       self.eligibility["unmetered"])
        self.send_message(msg)

    def handle_round(self, msg: Message) -> None:
        # server-supplied fields: confine the path to the shared cache dir
        # (msgpack artifact + confinement = no unpickle / no arbitrary-file
        # read). Drop bad messages instead of raising — an exception here
        # would kill the device's receive loop. TypeError covers missing
        # fields (confine_path(None) / int(None)).
        try:
            round_idx = int(msg.get(DeviceMessage.ARG_ROUND_IDX))
            silo_idx = int(msg.get(DeviceMessage.ARG_DATA_SILO_IDX,
                                   self.device_id - 1))
            params = load_model(confine_path(
                msg.get(DeviceMessage.ARG_MODEL_FILE), self.cache_dir))
        except (TypeError, ValueError, OSError) as e:
            logger.warning("device %d: dropping round message: %s",
                           self.device_id, e)
            return
        cid = silo_idx % self.fed.num_clients
        eval_acc = None
        if self.engine == "native":
            # on-device eval of the received global model BEFORE training
            # (the MobileNN on-device test path) — reported to the server
            eval_acc = self._eval_native(params, cid)
            new_params, n, loss = self._train_native(params, cid,
                                                     round_idx)
        else:
            new_params, n, loss = self._train_torch(params, cid, round_idx)
        out_path = os.path.join(
            self.cache_dir,
            f"device_{self.device_id}_round_{round_idx}.npk")
        artifact = new_params
        if self._wire_spec is not None:
            enc = encode_update(
                self._vector(new_params), base=flat_vector(params),
                spec=self._wire_spec, residual=self._wire_residual,
                rng=prng.fold_in(self._wire_rng, round_idx),
                msg_type=DeviceMessage.MSG_TYPE_D2S_MODEL)
            self._wire_residual = enc.residual
            artifact = enc.payload
        save_model(artifact, out_path)
        reply = Message(DeviceMessage.MSG_TYPE_D2S_MODEL, self.device_id, 0)
        reply.add_params(DeviceMessage.ARG_DEVICE_ID, self.device_id)
        reply.add_params(DeviceMessage.ARG_MODEL_FILE, out_path)
        reply.add_params(DeviceMessage.ARG_ROUND_IDX, round_idx)
        reply.add_params(DeviceMessage.ARG_NUM_SAMPLES, n)
        reply.add_params(DeviceMessage.ARG_TRAIN_LOSS, loss)
        if eval_acc is not None:
            reply.add_params(DeviceMessage.ARG_DEVICE_EVAL_ACC, eval_acc)
        self.send_message(reply)

    def handle_finish(self, msg: Message) -> None:
        logger.info("device %d finished", self.device_id)
        self.finish()

    @staticmethod
    def _vector(params) -> np.ndarray:
        """The trained params (a state dict on the card, or the native
        engine's flax tree) as the host flat vector."""
        if all(torch.is_tensor(v) for v in params.values()):
            return tree_flatten_to_vector(params).float().cpu().numpy()
        return flat_vector(params)

    # --- engines -----------------------------------------------------------
    def _train_torch(self, params, cid: int, round_idx: int):
        start = {k: torch.tensor(v, device=self.device)
                 for k, v in flax_to_state_dict(params).items()}
        key = prng.fold_in(self.rng, round_idx)
        new_params, n, metrics = self.trainer.train(start, cid, round_idx,
                                                    key=key)
        return new_params, n, metrics["train_loss"]

    def _flatten_real(self, cid: int):
        x = np.asarray(self.fed.train.x[cid])
        y = np.asarray(self.fed.train.y[cid])
        mask = np.asarray(self.fed.train.mask[cid]).reshape(-1) > 0
        return (x.reshape((-1,) + x.shape[2:])[mask],
                y.reshape(-1)[mask].astype(np.int32))

    def _eval_native(self, params, cid: int) -> float:
        x, y = self._flatten_real(cid)
        return float(self._native.evaluate(params, x, y))

    def _train_native(self, params, cid: int, round_idx: int):
        # flatten padded batches back to the real sample list
        x, y = self._flatten_real(cid)
        new_params, loss = self._native.train(
            params, x, y, epochs=int(self.args.epochs),
            batch_size=int(self.args.batch_size),
            lr=float(self.args.learning_rate),
            seed=round_idx * 7919 + self.device_id)
        return new_params, float(len(x)), loss
