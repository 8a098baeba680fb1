"""Native device core bindings (MobileNN analogue; counterpart of
``fedml_tpu/native/__init__.py``, with the same C++ source).

The reference ships a C++ on-device SDK (``android/fedmlsdk/MobileNN``:
``FedMLBaseTrainer`` + MNN/torch engines + native LightSecAgg,
``src/security/LightSecAgg.cpp``) bridged to the app through JNI. Here the
native core is :mod:`mobilenn.cpp` (softmax-regression and LeNet-class SGD,
GF(2^31-1) masking, LightSecAgg coding, the CSV reader and the model
artifact codec) compiled at first use with ``g++ -O2 -shared -fPIC
-std=c++17``, the JAX package's flags, so both bindings run the same
machine code, into the checkout's ``build/fedml_tpu_torch/native/``
(gitignored, as the CUDA kernels' builds are), and bridged through
``ctypes``. The simulated device client
(:mod:`fedml_tpu_torch.cross_device.client`) selects it with
``device_engine: native``.

A failed build raises (:class:`NativeBuildError`) wherever the core is
used; nothing falls back to another engine. :func:`available` says
whether it builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mobilenn.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

PRIME = 2147483647  # 2^31 - 1, matches core/mpc/field_ops.py

# callback signatures of the C ABI (include/fedml_client.h)
PROGRESS_CB = ctypes.CFUNCTYPE(None, ctypes.c_float)
LOSS_CB = ctypes.CFUNCTYPE(None, ctypes.c_int32, ctypes.c_float)


BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "fedml_tpu_torch" / "native"


class NativeBuildError(RuntimeError):
    """The native core did not build or load."""


def _cache_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return str(BUILD_DIR / f"libmobilenn-{digest}.so")


def _build() -> str:
    so = _cache_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp.so"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeBuildError(
            f"native core build failed ({e}): "
            f"{detail.decode(errors='replace')[:500]}") from e
    os.replace(tmp, so)
    logger.info("built native core -> %s", so)
    return so


def _load() -> ctypes.CDLL:
    """The loaded core, built at first use; raises
    :class:`NativeBuildError` if it does not build or load (every call
    retries: a failed build is not remembered)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise NativeBuildError(f"native core {so} does not load: "
                                   f"{e}") from e
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.train_linear_sgd.restype = ctypes.c_float
        lib.train_linear_sgd.argtypes = [
            f32p, f32p, f32p, i32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_uint64]
        lib.eval_linear.restype = ctypes.c_float
        lib.eval_linear.argtypes = [f32p, f32p, f32p, i32p, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32]
        lib.gen_mask.restype = None
        lib.gen_mask.argtypes = [u32p, ctypes.c_int64, ctypes.c_uint64]
        lib.mask_vector.restype = None
        lib.mask_vector.argtypes = [u32p, f32p, ctypes.c_int64,
                                    ctypes.c_float, ctypes.c_uint64]
        lib.unmask_vector.restype = None
        lib.unmask_vector.argtypes = [f32p, u32p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_uint64]
        lib.train_cnn_sgd.restype = ctypes.c_float
        lib.train_cnn_sgd.argtypes = (
            [f32p] * 6 + [f32p, i32p] + [ctypes.c_int32] * 9
            + [ctypes.c_float, ctypes.c_uint64])
        lib.eval_cnn.restype = ctypes.c_float
        lib.eval_cnn.argtypes = ([f32p] * 6 + [f32p, i32p]
                                 + [ctypes.c_int32] * 7)
        lib.lsa_mask_encode.restype = ctypes.c_int32
        lib.lsa_mask_encode.argtypes = [u32p, u32p, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_uint64]
        lib.csv_probe.restype = ctypes.c_int32
        lib.csv_probe.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.csv_read.restype = ctypes.c_int32
        lib.csv_read.argtypes = [ctypes.c_char_p, f32p, i32p,
                                 ctypes.c_int32, ctypes.c_int32]
        # model artifact codec (serialized-model handling)
        lib.artifact_open.restype = ctypes.c_void_p
        lib.artifact_open.argtypes = [ctypes.c_char_p]
        lib.artifact_count.restype = ctypes.c_int32
        lib.artifact_count.argtypes = [ctypes.c_void_p]
        lib.artifact_key.restype = ctypes.c_int32
        lib.artifact_key.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.c_char_p, ctypes.c_int32]
        lib.artifact_elems.restype = ctypes.c_int64
        lib.artifact_elems.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.artifact_shape.restype = ctypes.c_int32
        lib.artifact_shape.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       i32p, ctypes.c_int32]
        lib.artifact_read_f32.restype = ctypes.c_int64
        lib.artifact_read_f32.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          f32p, ctypes.c_int64]
        lib.artifact_close.restype = None
        lib.artifact_close.argtypes = [ctypes.c_void_p]
        lib.artifact_save.restype = ctypes.c_int32
        lib.artifact_save.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(f32p), i32p, i32p, ctypes.c_int32]
        # client manager session (FedMLClientManager analogue)
        lib.fedml_client_create.restype = ctypes.c_void_p
        lib.fedml_client_create.argtypes = []
        lib.fedml_client_release.restype = None
        lib.fedml_client_release.argtypes = [ctypes.c_void_p]
        lib.fedml_client_init.restype = ctypes.c_int32
        lib.fedml_client_init.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.c_uint64]
        lib.fedml_client_set_callbacks.restype = None
        lib.fedml_client_set_callbacks.argtypes = [ctypes.c_void_p,
                                                   PROGRESS_CB, LOSS_CB]
        lib.fedml_client_train.restype = ctypes.c_float
        lib.fedml_client_train.argtypes = [ctypes.c_void_p]
        lib.fedml_client_get_epoch_and_loss.restype = ctypes.c_int32
        lib.fedml_client_get_epoch_and_loss.argtypes = [
            ctypes.c_void_p, i32p, f32p]
        lib.fedml_client_stop_training.restype = ctypes.c_int32
        lib.fedml_client_stop_training.argtypes = [ctypes.c_void_p]
        lib.fedml_client_evaluate.restype = ctypes.c_float
        lib.fedml_client_evaluate.argtypes = [ctypes.c_void_p]
        lib.fedml_client_save_model.restype = ctypes.c_int32
        lib.fedml_client_save_model.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
        lib.mobilenn_abi_version.restype = ctypes.c_int32
        lib.mobilenn_abi_version.argtypes = []
        if lib.mobilenn_abi_version() != 3:
            raise NativeBuildError(
                f"native core ABI {lib.mobilenn_abi_version()}, expected 3")
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native core builds and loads here."""
    try:
        _load()
    except NativeBuildError as e:
        logger.warning("native core unavailable: %s", e)
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


class NativeLinearTrainer:
    """Device-side trainer over the native core. Param layout matches the
    flax ``LogisticRegression`` bundle ({'Dense_0': {'kernel','bias'}}), so
    the server aggregates native and JAX device updates interchangeably."""

    def __init__(self):
        self.lib = _load()

    def train(self, params: Dict, x: np.ndarray, y: np.ndarray,
              epochs: int, batch_size: int, lr: float, seed: int):
        dense = params["Dense_0"]
        W = np.ascontiguousarray(np.asarray(dense["kernel"], np.float32))
        b = np.ascontiguousarray(np.asarray(dense["bias"], np.float32))
        x2 = np.ascontiguousarray(x.reshape(len(x), -1).astype(np.float32))
        y2 = np.ascontiguousarray(np.asarray(y, np.int32))
        d, k = W.shape
        loss = self.lib.train_linear_sgd(
            _f32p(W), _f32p(b), _f32p(x2), _i32p(y2),
            np.int32(len(x2)), np.int32(d), np.int32(k),
            np.int32(epochs), np.int32(batch_size), np.float32(lr),
            np.uint64(seed))
        return {"Dense_0": {"kernel": W, "bias": b}}, float(loss)

    def evaluate(self, params: Dict, x: np.ndarray, y: np.ndarray) -> float:
        dense = params["Dense_0"]
        W = np.ascontiguousarray(np.asarray(dense["kernel"], np.float32))
        b = np.ascontiguousarray(np.asarray(dense["bias"], np.float32))
        x2 = np.ascontiguousarray(x.reshape(len(x), -1).astype(np.float32))
        y2 = np.ascontiguousarray(np.asarray(y, np.int32))
        d, k = W.shape
        return float(self.lib.eval_linear(
            _f32p(W), _f32p(b), _f32p(x2), _i32p(y2),
            np.int32(len(x2)), np.int32(d), np.int32(k)))


def gen_mask(n: int, seed: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, np.uint32)
    lib.gen_mask(_u32p(out), np.int64(n), np.uint64(seed))
    return out


def mask_vector(v: np.ndarray, scale: float, seed: int) -> np.ndarray:
    lib = _load()
    v = np.ascontiguousarray(v, np.float32)
    out = np.empty(v.size, np.uint32)
    lib.mask_vector(_u32p(out), _f32p(v), np.int64(v.size),
                    np.float32(scale), np.uint64(seed))
    return out


def unmask_vector(masked: np.ndarray, scale: float, seed: int) -> np.ndarray:
    lib = _load()
    masked = np.ascontiguousarray(masked, np.uint32)
    out = np.empty(masked.size, np.float32)
    lib.unmask_vector(_f32p(out), _u32p(masked), np.int64(masked.size),
                      np.float32(scale), np.uint64(seed))
    return out


class NativeCNNTrainer:
    """Device-side CNN trainer over the native core — the MNN-LeNet-engine
    analogue (reference ``FedMLMNNTrainer.cpp``). Param tree matches the
    flax ``DeviceCNN`` bundle ({'Conv_0','Conv_1','Dense_0'}), so the
    server aggregates native-CNN and JAX-CNN device updates
    interchangeably."""

    def __init__(self):
        self.lib = _load()

    @staticmethod
    def _unpack(params: Dict):
        k1 = np.ascontiguousarray(
            np.asarray(params["Conv_0"]["kernel"], np.float32))
        b1 = np.ascontiguousarray(
            np.asarray(params["Conv_0"]["bias"], np.float32))
        k2 = np.ascontiguousarray(
            np.asarray(params["Conv_1"]["kernel"], np.float32))
        b2 = np.ascontiguousarray(
            np.asarray(params["Conv_1"]["bias"], np.float32))
        wd = np.ascontiguousarray(
            np.asarray(params["Dense_0"]["kernel"], np.float32))
        bd = np.ascontiguousarray(
            np.asarray(params["Dense_0"]["bias"], np.float32))
        return k1, b1, k2, b2, wd, bd

    @staticmethod
    def _image(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.ndim == 2:  # flat -> square single-channel (DeviceCNN parity)
            side = int(round(x.shape[-1] ** 0.5))
            x = x.reshape(len(x), side, side, 1)
        return np.ascontiguousarray(x)

    def train(self, params: Dict, x: np.ndarray, y: np.ndarray,
              epochs: int, batch_size: int, lr: float, seed: int):
        k1, b1, k2, b2, wd, bd = self._unpack(params)
        x4 = self._image(x)
        y2 = np.ascontiguousarray(np.asarray(y, np.int32))
        n, H, W, cin = x4.shape
        c1, c2, k = k1.shape[-1], k2.shape[-1], bd.shape[0]
        loss = self.lib.train_cnn_sgd(
            _f32p(k1), _f32p(b1), _f32p(k2), _f32p(b2), _f32p(wd),
            _f32p(bd), _f32p(x4), _i32p(y2),
            np.int32(n), np.int32(H), np.int32(W), np.int32(cin),
            np.int32(c1), np.int32(c2), np.int32(k), np.int32(epochs),
            np.int32(batch_size), np.float32(lr), np.uint64(seed))
        return ({"Conv_0": {"kernel": k1, "bias": b1},
                 "Conv_1": {"kernel": k2, "bias": b2},
                 "Dense_0": {"kernel": wd, "bias": bd}}, float(loss))

    def evaluate(self, params: Dict, x: np.ndarray, y: np.ndarray) -> float:
        k1, b1, k2, b2, wd, bd = self._unpack(params)
        x4 = self._image(x)
        y2 = np.ascontiguousarray(np.asarray(y, np.int32))
        n, H, W, cin = x4.shape
        return float(self.lib.eval_cnn(
            _f32p(k1), _f32p(b1), _f32p(k2), _f32p(b2), _f32p(wd),
            _f32p(bd), _f32p(x4), _i32p(y2),
            np.int32(n), np.int32(H), np.int32(W), np.int32(cin),
            np.int32(k1.shape[-1]), np.int32(k2.shape[-1]),
            np.int32(bd.shape[0])))


def lsa_mask_encode(z: np.ndarray, n_clients: int, privacy_t: int,
                    split_t: int, seed: int) -> np.ndarray:
    """Native LightSecAgg Lagrange encoding of a field mask ``z`` into
    ``n_clients`` coded sub-masks — decodes with the Python
    ``core.mpc.lightsecagg.decode_aggregate_mask`` (same points, same
    field)."""
    lib = _load()
    z = np.ascontiguousarray(z, np.uint32)
    if len(z) % split_t:
        raise ValueError("mask length must divide split_t")
    out = np.empty((n_clients, len(z) // split_t), np.uint32)
    rc = lib.lsa_mask_encode(_u32p(out), _u32p(z), np.int32(len(z)),
                             np.int32(n_clients), np.int32(privacy_t),
                             np.int32(split_t), np.uint64(seed))
    if rc != 0:
        raise ValueError(f"lsa_mask_encode failed (rc={rc})")
    return out


def read_csv(path: str):
    """Native CSV dataset reader (label in the last column); returns
    (x [n, d] float32, y [n] int32)."""
    lib = _load()
    rows = np.zeros(1, np.int32)
    cols = np.zeros(1, np.int32)
    rc = lib.csv_probe(path.encode(), _i32p(rows), _i32p(cols))
    if rc != 0:
        raise OSError(f"csv_probe({path!r}) failed (rc={rc})")
    r, c = int(rows[0]), int(cols[0])
    x = np.empty((r, c - 1), np.float32)
    y = np.empty(r, np.int32)
    rc = lib.csv_read(path.encode(), _f32p(x), _i32p(y), np.int32(r),
                      np.int32(c))
    if rc != 0:
        raise OSError(f"csv_read({path!r}) failed (rc={rc})")
    return x, y


# ---------------------------------------------------------------------------
# model artifact access (serialized-model handling) — the native codec for
# the framework's msgpack artifact format (serving.save_model/load_model)


def load_artifact_native(path: str) -> Dict[str, np.ndarray]:
    """Parse a model artifact with the NATIVE codec (no Python msgpack):
    returns {slash/path: float32 ndarray}. Raises on parse failure."""
    lib = _load()
    h = lib.artifact_open(path.encode())
    if not h:
        raise ValueError(f"{path}: not a parseable fedml_tpu artifact")
    try:
        out: Dict[str, np.ndarray] = {}
        buf = ctypes.create_string_buffer(4096)
        for i in range(lib.artifact_count(h)):
            lib.artifact_key(h, np.int32(i), buf, np.int32(len(buf)))
            key = buf.value.decode()
            dims = np.zeros(16, np.int32)
            nd = lib.artifact_shape(h, key.encode(), _i32p(dims),
                                    np.int32(16))
            shape = tuple(int(d) for d in dims[:nd])
            n = lib.artifact_elems(h, key.encode())
            arr = np.empty(int(n), np.float32)
            got = lib.artifact_read_f32(h, key.encode(), _f32p(arr),
                                        np.int64(n))
            if got != n:
                raise ValueError(f"{path}: short read on {key}")
            out[key] = arr.reshape(shape)
        return out
    finally:
        lib.artifact_close(h)


def save_artifact_native(leaves: Dict[str, np.ndarray], path: str) -> None:
    """Write {slash/path: float32 array} as a nested model artifact,
    byte-compatible with ``serving.load_model``."""
    lib = _load()
    items = sorted(leaves.items())
    keys = (ctypes.c_char_p * len(items))(
        *[k.encode() for k, _ in items])
    arrays = [np.ascontiguousarray(v, np.float32) for _, v in items]
    data = (ctypes.POINTER(ctypes.c_float) * len(items))(
        *[_f32p(a) for a in arrays])
    ndims = np.asarray([a.ndim for a in arrays], np.int32)
    shapes = np.asarray(sum([list(a.shape) for a in arrays], []), np.int32)
    rc = lib.artifact_save(path.encode(), keys, data, _i32p(ndims),
                           _i32p(shapes), np.int32(len(items)))
    if rc != 0:
        raise OSError(f"artifact_save({path!r}) failed (rc={rc})")


class NativeClientManager:
    """The FedMLClientManager analogue over the C ABI
    (``include/fedml_client.h``; reference
    ``MobileNN/includes/FedMLClientManager.h`` +
    ``JniFedMLClientManager.cpp``): init(model artifact, CSV shard) ->
    train -> evaluate/save, with progress/loss callbacks."""

    def __init__(self):
        self.lib = _load()
        self._h = self.lib.fedml_client_create()
        self._cbs = []  # keep ctypes callbacks alive for the session

    def init(self, model_path: str, data_path: str, batch_size: int = 32,
             learning_rate: float = 0.1, epochs: int = 1,
             seed: int = 0) -> None:
        rc = self.lib.fedml_client_init(
            self._h, model_path.encode(), data_path.encode(),
            np.int32(batch_size), np.float32(learning_rate),
            np.int32(epochs), np.uint64(seed))
        if rc != 0:
            raise RuntimeError(f"fedml_client_init failed (rc={rc})")

    def set_callbacks(self, on_progress=None, on_loss=None) -> None:
        p = PROGRESS_CB(on_progress) if on_progress else PROGRESS_CB()
        l = LOSS_CB(on_loss) if on_loss else LOSS_CB()
        self._cbs = [p, l]  # keep alive: C holds these pointers
        self.lib.fedml_client_set_callbacks(self._h, p, l)

    def train(self) -> float:
        return float(self.lib.fedml_client_train(self._h))

    def get_epoch_and_loss(self):
        e = np.zeros(1, np.int32)
        lo = np.zeros(1, np.float32)
        self.lib.fedml_client_get_epoch_and_loss(self._h, _i32p(e),
                                                 _f32p(lo))
        return int(e[0]), float(lo[0])

    def stop_training(self) -> None:
        self.lib.fedml_client_stop_training(self._h)

    def evaluate(self) -> float:
        return float(self.lib.fedml_client_evaluate(self._h))

    def save_model(self, path: str) -> None:
        rc = self.lib.fedml_client_save_model(self._h, path.encode())
        if rc != 0:
            raise OSError(f"fedml_client_save_model failed (rc={rc})")

    def close(self) -> None:
        if self._h:
            self.lib.fedml_client_release(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
