"""Message envelope and the msgpack wire codec (counterpart of
``fedml_tpu/core/distributed/communication/message.py``).

Payloads are msgpack with one extension type (42) for arrays: a packed
``(dtype.str, shape)`` header followed by the C-order bytes. No pickle
anywhere: artifacts, checkpoints and messages may cross trust boundaries.
The same codec is the single serialisation seam of model artifacts
(``serving.save_model``), adapter exports and round checkpoints.

Byte-for-byte what the JAX package writes for the same values:

* :func:`dumps_tree` first turns every leaf into a numpy array, as the JAX
  package's ``tree_map(np.asarray, device_get(tree))`` does: dict keys come
  out sorted at every level (an ``OrderedDict`` keeps its order), tuples
  become arrays, ``None`` stays nil, and Python scalars become arrays
  (float64 / int64 / bool);
* a 0-d array crosses with shape ``[1]`` (``np.ascontiguousarray`` has at
  least one dimension);
* torch tensors go through ``.detach().cpu()``; a ``torch.bfloat16`` leaf
  is written under ml_dtypes' dtype string ``<V2`` with its raw bits, and
  like the JAX package's bf16 leaf it loads back as a ``|V2`` void array
  (:func:`array_to_tensor` turns that into a bf16 tensor);
* inside a :class:`Message` the encoder's hook alone applies: a numpy
  scalar with ``__array__`` (``np.float32``, ``np.int64``) is an array,
  ``np.float64`` (a Python float) a msgpack float.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Tuple

import msgpack
import numpy as np
import torch

from ...obs import metrics as obs_metrics


class WireStats:
    """Bytes-on-wire ledger at the encode seam: every ``Message.encode``
    records its serialized size under the message type, so any transport
    gets per-message-type accounting. Thread-safe; one process-wide
    instance (``WIRE_STATS``) because a process is one rank: readers diff
    :meth:`snapshot` across rounds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_type: Dict[Any, Dict[str, int]] = {}
        # per-pipeline-stage byte attribution: msg_type -> stage -> bytes
        self._by_stage: Dict[Any, Dict[str, int]] = {}
        self._total_bytes = 0
        self._total_msgs = 0

    def record(self, msg_type: Any, nbytes: int) -> None:
        with self._lock:
            ent = self._by_type.setdefault(msg_type,
                                           {"bytes": 0, "messages": 0})
            ent["bytes"] += int(nbytes)
            ent["messages"] += 1
            self._total_bytes += int(nbytes)
            self._total_msgs += 1
        # the registry has its own lock
        obs_metrics.record_wire(msg_type, nbytes)

    def record_stage(self, msg_type: Any, stage: str, nbytes: int) -> None:
        """Attribute bytes to one wire-pipeline stage for a message
        type: where the bytes behind :meth:`record`'s totals went."""
        with self._lock:
            ent = self._by_stage.setdefault(msg_type, {})
            ent[stage] = ent.get(stage, 0) + int(nbytes)
        obs_metrics.record_wire_stage(msg_type, stage, nbytes)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"total_bytes": self._total_bytes,
                    "total_messages": self._total_msgs,
                    "by_type": {str(t): dict(v)
                                for t, v in self._by_type.items()},
                    "by_stage": {str(t): dict(v)
                                 for t, v in self._by_stage.items()}}

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def reset(self) -> None:
        with self._lock:
            self._by_type.clear()
            self._by_stage.clear()
            self._total_bytes = 0
            self._total_msgs = 0


WIRE_STATS = WireStats()


class Message:
    # canonical keys
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_MODEL_PARAMS_URL = "model_params_url"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    # W3C trace-context header: an ordinary payload param, so every
    # transport propagates it
    MSG_ARG_KEY_TRACEPARENT = "traceparent"

    def __init__(self, msg_type: Any = 0, sender_id: int = 0,
                 receiver_id: int = 0):
        self.msg_params: Dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: msg_type,
            Message.MSG_ARG_KEY_SENDER: sender_id,
            Message.MSG_ARG_KEY_RECEIVER: receiver_id,
        }

    def get_sender_id(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_RECEIVER]

    def get_type(self):
        return self.msg_params[Message.MSG_ARG_KEY_TYPE]

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    add = add_params

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    def __repr__(self) -> str:
        keys = ", ".join(sorted(self.msg_params))
        return (f"Message(type={self.get_type()!r}, "
                f"{self.get_sender_id()}->{self.get_receiver_id()}, "
                f"keys=[{keys}])")

    # --- wire format --------------------------------------------------------
    def encode(self) -> bytes:
        blob = msgpack.packb(self.msg_params, default=_pack_np,
                             use_bin_type=True)
        WIRE_STATS.record(self.get_type(), len(blob))
        return blob

    @classmethod
    def decode(cls, blob: bytes) -> "Message":
        params = msgpack.unpackb(blob, ext_hook=_unpack_np, raw=False,
                                 strict_map_key=False)
        msg = cls()
        msg.msg_params = params
        return msg


_NP_EXT = 42
# ml_dtypes' bfloat16 dtype string, under which the JAX package writes a
# bf16 leaf
_BF16_STR = "<V2"


def _ext(dtype_str: str, arr: np.ndarray) -> msgpack.ExtType:
    head = msgpack.packb((dtype_str, list(arr.shape)))
    return msgpack.ExtType(_NP_EXT, head + arr.tobytes())


def _pack_np(obj):
    """msgpack hook: tensors and arrays -> ext(dtype, shape, bytes)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _ext(_BF16_STR, np.ascontiguousarray(
                t.view(torch.int16).numpy()))
        return _ext(*_np_ext_args(t.numpy()))
    if hasattr(obj, "__array__"):  # numpy arrays and numpy scalars
        return _ext(*_np_ext_args(obj))
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _np_ext_args(obj) -> Tuple[str, np.ndarray]:
    arr = np.ascontiguousarray(np.asarray(obj))
    return arr.dtype.str, arr


def _unpack_np(code, data):
    if code != _NP_EXT:
        return msgpack.ExtType(code, data)
    unpacker = msgpack.Unpacker(use_list=True, raw=False)
    unpacker.feed(data)
    dtype_str, shape = unpacker.unpack()
    off = unpacker.tell()
    arr = np.frombuffer(data[off:], dtype=np.dtype(dtype_str))
    return arr.reshape(shape)


def array_to_tensor(arr) -> torch.Tensor:
    """A decoded leaf as a CPU tensor; a ``|V2`` leaf (a bf16 leaf on the
    wire) becomes a ``torch.bfloat16`` tensor with the same bits."""
    a = np.asarray(arr)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _walk(tree, leaf: Callable[[Any], Any]):
    """Rebuild ``tree`` with ``leaf`` applied to every leaf, in the JAX
    package's pytree order: dicts by sorted key (``OrderedDict`` in its
    own order), lists and tuples in order, ``None`` kept as is."""
    if tree is None:
        return None
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict(
            (k, _walk(v, leaf)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _walk(tree[k], leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf) for v in tree)
    return leaf(tree)


def _host_leaf(x):
    """``np.asarray`` of a leaf; tensors come to the host first, and a bf16
    tensor stays a tensor for :func:`_pack_np` to write as ``<V2``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def dumps_tree(tree) -> bytes:
    """Serialize a tree of arrays or tensors (nested dicts and lists: the
    flax param shape) with the wire codec. The single safe-serialization
    seam shared by messages, model artifacts and checkpoints: never
    pickle."""
    return msgpack.packb(_walk(tree, _host_leaf), default=_pack_np,
                         use_bin_type=True)


def loads_tree(blob: bytes) -> Any:
    return msgpack.unpackb(blob, ext_hook=_unpack_np, raw=False,
                           strict_map_key=False)


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in pytree order; the path joins dict keys and list
    indices with ``/`` as the JAX package's ``tree_to_wire`` does."""
    out: List[Tuple[str, Any]] = []

    def rec(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            keys = (list(node) if isinstance(node, collections.OrderedDict)
                    else sorted(node))
            for k in keys:
                rec(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    rec(tree, ())
    return out


def _numpy_leaf(x) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor widens exactly to f32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


def tree_to_wire(tree) -> Dict[str, Any]:
    """Flatten a tree of arrays or tensors into ``{path: np.ndarray}`` for
    a Message payload (the analogue of shipping a state-dict)."""
    return {k: _numpy_leaf(v) for k, v in _flatten_with_paths(tree)}


WIRE_DTYPE_BF16 = "bf16"


def f32_to_bf16_bits(a) -> np.ndarray:
    """The uint16 bit pattern of ``a`` rounded to bfloat16 as ml_dtypes
    rounds it: through float32 first (so a float64 is rounded twice), then
    to nearest even; a NaN becomes the quiet NaN ``0x7fc0`` with its
    sign."""
    bits = np.array(a, np.float32).view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
               >> 16).astype(np.uint16)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = ((bits >> 16) & np.uint32(0x8000)).astype(np.uint16) \
        | np.uint16(0x7FC0)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bfloat16 bit patterns widened exactly to float32."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def tree_to_wire_bf16(tree) -> Dict[str, Any]:
    """Half-width variant of :func:`tree_to_wire`: leaves cross as the
    uint16 bit pattern of their bfloat16 rounding. Tag the message with
    ``WIRE_DTYPE_BF16`` so the receiver knows to reinterpret."""
    return {k: f32_to_bf16_bits(v) for k, v in tree_to_wire(tree).items()}


def _leaf_dtype(t) -> np.dtype:
    if isinstance(t, torch.Tensor):
        return torch.empty((), dtype=t.dtype).numpy().dtype
    return np.asarray(t).dtype


def bf16_wire_to_tree(flat: Dict[str, Any], template):
    """Inverse of :func:`tree_to_wire_bf16`; leaves come back as numpy
    arrays of the template's dtype (float32 weights widen from the bf16
    rounding)."""
    widened = {k: bf16_bits_to_f32(v) for k, v in flat.items()}
    paths = iter(_flatten_with_paths(template))

    def leaf(t):
        key, _ = next(paths)
        return np.asarray(widened[key], _leaf_dtype(t))

    return _walk(template, leaf)


def wire_to_tree(flat: Dict[str, Any], template):
    """Inverse of :func:`tree_to_wire` given a structural template."""
    paths = iter(_flatten_with_paths(template))
    return _walk(template, lambda _: np.asarray(flat[next(paths)[0]]))
