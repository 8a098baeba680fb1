"""Compute-plane observability: per-op roofline attribution and recompile
forensics (counterpart of ``fedml_tpu/core/obs/roofline.py``, a new design
with its public names, record fields and semantics).

The JAX module walks XLA's optimized HLO of a compiled program. The port
has no HLO: its programs are eager aten ops, CUDA graphs of them
(:class:`~fedml_tpu_torch.core.algframe.local_training.StepProgram`), and
four hand-written kernels that the PyTorch dispatcher never sees (they
launch through ``core/kernels/build.py`` with raw pointers). So a capture
is one eager run of the program's body under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode`, once per
(program, signature), on copies of its inputs (the run leaves no trace:
no optimizer update, no RNG advance, no launch counted), and every aten
op that reaches the mode becomes a row:

* FLOPs: matmuls, convolutions and attention through
  ``torch.utils.flop_counter``'s registry (the count of
  ``FlopCounterMode``, and of the engine's ``round_cost_flops``; like it,
  an op the registry lacks is first decomposed); every other op by the JAX
  module's per-op rules (``_op_flops``): views, movement and factories 0,
  elementwise ops their output elements, reductions (normalisations and
  softmaxes among them) their input elements, sort n·log2 n; an op none of
  these names counts its output elements and is marked ``estimated``;
* bytes by ``_op_bytes``: the tensors an op reads plus those it writes,
  views 0, window reads (``index_select``, ``gather``, ``index``) twice
  their output, window writes (``index_put_``, ``scatter``, ``copy_``)
  twice the update;
* a hand-written kernel's launch reports one row itself
  (:func:`kernel_launch`, from ``core/kernels/count_launch``) with its
  shapes and the work of ``core/kernels/cost.py``: the analogue of a known
  custom-call;
* ``mult``: a body repeated N times in a dispatch (a step program's
  replays) is recorded once, its rows multiplied by N (:func:`repeat`), as
  a ``while`` body's trip count is in the JAX module.

Each row's predicted time is ``max(flops / peak, bytes / bandwidth)``
against the card's machine balance (:func:`machine_balance`: the
profiler's peak table and :data:`HBM_GBPS`); the ``kind: roofline``
record sums them into a predicted program time and MFU. On one card there
are no collectives (``collectives`` is ``[]``, ``collective_wire_bytes``
0) and no XLA (``xla_flops`` / ``xla_bytes`` null). On the CPU the
balance is nominal and the record says ``static_only: true``.

Capture is opt-in (``obs_roofline``). Recompile forensics is always on:
every dispatch records its arguments' abstract signature (shapes and
dtypes, never values), and when a dispatch built a program past the
first one per program name (a new step program: built, and on a card
captured into a CUDA graph; the port's compile), a ``kind: recompile``
record names the leaves that changed.

``scripts/roofline_report.py`` renders the records unchanged.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import logging
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import metrics as obs_metrics
from . import profiler as obs_profiler
from . import sink

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# machine balance: HBM GB/s per card, keyed like profiler.PEAK_TFLOPS_BF16
# (public specs: H100 SXM 3.35 TB/s of HBM3, H100 PCIe 2.0 TB/s of HBM2e).
# The "cpu" entry is a NOMINAL host-memory figure so a CPU run still ranks
# its ops: flagged static-only, never a measurement.
HBM_GBPS = (
    ("h100 80gb hbm3", 3350.0), ("h100 sxm", 3350.0), ("h100 pcie", 2000.0),
    ("cpu", 25.0),
)

_cfg = {"default_enabled": False, "max_ops": 64}


def set_default_enabled(on: bool) -> None:
    """Process default for the ``obs_roofline`` knob (``configure``);
    engines read their own args first and fall back to this."""
    _cfg["default_enabled"] = bool(on)


def default_enabled() -> bool:
    return _cfg["default_enabled"]


def hbm_gbps(device: Any = None) -> Optional[float]:
    """HBM GB/s of a torch device, index or card name (None = the current
    CUDA card, else the CPU), or None for a card the table lacks."""
    name = obs_profiler._device_name(device).lower()
    for key, bw in HBM_GBPS:
        if key in name:
            return bw
    return None


@dataclass
class MachineBalance:
    device_kind: str
    peak_tflops: Optional[float]
    hbm_gbps: Optional[float]
    static_only: bool

    @property
    def flops_per_byte(self) -> Optional[float]:
        if not self.peak_tflops or not self.hbm_gbps:
            return None
        return (self.peak_tflops * 1e12) / (self.hbm_gbps * 1e9)


_static_warned = [False]


def machine_balance(device: Any = None) -> MachineBalance:
    """Peak FLOP/s + HBM bandwidth of a device. A CPU (or unknown) kind
    degrades LOUDLY to static-only predictions: the table's host entry
    keeps the ranking meaningful, but the time/MFU columns are a model,
    and the record carries ``static_only: true``."""
    kind = obs_profiler._device_name(device).lower()
    peak = obs_profiler.peak_tflops(kind)
    bw = hbm_gbps(kind)
    static = ("cpu" in kind) or peak is None or bw is None
    if static and not _static_warned[0]:
        _static_warned[0] = True
        logger.warning(
            "roofline: device kind %r has no measured machine balance — "
            "predictions are STATIC-ONLY (shapes/FLOPs/bytes exact, "
            "time/MFU a model); re-capture on the card for real numbers",
            kind)
    return MachineBalance(kind, peak, bw, static)


# ---------------------------------------------------------------------------
# per-op cost model (the JAX module's _op_flops / _op_bytes rules)

_DTYPE = {torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
          torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
          torch.bool: "pred", torch.complex64: "c64",
          torch.complex128: "c128"}

# data movement: 0 flops, bytes from shapes (XLA's copy / convert /
# concatenate / pad); the window ops below are movement too
_MOVEMENT = frozenset((
    "clone", "_to_copy", "copy", "contiguous", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "repeat", "expand_copy",
    "lift_fresh_copy", "tril", "triu",
))
# factories: 0 flops; the fills write their output, ``empty`` nothing
_FACTORIES = frozenset((
    "zeros", "ones", "full", "arange", "scalar_tensor", "zeros_like",
    "ones_like", "full_like", "fill", "fill_", "zero_", "linspace",
))
_EMPTY = frozenset(("empty", "empty_like", "empty_strided",
                    "new_empty", "new_empty_strided", "resize_",
                    "_local_scalar_dense", "set_"))
# views without the view flag in their schema
_VIEWS = frozenset(("_unsafe_view", "lift_fresh", "_reshape_alias"))
# reductions beyond the ``reduction`` tag: ops XLA would fuse from a
# reduction and elementwise ops (normalisations, softmaxes, the loss),
# charged their input elements like a reduce
_REDUCE_LIKE = frozenset((
    "native_group_norm", "native_group_norm_backward", "native_layer_norm",
    "native_layer_norm_backward", "native_batch_norm",
    "native_batch_norm_backward", "_softmax", "_softmax_backward_data",
    "_log_softmax", "_log_softmax_backward_data", "nll_loss_forward",
    "nll_loss_backward", "nll_loss2d_forward", "nll_loss2d_backward",
    "logsumexp", "cumsum", "cumprod", "embedding_dense_backward",
    "_fused_rms_norm", "_fused_rms_norm_backward", "bincount",
    "scatter_reduce", "index_reduce", "max_pool2d_with_indices",
    "max_pool2d_with_indices_backward", "avg_pool2d",
    "avg_pool2d_backward", "_adaptive_avg_pool2d",
    "_adaptive_avg_pool2d_backward", "linalg_vector_norm", "norm",
))
_SORTS = frozenset(("sort", "argsort", "topk", "kthvalue", "median",
                    "msort"))
# window reads charge twice their output; window writes twice the update
_WINDOW_READS = frozenset(("index_select", "gather", "index",
                           "masked_select", "embedding"))
_WINDOW_WRITES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
                  "scatter": 3, "scatter_": 3, "index_add": 3,
                  "index_add_": 3, "scatter_add": 3, "scatter_add_": 3,
                  "slice_scatter": 1, "select_scatter": 1}


def shape_str(t: torch.Tensor) -> str:
    """A tensor's dtype and shape as the JAX module writes an HLO shape
    (``f32[8,16]``)."""
    return f"{_DTYPE.get(t.dtype, str(t.dtype))}" \
           f"[{','.join(str(d) for d in t.shape)}]"


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _elems(ts: Sequence[torch.Tensor]) -> float:
    return float(sum(t.numel() for t in ts))


@dataclass
class OpRow:
    name: str
    opcode: str
    out: str
    operands: List[str]
    flops: float
    bytes: float
    mult: int
    known: bool
    estimated: bool = False

    def shape_key(self) -> str:
        return f"{self.opcode}({','.join(self.operands)})->{self.out}"


def op_cost(func, args: Sequence[Any], kwargs: Dict[str, Any], out: Any
            ) -> Optional[Tuple[float, float, bool]]:
    """(flops, bytes, known) of one aten op, or None for a view (no
    traffic of its own). ``known=False``: no rule names the op; its FLOPs
    are its output elements (the JAX module's unknown-opcode guess)."""
    from torch.utils.flop_counter import flop_registry
    packet = func._overloadpacket
    name = packet.__name__
    if name in _VIEWS or getattr(func, "is_view", False):
        return None
    ins = _tensors(list(args) + list(kwargs.values()))
    outs = _tensors(out)
    if name in _WINDOW_READS:
        return 0.0, 2.0 * sum(map(_nbytes, outs)), True
    if name in _WINDOW_WRITES:
        i = _WINDOW_WRITES[name]
        upd = _tensors(args[i]) if len(args) > i else []
        return 0.0, 2.0 * sum(map(_nbytes, upd or outs)), True
    if name == "copy_":
        # read the source, write the destination (a window of a buffer
        # when it is a view): twice the update
        src = _tensors(args[1:2])
        return 0.0, sum(map(_nbytes, src)) + sum(map(_nbytes, outs)), True
    nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    if packet in flop_registry:
        fl = flop_registry[packet](*args, **kwargs, out_val=out)
        return float(fl), nbytes, True
    if name in _EMPTY:
        return 0.0, 0.0, True
    if name in _FACTORIES:
        return 0.0, sum(map(_nbytes, outs)), True
    if name in _MOVEMENT:
        return 0.0, nbytes, True
    tags = func.tags
    if name in _SORTS:
        n = _elems(ins[:1])
        return n * max(math.log2(max(n, 2.0)), 1.0), nbytes, True
    if torch.Tag.reduction in tags or name in _REDUCE_LIKE:
        return _elems(ins), nbytes, True
    if torch.Tag.pointwise in tags:
        return _elems(outs), nbytes, True
    return _elems(outs), nbytes, False


class _Capture(TorchDispatchMode):
    """Records every aten op of the run it wraps (and kernel launches
    reported through :func:`kernel_launch`) as :class:`OpRow` s."""

    def __init__(self):
        super().__init__()
        self.rows: List[OpRow] = []
        self.mult = 1
        self.paused = False
        self._count: Dict[str, int] = collections.Counter()

    def add(self, name: str, opcode: str, out: str, operands: List[str],
            flops: float, nbytes: float, known: bool) -> None:
        i = self._count[name]
        self._count[name] += 1
        self.rows.append(OpRow(f"{name}.{i}", opcode, out, operands,
                               float(flops), float(nbytes), int(self.mult),
                               known, estimated=not known))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.utils.flop_counter import flop_registry
        # what FlopCounterMode does: an op its registry lacks is first
        # decomposed, and its parts are counted
        if (func not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        cost = op_cost(func, args, kwargs, out)
        if cost is not None:
            flops, nbytes, known = cost
            if flops or nbytes:
                name = func._overloadpacket.__name__
                self.add(name, name,
                         ",".join(shape_str(t) for t in _tensors(out)[:2]),
                         [shape_str(t) for t in
                          _tensors(list(args) + list(kwargs.values()))[:4]],
                         flops, nbytes, known)
        return out


def _active() -> Optional[_Capture]:
    """The capture running here: the innermost on the dispatch-mode
    stack, which autograd hands to its backward threads too (a backward
    kernel launches there)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Capture):
            return mode
    return None


def kernel_launch(wrapper, work: Optional[Callable[[], Tuple]]) -> bool:
    """Called by ``core/kernels/count_launch`` at a hand-written kernel's
    launch. While a capture runs on this thread, record the launch as one
    row (``work()`` gives ``(operand shapes, output shape, bytes, FLOPs)``;
    ``core/kernels/cost.py``; a launch without it is recorded as an
    unknown op) and return True: the launch belongs to the capture, not
    to the program's launch count."""
    cap = _active()
    if cap is None or cap.paused:
        return False
    name = getattr(wrapper, "__name__", str(wrapper))
    if work is None:
        cap.add(name, "kernel", "", [], 0.0, 0.0, False)
    else:
        operands, out, nbytes, flops = work()
        cap.add(name, "kernel", out, list(operands), flops, nbytes, True)
    return True


@contextlib.contextmanager
def repeat(n: int):
    """Rows recorded inside are multiplied by ``n`` (a body run ``n``
    times in the dispatch: the trip count of the JAX module's ``while``
    bodies). Nests multiplicatively; a no-op outside a capture."""
    cap = _active()
    if cap is None:
        yield
        return
    prev = cap.mult
    cap.mult = prev * int(n)
    try:
        yield
    finally:
        cap.mult = prev


@contextlib.contextmanager
def unrecorded():
    """Ops inside are not recorded (a capture's own set-up: copying the
    program's inputs)."""
    cap = _active()
    if cap is None:
        yield
        return
    prev = cap.paused
    cap.paused = True
    try:
        yield
    finally:
        cap.paused = prev


def clone_tree(x: Any) -> Any:
    """Copies of the tensors in nested dicts / lists / tuples (everything
    else as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return type(x)((k, clone_tree(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


def capture_rows(fn: Callable, args: Sequence[Any] = ()) -> List[OpRow]:
    """Run ``fn(*copies of args)`` once under the capture; its rows."""
    args = clone_tree(tuple(args))
    cap = _Capture()
    with cap:
        fn(*args)
    return cap.rows


# ---------------------------------------------------------------------------
# rows -> record


def analyze(program: str, fn: Callable, args: Sequence[Any] = (), *,
            device: Any = None, n_devices: int = 1,
            max_ops: Optional[int] = None) -> Dict[str, Any]:
    """Capture one run of ``fn(*args)`` (on copies of ``args``) into the
    ``kind: roofline`` record payload (the JAX module's
    ``analyze_compiled``)."""
    return record_from_rows(program, capture_rows(fn, args), device=device,
                            n_devices=n_devices, max_ops=max_ops)


def record_from_rows(program: str, rows: List[OpRow], *, device: Any = None,
                     n_devices: int = 1, max_ops: Optional[int] = None
                     ) -> Dict[str, Any]:
    bal = machine_balance(device)
    peak_fs = (bal.peak_tflops or 0.0) * 1e12
    bw_bs = (bal.hbm_gbps or 0.0) * 1e9

    def row_time(r: OpRow) -> float:
        t_c = (r.flops * r.mult / peak_fs) if peak_fs else 0.0
        t_m = (r.bytes * r.mult / bw_bs) if bw_bs else 0.0
        return max(t_c, t_m)

    total_flops = sum(r.flops * r.mult for r in rows)
    total_bytes = sum(r.bytes * r.mult for r in rows)
    times = [row_time(r) for r in rows]
    predicted_s = sum(times)
    mem_t = comp_t = unknown_t = 0.0
    balance = bal.flops_per_byte
    op_rows: List[Dict[str, Any]] = []
    for r, t in zip(rows, times):
        intensity = (r.flops / r.bytes) if r.bytes else None
        if not r.known:
            cls = "unknown"
            unknown_t += t
        elif balance is None or intensity is None:
            cls = "memory"
            mem_t += t
        elif intensity >= balance:
            cls = "compute"
            comp_t += t
        else:
            cls = "memory"
            mem_t += t
        op_rows.append({
            "name": r.name, "op": r.opcode, "op_name": "",
            "out": r.out, "operands": r.operands,
            "flops": r.flops * r.mult, "bytes": r.bytes * r.mult,
            "mult": r.mult,
            "intensity": (round(intensity, 4) if intensity is not None
                          else None),
            "bound": cls,
            "time_s": t,
            "share": (t / predicted_s) if predicted_s else 0.0,
            "estimated": bool(r.estimated),
        })
    op_rows.sort(key=lambda d: d["time_s"], reverse=True)
    cap = _cfg["max_ops"] if max_ops is None else int(max_ops)
    if cap and len(op_rows) > cap:
        rest = op_rows[cap:]
        op_rows = op_rows[:cap]
        op_rows.append({
            "name": "(other)", "op": "(other)", "op_name": "",
            "out": "", "operands": [],
            "flops": sum(d["flops"] for d in rest),
            "bytes": sum(d["bytes"] for d in rest), "mult": 1,
            "intensity": None, "bound": "mixed",
            "time_s": sum(d["time_s"] for d in rest),
            "share": sum(d["share"] for d in rest),
            "estimated": False,
        })
    predicted_mfu = None
    if peak_fs and predicted_s:
        predicted_mfu = total_flops / predicted_s / peak_fs
    attributed = 1.0 - (unknown_t / predicted_s if predicted_s else 0.0)
    return {
        "program": str(program),
        "device_kind": bal.device_kind,
        "n_devices": int(n_devices),
        "static_only": bool(bal.static_only),
        "peak_tflops": bal.peak_tflops,
        "hbm_gbps": bal.hbm_gbps,
        "balance_flops_per_byte": (round(balance, 2)
                                   if balance is not None else None),
        "total_flops": float(total_flops),
        "total_bytes": float(total_bytes),
        "predicted_s": float(predicted_s),
        "predicted_mfu": (round(predicted_mfu, 5)
                          if predicted_mfu is not None else None),
        "attributed_share": round(attributed, 5),
        "memory_bound_share": round(mem_t / predicted_s, 5)
        if predicted_s else 0.0,
        "compute_bound_share": round(comp_t / predicted_s, 5)
        if predicted_s else 0.0,
        # one card: no collective moves a byte
        "collective_wire_bytes": 0.0,
        "xla_flops": None,
        "xla_bytes": None,
        "ops": op_rows,
        "collectives": [],
    }


# ---------------------------------------------------------------------------
# per-engine dispatch tracker: opt-in roofline capture + always-on
# recompile forensics at the engine / serving dispatch seams

# most recent recompile-forensics records, process-wide
_recent_recompiles: collections.deque = collections.deque(maxlen=16)

# last roofline record per program name, process-wide
_reports: Dict[str, Dict[str, Any]] = {}


def recent_recompiles() -> List[Dict[str, Any]]:
    return list(_recent_recompiles)


def report(program: str) -> Optional[Dict[str, Any]]:
    return _reports.get(program)


def reports() -> Dict[str, Dict[str, Any]]:
    return dict(_reports)


def _leaf_desc(leaf: Any) -> str:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return f"py:{type(leaf).__name__}"
    return f"{str(dtype).replace('torch.', '')}" \
           f"[{','.join(str(d) for d in shape)}]"


def _flatten(x: Any, leaves: List[Any]) -> Any:
    """Append ``x``'s leaves (dict values in sorted-key order, as
    ``jax.tree_util`` flattens) and return its structure (hashable)."""
    if isinstance(x, dict):
        keys = sorted(x, key=str)
        return ("d", tuple((k, _flatten(x[k], leaves)) for k in keys))
    if isinstance(x, (list, tuple)):
        return ("l" if isinstance(x, list) else "t",
                tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _paths(struct: Any, prefix: str, out: List[str]) -> None:
    if struct is None:
        out.append(prefix)
        return
    kind, items = struct
    if kind == "d":
        for k, sub in items:
            _paths(sub, f"{prefix}[{k!r}]", out)
    else:
        for i, sub in enumerate(items):
            _paths(sub, f"{prefix}[{i}]", out)


# leaf paths memoized per structure: the serving decode step calls
# dispatch_signature once per generated token, and the per-leaf path
# strings are the expensive half; structure repeats, so pay it once
_path_cache: Dict[Any, List[str]] = {}


def dispatch_signature(args: Any) -> Tuple[Tuple[str, str], ...]:
    """Abstract signature of a dispatch's args: (tree path, shape/dtype)
    per leaf — values never recorded. Cheap enough for every dispatch
    (it is what makes recompile forensics free at default knobs)."""
    leaves: List[Any] = []
    struct = _flatten(args, leaves)
    paths = _path_cache.get(struct)
    if paths is None:
        if len(_path_cache) > 128:   # bounded: structures per process
            _path_cache.clear()
        paths = []
        _paths(struct, "", paths)
        _path_cache[struct] = paths
    return tuple(zip(paths, (_leaf_desc(l) for l in leaves)))


class DispatchTracker:
    """Per-engine-instance compute-plane seam. ``observe`` gives
    recompile forensics on every dispatch; ``maybe_capture`` does the
    opt-in roofline capture, once per (program, signature): ``fn(*args)``
    runs once on copies of ``args`` under the capture (call it outside a
    CUDA-graph capture, and charge nothing it does to the dispatch)."""

    def __init__(self, enabled: Optional[bool] = None,
                 n_devices: int = 1, device: Any = None):
        self.enabled = (bool(enabled) if enabled is not None
                        else _cfg["default_enabled"])
        self.n_devices = int(n_devices)
        self.device = device
        self._sigs: Dict[str, Tuple[Tuple[str, str], ...]] = {}
        self._compiles: Dict[str, int] = {}
        # SET of captured signatures per program: a shape-alternating
        # program pays one capture per distinct signature, not one per
        # dispatch
        self._captured: Dict[str, set] = {}

    # --- roofline capture (opt-in) -------------------------------------
    def maybe_capture(self, program: str, fn: Callable,
                      args: Sequence[Any] = (),
                      sig: Optional[Tuple] = None
                      ) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            return None
        if sig is None:
            sig = dispatch_signature(tuple(args))
        seen = self._captured.setdefault(program, set())
        if sig in seen:
            return None
        seen.add(sig)
        try:
            rec = analyze(program, fn, args, device=self.device,
                          n_devices=self.n_devices)
        except Exception as e:  # capture must never sink a run
            logger.warning("roofline capture of %r failed (%s: %s)",
                           program, type(e).__name__, e)
            return None
        _reports[program] = rec
        sink.emit("roofline", rec)
        obs_metrics.record_roofline(
            program, rec.get("predicted_mfu"),
            rec.get("memory_bound_share"),
            rec.get("collective_wire_bytes"))
        logger.info(
            "roofline[%s]: %d ops, predicted %s, mfu %s, memory-bound "
            "share %.2f%s", program, len(rec["ops"]),
            f"{rec['predicted_s'] * 1e3:.3f} ms", rec["predicted_mfu"],
            rec["memory_bound_share"],
            " (STATIC-ONLY: cpu balance)" if rec["static_only"] else "")
        return rec

    # --- recompile forensics (always on) -------------------------------
    def observe(self, program: str, sig: Tuple[Tuple[str, str], ...],
                compiles: int) -> Optional[Dict[str, Any]]:
        """Record a dispatch's signature; when the dispatch built a
        program PAST the pinned expectation (one per program name), emit
        the ``kind: recompile`` forensics record naming the changed
        abstract shapes."""
        prev = self._sigs.get(program)
        self._sigs[program] = sig
        if compiles <= 0:
            return None
        total = self._compiles.get(program, 0) + int(compiles)
        self._compiles[program] = total
        if prev is None:
            return None   # the expected first compile
        changed: List[Dict[str, Any]] = []
        old = dict(prev)
        new = dict(sig)
        for path in new:
            if path not in old:
                changed.append({"arg": path, "was": None,
                                "now": new[path]})
            elif old[path] != new[path]:
                changed.append({"arg": path, "was": old[path],
                                "now": new[path]})
        for path in old:
            if path not in new:
                changed.append({"arg": path, "was": old[path],
                                "now": None})
        note = None
        if not changed:
            note = ("no abstract-shape change — a new program from a "
                    "new model, optimizer or dtype")
        rec = {"program": str(program), "compiles": int(compiles),
               "total_compiles": int(total), "expected": 1,
               "changed": changed, "note": note}
        sink.emit("recompile", rec)
        obs_metrics.record_recompile(program)
        _recent_recompiles.append(rec)
        logger.warning(
            "recompile forensics[%s]: %d compile(s) past the pinned "
            "expectation; changed: %s", program,
            compiles, changed or note)
        return rec


def program_twin(program: Any) -> Any:
    """A shallow copy of ``program`` (a step or gradient program, or any
    object whose state is tensors in its attributes) with copies of every
    tensor it holds, one level into its attribute objects (the dropout
    keys): its body runs on the copies and leaves the program as it
    was."""
    twin = copy.copy(program)
    for k, v in vars(program).items():
        if isinstance(v, (torch.Tensor, dict, list, tuple)):
            setattr(twin, k, clone_tree(v))
        elif hasattr(v, "__dict__") and any(
                isinstance(a, torch.Tensor) for a in vars(v).values()):
            sub = copy.copy(v)
            for a, t in vars(v).items():
                if isinstance(t, torch.Tensor):
                    setattr(sub, a, t.detach().clone())
            setattr(twin, k, sub)
    return twin
