"""Multi-LoRA adapter bank: named per-user/per-silo adapters resident as
ONE stacked dict the decode step gathers from (counterpart of
``fedml_tpu/serving/batch/adapter_bank.py``).

``llm/federated.py`` trains per-silo LoRA adapters (kilobytes each); the
bank holds them side by side over one frozen base model, and every
request selects its adapter by name — the selection becomes a per-slot
integer index and the gather happens inside the step, so serving a new
silo's users costs one bank row, not a model replica (S-LoRA's
economics). Adapters are the port's flat LoRA dicts
(``layer_0.attn.q.lora_a`` ...).

The stack is CAPACITY-padded: leaves are ``[capacity, ...]`` from
construction, so registering adapter #2 through #capacity never changes
the step's input shapes. Index 0 is always the zero adapter — requests
with no adapter get the base model exactly.

Hot-swap: :meth:`AdapterBank.swap` publishes a NEW version of a named
adapter by writing a FRESH row and repointing the name — never by
overwriting the live row — so requests already in flight (which resolved
the name to a row at submit and pinned it via :meth:`retain_row`) keep
the exact version they started with; the retired row returns to the free
pool when its last pin drops. Watching an export directory
(``watch_dir``) and building a bank from artifacts (``from_artifacts``)
need the msgpack artifact codec, which is not ported yet: both raise.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

Params = Dict[str, Any]
logger = logging.getLogger(__name__)

BASE_ADAPTER = "base"


class AdapterBank:
    """Named LoRA adapters over one base model.

    ``template``: any flat adapter dict with the served model's LoRA
    structure (``lora_init`` output or a trained adapter) — defines the
    keys and leaf shapes; its values are NOT registered. ``capacity``:
    maximum adapters (including the reserved zero adapter at index 0)."""

    def __init__(self, template: Params, alpha: float = 16.0,
                 capacity: int = 64):
        self._keys = list(template)
        if not self._keys:
            raise ValueError("adapter template has no leaves")
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.alpha = float(alpha)
        # rank from the lora_a leaves: [d_in, r]
        a = next(template[k] for k in self._keys if k.endswith(".lora_a"))
        self.rank = int(a.shape[-1] if len(a.shape) == 2 else 0)
        self._lock = threading.Lock()
        self._names: Dict[str, int] = {BASE_ADAPTER: 0}
        # host mirror [capacity, ...] per leaf; row 0 stays zero
        self._host: List[np.ndarray] = [
            np.zeros((self.capacity,) + tuple(template[k].shape), np.float32)
            for k in self._keys]
        # device copies of the stack, rebuilt lazily after a write
        self._stacks: Dict[torch.device, Params] = {}
        # hot-swap bookkeeping: per-row in-flight pins and rows whose name
        # moved on (reusable once unpinned)
        self._row_refs: Dict[int, int] = {}
        self._retired: set = set()
        self.swaps = 0

    @property
    def scale(self) -> float:
        """The merged path's ``alpha / rank`` factor."""
        r = max(self.rank, 1)
        return self.alpha / r

    def __len__(self) -> int:
        with self._lock:
            return len(self._names)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._names, key=self._names.get)

    def _check_leaves(self, name: str, adapter: Params) -> List[np.ndarray]:
        if set(adapter) != set(self._keys):
            raise ValueError(
                f"adapter {name!r}: keys {sorted(adapter)} != template's "
                f"{sorted(self._keys)}")
        arrs = []
        for host, key in zip(self._host, self._keys):
            leaf = adapter[key]
            if torch.is_tensor(leaf):
                leaf = leaf.detach().float().cpu().numpy()
            arr = np.asarray(leaf, np.float32)
            if arr.shape != host.shape[1:]:
                raise ValueError(
                    f"adapter {name!r}: leaf shape {arr.shape} != "
                    f"template {host.shape[1:]} (same targets and "
                    "rank required)")
            arrs.append(arr)
        return arrs

    def _next_row_locked(self) -> int:
        """Smallest unused, unretired row (row 0 reserved). Retired rows
        rejoin the pool only when their last in-flight pin drops."""
        in_use = set(self._names.values()) | self._retired
        for r in range(1, self.capacity):
            if r not in in_use:
                return r
        raise RuntimeError(
            f"adapter bank full ({self.capacity}); raise "
            "serving_max_adapters")

    def add(self, name: str, adapter: Params) -> int:
        """Register (or replace IN PLACE) a named adapter; returns its
        index. In-place replacement mutates the live row — use
        :meth:`swap` when requests may be in flight on the old
        version."""
        arrs = self._check_leaves(name, adapter)
        with self._lock:
            if name == BASE_ADAPTER:
                raise ValueError(f"{BASE_ADAPTER!r} is the reserved zero "
                                 "adapter")
            idx = self._names.get(name)
            if idx is None:
                idx = self._next_row_locked()
                self._names[name] = idx
            for host, arr in zip(self._host, arrs):
                host[idx] = arr
            self._stacks.clear()
        return idx

    def swap(self, name: str, adapter: Params) -> int:
        """Hot-swap: publish a new version of ``name`` on a FRESH row
        and repoint the name — in-flight requests pinned to the old row
        keep the version they started with; the old row is retired and
        reused only once its last pin drops. A previously unknown name
        is simply added. Returns the (new) index."""
        arrs = self._check_leaves(name, adapter)
        with self._lock:
            if name == BASE_ADAPTER:
                raise ValueError(f"{BASE_ADAPTER!r} is the reserved zero "
                                 "adapter")
            old = self._names.get(name)
            idx = self._next_row_locked()
            for host, arr in zip(self._host, arrs):
                host[idx] = arr
            self._names[name] = idx
            if old is not None and old != 0:
                if self._row_refs.get(old, 0) > 0:
                    self._retired.add(old)
                # unpinned old row: implicitly free (not named, not
                # retired) — _next_row_locked can hand it out again
            self.swaps += 1
            self._stacks.clear()
        from ...core.obs import metrics as obs_metrics
        obs_metrics.record_llm_adapter_swap(name)
        logger.info("adapter bank: hot-swapped %r -> row %d (old row "
                    "%s)", name, idx, old)
        return idx

    def acquire(self, name: str) -> int:
        """Resolve a name to its row AND pin it, under ONE lock hold —
        a separate ``index()`` + ``retain_row()`` pair leaves a window
        where a concurrent swap retires-and-reuses the resolved row and
        the request decodes someone else's weights. Pair with
        :meth:`release_row`. Unknown names raise like :meth:`index`."""
        with self._lock:
            idx = self._names.get(str(name))
            if idx is None:
                loaded = sorted(self._names, key=self._names.get)
                raise KeyError(f"unknown adapter {name!r}; loaded: "
                               f"{loaded}")
            if idx > 0:
                self._row_refs[idx] = self._row_refs.get(idx, 0) + 1
            return idx

    def retain_row(self, idx: int) -> None:
        """Pin a row for an in-flight request (the engine calls this at
        submit): a pinned retired row is never reused. For pinning BY
        NAME use :meth:`acquire` — it closes the resolve-then-pin race
        against a concurrent hot-swap."""
        i = int(idx)
        if i <= 0:
            return   # the zero adapter is immutable
        with self._lock:
            self._row_refs[i] = self._row_refs.get(i, 0) + 1

    def release_row(self, idx: int) -> None:
        i = int(idx)
        if i <= 0:
            return
        with self._lock:
            n = self._row_refs.get(i, 0)
            if n <= 1:
                self._row_refs.pop(i, None)
                self._retired.discard(i)   # now reusable
            else:
                self._row_refs[i] = n - 1

    # --- watched hot-swap ---------------------------------------------------
    def watch_dir(self, manifest_dir: str, poll_s: float = 2.0,
                  swap_existing: bool = False) -> None:
        """Poll a ``save_adapter_artifacts`` dir and hot-swap changed
        adapters live — needs the msgpack artifact codec, not ported."""
        raise NotImplementedError(
            "AdapterBank.watch_dir needs the msgpack artifact codec "
            "(serving.save_model/load_model), which is not ported to "
            "fedml_tpu_torch yet; use swap() with an adapter dict")

    def stop_watch(self) -> None:
        """Nothing to stop: :meth:`watch_dir` is not ported."""

    def index(self, name: Optional[str]) -> int:
        """Name → bank index; ``None`` → the zero adapter. Unknown names
        raise — serving a user the WRONG personalization silently is the
        one failure mode a personalization gateway must not have."""
        if name is None:
            return 0
        with self._lock:
            idx = self._names.get(str(name))
        if idx is None:
            raise KeyError(f"unknown adapter {name!r}; loaded: "
                           f"{self.names()}")
        return idx

    def has(self, name: str) -> bool:
        with self._lock:
            return str(name) in self._names

    def stack(self, device: Optional[torch.device] = None) -> Params:
        """The resident ``[capacity, ...]`` stack on ``device`` (the CPU
        when None), rebuilt lazily after a write; the capacity padding
        keeps its shapes constant."""
        dev = torch.device("cpu") if device is None else torch.device(device)
        with self._lock:
            st = self._stacks.get(dev)
            if st is None:
                st = {k: torch.from_numpy(h.copy()).to(dev)
                      for k, h in zip(self._keys, self._host)}
                self._stacks[dev] = st
            return st

    @classmethod
    def from_artifacts(cls, manifest_dir: str, alpha: float = 16.0,
                       capacity: int = 64) -> "AdapterBank":
        """Build a bank from a ``save_adapter_artifacts`` directory —
        needs the msgpack artifact codec, not ported."""
        raise NotImplementedError(
            "AdapterBank.from_artifacts needs the msgpack artifact codec, "
            "which is not ported to fedml_tpu_torch yet; build the bank "
            "with AdapterBank(template) and add()")
