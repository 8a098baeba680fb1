"""Round-level checkpoint/resume (counterpart of
``fedml_tpu/core/checkpoint.py``).

The JAX package writes its round checkpoints with orbax; the port writes
them with the msgpack wire codec (``serving.save_model``: magic header,
``dumps_tree``, temporary file and ``os.replace``), one file per round,
``round_<r>.fmtpu``. The two packages do not read each other's
checkpoints. The state is the simulators' ``params``, ``server_state``,
round ``rng`` and, for an optimizer with per-client state,
``client_states`` (the GPU engine's ``[num_clients, ...]`` stack, the SP
loop's list); a resumed run continues at the round after the newest
checkpoint.
"""

from __future__ import annotations

import logging
import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

PyTree = Any

_FILE = re.compile(r"^round_(\d+)\.fmtpu$")


def _host_copy(tree: PyTree) -> PyTree:
    """A host copy of every leaf, made now: the device tensors may be
    rewritten by the next round (a step program's static tensors) before
    the writer thread gets to them."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if tree is None:
        return None
    return np.array(tree, copy=True)


def _restore_as(template: PyTree, loaded: PyTree, path: str = "") -> PyTree:
    """``loaded`` (numpy leaves) in ``template``'s structure, each leaf
    with the template leaf's shape, dtype and (for tensors) device."""
    from .distributed.communication.message import array_to_tensor
    if isinstance(template, dict):
        got = sorted(loaded) if isinstance(loaded, dict) else type(loaded)
        if got != sorted(template):
            raise ValueError(f"checkpoint {path or '/'}: holds {got}, the "
                             f"run has {sorted(template)}")
        return {k: _restore_as(v, loaded[k], f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore_as(t, v, f"{path}/{i}") for i, (t, v)
                              in enumerate(zip(template, loaded)))
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        t = array_to_tensor(loaded).reshape(template.shape)
        return t.to(template.device, template.dtype)
    a = np.asarray(template)
    return np.asarray(loaded, a.dtype).reshape(a.shape)


class RoundCheckpointer:
    """Checkpoints keyed by round index. Enabled only when ``directory``
    is set and ``every_rounds > 0``; keeps the ``max_to_keep`` newest.

    The save is asynchronous: :meth:`maybe_save` takes the host snapshot
    synchronously and hands the disk write to a writer thread, so the
    round loop keeps training. :meth:`flush` waits for every write (and
    raises a write's error) and stops the thread; :meth:`latest` flushes
    before it restores."""

    def __init__(self, directory: Optional[str], every_rounds: int = 0,
                 max_to_keep: int = 3):
        self.enabled = bool(directory) and int(every_rounds) > 0
        self.every = max(int(every_rounds), 1)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.path: Optional[str] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        if self.enabled:
            self.path = os.path.abspath(os.path.expanduser(directory))
            os.makedirs(self.path, exist_ok=True)

    def steps(self) -> List[int]:
        """Rounds with a checkpoint on disk, oldest first."""
        if not self.enabled:
            return []
        found = (_FILE.match(f) for f in os.listdir(self.path))
        return sorted(int(m.group(1)) for m in found if m)

    def file(self, round_idx: int) -> str:
        return os.path.join(self.path, f"round_{int(round_idx):08d}.fmtpu")

    def maybe_save(self, round_idx: int, state: PyTree) -> bool:
        """Save if the cadence hits (``(round_idx + 1) % every == 0``).
        Returns whether it did."""
        if not self.enabled or (round_idx + 1) % self.every != 0:
            return False
        snapshot = _host_copy(state)
        if self._pool is None:
            # one writer: writes and pruning stay in round order
            self._pool = ThreadPoolExecutor(
                1, thread_name_prefix="round-checkpoint")
        self._pending.append(self._pool.submit(self._write, int(round_idx),
                                               snapshot))
        logger.info("checkpointing round %d (async)", round_idx)
        return True

    def _write(self, round_idx: int, snapshot: PyTree) -> None:
        from ..serving import save_model
        save_model(snapshot, self.file(round_idx))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.file(old))

    def flush(self) -> None:
        """Block until every scheduled save is on disk. The blocking wall
        time lands in the ``fed_checkpoint_flush_seconds`` histogram: the
        checkpointing cost the round loop actually pays."""
        if self._pool is None:
            return
        from .obs import metrics as obs_metrics
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        pool, self._pool = self._pool, None
        try:
            for fut in pending:
                fut.result()
        finally:
            pool.shutdown(wait=True)
        obs_metrics.record_checkpoint_flush(time.perf_counter() - t0)

    def latest(self, template: PyTree) -> Optional[Tuple[int, PyTree]]:
        """``(round, state)`` of the newest checkpoint, in ``template``'s
        structure and leaf types, or None."""
        if not self.enabled:
            return None
        self.flush()
        steps = self.steps()
        if not steps:
            return None
        from ..serving import load_model
        loaded = load_model(self.file(steps[-1]))
        return steps[-1], _restore_as(template, loaded)

    def close(self) -> None:
        self.flush()
