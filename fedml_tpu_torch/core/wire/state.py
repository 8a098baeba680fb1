"""Wire-pipeline state joins the round checkpoint (a copy of
``fedml_tpu/core/wire/state.py`` over the port's ``RoundCheckpointer``).

Error-feedback compression is stateful: each sender carries a residual
of everything its sparsifier dropped, and each decoder tracks the base
the next delta applies to. A crash that loses the residual silently
drops accumulated (unsent) gradient mass; one that loses the base
corrupts every later delta. This module gives the cross-silo managers
(and the async server's per-sender pour residuals) a fixed-template
``RoundCheckpointer`` slot for exactly that state, reusing the existing
``checkpoint_dir`` / ``checkpoint_every_rounds`` knobs — off by
default, and resume-vs-uninterrupted parity is pinned in
``tests/test_wire.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..checkpoint import RoundCheckpointer

__all__ = ["wire_checkpointer", "wire_state_template", "pack_optional_vec",
           "unpack_optional_vec"]


def wire_checkpointer(args, role: str) -> Optional[RoundCheckpointer]:
    """A checkpointer for one manager's wire state, namespaced under the
    session's ``checkpoint_dir`` (``wire_<role>/``) so it never collides
    with the engine's model checkpoints. None when checkpointing is off."""
    directory = getattr(args, "checkpoint_dir", None)
    every = int(getattr(args, "checkpoint_every_rounds", 0) or 0)
    if not directory or every <= 0:
        return None
    return RoundCheckpointer(os.path.join(str(directory), f"wire_{role}"),
                             every_rounds=every)


def pack_optional_vec(vec, d: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(set_flag, f32[d])`` pair for a maybe-None vector — checkpoint
    templates need fixed shapes, and a fresh manager's residual/base are
    legitimately None until first use."""
    if vec is None:
        return np.zeros((), np.int32), np.zeros((d,), np.float32)
    return np.ones((), np.int32), np.asarray(vec, np.float32).reshape(d)


def unpack_optional_vec(flag, arr) -> Optional[np.ndarray]:
    return np.asarray(arr, np.float32) if int(flag) else None


def wire_state_template(d: int, vecs: Sequence[str],
                        matrices: Dict[str, int] = None) -> Dict:
    """Fixed-shape restore template: a round cursor, ``(flag, [d])``
    slots for each named vector, and optional ``[n, d]`` matrix slots
    (async per-sender residuals)."""
    out = {"round": np.zeros((), np.int32)}
    for name in vecs:
        out[f"{name}_set"] = np.zeros((), np.int32)
        out[name] = np.zeros((d,), np.float32)
    for name, n in (matrices or {}).items():
        out[f"{name}_set"] = np.zeros((n,), np.int32)
        out[name] = np.zeros((n, d), np.float32)
    return out
