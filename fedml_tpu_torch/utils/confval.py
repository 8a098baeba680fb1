"""Config-value access that treats an explicit 0/0.0/False as meaningful
(counterpart of ``fedml_tpu/utils/confval.py``).

The ``getattr(args, k, d) or d`` idiom silently replaces legitimate
zero-valued hyperparameters (slsgd alpha: 0.0, attack_scale: 0.0) with the
default; use :func:`get_arg` instead — only None/missing fall back.
"""

from __future__ import annotations

from typing import Any


def get_arg(args: Any, name: str, default: Any = None) -> Any:
    val = getattr(args, name, None)
    return default if val is None else val


def get_float(args: Any, name: str, default: float) -> float:
    return float(get_arg(args, name, default))


def get_int(args: Any, name: str, default: int) -> int:
    return int(get_arg(args, name, default))
