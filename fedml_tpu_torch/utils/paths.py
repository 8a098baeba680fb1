"""Filesystem path hygiene for peer-supplied paths."""

from __future__ import annotations

import os


def confine_path(path: str, root: str) -> str:
    """Resolve ``path`` and require it to live inside ``root``.

    File paths that arrive in wire messages from peers (cross-device model
    artifacts, object-store keys) must never escape their cache dir — an
    adversarial peer could otherwise point the process at an arbitrary
    local file. Combined with the msgpack artifact codec (no pickle) this
    makes file exchange read-only and confined."""
    real = os.path.realpath(path)
    root_real = os.path.realpath(root)
    if os.path.commonpath([real, root_real]) != root_real:
        raise ValueError(
            f"model file path {path!r} escapes the cache dir {root!r}")
    return real
