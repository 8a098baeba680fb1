"""Start W rank processes on this host and collect what each returns: the
launcher the tests and ``chip_smoke.py`` share, in place of ``torchrun``.

    from fedml_tpu_torch.core.launch import run_ranks
    results = run_ranks("mymodule:rank_main", 2, {"cfg": cfg})

Each rank is a fresh ``python -m fedml_tpu_torch.core.launch`` process with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); it imports
``module:function``, calls it with the keyword arguments, and writes its
return value back. The target joins the group itself
(:func:`fedml_tpu_torch.core.mesh.init_ranks`, or an entry point that
takes ``mesh_shape``); the process leaves it after the target returns.

The parent waits at most ``timeout`` seconds: a rank that fails or
outlives it kills every rank, and the call raises with the end of the
failing rank's output. Nothing survives the call.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_ranks(target: str, world: int, kwargs: Optional[Dict] = None, *,
              timeout: float = 300.0, threads: int = 1,
              sys_path: Sequence[str] = ()) -> List[Any]:
    """Run ``target`` (``"module:function"``) in ``world`` rank processes
    with ``kwargs``; returns each rank's return value, rank order.
    ``threads`` caps each rank's CPU threads; ``sys_path`` adds import
    paths (the package's root is always there)."""
    with tempfile.TemporaryDirectory(prefix="fedml_ranks_") as tmp:
        tmp = Path(tmp)
        spec = tmp / "spec.pkl"
        spec.write_bytes(pickle.dumps((target, dict(kwargs or {}))))
        path = os.pathsep.join([str(ROOT), *map(str, sys_path),
                                os.environ.get("PYTHONPATH", "")])
        base = dict(os.environ, PYTHONPATH=path,
                    WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                    OMP_NUM_THREADS=str(threads),
                    FEDML_RANK_THREADS=str(threads))
        procs, logs = [], []
        try:
            for r in range(world):
                log = tmp / f"rank{r}.log"
                logs.append(log)
                with open(log, "wb") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "fedml_tpu_torch.core.launch",
                         str(spec), str(tmp / f"rank{r}.pkl")],
                        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                        stdout=out, stderr=subprocess.STDOUT, cwd=str(ROOT)))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = bad[0]
                    raise RuntimeError(
                        f"rank {r} of {world} ({target}) exited with "
                        f"{codes[r]}:\n{_tail(logs[r])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    late = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(
                        f"ranks {late} of {world} ({target}) still running "
                        f"after {timeout:.0f} s:\n{_tail(logs[late[0]])}")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
                for r in range(world)]


def _main(spec_path: str, out_path: str) -> int:
    import faulthandler

    import torch
    # a rank that dies in native code (a backend, a kernel) leaves its
    # Python stack in its log
    faulthandler.enable()
    torch.set_num_threads(int(os.environ.get("FEDML_RANK_THREADS", "1")))
    target, kwargs = pickle.loads(Path(spec_path).read_bytes())
    module, fn = target.split(":")
    result = getattr(importlib.import_module(module), fn)(**kwargs)
    from .mesh import close_ranks
    close_ranks()
    Path(out_path).write_bytes(pickle.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], sys.argv[2]))
