"""Environment collection (counterpart of ``fedml_tpu/utils/collect_env.py``;
reference ``computing/scheduler/env/collect_env.py:11`` — prints the OS,
python, framework and accelerator inventory, through ``fedml_tpu_torch
env``).

A report, not an entry point: on a host with no card it lists 0 CUDA
devices and never raises.
"""

from __future__ import annotations

import importlib
import os
import platform
import sys


def _version(mod: str) -> str:
    try:
        return str(getattr(importlib.import_module(mod), "__version__", "?"))
    except ImportError:
        return "not installed"


def collect_env() -> str:
    lines = []
    lines.append("======== fedml_tpu_torch environment ========")
    import fedml_tpu_torch
    lines.append(f"fedml_tpu_torch:   {fedml_tpu_torch.__version__}")
    lines.append(f"python:            {sys.version.split()[0]}")
    lines.append(f"os:                {platform.platform()}")
    lines.append(f"cpu count:         {os.cpu_count()}")
    try:
        import psutil
        vm = psutil.virtual_memory()
        lines.append(f"memory:            {vm.total / 2**30:.1f} GiB "
                     f"({vm.percent}% used)")
    except ImportError:
        pass
    import torch
    cudnn = torch.backends.cudnn.version() if torch.cuda.is_available() \
        else None
    lines.append(f"{'torch:':<19}{torch.__version__}")
    lines.append(f"{'cuda (torch):':<19}{torch.version.cuda or 'none'}")
    lines.append(f"{'cudnn:':<19}{cudnn if cudnn is not None else 'none'}")
    for mod in ("triton", "numpy"):
        lines.append(f"{mod + ':':<19}{_version(mod)}")
    lines.append("-------- accelerators --------")
    try:
        n = torch.cuda.device_count()
        lines.append(f"cuda devices:      {n}")
        for i in range(min(n, 8)):
            p = torch.cuda.get_device_properties(i)
            lines.append(f"  - cuda:{i} {p.name} (sm_{p.major}{p.minor}, "
                         f"{p.total_memory / 2**30:.1f} GiB)")
        if n > 8:
            lines.append(f"  ... and {n - 8} more")
    except Exception as e:  # noqa: BLE001 — report, never crash env print
        lines.append(f"cuda devices unavailable: {e}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(collect_env())
