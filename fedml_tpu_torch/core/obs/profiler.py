"""Critical-path profiling at the engine's dispatch seam (counterpart of
``fedml_tpu/core/obs/profiler.py``).

Under ``obs_profile_device`` the GPU engine splits a block's wall time
into

* ``host_s`` — the host's part: enqueueing the block's steps (CUDA
  returns before the device finishes), and
* ``device_wait_s`` — the tail the host then waits for the device
  (``torch.cuda.synchronize``),

names the block in a ``torch.profiler`` trace (``record_function``), and
turns the engine's FLOPs model (``round_cost_flops``) into a per-round MFU
gauge and a ``kind: profile`` record. It is opt-in because the wait
defeats the overlap of the host enqueueing the next block with the device
running this one.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import metrics as obs_metrics
from . import sink

# bf16 dense peak TFLOP/s per chip, by device-name substring (public
# specs). The TPU entries are the JAX package's table (for its device
# kinds); the NVIDIA entries are the data sheets' dense bf16 tensor-core
# rates, matched against ``torch.cuda.get_device_name``: H100 SXM (sold as
# "H100 80GB HBM3") 989, H100 PCIe 756. A name not listed gives None:
# MFU is then null, never a guess.
PEAK_TFLOPS_BF16 = (
    ("h100 80gb hbm3", 989.0), ("h100 sxm", 989.0), ("h100 pcie", 756.0),
    ("v6", 918.0), ("v5p", 459.0), ("v5e", 197.0), ("v5", 197.0),
    ("v4", 275.0), ("v3", 123.0), ("v2", 45.0), ("cpu", 0.5),
)


def _device_name(device: Any = None) -> str:
    """A torch device (or index, or None = the current CUDA device, else
    the CPU) -> the name the peak table is keyed by."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def peak_tflops(device: Any = None) -> Optional[float]:
    """Per-chip bf16 peak for a device or device name, or None for a name
    the table does not list."""
    name = _device_name(device).lower()
    for key, peak in PEAK_TFLOPS_BF16:
        if key in name:
            return peak
    return None


def mfu_value(flops: float, wall_s: float, n_devices: int,
              peak_tflops_per_chip: Optional[float] = None,
              device: Any = None) -> Optional[float]:
    """MFU = achieved FLOP/s / (peak per chip x chips). ``flops`` is the
    useful work done in ``wall_s`` on all devices: the engine's FLOPs
    model counts real (unpadded) local steps only."""
    if not flops or not wall_s or wall_s <= 0:
        return None
    if peak_tflops_per_chip is None:
        peak_tflops_per_chip = peak_tflops(device)
    if not peak_tflops_per_chip:
        return None
    achieved_tflops = (flops / wall_s) / 1e12
    return achieved_tflops / (peak_tflops_per_chip * max(int(n_devices), 1))


def sample_hbm_peak_gb(device: Any = None) -> Optional[float]:
    """Peak device memory allocated by this process (GiB,
    ``torch.cuda.max_memory_allocated``; monotonic until
    ``reset_peak_memory_stats``), or None on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    obs_metrics.record_hbm_peak(gb)
    return round(gb, 4)


def record_dispatch_profile(name: str, rounds: int, host_s: float,
                            device_wait_s: Optional[float],
                            flops_per_round: Optional[float],
                            n_devices: int, captures: int = 0,
                            device: Any = None) -> Optional[float]:
    """Emit one ``profile`` record (+ the MFU/TFLOP/s gauges when the
    FLOPs model is known). Returns the per-round MFU or None.

    ``total_s = host_s + device_wait_s`` is the block's wall cost when the
    host waited for the device; with only ``host_s`` known no MFU is
    computed (an enqueue time is not a round time)."""
    total_s = host_s + (device_wait_s or 0.0)
    mfu = None
    tflops = None
    if (flops_per_round and rounds and device_wait_s is not None
            and total_s > 0):
        flops = float(flops_per_round) * int(rounds)
        tflops = (flops / total_s) / 1e12
        mfu = mfu_value(flops, total_s, n_devices, device=device)
        if mfu is not None:
            obs_metrics.record_round_mfu(mfu, tflops=tflops)
    rec = {"dispatch": str(name), "rounds": int(rounds),
           "host_s": round(float(host_s), 6),
           "total_s": round(total_s, 6)}
    if device_wait_s is not None:
        rec["device_wait_s"] = round(float(device_wait_s), 6)
    if captures:
        rec["captures"] = int(captures)
    if tflops is not None:
        rec["tflops"] = round(tflops, 4)
    if mfu is not None:
        rec["mfu"] = round(mfu, 5)
    sink.emit("profile", rec)
    return mfu
