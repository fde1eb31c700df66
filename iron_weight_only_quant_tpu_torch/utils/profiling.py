"""Profiling and roofline accounting (port of ``utils/profiling.py``).

* :func:`trace` records the enclosed region with ``torch.profiler`` and
  writes a Chrome trace; :func:`device_kernel_names` reads the device
  kernels one call runs from it;
* :class:`Roofline` turns measured times into fractions of the least time
  the card could take, from its memory rate and matrix-unit peak.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from dataclasses import dataclass
from typing import Optional

# NVIDIA H100 SXM data sheet, dense rates, at its full 700 W power limit (a
# card set below that limit runs slower under load).  The one home of the
# card's peaks: Roofline and the chip script's kernel bounds read them.
H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0
H100_INT8_TOPS = 1979.0
H100_F32_TFLOPS = 67.0  # f32 on the CUDA cores, outside the tensor cores


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the enclosed region, written to
    ``logdir/trace.json`` when ``logdir`` is given (open it in Perfetto or
    ``chrome://tracing``).  Records the card's kernels too where a card is
    present.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_kernel_names(fn, want: int = 1, tries: int = 3) -> list:
    """The names of the device kernels one call of ``fn`` runs, in order,
    read by :func:`trace` (empty where no trace recorded a device event).
    A trace can miss a kernel the call ran, so it traces again, at most
    ``tries`` times in all, while it records fewer than ``want``."""
    import torch
    from torch.autograd import DeviceType

    names: list = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with trace() as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        if len(names) >= want:
            break
    return names


@dataclass
class Roofline:
    hbm_gbps: float = H100_HBM_GBPS
    bf16_tflops: float = H100_BF16_TFLOPS

    def matmul_time_floor(self, m: int, k: int, n: int, weight_bytes: float) -> float:
        """Lower bound (s): max of bandwidth time and compute time."""
        io = weight_bytes + m * k * 2 + m * n * 2
        t_bw = io / (self.hbm_gbps * 1e9)
        t_fl = 2 * m * k * n / (self.bf16_tflops * 1e12)
        return max(t_bw, t_fl)

    def fraction(self, measured_s: float, m: int, k: int, n: int,
                 weight_bytes: float) -> float:
        return self.matmul_time_floor(m, k, n, weight_bytes) / max(measured_s, 1e-12)
