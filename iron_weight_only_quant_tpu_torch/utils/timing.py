"""Wall-clock phase timing, and the device timer of the kernel measurements.

:class:`Timer` is the JAX package's ``utils/timing.py`` as it is.
:func:`device_ms` times calls on the card with CUDA events, :func:`host_ms`
on the host's clock; both make :data:`WARMUP` untimed calls first.
:func:`copies_for` says how many distinct copies of an operand to rotate
through so that the card's L2 cache does not hold it between calls.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict

WARMUP = 2  # untimed calls before each timed series of device_ms / host_ms


class Timer:
    def __init__(self):
        self.spans: Dict[str, float] = {}
        self._starts: Dict[str, float] = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self.spans[name] = self.spans.get(name, 0.0) + dt
        return dt

    def __enter__(self):
        self.start("__total__")
        return self

    def __exit__(self, *exc):
        self.stop("__total__")
        return False


def device_ms(fn: Callable[[int], object], iters: int) -> float:
    """Device time of one ``fn(i)`` call, from CUDA events around ``iters``
    calls (``i`` = 0 .. iters-1), after ``WARMUP`` calls.  A sleep kernel
    queued first keeps the card busy while the host enqueues the calls, so
    host overhead between launches is not counted."""
    import torch

    for i in range(WARMUP):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def host_ms(fn: Callable[[int], object], iters: int) -> float:
    """Host-clock time of one ``fn(i)`` call, after ``WARMUP`` calls (the
    CPU's counterpart of :func:`device_ms`)."""
    for i in range(WARMUP):
        fn(i)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / iters


def copies_for(nbytes: int) -> int:
    """Distinct copies to rotate through so that repeated calls find the
    50 MB L2 cold, as the layers of a decode step do."""
    return max(2, math.ceil(160e6 / max(nbytes, 1)))
