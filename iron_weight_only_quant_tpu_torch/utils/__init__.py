"""Shared utilities: timing and roofline accounting (``results_io`` is not
ported yet)."""

from .profiling import Roofline, card_line, trace
from .timing import WARMUP, Timer, copies_for, device_ms, host_ms

__all__ = ["Roofline", "card_line", "Timer", "WARMUP", "copies_for", "device_ms", "host_ms",
           "trace"]
