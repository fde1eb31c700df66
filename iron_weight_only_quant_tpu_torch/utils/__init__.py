"""Shared utilities: results IO, timing and roofline accounting."""

from .profiling import Roofline, card_line, trace
from .results_io import append_results, read_results
from .timing import WARMUP, Timer, copies_for, device_ms, host_ms

__all__ = ["Roofline", "append_results", "card_line", "read_results", "Timer", "WARMUP",
           "copies_for", "device_ms", "host_ms", "trace"]
