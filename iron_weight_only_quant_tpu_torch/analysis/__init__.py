"""Quantization analysis tools (port of ``analysis/``; SURVEY.md C22 + the
dormant C7 capability).

Numeric cores are matplotlib-free; ``plots`` wraps them when matplotlib is
available.
"""

from .stats import (
    activation_pre_align,
    capture_linear_inputs,
    codeword_histogram,
    exponent_histogram,
    exponent_outlier_stats,
    fp16_bit_sparsity,
)

__all__ = [
    "codeword_histogram",
    "exponent_histogram",
    "exponent_outlier_stats",
    "fp16_bit_sparsity",
    "activation_pre_align",
    "capture_linear_inputs",
]
