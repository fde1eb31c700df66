"""Standalone two-step FP4 quantizer (port of ``formats/fp4_e1m2.py``).

First a per-group scale S maps the absmax onto the format's max value; then
each element gets a per-element power-of-two scale from its (bias-clamped)
exponent estimate and is rounded on that grid.  Despite the scheme's "e1m2"
name its constants are M=1, E=2, as in the JAX package; both are
parameters.

This is a fake-quant utility (it returns snapped values); no packed
artifact exists for it.
"""

from __future__ import annotations

import torch

from .minifloat import _div, exp2

SCALE_EPS = 1e-8


def _floor_log2_safe(x: torch.Tensor) -> torch.Tensor:
    raw = x.abs().to(torch.float32).contiguous().view(torch.int32)
    return (((raw >> 23) & 0xFF) - 127).to(torch.float32)


def quantize_fp4_two_step(
    tensor: torch.Tensor,
    group_size: int = 128,
    per_tensor: bool = False,
    mant_bits: int = 1,
    exp_bits: int = 2,
) -> torch.Tensor:
    """Fake-quantize a 2-D ``[rows, cols]`` tensor, grouping along the last dim."""
    if tensor.dim() != 2:
        raise ValueError("expected a 2-D tensor")
    org_shape = tensor.shape
    t = tensor.to(torch.float32)
    if group_size > 0:
        if org_shape[1] % group_size != 0:
            raise ValueError("cols must divide group_size")
        t = t.reshape(-1, group_size)
    if per_tensor:
        t = t.reshape(1, -1)

    bias = 2 ** (exp_bits - 1) - 1
    max_float = (2.0 - 2.0 ** (-mant_bits)) * 2.0 ** (2**exp_bits - 1 - bias)

    absmax = t.abs().amax(dim=1, keepdim=True).clamp(min=SCALE_EPS)
    S = _div(absmax, max_float)

    unscaled = (t / S).clamp(-max_float, max_float)
    log_scales = (_floor_log2_safe(unscaled) + bias).clamp(min=1.0)
    elem_scales = exp2(log_scales - mant_bits - bias)
    q = torch.round(unscaled / elem_scales) * elem_scales
    return (q * S).reshape(org_shape).to(tensor.dtype)
