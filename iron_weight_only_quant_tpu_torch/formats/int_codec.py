"""Uniform integer codec (port of ``formats/int_codec.py``).

  symmetric:  max_int = 2^(b-1)-1, min_int = -2^(b-1)
              scale = clamp(absmax, 1e-5) / max_int
              q     = clamp(round(w / scale), min_int, max_int)
  asymmetric: max_int = 2^b - 1
              scale = clamp(max - min, 1e-5) / max_int
              zero  = clamp(round(-min / scale), 0, max_int)
              q     = clamp(round(w / scale) + zero, 0, max_int)

All math in float32; ``torch.round`` rounds half to even, as ``jnp.round``
does, and ``max_int`` divides as a tensor (on CUDA torch turns division by
a Python scalar into a product with the reciprocal, which is not the IEEE
quotient), so codes and side info are bit-identical to the JAX package's
functions, on the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .minifloat import _div

SCALE_EPS = 1e-5


def int_range(bits: int, symmetric: bool) -> Tuple[int, int]:
    if symmetric:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


def encode_int(
    groups: torch.Tensor, bits: int, symmetric: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Grouped view -> (codes int32, scales f32 [G,1], zeros f32 [G,1] | None)."""
    g = groups.to(torch.float32)
    min_int, max_int = int_range(bits, symmetric)
    if symmetric:
        absmax = g.abs().amax(dim=1, keepdim=True).clamp(min=SCALE_EPS)
        scales = _div(absmax, max_int)
        zeros = None
        q = torch.round(g / scales).clamp(min_int, max_int)
    else:
        hi = g.amax(dim=1, keepdim=True)
        lo = g.amin(dim=1, keepdim=True)
        scales = _div((hi - lo).clamp(min=SCALE_EPS), max_int)
        # "+ 0.0" turns the -0.0 that round(-0/s) gives for an all-zero
        # group (padding) into +0.0, as jnp.clip does, so the stored bytes
        # match the JAX package's
        zeros = torch.round(-lo / scales).clamp(min_int, max_int) + 0.0
        q = (torch.round(g / scales) + zeros).clamp(min_int, max_int)
    return q.to(torch.int32), scales, zeros


def decode_int(
    codes: torch.Tensor,
    scales: torch.Tensor,
    zeros: Optional[torch.Tensor],
    symmetric: bool,
) -> torch.Tensor:
    q = codes.to(torch.float32)
    if symmetric:
        if zeros is not None:
            raise ValueError("symmetric codes carry no zero-points")
        return q * scales
    return (q - zeros) * scales


def pseudo_quantize(
    tensor: torch.Tensor,
    bits: int = 8,
    zero_point: bool = True,
    group_size: int = -1,
    per_tensor: bool = False,
) -> torch.Tensor:
    """Fake-quant round trip over the last dim, for activations and KV: rows
    of a 2-D view are the quantization unit (optionally regrouped to
    ``group_size``, or one unit for ``per_tensor``)."""
    shape = tensor.shape
    t = tensor.to(torch.float32)
    if group_size > 0:
        if shape[-1] % group_size != 0:
            raise ValueError("last dim must divide group_size")
        t = t.reshape(-1, group_size)
    else:
        t = t.reshape(-1, shape[-1])
    if per_tensor:
        t = t.reshape(1, -1)
    codes, scales, zeros = encode_int(t, bits, symmetric=not zero_point)
    out = decode_int(codes, scales, zeros, symmetric=not zero_point)
    return out.reshape(shape).to(tensor.dtype)
