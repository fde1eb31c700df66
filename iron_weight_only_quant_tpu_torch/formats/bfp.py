"""Block floating point codec (port of ``formats/bfp.py``).

Weights are read as IEEE fp16 bit fields; every mantissa of a group is
right-shift-aligned to the group's largest exponent field, then rounded
(half up) to ``bits-1`` mantissa bits, the leading 1 included.  Decoding
multiplies by ``2^(exp_block - 15 - frac_bits_keep)``.

Storage: signed aligned mantissas (int32 codes, magnitude < 2^(bits-1)) and
one 5-bit shared exponent field per group.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .minifloat import _rounding_rshift, exp2


def _fp16_fields(g: torch.Tensor):
    """float input -> (sign, exp_field, mant_field) of its fp16 encoding."""
    bits = g.to(torch.float16).contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    sign = (bits >> 15) & 0x1
    exp = (bits >> 10) & 0x1F
    mant = bits & 0x3FF
    return sign, exp, mant


def encode_bfp(groups: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped view -> (signed mantissa codes int32 [G,S], exp_block int32 [G,1])."""
    sign, exp, mant = _fp16_fields(groups)
    leading = (exp != 0).to(torch.int32)
    mant11 = (leading << 10) | mant

    exp_block = exp.amax(dim=1, keepdim=True)
    shift = (exp_block - exp).clamp(min=0)
    mant_aligned = mant11 >> shift  # truncating align

    target_mant_bits = min(bits - 1, 11)
    shift_down = max(0, 11 - target_mant_bits)
    if shift_down > 0:
        mant_rounded = _rounding_rshift(mant_aligned, torch.full_like(mant_aligned, shift_down))
    else:
        mant_rounded = mant_aligned
    mant_rounded = mant_rounded.clamp(max=(1 << target_mant_bits) - 1)
    codes = torch.where(sign == 1, -mant_rounded, mant_rounded)
    return codes.to(torch.int32), exp_block.to(torch.int32)


def bfp_scales(exp_block: torch.Tensor, bits: int) -> torch.Tensor:
    """The f32 scale ``2^(exp_block - 15 - frac_bits_keep)`` of each group."""
    frac_bits_keep = min(bits - 1, 11) - 1
    return exp2(exp_block - 15 - frac_bits_keep)


def decode_bfp(codes: torch.Tensor, exp_block: torch.Tensor, bits: int) -> torch.Tensor:
    return codes.to(torch.float32) * bfp_scales(exp_block, bits)
