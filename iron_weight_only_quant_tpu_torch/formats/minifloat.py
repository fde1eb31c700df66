"""Parametric minifloat codec with approximate aligned decode (port of
``formats/minifloat.py``).

  * ``float_to_code``   encodes values already normalized into the format;
  * ``code_to_float``   is the exact decode (subnormals included);
  * ``decode_minifloat_aligned`` and ``decode_minifloat_double_approx`` are
    the approximate decodes;
  * ``encode_minifloat`` / ``decode_minifloat`` add the per-group scale and
    the optional zero (the range midpoint);
  * ``minifloat_codebook`` lists every codeword's value.

Quirks kept on purpose, as in the JAX package:
  * no rounding carry from mantissa into exponent: a value that rounds up to
    2.0x its binade is clamped to the largest mantissa instead;
  * zero inputs are forced to code 0; negative values whose subnormal
    mantissa rounds to 0 keep their sign bit but decode to -0.0;
  * the double-approx grouping of 4 runs down the *transposed* grouped view,
    across quantization groups, with the int8 wrap-around of its mantissa
    arithmetic.

Exponents are read exactly from float32 bit patterns.  Every division by a
constant divides by a tensor: on CUDA, torch turns division by a Python
scalar into a product with the reciprocal, which is not the IEEE quotient,
so a card-built artifact would differ from a CPU-built one.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import AlignSpec, FloatFormat

SCALE_EPS = 1e-5
_ZERO_SAFE = 1e-8
_LN2_F32 = float(np.float32(math.log(2.0)))


def exp2(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` in f32 as the JAX package computes it: its ``exp2`` is
    ``exp(log(2) * e)`` with the product in f32, correctly rounded, which
    for integer ``|e| >= 13`` is not the exact power of two.  Taking the
    exponential in f64 and rounding once gives those bits on every device,
    so scales built from it (BFP) are byte-equal to the JAX package's."""
    prod = e.to(torch.float32) * _LN2_F32
    return torch.exp(prod.to(torch.float64)).to(torch.float32)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``a / c`` for a Python scalar ``c``, on the CPU and on CUDA."""
    return a / torch.full_like(a, c)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) for positive normal float32 x, via the bits."""
    raw = x.to(torch.float32).contiguous().view(torch.int32)
    return ((raw >> 23) & 0xFF) - 127


def _rounding_rshift(val: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Round-half-up right shift."""
    shift = shift.to(val.dtype)
    one = torch.ones_like(val)
    offset = torch.where(shift > 0, one << (shift - 1).clamp(min=0),
                         torch.zeros_like(val))
    return (val + offset) >> shift


def float_to_code(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Encode float values (already normalized into fmt's range) to codewords."""
    e_bits, m_bits, bias = fmt.exp_bits, fmt.mant_bits, fmt.bias
    x = x.to(torch.float32)
    sign = (x < 0).to(torch.int32)
    x_abs = x.abs()
    zero_mask = x_abs == 0
    safe = torch.where(zero_mask, torch.full_like(x_abs, _ZERO_SAFE), x_abs)

    min_normal_exp = fmt.min_normal_exp
    exp_val = _floor_log2(safe)
    is_sub = exp_val < min_normal_exp

    exp_clamped = exp_val.clamp(min_normal_exp, fmt.max_exp_field - bias)
    mant_scale = 1 << m_bits
    pow_exp = exp2(exp_clamped)
    mant_normal = torch.round((safe / pow_exp - 1.0) * mant_scale).clamp(
        0, mant_scale - 1).to(torch.int32)
    mant_sub = torch.round(safe * (2.0 ** (-min_normal_exp)) * mant_scale).clamp(
        0, mant_scale - 1).to(torch.int32)

    exp_field = torch.where(is_sub, torch.zeros_like(exp_clamped), exp_clamped + bias)
    mant_field = torch.where(is_sub, mant_sub, mant_normal)
    code = (sign << (e_bits + m_bits)) | (exp_field << m_bits) | mant_field
    return torch.where(zero_mask, torch.zeros_like(code), code).to(torch.int32)


def _split_code(code: torch.Tensor, fmt: FloatFormat):
    e_bits, m_bits = fmt.exp_bits, fmt.mant_bits
    code = code.to(torch.int32)
    sign = (code >> (e_bits + m_bits)) & 0x1
    exp_field = (code >> m_bits) & ((1 << e_bits) - 1)
    mant_field = code & ((1 << m_bits) - 1)
    return sign, exp_field, mant_field


def code_to_float(code: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Exact decode (subnormals included); code 0 -> 0.0."""
    m_bits, bias = fmt.mant_bits, fmt.bias
    sign, exp_field, mant_field = _split_code(code, fmt)
    zero_mask = code == 0
    mant = mant_field.to(torch.float32) * (1.0 / (1 << m_bits))  # a power of 2
    value_normal = (1.0 + mant) * exp2(exp_field - bias)
    value_sub = mant * (2.0 ** (1 - bias))
    value = torch.where(exp_field == 0, value_sub, value_normal)
    value = torch.where(sign == 1, -value, value)
    return torch.where(zero_mask, torch.zeros_like(value), value)


def decode_minifloat_aligned(
    code: torch.Tensor, fmt: FloatFormat, align: AlignSpec
) -> torch.Tensor:
    """Approximate decode: high-exponent codes share exponent ``hi_align_exp_field``."""
    m_bits, bias = fmt.mant_bits, fmt.bias
    sign, exp_field, mant_field = _split_code(code, fmt)
    zero_mask = code == 0
    one = torch.ones_like(exp_field)

    align_exp = (torch.where(exp_field == 0, one, exp_field)
                 if align.align_subnorm_exp_as_one else exp_field)
    leading = torch.where(exp_field == 0, torch.zeros_like(one), one)
    mant_full = (leading << m_bits) | mant_field
    pad = align.tail_pad_bits
    if pad >= 0:
        mant_padded = mant_full << pad
    else:
        mant_padded = _rounding_rshift(mant_full, torch.full_like(mant_full, -pad))

    exp_unbiased = torch.where(exp_field == 0, one * (1 - bias), exp_field - bias)
    value_normal = (mant_full.to(torch.float32) * (1.0 / (1 << m_bits))
                    * exp2(exp_unbiased))

    hi_mask = align_exp >= align.hi_align_start
    if align.limit_align_exp_to_field:
        hi_mask = hi_mask & (align_exp <= align.hi_align_exp_field)

    shift = (align.hi_align_exp_field - align_exp).clamp(min=0)
    mant_aligned = _rounding_rshift(mant_padded, shift)
    hi_unbiased = align.hi_align_exp_field - bias
    value_hi = (mant_aligned.to(torch.float32) * (1.0 / 2.0 ** (m_bits + pad))
                * (2.0 ** hi_unbiased))

    value = torch.where(hi_mask, value_hi, value_normal)
    value = torch.where(sign == 1, -value, value)
    return torch.where(zero_mask, torch.zeros_like(value), value)


def _wrap_i8(x: torch.Tensor) -> torch.Tensor:
    """Truncate int32 values to int8 two's complement."""
    return ((x & 0xFF) ^ 0x80) - 0x80


def _rounding_rshift_i8(val: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """:func:`_rounding_rshift` as int8 tensors compute it: the round-half-up
    offset ``1 << (shift-1)`` wraps for shift >= 8 (shift 8 gives offset
    -128).  Kept bit for bit on purpose, as in the JAX package."""
    one = torch.ones_like(val)
    offset = torch.where(shift > 0, _wrap_i8(one << (shift - 1).clamp(0, 31)),
                         torch.zeros_like(val))
    return _wrap_i8(val + offset) >> shift


def decode_minifloat_double_approx(
    code: torch.Tensor, fmt: FloatFormat, align: AlignSpec
) -> torch.Tensor:
    """Group-of-4 double-approximate decode.

    The grouped-view code matrix is transposed before flattening into runs
    of 4, so consecutive elements of a run come from *different*
    quantization groups.  Mantissa arithmetic follows int8 tensors,
    overflow included.
    """
    m_bits, bias = fmt.mant_bits, fmt.bias
    code_t = code.to(torch.int32).t().contiguous()
    orig_t_shape = code_t.shape
    sign, exp_field, mant_field = _split_code(code_t, fmt)
    zero_mask = code_t == 0
    one = torch.ones_like(exp_field)

    align_exp = (torch.where(exp_field == 0, one, exp_field)
                 if align.align_subnorm_exp_as_one else exp_field)
    leading = torch.where(exp_field == 0, torch.zeros_like(one), one)
    mant_full = (leading << m_bits) | mant_field
    pad = align.tail_pad_bits
    if pad >= 0:
        mant_padded = _wrap_i8(mant_full << pad)
    else:
        mant_padded = _rounding_rshift_i8(mant_full, torch.full_like(mant_full, -pad))

    if code_t.numel() % 4 != 0:
        raise ValueError("double approx requires element count divisible by 4")
    exp_g = align_exp.reshape(-1, 4)
    mant_g = mant_padded.reshape(-1, 4)
    sign_g = sign.reshape(-1, 4)
    zero_g = zero_mask.reshape(-1, 4)

    outlier = (exp_g < align.hi_align_start) | (exp_g > align.hi_align_exp_field)
    outlier_count = outlier.sum(dim=1, keepdim=True)
    group_max = exp_g.amax(dim=1, keepdim=True)
    target = torch.where(outlier_count <= 1,
                         torch.full_like(group_max, align.hi_align_exp_field), group_max)
    if align.handle_max_outlier:
        max_exp_val = fmt.max_exp_field
        has_max = ((exp_g == max_exp_val) & outlier).any(dim=1, keepdim=True)
        target = torch.where(has_max, torch.full_like(target, max_exp_val), target)

    shift = target - exp_g
    mant_right = _rounding_rshift_i8(mant_g, shift.clamp(min=0))
    mant_left = _wrap_i8(mant_g << (-shift).clamp(min=0))
    if pad >= 0:
        cap = ((1 << (m_bits + 1)) - 1) << pad
    else:
        cap = ((1 << (m_bits + 1)) - 1) >> (-pad)
    mant_left = mant_left.clamp(max=cap)
    mant_aligned = torch.where(shift >= 0, mant_right, mant_left)

    value = (mant_aligned.to(torch.float32) * (1.0 / 2.0 ** (m_bits + pad))
             * exp2(target - bias))
    value = torch.where(sign_g == 1, -value, value)
    value = torch.where(zero_g, torch.zeros_like(value), value)
    return value.reshape(orig_t_shape).t()


def encode_minifloat(
    groups: torch.Tensor, fmt: FloatFormat, symmetric: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Grouped view -> (codes, scales, zeros|None).

    Symmetric: the scale maps the group absmax onto ``fmt.max_value``.
    Asymmetric: the zero is the range midpoint and the scale maps the
    half-span; the zero is stored rounded to f16 (and added back at that
    precision), the scale at full precision.
    """
    g = groups.to(torch.float32)
    fp_max = fmt.max_value
    if symmetric:
        absmax = g.abs().amax(dim=1, keepdim=True).clamp(min=SCALE_EPS)
        scales = _div(absmax, fp_max).clamp(min=SCALE_EPS)
        zeros = None
        normalized = (g / scales).clamp(-fp_max, fp_max)
    else:
        hi = g.amax(dim=1, keepdim=True)
        lo = g.amin(dim=1, keepdim=True)
        mid = (hi + lo) * 0.5
        span = ((hi - lo) * 0.5).clamp(min=SCALE_EPS)
        scales = _div(span, fp_max).clamp(min=SCALE_EPS)
        zeros = mid.to(torch.float16).to(torch.float32)
        normalized = ((g - mid) / scales).clamp(-fp_max, fp_max)
    codes = float_to_code(normalized, fmt)
    return codes, scales, zeros


def decode_minifloat(
    codes: torch.Tensor,
    scales: torch.Tensor,
    zeros: Optional[torch.Tensor],
    fmt: FloatFormat,
    align: Optional[AlignSpec] = None,
    double_approx: bool = False,
) -> torch.Tensor:
    if align is None:
        vals = code_to_float(codes, fmt)
    elif double_approx:
        vals = decode_minifloat_double_approx(codes, fmt, align)
    else:
        vals = decode_minifloat_aligned(codes, fmt, align)
    out = vals * scales
    if zeros is not None:
        out = out + zeros
    return out


def minifloat_codebook(
    fmt: FloatFormat, align: Optional[AlignSpec] = None
) -> np.ndarray:
    """All ``2^(1+E+M)`` codeword values (exact or aligned decode) as float32."""
    codes = torch.arange(1 << fmt.total_bits, dtype=torch.int32)
    if align is None:
        vals = code_to_float(codes, fmt)
    else:
        vals = decode_minifloat_aligned(codes, fmt, align)
    return vals.numpy().astype(np.float32)
