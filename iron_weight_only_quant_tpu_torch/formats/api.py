"""Unified codec dispatch over :class:`~iron_weight_only_quant_tpu_torch.config.QuantSpec`
(port of ``formats/api.py``): the one entry point the quantizer, the
packing layer and the fake-quant path share."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import FloatFormat, QuantSpec
from . import bfp as bfp_mod
from . import fp4_e1m2 as fp4cpu
from . import int_codec
from . import minifloat as mf
from .grouping import make_groups, restore_from_groups


class GroupCodes(NamedTuple):
    """Encoded grouped view + side info. Fields unused by a format are None."""

    codes: torch.Tensor  # int32 [n_groups, width]
    scales: Optional[torch.Tensor]  # f32 [n_groups, 1]
    zeros: Optional[torch.Tensor]  # f32 [n_groups, 1]
    exp_block: Optional[torch.Tensor]  # int32 [n_groups, 1] (bfp only)


def _align_kind(fmt: FloatFormat) -> str:
    return {4: "fp4", 6: "fp6", 8: "fp8"}.get(fmt.total_bits, "fp8")


def quantize_groups(groups: torch.Tensor, spec: QuantSpec) -> GroupCodes:
    if spec.fmt == "int":
        codes, scales, zeros = int_codec.encode_int(groups, spec.bits, spec.symmetric)
        return GroupCodes(codes, scales, zeros, None)
    if spec.fmt == "fp":
        # the approximate path always uses the symmetric absmax scale
        symmetric = True if spec.approximate else spec.symmetric
        codes, scales, zeros = mf.encode_minifloat(groups, spec.float_format, symmetric)
        return GroupCodes(codes, scales, zeros, None)
    if spec.fmt == "bfp":
        codes, exp_block = bfp_mod.encode_bfp(groups, spec.bits)
        return GroupCodes(codes, None, None, exp_block)
    raise NotImplementedError(f"quantize_groups does not support fmt={spec.fmt!r}")


def dequantize_groups(enc: GroupCodes, spec: QuantSpec) -> torch.Tensor:
    if spec.fmt == "int":
        return int_codec.decode_int(enc.codes, enc.scales, enc.zeros, spec.symmetric)
    if spec.fmt == "fp":
        fmt = spec.float_format
        if spec.approximate:
            align = spec.effective_align(_align_kind(fmt))
            # E=1 formats always use the single-approx decode; wider
            # exponents use the group-of-4 double approx when asked
            use_double = spec.double_approximate and fmt.exp_bits != 1
            return mf.decode_minifloat(
                enc.codes, enc.scales, enc.zeros, fmt, align=align, double_approx=use_double
            )
        return mf.decode_minifloat(enc.codes, enc.scales, enc.zeros, fmt)
    if spec.fmt == "bfp":
        return bfp_mod.decode_bfp(enc.codes, enc.exp_block, spec.bits)
    raise NotImplementedError(f"dequantize_groups does not support fmt={spec.fmt!r}")


def fake_quantize(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize round trip on an ``[in, out]`` weight, in
    ``w``'s dtype."""
    if spec.fmt == "fp4_e1m2":
        # the standalone scheme quantizes the [out, in] orientation with
        # groups along input features
        q = fp4cpu.quantize_fp4_two_step(
            w.t() if spec.quant_axis == 0 else w,
            group_size=spec.group_size,
            per_tensor=spec.group_size == -1,
        )
        return q.t() if spec.quant_axis == 0 else q
    groups = make_groups(w.to(torch.float32), spec.group_size, spec.quant_axis)
    enc = quantize_groups(groups, spec)
    deq = dequantize_groups(enc, spec)
    return restore_from_groups(deq, tuple(w.shape), spec.quant_axis).to(w.dtype)
