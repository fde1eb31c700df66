"""Round-to-nearest quantization into packed artifacts (port of
``quantize/rtn.py``).

For the same float32 weights the port writes the same bytes as the JAX
package: codes, scales, zero-points and codebooks are bit-identical, on the
CPU and on the card.  Integer (``fmt="int"``) and block-floating-point
(``fmt="bfp"``) artifacts are affine; minifloat (``fmt="fp"``) artifacts
are LUT artifacts: ``w = codebook[code] * scale (+ zero)``, with no zero
array when symmetric.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PER_CHANNEL, PER_TENSOR, QuantSpec
from ..formats import make_groups, minifloat_codebook, quantize_groups
from ..formats.api import _align_kind
from ..formats.bfp import bfp_scales
from ..ops.packing import pack_codes_sharded, packing_for_bits, signed_to_unsigned_offset
from .qtensor import QuantizedTensor


def _kernel_layout(per_group_col: torch.Tensor, k: int, n: int, group_size: int) -> torch.Tensor:
    """Grouped side-info ``[n_groups, 1]`` -> ``[K/G | 1, N] | [1, 1]``.

    Grouped rows are ordered N-major (grouping transposes to ``[N, K]``
    first), so row ``n * (K/G) + kg`` maps to kernel position ``[kg, n]``.
    """
    if group_size == PER_TENSOR:
        return per_group_col.reshape(1, 1)
    if group_size == PER_CHANNEL:
        return per_group_col.reshape(1, n)
    kg = k // group_size
    return per_group_col.reshape(n, kg).t().contiguous()


def native_quantize_tensor(
    w: torch.Tensor, spec: QuantSpec, pad_n_to: int = 1
) -> Optional[QuantizedTensor]:
    """Quantize+pack on the host through the C++ library
    (``csrc/host/iwoq_native.cpp``): the artifact of :func:`quantize_tensor`
    byte for byte, on ``w``'s device.

    Covers the int4/int8 per-group affine layouts; returns None for every
    other spec or shape (the layouts the JAX package's version leaves out),
    and the caller quantizes with :func:`quantize_tensor`.  A library that
    cannot be built or loaded raises.  The weight goes to the host as
    float32 and the packed fields come back to its device; ``cli.quantize``
    calls it only for weights in host memory (a card weight is quantized on
    the card by :func:`quantize_tensor`).
    """
    from .. import native

    if (spec.fmt != "int" or spec.bits not in (4, 8) or spec.group_size <= 0
            or spec.quant_axis != 0 or w.ndim != 2):
        return None
    k, n = w.shape
    if k % spec.group_size or (spec.bits == 4 and k % 2):
        return None
    w_np = w.detach().to("cpu", torch.float32).numpy()
    n_pad = 0
    if pad_n_to > 1 and n % pad_n_to != 0:
        n_pad = pad_n_to - n % pad_n_to
        w_np = np.pad(w_np, ((0, 0), (0, n_pad)))
    fn = (native.native_quantize_int4 if spec.bits == 4
          else native.native_quantize_int8)
    packed, scales, zeros = fn(w_np, spec.group_size, spec.symmetric)
    if spec.symmetric:
        # quantize_tensor stores symmetric zero-points as a broadcast scalar
        zeros = zeros[:1, :1].copy()
    on = lambda a: torch.from_numpy(a).to(w.device)  # noqa: E731
    return QuantizedTensor(on(packed), on(scales), on(zeros), None, spec, (k, n),
                           "affine", 1, n_pad)


def quantize_tensor(
    w: torch.Tensor, spec: QuantSpec, k_shards: int = 1, pad_n_to: int = 1,
    side_dtype=None, pad_k_to: int = 1,
) -> QuantizedTensor:
    """Quantize an ``[K, N]`` weight into a packed artifact (RTN path).

    The artifact lives on ``w``'s device.  ``k_shards > 1`` confines
    sub-byte packing to each of that many K segments.  ``pad_n_to``
    zero-pads stored output columns to that multiple and ``pad_k_to``
    zero-pads stored reduction rows to that multiple, in whole quantization
    groups (skipped when the spec is not grouped or the multiple would
    split a group); ``shape`` stays logical either way.  ``side_dtype``
    stores scales/zeros at reduced precision (e.g. ``torch.float16``);
    scale computation stays float32.
    """
    if spec.quant_axis != 0:
        raise NotImplementedError("packed artifacts require quant_axis=0")
    if spec.fmt == "fp4_e1m2":
        raise NotImplementedError("fp4_e1m2 is a fake-quant-only scheme")
    if spec.fmt == "fp" and spec.approximate and spec.double_approximate \
            and spec.float_format.exp_bits != 1:
        raise NotImplementedError(
            "double-approximate decode is group-contextual; packed path unsupported"
        )

    def cast_side(a):
        return a if a is None or side_dtype is None else a.to(side_dtype)

    k, n = w.shape
    n_pad = 0
    if pad_n_to > 1 and n % pad_n_to != 0:
        n_pad = pad_n_to - n % pad_n_to
        w = F.pad(w, (0, n_pad))
    n_stored = n + n_pad
    k_pad = 0
    if (pad_k_to > 1 and k % pad_k_to != 0 and spec.group_size > 0
            and pad_k_to % spec.group_size == 0 and k % spec.group_size == 0
            and k_shards == 1):
        k_pad = pad_k_to - k % pad_k_to
        w = F.pad(w, (0, 0, 0, k_pad))
    k_stored = k + k_pad
    groups = make_groups(w.to(torch.float32), spec.group_size, 0)
    enc = quantize_groups(groups, spec)
    # grouped codes -> [K, N] kernel orientation
    codes = enc.codes.reshape(n_stored, k_stored).t().contiguous()

    def side(per_group):
        return _kernel_layout(per_group, k_stored, n_stored, spec.group_size)

    def scalar(v):
        return torch.full((1, 1), float(v), dtype=torch.float32, device=w.device)

    if spec.fmt == "int":
        if spec.symmetric:
            off = signed_to_unsigned_offset(spec.bits)
            codes = codes + off
            zeros = scalar(off)
        else:
            zeros = side(enc.zeros)
        scales = side(enc.scales)
        if packing_for_bits(spec.bits)[0] == "byte":
            # byte layouts store two's-complement code-128 (see packing.py);
            # shifting the zero-point keeps (code - zero) invariant
            codes = codes - 128
            zeros = zeros - 128.0
        qweight = pack_codes_sharded(codes, spec.bits, k_shards)
        return QuantizedTensor(qweight, cast_side(scales), cast_side(zeros),
                               None, spec, (k, n), "affine", k_shards, n_pad, k_pad)

    if spec.fmt == "bfp":
        if packing_for_bits(spec.bits)[0] == "byte":
            zeros = scalar(0)  # signed mantissas fit the int8 pattern as they are
        else:
            # sub-byte: shift to unsigned (magnitude <= 2^(b-1)-1)
            off = signed_to_unsigned_offset(spec.bits)
            codes = codes + off
            zeros = scalar(off)
        scales = side(bfp_scales(enc.exp_block, spec.bits))
        qweight = pack_codes_sharded(codes, spec.bits, k_shards)
        return QuantizedTensor(qweight, cast_side(scales), cast_side(zeros),
                               None, spec, (k, n), "affine", k_shards, n_pad, k_pad)

    # minifloat: LUT mode
    fmt = spec.float_format
    align = spec.effective_align(_align_kind(fmt)) if spec.approximate else None
    book = torch.from_numpy(minifloat_codebook(fmt, align)).to(w.device)
    scales = side(enc.scales)
    zeros = side(enc.zeros) if enc.zeros is not None else None
    store_bits = fmt.total_bits if fmt.total_bits in (2, 4, 6) else 8
    if store_bits == 6 and (k_stored % 4 or (k_stored // k_shards) % 4):
        store_bits = 8  # nq42 needs K divisible by 4 per shard
    if store_bits == 8:
        codes = codes - 128  # byte layout; dequant re-adds 128 before the LUT
    qweight = pack_codes_sharded(codes, store_bits, k_shards)
    return QuantizedTensor(qweight, cast_side(scales), cast_side(zeros), book,
                           spec, (k, n), "lut", k_shards, n_pad, k_pad)
