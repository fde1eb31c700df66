"""Round-to-nearest quantization into packed artifacts (port of
``quantize/rtn.py``, integer path).

For the same float32 weights the port writes the same bytes as the JAX
package: codes, scales and zero-points are bit-identical.  The minifloat
(``fmt="fp"``) and block-floating-point (``fmt="bfp"``) packers are still to
be ported (ROADMAP queue A, "Format zoo").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import PER_CHANNEL, PER_TENSOR, QuantSpec
from ..formats import encode_int, make_groups
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
    if spec.fmt != "int":
        raise NotImplementedError(
            f"fmt={spec.fmt!r} packing is not ported yet (ROADMAP queue A, "
            "'Format zoo'); only fmt='int' packs in this package")

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
    codes, scales_g, zeros_g = encode_int(groups, spec.bits, spec.symmetric)

    # grouped codes -> [K, N] kernel orientation
    codes = codes.reshape(n_stored, k_stored).t().contiguous()
    if spec.symmetric:
        off = signed_to_unsigned_offset(spec.bits)
        codes = codes + off
        zeros = torch.full((1, 1), float(off), dtype=torch.float32, device=w.device)
    else:
        zeros = _kernel_layout(zeros_g, k_stored, n_stored, spec.group_size)
    scales = _kernel_layout(scales_g, k_stored, n_stored, spec.group_size)
    if packing_for_bits(spec.bits)[0] == "byte":
        # byte layouts store two's-complement code-128 (see packing.py);
        # shifting the zero-point keeps (code - zero) invariant
        codes = codes - 128
        zeros = zeros - 128.0
    qweight = pack_codes_sharded(codes, spec.bits, k_shards)
    return QuantizedTensor(qweight, cast_side(scales), cast_side(zeros),
                           None, spec, (k, n), "affine", k_shards, n_pad, k_pad)
