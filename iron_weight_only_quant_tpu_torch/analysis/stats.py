"""Numeric analysis of quantized artifacts and activations (port of
``analysis/stats.py``).  Codes are unpacked on the artifact's device and
every result is a numpy array or a Python number on the host.

Capability map to the reference:
  * :func:`codeword_histogram`     ~ visualize_utils.plot_random_fp_dists /
                                     _count_fp4_values (quant_linear.py:366-384)
  * :func:`exponent_histogram`     ~ visualize_utils.plot_random_fp_exponent_dists
  * :func:`exponent_outlier_stats` ~ visualize_utils.count_fp8_exponent_outliers
  * :func:`fp16_bit_sparsity`      ~ utils.visualize_fp16_bit_sparsity
                                     (utils.py:132-200)
  * :func:`activation_pre_align`   ~ the FIGLUT-I activation pre-alignment the
                                     reference defines but never calls
                                     (quant_linear.py:19-81, C7)
  * :func:`capture_linear_inputs`  ~ demo_activation.py forward-pre-hook capture
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import FloatFormat
from ..models.common import recording_linears
from ..ops.packing import unpack_codes_sharded
from ..ops.qmatmul import packed_bits
from ..quantize.qtensor import QuantizedTensor


def _logical_codes(qt: QuantizedTensor) -> np.ndarray:
    codes = unpack_codes_sharded(
        qt.qweight, packed_bits(qt), qt.k_stored, qt.k_shards)[: qt.k].cpu().numpy()
    if packed_bits(qt) == 8:
        codes = codes + 128  # stored shifted (packing.py)
    return codes


def codeword_histogram(qt: QuantizedTensor) -> Tuple[np.ndarray, np.ndarray]:
    """Decoded-value histogram of a packed tensor: (values, counts)."""
    if qt.mode == "lut":
        book = qt.codebook.cpu().numpy()
        codes = _logical_codes(qt)
        counts = np.bincount(codes.ravel(), minlength=book.size)
        order = np.argsort(book)
        return book[order], counts[order]
    # affine formats have per-group grids; histogram the integer codes
    codes = _logical_codes(qt)
    values, counts = np.unique(codes, return_counts=True)
    return values.astype(np.float64), counts


def exponent_histogram(qt: QuantizedTensor, fmt: Optional[FloatFormat] = None):
    """Exponent-field occupancy for minifloat artifacts: (fields, counts)."""
    if fmt is None:
        fmt = qt.spec.float_format
    if fmt is None:
        raise ValueError("exponent histogram requires a minifloat artifact")
    codes = _logical_codes(qt)
    exp_field = (codes >> fmt.mant_bits) & ((1 << fmt.exp_bits) - 1)
    counts = np.bincount(exp_field.ravel(), minlength=1 << fmt.exp_bits)
    return np.arange(1 << fmt.exp_bits), counts


def exponent_outlier_stats(
    qt: QuantizedTensor, lo: int, hi: int, group_of: int = 4
) -> Dict[str, float]:
    """Per-group-of-N outlier statistics over the exponent field.

    An outlier has exponent field outside [lo, hi] -- the double-approx
    alignment criterion (quant_linear.py:334).  Returns the distribution of
    outlier counts per group.
    """
    fmt = qt.spec.float_format
    if fmt is None:
        raise ValueError("outlier stats require a minifloat artifact")
    codes = _logical_codes(qt)
    exp_field = ((codes >> fmt.mant_bits) & ((1 << fmt.exp_bits) - 1)).T.ravel()
    usable = exp_field.size - exp_field.size % group_of
    groups = exp_field[:usable].reshape(-1, group_of)
    outliers = ((groups < lo) | (groups > hi)).sum(axis=1)
    dist = np.bincount(outliers, minlength=group_of + 1)
    return {
        "n_groups": int(groups.shape[0]),
        "frac_groups_with_outlier": float((outliers > 0).mean()),
        "frac_groups_gt1_outlier": float((outliers > 1).mean()),
        "outlier_count_hist": dist.tolist(),
    }


def fp16_bit_sparsity(data: np.ndarray, keep_bits: int = 13) -> Dict[str, np.ndarray]:
    """Aligned-mantissa bit sparsity of fp16 data (utils.py:132-200 semantics).

    Decomposes to sign/exponent/mantissa, aligns every mantissa (with
    implicit leading 1, two padding zeros) to the max exponent, truncates to
    ``keep_bits``, and counts zeros per bit position (MSB first).
    """
    x = np.asarray(data, np.float16).ravel()
    raw = x.view(np.uint16).astype(np.int32)
    sign = (raw >> 15) & 0x1
    exp = (raw >> 10) & 0x1F
    mant = raw & 0x3FF

    bias = 15
    is_sub = exp == 0
    exp_unbiased = np.where(is_sub, 1 - bias, exp - bias)
    max_exp = exp_unbiased.max()
    leading = np.where(is_sub, 0, 1)
    mant_ext = ((leading << 10) | mant) << 2  # 13 bits
    shift = np.clip(max_exp - exp_unbiased, 0, 31)
    aligned = (mant_ext >> shift) & ((1 << keep_bits) - 1)

    bits = (aligned[:, None] >> np.arange(keep_bits)) & 0x1
    zero_counts = (bits == 0).sum(axis=0)[::-1]  # MSB first
    return {
        "sign_bits": sign,
        "exponent_bits": exp,
        "mantissa_bits": mant,
        "aligned_bits": bits,
        "zero_counts": zero_counts,
    }


def activation_pre_align(
    x: np.ndarray, mantissa_bits: int = 12
) -> Tuple[np.ndarray, np.ndarray]:
    """FIGLUT-I style activation pre-alignment (the reference's dormant C7).

    Aligns each row of a 2-D activation matrix to its max exponent and
    returns (sign+mantissa bit planes [rows, cols, 1+mantissa_bits],
    row_max_exponents [rows]).  This is the representation a LUT-based
    accelerator consumes; here it feeds analysis of how much activation
    precision survives alignment.
    """
    x = np.asarray(x, np.float64)
    if x.ndim != 2:
        raise ValueError("expected 2-D activations")
    absx = np.abs(x)
    nz = absx > 0
    exps = np.full(x.shape, -np.inf)
    if nz.any():
        exps[nz] = np.floor(np.log2(absx[nz]))
    row_max = exps.max(axis=-1)
    row_max = np.where(np.isfinite(row_max), row_max, 0.0)

    mant = x / np.exp2(row_max)[:, None]
    mant_int = np.round(mant * 2.0 ** (mantissa_bits - 1)).astype(np.int64)
    sign = (x < 0).astype(np.int64)[:, :, None]
    mags = np.abs(mant_int)[:, :, None]
    planes = (mags >> np.arange(mantissa_bits - 1, -1, -1)) & 0x1
    return np.concatenate([sign, planes], axis=-1), row_max


def capture_linear_inputs(
    forward, params, cfg, tokens, names: Optional[List[str]] = None
) -> Dict[str, np.ndarray]:
    """Record the inputs of named linear layers during one forward pass
    (the hook-free analogue of demo_activation.py's forward-pre-hooks).

    ``params`` must carry ``"name"`` keys (quantize.gptq_model.annotate_linears
    adds them per block).  numpy has no bfloat16: bf16 inputs come back as
    float32 (exact)."""
    captured: Dict[str, np.ndarray] = {}

    def cb(name, x):
        if names is None or name in names:
            if x.dtype == torch.bfloat16:
                x = x.float()
            captured.setdefault(name, x.detach().cpu().numpy())

    with torch.inference_mode(), recording_linears(cb):
        forward(params, tokens, cfg)
    return captured
