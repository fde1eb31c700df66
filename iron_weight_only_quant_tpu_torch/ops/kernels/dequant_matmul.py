"""Dequant-matmul: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``ops/pallas/dequant_matmul.py`` in the JAX package.  Sixteen
hand-written CUDA kernels compute ``y = x @ dequant(qt)`` for artifacts with
f32 side info, per storage layout:

  nib4 (int4, bfp4):  ``csrc/w4_matmul.cu``, ``csrc/w4_matmul_prenorm.cu``
                (bf16 x: the bf16 family of ``csrc/wa_slab_mma.cuh``; f32
                x: design notes in ``csrc/w4_common.cuh``),
                ``csrc/w4a8_matmul.cu``, ``csrc/w4a16_matmul.cu``
                (``csrc/wa_slab_mma.cuh``);
  byte (int8, bfp8):  ``csrc/w8_matmul.cu``, ``csrc/w8_matmul_prenorm.cu``
                (bf16 x: the bf16 family of ``csrc/wa_slab_mma.cuh``; f32
                x: design notes in ``csrc/w8_common.cuh``),
                ``csrc/w8a8_matmul.cu``, ``csrc/w8a16_matmul.cu``
                (``csrc/wa_slab_mma.cuh``);
  s21 (3-bit):  ``csrc/w3_matmul.cu`` (bf16 x: the bf16 family of
                ``csrc/wa_slab_mma.cuh``; f32 x: design notes in
                ``csrc/w3_common.cuh``), ``csrc/w3a8_matmul.cu``,
                ``csrc/w3a16_matmul.cu`` (``csrc/wa_slab_mma.cuh``);
  LUT nib4 (4-bit minifloat): ``csrc/lut4_matmul.cu`` (bf16 x: the bf16
                family of ``csrc/wa_slab_mma.cuh``; f32 x: design notes in
                ``csrc/lut_common.cuh``), ``csrc/lut4a16_matmul.cu``
                (``csrc/wa_slab_mma.cuh``);
  LUT nq42 (fp6 when K % 4 == 0): ``csrc/lut6_matmul.cu`` (bf16 x, f32 x
                as nib4), ``csrc/lut6a16_matmul.cu`` (``csrc/wa_slab_mma.cuh``);
  LUT byte (fp8, byte-per-code fp6): ``csrc/lut8_matmul.cu`` (bf16 x, f32 x
                as nib4).

The ``w4``/``w8``/``w3``/``lut`` kernels take bf16/f32 activations; the
affine nib4 and byte layouts also have a prenorm kernel, which applies the
weightless RMSNorm ``r = rsqrt(mean(x^2) + eps)`` to the f32 sum.  The s21
and LUT layouts have none, as in the JAX package (``prenorm_supported``): a
``pre_norm`` normalizes x first (:func:`_rms_nogamma`, cast back to x's
type), then the kernel runs.  A LUT kernel decodes each code to its exact
minifloat value from the format's exponent and mantissa widths (never from
the artifact's codebook) and computes ``w = val*s (+ z)``.  The nib4, nq42
and byte LUT kernels (``lut4``, ``lut6``, ``lut8``), the s21 kernel
(``w3``), the affine nib4 kernels (``w4_matmul``, ``w4_matmul_prenorm``)
and the affine byte kernels (``w8_matmul``, ``w8_matmul_prenorm``)
(:data:`BF16_MMA`) take bf16 x on the bf16 tensor cores
(:func:`bf16_mma_route`): the codes decode to their exact bf16 values,
``mma.sync`` m16n8k16 sums each group's products in f32, ``acc += part*s
(+ xsum*z)`` (affine: ``- xsum*(s*z)``), the kernel summing each group's
x itself for the zeros.  The two prenorm kernels keep their epilogue norm
there: the kernel reads the raw x, sums its squares too and scales the f32
sum by the row factor.  Elsewhere a row pass runs only where a
``pre_norm`` is given, which it then applies to a copy of x (the same
function: normalize, cast to bf16, then the product), or where x cannot be
read in place.  f32 x stays on their CUDA-core kernel, under the same name
and launch count.
The ``a8``/``a16`` kernels take ``activation_bits`` 8 or 16: a row pass
quantizes x to one int8 plane (A8, ``sx = absmax/127``) or two (A16, ``x
~= sx*(256*hi + lo)``, ``sx = absmax/32512``), the product runs on integer
codes, and the f32 result is scaled by the row's ``sx``.  Every
int-activation kernel (:data:`SLAB_MMA`: the A16 kernels ``w4a16``,
``w8a16``, ``w3a16``, ``lut4a16``, ``lut6a16`` with two planes, the A8
kernels ``w4a8``, ``w8a8``, ``w3a8`` with one) is a layout of the int8
slab kernel (``csrc/wa_slab_mma.cuh``): it runs its products on the int8
tensor cores and takes the slab kernel's K-split plan
(:func:`plan_slab_splits`); its row pass also writes each group's
activation sum (:func:`activation_group_sums`).
Under activation bits a ``pre_norm`` is applied to x before quantizing (in
the row pass), as the JAX package does, so no prenorm kernel runs.  LUT
artifacts take A16 where the format's exact values form an int8 grid (fp4 E2M1 and E1M2: ``lut4a16``; fp6 E2M3 in the nq42
layout: ``lut6a16``); A16 on a wide-exponent format (fp8, fp6 E3M2)
warns and runs with full-precision activations, and A8 raises, as in the JAX
package.  The layer-stacked entry point reuses the kernels with the layer
as a pointer offset.

Some artifacts the JAX package never sends to a Pallas kernel, by their
format alone (:func:`xla_route`): affine artifacts of another format than
int or bfp, approximate or non-minifloat LUT artifacts, ``k_shards > 1``,
16-bit side info, storage bits outside {3, 4, 6, 8}, 3-bit groups that
straddle the K/8 slabs, and 6-bit (nq42) groups that straddle the K/4
quarters.  There it computes ``dequantize_weight`` in f32 and
a plain matmul (its XLA path), with ``pre_norm`` applied to x first and the
activation bits ignored.  :func:`route_matmul` does the same here, on the
CPU and on the card alike, counted in ``ROUTE_CALLS``; the product is
``torch.matmul``, as the JAX package leaves it to XLA.  The route is chosen
by the artifact's format before any launch and never stands in for a kernel
that fails.

Otherwise dispatch is by the activation's device: a CPU tensor takes the
plain PyTorch version (:func:`dequant_matmul_plain`), a CUDA tensor launches
the kernel or raises ``NotImplementedError`` for an artifact no CUDA kernel
takes (an affine artifact without zeros, N not a multiple of 4, a group
that is not a multiple of 4 under activation bits).  Nothing falls back
quietly.  The plain version computes what the kernel computes,
activation quantization included; this deliberately differs from the JAX
package's XLA path, which ignores activation bits: here the CPU path stands
in for the kernel.

``LAUNCHES`` counts kernel launches, ``STACKED_LAUNCHES`` those of them
on a layer-stacked artifact, ``PLAIN_CALLS`` calls of the plain
version per name of the kernel it stands in for (an artifact no kernel
takes is not counted), ``ROUTE_CALLS`` the route's calls;
:func:`reset_counts` zeroes all four.  The two modes of the W4 inner-loop
probe kernel (``ops/kernels/w4_inner.py``, no serving path) count here too.
The counts are taken in Python where a launch is issued; the engine's CUDA
graphs take a capture's counts back and add them at every replay
(``engine/graphs.py``), so the counters count launches that ran.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import Dict, Optional, Tuple

import torch

from ...quantize.qtensor import QuantizedTensor
from ..packing import unpack_codes_sharded
from ...formats.minifloat import code_to_float
from ..qmatmul import _rms_nogamma, dequantize_weight, index_stacked, packed_bits

W4 = "w4_matmul"
W4_PRENORM = "w4_matmul_prenorm"
W8 = "w8_matmul"
W8_PRENORM = "w8_matmul_prenorm"
W4A8 = "w4a8_matmul"
W4A16 = "w4a16_matmul"
W8A8 = "w8a8_matmul"
W8A16 = "w8a16_matmul"
W3 = "w3_matmul"
W3A8 = "w3a8_matmul"
W3A16 = "w3a16_matmul"
LUT4 = "lut4_matmul"
LUT4A16 = "lut4a16_matmul"
LUT8 = "lut8_matmul"
LUT6 = "lut6_matmul"
LUT6A16 = "lut6a16_matmul"
# the two modes of the W4 inner-loop probe kernel (ops/kernels/w4_inner.py)
W4_INNER_F32 = "w4_inner_f32"
W4_INNER_MAGIC = "w4_inner_magic"
ACTIVATION_BITS = (8, 16)
# packed storage bits -> (kernel, prenorm kernel or None, A8 kernel or None,
# A16 kernel or None), for affine and for LUT artifacts
_KERNELS = {4: (W4, W4_PRENORM, W4A8, W4A16), 8: (W8, W8_PRENORM, W8A8, W8A16),
            3: (W3, None, W3A8, W3A16)}
_LUT_KERNELS = {4: (LUT4, None, None, LUT4A16), 8: (LUT8, None, None, None),
                6: (LUT6, None, None, LUT6A16)}
LAUNCHES: Dict[str, int] = {name: 0 for table in (_KERNELS, _LUT_KERNELS)
                            for names in table.values() for name in names
                            if name is not None}
LAUNCHES.update({W4_INNER_F32: 0, W4_INNER_MAGIC: 0})
PLAIN_CALLS: Dict[str, int] = dict(LAUNCHES)
# the launches of LAUNCHES made by fused_quantized_matmul_stacked (a
# layer-stacked artifact, the reference's `_pfx` kernels): LAUNCHES counts
# every launch, this the stacked ones among them
STACKED_LAUNCHES: Dict[str, int] = dict(LAUNCHES)
ROUTE = "xla_route"
ROUTE_CALLS: Dict[str, int] = {ROUTE: 0}
# every dispatch counter (the engine's CUDA graphs add a replay's counts to
# each: engine/graphs.py)
COUNTERS = (LAUNCHES, STACKED_LAUNCHES, PLAIN_CALLS, ROUTE_CALLS)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,   # x, x_bf16, ldx, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,              # ws, rnorm, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, stored rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # G, kc, splits
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p,                  # k_logical, eps, stream
]
_ARGTYPES_A = [  # the int-activation kernels (csrc/wa_slab_mma.cuh launch_wa_slab)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # x, x_bf16, k_logical, norm
    ctypes.c_float, ctypes.c_void_p,                                # eps, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # xq, sx, ws, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, stored rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,      # G, kc, splits, stream
]
_ARGTYPES_LUT = [  # the LUT kernels (csrc/lut_common.cuh launch_lut)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,   # x, x_bf16, ldx, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z or NULL, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p,                               # ws, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, stored rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # G, kc, splits
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,                    # exp_bits, mant_bits, stream
]
_ARGTYPES_BF16_MMA = [  # the bf16 route (csrc/wa_slab_mma.cuh launch_bf16_mma)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # x, ldx, x_copy, k_logical
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p,                  # norm, eps, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z or NULL, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,              # xs or NULL, ws, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, stored rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # G, kc, splits
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,                    # exp_bits, mant_bits, stream
]
_ARGTYPES_A_LUT = _ARGTYPES_A[:-1] + [  # the LUT A16 kernels: the affine ones', then
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # exp_bits, mant_bits, stream
_ARGTYPES_ROWS_SLAB = [  # iwoq_quantize_rows_slab, the slab kernels' row pass alone
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # x, x_bf16, k_logical, slabs
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # Kb, G, bits
    ctypes.c_int, ctypes.c_float,                                   # norm, eps
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,              # xq, sx, xsum
    ctypes.c_int, ctypes.c_void_p,                                  # M, stream
]
_BLOCK_N, _TILE_M = 128, 8  # must match kBlockN / kTileM in w4_common.cuh
_MIN_ROWS_PER_SPLIT = 64
_BLOCKS_PER_SM = 3
# The layouts of the slab kernel (csrc/wa_slab_mma.cuh; the Layout enum of
# csrc/slab_tile.cuh, whose values these are): the int8 family (A16) takes
# the affine nib4, byte and s21 layouts and the nib4 and nq42 LUT ones; the
# bf16 family (bf16 x, bf16 products) the nib4, nq42 and byte LUT layouts,
# s21, affine nib4 and affine byte, and the W4 inner-loop probe's two
# decodes of the affine nib4 packing (bf16 x: magic on bf16 products, f32
# on TF32 ones).
SLAB_LAYOUT_IDS = {"nib4": 0, "byte": 1, "s21": 2, "lut4": 3, "lut6": 4,
                   "lut4_bf16": 5, "lut6_bf16": 6, "s21_bf16": 7, "nib4_bf16": 8,
                   "byte_bf16": 9, "lut8_bf16": 10, "nib4_magic_bf16": 11,
                   "nib4_tf32_bf16": 12}
# layout -> (slabs: K streams a packed row, row r of slab i holding K column
# i*Kb + r; then (tokens, channels, parts) a block takes at decode, M <= 8,
# and beyond): SlabTile's S, and its MT, BN and P at NT = 1 and at
# slab_tile_nt(9, layout) (tests/test_torch_w4a16_w3_mma.py compiles
# csrc/slab_tile.cuh with the host compiler and holds this table to it)
SLAB_TILES = {
    "nib4": (2, (8, 128, 2), (32, 64, 2)),
    "byte": (1, (8, 128, 4), (32, 64, 4)),
    "s21": (8, (8, 64, 1), (16, 64, 1)),
    "lut4": (2, (8, 128, 2), (32, 64, 2)),
    "lut6": (4, (8, 128, 1), (32, 64, 1)),
    "lut4_bf16": (2, (8, 128, 2), (64, 128, 1)),
    "lut6_bf16": (4, (8, 128, 1), (64, 64, 1)),
    "s21_bf16": (8, (8, 64, 1), (32, 64, 1)),
    "nib4_bf16": (2, (8, 128, 2), (64, 128, 1)),
    "byte_bf16": (1, (8, 128, 4), (64, 256, 1)),
    "lut8_bf16": (1, (8, 128, 4), (64, 256, 1)),
    "nib4_magic_bf16": (2, (8, 128, 2), (64, 128, 1)),
    "nib4_tf32_bf16": (2, (8, 128, 2), (64, 128, 1)),
}
# The one-plane (A8) wide tile where it is not the layout's wide tile:
# slab_tile_nt with planes 1 gives the affine nib4 (w4a8) and byte (w8a8)
# layouts the 64-token tile and s21 (w3a8) the 32-token one (the same test
# holds them to csrc/slab_tile.cuh).
SLAB_TILES_A8 = {"nib4": (64, 64, 2), "byte": (64, 64, 4), "s21": (32, 64, 1)}
SLAB_WINDOW = 32  # kSlabWin: slab rows a window
# The int-activation kernels on the int8 tensor cores, by layout: every A16
# kernel (two planes) and every A8 kernel (one plane, on the layout of the
# A16 kernel of its storage bits).
SLAB_MMA = {W4A16: "nib4", W8A16: "byte", W3A16: "s21", LUT4A16: "lut4", LUT6A16: "lut6",
            W4A8: "nib4", W8A8: "byte", W3A8: "s21"}
# The bf16-x calls of the nib4, nq42 and byte LUT kernels, of the s21
# kernel, of the two affine nib4 kernels (w4_matmul, w4_matmul_prenorm) and
# of the two affine byte kernels (w8_matmul, w8_matmul_prenorm) on the bf16
# tensor cores, by layout (a prenorm form shares its flat kernel's layout,
# its row factor in the epilogue); f32 x stays on their CUDA-core kernels
# (csrc/lut_common.cuh, csrc/w3_common.cuh, csrc/w4_common.cuh,
# csrc/w8_common.cuh).  Name and launch count are the kernel's either way.
BF16_MMA = {LUT4: "lut4_bf16", LUT6: "lut6_bf16", LUT8: "lut8_bf16", W3: "s21_bf16",
            W4: "nib4_bf16", W4_PRENORM: "nib4_bf16", W8: "byte_bf16",
            W8_PRENORM: "byte_bf16"}
# The bf16-x calls of the W4 inner-loop probe kernel (ops/kernels/w4_inner.py)
# on the same family, by mode: magic on the bf16 tensor cores, f32 on the
# TF32 ones; the rule and the f32-x kernel are w4_matmul's.
W4_INNER_MMA = {W4_INNER_MAGIC: "nib4_magic_bf16", W4_INNER_F32: "nib4_tf32_bf16"}
# Layouts whose K-split plan never starts a partial round of blocks (see
# plan_slab_splits): byte, which decodes nothing, and affine nib4 and byte
# in both families, whose decode is a few masks and permutes a word (on the
# H100 the floored plan beat the rounded one at the 7B qkv decode shape and
# tied at the others; for the bf16 nib4 layout it lost at gate_up, won by
# more at qkv, and won over a decode step; the bf16 byte layout's flat W8
# calls, o, down and the lm_head, get the same plan either way).  The LUT
# byte layout keeps the rounded plan: at the fp8 decode step it won at
# gate_up by more than it lost at qkv.  The probe's two layouts, like
# nib4_bf16: on the H100 whole rounds won at qkv by more than they lost at
# gate_up (the only shapes whose plan differs), for the f32 decode's
# converts too.
SLAB_WHOLE_ROUNDS = ("byte", "nib4", "nib4_bf16", "byte_bf16", "nib4_magic_bf16",
                     "nib4_tf32_bf16")
_SM_COUNT: Dict[int, int] = {}


def reset_counts() -> None:
    for d in COUNTERS:
        for k in d:
            d[k] = 0


def xla_route(qt: QuantizedTensor) -> bool:
    """Whether the JAX package computes this artifact on its XLA path by its
    format alone (the format conditions of its ``_layout_supported``; its
    TPU tile conditions are not ported): an affine artifact of another
    format than int or bfp, a LUT artifact that is not an exact minifloat,
    ``k_shards > 1``, 16-bit scales or zeros, storage bits outside {3, 4, 6,
    8}, a 3-bit group that straddles the K/8 slabs of the s21 layout, or a
    6-bit group that straddles the K/4 quarters of the nq42 layout
    (``_layout6_supported``)."""
    if qt.mode == "affine":
        if qt.spec.fmt not in ("int", "bfp"):
            return True
    elif qt.mode == "lut":
        if qt.spec.fmt != "fp" or qt.spec.approximate:
            return True
    else:
        return True
    if qt.k_shards > 1:
        return True
    if qt.scales.element_size() != 4 or (qt.zeros is not None
                                         and qt.zeros.element_size() != 4):
        return True
    bits = packed_bits(qt)
    if bits not in (3, 4, 6, 8):
        return True
    if bits in (3, 6):
        ks, slabs = qt.k_stored, 8 if bits == 3 else 4
        rows = qt.scales.shape[-2] - qt.side_pad
        g = ks // rows
        return bool(ks % slabs or (rows > 1 and (g > ks // slabs or (ks // slabs) % g)))
    return False


def _names(qt: QuantizedTensor):
    """The kernel table entry of ``qt``'s storage layout (None: no kernel)."""
    table = _KERNELS if qt.mode == "affine" else _LUT_KERNELS
    return table.get(packed_bits(qt))


def _lut_a16_mult(fmt) -> Optional[float]:
    """The scale ``2**-t`` of the exact int8 grid of a minifloat format, or
    None.  With ``t = mant_bits + bias - 1`` every exact value times ``2**t``
    is the integer ``+-(mant_full << (max(exp_field, 1) - 1))``; it fits
    int8 iff the largest one, ``(2**(mant_bits+1) - 1) << (max_exp_field -
    1)``, is at most 127: fp4 E2M1 (12) and E1M2 (7), fp6 E2M3 (60)."""
    top = ((1 << (fmt.mant_bits + 1)) - 1) << max(fmt.max_exp_field - 1, 0)
    if top > 127:
        return None
    return 2.0 ** -(fmt.mant_bits + fmt.bias - 1)


def a16_supported(qt: QuantizedTensor) -> bool:
    """Whether the split-plane A16 activation path exists for this
    artifact's format: every affine artifact, and the LUT minifloats of 4 or
    6 stored bits whose exact values form an int8 grid
    (:func:`_lut_a16_mult`).  Wide-exponent LUT formats (fp8, fp6 E3M2)
    run with full-precision activations under A16, with a warning."""
    if qt.mode == "lut":
        return packed_bits(qt) in (4, 6) and _lut_a16_mult(qt.spec.float_format) is not None
    return True


def _effective_activation_bits(qt: QuantizedTensor,
                               activation_bits: Optional[int],
                               warn: bool = False) -> Optional[int]:
    """The activation bits a kernel call runs with: A16 on an artifact
    without the A16 path drops to full precision (with a warning when
    ``warn``), A8 on a LUT artifact raises, as in the JAX package."""
    if activation_bits is None:
        return None
    if activation_bits not in ACTIVATION_BITS:
        raise NotImplementedError(
            f"activation_bits={activation_bits}: must be None, 8 or 16")
    if activation_bits == 16 and not a16_supported(qt):
        if warn:
            warnings.warn(
                f"activation_bits=16 is unsupported for {qt.mode}/{packed_bits(qt)}-bit "
                "artifacts; running this matmul with full-precision activations",
                stacklevel=3)
        return None
    if qt.mode == "lut" and activation_bits == 8:
        raise NotImplementedError("int8 activations with LUT artifacts")
    return activation_bits


def kernel_name(qt: QuantizedTensor, pre_norm: Optional[float] = None,
                activation_bits: Optional[int] = None) -> Optional[str]:
    """The kernel that takes ``qt``'s storage layout (None: no kernel, or
    an artifact of the route).

    Under ``activation_bits`` (8 or 16) the int-activation kernel of the
    layout runs and ``pre_norm`` does not pick a kernel: the norm is
    applied to x before quantizing; A16 on a LUT format without the A16
    path names the flat kernel.  A layout without a prenorm kernel (s21,
    LUT) names its flat kernel for a ``pre_norm`` too: x is normalized
    before its product (in torch, or in the row pass of the bf16 route,
    :func:`bf16_mma_route`).
    """
    names = None if xla_route(qt) else _names(qt)
    if names is None:
        return None
    activation_bits = _effective_activation_bits(qt, activation_bits)
    if activation_bits is not None:
        return names[2 + ACTIVATION_BITS.index(activation_bits)]
    return names[1] if pre_norm is not None and names[1] else names[0]


def prenorm_supported(qt: QuantizedTensor) -> bool:
    """Whether a kernel applies ``pre_norm`` in its epilogue for this
    artifact (the affine nib4 and byte layouts, as ``prenorm_supported`` of
    the JAX package); elsewhere x is normalized first."""
    names = _names(qt)
    return names is not None and names[1] is not None


def _bf16_mma_fits(kb: int, g: int) -> bool:
    """The bf16 family's shape rule: slab rows and group (in slab rows) in
    fours (its windows split at group ends with 4-row granularity)."""
    return kb % 4 == 0 and g % 4 == 0


def bf16_mma_route(qt: QuantizedTensor, dtype: torch.dtype,
                   pre_norm: Optional[float] = None) -> bool:
    """Whether a call of this (flat or layer-stacked) artifact with x of
    ``dtype`` and ``pre_norm`` takes the bf16 tensor-core route of its
    kernel (:data:`BF16_MMA`): bf16 x on the nib4 (fp4), nq42 (fp6) or byte
    (fp8) LUT layout or the s21 (3-bit), nib4 (int4, bfp4) or byte (int8,
    bfp8) affine one, whose slab rows and group are multiples of 4.  There
    a ``pre_norm`` runs in the kernel's row pass, or, for the affine nib4
    and byte prenorm kernels, in their epilogue; f32 x and the rare shapes
    outside the rule take the CUDA-core kernel of the same name (s21 and
    LUT after x is normalized in torch)."""
    if dtype != torch.bfloat16:
        return False
    name = kernel_name(qt, pre_norm)
    if name not in BF16_MMA:
        return False
    rows = (qt.scales.shape[1] - qt.side_pad if qt.qweight.dim() == 3
            else qt.scales.shape[0])
    if rows < 1 or qt.k_stored % rows:
        return False
    slabs = SLAB_TILES[BF16_MMA[name]][0]
    return _bf16_mma_fits(qt.k_stored // slabs, _group_size(qt, rows))


def _group_size(qt: QuantizedTensor, rows: int) -> int:
    """K columns per side row as the kernel walks them (nib4: a group never
    straddles the two K halves; ``_nib4_groups`` splits those that do; s21,
    nq42: one side row spans the K/8 rows of a slab, or the K/4 rows of a
    quarter, or divides them)."""
    ks, bits = qt.k_stored, packed_bits(qt)
    if bits not in (3, 4, 6):
        return ks // rows
    kp = ks // {4: 2, 3: 8, 6: 4}[bits]
    return kp if rows == 1 else math.gcd(ks // rows, kp)


def _layout_supported(qt: QuantizedTensor, rows: int,
                      activation_bits: Optional[int] = None) -> bool:
    if activation_bits is not None and (activation_bits not in ACTIVATION_BITS or (
            qt.mode == "lut" and activation_bits == 8)):
        return False
    if xla_route(qt) or kernel_name(qt, None, activation_bits) is None:
        return False
    if qt.zeros is None and qt.mode != "lut":
        return False  # affine artifacts carry zeros; symmetric LUT ones do not
    ks, n = qt.k_stored, qt.n + qt.n_pad
    if n % 4 or rows < 1 or ks % rows:
        return False
    if packed_bits(qt) == 4 and ks % 2:
        return False
    activation_bits = _effective_activation_bits(qt, activation_bits)
    if activation_bits is not None and _group_size(qt, rows) % 4:
        return False  # the slab kernel's segments end on rows in fours
    if qt.zeros is None:
        return True
    z_rows = qt.zeros.shape[-2] - (qt.side_pad if qt.zeros.shape[-2] > 1 else 0)
    return z_rows in (1, rows)


def kernel_supported(qt: QuantizedTensor,
                     activation_bits: Optional[int] = None) -> bool:
    """Whether a CUDA kernel takes this flat (2-D) artifact."""
    return qt.qweight.dim() == 2 and _layout_supported(
        qt, qt.scales.shape[0], activation_bits)


def kernel_supported_stacked(qt: QuantizedTensor,
                             activation_bits: Optional[int] = None) -> bool:
    """Whether a CUDA kernel takes this layer-stacked ([L, ...]) artifact."""
    return qt.qweight.dim() == 3 and _layout_supported(
        qt, qt.scales.shape[1] - qt.side_pad, activation_bits)


# ---------------------------------------------------------------- plain

def quantize_activations(x2: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row activation quantization of ``x2`` ``[M, K]`` (the A8 and A16
    branches of the JAX package's ``_prep_x``), all in f32.

    Returns ``(planes, sx)``: int8 planes ``[P, M, K]`` and f32 ``sx [M]``.
    A8 (P = 1): ``sx = max(absmax, 1e-8) / 127``, ``q = clip(round(x / sx),
    -127, 127)``.  A16 (P = 2): ``sx = max(absmax, 1e-8) / 32512``, ``xi =
    round(x / sx)``, planes ``hi = (xi + 128) >> 8`` and ``lo = xi - (hi <<
    8)``, so ``x ~= sx * (256 * hi + lo)``.  ``round`` is half to even.  A
    K padding is appended by the caller after this, so the row maximum sees
    only the real columns.
    """
    if bits not in ACTIVATION_BITS:
        raise NotImplementedError(f"activation_bits={bits}: must be None, 8 or 16")
    xf = x2.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8)
    # a tensor divisor: on CUDA torch turns division by a Python scalar into
    # a product with its reciprocal, which is not the IEEE quotient
    # (32512 = 127 * 256 keeps hi in [-127, 127])
    sx = amax / torch.full_like(amax, 127.0 if bits == 8 else 32512.0)
    if bits == 8:
        planes = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)[None]
    else:
        xi = torch.round(xf / sx).to(torch.int32)
        hi = (xi + 128) >> 8
        planes = torch.stack([hi, xi - (hi << 8)]).to(torch.int8)
    return planes, sx[:, 0]


def activation_group_sums(planes: torch.Tensor, g: int) -> torch.Tensor:
    """The activation sum of every row and group of ``g`` K columns, int64
    ``[M, K/g]``: A16 ``256*Σhi + Σlo`` of planes ``[2, M, K]`` (the ``xsum``
    of ``_group_accum_a16`` and ``_lut_accum_a16`` in the JAX package), A8
    ``Σq`` of planes ``[1, M, K]`` (that of ``_group_accum``'s int path),
    exact integers."""
    p = planes.to(torch.int64)
    m, k = p.shape[1], p.shape[2]
    codes = p[0] if p.shape[0] == 1 else p[0] * 256 + p[1]
    return codes.reshape(m, k // g, g).sum(dim=-1)


def _side_rows(qt: QuantizedTensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 (scales, zeros or None) ``[R, N_stored]`` of a flat artifact,
    side_pad rows dropped, per-channel/per-tensor rows broadcast."""
    s, z = qt.scales, qt.zeros
    rows = s.shape[0] - qt.side_pad
    n = qt.qweight.shape[-1]
    s = s[:rows].to(torch.float32).expand(rows, n)
    if z is not None:
        z = (z[:rows] if z.shape[0] > 1 else z).to(torch.float32).expand(rows, n)
    return s, z


def _lut_decode(qt: QuantizedTensor, decode) -> torch.Tensor:
    """``decode`` (codes -> values) of every code of a flat LUT artifact,
    ``[K_stored, N_stored]``: a table of the format's ``2**total_bits``
    codewords, gathered (the byte layout stores code - 128)."""
    fmt = qt.spec.float_format
    table = decode(torch.arange(1 << fmt.total_bits, dtype=torch.int32,
                                device=qt.qweight.device), fmt)
    bits = packed_bits(qt)
    codes = unpack_codes_sharded(qt.qweight, bits, qt.k_stored, qt.k_shards).long()
    return table[codes + 128 if bits == 8 else codes]


def _minifloat_int(codes: torch.Tensor, fmt) -> torch.Tensor:
    """The exact int8 grid of the A16 LUT path (``_minifloat_decode_int`` of
    the JAX package): ``code_to_float(code) * 2**t`` as an integer,
    ``+-(mant_full << (max(exp_field, 1) - 1))``."""
    e, m = fmt.exp_bits, fmt.mant_bits
    sign = (codes >> (e + m)) & 1
    expf = (codes >> m) & ((1 << e) - 1)
    mant_full = ((expf != 0).to(torch.int32) << m) | (codes & ((1 << m) - 1))
    ival = mant_full << (expf.clamp(min=1) - 1)
    return torch.where(sign == 1, -ival, ival)


def lut_matmul_plain(x2: torch.Tensor, qt: QuantizedTensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``x2 @ dequant(qt)`` for a flat LUT artifact, as the LUT kernels
    compute it (``_lut_accum`` of the JAX package): the codes decode to
    their exact minifloat values ``val`` (from the format, not the
    codebook), and per group of side rows ``acc += (x . val) * s``, then
    ``acc += sum(x) * z`` where the artifact has zeros, in f32, group after
    group; cast to ``out_dtype``, the ``n_pad`` columns dropped.  ``x2`` is
    ``[M, K_stored]``."""
    vals = _lut_decode(qt, code_to_float)
    s, z = _side_rows(qt)
    rows = s.shape[0]
    g = qt.k_stored // rows
    xf = x2.to(torch.float32)
    acc = torch.zeros((xf.shape[0], vals.shape[1]), dtype=torch.float32, device=x2.device)
    for r in range(rows):
        xg = xf[:, r * g:(r + 1) * g]
        acc = acc + (xg @ vals[r * g:(r + 1) * g]) * s[r]
        if z is not None:
            acc = acc + xg.sum(dim=1, keepdim=True) * z[r]
    return acc.to(out_dtype)[:, :qt.n]


def lut_int_matmul_plain(planes: torch.Tensor, sx: torch.Tensor, qt: QuantizedTensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """``sx * (planes @ dequant(qt))`` for a flat LUT artifact under A16, as
    ``lut4a16`` computes it (``_lut_accum_a16`` of the JAX package): the
    codes decode to the exact int8 grid ``ival`` (:func:`_minifloat_int`,
    ``val = ival * mult``, ``mult = 2**-t``); per group of side rows each
    plane's integer product with ``ival`` (exact, in f64) becomes f32,
    ``part = 256*pa + pb``, ``acc += part * (s*mult)``, then ``acc +=
    xsum * z`` (``xsum = 256*Σhi + Σlo``) where the artifact has zeros;
    then ``acc * sx``, cast to ``out_dtype``, the ``n_pad`` columns
    dropped.  ``planes`` is ``[2, M, K_stored]``."""
    fmt = qt.spec.float_format
    mult = _lut_a16_mult(fmt)
    ivals = _lut_decode(qt, _minifloat_int).to(torch.float64)
    s, z = _side_rows(qt)
    rows = s.shape[0]
    g = qt.k_stored // rows
    xq = planes.to(torch.float64)
    acc = torch.zeros((planes.shape[1], ivals.shape[1]), dtype=torch.float32,
                      device=planes.device)
    for r in range(rows):
        xg = xq[:, :, r * g:(r + 1) * g]
        pg = (xg @ ivals[r * g:(r + 1) * g]).to(torch.float32)  # [2, M, N]
        acc = acc + (pg[0] * 256.0 + pg[1]) * (s[r] * mult)
        if z is not None:
            isum = xg.sum(dim=-1).to(torch.int64)
            acc = acc + (isum[0] * 256 + isum[1]).to(torch.float32)[:, None] * z[r]
    return (acc * sx[:, None]).to(out_dtype)[:, :qt.n]


def int_matmul_plain(planes: torch.Tensor, sx: torch.Tensor, qt: QuantizedTensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``sx * (planes @ dequant(qt))`` for a flat affine artifact, as the
    int-activation kernels compute it (the int paths of ``_group_accum`` and
    ``_group_accum_a16``): per group of side rows, each plane's integer
    product with the stored codes (exact, in f64) becomes f32, ``part =
    256*pa + pb`` (A16) or ``pa`` (A8), the activation sum ``xsum = 256*Σhi
    + Σlo`` (or ``Σq``), and ``acc += part*s - xsum*(s*z)`` in f32, group
    after group; then ``acc * sx`` in f32, cast to ``out_dtype``, with the
    ``n_pad`` columns dropped.  ``planes`` is ``[P, M, K_stored]``.
    """
    codes = unpack_codes_sharded(qt.qweight, packed_bits(qt), qt.k_stored,
                                 qt.k_shards).to(torch.float64)
    s, z = _side_rows(qt)
    rows = s.shape[0]
    g = qt.k_stored // rows
    p, m = planes.shape[0], planes.shape[1]
    xq = planes.to(torch.float64)
    acc = torch.zeros((m, codes.shape[1]), dtype=torch.float32, device=planes.device)
    for r in range(rows):
        xg = xq[:, :, r * g:(r + 1) * g]
        pg = (xg @ codes[r * g:(r + 1) * g]).to(torch.float32)  # [P, M, N]
        isum = xg.sum(dim=-1).to(torch.int64)                  # [P, M]
        part = pg[0] if p == 1 else pg[0] * 256.0 + pg[1]
        xsum = (isum[0] if p == 1 else isum[0] * 256 + isum[1]).to(torch.float32)
        acc = acc + part * s[r] - xsum[:, None] * (s[r] * z[r])
    return (acc * sx[:, None]).to(out_dtype)[:, :qt.n]


def dequant_matmul_plain(x: torch.Tensor, qt: QuantizedTensor,
                         pre_norm: Optional[float] = None,
                         layer: Optional[int] = None,
                         activation_bits: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels, for any packed layout.

    Without ``activation_bits``: for an affine artifact ``dequantize_weight``
    in f32, an f32 matmul, then a cast to ``x.dtype``; for a LUT artifact
    :func:`lut_matmul_plain`.  A ``pre_norm`` on a layout with a prenorm
    kernel (affine nib4, byte) applies the row factor ``rsqrt(mean(x^2) +
    eps)`` over the logical K to the f32 result before the cast -- the
    order of that kernel's epilogue; on any other layout (s21, LUT, and
    those without a kernel) it normalizes x first (:func:`_rms_nogamma`,
    cast back to ``x.dtype``), as the JAX package does where no prenorm
    kernel exists (``fused_quantized_matmul``'s fallback and the XLA path).
    With ``activation_bits``: ``pre_norm`` normalizes x first, then
    :func:`quantize_activations`, K padding, and :func:`int_matmul_plain`
    (affine) or :func:`lut_int_matmul_plain` (LUT); A16 on a LUT format
    without the A16 path runs with full-precision activations (the caller
    warns) and A8 on a LUT artifact raises.  ``layer`` selects one layer of
    a stacked artifact.
    """
    name = kernel_name(qt, pre_norm, activation_bits)
    if name is not None:
        PLAIN_CALLS[name] += 1
    activation_bits = _effective_activation_bits(qt, activation_bits)
    qt = qt if layer is None else index_stacked(qt, layer)
    if pre_norm is not None and (activation_bits is not None
                                 or not prenorm_supported(qt)):
        x = _rms_nogamma(x, pre_norm)
        pre_norm = None
    lut = qt.mode == "lut"
    if activation_bits is not None:
        planes, sx = quantize_activations(x.reshape(-1, qt.shape[0]), activation_bits)
        if qt.k_pad:
            planes = torch.nn.functional.pad(planes, (0, qt.k_pad))
        y = (lut_int_matmul_plain if lut else int_matmul_plain)(planes, sx, qt, x.dtype)
        return y.reshape(x.shape[:-1] + (qt.shape[1],))
    if lut:
        x2 = x.reshape(-1, qt.shape[0])
        if qt.k_pad:
            x2 = torch.nn.functional.pad(x2, (0, qt.k_pad))
        y = lut_matmul_plain(x2, qt, x.dtype)
        return y.reshape(x.shape[:-1] + (qt.shape[1],))
    w = dequantize_weight(qt)
    xf = x.to(torch.float32)
    y = xf @ w
    if pre_norm is not None:
        y = y * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + pre_norm)
    return y.to(x.dtype)


# ---------------------------------------------------------------- kernels

def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def plan_splits(m: int, n: int, kp: int, sm_count: int) -> Tuple[int, int]:
    """(rows per K-split, number of K-splits) for an [m, n] output.

    Split K only as far as needed to give every SM a few blocks: each split
    adds an [m, n] f32 partial to the workspace traffic.
    """
    base = math.ceil(n / _BLOCK_N) * math.ceil(m / _TILE_M)
    want = math.ceil(_BLOCKS_PER_SM * sm_count / base)
    splits = max(1, min(want, kp // _MIN_ROWS_PER_SPLIT))
    kc = math.ceil(math.ceil(kp / splits) / 32) * 32
    return kc, math.ceil(kp / kc)


def slab_tile(m: int, layout: str, planes: int = 2) -> Tuple[int, int, int]:
    """(tokens, channels, parts) a block of the slab kernel takes for ``m``
    activation rows in ``layout`` (:data:`SLAB_TILES`) with ``planes`` int8
    activation planes (A16: 2, A8: 1; the bf16 family: any): the decode
    tile at M <= 8, else the layout's wide tile (:data:`SLAB_TILES_A8` for
    one plane where it has the layout).  A block splits its K range into
    ``parts`` over its warps."""
    if m > 8 and planes == 1 and layout in SLAB_TILES_A8:
        return SLAB_TILES_A8[layout]
    return SLAB_TILES[layout][1 if m <= 8 else 2]


def plan_slab_splits(m: int, n: int, kb: int, layout: str,
                     sm_count: int, planes: int = 2) -> Tuple[int, int]:
    """(slab rows per K-split, number of K-splits) of the slab kernel of
    ``layout`` (:data:`SLAB_MMA`, :data:`BF16_MMA`) with ``planes``
    activation planes for an [m, n] output over ``kb`` slab rows.

    A block splits its range into ``P`` parts (:func:`slab_tile`) over its
    warps, each a whole number of windows (32 rows), so ``kc`` is a multiple
    of ``32 * P``, and the splits cover the ``kb`` rows exactly once,
    ``[i * kc, min(kb, (i + 1) * kc))``.  K is split about as far as
    needed to fill the card's block slots once (two blocks an SM at decode,
    one beyond), from the shapes alone: the layouts that decode their codes
    take the nearest count of rounds (a second block on more SMs hides
    their decode); those of :data:`SLAB_WHOLE_ROUNDS`, which decode little
    or nothing and stream their bytes, never start a partial second round,
    which would cost them a whole one.
    """
    tokens, channels, parts = slab_tile(m, layout, planes)
    step = SLAB_WINDOW * parts
    base = math.ceil(n / channels) * math.ceil(m / tokens)
    slots = (2 if m <= 8 else 1) * sm_count
    want = slots // base if layout in SLAB_WHOLE_ROUNDS else math.floor(slots / base + 0.5)
    steps = math.ceil(kb / step)
    splits = max(1, min(want, steps))
    kc = step * math.ceil(steps / splits)
    return kc, math.ceil(kb / kc)


def slab_scratch_bytes(m: int, kb: int, layout: str, g: int, sums: bool, planes: int) -> int:
    """Bytes of the int8 scratch of a slab launch (:data:`SLAB_MMA`) in
    ``layout``: the activation planes ``[planes, M, slabs, Kb32]`` (A16: 2,
    A8: 1; each slab padded to a multiple of 32 rows), then, where the
    kernel reads them (every affine artifact, a LUT one with zeros), the
    int32 group sums ``[M, slabs * kb / g]`` (``launch_wa_slab`` in
    ``csrc/wa_slab_mma.cuh``)."""
    slabs = SLAB_TILES[layout][0]
    kb32 = math.ceil(kb / SLAB_WINDOW) * SLAB_WINDOW
    return planes * m * slabs * kb32 + (4 * m * slabs * (kb // g) if sums else 0)


def bf16_mma_scratch_bytes(m: int, kb: int, layout: str) -> int:
    """Bytes of the scratch of a bf16-family launch (:data:`BF16_MMA`) whose
    row pass copies x (a pre-norm that the kernel's epilogue does not apply,
    or x not 16-byte aligned): the bf16 copy
    ``[M, slabs, Kb32]``, each slab padded to a multiple of 32 rows
    (``launch_bf16_mma`` in ``csrc/wa_slab_mma.cuh``)."""
    slabs = SLAB_TILES[layout][0]
    return 2 * m * slabs * math.ceil(kb / SLAB_WINDOW) * SLAB_WINDOW


def x_needs_copy(x2: torch.Tensor, kb: int) -> bool:
    """Whether the bf16 family cannot read ``x2`` ``[M, K_stored]`` in
    place, in 16-byte copies of each slab's rows: x not 16-byte aligned, or
    K_stored or the slab rows ``kb`` no multiple of 8.  The row pass then
    copies it."""
    return bool(x2.data_ptr() % 16 or x2.shape[1] % 8 or kb % 8)


def _side_view(side: torch.Tensor, rows: int) -> Tuple[torch.Tensor, int, int]:
    """(2-D view, row stride, column stride) with stride 0 on broadcast axes."""
    side = side[:rows] if side.shape[0] > 1 else side
    rs = side.stride(0) if side.shape[0] > 1 else 0
    cs = side.stride(1) if side.shape[1] > 1 else 0
    return side, rs, cs


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _nib4_groups(ks: int, kp: int, rows: int, scales: torch.Tensor,
                 zeros: Optional[torch.Tensor]):
    """(group size, rows, scales, zeros) for the nib4 layout: packed row kp
    holds K columns kp and kp + Kp, so the kernel needs G | Kp."""
    _check(ks == 2 * kp, f"x has {ks} columns, the nib4 artifact stores {2 * kp}")
    g = ks // rows
    if rows == 1:
        g = kp
    elif kp % g:
        # group rows straddle the K halves: split each group so that the
        # kernel's row groups tile both halves (a per-call copy; no
        # main-path artifact takes this branch)
        f = g // math.gcd(g, kp)
        scales = scales[:rows].repeat_interleave(f, dim=0)
        if zeros is not None and zeros.shape[0] > 1:
            zeros = zeros[:rows].repeat_interleave(f, dim=0)
        rows, g = rows * f, g // f
    return g, rows, scales, zeros


def _byte_groups(ks: int, kp: int, rows: int) -> int:
    """Group size for the byte layout: one stored row per K column."""
    _check(ks == kp, f"x has {ks} columns, the byte artifact stores {kp}")
    _check(ks % rows == 0, f"{rows} side rows do not divide K={ks}")
    return ks // rows


def _slab_groups(ks: int, kb: int, rows: int, slabs: int) -> int:
    """Group size for the s21 (8 slabs) and nq42 (4 quarters) layouts, in
    slab rows: row r of slab i holds K column i*Kb + r (s21: a B row; nq42:
    a quad row), so the kernel needs G | Kb (per-channel: G = Kb)."""
    layout = "s21" if slabs == 8 else "nq42"
    _check(ks == slabs * kb, f"x has {ks} columns, the {layout} artifact stores {slabs * kb}")
    _check(ks % rows == 0, f"{rows} side rows do not divide K={ks}")
    g = kb if rows == 1 else ks // rows
    _check(kb % g == 0, f"group {g} straddles the K/{slabs} = {kb} slabs of the "
           f"{layout} layout")
    return g


def _load_fn(name: str, symbol: str, argtypes):
    from .build import load

    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _raise_if(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.iwoq_cuda_error_string(err).decode()})")


def _check_operands(x2: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                    zeros: Optional[torch.Tensor], rows: int) -> None:
    """What every kernel needs of its 2-D operands: one device, contiguous
    bf16/f32 x, contiguous 4-byte-aligned uint8 codes ``[*, N]``, f32 side
    info of ``rows`` or more (or 1) rows and N (or 1) columns."""
    dev, n = x2.device, qw.shape[1]
    _check(x2.dtype in (torch.bfloat16, torch.float32),
           f"x dtype {x2.dtype} is not bfloat16 or float32")
    sides = (("scales", scales),) + ((("zeros", zeros),) if zeros is not None else ())
    for name_, t in (("qweight", qw),) + sides:
        _check(t.device == dev, f"{name_} is on {t.device}, x on {dev}")
    for name_, t in sides:
        _check(t.dim() == 2 and t.dtype == torch.float32
               and t.shape[1] in (1, n) and (t.shape[0] == 1 or t.shape[0] >= rows),
               f"{name_} {tuple(t.shape)} {t.dtype} is not f32 [1|{rows}+, 1|{n}]")
    _check(qw.dtype == torch.uint8 and qw.is_contiguous()
           and qw.data_ptr() % 4 == 0, "qweight must be contiguous uint8")
    _check(x2.is_contiguous(), "x must be contiguous")


def _launch(bits: int, pre_norm: Optional[float], x2: torch.Tensor,
            qw: torch.Tensor, scales: torch.Tensor, zeros: Optional[torch.Tensor],
            rows: int, k_logical: int, n_out: int,
            activation_bits: Optional[int] = None, fmt=None,
            stacked: bool = False) -> torch.Tensor:
    """Launch the ``bits``-storage kernel on 2-D operands: its prenorm form
    if ``pre_norm`` (affine nib4, byte), its int-activation form if
    ``activation_bits``; a LUT kernel of minifloat format ``fmt`` where one
    is given (``zeros`` may then be None).  The LUT kernels, the s21 one
    and the affine nib4 and byte ones take bf16 x on their bf16 tensor-core
    route (:data:`BF16_MMA`, :func:`bf16_mma_route`; a ``pre_norm`` then
    runs in its row pass, or, for the two prenorm kernels, in their
    epilogue).

    x2 is [M, K_stored] contiguous, or under ``activation_bits`` [M, K]
    contiguous (the row pass appends the K padding to the int8 planes).
    The s21 and nq42 kernels walk the rows of one slab (``qw`` rows / 3):
    the K/8 B rows, or the K/4 quad rows.  ``stacked`` (operands of one
    layer of a stacked artifact) counts the launch in ``STACKED_LAUNCHES``
    too.
    """
    names = (_KERNELS if fmt is None else _LUT_KERNELS)[bits]
    if activation_bits is not None:
        name = names[2 + ACTIVATION_BITS.index(activation_bits)]
    else:
        name = names[1] if pre_norm is not None and names[1] is not None else names[0]
    _check(name is not None, f"no {bits}-bit kernel for activation_bits={activation_bits}")
    _check(zeros is not None or fmt is not None, "an affine artifact needs zeros")
    dev = x2.device
    m = x2.shape[0]
    kp, n = qw.shape
    slabs = {3: 8, 6: 4}.get(bits)
    if slabs:  # s21: stored rows 2Kb..3Kb are the B rows; nq42: 2Kq..3Kq the quad rows
        _check(kp % 3 == 0, f"a {bits}-bit artifact stores 3*K/{slabs} rows, not {kp}")
        kp //= 3
    # stored K: 2 columns a packed row (nib4), 8 a B row (s21), 4 a quad row
    # (nq42), 1 (byte)
    ks = x2.shape[1] if activation_bits is None else {4: 2, 3: 8, 6: 4}.get(bits, 1) * kp
    _check_operands(x2, qw, scales, zeros, rows)
    if activation_bits is not None:
        _check(x2.shape[1] == k_logical <= ks,
               f"x has {x2.shape[1]} columns, the artifact K={k_logical}")
    if bits == 4:
        g, rows, scales, zeros = _nib4_groups(ks, kp, rows, scales, zeros)
    elif slabs:
        g = _slab_groups(ks, kp, rows, slabs)
    else:
        g = _byte_groups(ks, kp, rows)
    mma = (activation_bits is None and name in BF16_MMA and x2.dtype == torch.bfloat16
           and _bf16_mma_fits(kp, g))
    _check(pre_norm is None or activation_bits is not None or names[1] is not None or mma,
           f"the {bits}-bit layout has no prenorm kernel: normalize x first")
    s2, s_rs, s_cs = _side_view(scales, rows)
    z2, z_rs, z_cs = _side_view(zeros, rows) if zeros is not None else (None, 0, 0)
    z_ptr = None if z2 is None else z2.data_ptr()
    out = torch.empty((m, n_out), dtype=x2.dtype, device=dev)
    if m == 0:
        return out
    planes = 2 if activation_bits is None else activation_bits // 8  # int8 x planes
    if name in SLAB_MMA or mma:
        kc, splits = plan_slab_splits(m, n, kp, (BF16_MMA if mma else SLAB_MMA)[name],
                                      _sm_count(dev), planes)
    else:
        kc, splits = plan_splits(m, n, kp, _sm_count(dev))
    # the prenorm kernel's route keeps its norm in the epilogue: with a
    # K-split the splits' sums of x^2 [splits, M] follow the partials
    epi_norm = mma and pre_norm is not None and name == names[1]
    ws = torch.empty((splits * m * n + (splits * m if epi_norm else 0),), dtype=torch.float32,
                     device=dev)
    x_bf16 = int(x2.dtype == torch.bfloat16)
    eps = 0.0 if pre_norm is None else float(pre_norm)
    if mma:
        x_copy = x_needs_copy(x2, kp)
        row_norm = pre_norm is not None and not epi_norm
        xs = (torch.empty((bf16_mma_scratch_bytes(m, kp, BF16_MMA[name]),), dtype=torch.uint8,
                          device=dev) if x_copy or row_norm else None)
        exp_bits, mant_bits = (0, 0) if fmt is None else (fmt.exp_bits, fmt.mant_bits)
        lib, fn = _load_fn(name, f"iwoq_{name}_mma", _ARGTYPES_BF16_MMA)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2.data_ptr(), ks, int(x_copy), k_logical, int(pre_norm is not None), eps,
                     qw.data_ptr(), s2.data_ptr(), s_rs, s_cs, z_ptr, z_rs, z_cs,
                     None if xs is None else xs.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     m, n, n_out, kp, g, kc, splits, exp_bits, mant_bits, stream)
    elif activation_bits is None and fmt is not None:
        lib, fn = _load_fn(name, f"iwoq_{name}", _ARGTYPES_LUT)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2.data_ptr(), x_bf16, ks, qw.data_ptr(), s2.data_ptr(), s_rs,
                     s_cs, z_ptr, z_rs, z_cs, ws.data_ptr(), out.data_ptr(),
                     m, n, n_out, kp, g, kc, splits, fmt.exp_bits, fmt.mant_bits, stream)
    elif activation_bits is None:
        rnorm = None if pre_norm is None else \
            torch.empty((m,), dtype=torch.float32, device=dev)
        lib, fn = _load_fn(name, f"iwoq_{name}", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2.data_ptr(), x_bf16, ks, qw.data_ptr(), s2.data_ptr(), s_rs,
                     s_cs, z_ptr, z_rs, z_cs, ws.data_ptr(),
                     None if rnorm is None else rnorm.data_ptr(), out.data_ptr(),
                     m, n, n_out, kp, g, kc, splits, k_logical, eps, stream)
    else:
        # the planes padded per slab, then the group sums
        nbytes = slab_scratch_bytes(m, kp, SLAB_MMA[name], g, zeros is not None, planes)
        xq = torch.empty((nbytes,), dtype=torch.int8, device=dev)
        sx = torch.empty((m,), dtype=torch.float32, device=dev)
        args = (x2.data_ptr(), x_bf16, k_logical, int(pre_norm is not None), eps,
                qw.data_ptr(), s2.data_ptr(), s_rs, s_cs, z_ptr, z_rs, z_cs,
                xq.data_ptr(), sx.data_ptr(), ws.data_ptr(), out.data_ptr(),
                m, n, n_out, kp, g, kc, splits)
        if fmt is None:
            lib, fn = _load_fn(name, f"iwoq_{name}", _ARGTYPES_A)
        else:
            lib, fn = _load_fn(name, f"iwoq_{name}", _ARGTYPES_A_LUT)
            args += (fmt.exp_bits, fmt.mant_bits)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*args, stream)
    _raise_if(err, lib, name)
    LAUNCHES[name] += 1
    if stacked:
        STACKED_LAUNCHES[name] += 1
    return out


def quantize_activations_slab_kernel(x2: torch.Tensor, slabs: int, kb: int, g: int,
                                     pre_norm: Optional[float] = None, bits: int = 16
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slab kernels' row pass alone, on the card: ``(planes [P, M,
    slabs*kb] int8, sx [M] f32, sums [M, slabs*kb/g] int32)`` for ``x2``
    ``[M, K]``, K <= slabs*kb (``pre_norm`` normalizes each row first), P =
    2 for ``bits`` 16 and 1 for 8.  The pass writes each slab padded to a
    multiple of 32 rows; the planes come back in K order.  It is part of
    every launch of a :data:`SLAB_MMA` kernel (``slabs`` 1, 2, 4 or 8); this
    entry point exists to hold its codes and sums against
    :func:`quantize_activations` and :func:`activation_group_sums` and is
    not counted."""
    _check(x2.is_cuda and x2.dim() == 2 and x2.is_contiguous()
           and x2.dtype in (torch.bfloat16, torch.float32),
           "x must be a contiguous 2-D bf16/f32 CUDA tensor")
    m, k = x2.shape
    _check(slabs in (1, 2, 4, 8) and 0 < k <= slabs * kb and m > 0 and g > 0 and kb % g == 0
           and bits in ACTIVATION_BITS, f"slabs={slabs}, Kb={kb}, G={g}, K={k}, M={m}, "
           f"bits={bits}")
    dev = x2.device
    kb32 = math.ceil(kb / SLAB_WINDOW) * SLAB_WINDOW
    planes = bits // 8
    xq = torch.empty((planes, m, slabs, kb32), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    sums = torch.empty((m, slabs * (kb // g)), dtype=torch.int32, device=dev)
    lib, fn = _load_fn(W3A16, "iwoq_quantize_rows_slab", _ARGTYPES_ROWS_SLAB)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), k, slabs, kb, g, bits,
                 int(pre_norm is not None), 0.0 if pre_norm is None else float(pre_norm),
                 xq.data_ptr(), sx.data_ptr(), sums.data_ptr(), m, stream)
    _raise_if(err, lib, "iwoq_quantize_rows_slab")
    if xq[..., kb:].any():
        raise RuntimeError("the slab row pass wrote codes beyond a slab's end")
    return xq[..., :kb].reshape(planes, m, slabs * kb), sx, sums


def _prep_x(x: torch.Tensor, qt: QuantizedTensor,
            activation_bits: Optional[int] = None) -> torch.Tensor:
    k = qt.shape[0]
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the artifact K={k}")
    x2 = x.reshape(-1, k)
    if qt.k_pad and activation_bits is None:
        # stored K carries whole zero groups; zero x columns meet them (the
        # int-activation row pass pads its planes after quantizing instead)
        x2 = torch.nn.functional.pad(x2, (0, qt.k_pad))
    return x2.contiguous()


def _unsupported(qt: QuantizedTensor,
                 activation_bits: Optional[int] = None) -> NotImplementedError:
    what = "" if activation_bits is None else f" with activation_bits={activation_bits}"
    return NotImplementedError(
        f"no CUDA kernel for this artifact{what} (mode={qt.mode}, "
        f"{packed_bits(qt)}-bit storage, K={qt.k_stored}, side rows "
        f"{qt.scales.shape[-2]}, k_shards={qt.k_shards}, side dtype "
        f"{qt.scales.dtype}); the kernels take affine nib4 (int4, bfp4), byte "
        "(int8, bfp8) and s21 (3-bit) artifacts with zeros, bf16/f32 activations "
        "or activation_bits 8/16 (group size a multiple of 4), and exact-minifloat "
        "LUT nib4 (fp4), nq42 (fp6) and byte (fp8) artifacts with bf16/f32 "
        "activations or A16 (fp4 E2M1/E1M2, fp6 E2M3), N a multiple of 4")


def route_matmul(x: torch.Tensor, qt: QuantizedTensor,
                 pre_norm: Optional[float] = None,
                 layer: Optional[int] = None) -> torch.Tensor:
    """What the JAX package computes on its XLA path for an artifact of
    :func:`xla_route`, on any device: ``pre_norm`` normalizes x first (cast
    back to x's type), then ``x @ dequantize_weight(qt)`` in f32, returned
    in f32 (the caller adds a bias and casts); activation bits do not
    apply.  ``layer`` selects one layer of a stacked artifact.  Counted in
    ``ROUTE_CALLS``."""
    ROUTE_CALLS[ROUTE] += 1
    qt = qt if layer is None else index_stacked(qt, layer)
    if pre_norm is not None:
        x = _rms_nogamma(x, pre_norm)
    return torch.matmul(x.to(torch.float32), dequantize_weight(qt))


def _lut_format(qt: QuantizedTensor):
    """The minifloat format a LUT kernel decodes (None: affine)."""
    return qt.spec.float_format if qt.mode == "lut" else None


def fused_quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                           pre_norm: Optional[float] = None,
                           activation_bits: Optional[int] = None) -> torch.Tensor:
    """``y = x @ dequant(qt)`` for ``x`` ``[..., K]``, output in ``x.dtype``.

    ``pre_norm`` (the RMS eps) applies the weightless RMSNorm in the
    kernel's epilogue (affine nib4, byte) or to x before the product (s21,
    LUT, as the JAX package does: in torch, but in the kernel's row pass on
    the bf16 route, :func:`bf16_mma_route`); the norm's gamma must
    already be folded into the weights (``models.llama.fold_llama_norms``).
    ``activation_bits`` 8 or 16 quantizes x per row first and runs the
    int-activation kernel; a ``pre_norm`` then normalizes x before it is
    quantized.  An artifact of :func:`xla_route` takes :func:`route_matmul`.
    """
    if xla_route(qt):
        return route_matmul(x, qt, pre_norm).to(x.dtype)
    activation_bits = _effective_activation_bits(qt, activation_bits, warn=True)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, qt, pre_norm, activation_bits=activation_bits)
    if not x.is_cuda:
        raise NotImplementedError(f"no dequant-matmul for device {x.device}")
    if not kernel_supported(qt, activation_bits):
        raise _unsupported(qt, activation_bits)
    if pre_norm is not None and activation_bits is None and not prenorm_supported(qt) \
            and not bf16_mma_route(qt, x.dtype, pre_norm):
        x, pre_norm = _rms_nogamma(x, pre_norm), None
    out = _launch(packed_bits(qt), pre_norm, _prep_x(x, qt, activation_bits),
                  qt.qweight, qt.scales, qt.zeros, qt.scales.shape[0], qt.shape[0],
                  qt.shape[1], activation_bits, _lut_format(qt))
    return out.reshape(x.shape[:-1] + (qt.shape[1],))


def fused_quantized_matmul_stacked(x: torch.Tensor, qt: QuantizedTensor,
                                   layer_idx,
                                   pre_norm: Optional[float] = None,
                                   activation_bits: Optional[int] = None) -> torch.Tensor:
    """``y = x @ dequant(qt[layer_idx])`` for a layer-stacked artifact.

    The kernel reads the layer's weights and side info in place: the
    wrapper passes ``qweight[layer]`` and ``scales[layer]`` views, so no
    layer copy is made and ``side_pad`` rows are simply never read.
    """
    layer = int(layer_idx)
    if xla_route(qt):
        return route_matmul(x, qt, pre_norm, layer=layer).to(x.dtype)
    activation_bits = _effective_activation_bits(qt, activation_bits, warn=True)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, qt, pre_norm, layer=layer,
                                    activation_bits=activation_bits)
    if not x.is_cuda:
        raise NotImplementedError(f"no dequant-matmul for device {x.device}")
    if not kernel_supported_stacked(qt, activation_bits):
        raise _unsupported(qt, activation_bits)
    if not 0 <= layer < qt.qweight.shape[0]:
        raise IndexError(f"layer {layer} of a {qt.qweight.shape[0]}-layer artifact")
    if pre_norm is not None and activation_bits is None and not prenorm_supported(qt) \
            and not bf16_mma_route(qt, x.dtype, pre_norm):
        x, pre_norm = _rms_nogamma(x, pre_norm), None
    rows = qt.scales.shape[1] - qt.side_pad
    out = _launch(packed_bits(qt), pre_norm, _prep_x(x, qt, activation_bits),
                  qt.qweight[layer], qt.scales[layer],
                  None if qt.zeros is None else qt.zeros[layer], rows,
                  qt.shape[0], qt.shape[1], activation_bits, _lut_format(qt), stacked=True)
    return out.reshape(x.shape[:-1] + (qt.shape[1],))
