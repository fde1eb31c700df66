"""Dequant-matmul: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``ops/pallas/dequant_matmul.py`` in the JAX package.  Eleven
hand-written CUDA kernels compute ``y = x @ dequant(qt)`` for affine
artifacts with f32 side info, per storage layout:

  nib4 (int4):  ``csrc/w4_matmul.cu``, ``csrc/w4_matmul_prenorm.cu``
                (design notes in ``csrc/w4_common.cuh``),
                ``csrc/w4a8_matmul.cu``, ``csrc/w4a16_matmul.cu``;
  byte (int8):  ``csrc/w8_matmul.cu``, ``csrc/w8_matmul_prenorm.cu``
                (design notes in ``csrc/w8_common.cuh``),
                ``csrc/w8a8_matmul.cu``, ``csrc/w8a16_matmul.cu``;
  s21 (3-bit):  ``csrc/w3_matmul.cu`` (design notes in
                ``csrc/w3_common.cuh``), ``csrc/w3a8_matmul.cu``,
                ``csrc/w3a16_matmul.cu``.

The ``w4``/``w8``/``w3`` kernels take bf16/f32 activations; the nib4 and
byte layouts also have a prenorm kernel, which applies the weightless
RMSNorm ``r = rsqrt(mean(x^2) + eps)`` to the f32 sum.  The s21 layout has
none, as in the JAX package (``prenorm_supported``): a ``pre_norm``
normalizes x first (:func:`_rms_nogamma`, cast back to x's type), then the
``w3`` kernel runs.  The ``a8``/``a16`` kernels (design notes in
``csrc/wa_common.cuh``) take ``activation_bits`` 8 or 16: a row pass
quantizes x to one int8 plane (A8, ``sx = absmax/127``) or two (A16, ``x ~=
sx*(256*hi + lo)``, ``sx = absmax/32512``), the product runs on integer
codes, and the f32 result is scaled by the row's ``sx``.  Under activation
bits a ``pre_norm`` is applied to x before quantizing (in the row pass), as
the JAX package does, so no prenorm kernel runs.  The layer-stacked entry
point reuses the kernels with the layer as a pointer offset.

Dispatch is by the activation's device: a CPU tensor takes the plain
PyTorch version (:func:`dequant_matmul_plain`), a CUDA tensor launches the
kernel or raises ``NotImplementedError`` for a layout no kernel takes yet.
Nothing falls back quietly.  The plain version computes what the kernel
computes, activation quantization included; this deliberately differs from
the JAX package's XLA fallback, which ignores activation bits: here the
CPU path stands in for the kernel.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of the plain
version, per name of the kernel it stands in for (a layout no kernel takes
is not counted); :func:`reset_counts` zeroes both.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ...quantize.qtensor import QuantizedTensor
from ..packing import unpack_codes_sharded
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
ACTIVATION_BITS = (8, 16)
# packed storage bits -> (kernel, prenorm kernel or None, A8 kernel, A16 kernel)
_KERNELS = {4: (W4, W4_PRENORM, W4A8, W4A16), 8: (W8, W8_PRENORM, W8A8, W8A16),
            3: (W3, None, W3A8, W3A16)}
LAUNCHES: Dict[str, int] = {name: 0 for names in _KERNELS.values() for name in names
                            if name is not None}
PLAIN_CALLS: Dict[str, int] = dict(LAUNCHES)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,   # x, x_bf16, ldx, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,              # ws, rnorm, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, stored rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # G, kc, splits
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p,                  # k_logical, eps, stream
]
_ARGTYPES_A = [  # the int-activation kernels (csrc/wa_common.cuh launch_wa)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # x, x_bf16, k_logical, norm
    ctypes.c_float, ctypes.c_void_p,                                # eps, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # xq, sx, ws, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, stored rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,      # G, kc, splits, stream
]
_ARGTYPES_ROWS = [  # iwoq_quantize_rows, the row pass alone
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # x, x_bf16, k_logical, k_stored
    ctypes.c_int, ctypes.c_int, ctypes.c_float,                     # bits, norm, eps
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # xq, sx, M, stream
]
_BLOCK_N, _TILE_M = 128, 8  # must match kBlockN / kTileM in w4_common.cuh
_MIN_ROWS_PER_SPLIT = 64
_BLOCKS_PER_SM = 3
_SM_COUNT: Dict[int, int] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _names(qt: QuantizedTensor):
    """The ``_KERNELS`` entry of ``qt``'s storage layout (None: no kernel)."""
    return _KERNELS.get(packed_bits(qt)) if qt.mode == "affine" else None


def kernel_name(qt: QuantizedTensor, pre_norm: Optional[float] = None,
                activation_bits: Optional[int] = None) -> Optional[str]:
    """The kernel that takes ``qt``'s storage layout (None: no kernel).

    Under ``activation_bits`` (8 or 16) the int-activation kernel of the
    layout runs and ``pre_norm`` does not pick a kernel: the norm is
    applied to x before quantizing.  A layout without a prenorm kernel
    (s21) names its flat kernel for a ``pre_norm`` too: x is normalized
    before it runs.
    """
    names = _names(qt)
    if names is None:
        return None
    if activation_bits is not None:
        return names[2 + ACTIVATION_BITS.index(activation_bits)]
    return names[1] if pre_norm is not None and names[1] else names[0]


def prenorm_supported(qt: QuantizedTensor) -> bool:
    """Whether a kernel applies ``pre_norm`` in its epilogue for this
    artifact (the nib4 and byte layouts, as ``prenorm_supported`` of the JAX
    package); elsewhere x is normalized first."""
    names = _names(qt)
    return names is not None and names[1] is not None


def a16_supported(qt: QuantizedTensor) -> bool:
    """Whether the split-plane A16 activation path exists for this artifact's
    format: every affine artifact.  The LUT formats' A16 decode (queue B
    rows 13 and 16 of ``ROADMAP.md``) is not ported."""
    return qt.mode == "affine"


def _group_size(qt: QuantizedTensor, rows: int) -> int:
    """K columns per side row as the kernel walks them (nib4: a group never
    straddles the two K halves; ``_nib4_groups`` splits those that do; s21:
    one side row spans the K/8 rows of a slab or divides them)."""
    ks, bits = qt.k_stored, packed_bits(qt)
    if bits not in (3, 4):
        return ks // rows
    kp = ks // 2 if bits == 4 else ks // 8
    return kp if rows == 1 else math.gcd(ks // rows, kp)


def _layout_supported(qt: QuantizedTensor, rows: int,
                      activation_bits: Optional[int] = None) -> bool:
    if kernel_name(qt) is None or qt.k_shards != 1:
        return False
    if qt.zeros is None:
        return False
    if qt.scales.dtype != torch.float32 or qt.zeros.dtype != torch.float32:
        return False  # 16-bit side info: no kernel yet
    ks, n = qt.k_stored, qt.n + qt.n_pad
    if n % 4 or rows < 1 or ks % rows:
        return False
    if packed_bits(qt) == 4 and ks % 2:
        return False
    if packed_bits(qt) == 3 and (ks % 8 or (rows > 1 and (ks // 8) % (ks // rows))):
        return False  # a group must not straddle two K slabs (as _layout3_supported)
    if activation_bits is not None and (activation_bits not in ACTIVATION_BITS
                                        or _group_size(qt, rows) % 4):
        return False  # __dp4a takes K four at a time (the group divides K)
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


def _side_rows(qt: QuantizedTensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (scales, zeros) ``[R, N_stored]`` of a flat artifact, side_pad
    rows dropped, per-channel/per-tensor rows broadcast."""
    s, z = qt.scales, qt.zeros
    rows = s.shape[0] - qt.side_pad
    s = s[:rows].to(torch.float32)
    z = (z[:rows] if z.shape[0] > 1 else z).to(torch.float32)
    n = qt.qweight.shape[-1]
    return s.expand(rows, n), z.expand(rows, n)


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

    Without ``activation_bits``: ``dequantize_weight`` in f32, an f32
    matmul, then a cast to ``x.dtype``.  A ``pre_norm`` on a layout with a
    prenorm kernel (nib4, byte) applies the row factor ``rsqrt(mean(x^2) +
    eps)`` over the logical K to the f32 result before the cast -- the
    order of that kernel's epilogue; on any other layout (s21, and those
    without a kernel) it normalizes x first (:func:`_rms_nogamma`, cast
    back to ``x.dtype``), as the JAX package does where no prenorm kernel
    exists (``fused_quantized_matmul``'s fallback and the XLA path).  With
    ``activation_bits`` (affine artifacts): ``pre_norm`` normalizes x first,
    then :func:`quantize_activations`, K padding, and
    :func:`int_matmul_plain`.  ``layer`` selects one layer of a stacked
    artifact.
    """
    name = kernel_name(qt, pre_norm, activation_bits)
    if name is not None:
        PLAIN_CALLS[name] += 1
    qt = qt if layer is None else index_stacked(qt, layer)
    if pre_norm is not None and (activation_bits is not None
                                 or not prenorm_supported(qt)):
        x = _rms_nogamma(x, pre_norm)
        pre_norm = None
    if activation_bits is not None:
        planes, sx = quantize_activations(x.reshape(-1, qt.shape[0]), activation_bits)
        if qt.k_pad:
            planes = torch.nn.functional.pad(planes, (0, qt.k_pad))
        y = int_matmul_plain(planes, sx, qt, x.dtype)
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
                 zeros: torch.Tensor):
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
        if zeros.shape[0] > 1:
            zeros = zeros[:rows].repeat_interleave(f, dim=0)
        rows, g = rows * f, g // f
    return g, rows, scales, zeros


def _byte_groups(ks: int, kp: int, rows: int) -> int:
    """Group size for the byte layout: one stored row per K column."""
    _check(ks == kp, f"x has {ks} columns, the byte artifact stores {kp}")
    _check(ks % rows == 0, f"{rows} side rows do not divide K={ks}")
    return ks // rows


def _s21_groups(ks: int, kb: int, rows: int) -> int:
    """Group size for the s21 layout, in B rows: B row r of slab i holds K
    column i*Kb + r, so the kernel needs G | Kb (per-channel: G = Kb)."""
    _check(ks == 8 * kb, f"x has {ks} columns, the s21 artifact stores {8 * kb}")
    _check(ks % rows == 0, f"{rows} side rows do not divide K={ks}")
    g = kb if rows == 1 else ks // rows
    _check(kb % g == 0, f"group {g} straddles the K/8 = {kb} slabs of the s21 layout")
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


def _launch(bits: int, pre_norm: Optional[float], x2: torch.Tensor,
            qw: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
            rows: int, k_logical: int, n_out: int,
            activation_bits: Optional[int] = None) -> torch.Tensor:
    """Launch the ``bits``-storage kernel on 2-D operands: its prenorm form
    if ``pre_norm`` (nib4, byte), its int-activation form if
    ``activation_bits``.

    x2 is [M, K_stored] contiguous, or under ``activation_bits`` [M, K]
    contiguous (the row pass appends the K padding to the int8 planes).
    """
    names = _KERNELS[bits]
    _check(pre_norm is None or activation_bits is not None or names[1] is not None,
           f"the {bits}-bit layout has no prenorm kernel: normalize x first")
    name = (names[pre_norm is not None] if activation_bits is None
            else names[2 + ACTIVATION_BITS.index(activation_bits)])
    dev = x2.device
    m = x2.shape[0]
    kp, n = qw.shape
    if bits == 3:  # the kernel walks the B rows (stored rows 2Kb..3Kb)
        _check(kp % 3 == 0, f"an s21 artifact stores 3*K/8 rows, not {kp}")
        kp //= 3
    # stored K: 2 columns a packed row (nib4), 8 a B row (s21), 1 (byte)
    ks = x2.shape[1] if activation_bits is None else {4: 2, 3: 8}.get(bits, 1) * kp
    _check(x2.dtype in (torch.bfloat16, torch.float32),
           f"x dtype {x2.dtype} is not bfloat16 or float32")
    for name_, t in (("qweight", qw), ("scales", scales), ("zeros", zeros)):
        _check(t.device == dev, f"{name_} is on {t.device}, x on {dev}")
    for name_, t in (("scales", scales), ("zeros", zeros)):
        _check(t.dim() == 2 and t.dtype == torch.float32
               and t.shape[1] in (1, n) and (t.shape[0] == 1 or t.shape[0] >= rows),
               f"{name_} {tuple(t.shape)} {t.dtype} is not f32 [1|{rows}+, 1|{n}]")
    _check(qw.dtype == torch.uint8 and qw.is_contiguous()
           and qw.data_ptr() % 4 == 0, "qweight must be contiguous uint8")
    _check(x2.is_contiguous(), "x must be contiguous")
    if activation_bits is not None:
        _check(x2.shape[1] == k_logical <= ks,
               f"x has {x2.shape[1]} columns, the artifact K={k_logical}")
    if bits == 4:
        g, rows, scales, zeros = _nib4_groups(ks, kp, rows, scales, zeros)
    elif bits == 3:
        g = _s21_groups(ks, kp, rows)
    else:
        g = _byte_groups(ks, kp, rows)
    s2, s_rs, s_cs = _side_view(scales, rows)
    z2, z_rs, z_cs = _side_view(zeros, rows)
    out = torch.empty((m, n_out), dtype=x2.dtype, device=dev)
    if m == 0:
        return out
    kc, splits = plan_splits(m, n, kp, _sm_count(dev))
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    x_bf16 = int(x2.dtype == torch.bfloat16)
    eps = 0.0 if pre_norm is None else float(pre_norm)
    if activation_bits is None:
        rnorm = None if pre_norm is None else \
            torch.empty((m,), dtype=torch.float32, device=dev)
        lib, fn = _load_fn(name, f"iwoq_{name}", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2.data_ptr(), x_bf16, ks, qw.data_ptr(), s2.data_ptr(), s_rs,
                     s_cs, z2.data_ptr(), z_rs, z_cs, ws.data_ptr(),
                     None if rnorm is None else rnorm.data_ptr(), out.data_ptr(),
                     m, n, n_out, kp, g, kc, splits, k_logical, eps, stream)
    else:
        planes = 1 if activation_bits == 8 else 2
        xq = torch.empty((planes, m, ks), dtype=torch.int8, device=dev)
        sx = torch.empty((m,), dtype=torch.float32, device=dev)
        lib, fn = _load_fn(name, f"iwoq_{name}", _ARGTYPES_A)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2.data_ptr(), x_bf16, k_logical, int(pre_norm is not None), eps,
                     qw.data_ptr(), s2.data_ptr(), s_rs, s_cs, z2.data_ptr(), z_rs,
                     z_cs, xq.data_ptr(), sx.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), m, n, n_out, kp, g, kc, splits, stream)
    _raise_if(err, lib, name)
    LAUNCHES[name] += 1
    return out


def quantize_activations_kernel(x2: torch.Tensor, bits: int, k_stored: int,
                                pre_norm: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int-activation kernels' row pass alone, on the card: ``(planes
    [P, M, k_stored] int8, sx [M] f32)`` for ``x2`` ``[M, K]`` (``pre_norm``
    normalizes each row first).  It is part of every ``a8``/``a16`` launch;
    this entry point exists to hold its codes against
    :func:`quantize_activations` and is not counted."""
    _check(x2.is_cuda and x2.dim() == 2 and x2.is_contiguous()
           and x2.dtype in (torch.bfloat16, torch.float32),
           "x must be a contiguous 2-D bf16/f32 CUDA tensor")
    m, k = x2.shape
    _check(bits in ACTIVATION_BITS and k <= k_stored and m > 0,
           f"bits={bits}, K={k}, k_stored={k_stored}, M={m}")
    dev = x2.device
    xq = torch.empty((1 if bits == 8 else 2, m, k_stored), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    name = W4A8 if bits == 8 else W4A16  # every int-activation library has the pass
    lib, fn = _load_fn(name, "iwoq_quantize_rows", _ARGTYPES_ROWS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), k, k_stored, bits,
                 int(pre_norm is not None), 0.0 if pre_norm is None else float(pre_norm),
                 xq.data_ptr(), sx.data_ptr(), m, stream)
    _raise_if(err, lib, "iwoq_quantize_rows")
    return xq, sx


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
        f"no CUDA kernel yet for this artifact{what} (mode={qt.mode}, "
        f"{packed_bits(qt)}-bit storage, K={qt.k_stored}, side rows "
        f"{qt.scales.shape[-2]}, k_shards={qt.k_shards}, side dtype "
        f"{qt.scales.dtype}); ported so far: affine nib4 (int4), byte (int8) "
        "and s21 (3-bit, groups that do not straddle the K/8 slabs) layouts "
        "with f32 side info and k_shards=1, with bf16/f32 activations or "
        "activation_bits 8/16 (group size a multiple of 4). See ROADMAP "
        "queue B for the kernels still to port")


def _check_activation_bits(qt: QuantizedTensor, activation_bits: Optional[int]) -> None:
    if activation_bits is None:
        return
    if activation_bits not in ACTIVATION_BITS:
        raise NotImplementedError(
            f"activation_bits={activation_bits}: must be None, 8 or 16")
    if not a16_supported(qt):
        raise NotImplementedError(
            f"activation_bits={activation_bits} with a {qt.mode} artifact: the "
            "LUT formats' codecs and kernels are not ported yet (ROADMAP queue "
            "A, 'Format zoo', and queue B rows 12-16)")


def fused_quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                           pre_norm: Optional[float] = None,
                           activation_bits: Optional[int] = None) -> torch.Tensor:
    """``y = x @ dequant(qt)`` for ``x`` ``[..., K]``, output in ``x.dtype``.

    ``pre_norm`` (the RMS eps) applies the weightless RMSNorm in the
    kernel's epilogue (nib4, byte) or to x before the kernel (s21, as the
    JAX package does); the norm's gamma must already be folded into the
    weights (``models.llama.fold_llama_norms``).  ``activation_bits`` 8 or
    16 quantizes x per row first and runs the int-activation kernel; a
    ``pre_norm`` then normalizes x before it is quantized.
    """
    _check_activation_bits(qt, activation_bits)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, qt, pre_norm, activation_bits=activation_bits)
    if not x.is_cuda:
        raise NotImplementedError(f"no dequant-matmul for device {x.device}")
    if not kernel_supported(qt, activation_bits):
        raise _unsupported(qt, activation_bits)
    if pre_norm is not None and activation_bits is None and not prenorm_supported(qt):
        x, pre_norm = _rms_nogamma(x, pre_norm), None
    out = _launch(packed_bits(qt), pre_norm, _prep_x(x, qt, activation_bits),
                  qt.qweight, qt.scales, qt.zeros, qt.scales.shape[0], qt.shape[0],
                  qt.shape[1], activation_bits)
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
    _check_activation_bits(qt, activation_bits)
    layer = int(layer_idx)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, qt, pre_norm, layer=layer,
                                    activation_bits=activation_bits)
    if not x.is_cuda:
        raise NotImplementedError(f"no dequant-matmul for device {x.device}")
    if not kernel_supported_stacked(qt, activation_bits):
        raise _unsupported(qt, activation_bits)
    if not 0 <= layer < qt.qweight.shape[0]:
        raise IndexError(f"layer {layer} of a {qt.qweight.shape[0]}-layer artifact")
    if pre_norm is not None and activation_bits is None and not prenorm_supported(qt):
        x, pre_norm = _rms_nogamma(x, pre_norm), None
    rows = qt.scales.shape[1] - qt.side_pad
    out = _launch(packed_bits(qt), pre_norm, _prep_x(x, qt, activation_bits),
                  qt.qweight[layer], qt.scales[layer], qt.zeros[layer], rows,
                  qt.shape[0], qt.shape[1], activation_bits)
    return out.reshape(x.shape[:-1] + (qt.shape[1],))
