"""Dequant-matmul: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``ops/pallas/dequant_matmul.py`` in the JAX package.  Four
hand-written CUDA kernels compute ``y = x @ dequant(qt)`` for affine
artifacts with f32 side info, two per storage layout, the second of each
pair with the weightless RMSNorm ``r = rsqrt(mean(x^2) + eps)`` applied to
the f32 sum:

  nib4 (int4):  ``csrc/w4_matmul.cu``, ``csrc/w4_matmul_prenorm.cu``
                (design notes in ``csrc/w4_common.cuh``);
  byte (int8):  ``csrc/w8_matmul.cu``, ``csrc/w8_matmul_prenorm.cu``
                (design notes in ``csrc/w8_common.cuh``).

The layer-stacked entry point reuses them with the layer as a pointer
offset.

Dispatch is by the activation's device: a CPU tensor takes the plain
PyTorch version (:func:`dequant_matmul_plain`), a CUDA tensor launches the
kernel or raises ``NotImplementedError`` for a layout no kernel takes yet.
Nothing falls back quietly.

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
from ..qmatmul import dequantize_weight, index_stacked, packed_bits

W4 = "w4_matmul"
W4_PRENORM = "w4_matmul_prenorm"
W8 = "w8_matmul"
W8_PRENORM = "w8_matmul_prenorm"
# packed storage bits -> (kernel, prenorm kernel)
_KERNELS = {4: (W4, W4_PRENORM), 8: (W8, W8_PRENORM)}
LAUNCHES: Dict[str, int] = {name: 0 for pair in _KERNELS.values() for name in pair}
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
_BLOCK_N, _TILE_M = 128, 8  # must match kBlockN / kTileM in w4_common.cuh
_MIN_ROWS_PER_SPLIT = 64
_BLOCKS_PER_SM = 3
_SM_COUNT: Dict[int, int] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def kernel_name(qt: QuantizedTensor, pre_norm: Optional[float] = None) -> Optional[str]:
    """The kernel that takes ``qt``'s storage layout (None: no kernel)."""
    pair = _KERNELS.get(packed_bits(qt)) if qt.mode == "affine" else None
    return None if pair is None else pair[pre_norm is not None]


def _layout_supported(qt: QuantizedTensor, rows: int) -> bool:
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
    z_rows = qt.zeros.shape[-2] - (qt.side_pad if qt.zeros.shape[-2] > 1 else 0)
    return z_rows in (1, rows)


def kernel_supported(qt: QuantizedTensor) -> bool:
    """Whether a CUDA kernel takes this flat (2-D) artifact."""
    return qt.qweight.dim() == 2 and _layout_supported(qt, qt.scales.shape[0])


def kernel_supported_stacked(qt: QuantizedTensor) -> bool:
    """Whether a CUDA kernel takes this layer-stacked ([L, ...]) artifact."""
    return qt.qweight.dim() == 3 and _layout_supported(
        qt, qt.scales.shape[1] - qt.side_pad)


# ---------------------------------------------------------------- plain

def dequant_matmul_plain(x: torch.Tensor, qt: QuantizedTensor,
                         pre_norm: Optional[float] = None,
                         layer: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels, for any packed layout.

    ``dequantize_weight`` in f32, an f32 matmul, then (``pre_norm``) the
    row factor ``rsqrt(mean(x^2) + eps)`` over the logical K applied to the
    f32 result, then a cast to ``x.dtype`` -- the order of the kernels'
    epilogue.  ``layer`` selects one layer of a stacked artifact.
    """
    name = kernel_name(qt, pre_norm)
    if name is not None:
        PLAIN_CALLS[name] += 1
    w = dequantize_weight(qt if layer is None else index_stacked(qt, layer))
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


def _launch(bits: int, pre_norm: Optional[float], x2: torch.Tensor,
            qw: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
            rows: int, k_logical: int, n_out: int) -> torch.Tensor:
    """Launch the ``bits``-storage kernel (its prenorm form if ``pre_norm``)
    on 2-D operands; x2 is [M, K_stored] contiguous."""
    from .build import load

    name = _KERNELS[bits][pre_norm is not None]
    dev = x2.device
    m, ks = x2.shape
    kp, n = qw.shape
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
    if bits == 4:
        g, rows, scales, zeros = _nib4_groups(ks, kp, rows, scales, zeros)
    else:
        g = _byte_groups(ks, kp, rows)
    s2, s_rs, s_cs = _side_view(scales, rows)
    z2, z_rs, z_cs = _side_view(zeros, rows)
    out = torch.empty((m, n_out), dtype=x2.dtype, device=dev)
    if m == 0:
        return out
    kc, splits = plan_splits(m, n, kp, _sm_count(dev))
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    rnorm = None if pre_norm is None else \
        torch.empty((m,), dtype=torch.float32, device=dev)
    lib = load(name)
    fn = getattr(lib, f"iwoq_{name}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), ks,
                 qw.data_ptr(), s2.data_ptr(), s_rs, s_cs, z2.data_ptr(),
                 z_rs, z_cs, ws.data_ptr(),
                 None if rnorm is None else rnorm.data_ptr(), out.data_ptr(),
                 m, n, n_out, kp, g, kc, splits, k_logical,
                 0.0 if pre_norm is None else float(pre_norm), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.iwoq_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return out


def _prep_x(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    k = qt.shape[0]
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the artifact K={k}")
    x2 = x.reshape(-1, k)
    if qt.k_pad:
        # stored K carries whole zero groups; zero x columns meet them
        x2 = torch.nn.functional.pad(x2, (0, qt.k_pad))
    return x2.contiguous()


def _unsupported(qt: QuantizedTensor) -> NotImplementedError:
    return NotImplementedError(
        f"no CUDA kernel yet for this artifact (mode={qt.mode}, "
        f"{packed_bits(qt)}-bit storage, k_shards={qt.k_shards}, side dtype "
        f"{qt.scales.dtype}); ported so far: affine nib4 (int4) and byte "
        "(int8) layouts with f32 side info and k_shards=1. See ROADMAP queue "
        "B for the kernels still to port")


def fused_quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                           pre_norm: Optional[float] = None) -> torch.Tensor:
    """``y = x @ dequant(qt)`` for ``x`` ``[..., K]``, output in ``x.dtype``.

    ``pre_norm`` (the RMS eps) applies the weightless RMSNorm in the
    kernel's epilogue; the norm's gamma must already be folded into the
    weights (``models.llama.fold_llama_norms``).
    """
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, qt, pre_norm)
    if not x.is_cuda:
        raise NotImplementedError(f"no dequant-matmul for device {x.device}")
    if not kernel_supported(qt):
        raise _unsupported(qt)
    out = _launch(packed_bits(qt), pre_norm, _prep_x(x, qt), qt.qweight, qt.scales,
                  qt.zeros, qt.scales.shape[0], qt.shape[0], qt.shape[1])
    return out.reshape(x.shape[:-1] + (qt.shape[1],))


def fused_quantized_matmul_stacked(x: torch.Tensor, qt: QuantizedTensor,
                                   layer_idx,
                                   pre_norm: Optional[float] = None) -> torch.Tensor:
    """``y = x @ dequant(qt[layer_idx])`` for a layer-stacked artifact.

    The kernel reads the layer's weights and side info in place: the
    wrapper passes ``qweight[layer]`` and ``scales[layer]`` views, so no
    layer copy is made and ``side_pad`` rows are simply never read.
    """
    layer = int(layer_idx)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, qt, pre_norm, layer=layer)
    if not x.is_cuda:
        raise NotImplementedError(f"no dequant-matmul for device {x.device}")
    if not kernel_supported_stacked(qt):
        raise _unsupported(qt)
    if not 0 <= layer < qt.qweight.shape[0]:
        raise IndexError(f"layer {layer} of a {qt.qweight.shape[0]}-layer artifact")
    rows = qt.scales.shape[1] - qt.side_pad
    out = _launch(packed_bits(qt), pre_norm, _prep_x(x, qt), qt.qweight[layer],
                  qt.scales[layer], qt.zeros[layer], rows, qt.shape[0], qt.shape[1])
    return out.reshape(x.shape[:-1] + (qt.shape[1],))
