"""W4 inner-loop probe kernels: the factored group form with two decodes.

Counterpart of ``_kernel_variant`` in the JAX package's
``scripts/probe_w4_inner.py`` (modes ``f32`` and ``magic``), which no
serving path runs: the probe entry point
(``iron_weight_only_quant_tpu_torch.probes.probe_w4_inner``) times it
beside ``w4_matmul``.  :func:`w4_inner_matmul` computes ``y = x @
dequant(qt)`` for the artifacts ``w4_matmul`` takes on the card (affine
nib4, f32 scales and zeros), output in ``x.dtype``, without dequantizing a
weight: per group segment ``acc += (x_g . v_g) * s * mult - sum(x_g) * s
* (z - zshift)``, in f32, where ``v`` is the decoded stored value.

``f32``: ``v`` is the low code (mult 1, zshift 0) or the high nibble's
signed view ``16 * (code - 8)`` (mult 1/16, zshift 8), each by an int ->
float convert.  ``magic``: ``v = 128 + code`` for both halves, decoded by
the bf16 bias trick (mult 1, zshift -128).  The kernels are in
``csrc/w4_inner_matmul.cu`` (design notes there), with two routes per mode,
as ``w4_matmul``'s: bf16 x whose shape meets the bf16 family's rule
(``dequant_matmul.bf16_mma_route``) runs on the tensor cores
(``dequant_matmul.W4_INNER_MMA``: magic on bf16 products, f32 on TF32
ones, in ``csrc/wa_slab_mma.cuh``); f32 x, for which TF32 would not be
exact, and shapes off that rule run the CUDA-core kernel.
:func:`w4_inner_plain` is their plain PyTorch version, which a CPU tensor
takes.  Launches count in ``dequant_matmul.LAUNCHES`` and plain calls in
``PLAIN_CALLS``, under ``w4_inner_f32`` and ``w4_inner_magic``, one name
for both routes.
"""

from __future__ import annotations

import ctypes

import torch

from ...quantize.qtensor import QuantizedTensor
from . import dequant_matmul as dm

MODES = ("f32", "magic")
SOURCE = "w4_inner_matmul"
_NAMES = {"f32": dm.W4_INNER_F32, "magic": dm.W4_INNER_MAGIC}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,   # x, x_bf16, ldx, qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p,                               # ws, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, Kp
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # G, kc, splits
    ctypes.c_int, ctypes.c_void_p,                                  # magic, stream
]
_ARGTYPES_MMA = [  # iwoq_w4_inner_matmul_mma, the tensor-core route
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # x, ldx, x_copy, k_logical
    ctypes.c_void_p,                                                # qw
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # s, s_rs, s_cs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,          # z, z_rs, z_cs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,              # xs or NULL, ws, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # M, N, n_out, Kp
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # G, kc, splits
    ctypes.c_int, ctypes.c_void_p,                                  # magic, stream
]


def _checked(x: torch.Tensor, qt: QuantizedTensor, mode: str) -> str:
    """The counter name of ``mode``; raises for an artifact ``w4_matmul``
    does not take on the card, or an x that is not bf16/f32."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: must be one of {MODES}")
    if not (dm.kernel_supported(qt) and dm.kernel_name(qt) == dm.W4):
        raise dm._unsupported(qt)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype} is not bfloat16 or float32")
    return _NAMES[mode]


def w4_inner_plain(x: torch.Tensor, qt: QuantizedTensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of ``w4_inner_matmul`` in ``mode``: the same
    factored arithmetic, in f32, group after group of each K half (a
    per-channel artifact's group is the whole half), the ``n_pad`` columns
    dropped, cast to ``x.dtype``.  ``x`` is ``[..., K]``."""
    name = _checked(x, qt, mode)
    dm.PLAIN_CALLS[name] += 1
    x2 = dm._prep_x(x, qt).to(torch.float32)
    qw = qt.qweight.to(torch.int32)
    kp = qw.shape[0]
    lo, hi = qw & 0xF, (qw >> 4) ^ 8  # the codes of K rows kp and kp + Kp
    if mode == "f32":  # (stored value, mult, zshift) per half
        halves = ((lo, 1.0, 0.0), (16 * (hi - 8), 1.0 / 16.0, 8.0))
    else:
        halves = ((lo + 128, 1.0, -128.0), (hi + 128, 1.0, -128.0))
    s, z = dm._side_rows(qt)
    g, rows, s, z = dm._nib4_groups(qt.k_stored, kp, s.shape[0], s, z)
    acc = torch.zeros((x2.shape[0], qw.shape[1]), dtype=torch.float32, device=x.device)
    for h, (v, mult, zshift) in enumerate(halves):
        v = v.to(torch.float32)
        for r0 in range(h * kp, (h + 1) * kp, g):
            xg = x2[:, r0:r0 + g]
            sr, zr = (s[r0 // g], z[r0 // g]) if rows > 1 else (s[0], z[0])
            acc = acc + (xg @ v[r0 - h * kp:r0 - h * kp + g]) * (sr * mult) \
                - xg.sum(dim=1, keepdim=True) * (sr * (zr - zshift))
    return acc.to(x.dtype)[:, :qt.n].reshape(x.shape[:-1] + (qt.n,))


def w4_inner_matmul(x: torch.Tensor, qt: QuantizedTensor, mode: str) -> torch.Tensor:
    """``y = x @ dequant(qt)`` for ``x`` ``[..., K]`` by the factored group
    form in ``mode`` (``"f32"`` or ``"magic"``), output in ``x.dtype``.  A
    CPU tensor takes :func:`w4_inner_plain`; a CUDA tensor launches
    ``csrc/w4_inner_matmul.cu``: bf16 x on the rule of
    ``dequant_matmul.bf16_mma_route`` its tensor-core route, anything else
    its CUDA-core kernel.  Raises for any artifact ``w4_matmul`` does not
    take on the card."""
    _checked(x, qt, mode)
    if x.device.type == "cpu":
        return w4_inner_plain(x, qt, mode)
    if not x.is_cuda:
        raise NotImplementedError(f"no W4 inner-loop kernel for device {x.device}")
    return _launch(dm._prep_x(x, qt), qt, mode).reshape(x.shape[:-1] + (qt.n,))


def _launch(x2: torch.Tensor, qt: QuantizedTensor, mode: str) -> torch.Tensor:
    """One launch of ``mode``'s kernel on ``x2`` ``[M, K_stored]``: the
    tensor-core route for bf16 x whose slab rows and group meet
    ``dequant_matmul._bf16_mma_fits``, else the CUDA-core kernel (an
    explicit rule, never a fallback); ``[M, n]`` in ``x2.dtype``."""
    name = _NAMES[mode]
    qw = qt.qweight
    kp, n = qw.shape
    rows = qt.scales.shape[0]
    dm._check_operands(x2, qw, qt.scales, qt.zeros, rows)
    g, rows, scales, zeros = dm._nib4_groups(x2.shape[1], kp, rows, qt.scales, qt.zeros)
    s2, s_rs, s_cs = dm._side_view(scales, rows)
    z2, z_rs, z_cs = dm._side_view(zeros, rows)
    dev = x2.device
    m = x2.shape[0]
    out = torch.empty((m, qt.n), dtype=x2.dtype, device=dev)
    if not m:
        return out
    mma = x2.dtype == torch.bfloat16 and dm._bf16_mma_fits(kp, g)
    if mma:
        layout = dm.W4_INNER_MMA[name]
        kc, splits = dm.plan_slab_splits(m, n, kp, layout, dm._sm_count(dev))
        x_copy = dm.x_needs_copy(x2, kp)
        xs = (torch.empty((dm.bf16_mma_scratch_bytes(m, kp, layout),), dtype=torch.uint8,
                          device=dev) if x_copy else None)
        lib, fn = dm._load_fn(SOURCE, f"iwoq_{SOURCE}_mma", _ARGTYPES_MMA)
    else:
        kc, splits = dm.plan_splits(m, n, kp, dm._sm_count(dev))
        lib, fn = dm._load_fn(SOURCE, f"iwoq_{SOURCE}", _ARGTYPES)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mma:
            err = fn(x2.data_ptr(), x2.shape[1], int(x_copy), qt.shape[0], qw.data_ptr(),
                     s2.data_ptr(), s_rs, s_cs, z2.data_ptr(), z_rs, z_cs,
                     None if xs is None else xs.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     m, n, qt.n, kp, g, kc, splits, int(mode == "magic"), stream)
        else:
            err = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), x2.shape[1],
                     qw.data_ptr(), s2.data_ptr(), s_rs, s_cs, z2.data_ptr(), z_rs,
                     z_cs, ws.data_ptr(), out.data_ptr(), m, n, qt.n, kp, g, kc,
                     splits, int(mode == "magic"), stream)
    dm._raise_if(err, lib, name)
    dm.LAUNCHES[name] += 1
    return out
