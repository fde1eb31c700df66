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
the bf16 bias trick (mult 1, zshift -128).  The CUDA kernel is
``csrc/w4_inner_matmul.cu`` (design notes there); :func:`w4_inner_plain` is
its plain PyTorch version, which a CPU tensor takes.  Launches count in
``dequant_matmul.LAUNCHES`` and plain calls in ``PLAIN_CALLS``, under
``w4_inner_f32`` and ``w4_inner_magic``.
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
    ``csrc/w4_inner_matmul.cu``.  Raises for any artifact ``w4_matmul``
    does not take on the card."""
    name = _checked(x, qt, mode)
    if x.device.type == "cpu":
        return w4_inner_plain(x, qt, mode)
    if not x.is_cuda:
        raise NotImplementedError(f"no W4 inner-loop kernel for device {x.device}")
    x2 = dm._prep_x(x, qt)
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
    if m:
        kc, splits = dm.plan_splits(m, n, kp, dm._sm_count(dev))
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
        lib, fn = dm._load_fn(SOURCE, f"iwoq_{SOURCE}", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16), x2.shape[1],
                     qw.data_ptr(), s2.data_ptr(), s_rs, s_cs, z2.data_ptr(), z_rs,
                     z_cs, ws.data_ptr(), out.data_ptr(), m, n, qt.n, kp, g, kc,
                     splits, int(mode == "magic"), stream)
        dm._raise_if(err, lib, name)
        dm.LAUNCHES[name] += 1
    return out.reshape(x.shape[:-1] + (qt.n,))
