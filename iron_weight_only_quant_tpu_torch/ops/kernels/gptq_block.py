"""The GPTQ / TrueOBS column loop of one block as one CUDA launch.

Counterpart of the JAX solvers' compiled block loops, the ``lax.fori_loop``
of ``quantize/gptq.py`` (body ``:209-257``) and of ``quantize/trueobs.py``
(``:382-411``), which XLA compiles and which have no Pallas kernel.
:func:`gptq_block_kernel` launches ``csrc/gptq_block.cu`` (design notes
there) for columns ``i1`` to ``i2`` of a solve, in every mode the solvers
have: group refresh (with the ``mse`` shrink search), per-channel, static
groups (under act-order through a device table of each column's group),
``trits``, and TrueOBS plain, ``nearest`` and ``sparseout``.  Its plain
PyTorch version is ``quantize.gptq.gptq_block_plain``, which a CPU tensor
takes (``quantize.gptq.gptq_block`` dispatches).  Launches count in
``LAUNCHES``, plain calls in ``PLAIN_CALLS``, both under ``GPTQ_BLOCK``;
:func:`reset_counts` zeroes both.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

GPTQ_BLOCK = "gptq_block"
SOURCE = "gptq_block"
LAUNCHES: Dict[str, int] = {GPTQ_BLOCK: 0}
PLAIN_CALLS: Dict[str, int] = {GPTQ_BLOCK: 0}
# the mse shrink search of quantize.gptq._find_params
MSE_NORM, MSE_GRID, MSE_MAXSHRINK = 2.4, 100, 0.8
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = [
    _P, _L, _I, _I,          # w, its row stride, rows, cols
    _P, _L, _L,              # hinv, its two strides
    _P, _P, _I,              # scales, zeros, n_groups
    _P, _I, _I,              # gidx, gsize, refresh
    _P, _P, _P,              # q, codes, err1
    _P, _P, _P,              # losses, outliers, thresh
    _I, _I,                  # i1, count
    _F, _I, _I, _I,          # maxq, sym, trits, mse
    _F, _I, _I,              # norm, grid, steps
    _I,                      # nearest
    _P,                      # stream
]


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def gptq_block_kernel(w: torch.Tensor, hinv: torch.Tensor, i1: int, i2: int, loop) -> torch.Tensor:
    """One launch of ``csrc/gptq_block.cu`` for columns ``i1`` to ``i2``:
    writes those columns of ``loop.q``, ``loop.codes`` (and the TrueOBS
    outputs), the group params found in the block, and returns ``err1``
    ``[rows, i2 - i1]``.  ``loop`` is a ``quantize.gptq.ColumnLoop``.
    Raises for a tensor that is not on a CUDA device, of another dtype or
    layout than the solver makes, or a failed build or launch."""
    from . import dequant_matmul as dm  # not at import: quantize.gptq imports this module

    if not w.is_cuda:
        raise NotImplementedError(f"no GPTQ block kernel for device {w.device}")
    rows, cols = w.shape
    count = i2 - i1
    dev = w.device
    f32 = [w, hinv, loop.scales, loop.zeros, loop.q, loop.codes]
    f32 += [t for t in (loop.losses, loop.thresh) if t is not None]
    for t in f32:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"GPTQ block operand on {t.device} as {t.dtype}: needs float32 "
                             f"on {dev}")
    n_groups = loop.scales.shape[1]
    if (w.stride(1) != 1 or hinv.shape != (cols, cols) or loop.gsize <= 0
            or not 0 <= i1 < i2 <= cols
            or any(not t.is_contiguous() for t in (loop.scales, loop.zeros, loop.q, loop.codes))
            or loop.scales.shape != (rows, n_groups) or loop.zeros.shape != (rows, n_groups)
            or loop.q.shape != (rows, cols) or loop.codes.shape != (rows, cols)):
        raise ValueError(f"GPTQ block: w {tuple(w.shape)} strides {w.stride()}, hinv "
                         f"{tuple(hinv.shape)}, tables {tuple(loop.scales.shape)}, columns "
                         f"{i1}:{i2}, group {loop.gsize}: not a layout the kernel takes")
    if loop.gidx is not None and (loop.gidx.dtype != torch.int32 or loop.gidx.device != dev
                                  or loop.gidx.shape != (cols,)):
        raise ValueError("GPTQ block: gidx must be int32 [cols] on the weight's device")
    if loop.losses is not None and (loop.losses.shape != (rows, cols)
                                    or not loop.losses.is_contiguous()):
        raise ValueError("GPTQ block: losses must be a contiguous [rows, cols] tensor")
    if loop.thresh is not None and (loop.outliers is None or loop.outliers.dtype != torch.bool
                                    or loop.outliers.shape != (rows, cols)
                                    or not loop.outliers.is_contiguous()
                                    or loop.thresh.shape != (rows,)):
        raise ValueError("GPTQ block: sparseout needs bool outliers [rows, cols] and thresh "
                         "[rows]")
    if loop.trits and loop.mse:
        raise ValueError("mse grid search is not supported in trits (ternary) mode")
    err1 = torch.empty((rows, count), dtype=torch.float32, device=dev)
    maxq = float(2**loop.bits - 1)
    lib, fn = dm._load_fn(SOURCE, f"iwoq_{SOURCE}", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(w.data_ptr(), w.stride(0), rows, cols,
                 hinv.data_ptr(), hinv.stride(0), hinv.stride(1),
                 loop.scales.data_ptr(), loop.zeros.data_ptr(), n_groups,
                 _ptr(loop.gidx), loop.gsize, int(loop.refresh),
                 loop.q.data_ptr(), loop.codes.data_ptr(), err1.data_ptr(),
                 _ptr(loop.losses), _ptr(loop.outliers), _ptr(loop.thresh), i1, count,
                 maxq, int(loop.sym), int(loop.trits), int(loop.mse),
                 MSE_NORM, MSE_GRID, int(MSE_MAXSHRINK * MSE_GRID),
                 int(loop.nearest), stream)
    dm._raise_if(err, lib, GPTQ_BLOCK)
    LAUNCHES[GPTQ_BLOCK] += 1
    return err1
