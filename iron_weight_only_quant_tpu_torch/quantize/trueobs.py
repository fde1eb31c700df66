"""The TrueOBS solver (port of ``quantize/trueobs.py``).

The variant of the OBS/GPTQ family that the reference vendors in its
zero-shot harness (gptq/zeroShot/models/fast_trueobs.py:17-176).  Beside
plain GPTQ it offers:

* ``sparseout``: a weight whose squared rounding error exceeds
  ``0.25 * scale^2`` keeps its full-precision value (its loss is zeroed
  and no error is propagated for it): dense codes plus sparse fp outliers
  (fast_trueobs.py:108,134-139);
* ``nearest``: no error propagation at all, plain rounding with the same
  loss accounting (fast_trueobs.py:142-150);
* the per-element OBS loss ``(w - q)^2 / (2 d^2)`` (fast_trueobs.py:132,147).

The grid params are found once, per row, on the whole matrix
(fast_trueobs.py:72-73): no group refresh.  The skeleton is the GPTQ
solver's (:mod:`.gptq`), and so is the block's column loop: the same
kernel, ``csrc/gptq_block.cu``, in its TrueOBS mode on a CUDA tensor, and
:func:`.gptq.gptq_block_plain` on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gptq import (
    BlockFn,
    ColumnLoop,
    _find_params,
    damped_hinv_upper,
    drop_dead_columns,
    gptq_block,
    no_tf32,
)


class TrueOBSResult(NamedTuple):
    q: torch.Tensor            # dequantized weights [rows, cols] f32 (with fp outliers)
    codes: torch.Tensor        # integer codes [rows, cols] int32 (invalid at outliers)
    outliers: torch.Tensor     # bool [rows, cols]: True where q is the original weight
    scale: torch.Tensor        # [rows] f32
    zero: torch.Tensor         # [rows] f32
    losses: torch.Tensor       # [rows, cols] f32: (w - q)^2 / (2 d^2), 0 at outliers
    outlier_fraction: torch.Tensor  # 0-dim f32 (the reference prints tot / numel)


def trueobs_quantize(
    w: torch.Tensor,  # [rows, cols] -- [out, in] orientation
    h: torch.Tensor,  # [cols, cols] accumulated Hessian
    *,
    bits: int = 4,
    sym: bool = False,
    blocksize: int = 128,
    percdamp: float = 0.01,
    mse: bool = False,
    sparseout: bool = False,
    nearest: bool = False,
) -> TrueOBSResult:
    """Solve one linear with per-row grid params, on ``w``'s device."""
    return solve_trueobs(w, h, gptq_block, bits=bits, sym=sym, blocksize=blocksize,
                         percdamp=percdamp, mse=mse, sparseout=sparseout, nearest=nearest)


def solve_trueobs(
    w: torch.Tensor,
    h: torch.Tensor,
    block: BlockFn,
    *,
    bits: int = 4,
    sym: bool = False,
    blocksize: int = 128,
    percdamp: float = 0.01,
    mse: bool = False,
    sparseout: bool = False,
    nearest: bool = False,
) -> TrueOBSResult:
    """:func:`trueobs_quantize` with ``block`` solving each block's columns
    (:func:`.gptq.gptq_block`, or :func:`.gptq.gptq_block_plain` on any
    device)."""
    cols = w.shape[1]
    w = w.to(torch.float32)
    # the params come from the weights before the dead columns are zeroed
    # (fast_trueobs.py:72-73, then :93-95)
    scale, zero = _find_params(w, bits, sym, mse)
    w, h = drop_dead_columns(w, h.to(torch.float32))
    hinv = damped_hinv_upper(h, percdamp)
    del h

    outliers = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    loop = ColumnLoop(
        scale[:, None].contiguous(), zero[:, None].contiguous(), None, cols, False, bits, sym,
        mse, False, torch.zeros_like(w), torch.zeros_like(w), losses=torch.zeros_like(w),
        outliers=outliers if sparseout else None,
        thresh=0.25 * scale**2 if sparseout else None,  # fast_trueobs.py:108
        nearest=nearest)

    for i1 in range(0, cols, blocksize):
        i2 = min(i1 + blocksize, cols)
        err1 = block(w, hinv, i1, i2, loop)
        if not nearest:
            with no_tf32():
                w[:, i2:] -= err1 @ hinv[i1:i2, i2:]

    return TrueOBSResult(
        loop.q, loop.codes.to(torch.int32), outliers, scale, zero, loop.losses,
        outliers.to(torch.float32).mean(),
    )
