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
solver's (:mod:`.gptq`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gptq import _find_params, _quantize_col, damped_hinv_upper, drop_dead_columns, no_tf32


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
    rows, cols = w.shape
    maxq = float(2**bits - 1)
    w = w.to(torch.float32)
    # the params come from the weights before the dead columns are zeroed
    # (fast_trueobs.py:72-73, then :93-95)
    scale, zero = _find_params(w, bits, sym, mse)
    outlier_thresh = 0.25 * scale**2  # fast_trueobs.py:108
    w, h = drop_dead_columns(w, h.to(torch.float32))
    hinv = damped_hinv_upper(h, percdamp)
    del h

    q_out = torch.zeros_like(w)
    codes_out = torch.zeros_like(w)
    outlier_out = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    losses_out = torch.zeros_like(w)

    for i1 in range(0, cols, blocksize):
        i2 = min(i1 + blocksize, cols)
        w1 = w[:, i1:i2].clone()
        err1 = torch.zeros_like(w1)
        hinv1 = hinv[i1:i2, i1:i2]
        for i in range(i2 - i1):
            col = i1 + i
            wcol = w1[:, i]
            d = hinv1[i, i]
            qcol, code = _quantize_col(wcol, scale, zero, maxq)
            loss = (wcol - qcol) ** 2 / d**2
            if sparseout:
                sel = (wcol - qcol) ** 2 > outlier_thresh
                loss = torch.where(sel, 0.0, loss)
                qcol = torch.where(sel, wcol, qcol)
                outlier_out[:, col] = sel
            err = (wcol - qcol) / d
            if not nearest:
                w1[:, i:] -= err[:, None] * hinv1[i, i:][None, :]
            q_out[:, col] = qcol
            codes_out[:, col] = code
            losses_out[:, col] = loss / 2.0  # fast_trueobs.py:147
            err1[:, i] = err
        if not nearest:
            with no_tf32():
                w[:, i2:] -= err1 @ hinv[i1:i2, i2:]

    return TrueOBSResult(
        q_out, codes_out.to(torch.int32), outlier_out, scale, zero, losses_out,
        outlier_out.to(torch.float32).mean(),
    )
