"""The GPTQ solver (port of ``quantize/gptq.py``).

Second-order post-training quantization: columns are quantized one by one
and each column's rounding error is propagated to the columns not yet
quantized through the upper Cholesky factor of the damped inverse Hessian
(the IST-DASLab algorithm the reference vendors in ``gptq/gptq.py``).
Blocks of ``blocksize`` columns are solved with a rank-1 update a column;
one product per block carries the block's errors to the columns after it.

A block's column loop is one function, :func:`gptq_block`: on a CUDA
tensor one launch of the hand-written kernel ``csrc/gptq_block.cu``
(``ops/kernels/gptq_block.py``), which takes the place of the JAX
package's compiled ``lax.fori_loop`` (it had no Pallas kernel here); on a
CPU tensor its plain version, :func:`gptq_block_plain`, about a dozen
small torch operations a column.  The damped factor, dead columns,
act-order, the static groups' tables and the cross-block product stay in
torch around it, as the JAX package keeps them outside its loop.
:func:`solve_gptq` takes the block function as an argument, so that the
plain loop can be run on the card beside the kernel.

Behaviour kept from the JAX package (held against ``tests/golden/gptq.npz``
and the JAX solver): dead columns, the damped Cholesky inverse's upper
factor, the per-row min/max grid (symmetric ranges mirrored, ``maxq = 2^bits
- 1``, ``zero = (maxq + 1) / 2`` when symmetric), the per-group scale refresh
at a group boundary reading the weights as they were before the block,
act-order by descending ``diag(H)``, static groups.  No f32 product of the
solver runs in TF32 on the card, whatever the caller has set.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import gptq_block as gb


class GPTQResult(NamedTuple):
    q: torch.Tensor        # dequantized weights [rows, cols] f32
    codes: torch.Tensor    # integer codes [rows, cols] int32, in [0, maxq]
    scales: torch.Tensor   # [rows, n_groups] f32
    zeros: torch.Tensor    # [rows, n_groups] f32
    perm: Optional[torch.Tensor]  # column permutation (act_order) or None


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls at full precision inside the block (the caller's
    setting is restored after it)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hessian_update(h: torch.Tensor, n: torch.Tensor,
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One add_batch step: the running mean ``H = (2/n) sum x x^T``.

    ``x``: ``[..., cols]``; ``n`` is a 0-dim f32 tensor on ``h``'s device
    (a Python float would compute the factors in f64).  The reference's
    recurrence (gptq/gptq.py:53-58), sample by sample.
    """
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    n1 = n + 1.0
    h = h * (n / n1)
    xs = torch.sqrt(n.new_tensor(2.0) / n1) * x
    with no_tf32():
        return h + xs.t() @ xs, n1


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``a / c`` (CUDA torch turns a Python-scalar divisor into a
    product with its reciprocal)."""
    return a / torch.full_like(a, c)


def _find_params(
    w: torch.Tensor, bits: int, sym: bool, mse: bool = False,
    norm: float = 2.4, grid: int = 100, maxshrink: float = 0.8,
    trits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row min/max grid params; ``w`` ``[rows, width]`` -> (scale,
    zero) ``[rows]``.

    ``mse`` runs the reference Quantizer's grid-shrink search
    (gptq/quant.py:78-95): ``int(maxshrink * grid)`` shrunken ranges
    ``p = 1 - i/grid``, keeping per row the one whose p-norm error is
    strictly lowest.  ``trits`` is the ternary mode (gptq/quant.py:33-34,
    68-70): ``scale`` carries the row max, ``zero`` the row min.
    """
    maxq = float(2**bits - 1)
    zero_t = torch.zeros((), dtype=w.dtype, device=w.device)
    xmin = torch.minimum(w.min(dim=1).values, zero_t)
    xmax = torch.maximum(w.max(dim=1).values, zero_t)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    if trits:
        if mse:
            # the reference runs the shrink loop with maxq < 0, where it is
            # degenerate (negative scale1, gptq/quant.py:78-95)
            raise ValueError("mse grid search is not supported in trits (ternary) mode")
        return xmax, xmin
    scale = _div(xmax - xmin, maxq)
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    if mse:
        best = torch.full_like(scale, float("inf"))
        for i in range(int(maxshrink * grid)):
            # the JAX package's f32 arithmetic for p
            p = float(np.float32(1.0) - np.float32(i) / np.float32(grid))
            xmin1, xmax1 = p * xmin, p * xmax
            scale1 = _div(xmax1 - xmin1, maxq)
            zero1 = zero if sym else torch.round(-xmin1 / scale1)
            q = torch.clamp(torch.round(w / scale1[:, None]) + zero1[:, None], 0, maxq)
            err = (scale1[:, None] * (q - zero1[:, None]) - w).abs().pow(norm).sum(dim=1)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)
    return scale, zero


def _quantize_col(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                  maxq: float, trits: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized value, code) of ``w`` on the grid ``scale``, ``zero``."""
    if trits:
        # the ternary snap (gptq/quant.py:6-8): {zero, 0, scale}, coded 0/1/2
        hi = w > scale / 2
        lo = w < zero / 2
        q = hi * scale + lo * zero
        code = torch.where(hi, 2.0, torch.where(lo, 0.0, 1.0))
        return q, code
    q = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
    return scale * (q - zero), q


def damped_hinv_upper(h: torch.Tensor, percdamp: float) -> torch.Tensor:
    """The upper Cholesky factor ``U`` of the damped inverse Hessian,
    ``(H + damp I)^-1 = U^T U`` with ``damp = percdamp * mean(diag(H))``:
    row ``i`` of ``U`` gives column ``i``'s update coefficients."""
    h = h.clone()
    damp = percdamp * torch.diagonal(h).mean()
    h.diagonal().add_(damp)
    with no_tf32():
        hinv = torch.cholesky_inverse(torch.linalg.cholesky(h))
        return torch.linalg.cholesky(hinv, upper=True)


def drop_dead_columns(w: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columns no calibration input reached (``diag(H) == 0``): a unit
    diagonal in ``H`` and zero weights (no host sync: no boolean index)."""
    dead = torch.diagonal(h) == 0
    h = h + torch.diag(dead.to(h.dtype))
    return torch.where(dead[None, :], 0.0, w), h


class ColumnLoop(NamedTuple):
    """What a block's column loop reads and writes beside ``w`` and the
    factor, for every block of one solve (the JAX ``fori_loop``'s carry).

    Column ``col``'s grid params are column ``g`` of ``scales`` and
    ``zeros`` (``[rows, n_groups]`` f32), ``g = gidx[col]`` (int32
    ``[cols]``: static groups under act-order) or ``col // gsize``.  With
    ``refresh`` (groups, not static) the loop finds them itself at each
    group boundary, from the outer ``w`` as it was before the block, and
    writes them there; otherwise it only reads them.  TrueOBS sets
    ``losses`` (and, with ``sparseout``, ``outliers`` and ``thresh``) and
    may set ``nearest``.
    """

    scales: torch.Tensor
    zeros: torch.Tensor
    gidx: Optional[torch.Tensor]
    gsize: int
    refresh: bool
    bits: int
    sym: bool
    mse: bool
    trits: bool
    q: torch.Tensor       # [rows, cols] f32, written
    codes: torch.Tensor   # [rows, cols] f32, written
    losses: Optional[torch.Tensor] = None    # [rows, cols] f32, written
    outliers: Optional[torch.Tensor] = None  # [rows, cols] bool, written
    thresh: Optional[torch.Tensor] = None    # [rows] f32: 0.25 * scale^2
    nearest: bool = False


BlockFn = Callable[[torch.Tensor, torch.Tensor, int, int, ColumnLoop], torch.Tensor]


def gptq_block_plain(w: torch.Tensor, hinv: torch.Tensor, i1: int, i2: int,
                     loop: ColumnLoop) -> torch.Tensor:
    """Plain PyTorch version of one block's column loop (columns ``i1`` to
    ``i2`` of ``w`` ``[rows, cols]``, with the upper factor ``hinv``),
    on any device: writes the block's columns of ``loop.q``,
    ``loop.codes`` (and the TrueOBS outputs), the group params found in
    it, and returns the block's scaled errors ``err1`` ``[rows, i2 -
    i1]``.  ``w`` is read, never written."""
    gb.PLAIN_CALLS[gb.GPTQ_BLOCK] += 1
    cols = w.shape[1]
    gsize = loop.gsize
    maxq = float(2**loop.bits - 1)
    w1 = w[:, i1:i2].clone()
    err1 = torch.zeros_like(w1)
    hinv1 = hinv[i1:i2, i1:i2]
    groups: List[int] = (loop.gidx[i1:i2].tolist() if loop.gidx is not None
                         else [col // gsize for col in range(i1, i2)])
    scale = zero = None
    g_now = -1
    for i in range(i2 - i1):
        col = i1 + i
        g = groups[i]
        if loop.refresh and col % gsize == 0:
            # the outer w, as it was before this block; the JAX package's
            # dynamic_slice keeps the slice inside the matrix, so a last
            # partial group reads the last gsize columns
            start = min(col, cols - gsize)
            scale, zero = _find_params(w[:, start:start + gsize], loop.bits, loop.sym,
                                       loop.mse, trits=loop.trits)
            loop.scales[:, g] = scale
            loop.zeros[:, g] = zero
        elif g != g_now:
            scale, zero = loop.scales[:, g], loop.zeros[:, g]
        g_now = g
        wcol = w1[:, i]
        d = hinv1[i, i]
        qcol, code = _quantize_col(wcol, scale, zero, maxq, trits=loop.trits)
        if loop.losses is not None:
            loss = (wcol - qcol) ** 2 / d**2
            if loop.thresh is not None:
                sel = (wcol - qcol) ** 2 > loop.thresh
                loss = torch.where(sel, 0.0, loss)
                qcol = torch.where(sel, wcol, qcol)
                loop.outliers[:, col] = sel
            loop.losses[:, col] = loss / 2.0  # fast_trueobs.py:147
        err = (wcol - qcol) / d
        if not loop.nearest:
            # the update includes column i itself, as the JAX package's mask
            w1[:, i:] -= err[:, None] * hinv1[i, i:][None, :]
        loop.q[:, col] = qcol
        loop.codes[:, col] = code
        err1[:, i] = err
    return err1


def gptq_block(w: torch.Tensor, hinv: torch.Tensor, i1: int, i2: int,
               loop: ColumnLoop) -> torch.Tensor:
    """One block's column loop: a CPU tensor takes :func:`gptq_block_plain`,
    a CUDA tensor one launch of ``csrc/gptq_block.cu`` (or raises)."""
    if w.device.type == "cpu":
        return gptq_block_plain(w, hinv, i1, i2, loop)
    return gb.gptq_block_kernel(w, hinv, i1, i2, loop)


def gptq_quantize(
    w: torch.Tensor,  # [rows, cols] -- [out, in] orientation
    h: torch.Tensor,  # [cols, cols] accumulated Hessian
    *,
    bits: int = 4,
    sym: bool = False,
    groupsize: int = -1,
    blocksize: int = 128,
    percdamp: float = 0.01,
    actorder: bool = False,
    static_groups: bool = False,
    mse: bool = False,
    trits: bool = False,
) -> GPTQResult:
    """Solve one linear: the quantized weights, codes and grid params, on
    ``w``'s device.  ``groupsize`` -1 is one group per row."""
    return solve_gptq(w, h, gptq_block, bits=bits, sym=sym, groupsize=groupsize,
                      blocksize=blocksize, percdamp=percdamp, actorder=actorder,
                      static_groups=static_groups, mse=mse, trits=trits)


def solve_gptq(
    w: torch.Tensor,
    h: torch.Tensor,
    block: BlockFn,
    *,
    bits: int = 4,
    sym: bool = False,
    groupsize: int = -1,
    blocksize: int = 128,
    percdamp: float = 0.01,
    actorder: bool = False,
    static_groups: bool = False,
    mse: bool = False,
    trits: bool = False,
) -> GPTQResult:
    """:func:`gptq_quantize` with ``block`` solving each block's columns
    (:func:`gptq_block`, or :func:`gptq_block_plain` on any device)."""
    rows, cols = w.shape
    w, h = drop_dead_columns(w.to(torch.float32), h.to(torch.float32))

    # a group wider than the matrix is one group over all columns (torch
    # slicing clamps in the reference)
    gsize = cols if groupsize == -1 else min(groupsize, cols)
    n_groups = (cols + gsize - 1) // gsize

    if static_groups:  # scales fixed from the weights before any update
        params = [_find_params(w[:, g * gsize:(g + 1) * gsize], bits, sym, mse, trits=trits)
                  for g in range(n_groups)]
        scales = torch.stack([s for s, _ in params], dim=1)
        zeros = torch.stack([z for _, z in params], dim=1)

    perm = gidx = None
    if actorder:
        perm = torch.argsort(-torch.diagonal(h), stable=True)
        w = w[:, perm]
        h = h[perm][:, perm]
        if static_groups:
            gidx = torch.div(perm, gsize, rounding_mode="floor").to(torch.int32)

    hinv = damped_hinv_upper(h, percdamp)
    del h

    refresh = groupsize != -1 and not static_groups
    if refresh:
        scales = w.new_zeros((rows, n_groups))
        zeros = w.new_zeros((rows, n_groups))
    elif not static_groups:
        scale, zero = _find_params(w, bits, sym, mse, trits=trits)
        scales, zeros = scale[:, None].contiguous(), zero[:, None].contiguous()
    loop = ColumnLoop(scales, zeros, gidx, gsize, refresh, bits, sym, mse, trits,
                      torch.zeros_like(w), torch.zeros_like(w))

    for i1 in range(0, cols, blocksize):
        i2 = min(i1 + blocksize, cols)
        err1 = block(w, hinv, i1, i2, loop)
        with no_tf32():  # the block's errors to the columns after it
            w[:, i2:] -= err1 @ hinv[i1:i2, i2:]

    q_out, codes_out = loop.q, loop.codes
    if actorder:
        invperm = torch.argsort(perm)
        q_out = q_out[:, invperm]
        codes_out = codes_out[:, invperm]
    return GPTQResult(q_out, codes_out.to(torch.int32), scales, zeros, perm)
