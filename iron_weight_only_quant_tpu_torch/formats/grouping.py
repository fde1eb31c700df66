"""Grouped-view helpers (port of ``formats/grouping.py``).

A quantization *group* is a contiguous run of weights sharing one scale and
zero-point.  Weights are stored ``[in, out]`` (``y = x @ w``):

  * ``group_size > 0``   : groups of that width along the chosen axis
  * ``group_size == -1`` : one group spanning the whole tensor (per-tensor)
  * ``group_size == -2`` : one group per channel (per output feature)

For ``quant_axis=0`` row ``g`` of the view is the ``g``-th group in
``[out, in]`` row-major order, as in the JAX package, so both produce the
same scales for the same weights.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import PER_CHANNEL, PER_TENSOR


def group_view_shape(shape: Tuple[int, int], group_size: int, quant_axis: int) -> Tuple[int, int]:
    """Shape of the grouped view for a ``[in, out]`` weight of ``shape``."""
    k, n = shape
    if quant_axis == 0:
        rows, reduce_len = n, k
    else:
        rows, reduce_len = k, n
    if group_size == PER_TENSOR:
        return (1, rows * reduce_len)
    if group_size == PER_CHANNEL:
        return (rows, reduce_len)
    if group_size > 0:
        if reduce_len % group_size != 0:
            raise ValueError(
                f"axis length {reduce_len} not divisible by group_size {group_size}"
            )
        return (rows * reduce_len // group_size, group_size)
    raise ValueError(f"invalid group_size {group_size}")


def make_groups(w: torch.Tensor, group_size: int, quant_axis: int = 0) -> torch.Tensor:
    """``[in, out]`` weight -> ``[n_groups, width]`` grouped view."""
    if w.dim() != 2:
        raise ValueError("make_groups expects a 2-D weight")
    mat = w.t() if quant_axis == 0 else w  # -> [rows, reduce_len]
    shape = group_view_shape(tuple(w.shape), group_size, quant_axis)
    return mat.reshape(shape)


def restore_from_groups(
    groups: torch.Tensor, shape: Tuple[int, int], quant_axis: int = 0
) -> torch.Tensor:
    """Grouped view -> ``[in, out]`` weight of ``shape``."""
    k, n = shape
    if quant_axis == 0:
        return groups.reshape(n, k).t()
    return groups.reshape(k, n)
