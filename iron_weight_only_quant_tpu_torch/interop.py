"""Carry parameter trees across from the JAX package as numpy.

The caller turns every array of a JAX param tree into numpy first (for
example ``jax.tree.map(np.asarray, params)``); :func:`params_from_numpy`
then rebuilds the tree with torch tensors on ``device``.  Packed artifacts
and fused linears are recognised by their fields (duck typing), so this
module never imports the JAX package:

* a leaf with ``qweight``, ``scales``, ``zeros``, ``codebook``, ``spec``,
  ``shape`` and ``mode`` becomes a :class:`QuantizedTensor` (``k_shards``,
  ``n_pad``, ``k_pad`` and ``side_pad`` are carried when present);
* a leaf with ``w``, ``b`` and ``spans`` becomes a :class:`FusedLinear`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import AlignSpec, FloatFormat, QuantSpec
from .device import resolve_device
from .models.common import FusedLinear
from .quantize.qtensor import QuantizedTensor

_QT_FIELDS = ("qweight", "scales", "zeros", "codebook", "spec", "shape", "mode")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array -> tensor on device.  bfloat16 is read from ``ml_dtypes``'
    type or, as numpy without ``ml_dtypes`` loads an artifact's bf16 array,
    from a 2-byte void type (the only one the artifacts hold)."""
    a = np.array(a)  # a writable copy: torch refuses read-only buffers
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def spec_from_fields(spec) -> QuantSpec:
    """Rebuild a :class:`QuantSpec` from any object with the same fields."""
    ff = spec.float_format
    al = spec.align
    return QuantSpec(
        fmt=spec.fmt, bits=spec.bits, group_size=spec.group_size,
        symmetric=spec.symmetric, quant_axis=spec.quant_axis,
        float_format=None if ff is None else FloatFormat(ff.exp_bits, ff.mant_bits),
        approximate=spec.approximate,
        double_approximate=spec.double_approximate,
        align=None if al is None else AlignSpec(
            al.hi_align_start, al.hi_align_exp_field, al.tail_pad_bits,
            al.align_subnorm_exp_as_one, al.limit_align_exp_to_field,
            al.handle_max_outlier),
    )


def _is_qtensor_like(v: Any) -> bool:
    return all(hasattr(v, f) for f in _QT_FIELDS)


def _is_fused_like(v: Any) -> bool:
    return all(hasattr(v, f) for f in ("w", "b", "spans"))


def params_from_numpy(tree: Any, device) -> Any:
    """Rebuild a numpy param tree as torch tensors on ``device``.

    Torch leaves and the port's own artifacts are moved to ``device`` as
    they are, so the same call also copies a port param tree to another
    device.
    """
    device = resolve_device(device)

    def conv(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, (np.ndarray, np.generic)):
            return tensor_from_numpy(v, device)
        if isinstance(v, QuantizedTensor):
            return v.map_arrays(lambda a: a.to(device))
        if _is_qtensor_like(v):
            opt = lambda a: None if a is None else tensor_from_numpy(a, device)  # noqa: E731
            return QuantizedTensor(
                tensor_from_numpy(v.qweight, device),
                tensor_from_numpy(v.scales, device),
                opt(v.zeros), opt(v.codebook), spec_from_fields(v.spec),
                tuple(int(d) for d in v.shape), str(v.mode),
                k_shards=int(getattr(v, "k_shards", 1)),
                n_pad=int(getattr(v, "n_pad", 0)),
                k_pad=int(getattr(v, "k_pad", 0)),
                side_pad=int(getattr(v, "side_pad", 0)),
            )
        if _is_fused_like(v):
            return FusedLinear(conv(v.w), conv(v.b),
                               tuple((int(a), int(b)) for a, b in v.spans))
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        if torch.is_tensor(v):
            return v.to(device)
        raise TypeError(f"params_from_numpy: cannot convert {type(v).__name__}")

    return conv(tree)
