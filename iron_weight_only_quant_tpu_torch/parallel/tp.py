"""Tensor-parallel quantized linears over the ``"model"`` ranks (port of
``parallel/tp.py``).

The two megatron building blocks, each rank running the quantized matmul
(the W4/W8 kernels on the card) on its own shard of the packed artifact:

  * :func:`tp_column_matmul` -- weight split on N (output features); x
    whole on every rank; each rank returns its N slice of y.  Split-K
    packing never pairs columns, so any artifact splits on N.
  * :func:`tp_row_matmul` -- weight split on K (reduction); each rank
    takes its K segment of x; the partial products are all-reduced.
    Needs an artifact packed with ``k_shards`` equal to the model axis
    (``quantize_tensor(..., k_shards=d)`` or ``repack_k_shards``), so
    that each rank's packed rows are self-contained.

Both take the whole (global) artifact and slice this rank's shard, as a
``shard_map`` does.
"""

from __future__ import annotations

import torch

from ..ops.qmatmul import quantized_matmul
from ..quantize.qtensor import QuantizedTensor
from .mesh import Mesh, all_reduce
from .sharding import _local


def _side_specs(qt: QuantizedTensor, row_shard: bool):
    def spec(side):
        if side is None:
            return None
        if row_shard:
            # per-channel/tensor side info ([1, N] / [1, 1]) is K-invariant
            return ("model", None) if side.shape[0] > 1 else ()
        return (None, "model") if side.shape[1] > 1 else ()

    return spec(qt.scales), spec(qt.zeros)


def _local_qt(qt: QuantizedTensor, qw, s, z, k_local: int, n_local: int) -> QuantizedTensor:
    return QuantizedTensor(qw, s, z, None, qt.spec, (k_local, n_local), qt.mode, 1,
                           qt.n_pad, qt.k_pad)


def _shard(qt: QuantizedTensor, mesh: Mesh, row: bool):
    s_spec, z_spec = _side_specs(qt, row)
    wspec = ("model", None) if row else (None, "model")
    return (_local(qt.qweight, wspec, mesh), _local(qt.scales, s_spec, mesh),
            None if qt.zeros is None else _local(qt.zeros, z_spec, mesh))


def tp_column_matmul(x: torch.Tensor, qt: QuantizedTensor, mesh: Mesh) -> torch.Tensor:
    """x: [..., K] on every rank -> this rank's y[..., N/d] block."""
    if qt.mode != "affine":
        raise NotImplementedError("tp ops support affine artifacts")
    d = mesh.model
    if qt.n % d != 0 or (qt.scales.shape[1] > 1 and qt.scales.shape[1] % d != 0):
        raise ValueError(f"N={qt.n} / scale columns must divide model={d}")
    qw, s, z = _shard(qt, mesh, row=False)
    return quantized_matmul(x, _local_qt(qt, qw, s, z, qt.k, qt.n // d))


def tp_row_matmul(x: torch.Tensor, qt: QuantizedTensor, mesh: Mesh) -> torch.Tensor:
    """x: [..., K] (whole; this rank takes its segment) or [..., K/d] (this
    rank's segment) -> y: [..., N], all-reduced over the model ranks.

    The artifact must be packed with ``k_shards`` equal to the model axis."""
    if qt.mode != "affine":
        raise NotImplementedError("tp ops support affine artifacts")
    d = mesh.model
    if qt.k_shards != d:
        raise ValueError(
            f"artifact k_shards={qt.k_shards} must equal mesh model size {d}; "
            "re-quantize with quantize_tensor(..., k_shards=d)")
    if qt.scales.shape[0] > 1 and qt.scales.shape[0] % d != 0:
        raise ValueError("per-group scale rows must divide the mesh axis")
    k_loc = qt.k // d
    if x.shape[-1] == qt.k and d > 1:
        x = x[..., mesh.model_index * k_loc:(mesh.model_index + 1) * k_loc]
    qw, s, z = _shard(qt, mesh, row=True)
    part = quantized_matmul(x, _local_qt(qt, qw, s, z, k_loc, qt.n))
    return all_reduce(part, mesh.model_group)
