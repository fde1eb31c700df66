"""The packed quantized-weight artifact (port of ``quantize/qtensor.py``).

The artifact keeps weights packed in device memory; the dequant-matmul
kernels read them directly.  One dequant rule covers the packed formats:

  affine ("int", "bfp"):   w = (codes - zeros) * scales
  lut    ("fp" minifloat): w = codebook[codes] * scales (+ zeros)

Layouts (for an ``[K, N]`` weight, ``y = x @ w``):
  * ``qweight``: packed uint8 (see ``ops/packing.py``, split-K layout)
  * ``scales``/``zeros``: ``[K/G, N]`` per-group, ``[1, N]`` per-channel,
    ``[1, 1]`` per-tensor, broadcast over K-groups
  * ``codebook``: ``[2^bits]`` decode table (LUT mode)

A layer-stacked artifact carries a leading ``[L, ...]`` axis on every array.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..config import QuantSpec


@dataclass
class QuantizedTensor:
    qweight: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]
    codebook: Optional[torch.Tensor]
    spec: QuantSpec
    shape: Tuple[int, int]  # (K, N) logical
    mode: str  # "affine" | "lut"
    # sub-byte codes are paired within each of k_shards contiguous K
    # segments (row-parallel sharding contract)
    k_shards: int = 1
    # zero columns appended to N in storage; ``shape`` stays logical
    n_pad: int = 0
    # zero rows appended to K in storage, in whole quantization groups;
    # they only ever meet zero-padded x columns, so they contribute 0
    k_pad: int = 0
    # rows appended to the side-info row axis of a stacked artifact;
    # consumers slice them off (logical rows = stored rows - side_pad)
    side_pad: int = 0

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def k_stored(self) -> int:
        return self.shape[0] + self.k_pad

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def storage_bits(self) -> int:
        return self.spec.storage_bits

    def replace(self, **kw) -> "QuantizedTensor":
        return dataclasses.replace(self, **kw)

    def map_arrays(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to every tensor field (e.g. ``.to(device)``)."""
        opt = lambda a: None if a is None else fn(a)  # noqa: E731
        return self.replace(qweight=fn(self.qweight), scales=fn(self.scales),
                            zeros=opt(self.zeros), codebook=opt(self.codebook))


def repack_k_shards(qt: QuantizedTensor, k_shards: int) -> QuantizedTensor:
    """Re-pack an artifact so sub-byte code pairing is confined to each of
    ``k_shards`` contiguous K segments.

    Row-parallel sharding slices the packed array at segment boundaries; a
    ``k_shards=1`` artifact pairs codes (k, k + K/2) in one byte, so a bare
    row slice is not self-contained until it is repacked (one unpack and
    pack pass).
    """
    if qt.k_shards == k_shards:
        return qt
    from ..ops.packing import pack_codes_sharded, unpack_codes_sharded
    from ..ops.qmatmul import packed_bits

    bits = packed_bits(qt)
    codes = unpack_codes_sharded(qt.qweight, bits, qt.k_stored, qt.k_shards)
    return qt.replace(qweight=pack_codes_sharded(codes, bits, k_shards),
                      k_shards=k_shards)


def concat_n(qts: Sequence[QuantizedTensor]) -> QuantizedTensor:
    """Concatenate packed artifacts along the output (N) dimension.

    Per-group quantization is independent per output column, so fusing
    projections that share an input (q|k|v, gate|up) into one artifact is
    exact.  Members may carry N padding; the fused tensor treats stored
    columns as logical (n_pad=0) and callers slice member outputs by
    :func:`stored_spans`.
    """
    first = qts[0]
    for qt in qts[1:]:
        if (qt.spec != first.spec or qt.mode != first.mode
                or qt.shape[0] != first.shape[0] or qt.k_shards != first.k_shards
                or qt.k_pad != first.k_pad
                or qt.scales.shape[0] != first.scales.shape[0]
                or (qt.zeros is None) != (first.zeros is None)):
            raise ValueError("concat_n: incompatible artifacts")
        if (qt.codebook is None) != (first.codebook is None) or (
            first.codebook is not None
            and not torch.equal(qt.codebook, first.codebook)
        ):
            raise ValueError("concat_n: incompatible codebooks")
    total_n = sum(qt.shape[1] + qt.n_pad for qt in qts)
    return QuantizedTensor(
        torch.cat([qt.qweight for qt in qts], dim=-1),
        torch.cat([qt.scales for qt in qts], dim=-1),
        None if first.zeros is None
        else torch.cat([qt.zeros for qt in qts], dim=-1),
        first.codebook,
        first.spec,
        (first.shape[0], total_n),
        first.mode,
        k_shards=first.k_shards,
        n_pad=0,
        k_pad=first.k_pad,
    )


def stored_spans(qts: Sequence[QuantizedTensor]) -> Tuple[Tuple[int, int], ...]:
    """[(start, end)] of each member's *logical* columns inside the stored
    (padding-inclusive) width of ``concat_n(qts)``'s output."""
    spans, off = [], 0
    for qt in qts:
        spans.append((off, off + qt.shape[1]))
        off += qt.shape[1] + qt.n_pad
    return tuple(spans)
