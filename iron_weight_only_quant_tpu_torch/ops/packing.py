"""Sub-byte weight packing with the split-K layout (port of ``ops/packing.py``).

The byte layouts are the artifact format shared with the JAX package, so
they are reproduced bit for bit:

  int4: byte ``p[k, n]`` holds code ``(k, n)`` in its low nibble and code
        ``(k + K/2, n)`` in its high nibble, stored MSB-flipped (``hi ^ 8``);
  int2: byte holds codes ``(k, k+K/4, k+K/2, k+3K/4)`` in 2-bit lanes;
  s21 (3-bit): array A ``[K/4, N]`` of 2-bit fields (top field flipped)
        plus an MSB bit-plane ``[K/8, N]``;
  nq42 (6-bit): a nibble array ``[K/2, N]`` laid out like int4 plus a quad
        array ``[K/4, N]`` holding the high 2 bits;
  int8: one byte per code, stored as ``code - 128`` two's complement.

``unpack_codes`` undoes both twists: it returns the logical unsigned codes
for sub-byte layouts and the signed (shifted) codes for 8-bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

# storage bits -> (layout name, K-divisibility requirement)
PACKED_LAYOUTS = {
    2: ("nib2", 4),
    3: ("s21", 8),   # 2-bit quads + MSB bit-plane -> 3 bytes per 8 codes
    4: ("nib4", 2),
    6: ("nq42", 4),  # 4-bit nibble array + 2-bit quad array
    8: ("byte", 1),
}


def packing_for_bits(bits: int) -> Tuple[str, int]:
    return PACKED_LAYOUTS.get(bits, ("byte", 1))


def _u8(a: torch.Tensor) -> torch.Tensor:
    return (a & 0xFF).to(torch.uint8).contiguous()


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes ``[K, N]`` (integer) -> packed uint8 array.

    * 4-bit: codes in [0, 15] -> ``[K/2, N]`` (high nibble MSB-flipped)
    * 2-bit: codes in [0, 3]  -> ``[K/4, N]``
    * 8-bit: codes in [-128, 127] (already shifted by caller) -> ``[K, N]``
    """
    layout, per_byte = packing_for_bits(bits)
    codes = codes.to(torch.int32)
    k = codes.shape[0]
    if layout == "byte":
        return _u8(codes)
    if k % per_byte != 0:
        raise ValueError(f"K={k} must divide {per_byte} for {bits}-bit packing")
    span = k // per_byte
    if layout == "nq42":
        ka, kb = k // 2, k // 4
        lo = codes & 0xF
        hi = (codes >> 4) & 3
        a = lo[:ka] | ((lo[ka:] ^ 8) << 4)
        b = torch.zeros_like(codes[:kb])
        for j in range(4):
            b = b | (hi[j * kb : (j + 1) * kb] << (2 * j))
        return _u8(torch.cat([a, b], dim=0))
    if layout == "s21":
        qa, qb = k // 4, k // 8
        lo = codes & 3
        hi = (codes >> 2) & 1
        a = torch.zeros_like(codes[:qa])
        for j in range(4):
            f = lo[j * qa : (j + 1) * qa]
            if j == 3:
                f = f ^ 2
            a = a | (f << (2 * j))
        b = torch.zeros_like(codes[:qb])
        for i in range(8):
            b = b | (hi[i * qb : (i + 1) * qb] << i)
        return _u8(torch.cat([a, b], dim=0))
    out = torch.zeros_like(codes[:span])
    for i in range(per_byte):
        slab = codes[i * span : (i + 1) * span]
        if bits == 4 and i == 1:
            slab = slab ^ 8  # MSB flip of the high nibble
        out = out | (slab << (bits * i))
    return _u8(out)


def unpack_codes(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> logical codes ``[K, N]`` int32.

    Sub-byte: unsigned [0, 2^bits).  8-bit: signed (stored) value [-128, 127].
    """
    layout, per_byte = packing_for_bits(bits)
    p = packed.to(torch.int32)
    if layout == "byte":
        return ((p & 0xFF) ^ 0x80) - 0x80  # sign-extend the int8 pattern
    if layout == "nq42":
        ka, kb = k // 2, k // 4
        a, b = p[:ka], p[ka : ka + kb]
        lo = torch.cat([a & 0xF, ((a >> 4) & 0xF) ^ 8], dim=0)
        hi = torch.cat([(b >> (2 * j)) & 3 for j in range(4)], dim=0)
        return lo | (hi << 4)
    if layout == "s21":
        qa, qb = k // 4, k // 8
        a, b = p[:qa], p[qa : qa + qb]
        lo_slabs = []
        for j in range(4):
            f = (a >> (2 * j)) & 3
            if j == 3:
                f = f ^ 2
            lo_slabs.append(f)
        lo = torch.cat(lo_slabs, dim=0)
        hi = torch.cat([(b >> i) & 1 for i in range(8)], dim=0)
        return lo | (hi << 2)
    mask = (1 << bits) - 1
    slabs = []
    for i in range(per_byte):
        slab = (p >> (bits * i)) & mask
        if bits == 4 and i == 1:
            slab = slab ^ 8
        slabs.append(slab)
    return torch.cat(slabs, dim=0)


def signed_to_unsigned_offset(bits: int) -> int:
    """Offset added to symmetric (signed) codes for unsigned storage."""
    return 1 << (bits - 1)


def pack_codes_sharded(codes: torch.Tensor, bits: int, k_shards: int) -> torch.Tensor:
    """Pack with pairing confined to each of ``k_shards`` K segments.

    Slicing the result at packed-segment boundaries yields arrays identical
    to packing each segment alone (the row-parallel sharding contract).
    """
    if k_shards <= 1:
        return pack_codes(codes, bits)
    k = codes.shape[0]
    if k % k_shards != 0:
        raise ValueError(f"K={k} not divisible by k_shards={k_shards}")
    seg = k // k_shards
    return torch.cat(
        [pack_codes(codes[i * seg : (i + 1) * seg], bits) for i in range(k_shards)],
        dim=0,
    )


def unpack_codes_sharded(
    packed: torch.Tensor, bits: int, k: int, k_shards: int
) -> torch.Tensor:
    if k_shards <= 1:
        return unpack_codes(packed, bits, k)
    seg_k = k // k_shards
    seg_p = packed.shape[0] // k_shards
    return torch.cat(
        [
            unpack_codes(packed[i * seg_p : (i + 1) * seg_p], bits, seg_k)
            for i in range(k_shards)
        ],
        dim=0,
    )
