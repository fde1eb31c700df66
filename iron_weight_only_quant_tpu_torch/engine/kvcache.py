"""KV caches (port of ``engine/kvcache.py``): contiguous 16-bit, quantized
int8/int4, and paged.

A cache is one view per layer:

* :class:`~..models.common.KVCacheView`: ``[B, T_max, H_kv, D]`` buffers
  in the compute dtype;
* :class:`QuantKVCacheView`: the same timeline as integer codes with
  per-(token, head, group) affine params, encoded on write and decoded on
  read (the asymmetric min/max codec of ``formats/int_codec.py`` over
  groups of the head dim).  int8 halves the cache; int4 codes are packed
  two a byte (split-D: byte ``d`` holds codes ``d`` and ``d + D/2``) and
  quarter it;
* :class:`PagedKVCacheView`: a pool of fixed-size pages shared by the
  slots, 16-bit or quantized with the same codec, and a per-slot page
  table; pool memory follows the live tokens.

The scan path (layer-stacked params) takes ONE contiguous view, 16-bit or
quantized, whose buffers carry a leading layer axis, ``[L, B, T_max, ...]``
(:func:`make_stacked_caches`); the forward hands layer ``l`` a
:class:`StackedCacheAt`.  Paged caches have no stacked form, as in the
reference.

Every buffer is updated in place by index, with no host sync
(``models.common.write_columns`` for the contiguous views).  Quantizing
and dequantizing are plain torch ops, as they were plain XLA in the
reference.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch

from ..config import KVCacheConfig
from ..device import resolve_device
from ..formats.int_codec import decode_int, encode_int
from ..models.common import KVCacheView, update_kv_cache, write_columns


class QuantKVCacheView(NamedTuple):
    """Quantized per-layer cache: codes + per-group affine params.

    Codes ``[B, T, H, D]`` int8, or ``[B, T, H, D/2]`` uint8 when
    ``packed``; scales/zeros ``[B, T, H, D/g]`` f32.  ``length`` and
    ``valid`` as in :class:`~..models.common.KVCacheView`.
    """

    k_codes: torch.Tensor
    k_scales: torch.Tensor
    k_zeros: torch.Tensor
    v_codes: torch.Tensor
    v_scales: torch.Tensor
    v_zeros: torch.Tensor
    length: Union[int, torch.Tensor]
    bits: int
    group: int
    packed: bool = False
    valid: Optional[torch.Tensor] = None


class PagedKVCacheView(NamedTuple):
    """Paged per-layer cache: a pool of pages + a per-slot page table.

    Pools are ``[P, page, H, D]`` in the compute dtype, or int8/uint8 codes
    with scale/zero pools ``[P, page, H, D/g]`` when quantized (``scales is
    None`` means 16-bit).  ``page_table`` is ``[B, MP]`` page ids; page 0
    is the reserved garbage page (idle slots, unallocated columns and
    dropped tokens point there; attention masks those columns out).
    ``length`` is always ``[B]``.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]
    k_zeros: Optional[torch.Tensor]
    v_scales: Optional[torch.Tensor]
    v_zeros: Optional[torch.Tensor]
    page_table: torch.Tensor
    length: torch.Tensor
    page_size: int
    bits: int = 16
    group: int = 128
    packed: bool = False
    valid: Optional[torch.Tensor] = None


CacheView = Union[KVCacheView, QuantKVCacheView, PagedKVCacheView]


class PageAllocator:
    """Host-side free list over the page pool (page 0 is reserved garbage).

    The device never allocates: the serve loop calls ``alloc`` as a slot's
    length crosses a page boundary and sends the updated table with the
    next sync's inputs.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1, 2, ...

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "KV page pool exhausted; raise KVCacheConfig.num_pages "
                "(need >= slots * ceil((prompt+max_new)/page_size) to "
                "guarantee admission-order progress)")
        return self._free.pop()

    def free(self, pages) -> None:
        self._free.extend(pages)


# ------------------------------------------------------------------ codec

def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[..., D] codes in [0, 15] -> [..., D/2] uint8, split-D lo/hi halves."""
    d = codes.shape[-1]
    return (codes[..., : d // 2] + codes[..., d // 2 :] * 16).to(torch.uint8)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., D/2] uint8 -> [..., D] int32 codes in [0, 15]."""
    p = packed.to(torch.int32)
    return torch.cat([p & 0xF, p >> 4], dim=-1)


def _encode(x: torch.Tensor, bits: int, group: int, packed: bool = False):
    """[B, S, H, D] -> codes int8 (or packed uint8), scales/zeros [B, S, H, D/g]."""
    b, s, h, d = x.shape
    g = min(group, d)
    rows = x.to(torch.float32).reshape(-1, g)
    codes, scales, zeros = encode_int(rows, bits, symmetric=False)
    scales = scales.reshape(b, s, h, d // g)
    if packed:
        return _pack_nibbles(codes.reshape(b, s, h, d)), scales, zeros.reshape(b, s, h, d // g)
    # asymmetric codes span [0, 2^bits - 1]; shifting by -2^(bits-1) fits
    # int8, and (code - zero) does not change under a common shift
    off = 1 << (bits - 1)
    return ((codes - off).to(torch.int8).reshape(b, s, h, d), scales,
            (zeros - off).reshape(b, s, h, d // g))


def _decode(codes, scales, zeros, d: int, dtype, packed: bool = False) -> torch.Tensor:
    """Codes [B, T, H, D(/2)] and scales/zeros [B, T, H, D/g] -> [B, T, H, D]
    in ``dtype``: ``(code - zero) * scale`` in f32, per group."""
    b, t, h, _ = codes.shape
    if packed:
        codes = _unpack_nibbles(codes)
    ng = scales.shape[-1]
    vals = decode_int(codes.to(torch.float32).reshape(b, t, h, ng, d // ng),
                      scales[..., None], zeros[..., None], symmetric=False)
    return vals.reshape(b, t, h, d).to(dtype)


def _quant_layout(kv_cfg: KVCacheConfig, head_dim: int):
    """(group, packed, stored head dim, code dtype) of a quantized cache."""
    g = min(kv_cfg.kv_group_size, head_dim)
    packed = kv_cfg.kv_bits == 4 and head_dim % 2 == 0
    return g, packed, head_dim // 2 if packed else head_dim, (
        torch.uint8 if packed else torch.int8)


# ------------------------------------------------------------------ caches

def make_caches(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    head_dim: int,
    kv_cfg: KVCacheConfig,
    dtype=torch.bfloat16,
    device=None,
) -> List[CacheView]:
    device = resolve_device(device)
    if kv_cfg.paged:
        return _make_paged_caches(n_layers, batch, n_kv_heads, head_dim, kv_cfg,
                                  dtype, device)
    t = kv_cfg.max_seq_len
    if kv_cfg.kv_bits >= 16:
        shape = (batch, t, n_kv_heads, head_dim)
        return [
            KVCacheView(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device), 0)
            for _ in range(n_layers)
        ]
    g, packed, d_store, code_dtype = _quant_layout(kv_cfg, head_dim)
    codes_shape = (batch, t, n_kv_heads, d_store)
    side_shape = (batch, t, n_kv_heads, head_dim // g)

    def half():
        return (torch.zeros(codes_shape, dtype=code_dtype, device=device),
                torch.ones(side_shape, dtype=torch.float32, device=device),
                torch.zeros(side_shape, dtype=torch.float32, device=device))

    return [QuantKVCacheView(*half(), *half(), 0, kv_cfg.kv_bits, g, packed)
            for _ in range(n_layers)]


def pages_per_seq(kv_cfg: KVCacheConfig) -> int:
    return -(-kv_cfg.max_seq_len // kv_cfg.page_size)


def pool_pages(batch: int, kv_cfg: KVCacheConfig) -> int:
    """Pool size in pages: configured, or worst case + 1 garbage page."""
    return kv_cfg.num_pages or (1 + batch * pages_per_seq(kv_cfg))


def _make_paged_caches(n_layers, batch, n_kv_heads, head_dim, kv_cfg, dtype, device):
    mp = pages_per_seq(kv_cfg)
    p = pool_pages(batch, kv_cfg)
    page = kv_cfg.page_size
    quant = kv_cfg.kv_bits < 16
    if quant:
        g, packed, d_store, code_dtype = _quant_layout(kv_cfg, head_dim)
    else:
        g, packed, d_store, code_dtype = kv_cfg.kv_group_size, False, head_dim, dtype
    # default table: the contiguous static allocation (slot b owns pages
    # 1 + b*mp .. (b+1)*mp, where they exist); generate() runs on it, and
    # serve() replaces it from its allocator
    table = (1 + torch.arange(batch, device=device)[:, None] * mp
             + torch.arange(mp, device=device)[None, :])
    table = torch.where(table < p, table, 0)
    side_shape = (p, page, n_kv_heads, head_dim // g)

    def sides():
        if not quant:
            return None, None
        return (torch.ones(side_shape, dtype=torch.float32, device=device),
                torch.zeros(side_shape, dtype=torch.float32, device=device))

    out = []
    for _ in range(n_layers):
        ks, kz = sides()
        vs, vz = sides()
        out.append(PagedKVCacheView(
            torch.zeros((p, page, n_kv_heads, d_store), dtype=code_dtype, device=device),
            torch.zeros((p, page, n_kv_heads, d_store), dtype=code_dtype, device=device),
            ks, kz, vs, vz, table,
            torch.zeros((batch,), dtype=torch.int64, device=device),
            page, kv_cfg.kv_bits if quant else 16, g, packed))
    return out


def _paged_update_and_fetch(cache: PagedKVCacheView, k_new, v_new):
    b, s, h, d = k_new.shape
    page = cache.page_size
    mp = cache.page_table.shape[1]
    dev = k_new.device

    # (page id, offset) of each of the S new tokens of each slot
    ar = torch.arange(s, device=dev)
    t = cache.length[:, None] + ar[None, :]  # [B, S]
    slot_page = torch.clamp(t // page, 0, mp - 1)
    pidx = torch.take_along_dim(cache.page_table, slot_page, dim=1)
    poff = t % page
    adv = s
    if cache.valid is not None:  # per-slot partial write (serve waves)
        invalid = ar[None, :] >= cache.valid[:, None]
        pidx = torch.where(invalid, 0, pidx)  # the garbage page
        poff = torch.where(invalid, 0, poff)
        adv = cache.valid

    if cache.bits < 16:
        news = (*_encode(k_new, cache.bits, cache.group, cache.packed),
                *_encode(v_new, cache.bits, cache.group, cache.packed))
        pools = (cache.k_pages, cache.k_scales, cache.k_zeros,
                 cache.v_pages, cache.v_scales, cache.v_zeros)
    else:
        news, pools = (k_new, v_new), (cache.k_pages, cache.v_pages)
    for pool, new in zip(pools, news):
        pool[pidx, poff] = new.to(pool.dtype)
    cache = cache._replace(length=cache.length + adv, valid=None)

    # one gather gives the slot-ordered timeline [B, MP*page, H, d];
    # unallocated columns read the garbage page and are masked out by the
    # attention mask built from the lengths
    def view(pool):
        g = pool[cache.page_table]  # [B, MP, page, H, d_store]
        return g.reshape(b, mp * page, h, g.shape[-1])

    if cache.bits < 16:
        k_all = _decode(view(cache.k_pages), view(cache.k_scales),
                        view(cache.k_zeros), d, k_new.dtype, cache.packed)
        v_all = _decode(view(cache.v_pages), view(cache.v_scales),
                        view(cache.v_zeros), d, v_new.dtype, cache.packed)
    else:
        k_all = view(cache.k_pages).to(k_new.dtype)
        v_all = view(cache.v_pages).to(v_new.dtype)
    return cache, k_all, v_all


class StackedCacheAt:
    """Layer ``idx``'s handle into a stacked (``[L, ...]``) cache view: the
    scan forwards thread the whole stacked view through the layers, and
    :func:`update_and_fetch` writes the new tokens into ``buf[idx]`` in
    place and reads ``buf[idx]`` back, a view, never a copy of the slab."""

    __slots__ = ("caches", "idx")

    def __init__(self, caches, idx: int):
        self.caches = caches
        self.idx = idx


def _stacked_update_and_fetch(caches, l: int, k_new: torch.Tensor, v_new: torch.Tensor):
    """Layer-``l`` append on a stacked cache view.

    ``length`` holds one entry a layer, the view's ``[L]`` or ``[L, B]``
    lengths as a tuple: Python ints (``generate``'s prefill), 0-d device
    tensors (``generate``'s decode chunks: the shared timeline on the
    device, so a chunk reads no value on the host) or ``[B]`` tensors
    (slot-local timelines, ``serve``); layer ``l``'s entry is replaced by
    its advanced length.
    ``valid`` (``[B]``) is shared by the layers and KEPT on write -- every
    layer of a wave reads the same mask -- and the engine clears it between
    the wave and the chunk phase.  Writes take the flat views' rule
    (``write_columns``): a start too close to the end is clamped so the S
    tokens fit.  The reference's stacked scatter drops such columns
    instead; they occur only in slots whose request has ended (``serve``
    refuses a request that would outgrow the cache), whose columns are
    written again before they are read, and the clamp needs fewer device
    operations a layer than a masked write.
    """
    if isinstance(caches, KVCacheView):
        bufs = (caches.k[l], caches.v[l])
        news = (k_new, v_new)
    elif isinstance(caches, QuantKVCacheView):
        bufs = tuple(b[l] for b in caches[:6])
        news = (*_encode(k_new, caches.bits, caches.group, caches.packed),
                *_encode(v_new, caches.bits, caches.group, caches.packed))
    else:
        raise NotImplementedError(
            f"stacked scan caches not supported for {type(caches).__name__}")
    length = caches.length
    new = write_columns(bufs, news, length[l], caches.valid)
    caches = caches._replace(length=length[:l] + (new,) + length[l + 1:])
    if isinstance(caches, KVCacheView):
        return caches, bufs[0].to(k_new.dtype), bufs[1].to(v_new.dtype)
    d = k_new.shape[-1]
    k_all = _decode(*bufs[:3], d, k_new.dtype, caches.packed)
    v_all = _decode(*bufs[3:], d, v_new.dtype, caches.packed)
    return caches, k_all, v_all


def update_and_fetch(cache: CacheView, k_new: torch.Tensor, v_new: torch.Tensor):
    """Append S new tokens; return (cache', k_all, v_all) in compute dtype."""
    if isinstance(cache, StackedCacheAt):
        new, k_all, v_all = _stacked_update_and_fetch(cache.caches, cache.idx, k_new, v_new)
        return StackedCacheAt(new, cache.idx), k_all, v_all
    if isinstance(cache, PagedKVCacheView):
        return _paged_update_and_fetch(cache, k_new, v_new)
    if isinstance(cache, KVCacheView):
        cache = update_kv_cache(cache, k_new, v_new)
        return cache, cache.k, cache.v
    d = k_new.shape[-1]
    kc, ks, kz = _encode(k_new, cache.bits, cache.group, cache.packed)
    vc, vs, vz = _encode(v_new, cache.bits, cache.group, cache.packed)
    bufs = cache[:6]
    length = write_columns(bufs, (kc, ks, kz, vc, vs, vz), cache.length, cache.valid)
    cache = cache._replace(length=length, valid=None)
    k_all = _decode(cache.k_codes, cache.k_scales, cache.k_zeros, d, k_new.dtype,
                    cache.packed)
    v_all = _decode(cache.v_codes, cache.v_scales, cache.v_zeros, d, v_new.dtype,
                    cache.packed)
    return cache, k_all, v_all


def make_stacked_caches(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    head_dim: int,
    kv_cfg: KVCacheConfig,
    dtype=torch.bfloat16,
    device=None,
):
    """One cache view with a leading layer axis, ``[L, B, T_max, ...]``,
    for the scan forwards: allocated whole (not L caches and a stack), its
    lengths a tuple of L zeros (see :func:`_stacked_update_and_fetch`).
    Paged caches have no stacked form."""
    if kv_cfg.paged:
        raise NotImplementedError(
            "paged KV caches do not compose with scan-over-layers params; use "
            "contiguous (quantized) caches for the scan path or flat layers for paging")
    device = resolve_device(device)
    t = kv_cfg.max_seq_len
    zero = (0,) * n_layers
    if kv_cfg.kv_bits >= 16:
        shape = (n_layers, batch, t, n_kv_heads, head_dim)
        return KVCacheView(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device), zero)
    g, packed, d_store, code_dtype = _quant_layout(kv_cfg, head_dim)
    codes_shape = (n_layers, batch, t, n_kv_heads, d_store)
    side_shape = (n_layers, batch, t, n_kv_heads, head_dim // g)

    def half():
        return (torch.zeros(codes_shape, dtype=code_dtype, device=device),
                torch.ones(side_shape, dtype=torch.float32, device=device),
                torch.zeros(side_shape, dtype=torch.float32, device=device))

    return QuantKVCacheView(*half(), *half(), zero, kv_cfg.kv_bits, g, packed)


def reset_caches(caches) -> None:
    """Return a cache set (a list of views, or one stacked view) to its
    state at allocation, in place: codes, pages and zeros to 0, scales to
    1, as :func:`make_caches` fills them.  The engine keeps its cache
    sets and resets them at the start of each call, so its CUDA graphs
    read the same buffers in every call.  The lengths, page tables and
    ``valid`` are left alone: a view's are never written in place (a write
    returns a view with the advanced length), so the kept views still hold
    those of allocation."""
    views = [caches] if hasattr(caches, "_fields") else caches
    skip = ("length", "valid", "page_table")
    for view in views:
        for name, t in zip(view._fields, view):
            if name not in skip and torch.is_tensor(t):
                t.fill_(1 if name.endswith("scales") else 0)


def cache_max_len(cache: CacheView) -> int:
    """T_max of a per-layer (``[B, T, ...]``) or stacked (``[L, B, T, ...]``)
    view."""
    if isinstance(cache, PagedKVCacheView):
        return cache.page_table.shape[1] * cache.page_size
    buf = cache.k_codes if isinstance(cache, QuantKVCacheView) else cache.k
    return buf.shape[1 if buf.dim() == 4 else 2]


def cache_bytes(caches) -> int:
    """Bytes the KV buffers of ``caches`` (a list of views, or one stacked
    view) hold: codes, pages, scales, zeros; not the lengths or page
    tables."""
    if hasattr(caches, "_fields"):
        caches = [caches]
    skip = ("length", "valid", "page_table")
    return sum(t.numel() * t.element_size() for c in caches
               for name, t in zip(c._fields, c) if name not in skip and torch.is_tensor(t))
