"""KV caches (port of ``engine/kvcache.py``, contiguous caches only).

A cache is one :class:`~..models.common.KVCacheView` per layer holding
``[B, T_max, H_kv, D]`` buffers in the compute dtype.  The buffers are
updated in place (see ``models.common.update_kv_cache``).  The quantized
int8/int4 caches and the paged cache are still to be ported (ROADMAP
queue A); asking for them raises.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import KVCacheConfig
from ..device import resolve_device
from ..models.common import KVCacheView, update_kv_cache


def make_caches(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    head_dim: int,
    kv_cfg: KVCacheConfig,
    dtype=torch.bfloat16,
    device=None,
) -> List[KVCacheView]:
    device = resolve_device(device)
    if kv_cfg.paged:
        raise NotImplementedError(
            "paged KV caches are not ported yet (ROADMAP queue A, 'Quantized "
            "and paged KV')")
    if kv_cfg.kv_bits < 16:
        raise NotImplementedError(
            f"kv_bits={kv_cfg.kv_bits}: quantized KV caches are not ported "
            "yet (ROADMAP queue A, 'Quantized and paged KV'); use kv_bits=16")
    shape = (batch, kv_cfg.max_seq_len, n_kv_heads, head_dim)
    return [
        KVCacheView(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device), 0)
        for _ in range(n_layers)
    ]


def update_and_fetch(cache: KVCacheView, k_new: torch.Tensor,
                     v_new: torch.Tensor):
    """Append S new tokens; return (cache', k_all, v_all) in compute dtype."""
    if not isinstance(cache, KVCacheView):
        raise NotImplementedError(
            f"{type(cache).__name__}: only contiguous KV caches are ported")
    cache = update_kv_cache(cache, k_new, v_new)
    return cache, cache.k, cache.v


def cache_max_len(cache: KVCacheView) -> int:
    """T_max of a per-layer ``[B, T, H, D]`` view."""
    return cache.k.shape[1]
