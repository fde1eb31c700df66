"""BLOOM family (port of ``models/bloom.py``): ALiBi attention, a tanh-GELU
MLP, LayerNorms (the embedding's too) and the lm_head tied to the token
embedding.  A checkpoint's fused query_key_value projection is split into
q, k and v at conversion time, so the attention path is the common one.

:func:`bloom_forward` runs the per-layer list ``params["layers"]``,
:func:`bloom_forward_scan` the layer-stacked ``params["layers_stacked"]``
(:func:`stack_bloom_layers`) with one stacked cache view.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .common import (
    KVCacheView,
    alibi_slopes,
    attend,
    cache_start,
    causal_mask,
    first_cache,
    layernorm,
    linear,
    run_layers,
    scan_forward,
    stack_model_layers,
)
from .opt import _row_tp

stack_bloom_layers = stack_model_layers


@dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 256) -> "BloomConfig":
        return BloomConfig(vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4)


def bloom_init(cfg: BloomConfig, generator: torch.Generator, dtype=torch.float32,
               device=None) -> Dict[str, Any]:
    """Random init drawn from ``generator`` (which must live on ``device``):
    the JAX package's shapes and scales, other numbers."""
    device = resolve_device(device)
    h = cfg.hidden_size

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    def dense(kin, kout):
        return {"w": (normal(kin, kout) * kin**-0.5).to(dtype),
                "b": torch.zeros((kout,), dtype=dtype, device=device)}

    def ln():
        return {"w": torch.ones((h,), dtype=dtype, device=device),
                "b": torch.zeros((h,), dtype=dtype, device=device)}

    layers = [{
        "attn_norm": ln(),
        "q": dense(h, h), "k": dense(h, h), "v": dense(h, h), "o": dense(h, h),
        "post_norm": ln(),
        "fc1": dense(h, 4 * h), "fc2": dense(4 * h, h),
    } for _ in range(cfg.num_layers)]
    return {
        "embed": (normal(cfg.vocab_size, h) * 0.02).to(dtype),
        "embed_norm": ln(),
        "layers": layers,
        "final_norm": ln(),
    }


@functools.lru_cache(maxsize=16)
def _slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """:func:`alibi_slopes` on ``device``, copied there once: a copy from
    the host every forward would synchronise the stream each step."""
    return alibi_slopes(n_heads, device)


def _alibi_bias(cfg: BloomConfig, t: int, device, head_shard=(0, 1)) -> torch.Tensor:
    """[1, H, 1, T] bias: slope_h * key position (shift-invariant by row).
    ``head_shard`` = (i, d): ``cfg`` holds shard ``i`` of ``d`` of the
    heads, which take slopes ``[i * H, (i + 1) * H)`` of the ``d * H``."""
    i, d = head_shard
    h = cfg.num_heads
    slopes = _slopes_on(h * d, torch.device(device))[i * h:(i + 1) * h]
    return (slopes[:, None, None]
            * torch.arange(t, dtype=torch.float32, device=device)[None, None, :])[None]


def _block(x, p, cfg: BloomConfig, mask, bias, cache, reduce=None):
    """One BLOOM block.  ``reduce`` is the tensor-parallel seam of
    ``models.opt._row_tp`` (``bias`` then this shard's ALiBi heads)."""
    b, s, _ = x.shape
    hd = cfg.hd
    h_out = cfg.num_heads * hd
    residual = x
    x = layernorm(x, p["attn_norm"]["w"], p["attn_norm"]["b"], cfg.layer_norm_eps)
    q = linear(x, p["q"]).reshape(b, s, cfg.num_heads, hd)
    k = linear(x, p["k"]).reshape(b, s, cfg.num_heads, hd)
    v = linear(x, p["v"]).reshape(b, s, cfg.num_heads, hd)
    if cache is not None:
        from ..engine.kvcache import update_and_fetch

        cache, k, v = update_and_fetch(cache, k, v)
    attn = attend(q, k, v, mask, bias=bias)
    x = residual + _row_tp(attn.reshape(b, s, h_out), p["o"], reduce)

    residual = x
    x = layernorm(x, p["post_norm"]["w"], p["post_norm"]["b"], cfg.layer_norm_eps)
    x = F.gelu(linear(x, p["fc1"]).to(torch.float32), approximate="tanh").to(residual.dtype)
    x = residual + _row_tp(x, p["fc2"], reduce)
    return x, cache


def bloom_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: BloomConfig,
    caches: Optional[List[KVCacheView]] = None,
    positions: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[List[KVCacheView]]]:
    """Full or incremental forward.  Returns (logits [B, S, V], caches).
    Runs on the device the params lie on; ``tokens`` are moved there.
    ``positions`` only shape the default mask: ALiBi needs no position."""
    return _forward(params, tokens, cfg, caches, positions, attn_mask, scan=False)


@scan_forward
def bloom_forward_scan(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: BloomConfig,
    caches=None,  # one stacked cache view ([L, ...] buffers), or None
    positions: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Any]]:
    """:func:`bloom_forward` over :func:`stack_bloom_layers` params: a loop
    over the layer index, the stacked kernels reading each layer in place."""
    return _forward(params, tokens, cfg, caches, positions, attn_mask, scan=True)


def _forward(params, tokens, cfg, caches, positions, attn_mask, scan: bool,
             reduce=None, head_shard=(0, 1)):
    """The forward of both layouts; ``reduce`` and ``head_shard`` are the
    tensor-parallel seams of :func:`_block` and :func:`_alibi_bias`
    (``parallel.tp_block``: ``cfg`` shard-local)."""
    embed = params["embed"]
    dev = embed.device
    tokens = tokens.to(dev)
    s = tokens.shape[1]
    if caches is None:
        mask = causal_mask(s, device=dev) if attn_mask is None else attn_mask
        t = s
    else:
        from ..engine.kvcache import cache_max_len

        t = cache_max_len(first_cache(caches))
        if attn_mask is None:
            if positions is None:
                qpos = cache_start(caches) + torch.arange(s, device=dev)
            else:
                qpos = positions.to(dev)
            mask = (torch.arange(t, device=dev)[None, :] <= qpos[:, None])[None, None]
        else:
            mask = attn_mask
    bias = _alibi_bias(cfg, t, dev, head_shard)

    x = layernorm(embed[tokens], params["embed_norm"]["w"], params["embed_norm"]["b"],
                  cfg.layer_norm_eps)
    x, new_caches = run_layers(x, params, caches,
                               lambda x, p, c: _block(x, p, cfg, mask, bias, c, reduce),
                               scan)
    x = layernorm(x, params["final_norm"]["w"], params["final_norm"]["b"], cfg.layer_norm_eps)
    logits = x @ embed.t().to(x.dtype)  # tied lm_head
    return logits, new_caches
