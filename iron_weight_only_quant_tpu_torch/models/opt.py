"""OPT family (port of ``models/opt.py``): a decoder with LayerNorm before
(or after) each sub-block, learned positions at an offset of 2, a ReLU FFN
and the lm_head tied to the token embedding.

:func:`opt_forward` runs the per-layer list ``params["layers"]``,
:func:`opt_forward_scan` the layer-stacked ``params["layers_stacked"]``
(:func:`stack_opt_layers`) with one stacked cache view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from .common import (
    KVCacheView,
    StackedLinear,
    attend,
    layernorm,
    linear,
    positions_and_mask,
    run_layers,
    scan_forward,
    stack_model_layers,
)

stack_opt_layers = stack_model_layers

POS_OFFSET = 2  # the offset of the learned position table (HF OPT)


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def opt_125m() -> "OPTConfig":
        return OPTConfig()

    @staticmethod
    def opt_6_7b() -> "OPTConfig":
        return OPTConfig(hidden_size=4096, ffn_dim=16384, num_layers=32, num_heads=32)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "OPTConfig":
        return OPTConfig(
            vocab_size=vocab_size, hidden_size=64, ffn_dim=128,
            num_layers=2, num_heads=4, max_position_embeddings=128,
        )


def opt_init(cfg: OPTConfig, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
    """Random init drawn from ``generator`` (which must live on ``device``):
    the JAX package's shapes and scales, other numbers (parity tests carry
    numpy params across with ``interop.params_from_numpy``)."""
    device = resolve_device(device)
    h, f = cfg.hidden_size, cfg.ffn_dim

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
        "final_norm": ln(),
        "fc1": dense(h, f), "fc2": dense(f, h),
    } for _ in range(cfg.num_layers)]
    return {
        "embed": (normal(cfg.vocab_size, h) * 0.02).to(dtype),
        "embed_pos": (normal(cfg.max_position_embeddings + POS_OFFSET, h) * 0.02).to(dtype),
        "layers": layers,
        "final_norm": ln(),
    }


def _row_tp(x: torch.Tensor, lin: Any, reduce=None) -> torch.Tensor:
    """A row-parallel linear: without ``reduce`` the plain linear; with it
    (the tensor-parallel seam, ``parallel.tp_block``) the product without the
    bias, ``reduce`` (the all-reduce over the model axis), then the bias
    once -- adding it on every shard before the reduce would count it d
    times.  ``lin`` is a param dict or a :class:`StackedLinear`."""
    if reduce is None:
        return linear(x, lin)
    if isinstance(lin, StackedLinear):
        b = lin.p.get("b")
        bias = None if b is None else b[lin.idx]
        part = linear(x, StackedLinear({**lin.p, "b": None}, lin.idx))
    else:
        bias = lin.get("b")
        part = linear(x, {**lin, "b": None})
    out = reduce(part)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _block(x, p, cfg: OPTConfig, mask, cache, reduce=None):
    """One OPT block, LayerNorm before (``do_layer_norm_before``) or after
    each sub-block.  ``reduce`` is the tensor-parallel seam of
    :func:`_row_tp` (``cfg`` then carries shard-local head counts)."""
    b, s, _ = x.shape
    hd = cfg.hd
    h_out = cfg.num_heads * hd
    residual = x
    if cfg.do_layer_norm_before:
        x = layernorm(x, p["attn_norm"]["w"], p["attn_norm"]["b"], cfg.layer_norm_eps)
    q = linear(x, p["q"]).reshape(b, s, cfg.num_heads, hd)
    k = linear(x, p["k"]).reshape(b, s, cfg.num_heads, hd)
    v = linear(x, p["v"]).reshape(b, s, cfg.num_heads, hd)
    if cache is not None:
        from ..engine.kvcache import update_and_fetch

        cache, k, v = update_and_fetch(cache, k, v)
    attn = attend(q, k, v, mask)
    x = residual + _row_tp(attn.reshape(b, s, h_out), p["o"], reduce)
    if not cfg.do_layer_norm_before:
        x = layernorm(x, p["attn_norm"]["w"], p["attn_norm"]["b"], cfg.layer_norm_eps)

    residual = x
    if cfg.do_layer_norm_before:
        x = layernorm(x, p["final_norm"]["w"], p["final_norm"]["b"], cfg.layer_norm_eps)
    x = torch.relu(linear(x, p["fc1"]))
    x = residual + _row_tp(x, p["fc2"], reduce)
    if not cfg.do_layer_norm_before:
        x = layernorm(x, p["final_norm"]["w"], p["final_norm"]["b"], cfg.layer_norm_eps)
    return x, cache


def opt_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: OPTConfig,
    caches: Optional[List[KVCacheView]] = None,
    positions: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[List[KVCacheView]]]:
    """Full or incremental forward.  Returns (logits [B, S, V], caches).
    Runs on the device the params lie on; ``tokens`` are moved there."""
    return _forward(params, tokens, cfg, caches, positions, attn_mask, scan=False)


@scan_forward
def opt_forward_scan(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: OPTConfig,
    caches=None,  # one stacked cache view ([L, ...] buffers), or None
    positions: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Any]]:
    """:func:`opt_forward` over :func:`stack_opt_layers` params: a loop over
    the layer index, the stacked kernels reading each layer in place."""
    return _forward(params, tokens, cfg, caches, positions, attn_mask, scan=True)


def _forward(params, tokens, cfg, caches, positions, attn_mask, scan: bool,
             reduce=None):
    """The forward of both layouts; ``reduce`` is the tensor-parallel seam
    of :func:`_block` (``parallel.tp_block``: ``cfg`` shard-local; the tied
    head reads the whole embedding, so the logits are whole)."""
    embed = params["embed"]
    dev = embed.device
    tokens = tokens.to(dev)
    positions, mask = positions_and_mask(caches, tokens.shape[1], positions, attn_mask, dev)
    x = embed[tokens] + params["embed_pos"][positions.to(dev) + POS_OFFSET]
    x, new_caches = run_layers(x, params, caches,
                               lambda x, p, c: _block(x, p, cfg, mask, c, reduce), scan)
    if cfg.do_layer_norm_before and "final_norm" in params:
        x = layernorm(x, params["final_norm"]["w"], params["final_norm"]["b"],
                      cfg.layer_norm_eps)
    logits = x @ embed.t().to(x.dtype)  # tied lm_head
    return logits, new_caches
