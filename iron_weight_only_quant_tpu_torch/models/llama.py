"""LLaMA family (port of ``models/llama.py``): RMSNorm, RoPE, SwiGLU, GQA.

Functional, as in the JAX package: ``params`` is a dict whose linear weights
are dense ``[K, N]`` tensors or packed :class:`QuantizedTensor` artifacts.
:func:`llama_forward` runs the per-layer list ``params["layers"]``,
:func:`llama_forward_scan` the layer-stacked ``params["layers_stacked"]``
(:func:`stack_llama_layers`) with one stacked cache view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .common import (
    FusedLinear,
    KVCacheView,
    apply_rope,
    attend,
    linear,
    positions_and_mask,
    rmsnorm,
    rope_tables,
    run_layers,
    scan_forward,
    stack_model_layers,
)

stack_llama_layers = stack_model_layers


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # RoPE position interpolation (positions divided by the ratio)
    condense_ratio: float = 1.0
    tie_word_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_70b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=8192, intermediate_size=28672, num_layers=80,
            num_heads=64, num_kv_heads=8, max_position_embeddings=4096,
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=128,
        )


def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random init (for tests and the chip smoke run), drawn from
    ``generator``, which must live on ``device``.

    Same shapes and scales as the JAX package's ``llama_init``; the numbers
    differ (another generator), so parity tests build params once with
    numpy and carry them across with ``interop.params_from_numpy``.
    """
    device = resolve_device(device)
    h, inter, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    def dense(kin, kout):
        return {"w": (normal(kin, kout) * kin**-0.5).to(dtype), "b": None}

    def ones():
        return torch.ones((h,), dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_norm": ones(),
            "q": dense(h, qdim),
            "k": dense(h, kvdim),
            "v": dense(h, kvdim),
            "o": dense(qdim, h),
            "post_norm": ones(),
            "gate": dense(h, inter),
            "up": dense(h, inter),
            "down": dense(inter, h),
        })
    params = {
        "embed": (normal(cfg.vocab_size, h) * 0.02).to(dtype),
        "layers": layers,
        "final_norm": ones(),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size)
    return params


def _block(
    x: torch.Tensor,
    p: Dict[str, Any],
    cfg: LlamaConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    cache: Optional[KVCacheView],
    reduce=None,
) -> Tuple[torch.Tensor, Optional[KVCacheView]]:
    """One transformer block.  ``reduce`` (optional) is applied to the o and
    down projection outputs before the residual add: the tensor-parallel
    seam, where each rank computes a partial row-parallel output and
    ``reduce`` is the all-reduce over the model ranks
    (``parallel.tp_block``); ``cfg`` then carries shard-local head counts."""
    b, s, h = x.shape
    hd = cfg.hd

    # a None norm weight means its gamma was folded into the following
    # projections (fold_llama_norms): the weightless rmsnorm then runs
    # inside the dequant-matmul kernel (pre_norm)
    pre_attn = cfg.rms_norm_eps if p.get("input_norm") is None else None
    attn_in = x if pre_attn is not None else rmsnorm(
        x, p["input_norm"], cfg.rms_norm_eps)
    if "qkv" in p:
        q, k, v = p["qkv"].apply(attn_in, pre_norm=pre_attn)
    else:
        q = linear(attn_in, p["q"], pre_norm=pre_attn)
        k = linear(attn_in, p["k"], pre_norm=pre_attn)
        v = linear(attn_in, p["v"], pre_norm=pre_attn)
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        from ..engine.kvcache import update_and_fetch

        cache, k, v = update_and_fetch(cache, k, v)
    attn = attend(q, k, v, mask)
    o_out = linear(attn.reshape(b, s, cfg.num_heads * hd), p["o"])
    if reduce is not None:
        o_out = reduce(o_out)
    x = x + o_out

    pre_mlp = cfg.rms_norm_eps if p.get("post_norm") is None else None
    mlp_in = x if pre_mlp is not None else rmsnorm(
        x, p["post_norm"], cfg.rms_norm_eps)
    if "gate_up" in p:
        gate, up = p["gate_up"].apply(mlp_in, pre_norm=pre_mlp)
    else:
        gate = linear(mlp_in, p["gate"], pre_norm=pre_mlp)
        up = linear(mlp_in, p["up"], pre_norm=pre_mlp)
    gate = F.silu(gate.to(torch.float32)).to(x.dtype)
    down_out = linear(gate * up, p["down"])
    if reduce is not None:
        down_out = reduce(down_out)
    x = x + down_out
    return x, cache


def llama_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # [B, S] integer
    cfg: LlamaConfig,
    caches: Optional[List[KVCacheView]] = None,
    positions: Optional[torch.Tensor] = None,  # [B, S] or [S]
    attn_mask: Optional[torch.Tensor] = None,  # [B|1, 1, S, T] overrides default
) -> Tuple[torch.Tensor, Optional[List[KVCacheView]]]:
    """Full or incremental forward.  Returns (logits [B, S, V], caches).

    Runs on the device the params lie on; ``tokens`` are moved there.
    """
    return _forward(params, tokens, cfg, caches, positions, attn_mask, scan=False)


@scan_forward
def llama_forward_scan(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    caches=None,  # one stacked cache view ([L, ...] buffers), or None
    positions: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Any]]:
    """:func:`llama_forward` over layer-stacked params: a loop over the
    layer index into the ``[L, ...]`` buffers, the stacked kernels reading
    each layer's packed weights in place.  ``caches`` is one stacked view
    (``engine.kvcache.make_stacked_caches``)."""
    return _forward(params, tokens, cfg, caches, positions, attn_mask, scan=True)


def _forward(params, tokens, cfg, caches, positions, attn_mask, scan: bool,
             reduce=None):
    """The forward of both layouts; ``reduce`` is the tensor-parallel seam
    of :func:`_block` (``parallel.tp_block``: ``cfg`` shard-local, the
    lm_head this rank's vocab slice)."""
    embed = params["embed"]
    dev = embed.device
    tokens = tokens.to(dev)
    s = tokens.shape[1]
    x = embed[tokens]
    positions, mask = positions_and_mask(caches, s, positions, attn_mask, dev)
    cos, sin = rope_tables(positions.to(dev), cfg.hd, cfg.rope_theta,
                           cfg.condense_ratio)

    x, new_caches = run_layers(
        x, params, caches, lambda x, p, c: _block(x, p, cfg, cos, sin, mask, c, reduce),
        scan)
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        logits = x @ embed.t().to(x.dtype)
    else:
        logits = linear(x, params["lm_head"])
    return logits, new_caches


def fold_llama_norms(params: Dict[str, Any]) -> Dict[str, Any]:
    """Absorb each rmsnorm's gamma into the following projections' weights.

    ``rmsnorm(x, g) @ W == rmsnorm(x, 1) @ (diag(g) W)`` exactly, so serving
    runs the weightless norm inside the kernel (``linear(..., pre_norm=eps)``).
    Folded layers carry ``input_norm = post_norm = None``, the marker
    :func:`_block` keys on.  Apply to dense weights, before quantization.
    """
    from ..quantize.qtensor import QuantizedTensor

    def fold(lin, gamma):
        w = lin["w"]
        if isinstance(w, QuantizedTensor):
            raise ValueError(
                "fold_llama_norms must run on dense weights, before "
                "quantization")
        return {**lin, "w": (w.to(torch.float32)
                             * gamma.to(torch.float32)[:, None]).to(w.dtype)}

    layers = []
    for p in params["layers"]:
        p = dict(p)
        if p.get("input_norm") is not None:
            g = p["input_norm"]
            for key in ("q", "k", "v"):
                p[key] = fold(p[key], g)
            p["input_norm"] = None
        if p.get("post_norm") is not None:
            g = p["post_norm"]
            for key in ("gate", "up"):
                p[key] = fold(p[key], g)
            p["post_norm"] = None
        layers.append(p)
    return {**params, "layers": layers}


def fuse_llama_projections(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse q|k|v and gate|up into single wide packed artifacts per layer.

    Exact: per-group quantization is independent per output column.  Only
    packed, bias-free linears fuse; anything else is left as it is.
    """
    return {**params,
            "layers": [fuse_llama_layer(p) for p in params["layers"]]}


def fuse_llama_layer(p: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse one layer dict's q|k|v and gate|up (see
    :func:`fuse_llama_projections`)."""
    from ..quantize.qtensor import QuantizedTensor, concat_n, stored_spans

    def try_fuse(p, names):
        if not all(n in p for n in names):
            return None
        ws = [p[n]["w"] for n in names]
        if not all(isinstance(w, QuantizedTensor) for w in ws):
            return None
        if any(p[n].get("b") is not None for n in names):
            return None
        try:
            fused = concat_n(ws)
        except ValueError:
            return None
        return FusedLinear(fused, None, stored_spans(ws))

    p = dict(p)
    qkv = try_fuse(p, ("q", "k", "v"))
    if qkv is not None:
        p["qkv"] = qkv
        del p["q"], p["k"], p["v"]
    gu = try_fuse(p, ("gate", "up"))
    if gu is not None:
        p["gate_up"] = gu
        del p["gate"], p["up"]
    return p
