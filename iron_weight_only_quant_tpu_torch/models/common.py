"""Shared model building blocks (port of ``models/common.py``).

Plain PyTorch ops, eager.  Attention, RoPE, norms and KV writes were plain
XLA in the reference, not kernels, so they are plain torch ops here too;
the only kernels on the model path are the dequant-matmuls behind
:func:`linear`.

Layer-stacked params (the scan path): :func:`stack_model_layers` turns the
per-layer list ``params["layers"]`` into one dict ``params["layers_stacked"]``
whose tensors carry a leading ``[L, ...]`` axis; :func:`stacked_layer_view`
gives one layer's view of it, in which the linears stay in place
(:class:`StackedLinear`, :class:`StackedFusedView`) and the stacked kernels
read layer ``l`` of the ``[L, ...]`` buffers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..ops.qmatmul import _rms_nogamma, quantized_matmul, quantized_matmul_stacked
from ..quantize.qtensor import QuantizedTensor


_LINEAR_RECORDER: Optional[Callable[[str, torch.Tensor], None]] = None


class recording_linears:
    """Context manager: call ``cb(name, x)`` with the input of every named
    linear (the calibration seam, the functional counterpart of the
    reference's forward hooks, gptq_utils.py:153-160).

    Only linear param dicts that carry a ``"name"`` key are recorded
    (``quantize.gptq_model.annotate_linears``), never a
    :class:`StackedLinear` or a :class:`FusedLinear`.  With a ``pre_norm``
    the callback receives the normalized input, also where the quantized
    path would normalize inside the kernel.  With no recorder set,
    :func:`linear` does no work for it.
    """

    def __init__(self, cb: Callable[[str, torch.Tensor], None]):
        self.cb = cb

    def __enter__(self):
        global _LINEAR_RECORDER
        self._prev = _LINEAR_RECORDER
        _LINEAR_RECORDER = self.cb
        return self

    def __exit__(self, *exc):
        global _LINEAR_RECORDER
        _LINEAR_RECORDER = self._prev
        return False


@dataclass
class FusedLinear:
    """Several projections sharing one input, packed as ONE artifact.

    Built by ``concat_n`` over the member weights; ``spans`` are the
    (start, end) column ranges of each member's logical output inside the
    fused (padding-inclusive) output width.
    """

    w: Any
    b: Optional[torch.Tensor]
    spans: Tuple[Tuple[int, int], ...]

    def apply(self, x: torch.Tensor,
              pre_norm: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
        y = linear(x, {"w": self.w, "b": self.b}, pre_norm=pre_norm)
        return tuple(y[..., a:b] for a, b in self.spans)


class StackedLinear:
    """One layer's linear inside a layer-stacked param dict: the whole
    stacked ``{"w", "b"}`` and the layer index, so :func:`linear` sends a
    quantized weight to the stacked kernel, which reads layer ``idx`` of the
    ``[L, ...]`` buffers in place (no copy of the layer's weights)."""

    __slots__ = ("p", "idx")

    def __init__(self, p: Dict[str, Any], idx: int):
        self.p = p
        self.idx = idx


class StackedFusedView:
    """One layer's view of a layer-stacked :class:`FusedLinear`: ``apply``
    runs the stacked kernel on layer ``idx`` and slices the member spans, so
    the scan path keeps the fused projections."""

    __slots__ = ("fl", "idx")

    def __init__(self, fl: FusedLinear, idx: int):
        self.fl = fl
        self.idx = idx

    def apply(self, x: torch.Tensor,
              pre_norm: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
        b = self.fl.b
        if b is not None:
            b = b[self.idx]
        y = quantized_matmul_stacked(x, self.fl.w, self.idx, bias=b, pre_norm=pre_norm)
        return tuple(y[..., a:e] for a, e in self.fl.spans)


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of a param subtree (None, tensors, dicts,
    :class:`QuantizedTensor` and :class:`FusedLinear`; their static fields
    come from ``tree``), with the matching leaves of ``rest``."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.replace(**{f: _tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                               for f in ("qweight", "scales", "zeros", "codebook")})
    if isinstance(tree, FusedLinear):
        return FusedLinear(_tree_map(fn, tree.w, *(r.w for r in rest)),
                           _tree_map(fn, tree.b, *(r.b for r in rest)), tree.spans)
    raise TypeError(f"cannot stack a {type(tree).__name__}")


def stack_model_layers(params: Dict[str, Any], consume: bool = False,
                       tp_segments: bool = False) -> Dict[str, Any]:
    """Stack the per-layer param list into one dict with a leading ``[L]``
    axis on every tensor (``params["layers_stacked"]``), for the scan
    forwards.  Packed artifacts stack to ``[L, ...]`` tensors that the
    stacked kernels index in place.

    Each kind of leaf fills a preallocated ``[L, ...]`` buffer layer by
    layer.  ``consume=True`` pops each projection out of the caller's layer
    dicts as it is stacked and drops the caller's ``layers``, so the
    per-layer tensors can free as they go, rather than the whole model
    existing twice.  ``tp_segments`` pads ``k_shards > 1`` side info per K
    segment (:func:`pad_stacked_sides`).
    """
    layers = params["layers"]
    if not consume:
        layers = [dict(l) for l in layers]
    n_layers = len(layers)
    stacked = {}
    for key in list(layers[0].keys()):
        vals = [l.pop(key) for l in layers]
        bufs = _tree_map(lambda a: torch.empty((n_layers,) + tuple(a.shape),
                                               dtype=a.dtype, device=a.device), vals[0])
        for i in range(n_layers):
            _tree_map(lambda b, a: b[i].copy_(a), bufs, vals[i])
            vals[i] = None  # this layer's leaves may free now
        stacked[key] = pad_stacked_sides(bufs, tp_segments)
        del vals, bufs
    out = {k: v for k, v in params.items() if k != "layers"}
    if consume:
        params.pop("layers", None)
    out["layers_stacked"] = stacked
    return out


def pad_stacked_sides(v: Any, tp_segments: bool = False) -> Any:
    """Pad a stacked linear's grouped side-info rows (scales, zeros) to a
    multiple of 8, once at stack time, and record the pad in ``side_pad``
    (consumers drop those rows).  The reference's TPU kernels needed row
    counts divisible by 8; the port's kernels simply never read the pad
    rows, and the pad keeps the stacked artifact byte-equal to the JAX
    package's.  Left as they are: other storage than 4 and 8 bits, a
    single side row, an artifact padded already, ``k_shards > 1`` without
    ``tp_segments``, and broadcast ``[L, 1, 1]`` zeros.

    With ``tp_segments`` each of the ``k_shards`` contiguous row segments is
    padded on its own, so a K slice hands every shard a self-contained side
    block; ``side_pad`` then means the per-segment pad, which only the
    shard-local views read.
    """
    from ..ops.qmatmul import packed_bits

    if isinstance(v, FusedLinear):
        return FusedLinear(pad_stacked_sides({"w": v.w}, tp_segments)["w"], v.b, v.spans)
    if not (isinstance(v, dict) and isinstance(v.get("w"), QuantizedTensor)):
        return v
    qt = v["w"]
    rows = qt.scales.shape[1]
    if (qt.qweight.dim() != 3 or packed_bits(qt) not in (4, 8)
            or qt.side_pad or rows <= 1):
        return v
    shards = qt.k_shards
    if shards > 1 and not tp_segments:
        return v
    if rows % shards:
        return v
    rows_per = rows // shards
    pad = (-rows_per) % 8
    if pad == 0:
        return v
    if qt.zeros is not None and qt.zeros.shape[1] != rows:
        return v

    def pr(a):
        if a is None:
            return None
        if shards == 1:
            return torch.nn.functional.pad(a, (0, 0, 0, pad))
        l, _, n = a.shape
        seg = torch.nn.functional.pad(a.reshape(l, shards, rows_per, n), (0, 0, 0, pad))
        return seg.reshape(l, shards * (rows_per + pad), n)

    return {**v, "w": qt.replace(scales=pr(qt.scales), zeros=pr(qt.zeros), side_pad=pad)}


def _is_stacked_linear(v: Any) -> bool:
    if not (isinstance(v, dict) and "w" in v):
        return False
    w = v["w"]
    return isinstance(w, QuantizedTensor) or (torch.is_tensor(w) and w.dim() == 3)


def stacked_layer_view(stacked: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s param view of a stacked dict: linears become
    :class:`StackedLinear` / :class:`StackedFusedView` (weights stay in
    place), every other tensor (norm vectors, ``{"w", "b"}`` norm dicts) is
    indexed, a view."""
    lp = {}
    for name, v in stacked.items():
        if v is None:  # folded norm weights (fold_llama_norms)
            lp[name] = None
        elif isinstance(v, FusedLinear):
            lp[name] = StackedFusedView(v, l)
        elif _is_stacked_linear(v):
            lp[name] = StackedLinear(v, l)
        elif isinstance(v, dict):
            lp[name] = _tree_map(lambda a: a[l], v)
        else:
            lp[name] = v[l]
    return lp


def stacked_depth(stacked: Dict[str, Any]) -> int:
    """Number of layers of a stacked dict: the leading size of its first
    tensor (folded params carry None norms)."""
    for v in stacked.values():
        found = []
        _tree_map(lambda a: found.append(a.shape[0]), v)
        if found:
            return found[0]
    raise ValueError("a stacked param dict without tensors")


def scan_forward(fn: Callable) -> Callable:
    """Mark ``fn`` as a forward over layer-stacked params: the engine reads
    the mark (:func:`is_scan_forward`), not the function's name, to stack
    flat params and to make stacked caches for it."""
    fn.scan_layers = True
    return fn


def is_scan_forward(fn: Callable) -> bool:
    return bool(getattr(fn, "scan_layers", False))


def run_layers(x: torch.Tensor, params: Dict[str, Any], caches, block: Callable,
               scan: bool):
    """The layer loop of a forward: ``block(x, layer_params, cache)`` ->
    ``(x, cache)`` over ``params["layers"]`` with a per-layer cache list,
    or, with ``scan``, over the layer index of ``params["layers_stacked"]``
    with one stacked cache view (each layer gets a
    ``engine.kvcache.StackedCacheAt``).  Returns (x, caches)."""
    if scan:
        from ..engine.kvcache import StackedCacheAt

        stacked = params["layers_stacked"]
        for l in range(stacked_depth(stacked)):
            at = None if caches is None else StackedCacheAt(caches, l)
            x, at = block(x, stacked_layer_view(stacked, l), at)
            if at is not None:
                caches = at.caches
        return x, caches
    new_caches = None if caches is None else []
    for i, p in enumerate(params["layers"]):
        x, c = block(x, p, None if caches is None else caches[i])
        if new_caches is not None:
            new_caches.append(c)
    return x, new_caches


def linear(x: torch.Tensor, p: Any,
           pre_norm: Optional[float] = None) -> torch.Tensor:
    """Apply a linear layer whose weight is dense ``[K, N]`` or quantized;
    ``p`` is a param dict or a :class:`StackedLinear` (a quantized weight
    then takes the stacked kernel, a dense ``[L, K, N]`` one ``w[idx]``).

    ``pre_norm`` (the RMS eps) applies a weightless RMSNorm to x first --
    inside the kernel for quantized weights on the card.  The norm gamma
    must already be folded into the weights (``fold_llama_norms``).
    """
    if isinstance(p, StackedLinear):
        w, b = p.p["w"], p.p.get("b")
        if b is not None:
            b = b[p.idx]
        if isinstance(w, QuantizedTensor):
            return quantized_matmul_stacked(x, w, p.idx, bias=b, pre_norm=pre_norm)
        w = w[p.idx]
    else:
        if _LINEAR_RECORDER is not None and "name" in p:
            _LINEAR_RECORDER(p["name"], x if pre_norm is None else _rms_nogamma(x, pre_norm))
        w, b = p["w"], p.get("b")
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, bias=b, pre_norm=pre_norm)
    if pre_norm is not None:
        x = _rms_nogamma(x, pre_norm)
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm in f32, the reference's order: mean, population variance
    (``jnp.var``: ``correction=0``), ``rsqrt``, then gamma and beta."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


# ------------------------------------------------------------------ RoPE

def rope_tables(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    condense_ratio: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., head_dim]`` (half-rotation convention), on
    ``positions``' device.

    ``condense_ratio > 1`` is RoPE position interpolation: positions are
    divided by the ratio before the frequency product.
    """
    dev = positions.device
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    # a Python-scalar base: a tensor made from theta on a CUDA device would
    # be a host->device copy, which synchronises the stream every step
    inv_freq = 1.0 / torch.pow(float(theta), exps)
    t = positions.to(torch.float32) / condense_ratio
    freqs = t[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D] or [S, D]."""
    if cos.dim() == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.to(torch.float32) * cos + rotated.to(torch.float32) * sin).to(x.dtype)


# ------------------------------------------------------------- attention

class KVCacheView(NamedTuple):
    """Per-layer cache slab: k/v ``[B, T_max, H_kv, D]`` + current length.

    ``length`` is a Python int or a 0-d int tensor on the device (one
    shared timeline: ``generate``'s prefill, its decode chunks) or a
    ``[B]`` int tensor (slot-local timelines).  ``valid`` (optional, ``[B]``, slot-local only)
    marks how many of the next write's S tokens are real per slot: writes
    beyond a slot's count are dropped and its length advances by the count.
    The stacked form of the scan path has ``[L, B, T_max, H_kv, D]`` buffers
    and a tuple of L lengths, each of those kinds
    (``engine.kvcache.make_stacked_caches``).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor]
    valid: Optional[torch.Tensor] = None


def attend(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    mask: torch.Tensor,  # [B|1, 1, S, T] boolean (True = keep)
    *,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention with GQA head expansion and f32 accumulation.

    The reference's op order: f32 scores, masked with the f32 minimum, f32
    softmax, probabilities cast to ``v.dtype``, f32 product, cast to
    ``q.dtype``.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if bias is not None:
        scores = scores + bias
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def causal_mask(s: int, t: Optional[int] = None, offset: int = 0,
                device=None) -> torch.Tensor:
    """Boolean mask [1, 1, S, T]; query i attends to keys <= i + offset."""
    t = t if t is not None else s
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    return (cols <= rows + offset)[None, None]


def first_cache(caches):
    """A stacked cache view itself, or the first view of a per-layer list."""
    return caches if hasattr(caches, "_fields") else caches[0]


def cache_start(caches):
    """The cache length the next tokens are written at: the first view's,
    or layer 0's of a stacked view."""
    c0 = first_cache(caches)
    return c0.length[0] if c0 is caches else c0.length


def positions_and_mask(caches, s: int, positions: Optional[torch.Tensor],
                       attn_mask: Optional[torch.Tensor], device):
    """The positions and the attention mask of a forward over S tokens, as
    the LLaMA and OPT forwards of the reference build them: without a cache
    ``arange(S)`` and the causal mask; with one, positions from the cache's
    length (a stacked view's layer 0) and a mask over its ``T_max``
    columns.  Given ``positions`` / ``attn_mask`` are kept."""
    if caches is None:
        if positions is None:
            positions = torch.arange(s, device=device)
        mask = causal_mask(s, device=device) if attn_mask is None else attn_mask
        return positions, mask
    from ..engine.kvcache import cache_max_len

    if positions is None:
        positions = cache_start(caches) + torch.arange(s, device=device)
    if attn_mask is not None:
        return positions, attn_mask
    cols = torch.arange(cache_max_len(first_cache(caches)), device=device)[None, :]
    qpos = positions if positions.dim() == 1 else positions[0]
    return positions, (cols <= qpos[:, None])[None, None]


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """The standard ALiBi head slopes (BLOOM attention), f32: computed in
    Python floats and rounded once, as the reference does; a head count
    that is no power of two takes the closest power's slopes and every
    other slope of twice that count."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2_slopes(closest)
        slopes += pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def update_kv_cache(
    cache: KVCacheView, k_new: torch.Tensor, v_new: torch.Tensor
) -> KVCacheView:
    """Write S new tokens at position ``cache.length`` (see
    :func:`write_columns`); the returned view shares the buffers, which are
    updated IN PLACE (the reference returned new arrays), and carries the
    advanced length."""
    length = write_columns((cache.k, cache.v), (k_new, v_new), cache.length,
                           cache.valid)
    return KVCacheView(cache.k, cache.v, length)


def write_columns(bufs, news, start: Union[int, torch.Tensor],
                  valid: Optional[torch.Tensor] = None):
    """Write the S new tokens of each ``news[i]`` ``[B, S, ...]`` into
    ``bufs[i]`` ``[B, T_max, ...]`` in place, at column ``start``; returns
    the advanced length.  Every buffer of a cache (k and v, or the codes,
    scales and zeros of a quantized one) takes the same columns.

    As in the reference, a start too close to the end is clamped so that
    the S tokens fit, and a ``[B]`` start writes each row at its own column.
    A 0-d tensor start (``generate``'s timeline on the device) writes the
    bytes of its int start, by an ``index_copy_`` at the clamped start
    plus ``arange(S)``: no value is read on the host.

    With ``valid`` (``[B]``, slot-local starts only), token i of slot b
    lands at column ``start[b] + i`` when ``i < valid[b]`` and the column
    exists, and is dropped otherwise (the reference's ``mode="drop"``
    scatter); the length advances by ``valid``.  No boolean mask selects
    the kept tokens (on a CUDA tensor that would be a device->host sync per
    layer): every token is written, the dropped ones to the slot's first
    column with the bytes that column ends up holding anyway -- its kept
    token 0 if the slot keeps any, else its current content -- so duplicate
    writes carry equal bytes and the result does not depend on their order.
    """
    s = news[0].shape[1]
    t_max = bufs[0].shape[1]
    bsz = bufs[0].shape[0]
    if valid is not None:
        if not (torch.is_tensor(start) and start.dim() == 1):
            raise ValueError("valid requires [B] slot-local lengths")
        ar = torch.arange(s, device=start.device)
        t = start[:, None] + ar[None, :]  # [B, S]
        keep = (ar[None, :] < valid[:, None]) & (t < t_max)
        first = start.clamp(0, t_max - 1)[:, None]  # [B, 1]
        col = torch.where(keep, t, first)
        b_idx = torch.arange(bsz, device=start.device)[:, None]
        for buf, new in zip(bufs, news):
            new = new.to(buf.dtype)
            anchor = torch.where(keep[:, :1, None, None], new[:, :1],
                                 buf[b_idx, first])
            buf[b_idx, col] = torch.where(keep[:, :, None, None], new, anchor)
        return start + valid
    if torch.is_tensor(start) and start.dim() == 1:
        st = start.clamp(0, t_max - s)
        t = st[:, None] + torch.arange(s, device=start.device)[None, :]
        b_idx = torch.arange(bsz, device=start.device)[:, None]
        for buf, new in zip(bufs, news):
            buf[b_idx, t] = new.to(buf.dtype)
    elif torch.is_tensor(start):
        cols = start.clamp(0, t_max - s) + torch.arange(s, device=start.device)
        for buf, new in zip(bufs, news):
            buf.index_copy_(1, cols, new.to(buf.dtype))
    else:
        st = min(max(start, 0), t_max - s)
        for buf, new in zip(bufs, news):
            buf[:, st : st + s] = new.to(buf.dtype)
    return start + s
