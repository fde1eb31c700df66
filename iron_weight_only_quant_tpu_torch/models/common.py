"""Shared model building blocks (port of ``models/common.py``).

Plain PyTorch ops, eager.  Attention, RoPE and KV writes were plain XLA in
the reference, not kernels, so they are plain torch ops here too; the only
kernels on the model path are the W4/W8 dequant-matmuls behind :func:`linear`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from ..ops.qmatmul import _rms_nogamma, quantized_matmul
from ..quantize.qtensor import QuantizedTensor


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


def linear(x: torch.Tensor, p: Any,
           pre_norm: Optional[float] = None) -> torch.Tensor:
    """Apply a linear layer whose weight is dense ``[K, N]`` or quantized.

    ``pre_norm`` (the RMS eps) applies a weightless RMSNorm to x first --
    inside the kernel for quantized weights on the card.  The norm gamma
    must already be folded into the weights (``fold_llama_norms``).
    """
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

    ``length`` is a Python int (one shared timeline) or a ``[B]`` int tensor
    (slot-local timelines).  ``valid`` (optional, ``[B]``, slot-local only)
    marks how many of the next write's S tokens are real per slot: writes
    beyond a slot's count are dropped and its length advances by the count.
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
    else:
        st = min(max(int(start), 0), t_max - s)
        for buf, new in zip(bufs, news):
            buf[:, st : st + s] = new.to(buf.dtype)
    return start + s
