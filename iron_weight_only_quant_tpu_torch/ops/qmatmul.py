"""Quantized matmul: the dequantize oracle and the dispatch to the kernels
(port of ``ops/qmatmul.py``).

``dequantize_weight`` followed by a matmul is the correctness oracle.
``quantized_matmul`` goes to ``ops/kernels/dequant_matmul.py``.  An
artifact the JAX package computes on its XLA path by its format alone
(``xla_route``: other formats, approximate minifloats, ``k_shards > 1``,
16-bit side info, 2-bit codes, 3-bit groups straddling the K/8 slabs) takes
the same computation here, on any device: ``pre_norm`` first, the
dequantized weight in f32, a plain matmul, activation bits ignored.  Any
other artifact on a CPU tensor takes the plain PyTorch version of its
kernel; on a CUDA tensor it launches a hand-written kernel (affine int4 or
bfp4 nib4, int8 or bfp8 byte and 3-bit s21 layouts, minifloat LUT nib4 and
byte layouts, with bf16/f32 activations or int8/A16 ones) or raises for a
layout that has no kernel yet (fp6 in the nq42 layout).  ``activation_quant`` sets the activation
bits that calls without an explicit ``activation_bits`` use, as in the
reference; the engine wraps its prefill and decode phases in it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quantize.qtensor import QuantizedTensor
from .packing import unpack_codes_sharded


def packed_bits(qt: QuantizedTensor) -> int:
    b = qt.spec.storage_bits
    if qt.mode == "lut":  # codebook indexing needs plain unsigned sub-byte
        if b == 6:
            # nq42 stores [3K/4, N] bytes; byte-per-code fp6 stores [K, N]
            k_rows = qt.qweight.shape[-2]
            per_shard = qt.k_stored // qt.k_shards
            return 6 if k_rows * 4 == qt.k_stored * 3 and per_shard % 4 == 0 else 8
        return b if b in (2, 4) else 8
    return b if b in (2, 3, 4, 8) else 8


def dequantize_weight(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Packed (flat) artifact -> dense ``[K, N]`` weight (the oracle)."""
    codes = unpack_codes_sharded(
        qt.qweight, packed_bits(qt), qt.k_stored, qt.k_shards
    )
    k = qt.k_stored
    scales, zeros_arr = qt.scales, qt.zeros
    if qt.side_pad:  # stack-time row padding of the side info
        scales = scales[: scales.shape[0] - qt.side_pad]
        if zeros_arr is not None and zeros_arr.shape[0] == scales.shape[0] + qt.side_pad:
            zeros_arr = zeros_arr[: scales.shape[0]]
    scales = scales.to(torch.float32)

    def expand(side):  # per-group side info [K/G, N] -> [K, N]
        if side.shape[0] == 1:
            return side
        return side.repeat_interleave(k // side.shape[0], dim=0)

    if qt.mode == "affine":
        zeros = (expand(zeros_arr.to(torch.float32))
                 if zeros_arr is not None else 0.0)
        w = (codes.to(torch.float32) - zeros) * expand(scales)
    else:  # lut
        if packed_bits(qt) == 8:
            codes = codes + 128  # byte layout stores code-128
        w = qt.codebook[codes.long()] * expand(scales)
        if zeros_arr is not None:
            w = w + expand(zeros_arr.to(torch.float32))
    if qt.k_pad:
        w = w[: qt.k]
    if qt.n_pad:
        w = w[:, : qt.n]
    return w.to(dtype)


def _rms_nogamma(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless RMSNorm in f32, cast back to ``x.dtype``: what ``pre_norm``
    applies to x where no kernel applies it in its epilogue (dense weights,
    and before activation quantization)."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


_DEFAULT_ACTIVATION_BITS: Optional[int] = None


class activation_quant:
    """Context manager setting the activation bits (None, 8 or 16) that
    ``quantized_matmul`` and ``quantized_matmul_stacked`` use when their
    ``activation_bits`` argument is None: 8 = int8 activations (W4A8/W8A8),
    16 = split-int8 16-bit fixed point (A16)."""

    def __init__(self, bits: Optional[int] = 8):
        self.bits = bits

    def __enter__(self):
        global _DEFAULT_ACTIVATION_BITS
        self._prev = _DEFAULT_ACTIVATION_BITS
        _DEFAULT_ACTIVATION_BITS = self.bits
        return self

    def __exit__(self, *exc):
        global _DEFAULT_ACTIVATION_BITS
        _DEFAULT_ACTIVATION_BITS = self._prev
        return False


def quantized_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation_bits: Optional[int] = None,
    pre_norm: Optional[float] = None,
) -> torch.Tensor:
    """``y = x @ dequant(qt) (+ bias)``, cast to ``x.dtype``.

    ``pre_norm`` (the RMS eps) applies a weightless RMSNorm to x, inside the
    kernel on the card where the layout has a prenorm kernel (nib4, byte),
    else to x first (s21, as the JAX package does); the norm gamma must be
    folded into the weights.
    ``activation_bits`` (None: the ambient ``activation_quant`` setting)
    quantizes x per row to int8 (8) or two int8 planes (16) first; LUT
    artifacts take A16 where their format allows it (else full precision,
    with a warning) and refuse A8.  The bias is added before the final
    cast, as in the reference; on the route to an f32 product.
    """
    from .kernels import dequant_matmul as dm

    if dm.xla_route(qt):
        out = dm.route_matmul(x, qt, pre_norm)
    else:
        if activation_bits is None:
            activation_bits = _DEFAULT_ACTIVATION_BITS
        out = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm,
                                        activation_bits=activation_bits)
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def index_stacked(qt: QuantizedTensor, layer_idx) -> QuantizedTensor:
    """One layer of a layer-stacked artifact (views, no copy)."""
    return qt.map_arrays(lambda a: a[layer_idx])


def quantized_matmul_stacked(
    x: torch.Tensor,
    qt: QuantizedTensor,
    layer_idx,
    bias: Optional[torch.Tensor] = None,
    *,
    activation_bits: Optional[int] = None,
    pre_norm: Optional[float] = None,
) -> torch.Tensor:
    """``y = x @ dequant(qt[layer_idx]) (+ bias)`` for layer-stacked artifacts;
    the kernel reads the selected layer in place (the route dequantizes
    that layer)."""
    from .kernels import dequant_matmul as dm

    if dm.xla_route(qt):
        out = dm.route_matmul(x, qt, pre_norm, layer=int(layer_idx))
    else:
        if activation_bits is None:
            activation_bits = _DEFAULT_ACTIVATION_BITS
        out = dm.fused_quantized_matmul_stacked(x, qt, layer_idx, pre_norm=pre_norm,
                                                activation_bits=activation_bits)
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)
