"""Whole-model quantization pass over a params tree (port of
``quantize/model_pass.py``).

Every linear-layer dict ``{"w": ..., "b": ...}`` with a dense 2-D weight
becomes a packed :class:`QuantizedTensor`, except the paths that
``exclude`` names (the lm_head by default).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import QuantSpec
from ..device import resolve_device
from .qtensor import QuantizedTensor
from .rtn import quantize_tensor

EXCLUDE_DEFAULT = ("lm_head",)


def _is_linear(node: Any) -> bool:
    return isinstance(node, dict) and "w" in node and not isinstance(
        node["w"], QuantizedTensor
    ) and hasattr(node["w"], "ndim") and node["w"].ndim == 2


def quantize_model_params(
    params: Dict[str, Any],
    spec: QuantSpec,
    exclude: Tuple[str, ...] = EXCLUDE_DEFAULT,
    quantize_fn: Optional[Callable[[torch.Tensor, str], QuantizedTensor]] = None,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (quantized params, report {n_quantized, n_skipped, names}),
    every tensor on ``device`` (the card unless named).

    ``quantize_fn(w, path)`` overrides the per-weight quantizer (default:
    RTN, :func:`quantize_tensor`).
    """
    device = resolve_device(device)
    report = {"n_quantized": 0, "n_skipped": 0, "names": []}

    def qfn(w, path):
        if quantize_fn is not None:
            return quantize_fn(w, path)
        return quantize_tensor(w, spec)

    def walk(node, path):
        if _is_linear(node):
            node = {k: walk(v, f"{path}.{k}") for k, v in node.items()}
            if any(e in path for e in exclude):
                report["n_skipped"] += 1
                return node
            qt = qfn(node["w"], path)
            report["n_quantized"] += 1
            report["names"].append(path)
            return {**node, "w": qt}
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        if torch.is_tensor(node):
            return node.to(device)
        return node

    return walk(params, ""), report


def dequantize_model_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Replace every QuantizedTensor with its dense dequantized f32 weight
    (the fake-quant evaluation path)."""
    from ..ops.qmatmul import dequantize_weight

    def walk(node):
        if isinstance(node, QuantizedTensor):
            return dequantize_weight(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
