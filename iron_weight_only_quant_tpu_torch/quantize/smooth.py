"""SmoothQuant-style activation smoothing (port of ``quantize/smooth.py``).

Per-channel activation scales migrate into the preceding weights,

    y = (x / s) @ (s * W),   s = act_absmax^alpha / weight_absmax^(1 - alpha),

which flattens activation outliers before quantization.  For serving, the
division of x by ``s`` is folded into the preceding norm's scale and ``s``
into the rows of the linears that norm feeds: only those sites (the
attention and MLP input projections after a norm) are smoothed.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..models.common import recording_linears

# per family: (norm key, keys of the linears that norm feeds)
FOLD_SITES = {
    "llama": [("input_norm", ["q", "k", "v"]), ("post_norm", ["gate", "up"])],
    "opt": [("attn_norm", ["q", "k", "v"]), ("final_norm", ["fc1"])],
    "bloom": [("attn_norm", ["q", "k", "v"]), ("post_norm", ["fc1"])],
}


def collect_act_scales(forward, params: Dict[str, Any], cfg,
                       samples: List[np.ndarray]) -> Dict[str, torch.Tensor]:
    """Per-linear, per-channel absmax of the inputs over the calibration
    samples, on the params' device.  The linears must carry names
    (``quantize.gptq_model.annotate_linears``)."""
    maxes: Dict[str, torch.Tensor] = {}

    def cb(name, x):
        m = x.reshape(-1, x.shape[-1]).abs().max(dim=0).values
        maxes[name] = torch.maximum(maxes[name], m) if name in maxes else m

    dev = params["embed"].device
    with torch.no_grad(), recording_linears(cb):
        for s in samples:
            forward(params, torch.as_tensor(np.asarray(s), dtype=torch.int64, device=dev), cfg)
    return maxes


def smooth_block(
    block: Dict[str, Any],
    act_scales: Dict[str, torch.Tensor],
    family: str,
    alpha: float = 0.5,
    eps: float = 1e-5,
) -> Dict[str, Any]:
    """Fold the smoothing scales into one block's norms and input
    projections."""
    out = dict(block)
    for norm_key, lin_keys in FOLD_SITES[family]:
        acts = [act_scales[k] for k in lin_keys if k in act_scales]
        if not acts:
            continue
        act_max = torch.stack(acts).max(dim=0).values.clamp(min=eps)
        w_max = torch.stack([block[k]["w"].abs().max(dim=1).values
                             for k in lin_keys]).max(dim=0).values.clamp(min=eps)
        s = (act_max**alpha / w_max ** (1 - alpha)).clamp(min=eps)

        norm = block[norm_key]
        if isinstance(norm, dict):  # layernorm {w, b}: both divide by s
            out[norm_key] = {"w": norm["w"] / s, "b": norm["b"] / s}
        else:  # the rmsnorm weight vector
            out[norm_key] = norm / s
        for k in lin_keys:
            lin = block[k]
            out[k] = {**lin, "w": lin["w"] * s[:, None]}
    return out


def _annotate_with_layer(block: Dict[str, Any], idx: int) -> Dict[str, Any]:
    out = {}
    for k, v in block.items():
        if isinstance(v, dict) and "w" in v and getattr(v["w"], "ndim", 0) == 2:
            out[k] = {**v, "name": f"{idx}.{k}"}
        else:
            out[k] = v
    return out


def smooth_model(
    params: Dict[str, Any],
    cfg,
    family: str,
    forward,
    samples: List[np.ndarray],
    alpha: float = 0.5,
) -> Dict[str, Any]:
    """The whole-model smoothing pass (run it before quantization)."""
    annotated = {
        **params,
        "layers": [_annotate_with_layer(b, i) for i, b in enumerate(params["layers"])],
    }
    act_scales = collect_act_scales(forward, annotated, cfg, samples)
    new_layers = []
    for i, b in enumerate(params["layers"]):
        per_layer = {k.split(".", 1)[1]: v for k, v in act_scales.items()
                     if k.startswith(f"{i}.")}
        new_layers.append(smooth_block(b, per_layer, family, alpha))
    return {**params, "layers": new_layers}
