"""Tensor-parallel partition specs for model params, and the slicing that
gives each rank its shards (port of ``parallel/sharding.py``).

Megatron-style column/row parallel linears on the ``"model"`` axis:

  * q/k/v/gate/up/fc1 : column-parallel -- weight ``[K, N]`` split on N,
    bias on N
  * o/down/fc2        : row-parallel -- weight split on K, bias whole (the
    forward adds it once, after the all-reduce)
  * embeddings        : vocab-split ``("model", None)`` (the tensor-parallel
    forwards read the embedding whole: the engine replicates it)
  * norms             : replicated

A spec is a tuple with one entry a dimension, the axis name that splits it
or None (the JAX ``PartitionSpec`` as a plain tuple; ``()`` replicates).
For a packed :class:`QuantizedTensor` the linear's weight spec applies to
``qweight`` and to grouped ``scales``/``zeros``; side arrays with a single
row or column stay whole.  :func:`apply_sharding` returns this rank's
local tensors, on its device: slices, not sharded arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.common import FusedLinear
from ..quantize.qtensor import QuantizedTensor

COL = {"w": (None, "model"), "b": ("model",)}
ROW = {"w": ("model", None), "b": ()}
REP = {"w": (), "b": ()}

_LLAMA_LAYER = {
    "input_norm": (),
    "q": COL, "k": COL, "v": COL, "o": ROW,
    "post_norm": (),
    "gate": COL, "up": COL, "down": ROW,
    # shard-blocked fused artifacts (tp_block.fuse_projections_tp)
    "qkv": COL, "gate_up": COL,
}
_OPT_LAYER = {
    "attn_norm": REP,
    "q": COL, "k": COL, "v": COL, "o": ROW,
    "final_norm": REP,
    "fc1": COL, "fc2": ROW,
}
_BLOOM_LAYER = {
    "attn_norm": REP,
    "q": COL, "k": COL, "v": COL, "o": ROW,
    "post_norm": REP,
    "fc1": COL, "fc2": ROW,
}


def _stack_spec(spec):
    """Prepend a replicated layer axis to a flat layer spec (stacked params)."""
    if isinstance(spec, dict):
        return {k: _stack_spec(v) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return (None,) + spec
    return spec


def param_specs(family: str, params: Dict[str, Any]) -> Dict[str, Any]:
    """A spec tree mirroring ``params`` (flat or layer-stacked)."""
    layer = {"llama": _LLAMA_LAYER, "opt": _OPT_LAYER, "bloom": _BLOOM_LAYER}[family]
    if "layers_stacked" in params:
        stacked_layer = _stack_spec(dict(layer))
        specs: Dict[str, Any] = {"layers_stacked": {
            key: stacked_layer.get(key, ()) for key in params["layers_stacked"]}}
    else:
        specs = {"layers": [dict(layer) for _ in range(len(params["layers"]))]}
    specs["embed"] = ("model", None)
    if family == "opt":
        specs["embed_pos"] = ()
        if "final_norm" in params:
            specs["final_norm"] = REP
    elif family == "bloom":
        specs["embed_norm"] = REP
        specs["final_norm"] = REP
    else:
        specs["final_norm"] = ()
        if "lm_head" in params:
            specs["lm_head"] = COL
    return specs


def _compatible_spec(shape, spec: tuple, model: int) -> tuple:
    """Drop spec axes whose extent does not divide the array dim (those
    dims are kept whole: per-group side arrays with few rows, say)."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
            continue
        out.append(axis if shape[i] % model == 0 else None)
    return tuple(out)


def _local(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, on the mesh's device.  A
    tensor that is not split is moved there as it is (no copy on its own
    device); a split one becomes a contiguous copy of the slice."""
    spec = _compatible_spec(tuple(t.shape), spec, mesh.model)
    for dim, axis in enumerate(spec):
        if axis is None or mesh.model == 1:
            continue
        size = t.shape[dim] // mesh.model
        t = t.narrow(dim, mesh.model_index * size, size).contiguous()
    return t.to(mesh.device)


def _leaf_sharding(value: Any, spec, mesh):
    if isinstance(value, QuantizedTensor):
        wspec = spec["w"] if isinstance(spec, dict) else spec

        def side_spec(side):
            if side is None:
                return None
            return wspec if any(d > 1 for d in side.shape) else ()

        def place(leaf, leaf_spec):
            return None if leaf is None else _local(leaf, leaf_spec, mesh)

        return value.replace(
            qweight=place(value.qweight, wspec),
            scales=place(value.scales, side_spec(value.scales)),
            zeros=place(value.zeros, side_spec(value.zeros)),
            codebook=place(value.codebook, ()))
    return _local(value, spec, mesh)


def apply_sharding(params: Dict[str, Any], specs: Dict[str, Any], mesh):
    """This rank's local param tree: every tensor sliced by its spec (dicts
    with ``w``/``b`` handled), on ``mesh.device``.  Packed artifacts keep
    their global ``shape`` metadata, as the arrays of a JAX ``shard_map``
    body do; the forwards' local views (``tp_block._local_view``) fix it."""

    def walk(p, s):
        if isinstance(p, FusedLinear):
            wspec = s["w"] if isinstance(s, dict) else s
            bspec = s["b"] if isinstance(s, dict) else ("model",)
            return FusedLinear(walk(p.w, wspec),
                               None if p.b is None else _leaf_sharding(p.b, bspec, mesh),
                               p.spans)
        if isinstance(p, QuantizedTensor):
            return _leaf_sharding(p, s, mesh)
        if isinstance(p, dict):
            out = {}
            for key, val in p.items():
                if key == "name":
                    out[key] = val
                    continue
                sub = s[key] if isinstance(s, dict) and key in s else s
                out[key] = walk(val, sub)
            return out
        if isinstance(p, list):
            return [walk(v, s[i] if isinstance(s, list) else s) for i, v in enumerate(p)]
        if p is None:
            return None
        if torch.is_tensor(p):
            spec = s if isinstance(s, tuple) else ()
            if p.dim() < len([a for a in spec if a]):
                spec = ()
            return _leaf_sharding(p, spec, mesh)
        return p

    return walk(params, specs)
