"""Block-level tensor parallelism over the ``"model"`` ranks, for LLaMA, OPT
and BLOOM, flat and layer-stacked (port of ``parallel/tp_block.py``).

Each rank holds its shard of every linear and runs the whole model on it:
q/k/v/gate/up/fc1 are column-parallel (heads and FFN channels split over
the ranks), attention runs on each rank's own heads with no exchange, and
o/down/fc2 are row-parallel with one all-reduce each -- the megatron
block, over packed quantized weights whose kernels (the W4/W8 dequant
matmuls on the card) run on each rank's local shapes.  The activations
are whole on every rank between the blocks.  The JAX package runs this as
one ``shard_map``; here every rank runs the model's own forward with a
shard-local config, the ``reduce`` seam of its blocks set to the
all-reduce, and local views of its params.

Requirements: heads, KV heads and the FFN width divisible by the model
axis (else ``ValueError``); row-parallel artifacts packed with
``k_shards`` equal to the axis (:func:`tp_prepare_layer`, the engine does
it); no N padding on a column-parallel artifact under d > 1 (the padding
sits at the end of N, so a 1/d slice would mix logical and pad columns:
``ValueError``; fused projections drop member padding).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.common import FusedLinear, stack_model_layers
from ..quantize.qtensor import QuantizedTensor, concat_n, repack_k_shards
from ..quantize.rtn import quantize_tensor
from .mesh import Mesh, all_gather, all_reduce

# per family: (column-parallel keys, row-parallel keys)
_FAMILY_LINEARS = {
    "llama": (("q", "k", "v", "gate", "up"), ("o", "down")),
    "opt": (("q", "k", "v", "fc1"), ("o", "fc2")),
    "bloom": (("q", "k", "v", "fc1"), ("o", "fc2")),
}


# ------------------------------------------ TP-aware projection fusion

def _slice_cols(qt: QuantizedTensor, a: int, b: int) -> QuantizedTensor:
    """Logical column slice ``[a, b)`` of a packed artifact.

    Exact: per-group quantization is independent per output column, and the
    K-dim packing never mixes columns.  Member N padding (columns >=
    ``shape[1]``) is dropped by slicing logical columns only."""
    def side(s):
        if s is None or s.shape[-1] <= 1:
            return s
        return s[..., a:b]

    return qt.replace(qweight=qt.qweight[..., a:b], scales=side(qt.scales),
                      zeros=side(qt.zeros), shape=(qt.shape[0], b - a), n_pad=0)


def _pad_cols_zero(qt: QuantizedTensor, mult: int) -> QuantizedTensor:
    """Append zero-contribution columns so stored N is a ``mult`` multiple.

    Padding columns carry scale 0 (and zero-point 0), so they dequantize to
    exactly 0 in both affine and LUT modes whatever their code bytes;
    ``shape`` grows (callers slice member outputs by spans)."""
    n = qt.shape[1]
    if mult <= 1 or n % mult == 0:
        return qt
    pad = mult - n % mult

    def padded(a):
        if a is None:
            return None
        if a.shape[-1] <= 1:  # broadcast side info cannot express dead cols
            raise ValueError("cannot zero-pad per-tensor side info")
        return torch.nn.functional.pad(a, (0, pad))

    return qt.replace(qweight=padded(qt.qweight), scales=padded(qt.scales),
                      zeros=padded(qt.zeros), shape=(qt.shape[0], n + pad))


def _fuse_tp_layer(p: Dict[str, Any], d: int, pad_to: int = 128) -> Dict[str, Any]:
    """Fuse one LLaMA layer dict's q|k|v and gate|up into shard-blocked wide
    artifacts (see :func:`fuse_projections_tp` for the layout)."""
    def try_fuse(p, names):
        if not all(n in p for n in names):
            return None
        ws = [p[n]["w"] for n in names]
        if not all(isinstance(w, QuantizedTensor) for w in ws):
            return None
        if any(p[n].get("b") is not None for n in names):
            return None
        if any(w.shape[1] % d for w in ws):
            return None
        shards, spans = [], None
        for i in range(d):
            members = [_slice_cols(w, i * (w.shape[1] // d), (i + 1) * (w.shape[1] // d))
                       for w in ws]
            try:
                blk = _pad_cols_zero(concat_n(members), pad_to)
            except ValueError:
                return None
            if spans is None:  # shard-local member spans (the same every shard)
                off, spans = 0, []
                for m in members:
                    spans.append((off, off + m.shape[1]))
                    off += m.shape[1]
                spans = tuple(spans)
            shards.append(blk)
        return FusedLinear(concat_n(shards), None, spans)

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


def fuse_projections_tp(params: Dict[str, Any], d: int, pad_to: int = 128) -> Dict[str, Any]:
    """Fuse q|k|v and gate|up into shard-blocked wide artifacts.

    The one-device layout ``[q | k | v]`` (``models.llama.
    fuse_llama_projections``) cannot be split on N (a 1/d slice mixes
    members); here the columns are laid out ``[q_0 k_0 v_0 | q_1 k_1 v_1 |
    ...]``, so rank i's N slice is its own fused ``[q_i | k_i | v_i]``
    block.  The spans on the :class:`FusedLinear` are shard-local (the same
    on every rank); each block is zero-padded to a ``pad_to`` column
    multiple.  Exact by column independence.  LLaMA layer dicts only."""
    return {**params, "layers": [_fuse_tp_layer(p, d, pad_to) for p in params["layers"]]}


def _check_whole_groups(key: str, w: QuantizedTensor, d: int) -> None:
    """A row-parallel artifact's K must split into ``d`` shards of whole
    quantization groups: else each rank's rows would need a fraction of a
    group's side row."""
    g = w.spec.group_size
    if w.shape[0] % d or (g > 0 and (w.shape[0] // d) % g):
        raise ValueError(
            f"row-parallel '{key}': K={w.shape[0]} must split into {d} shards "
            f"of whole quantization groups (g={g}); K/d={w.shape[0] // d}")


def tp_prepare_layer(p: Dict[str, Any], d: int, fuse: bool = True, pad_to: int = 128,
                     family: str = "llama") -> Dict[str, Any]:
    """Per-layer TP transform: repack the row-parallel artifacts to
    ``k_shards=d`` and (LLaMA only) build the shard-blocked fused
    projections.  OPT/BLOOM column-parallel projections carry biases, which
    the fusion rejects: they split unfused."""
    _, row_keys = _FAMILY_LINEARS[family]
    p = dict(p)
    for key in row_keys:
        lin = p.get(key)
        if isinstance(lin, dict) and isinstance(lin.get("w"), QuantizedTensor):
            _check_whole_groups(key, lin["w"], d)
            p[key] = {**lin, "w": repack_k_shards(lin["w"], d)}
    if fuse and family == "llama":
        p = _fuse_tp_layer(p, d, pad_to)
    return p


def prepare_tp_stacked(params: Dict[str, Any], d: int, fuse: bool = True,
                       pad_to: int = 128, family: str = "llama") -> Dict[str, Any]:
    """Flat params -> TP-prepared layer-stacked params for the scan forwards:
    :func:`tp_prepare_layer` on every layer, then ``stack_model_layers``
    with the row-parallel side info padded per K segment
    (``models.common.pad_stacked_sides``), so that only shard-local views
    (where that padding is end-of-rows padding) read it: do not feed the
    prepared whole artifact to one-device consumers."""
    layers = [tp_prepare_layer(p, d, fuse, pad_to, family) for p in params["layers"]]
    flat = {**{k: v for k, v in params.items() if k != "layers"}, "layers": layers}
    return stack_model_layers(flat, consume=True, tp_segments=True)


def validate_tp_stacked(params: Dict[str, Any], d: int, family: str = "llama") -> None:
    """Check that a stacked param tree is TP-prepared for a model axis of ``d``."""
    _, row_keys = _FAMILY_LINEARS[family]
    stacked = params["layers_stacked"]
    for key in row_keys:
        lin = stacked.get(key)
        if isinstance(lin, dict) and isinstance(lin.get("w"), QuantizedTensor):
            if lin["w"].k_shards != d:
                raise ValueError(
                    f"stacked tensor-parallel params: row-parallel '{key}' packed with "
                    f"k_shards={lin['w'].k_shards}, need {d}; prepare flat params with "
                    "parallel.tp_block.prepare_tp_stacked(params, d) before stacking")
            _check_whole_groups(key, lin["w"], d)
            if lin.get("b") is not None:
                raise NotImplementedError(
                    f"row-parallel '{key}' bias under stacked tensor parallelism "
                    "(pass flat params: the engine prepares and stacks them)")
    for key, v in stacked.items():
        if key in row_keys:
            continue
        qt = v.w if isinstance(v, FusedLinear) else (
            v.get("w") if isinstance(v, dict) else None)
        if isinstance(qt, QuantizedTensor) and qt.n_pad and d > 1:
            raise ValueError(
                f"column-parallel '{key}' carries n_pad={qt.n_pad}: stored padding sits "
                "at the END of N, so a 1/d column slice mixes logical and pad columns -- "
                "fuse projections (prepare_tp_stacked(fuse=True)) or quantize with "
                "pad_n_to=1")


def shard_model_params(params: Dict[str, Any], cfg, spec, d: int,
                       family: str = "llama") -> Dict[str, Any]:
    """Quantize a dense param tree with TP-aware packing: column-parallel
    linears pack as usual, row-parallel ones with ``k_shards=d``."""
    col_keys, row_keys = _FAMILY_LINEARS[family]

    def qlin(key, lin):
        w = lin["w"]
        if isinstance(w, QuantizedTensor):
            return lin
        shards = d if key in row_keys else 1
        return {**lin, "w": quantize_tensor(w.to(torch.float32), spec, k_shards=shards)}

    layers = []
    for b in params["layers"]:
        nb = dict(b)
        for key in col_keys + row_keys:
            nb[key] = qlin(key, b[key])
        layers.append(nb)
    return {**params, "layers": layers}


# ------------------------------------------------------------ local views

def _local_view(lin, d: int, row: bool):
    """A linear of a rank's param tree (``sharding.apply_sharding``: local
    tensors, global metadata) with local metadata: column-parallel
    ``(K, N/d)``, row-parallel ``(K/d, N)`` with ``k_shards=1``."""
    if isinstance(lin, FusedLinear):
        w = lin.w
        return FusedLinear(QuantizedTensor(w.qweight, w.scales, w.zeros, w.codebook,
                                           w.spec, (w.shape[0], w.shape[1] // d), w.mode,
                                           1, w.n_pad, w.k_pad), lin.b, lin.spans)
    w = lin["w"]
    if not isinstance(w, QuantizedTensor):
        return lin
    k, n = w.shape
    if row:
        if w.k_pad:
            raise NotImplementedError("row-parallel TP over a K-padded artifact")
        if d > 1 and w.k_shards != d:
            # a bare row slice of such an artifact splits its code pairs (the
            # JAX package computes wrong products here)
            raise ValueError(
                f"a row-parallel artifact packed with k_shards={w.k_shards} under "
                f"model={d}: repack it (quantize.qtensor.repack_k_shards, or "
                "tp_prepare_layer) so that each rank's rows are self-contained")
        for side in (w.scales, w.zeros):
            # grouped side rows the sharding kept whole (their count does not
            # divide d): this rank's K/d rows would read the wrong groups
            if d > 1 and side is not None and side.dim() >= 2 and side.shape[-2] > 1 \
                    and side.shape[-2] * d * w.spec.group_size != k:
                raise ValueError(
                    f"a row-parallel artifact (K={k}, g={w.spec.group_size}) whose "
                    f"{side.shape[-2]} local side rows are not its 1/{d} share of the "
                    "groups: K/d must be whole quantization groups (tp_prepare_layer)")
        local = QuantizedTensor(w.qweight, w.scales, w.zeros, w.codebook, w.spec,
                                (k // d, n), w.mode, 1, w.n_pad)
    else:
        if w.n_pad and d > 1:
            # the JAX package computes wrong logits here (its lm_head under
            # d > 1); refuse rather than reproduce it
            raise ValueError(
                f"a column-parallel artifact with n_pad={w.n_pad} under model={d}: its "
                "stored padding sits at the end of N, so a 1/d slice mixes logical and "
                "pad columns; quantize it with pad_n_to=1 (a padded lm_head included)")
        local = QuantizedTensor(w.qweight, w.scales, w.zeros, w.codebook, w.spec,
                                (k, n // d), w.mode, 1, w.n_pad, w.k_pad)
    return {**lin, "w": local}


def _is_linear(v) -> bool:
    return isinstance(v, FusedLinear) or (isinstance(v, dict) and "w" in v)


def _local_flat(params: Dict[str, Any], d: int, row_keys) -> Dict[str, Any]:
    layers = [{k: _local_view(v, d, row=k in row_keys) if _is_linear(v) else v
               for k, v in p.items()} for p in params["layers"]]
    out = {**params, "layers": layers}
    if "lm_head" in params:
        out["lm_head"] = _local_view(params["lm_head"], d, row=False)
    return out


def _local_stacked(stacked: Dict[str, Any], d: int, row_keys) -> Dict[str, Any]:
    """Local metadata views of a rank's stacked layer dict: column-parallel
    ``(K, N/d)``, row-parallel ``(K/d, N)`` with ``k_shards=1`` (each
    segment's packing is self-contained after ``repack_k_shards``).
    ``side_pad`` keeps its value: per-segment padding of the whole artifact
    is end-of-rows padding of the local one."""
    out = {}
    for key, v in stacked.items():
        row = key in row_keys
        if isinstance(v, FusedLinear):
            w = v.w
            out[key] = (FusedLinear(w.replace(shape=(w.shape[0], w.shape[1] // d)), v.b,
                                    v.spans) if isinstance(w, QuantizedTensor) else v)
        elif isinstance(v, dict) and isinstance(v.get("w"), QuantizedTensor):
            w = v["w"]
            if row:
                if w.k_pad:
                    raise NotImplementedError("row-parallel TP over a K-padded artifact")
                lw = w.replace(shape=(w.shape[0] // d, w.shape[1]), k_shards=1)
            else:
                lw = w.replace(shape=(w.shape[0], w.shape[1] // d))
            out[key] = {**v, "w": lw}
        else:
            out[key] = v
    return out


def _local_stacked_params(params, d, row_keys):
    out = {**params, "layers_stacked": _local_stacked(params["layers_stacked"], d, row_keys)}
    if "lm_head" in params:
        out["lm_head"] = _local_view(params["lm_head"], d, row=False)
    return out


class _LocalCache:
    """The local views of the last param tree a forward saw: built once per
    tree, not once per call (the engine passes the same tree every step)."""

    def __init__(self, build):
        self.build = build
        self.params = self.local = None

    def __call__(self, params):
        if params is not self.params:
            self.params, self.local = params, self.build(params)
        return self.local


def _reducer(mesh: Mesh):
    """The all-reduce over the model ranks; None (no reduce) at d = 1."""
    if mesh.model == 1:
        return None
    return lambda t: all_reduce(t, mesh.model_group)


def _check_heads(cfg, d: int, family: str) -> None:
    if family == "llama":
        if cfg.num_heads % d or cfg.num_kv_heads % d or cfg.intermediate_size % d:
            raise ValueError(
                f"heads ({cfg.num_heads}), KV heads ({cfg.num_kv_heads}) and the FFN width "
                f"({cfg.intermediate_size}) must divide model={d}; the JAX package's "
                "GSPMD engine replicates what does not divide, the rank-per-shard forward "
                "does not")
        if cfg.tie_word_embeddings:
            raise NotImplementedError("tied lm head under tensor parallelism")
    elif family == "opt":
        if cfg.num_heads % d or cfg.ffn_dim % d:
            raise ValueError(f"num_heads ({cfg.num_heads}) and ffn_dim ({cfg.ffn_dim}) "
                             f"must divide model={d}")
    elif cfg.num_heads % d or cfg.hidden_size % d:
        raise ValueError(f"num_heads ({cfg.num_heads}) and hidden_size "
                         f"({cfg.hidden_size}) must divide model={d}")


def _local_cfg(cfg, d: int, family: str):
    if family == "llama":
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // d,
                                   num_kv_heads=cfg.num_kv_heads // d, head_dim=cfg.hd)
    # OPT/BLOOM derive the head dim (hidden / heads): scale both
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // d,
                               hidden_size=cfg.hidden_size // d)


# ---------------------------------------------------------------- forwards

def make_tp_forward(cfg, mesh: Mesh, family: str, stacked: bool):
    """``forward(params, tokens, cfg=None, caches=None, positions=None,
    attn_mask=None)`` of ``family`` over a rank's flat or (``stacked``)
    layer-stacked params (``apply_sharding`` of TP-prepared params,
    :func:`tp_prepare_layer` / :func:`prepare_tp_stacked`): local heads,
    caches of the rank's ``1/d`` of the KV heads (``[L, B, T, H_kv/d, ...]``
    stacked), one all-reduce after each row-parallel linear.  LLaMA's
    column-parallel lm_head logits are all-gathered to the full vocab;
    OPT/BLOOM add row-parallel biases once after the all-reduce
    (``models.opt._row_tp``) and their tied head reads the whole embedding,
    so every rank computes the full logits; each BLOOM rank's ALiBi slopes
    are its heads' slice.  The engine's entry point; the JAX package's
    ``make_tp_*_forward[_stacked]`` names are aliases of it (below)."""
    from ..models import bloom, llama, opt

    d = mesh.model
    _check_heads(cfg, d, family)
    cfg_loc = _local_cfg(cfg, d, family)
    _, row_keys = _FAMILY_LINEARS[family]
    build = _local_stacked_params if stacked else _local_flat
    local_of = _LocalCache(lambda p: build(p, d, row_keys))
    reduce = _reducer(mesh)
    model_fwd = {"llama": llama._forward, "opt": opt._forward, "bloom": bloom._forward}[family]
    kw = {"head_shard": (mesh.model_index, d)} if family == "bloom" else {}

    def forward(params, tokens, cfg_arg=None, caches=None, positions=None,
                attn_mask=None):
        # cfg_arg is accepted (and ignored) so the engine can call this with
        # the models' forward signature
        logits, caches = model_fwd(local_of(params), tokens, cfg_loc, caches, positions,
                                   attn_mask, stacked, reduce=reduce, **kw)
        if family == "llama":  # column-parallel head: this rank's vocab slice
            logits = all_gather(logits, mesh.model_group, dim=-1)
        return logits, caches

    return forward


def _alias(family: str, stacked: bool):
    def make(cfg, mesh: Mesh):
        return make_tp_forward(cfg, mesh, family, stacked)

    make.__name__ = f"make_tp_{family}_forward" + ("_stacked" if stacked else "")
    return make


# the JAX package's names
make_tp_llama_forward = _alias("llama", False)
make_tp_llama_forward_stacked = _alias("llama", True)
make_tp_opt_forward = _alias("opt", False)
make_tp_opt_forward_stacked = _alias("opt", True)
make_tp_bloom_forward = _alias("bloom", False)
make_tp_bloom_forward_stacked = _alias("bloom", True)
