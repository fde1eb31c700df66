"""Layer-sequential GPTQ over a whole model (port of ``quantize/gptq_model.py``).

The reference flow (gptq_utils.py:53-194): take the inputs of block 0,
then for each block accumulate every linear's Hessian over one forward
with the dense weights, solve each linear, and run the block again with
the quantized weights to make the next block's inputs.  Only one block's
activations are live at a time.  Linears are recorded through the seam
``models.common.recording_linears``, not through forward hooks.

Everything runs on the device the params lie on: the Hessian forwards on
the dense weights, the solves (:mod:`.gptq`, :mod:`.trueobs`), and the
quantized re-forward through the dequant-matmul kernels.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import GPTQConfig, QuantSpec
from ..models.common import recording_linears
from ..ops.packing import pack_codes, packing_for_bits
from .gptq import GPTQResult, gptq_quantize, hessian_update, no_tf32
from .qtensor import QuantizedTensor
from .trueobs import trueobs_quantize


def annotate_linears(block_params: Dict[str, Any]) -> Dict[str, Any]:
    """Add a ``"name"`` key to every linear dict (2-D weight) of a block.

    Norm params are ``{"w", "b"}`` dicts too but 1-D, and are left out, as
    the reference hooks only ``nn.Linear`` (gptq_utils find_layers).
    """
    out = {}
    for k, v in block_params.items():
        if isinstance(v, dict) and "w" in v and getattr(v["w"], "ndim", 0) == 2:
            out[k] = {**v, "name": k}
        else:
            out[k] = v
    return out


def gptq_result_to_qtensor(res: GPTQResult, spec: QuantSpec, k: int, n: int) -> QuantizedTensor:
    """Pack a GPTQ solve (rows = N out-features, cols = K in-features) into
    the artifact layout.

    GPTQ codes are unsigned in ``[0, maxq]`` with ``w = scale * (code -
    zero)``: the affine rule.  Per-group scales pack as ``[K/G, N]``.
    Act-order with groups has column-interleaved scales and is not
    packable (it stays fake-quant, as the reference's packed path is
    per-channel only).  The byte layout (8-bit) stores ``code - 128`` with
    ``zero - 128``, as the RTN path does; the JAX package packs 8-bit GPTQ
    codes unshifted with unshifted zeros, which decodes every code >= 128
    wrong (ROADMAP C17).
    """
    if res.perm is not None and res.scales.shape[1] > 1:
        raise NotImplementedError("act_order + groups: use fake-quant path")
    codes = res.codes.t()  # [K, N]
    scales = res.scales.t().to(torch.float32).contiguous()  # [n_groups, N]
    zeros = res.zeros.t().to(torch.float32).contiguous()
    if packing_for_bits(spec.bits)[0] == "byte":
        codes = codes - 128
        zeros = zeros - 128.0
    return QuantizedTensor(pack_codes(codes, spec.bits), scales, zeros, None, spec,
                           (k, n), "affine")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def quantize_blocks_gptq(
    inputs: List[torch.Tensor],
    blocks: List[Dict[str, Any]],
    block_apply: Callable[[torch.Tensor, Dict[str, Any]], torch.Tensor],
    spec: QuantSpec,
    gcfg: GPTQConfig,
    pack: bool = True,
    progress: Optional[Callable[[str], None]] = None,
    stage_order: Optional[List[List[str]]] = None,
    observer: Optional[Callable[[int, str, float, Dict[str, Any]], None]] = None,
) -> List[Dict[str, Any]]:
    """Quantize each block given the streaming inputs.

    ``inputs``: per-sample activations entering block 0 (``[1, S, H]``
    each).  ``block_apply(x, params) -> x_out`` runs one block (mask and
    RoPE closed over).  ``stage_order`` (the true-sequential mode,
    reference gptq/llama.py:75-83) quantizes the linears stage by stage,
    each stage's Hessians collected with the earlier stages quantized.
    Returns the new block param dicts.

    ``observer(block, phase, seconds, info)`` is called after each
    stage's Hessian forwards (``"hessian"``), after each solve
    (``"solve"``; ``info``: the linear's ``name``, its Hessian ``h``, the
    dense ``[K, N]`` weight ``w`` and the result ``new_w``) and after the
    quantized re-forward (``"forward"``).  Only when it is given is the
    device synchronised before each reading of the clock.
    """
    if spec.fmt != "int":
        raise NotImplementedError("GPTQ supports int format only")  # quant_wrapper.py:24-25
    groupsize = spec.group_size if spec.group_size > 0 else -1
    if gcfg.solver == "trueobs" and groupsize != -1:
        # the reference TrueOBS quantizer finds its params once on the
        # whole matrix (fast_trueobs.py:72-73): per-channel only
        raise NotImplementedError("TrueOBS is per-channel: use group_size<=0")

    def solve(w, h):
        k, n = w.shape
        wt = w.t().to(torch.float32).contiguous()
        if gcfg.solver == "trueobs":
            res = trueobs_quantize(
                wt, h, bits=spec.bits, sym=spec.symmetric, blocksize=gcfg.blocksize,
                percdamp=gcfg.percdamp, mse=gcfg.mse, sparseout=gcfg.sparseout,
                nearest=gcfg.nearest)
            if pack and not gcfg.sparseout:
                gres = GPTQResult(res.q, res.codes, res.scale[:, None], res.zero[:, None], None)
                return gptq_result_to_qtensor(gres, spec, k, n)
            return res.q.t().to(w.dtype).contiguous()
        res = gptq_quantize(
            wt, h, bits=spec.bits, sym=spec.symmetric, groupsize=groupsize,
            blocksize=gcfg.blocksize, percdamp=gcfg.percdamp, actorder=gcfg.act_order,
            static_groups=gcfg.static_groups, mse=gcfg.mse, trits=gcfg.trits)
        if pack and not gcfg.trits and not (gcfg.act_order and groupsize != -1):
            return gptq_result_to_qtensor(res, spec, k, n)
        return res.q.t().to(w.dtype).contiguous()  # fake-quant dense

    new_blocks = []
    xs = list(inputs)
    dev = xs[0].device
    clock = time.perf_counter

    def timed(block, phase, t0, **info):
        if observer is not None:
            _sync(dev)
            observer(block, phase, clock() - t0, info)

    with torch.no_grad(), no_tf32():
        for li, bp in enumerate(blocks):
            if progress:
                progress(f"GPTQ block {li + 1}/{len(blocks)}")
            lin_names = [k for k, v in annotate_linears(bp).items()
                         if isinstance(v, dict) and "name" in v]
            stages = [lin_names] if stage_order is None else [
                [n for n in st if n in lin_names] for st in stage_order]
            new_bp = dict(bp)
            for stage in stages:
                if not stage:
                    continue
                hs: Dict[str, Any] = {}
                ns: Dict[str, torch.Tensor] = {}
                for name in stage:
                    cdim = bp[name]["w"].shape[0]
                    hs[name] = torch.zeros((cdim, cdim), dtype=torch.float32, device=dev)
                    ns[name] = torch.zeros((), dtype=torch.float32, device=dev)

                def record(name, x, _stage=tuple(stage)):
                    if name in _stage:
                        hs[name], ns[name] = hessian_update(hs[name], ns[name], x)

                # Hessians over the block with the earlier stages quantized
                t0 = clock()
                current = annotate_linears(new_bp)
                with recording_linears(record):
                    for x in xs:
                        block_apply(x, current)
                timed(li, "hessian", t0)
                for name in stage:
                    t0 = clock()
                    new_w = solve(bp[name]["w"], hs[name])
                    timed(li, "solve", t0, name=name, h=hs[name], w=bp[name]["w"], new_w=new_w)
                    new_bp[name] = {**bp[name], "w": new_w}
                    hs[name] = None  # free

            # the next block's inputs, from the quantized block
            t0 = clock()
            xs = [block_apply(x, new_bp) for x in xs]
            timed(li, "forward", t0)
            new_blocks.append(new_bp)
    return new_blocks


# ---------------------------------------------------------- family adapters

def _llama_ctx(params, cfg, sample):
    from ..models import llama as L
    from ..models.common import causal_mask, rope_tables

    dev = params["embed"].device
    s = sample.shape[1]
    cos, sin = rope_tables(torch.arange(s, device=dev), cfg.hd, cfg.rope_theta,
                           cfg.condense_ratio)
    mask = causal_mask(s, device=dev)
    x0 = params["embed"][sample]

    def apply(x, bp):
        return L._block(x, bp, cfg, cos, sin, mask, None)[0]

    return x0, apply


def _opt_ctx(params, cfg, sample):
    from ..models import opt as O
    from ..models.common import causal_mask

    dev = params["embed"].device
    s = sample.shape[1]
    mask = causal_mask(s, device=dev)
    x0 = params["embed"][sample] + params["embed_pos"][torch.arange(s, device=dev)
                                                       + O.POS_OFFSET]

    def apply(x, bp):
        return O._block(x, bp, cfg, mask, None)[0]

    return x0, apply


def _bloom_ctx(params, cfg, sample):
    from ..models import bloom as B
    from ..models.common import causal_mask, layernorm

    dev = params["embed"].device
    s = sample.shape[1]
    mask = causal_mask(s, device=dev)
    bias = B._alibi_bias(cfg, s, dev)
    x0 = layernorm(params["embed"][sample], params["embed_norm"]["w"],
                   params["embed_norm"]["b"], cfg.layer_norm_eps)

    def apply(x, bp):
        return B._block(x, bp, cfg, mask, bias, None)[0]

    return x0, apply


_FAMILY_CTX = {"llama": _llama_ctx, "opt": _opt_ctx, "bloom": _bloom_ctx}

# the true-sequential order within a block (reference gptq/llama.py:75-83)
_FAMILY_STAGES = {
    "llama": [["k", "v", "q"], ["o"], ["up", "gate"], ["down"]],
    "opt": [["k", "v", "q"], ["o"], ["fc1"], ["fc2"]],
    "bloom": [["k", "v", "q"], ["o"], ["fc1"], ["fc2"]],
}


def quantize_model_gptq(
    params: Dict[str, Any],
    cfg,
    family: str,
    calib_samples: List[np.ndarray],  # each [1, S] int tokens
    spec: QuantSpec,
    gcfg: GPTQConfig = GPTQConfig(),
    pack: bool = True,
    progress: Optional[Callable[[str], None]] = print,
    true_sequential: bool = False,
    observer: Optional[Callable[[int, str, float, Dict[str, Any]], None]] = None,
) -> Dict[str, Any]:
    """Whole-model layer-sequential GPTQ on the params' device; returns the
    new params tree.  Only ``params["layers"]`` are calibrated: the
    lm_head stays dense.  ``observer``: see :func:`quantize_blocks_gptq`."""
    ctx_fn = _FAMILY_CTX[family]
    dev = params["embed"].device
    xs, apply = [], None
    for sample in calib_samples[: gcfg.nsamples]:
        tokens = torch.as_tensor(np.asarray(sample), dtype=torch.int64, device=dev)
        x0, apply = ctx_fn(params, cfg, tokens)
        xs.append(x0)
    new_layers = quantize_blocks_gptq(
        xs, params["layers"], apply, spec, gcfg, pack=pack, progress=progress,
        stage_order=_FAMILY_STAGES[family] if true_sequential else None,
        observer=observer)
    return {**params, "layers": new_layers}
