#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``iron_weight_only_quant_tpu_torch`` only (no JAX) through twenty-five
phases; any failing phase ends the run with a non-zero exit code.  The W4,
fp4 and fp6 models run all 32 layers of LLaMA-2-7B; the W8, W3 and fp8
models, whose kernels those paths do not carry but which add time, run
``CUT_LAYERS`` (8) layers at full width.

1. Build: compile the CUDA kernels in ``csrc/`` with ``nvcc`` (one process
   per source, all at once) and print the card's name and power limit.
2. W4 kernels vs plain: each W4 kernel against its plain PyTorch version at
   the five main-path shapes of a LLaMA-2-7B W4 g128 model, at decode M=8
   and a prefill M, plus a ``k_pad`` artifact and a layer-stacked call with
   layer > 0; untimed, at every other row count the main paths give the
   kernels (serve's prefill waves, generate's prefill).  Prints error,
   kernel time, plain time, ``torch.matmul`` on a pre-dequantized bf16
   weight (a yardstick, never used by the port) and the byte/operation
   bound of each call.
3. W4 two-layer model: ``llama_forward`` logits at full 7B width with the
   kernels on the card against the same params through the plain path on
   the CPU, in float32 and in bfloat16.
4. W4 full model: 32-layer 7B-width W4 model quantized layer by layer on
   the card, ``InferenceEngine.generate`` on 8 prompts of different
   lengths, greedy, 32 new tokens; then two ``InferenceEngine.serve`` runs
   of the serving traffic (phase 7).  The launch counters are zeroed just
   before each run and read just after: both kernels must have run exactly
   as often as the model's shape says, and the plain versions never.
5. W8 kernels vs plain: phase 2 for the int8 g128 kernels, plus a
   per-channel symmetric artifact.
6. W8 two-layer model: phase 3 with int8 g128 weights.
7. W8 serve: 8-layer 7B-width W8 model, ``InferenceEngine.serve`` with
   the traffic of the JAX package's ``bench.py`` ``serve_throughput`` (8
   slots, 16 requests of 16-64 tokens, 32 new tokens, 16 steps per sync,
   greedy): one warm-up run, then 3 timed runs, reported by their median
   (the best beside it).  Launch counts are exact per run, the tokens
   repeat across runs.  One more run under
   ``torch.profiler`` (W4 in phase 4 too) gives the device's busy time,
   idle share and device time by kernel.
8. Int-activation kernels vs plain: the W4A8, W4A16, W8A8 and W8A16
   kernels (``activation_bits`` 8 and 16) against their plain versions at
   the five main-path shapes (qkv and gate_up with the norm applied before
   quantizing, as the main path calls them), timed at M=8 and M=256 as in
   phase 2, untimed at the other main-path row counts; per kernel also a
   layer-stacked call, a ``k_pad`` artifact, a per-channel symmetric one
   and an f32 x; and the row pass's int8 planes and row scales bit-equal
   to the plain ``quantize_activations`` on the card.
9. Two-layer logits with activation bits: phase 3 under A8 and A16, W4
   and W8.
10. W4 A-serve: the 32-layer W4 model of phase 4, ``serve`` of phase 7's
    traffic with ``prefill_activation_bits=8`` and ``activation_bits=16``
    (waves on W4A8, decode steps on W4A16); warm-up, median of 3, one
    profiled run; launch counts exact per run.
11. W8 A-serve: the 8-layer W8 model of phase 7 with ``prefill_activation_bits=16``
    and ``activation_bits=8`` (waves on W8A16, decode steps on W8A8).
12. W3 kernels vs plain: the three s21 3-bit kernels (``w3_matmul``,
    ``w3a8_matmul``, ``w3a16_matmul``) against their plain versions at the
    five main-path shapes of a LLaMA-2-7B W3 g128 model (down's K=11008
    stored as 11264, ``pad_k_to=1024``; lm_head N padded to 32256), timed at
    M=8 and M=256 as in phase 2, untimed at the other main-path row counts;
    qkv and gate_up also once with ``pre_norm`` (x normalized in torch
    before ``w3_matmul``, in the row pass of the A-kernels); per kernel also
    an f32 x, g128 symmetric, per-channel asymmetric and per-tensor
    symmetric artifacts, and a layer-stacked call (layer 2 of 3, side info
    padded by 2 rows).
13. W3 two-layer logits: phase 3 with the W3 model, with bf16/f32
    activations, A8 and A16.
14. W3 model: 8-layer 7B-width W3 model (every linear int3 g128
    asym, ``pad_n_to=512``, ``pad_k_to=1024``) built on the card;
    ``generate`` as in phase 4; ``serve`` of phase 7's traffic (warm-up,
    median of 3, profiled run); and the A-serve of phase 10 (A8 waves on
    ``w3a8_matmul``, A16 decode on ``w3a16_matmul``).  Every linear of a
    forward takes ``w3_matmul`` (4 per layer and the lm_head), so the
    launch counts are ``forwards * (4L + 1)``.
15. The XLA route on the card: at the o shape (4096x4096), the artifacts
    the JAX package computes on its XLA path by their format (16-bit side
    info, ``k_shards=2``, int2, approximate fp4, int3 K=1088 g64, and fp6
    K=512 g256, whose groups straddle the K/4 quarters) each take the route
    once (``ROUTE_CALLS``, no launch) and match the same route on the CPU;
    an fp6 nq42 E3M2 g128 artifact launches ``lut6_matmul`` once.
16. Format zoo on the card: for a K=4096 and a K=11008 weight, the
    card-built fp4 E2M1 g128 asymmetric, fp8 E4M3 g128 symmetric, bfp4 g128
    and bfp8 g128 artifacts (``pad_n_to=512``) are byte-equal to CPU-built
    ones, scales, zeros and codebooks included.
17. LUT kernels vs plain: ``lut4_matmul`` (fp4 E2M1 g128 asymmetric),
    ``lut4a16_matmul`` (the same under A16) and ``lut8_matmul`` (fp8 E4M3
    g128 symmetric) at the five main-path shapes, timed at M=8 and M=256
    as in phase 2, untimed at the other main-path row counts; qkv and
    gate_up also once with ``pre_norm`` (x normalized in torch first, in
    the row pass under A16); at the down shape fp4 E2M1 symmetric and
    E1M2 g64 (lut4, lut4a16), fp8 E4M3 per-channel asymmetric and E3M4
    g128 (lut8), an f32 x and a layer-stacked call per kernel; and bfp4 and
    bfp8 artifacts on ``w4_matmul``, ``w4a16_matmul``, ``w8_matmul`` and
    ``w8a16_matmul``.
18. Two-layer 7B-width fp4 (also under A16) and fp8 logits, kernels vs
    the plain path on the CPU, as phase 3.
19. FP4 full model: 32-layer 7B-width fp4 E2M1 g128 asymmetric model built
    on the card (``pad_n_to=512``, the lm_head included); ``generate`` as
    in phase 4, ``serve`` of phase 7's traffic (warm-up, median of 3,
    profiled run) and a serve with A16 waves and A16 decode (LUT has no
    A8).  Every linear takes ``lut4_matmul`` (``lut4a16_matmul`` under
    A16): ``forwards * (4L + 1)`` launches, no plain call, no route call.
20. FP8 model: 8-layer 7B-width fp8 E4M3 g128 symmetric model,
    ``serve`` as in phase 7, every linear on ``lut8_matmul``.
21. FP6 kernels vs plain: ``lut6_matmul`` and ``lut6a16_matmul`` on fp6
    E2M3 g128 symmetric artifacts in the nq42 layout (``pad_k_to=1024``:
    down's K=11008 stored as 11264) at the five main-path shapes, timed at
    M=8 and M=256, untimed at the other main-path row counts, qkv and
    gate_up also with ``pre_norm``; at the down shape E3M2 g128
    asymmetric, E2M3 g64 symmetric and per-channel asymmetric artifacts, an
    f32 x and a stacked call per kernel; E3M2 under A16 warns and launches
    ``lut6_matmul``.
22. FP6 two-layer 7B-width logits (bf16/f32 activations and A16), kernels
    vs the plain path on the CPU, as phase 3.
23. FP6 full model: 32-layer 7B-width fp6 E2M3 g128 symmetric model built
    on the card (``pad_n_to=512``, ``pad_k_to=1024``, the lm_head
    included); ``generate`` as in phase 4, ``serve`` of phase 7's traffic
    (warm-up, median of 3, profiled run) and a serve with A16 waves and A16
    decode.  Every linear takes ``lut6_matmul`` (``lut6a16_matmul`` under
    A16): ``forwards * (4L + 1)`` launches, no plain call, no route call.
24. W4 inner-loop probes: both modes of ``w4_inner_matmul`` (``f32``,
    ``magic``) against their plain versions at the five main-path shapes of
    a W4 g128 model, timed at M=8 and M=256, plus an f32 x and a ``k_pad``
    artifact (down, 11008 stored as 11264), and untimed at M=8 at each of
    the probe's three shapes (4096x11264 among them) with the probe's spec;
    then the probe entry point
    (``probes/probe_w4_inner.py``) at its three shapes, its lines and JSON
    passed through, with exact launch counts (``base``, ``f32``, ``magic``,
    ``w4a8``, ``a16``), no plain call, no route call.
25. Report: the generate and serve JSON lines, the card line, the
    per-kernel JSON line, and as the last line ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present or
when the port's package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

REL_TOL_BF16 = 1e-2  # kernel vs plain, max|y - y_ref| / max|y_ref|, bf16 x
REL_TOL_F32 = 1e-4  # the same for f32 x (int-activation kernels)
LOGITS_TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # same measure on logits
# Under A8 the logits of two runs whose activations differ in the last bit
# differ by the A8 quantizer's own noise, not by rounding: one code rounding
# the other way (a step of 1/127 of the row's maximum) shifts the next
# layer's inputs enough to move many more codes, so a one-ulp change of the
# embedding moves two-layer 7B-width A8 logits by a few percent of their
# maximum.  A8 is held to this limit in both dtypes (the kernels themselves
# are held to their plain versions on equal inputs in phase 8); A16, whose
# step is 1/32512, to LOGITS_TOL.
LOGITS_TOL_A8 = 1e-1
DECODE_M = 8
PREFILL_M = 256
BATCH = 8
NEW_TOKENS = 32
PROMPT_LENS = (9, 13, 17, 21, 25, 29, 33, 37)
EXTRA_K, EXTRA_N = 11008, 4096  # the down shape, for the k_pad and stacked calls
SERVE_SLOTS = 8  # bench.py serve_throughput: 2 * slots requests, seed 3
SERVE_CHUNK = 16
SERVE_RUNS = 3  # timed runs after one warm-up; the median is reported
# Row counts the main paths give the kernels beside DECODE_M and PREFILL_M,
# checked untimed: serve's prefill waves are [slots, bucket] forwards with
# a power-of-2 bucket from 8 up (the traffic's prompts of at most 64 tokens
# stop at 64), generate's prefill is [BATCH, longest prompt]
WAVE_M = tuple(sorted(({SERVE_SLOTS * b for b in (8, 16, 32, 64)}
                       | {BATCH * max(PROMPT_LENS)}) - {DECODE_M, PREFILL_M}))
KERNEL_SOURCES = {  # kernel -> (source, the TPU kernel it replaces)
    "w4_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w4_matmul.cu",
                  "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:319"),
    "w4_matmul_prenorm": ("iron_weight_only_quant_tpu_torch/csrc/w4_matmul_prenorm.cu",
                          "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:328"),
    "w8_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w8_matmul.cu",
                  "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:1057"),
    "w8_matmul_prenorm": ("iron_weight_only_quant_tpu_torch/csrc/w8_matmul_prenorm.cu",
                          "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:380"),
    "w4a8_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w4a8_matmul.cu",
                    "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:319"),
    "w8a8_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w8a8_matmul.cu",
                    "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:1057"),
    "w4a16_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w4a16_matmul.cu",
                     "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:418"),
    "w8a16_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w8a16_matmul.cu",
                     "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:449"),
    "w3_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w3_matmul.cu",
                  "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:467"),
    "w3a8_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w3a8_matmul.cu",
                    "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:467"),
    "w3a16_matmul": ("iron_weight_only_quant_tpu_torch/csrc/w3a16_matmul.cu",
                     "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:533"),
    "lut4_matmul": ("iron_weight_only_quant_tpu_torch/csrc/lut4_matmul.cu",
                    "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:739"),
    "lut4a16_matmul": ("iron_weight_only_quant_tpu_torch/csrc/lut4a16_matmul.cu",
                       "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:771"),
    "lut8_matmul": ("iron_weight_only_quant_tpu_torch/csrc/lut8_matmul.cu",
                    "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:811"),
    "lut6_matmul": ("iron_weight_only_quant_tpu_torch/csrc/lut6_matmul.cu",
                    "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:835"),
    "lut6a16_matmul": ("iron_weight_only_quant_tpu_torch/csrc/lut6a16_matmul.cu",
                       "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:892"),
    "w4_inner_f32": ("iron_weight_only_quant_tpu_torch/csrc/w4_inner_matmul.cu",
                     "scripts/probe_w4_inner.py:67"),
    "w4_inner_magic": ("iron_weight_only_quant_tpu_torch/csrc/w4_inner_matmul.cu",
                       "scripts/probe_w4_inner.py:67"),
}
W3_PAD_K = 1024  # down's K=11008 stored as 11264: K/8 = 1408 = 11 groups of 128
FP6_PAD_K = 1024  # the same for nq42: K/4 = 2816 = 22 groups of 128
CUT_LAYERS = 8  # depth of the earlier full-model paths whose kernels the
#                 32-layer W4, fp4 and fp6 paths already drive at full depth


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ model

def build_quantized_llama(cfg, generator, spec, dtype, device, pad_k_to=1):
    """Random quantized LLaMA built on the card, quantizing each linear as
    it is made, so the dense model never exists whole.  Norm gammas are 1,
    so marking them folded (``None``) is exact; every linear, the lm_head
    included, is a ``spec`` artifact with N padded to 512 and K to
    ``pad_k_to``."""
    import torch

    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    h, inter, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    def qlin(kin, kout, scale=None):
        scale = kin**-0.5 if scale is None else scale
        return {"w": quantize_tensor(normal(kin, kout) * scale, spec,
                                     pad_n_to=512, pad_k_to=pad_k_to), "b": None}

    layers = [{
        "input_norm": None,
        "q": qlin(h, qdim), "k": qlin(h, kvdim), "v": qlin(h, kvdim),
        "o": qlin(qdim, h),
        "post_norm": None,
        "gate": qlin(h, inter), "up": qlin(h, inter), "down": qlin(inter, h),
    } for _ in range(cfg.num_layers)]
    return {
        "embed": (normal(cfg.vocab_size, h) * 0.02).to(dtype),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dtype, device=device),
        "lm_head": qlin(h, cfg.vocab_size, scale=0.02),
    }


# ------------------------------------------------------------- phase 2

MAIN_SHAPES = (  # name, K, member widths, prenorm, launches per decode step
    ("qkv", 4096, (4096, 4096, 4096), True, 32),
    ("o", 4096, (4096,), False, 32),
    ("gate_up", 4096, (11008, 11008), True, 32),
    ("down", 11008, (4096,), False, 32),
    ("lm_head", 4096, (32000,), False, 1),
)


def make_artifact(torch, gen, spec, k, widths, device, pad_k_to=1):
    from iron_weight_only_quant_tpu_torch.quantize import (
        concat_n,
        quantize_tensor,
        stored_spans,
    )

    qts = [quantize_tensor(torch.randn((k, n), generator=gen, device=device)
                           * k**-0.5, spec, pad_n_to=512, pad_k_to=pad_k_to)
           for n in widths]
    if len(qts) == 1:
        return qts[0], ((0, widths[0]),)
    return concat_n(qts), stored_spans(qts)


def call_cost(qt, m: int, x_bytes: int, abits=None):
    """(bytes, operations, operations peak) the call needs: each input read
    once, the output written once; operations 2*M*K*N.  With activation
    bits x is read as its int8 planes (one for A8, two for A16) and the
    product is int8, twice over for A16.  The peak, in operations a second,
    is the card's from ``utils.profiling``."""
    from iron_weight_only_quant_tpu_torch.utils.profiling import (
        H100_BF16_TFLOPS,
        H100_INT8_TOPS,
    )

    k, n = qt.shape
    side = qt.scales.numel() * qt.scales.element_size()
    if qt.zeros is not None:
        side += qt.zeros.numel() * qt.zeros.element_size()
    planes = 1 if abits is None else abits // 8
    x_in = m * k * (x_bytes if abits is None else planes)
    nbytes = qt.qweight.numel() + side + x_in + m * n * x_bytes
    peak = (H100_BF16_TFLOPS if abits is None else H100_INT8_TOPS) * 1e12
    return nbytes, 2 * m * k * n * planes, peak


def bound(nbytes: int, ops: int, peak: float):
    """Least time (ms) for ``nbytes`` over the card's memory rate and ``ops``
    over ``peak`` (operations a second), and which of the two bounds it."""
    from iron_weight_only_quant_tpu_torch.utils.profiling import H100_HBM_GBPS

    t_bytes, t_ops = nbytes / (H100_HBM_GBPS * 1e9), ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_call(torch, name, qt, x, run, run_plain, w_lib=None, abits=None):
    """One kernel call against its plain version; records errors and times."""
    y = run(x, qt)
    y_ref = run_plain(x, qt)
    torch.cuda.synchronize()
    if y.shape != y_ref.shape or not torch.isfinite(y).all():
        fail(f"{name}: shape {tuple(y.shape)} vs {tuple(y_ref.shape)} or non-finite output")
    diff = (y.float() - y_ref.float()).abs().max().item()
    ref_max = y_ref.float().abs().max().item()
    rel = diff / max(ref_max, 1e-30)
    tol = REL_TOL_F32 if x.dtype == torch.float32 else REL_TOL_BF16
    ok = rel <= tol
    rec = {"call": name, "M": x.shape[0], "K": qt.shape[0], "N": qt.shape[1],
           "dtype": str(x.dtype).split(".")[-1], "max_abs_err": diff, "rel_err": rel,
           "tol": tol, "ok": ok}
    if w_lib is not None:  # timed: a main-path shape
        from iron_weight_only_quant_tpu_torch.utils.timing import copies_for, device_ms

        nbytes, ops, peak = call_cost(qt, x.shape[0], x.element_size(), abits)
        reps = copies_for(qt.qweight.numel())
        qts = [qt] + [qt.map_arrays(torch.clone) for _ in range(reps - 1)]
        rec["ms"] = device_ms(lambda i: run(x, qts[i % reps]), 20)
        rec["plain_ms"] = device_ms(lambda i: run_plain(x, qts[i % reps]), 4)
        lib_reps = copies_for(w_lib.numel() * w_lib.element_size())
        ws = [w_lib] + [w_lib.clone() for _ in range(lib_reps - 1)]
        rec["library_ms"] = device_ms(lambda i: torch.matmul(x, ws[i % lib_reps]), 20)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, peak)
        rec["bytes"], rec["ops"], rec["peak"] = nbytes, ops, peak
        del qts, ws
    print("  " + json.dumps(rec), flush=True)
    if not ok:
        fail(f"{name}: kernel vs plain rel err {rel:.3e} > {tol}")
    return rec


def phase_kernels(torch, device, spec, names, extra_specs=()):
    """Both kernels of a layout (``names``: flat, prenorm) against their
    plain versions; ``extra_specs`` are further (label, spec) artifacts
    checked once at the down shape, untimed."""
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    per_kernel = {name: [] for name in names}
    eps = 1e-5

    def runner(prenorm, layer=None):
        """(kernel call, plain call); ``layer`` for a stacked artifact."""
        pre = eps if prenorm else None
        if layer is None:
            return (lambda x, qt: dm.fused_quantized_matmul(x, qt, pre_norm=pre),
                    lambda x, qt: dm.dequant_matmul_plain(x, qt, pre_norm=pre))
        return (lambda x, qt: dm.fused_quantized_matmul_stacked(x, qt, layer, pre_norm=pre),
                lambda x, qt: dm.dequant_matmul_plain(x, qt, pre_norm=pre, layer=layer))

    for name, k, widths, prenorm, per_step in MAIN_SHAPES:
        qt, spans = make_artifact(torch, gen, spec, k, widths, device)
        w_lib = dequantize_weight(qt, torch.bfloat16)
        run, run_plain = runner(prenorm)
        kname = names[prenorm]
        if dm.kernel_name(qt, eps if prenorm else None) != kname:
            fail(f"{name}: the artifact does not dispatch to {kname}")
        for m in (DECODE_M, PREFILL_M) + WAVE_M:
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            rec = check_call(torch, f"{kname}:{name}:M={m}", qt, x, run, run_plain,
                             w_lib if m in (DECODE_M, PREFILL_M) else None)
            rec.update(kernel=kname, shape=name, per_step=per_step,
                       stored_n=qt.qweight.shape[-1], spans=spans)
            per_kernel[kname].append(rec)
        del qt, w_lib
        torch.cuda.empty_cache()

    # a k_pad artifact (K=11008 stored as 11264) and a stacked call, layer 2
    # of 3, with side info padded by 2 rows (side_pad=2), for both kernels
    for prenorm in (False, True):
        run, run_plain = runner(prenorm)
        kname = names[prenorm]
        for label, extra in extra_specs:
            qt, _ = make_artifact(torch, gen, extra, EXTRA_K, (EXTRA_N,), device)
            x = torch.randn((DECODE_M, EXTRA_K), generator=gen,
                            device=device).to(torch.bfloat16)
            check_call(torch, f"{kname}:{label}", qt, x, run, run_plain)
            del qt
        qt, _ = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device,
                              pad_k_to=1024)
        if qt.k_pad == 0:
            fail("the k_pad artifact has no padding")
        x = torch.randn((DECODE_M, EXTRA_K), generator=gen,
                        device=device).to(torch.bfloat16)
        check_call(torch, f"{kname}:k_pad", qt, x, run, run_plain)
        layers = [make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device)[0]
                  for _ in range(3)]
        pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 2))  # noqa: E731
        st = layers[0].replace(
            qweight=torch.stack([q.qweight for q in layers]),
            scales=torch.stack([pad(q.scales) for q in layers]),
            zeros=torch.stack([pad(q.zeros) for q in layers]), side_pad=2)
        # the plain version of a stacked call dequantizes
        # index_stacked(st, 2), the oracle of the stacked kernel
        check_call(torch, f"{kname}:stacked:layer=2", st, x, *runner(prenorm, 2))
        del qt, layers, st
    torch.cuda.empty_cache()
    return per_kernel


# ------------------------------------------------------------- phase 3

def phase_two_layers(torch, device, spec, cfg_full, abits_list=(None,), pad_k_to=1):
    """Two-layer logits, kernels on the card against the plain path on the
    CPU, in f32 and bf16, under each activation-bits setting of
    ``abits_list`` (None: bf16/f32 activations)."""
    import dataclasses

    from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
    from iron_weight_only_quant_tpu_torch.models.llama import (
        fuse_llama_projections,
        llama_forward,
    )
    from iron_weight_only_quant_tpu_torch.ops.qmatmul import activation_quant

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = fuse_llama_projections(
        build_quantized_llama(cfg, gen, spec, torch.float32, device, pad_k_to))
    cpu_params = params_from_numpy(params, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=device)
    out = {}
    for dtype, abits in [(d, a) for a in abits_list for d in (torch.float32, torch.bfloat16)]:
        for p in (params, cpu_params):
            p["embed"] = p["embed"].to(dtype)
            p["final_norm"] = p["final_norm"].to(dtype)
        with torch.inference_mode(), activation_quant(abits):
            lg, _ = llama_forward(params, tokens, cfg)
            lg_ref, _ = llama_forward(cpu_params, tokens.cpu(), cfg)
        torch.cuda.synchronize()
        lg, lg_ref = lg.float().cpu(), lg_ref.float()
        if not torch.isfinite(lg).all():
            fail("two-layer logits are not finite")
        rel = ((lg - lg_ref).abs().max() / lg_ref.abs().max()).item()
        agree = (lg.argmax(-1) == lg_ref.argmax(-1)).float().mean().item()
        name = str(dtype).split(".")[-1]
        label = name if abits is None else f"{name} A{abits}"
        tol = LOGITS_TOL_A8 if abits == 8 else LOGITS_TOL[name]
        out[label] = {"rel_err": rel, "tol": tol, "argmax_agree": agree}
        print(f"  logits {label}: max|d|/max|ref| = {rel:.3e} (tol "
              f"{tol}), argmax agreement {agree:.4f}", flush=True)
        if rel > tol:
            fail(f"two-layer logits ({label}) rel err {rel:.3e} > {tol}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 4

def expected_launches(names, forwards: int, n_layers: int):
    """Launch counts of ``forwards`` model forwards whose linears all take
    the kernels ``names`` (flat, prenorm): o, down and the lm_head go to the
    flat kernel, the fused qkv and gate_up to the prenorm one (the same
    kernel for W3, whose pre-norm runs in torch)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    want = {name: 0 for name in dm.LAUNCHES}
    want[names[0]] += forwards * (2 * n_layers + 1)
    want[names[1]] += forwards * 2 * n_layers
    return want


def expected_a_launches(names, waves: int, steps: int, n_layers: int):
    """Launch counts of ``waves`` prefill forwards on ``names[0]`` and
    ``steps`` decode forwards on ``names[1]``: under activation bits every
    linear of a forward (4 per layer and the lm_head) takes the phase's
    int-activation kernel."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    want = {name: 0 for name in dm.LAUNCHES}
    want[names[0]] += waves * (4 * n_layers + 1)
    want[names[1]] += steps * (4 * n_layers + 1)
    return want


def check_counts(what, want):
    """Read the counters after a run: exactly the launches ``want``, no
    plain call, no call of the XLA route."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    launches, plain = dict(dm.LAUNCHES), dict(dm.PLAIN_CALLS)
    print(f"  {what}: launches {launches}, expected {want}, plain calls {plain}, "
          f"route calls {dm.ROUTE_CALLS}", flush=True)
    if launches != want:
        fail(f"{what}: kernel launches {launches} != expected {want}")
    if any(plain.values()):
        fail(f"{what}: the plain path ran on the main path: {plain}")
    if any(dm.ROUTE_CALLS.values()):
        fail(f"{what}: the XLA route ran on the main path: {dm.ROUTE_CALLS}")
    return launches


def build_model(torch, device, spec, cfg, label, seed, pad_k_to=1):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = build_quantized_llama(cfg, gen, spec, torch.bfloat16, device, pad_k_to)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"  built {cfg.num_layers}-layer {label} model in {build_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    return params, gen, build_s


def phase_generate(torch, device, spec, cfg, card, names=None, label="W4", pad_k_to=1,
                   serve_runs=1):
    """``generate`` on the ``cfg.num_layers``-layer model whose linears take ``names``
    (flat, prenorm kernel; W4's by default), then ``serve_runs`` timed
    serve runs.  Returns (generate result, serve result, fused params)."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    names = names or (dm.W4, dm.W4_PRENORM)
    params, gen, build_s = build_model(torch, device, spec, cfg, label, 0, pad_k_to)
    ecfg = EngineConfig(fuse_projections=True,
                        kv=KVCacheConfig(max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8))
    eng = InferenceEngine(params, cfg, llama_forward, family="llama",
                          engine_cfg=ecfg, dtype=torch.bfloat16, device=device)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=device).tolist() for n in PROMPT_LENS]

    warm = eng.generate(prompts, max_new_tokens=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    dm.reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = check_counts("generate", expected_launches(
        names, 1 + (NEW_TOKENS - 1), cfg.num_layers))
    if len(out) != BATCH or any(len(o) != NEW_TOKENS for o in out):
        fail(f"generate returned {[len(o) for o in out]} tokens")
    if any(not 0 <= t < cfg.vocab_size for o in out for t in o):
        fail("a generated token is out of the vocabulary")
    if any(o[:2] != w for o, w in zip(out, warm)):
        fail("greedy tokens differ between two runs of the same prompts")
    decode_s = gen_s - prefill_s
    tok_s = BATCH * (NEW_TOKENS - 1) / decode_s
    res = {"build_s": build_s, "prefill_s": prefill_s, "generate_s": gen_s,
           "decode_tok_per_s": tok_s, "prefill_tokens": BATCH * max(PROMPT_LENS),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "card": card}
    print(f"  decode {tok_s:.1f} tok/s at batch {BATCH} "
          f"({decode_s * 1e3 / (NEW_TOKENS - 1):.2f} ms/step), prefill "
          f"{prefill_s * 1e3:.1f} ms for {BATCH}x{max(PROMPT_LENS)} tokens, on {card}",
          flush=True)
    print("  first tokens: " + json.dumps([o[:8] for o in out[:2]]), flush=True)

    print(f"  -- {label} serve (one warm-up run, {serve_runs} timed)", flush=True)
    serve = phase_serve(torch, eng.params, cfg, names, serve_runs, card)
    fused = eng.params  # kept for the A-serve
    del eng, params
    torch.cuda.empty_cache()
    return res, serve, fused


# ------------------------------------------------------------- phase 7

def serve_requests(vocab_size: int):
    """The traffic of the JAX package's bench.py serve_throughput: 2 *
    slots requests of 16-64 tokens, uniform in [1, vocab), seed 3."""
    import random

    rng = random.Random(3)
    return [[rng.randint(1, vocab_size - 1) for _ in range(rng.randint(16, 64))]
            for _ in range(2 * SERVE_SLOTS)]


def percentile_ms(series, q):
    import numpy as np

    return float(np.percentile(np.asarray(series, np.float64) * 1e3, q))


def serve_engine(torch, params, cfg, **ecfg):
    """(engine, requests) of the serving traffic; the cache holds the
    longest request plus the new tokens, as bench.py sizes it.  ``ecfg``
    adds engine options (the activation bits)."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward

    reqs = serve_requests(cfg.vocab_size)
    t_need = max(len(r) for r in reqs) + NEW_TOKENS
    ecfg = EngineConfig(kv=KVCacheConfig(max_seq_len=t_need),
                        max_batch_size=SERVE_SLOTS, fuse_projections=True, **ecfg)
    eng = InferenceEngine(params, cfg, llama_forward, family="llama",
                          engine_cfg=ecfg, dtype=torch.bfloat16,
                          device=params["embed"].device)
    return eng, reqs


def profile_serve(torch, eng, reqs):
    """One more serve run under ``torch.profiler``: its wall time, the
    device's busy time (the sum of its kernel and copy intervals: one
    stream, so they do not overlap), the idle share, and the device time
    by kernel.  The profiler slows the host, so the idle share is an upper
    bound for an unprofiled run.  The device intervals are read from the
    profiler's raw records: ``prof.events()`` would first build a Python
    event for each of the run's host and device records, hundreds of
    thousands, which is slow."""
    from torch.autograd import DeviceType

    from iron_weight_only_quant_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    if not by_name:
        print("  profiler: no device events; device busy time not measured", flush=True)
        return {"wall_s": wall, "device_busy_ms": "not measured",
                "device_idle_share": "not measured"}
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    res = {"wall_s": wall, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / (wall * 1e3),
           "device_events": sum(n for n, _ in by_name.values()),
           "top_device_ms": [[k[:80], n, us / 1e3] for k, (n, us) in top]}
    print(f"  profiled serve run: wall {wall:.3f} s, device busy {busy_ms:.1f} ms "
          f"(idle {100 * res['device_idle_share']:.1f}%), "
          f"{res['device_events']} device events", flush=True)
    for k, n, ms in res["top_device_ms"]:
        print(f"    {ms:9.2f} ms {n:6d}x  {k}", flush=True)
    return res


def phase_serve(torch, params, cfg, names, runs, card, abits=None):
    """``InferenceEngine.serve`` of the serving traffic: one warm-up run,
    then ``runs`` timed runs (the median run is reported, the best wall
    time beside it), then one profiled run.  ``params`` may be fused
    already (fusing is idempotent).  Every counted run must launch
    the kernels ``names`` exactly ``n_steps`` forwards' worth, never the
    plain path, and give 32 in-vocabulary tokens per request, the same in
    every run.  With ``abits`` = (prefill_activation_bits,
    activation_bits), ``names`` are the (wave, decode) int-activation
    kernels: the waves (one per combo) launch the first, the other device
    steps the second."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    ecfg = {} if abits is None else dict(prefill_activation_bits=abits[0],
                                         activation_bits=abits[1])
    eng, reqs = serve_engine(torch, params, cfg, **ecfg)
    first = None
    timed = []
    for i in range(1 + runs):
        stats = {}
        torch.cuda.synchronize()
        dm.reset_counts()
        t0 = time.perf_counter()
        out = eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK,
                        stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if abits is None:
            want = expected_launches(names, stats["n_steps"], cfg.num_layers)
        else:  # one wave per combo
            want = expected_a_launches(names, stats["n_combos"],
                                       stats["n_steps"] - stats["n_combos"],
                                       cfg.num_layers)
        launches = check_counts(f"serve run {i}", want)
        if [len(o) for o in out] != [NEW_TOKENS] * len(reqs):
            fail(f"serve returned {[len(o) for o in out]} tokens")
        if any(not 0 <= t < cfg.vocab_size for o in out for t in o):
            fail("a served token is out of the vocabulary")
        if first is None:
            first = out
        elif out != first:
            fail("greedy serve tokens differ between runs of the same requests")
        print(f"  serve run {i}{' (warm-up)' if i == 0 else ''}: {wall:.3f} s", flush=True)
        if i > 0:
            timed.append((wall, stats, launches))
    timed.sort(key=lambda t: t[0])
    wall, stats, launches = timed[len(timed) // 2]
    n_gen = sum(len(o) for o in first)
    n_prompt = sum(len(r) for r in reqs)
    res = {
        "kernels": list(names), "activation_bits": abits,
        "requests": len(reqs), "slots": SERVE_SLOTS,
        "chunk": SERVE_CHUNK, "max_new_tokens": NEW_TOKENS, "timed_runs": runs,
        "wall_s": wall, "toks_per_s": n_gen / wall,
        "total_toks_per_s": (n_gen + n_prompt) / wall,
        "walls_s": [t[0] for t in timed], "best_toks_per_s": n_gen / timed[0][0],
        "n_generated": n_gen, "n_prompt": n_prompt,
        "syncs": stats["n_combos"] + stats["n_chunks"],
        "n_combos": stats["n_combos"], "n_chunks": stats["n_chunks"],
        "device_steps": stats["n_steps"],
        "t_combos_s": stats["t_combos_s"], "t_chunks_s": stats["t_chunks_s"],
        "ttft_p50_ms": percentile_ms(stats["ttft_s"], 50),
        "ttft_p95_ms": percentile_ms(stats["ttft_s"], 95),
        "tpot_p50_ms": percentile_ms(stats["tpot_s"], 50),
        "tpot_p95_ms": percentile_ms(stats["tpot_s"], 95),
        "latency_granularity": "host sync (a token counts when the host fetches it)",
        "launches": launches, "card": card,
    }
    print(f"  serve {res['toks_per_s']:.1f} generated tok/s, "
          f"{res['total_toks_per_s']:.1f} total tok/s, wall {wall:.3f} s (median of "
          f"{runs}; best {res['best_toks_per_s']:.1f} tok/s), {res['syncs']} syncs, "
          f"{res['device_steps']} device steps; "
          f"TTFT p50/p95 {res['ttft_p50_ms']:.1f}/{res['ttft_p95_ms']:.1f} ms, "
          f"TPOT p50/p95 {res['tpot_p50_ms']:.1f}/{res['tpot_p95_ms']:.1f} ms "
          f"(measured at sync granularity), on {card}", flush=True)
    print("  first tokens: " + json.dumps([o[:8] for o in first[:2]]), flush=True)
    res["profile"] = profile_serve(torch, eng, reqs)
    del eng
    return res


def phase_w8_serve(torch, device, spec, cfg, card, names=None, label="W8"):
    """Build the ``cfg.num_layers``-layer model of ``spec`` and ``serve`` it
    on the kernels ``names`` (flat, prenorm; W8's by default)."""
    from iron_weight_only_quant_tpu_torch.models.llama import fuse_llama_projections
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    torch.cuda.reset_peak_memory_stats()
    params, _, build_s = build_model(torch, device, spec, cfg, label, 0)
    params = fuse_llama_projections(params)  # drops the unfused artifacts
    res = phase_serve(torch, params, cfg, names or (dm.W8, dm.W8_PRENORM), SERVE_RUNS,
                      card)
    res["build_s"] = build_s
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    return res, params  # params kept for the A-serve of phase 11


# ------------------------------------------------------------- phase 8

def stacked_of(torch, layers):
    """Layer-stacked artifact of ``layers``, side info padded by 2 rows."""
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 2))  # noqa: E731
    zeros = None if layers[0].zeros is None else torch.stack([pad(q.zeros) for q in layers])
    return layers[0].replace(
        qweight=torch.stack([q.qweight for q in layers]),
        scales=torch.stack([pad(q.scales) for q in layers]), zeros=zeros, side_pad=2)


def a_runner(pre, abits, layer=None):
    """(kernel call, plain call) with ``pre_norm`` and ``activation_bits``
    given; ``layer`` for a stacked artifact."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    kw = dict(pre_norm=pre, activation_bits=abits)
    if layer is None:
        return (lambda x, qt: dm.fused_quantized_matmul(x, qt, **kw),
                lambda x, qt: dm.dequant_matmul_plain(x, qt, **kw))
    return (lambda x, qt: dm.fused_quantized_matmul_stacked(x, qt, layer, **kw),
            lambda x, qt: dm.dequant_matmul_plain(x, qt, layer=layer, **kw))


def check_row_pass(torch, gen, device):
    """The int-activation kernels' row pass against the plain
    ``quantize_activations`` on the card: int8 planes and f32 row scales
    bit-equal, at the main path's K (4096, 11008 padded to 11264) and row
    counts, bf16 and f32 x, with an all-zero row."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    checked = 0
    for bits in dm.ACTIVATION_BITS:
        for k, k_stored in ((4096, 4096), (11008, 11264)):
            for m in (DECODE_M, 512):
                for dtype in (torch.bfloat16, torch.float32):
                    x = (torch.randn((m, k), generator=gen, device=device) * 3).to(dtype)
                    x[1] = 0
                    planes, sx = dm.quantize_activations_kernel(x, bits, k_stored)
                    want, want_sx = dm.quantize_activations(x, bits)
                    torch.cuda.synchronize()
                    if not (torch.equal(planes[..., :k], want) and torch.equal(sx, want_sx)
                            and not planes[..., k:].any()):
                        fail(f"row pass A{bits} K={k} M={m} {dtype}: codes or row "
                             "scales differ from quantize_activations")
                    checked += 1
    print(f"  row pass: int8 planes and row scales bit-equal to the plain version "
          f"in {checked} calls", flush=True)
    return checked


def phase_a_kernels(torch, device, specs):
    """The int-activation kernels against their plain versions.  ``specs``
    maps storage bits (4, 8) to the model's QuantSpec.  Every main-path
    shape takes the kernel of the phase's activation bits; qkv and gate_up
    with ``pre_norm`` (normalized in the row pass before quantizing)."""
    from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, QuantSpec
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    per_kernel = {}
    eps = 1e-5

    for wbits, spec in specs.items():
        for name, k, widths, prenorm, per_step in MAIN_SHAPES:
            qt, spans = make_artifact(torch, gen, spec, k, widths, device)
            w_lib = dequantize_weight(qt, torch.bfloat16)
            pre = eps if prenorm else None
            for abits in dm.ACTIVATION_BITS:
                kname = dm.kernel_name(qt, pre, abits)
                if not dm.kernel_supported(qt, abits):
                    fail(f"{name}: no int-activation kernel takes the W{wbits} artifact")
                for m in (DECODE_M, PREFILL_M) + WAVE_M:
                    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                    timed = m in (DECODE_M, PREFILL_M)
                    rec = check_call(torch, f"{kname}:{name}:M={m}", qt, x,
                                     *a_runner(pre, abits), w_lib if timed else None, abits)
                    rec.update(kernel=kname, shape=name, per_step=per_step,
                               stored_n=qt.qweight.shape[-1], spans=spans)
                    per_kernel.setdefault(kname, []).append(rec)
            del qt, w_lib
            torch.cuda.empty_cache()

        # once per kernel at the down shape: an f32 x, a per-channel
        # symmetric artifact, a k_pad artifact (11008 stored as 11264) and a
        # stacked call (layer 2 of 3, side_pad=2)
        perchannel = QuantSpec(fmt="int", bits=wbits, group_size=PER_CHANNEL, symmetric=True)
        qt = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device)[0]
        qt_pc = make_artifact(torch, gen, perchannel, EXTRA_K, (EXTRA_N,), device)[0]
        qt_kp = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device, pad_k_to=1024)[0]
        if qt_kp.k_pad == 0:
            fail("the k_pad artifact has no padding")
        st = stacked_of(torch, [qt] + [
            make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device)[0] for _ in range(2)])
        x = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device)
        xb = x.to(torch.bfloat16)
        for abits in dm.ACTIVATION_BITS:
            kname = dm.kernel_name(qt, None, abits)
            check_call(torch, f"{kname}:f32", qt, x, *a_runner(None, abits))
            check_call(torch, f"{kname}:perchannel_sym", qt_pc, xb, *a_runner(None, abits))
            check_call(torch, f"{kname}:k_pad", qt_kp, xb, *a_runner(None, abits))
            check_call(torch, f"{kname}:stacked:layer=2", st, xb, *a_runner(None, abits, 2))
        del qt, qt_pc, qt_kp, st
        torch.cuda.empty_cache()
    return per_kernel, check_row_pass(torch, gen, device)


# ------------------------------------------------------------- phase 12

def phase_w3_kernels(torch, device, spec):
    """The three s21 kernels against their plain versions: ``w3_matmul``
    (bf16/f32 x), ``w3a8_matmul`` and ``w3a16_matmul`` (activation bits 8
    and 16), at the five main-path shapes with down's K padded to 11264.
    The kernels are timed alone; qkv and gate_up are then checked once with
    ``pre_norm`` as the main path calls them (x normalized in torch before
    ``w3_matmul``, in the row pass of the A-kernels)."""
    from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, PER_TENSOR, QuantSpec
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    per_kernel = {}
    eps = 1e-5
    abits_all = (None,) + dm.ACTIVATION_BITS

    for name, k, widths, prenorm, per_step in MAIN_SHAPES:
        qt, spans = make_artifact(torch, gen, spec, k, widths, device, pad_k_to=W3_PAD_K)
        w_lib = dequantize_weight(qt, torch.bfloat16)
        for abits in abits_all:
            kname = dm.kernel_name(qt, eps if prenorm else None, abits)
            if not dm.kernel_supported(qt, abits) or kname not in KERNEL_SOURCES:
                fail(f"{name}: no W3 kernel takes the artifact (activation bits {abits})")
            for m in (DECODE_M, PREFILL_M) + WAVE_M:
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                timed = m in (DECODE_M, PREFILL_M)
                rec = check_call(torch, f"{kname}:{name}:M={m}", qt, x, *a_runner(None, abits),
                                 w_lib if timed else None, abits)
                rec.update(kernel=kname, shape=name, per_step=per_step,
                           stored_n=qt.qweight.shape[-1], spans=spans)
                per_kernel.setdefault(kname, []).append(rec)
            if prenorm:
                x = torch.randn((DECODE_M, k), generator=gen, device=device).to(torch.bfloat16)
                check_call(torch, f"{kname}:{name}:pre_norm", qt, x, *a_runner(eps, abits))
        del qt, w_lib
        torch.cuda.empty_cache()

    # once per kernel at the down shape: an f32 x, the other side layouts
    # and a stacked call (layer 2 of 3, side_pad=2)
    others = {label: make_artifact(torch, gen, other, EXTRA_K, (EXTRA_N,), device,
                                   pad_k_to=W3_PAD_K)[0]
              for label, other in (
                  ("g128_sym", QuantSpec(fmt="int", bits=3, group_size=128, symmetric=True)),
                  ("perchannel_asym", QuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL,
                                                symmetric=False)),
                  ("pertensor_sym", QuantSpec(fmt="int", bits=3, group_size=PER_TENSOR,
                                              symmetric=True)))}
    layers = [make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device,
                            pad_k_to=W3_PAD_K)[0] for _ in range(3)]
    st = stacked_of(torch, layers)
    x = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device)
    xb = x.to(torch.bfloat16)
    for abits in abits_all:
        kname = dm.kernel_name(layers[0], None, abits)
        check_call(torch, f"{kname}:f32", layers[0], x, *a_runner(None, abits))
        for label, qt in others.items():
            check_call(torch, f"{kname}:{label}", qt, xb, *a_runner(None, abits))
        check_call(torch, f"{kname}:stacked:layer=2", st, xb, *a_runner(None, abits, 2))
    del others, layers, st
    torch.cuda.empty_cache()
    return per_kernel


# ------------------------------------------------------------- phase 15

def phase_route(torch, device):
    """The artifacts the JAX package computes on its XLA path by their
    format, at the o shape: each takes the route once on the card and
    matches the same route on the CPU (an fp6 artifact whose groups straddle
    the K/4 quarters among them); an fp6 nq42 artifact whose groups do not
    launches ``lut6_matmul`` instead."""
    from iron_weight_only_quant_tpu_torch.config import QuantSpec, fp_spec
    from iron_weight_only_quant_tpu_torch.ops import qmatmul
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    w4 = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    cases = {  # label: (spec, quantize_tensor kwargs, K)
        "side_f16": (w4, dict(side_dtype=torch.float16), 4096),
        "k_shards_2": (w4, dict(k_shards=2), 4096),
        "int2": (QuantSpec(fmt="int", bits=2, group_size=128, symmetric=False), {}, 4096),
        "fp4_approx": (fp_spec("fp4", 2, 1, group_size=128, approximate=True), {}, 4096),
        "int3_k1088_g64": (QuantSpec(fmt="int", bits=3, group_size=64, symmetric=False),
                           {}, 1088),
        "fp6_k512_g256": (fp_spec("fp6", 2, 3, group_size=256), {}, 512),
    }
    out = {}
    for label, (spec, kw, k) in cases.items():
        w = torch.randn((k, 4096), generator=gen, device=device) * k**-0.5
        qt = quantize_tensor(w, spec, **kw)
        if not dm.xla_route(qt) or dm.kernel_supported(qt):
            fail(f"route {label}: the artifact does not take the route")
        x = torch.randn((DECODE_M, k), generator=gen, device=device).to(torch.bfloat16)
        dm.reset_counts()
        y = qmatmul.quantized_matmul(x, qt, pre_norm=1e-5, activation_bits=16)
        torch.cuda.synchronize()
        counts = (dict(dm.ROUTE_CALLS), sum(dm.LAUNCHES.values()),
                  sum(dm.PLAIN_CALLS.values()))
        y_ref = qmatmul.quantized_matmul(x.cpu(), qt.map_arrays(lambda a: a.cpu()),
                                         pre_norm=1e-5)
        rel = ((y.float().cpu() - y_ref.float()).abs().max()
               / y_ref.float().abs().max()).item()
        out[label] = {"rel_err": rel, "route_calls": counts[0][dm.ROUTE]}
        print(f"  route {label}: route calls {counts[0]}, launches {counts[1]}, plain "
              f"calls {counts[2]}, rel err vs the CPU route {rel:.3e} (tol {REL_TOL_BF16})",
              flush=True)
        if counts != ({dm.ROUTE: 1}, 0, 0) or not torch.isfinite(y).all() \
                or rel > REL_TOL_BF16:
            fail(f"route {label}: counts {counts}, rel err {rel:.3e}")
    qt = quantize_tensor(torch.randn((4096, 4096), generator=gen, device=device) * 0.02,
                         fp_spec("fp6", 3, 2, group_size=128))
    x = torch.randn((DECODE_M, 4096), generator=gen, device=device).to(torch.bfloat16)
    dm.reset_counts()
    y = qmatmul.quantized_matmul(x, qt, pre_norm=1e-5)
    torch.cuda.synchronize()
    counts = (dict(dm.LAUNCHES), sum(dm.PLAIN_CALLS.values()), dm.ROUTE_CALLS[dm.ROUTE])
    y_ref = dm.dequant_matmul_plain(x, qt, pre_norm=1e-5)
    rel = ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item()
    print(f"  fp6 nq42 E3M2 g128: launches {counts[0][dm.LUT6]} lut6_matmul, plain calls "
          f"{counts[1]}, route calls {counts[2]}, rel err vs plain {rel:.3e}", flush=True)
    if counts != ({**{k: 0 for k in dm.LAUNCHES}, dm.LUT6: 1}, 0, 0) or rel > REL_TOL_BF16:
        fail(f"fp6 nq42: counts {counts}, rel err {rel:.3e}")
    out["fp6_nq42_lut6"] = {"rel_err": rel, "launches": 1}
    return out


# ------------------------------------------------------------- phase 16

def phase_zoo_bytes(torch, device):
    """Card-built fp4/fp8/bfp artifacts byte-equal to CPU-built ones."""
    from iron_weight_only_quant_tpu_torch.config import QuantSpec, fp_spec
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    specs = {"fp4_e2m1_g128_asym": fp_spec("fp4", 2, 1, group_size=128, symmetric=False),
             "fp8_e4m3_g128_sym": fp_spec("fp8", 4, 3, group_size=128),
             "bfp4_g128": QuantSpec(fmt="bfp", bits=4, group_size=128),
             "bfp8_g128": QuantSpec(fmt="bfp", bits=8, group_size=128)}
    checked = 0
    for k in (4096, 11008):
        w = torch.randn((k, 4096), generator=gen, device=device) * k**-0.5
        w_cpu = w.cpu()
        for label, spec in specs.items():
            on_card = quantize_tensor(w, spec, pad_n_to=512)
            on_cpu = quantize_tensor(w_cpu, spec, pad_n_to=512)
            for name in ("qweight", "scales", "zeros", "codebook"):
                a, b = getattr(on_card, name), getattr(on_cpu, name)
                if (a is None) != (b is None) or (a is not None and not torch.equal(
                        a.cpu().view(torch.uint8), b.view(torch.uint8))):
                    fail(f"{label} K={k}: the card-built {name} differs from the CPU-built")
            checked += 1
            print(f"  {label} K={k}: card-built artifact byte-equal to the CPU-built",
                  flush=True)
    return checked


# ------------------------------------------------------------- phases 17, 21

def phase_lut_kernels(torch, device, seed, cases, pad_k_to=1):
    """LUT kernels against their plain versions.  ``cases`` are (spec,
    activation-bits settings, {label: other spec}): each spec at the five
    main-path shapes (K padded to ``pad_k_to``), timed at M=8 and M=256,
    untimed at the other main-path row counts, qkv and gate_up also once
    with ``pre_norm`` (x normalized in torch first, in the row pass under
    A16); then at the down shape an f32 x, the other specs (under A16 only
    those with the A16 path) and a stacked call (layer 2 of 3,
    side_pad=2) per kernel.  Returns (records by kernel, the generator and
    the function that makes a down-shape artifact, for the phase's own
    checks)."""
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    per_kernel = {}
    eps = 1e-5
    for spec, abits_all, _ in cases:
        for name, k, widths, prenorm, per_step in MAIN_SHAPES:
            qt, spans = make_artifact(torch, gen, spec, k, widths, device, pad_k_to=pad_k_to)
            w_lib = dequantize_weight(qt, torch.bfloat16)
            for abits in abits_all:
                kname = dm.kernel_name(qt, eps if prenorm else None, abits)
                if not dm.kernel_supported(qt, abits) or kname not in KERNEL_SOURCES:
                    fail(f"{name}: no LUT kernel takes the artifact (activation bits {abits})")
                for m in (DECODE_M, PREFILL_M) + WAVE_M:
                    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                    timed = m in (DECODE_M, PREFILL_M)
                    rec = check_call(torch, f"{kname}:{name}:M={m}", qt, x,
                                     *a_runner(None, abits), w_lib if timed else None, abits)
                    rec.update(kernel=kname, shape=name, per_step=per_step,
                               stored_n=qt.qweight.shape[-1], spans=spans)
                    per_kernel.setdefault(kname, []).append(rec)
                if prenorm:
                    x = torch.randn((DECODE_M, k), generator=gen, device=device).to(torch.bfloat16)
                    check_call(torch, f"{kname}:{name}:pre_norm", qt, x, *a_runner(eps, abits))
            del qt, w_lib
            torch.cuda.empty_cache()

    def down(spec):
        return make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device,
                             pad_k_to=pad_k_to)[0]

    x = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device)
    xb = x.to(torch.bfloat16)
    for spec, abits_all, others in cases:
        layers = [down(spec) for _ in range(3)]
        st = stacked_of(torch, layers)
        extra = {label: down(o) for label, o in others.items()}
        for abits in abits_all:
            kname = dm.kernel_name(layers[0], None, abits)
            check_call(torch, f"{kname}:f32", layers[0], x, *a_runner(None, abits))
            for label, qt in extra.items():
                if abits is None or dm.a16_supported(qt):
                    check_call(torch, f"{kname}:{label}", qt, xb, *a_runner(None, abits))
            check_call(torch, f"{kname}:stacked:layer=2", st, xb, *a_runner(None, abits, 2))
        del layers, st, extra
        torch.cuda.empty_cache()
    return per_kernel, gen, down


def check_bfp_on_int_kernels(torch, down, gen, device):
    """BFP artifacts are affine: the int kernels of their storage take
    them (``w4``, ``w4a16``, ``w8``, ``w8a16``), against the plain path."""
    from iron_weight_only_quant_tpu_torch.config import QuantSpec
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    xb = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device).to(torch.bfloat16)
    for bits in (4, 8):
        qt = down(QuantSpec(fmt="bfp", bits=bits, group_size=128))
        for abits in (None, 16):
            kname = dm.kernel_name(qt, None, abits)
            check_call(torch, f"{kname}:bfp{bits}", qt, xb, *a_runner(None, abits))
        del qt
    torch.cuda.empty_cache()


def check_a16_without_grid(torch, down, spec, gen, device):
    """A16 on an nq42 format without the int8 grid (fp6 E3M2) warns and
    launches ``lut6_matmul`` once, at full precision."""
    import warnings

    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    qt = down(spec)
    xb = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device).to(torch.bfloat16)
    dm.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y = dm.fused_quantized_matmul(xb, qt, activation_bits=16)
    torch.cuda.synchronize()
    launches = dict(dm.LAUNCHES)
    if not any("full-precision" in str(w.message) for w in caught) or \
            launches != {**{k: 0 for k in dm.LAUNCHES}, dm.LUT6: 1}:
        fail(f"fp6 E3M2 under A16: warnings {[str(w.message) for w in caught]}, "
             f"launches {launches}")
    check_call(torch, "lut6_matmul:fp6_e3m2_g128_asym:a16_full_precision", qt, xb,
               lambda x_, qt_: y, lambda x_, qt_: dm.dequant_matmul_plain(x_, qt_))
    print("  fp6 E3M2 under A16: warned, one lut6_matmul launch", flush=True)


# ------------------------------------------------------------- phase 24

def probe_launches(probe):
    """Launch counts of one W4 inner-loop probe run, from the probe's own
    table: per shape, every variant's timed series makes ``WARMUP`` and
    ``probe.ITERS`` calls in each of ``probe.ROUNDS`` rounds; the reference
    variant runs once more for the reference, and every variant checked
    against it once for its error."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.utils.timing import WARMUP

    series = probe.ROUNDS * (WARMUP + probe.ITERS)
    want = {name: 0 for name in dm.LAUNCHES}
    for tag, (kernel, _, checked) in probe.VARIANTS.items():
        want[kernel] += len(probe.SHAPES) * (series + int(checked)
                                             + int(tag == probe.REFERENCE))
    return want


def phase_w4_inner(torch, device, spec):
    """Both modes of ``w4_inner_matmul`` against their plain versions at the
    main-path shapes and at the probe's own shapes; then the probe entry
    point's run (as its ``main`` calls it) on its main path, the launch
    counters zeroed before it and read after it.  The kernel
    records of the qkv and gate_up shapes count no launch a decode step: as
    row 1, the probe kernel stands for o, down and the lm_head."""
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import (
        MODES,
        w4_inner_matmul,
        w4_inner_plain,
    )
    from iron_weight_only_quant_tpu_torch.probes import probe_w4_inner as probe
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    names = {"f32": dm.W4_INNER_F32, "magic": dm.W4_INNER_MAGIC}
    runners = {mode: (lambda x, qt, md=mode: w4_inner_matmul(x, qt, md),
                      lambda x, qt, md=mode: w4_inner_plain(x, qt, md)) for mode in MODES}
    per_kernel = {}
    for name, k, widths, prenorm, per_step in MAIN_SHAPES:
        qt, spans = make_artifact(torch, gen, spec, k, widths, device)
        w_lib = dequantize_weight(qt, torch.bfloat16)
        for mode in MODES:
            for m in (DECODE_M, PREFILL_M):
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                rec = check_call(torch, f"{names[mode]}:{name}:M={m}", qt, x,
                                 *runners[mode], w_lib)
                rec.update(kernel=names[mode], shape=name, per_step=0 if prenorm else per_step,
                           stored_n=qt.qweight.shape[-1], spans=spans)
                per_kernel.setdefault(names[mode], []).append(rec)
        del qt, w_lib
        torch.cuda.empty_cache()

    qt = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device)[0]
    qt_kp = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device, pad_k_to=1024)[0]
    if qt_kp.k_pad == 0:
        fail("the k_pad artifact has no padding")
    x = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device)
    for mode in MODES:
        check_call(torch, f"{names[mode]}:f32", qt, x, *runners[mode])
        check_call(torch, f"{names[mode]}:k_pad", qt_kp, x.to(torch.bfloat16), *runners[mode])
    del qt, qt_kp
    torch.cuda.empty_cache()

    for k, n in probe.SHAPES:  # the probe's own shapes, as it quantizes them
        qt = quantize_tensor(torch.randn((k, n), generator=gen, device=device) * 0.02,
                             probe.SPEC)
        x = torch.randn((probe.M, k), generator=gen, device=device).to(torch.bfloat16)
        for mode in MODES:
            check_call(torch, f"{names[mode]}:probe:{k}x{n}", qt, x, *runners[mode])
        del qt
    torch.cuda.empty_cache()

    print(f"  -- the probe entry point at {len(probe.SHAPES)} shapes, M={probe.M}, "
          f"{probe.ROUNDS} rounds of {probe.ITERS} timed calls", flush=True)
    torch.cuda.synchronize()
    dm.reset_counts()
    res = probe.run(device, out=lambda line: print("  " + line, flush=True))
    torch.cuda.synchronize()
    launches = check_counts("probe", probe_launches(probe))
    print(json.dumps({"probe_w4_inner": res}), flush=True)
    for shape in res["shapes"]:
        for tag, rec in shape["variants"].items():
            if not (0 < rec["us"] < math.inf) or rec["maxrel"] > REL_TOL_BF16:
                fail(f"probe {shape['k']}x{shape['n']} {tag}: {rec}")
    return per_kernel, res, launches


# --------------------------------------------------------------- report

def kernel_rows(per_kernel, launches):
    """One row per kernel: times summed over the launches one decode step
    (M=8) makes at each main-path shape; ``launches`` from the run of the
    kernel's main path."""
    rows = []
    for name, recs in per_kernel.items():
        dec = [r for r in recs if r["M"] == DECODE_M]
        step = lambda key: sum(r[key] * r["per_step"] for r in dec)  # noqa: E731
        nbytes, ops = step("bytes"), step("ops")
        bound_ms, bound_by = bound(nbytes, ops, dec[0]["peak"])
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": step("ms"), "plain_ms": step("plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": step("library_ms"),
        })
    return rows


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "iron_weight_only_quant_tpu_torch")):
        print("chip_smoke: the iron_weight_only_quant_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    def header(text: str) -> None:
        print(f"{text} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    header("== phase 1: build")
    from iron_weight_only_quant_tpu_torch.config import QuantSpec, fp_spec
    from iron_weight_only_quant_tpu_torch.models.llama import LlamaConfig
    from iron_weight_only_quant_tpu_torch.ops.kernels import build as kbuild
    from iron_weight_only_quant_tpu_torch.utils.profiling import card_line

    t0 = time.perf_counter()
    paths = kbuild.build()
    print(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in paths:
        for line in kbuild.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    card = card_line()
    print(card, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    w4 = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    w8 = QuantSpec(fmt="int", bits=8, group_size=128, symmetric=False)
    cfg = LlamaConfig.llama2_7b()
    cfg_cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    tol = f"tolerance max|y-y_ref|/max|y_ref| <= {REL_TOL_BF16}, bf16 x"

    header(f"== phase 2: W4 kernels vs plain versions ({tol})")
    per_kernel = phase_kernels(torch, device, w4, (dm.W4, dm.W4_PRENORM))

    header("== phase 3: W4 two-layer 7B-width logits, kernels vs plain path")
    phase_two_layers(torch, device, w4, cfg)

    header("== phase 4: 32-layer 7B-width W4 generate and serve")
    res, serve_w4, params_w4 = phase_generate(torch, device, w4, cfg, card)

    header(f"== phase 5: W8 kernels vs plain versions ({tol})")
    per_kernel.update(phase_kernels(
        torch, device, w8, (dm.W8, dm.W8_PRENORM),
        extra_specs=(("perchannel_sym", QuantSpec(fmt="int", bits=8,
                                                  group_size=PER_CHANNEL,
                                                  symmetric=True)),)))

    header("== phase 6: W8 two-layer 7B-width logits, kernels vs plain path")
    phase_two_layers(torch, device, w8, cfg)

    header(f"== phase 7: {CUT_LAYERS}-layer 7B-width W8 serve")
    serve_w8, params_w8 = phase_w8_serve(torch, device, w8, cfg_cut, card)

    tol_a = f"{tol}; {REL_TOL_F32} for f32 x"
    header(f"== phase 8: int-activation kernels vs plain versions ({tol_a})")
    per_kernel_a, row_pass_checks = phase_a_kernels(torch, device, {4: w4, 8: w8})
    per_kernel.update(per_kernel_a)

    header("== phase 9: two-layer 7B-width logits under A8 and A16, kernels vs "
           "plain path")
    for spec in (w4, w8):
        phase_two_layers(torch, device, spec, cfg, abits_list=dm.ACTIVATION_BITS)

    header("== phase 10: 32-layer 7B-width W4 serve, A8 waves, A16 decode")
    serve_w4_a = phase_serve(torch, params_w4, cfg, (dm.W4A8, dm.W4A16), SERVE_RUNS,
                             card, abits=(8, 16))
    del params_w4
    torch.cuda.empty_cache()

    header(f"== phase 11: {CUT_LAYERS}-layer 7B-width W8 serve, A16 waves, A8 decode")
    serve_w8_a = phase_serve(torch, params_w8, cfg_cut, (dm.W8A16, dm.W8A8), SERVE_RUNS,
                             card, abits=(16, 8))
    del params_w8
    torch.cuda.empty_cache()

    w3 = QuantSpec(fmt="int", bits=3, group_size=128, symmetric=False)
    header(f"== phase 12: W3 kernels vs plain versions ({tol_a})")
    per_kernel.update(phase_w3_kernels(torch, device, w3))

    header("== phase 13: W3 two-layer 7B-width logits, kernels vs plain path "
           "(bf16/f32 activations, A8, A16)")
    phase_two_layers(torch, device, w3, cfg, abits_list=(None,) + dm.ACTIVATION_BITS,
                     pad_k_to=W3_PAD_K)

    header(f"== phase 14: {CUT_LAYERS}-layer 7B-width W3 generate, serve, and serve with A8 "
           "waves, A16 decode")
    res_w3, serve_w3, params_w3 = phase_generate(
        torch, device, w3, cfg_cut, card, names=(dm.W3, dm.W3), label="W3",
        pad_k_to=W3_PAD_K, serve_runs=SERVE_RUNS)
    print("  -- W3 serve, A8 waves, A16 decode", flush=True)
    serve_w3_a = phase_serve(torch, params_w3, cfg_cut, (dm.W3A8, dm.W3A16), SERVE_RUNS,
                             card, abits=(8, 16))
    del params_w3
    torch.cuda.empty_cache()

    header("== phase 15: the XLA route on the card (artifacts the JAX package "
           "computes on its XLA path)")
    route = phase_route(torch, device)

    header("== phase 16: format zoo, card-built artifacts vs CPU-built")
    zoo_checks = phase_zoo_bytes(torch, device)

    fp4 = fp_spec("fp4", 2, 1, group_size=128, symmetric=False)
    fp8 = fp_spec("fp8", 4, 3, group_size=128)
    header(f"== phase 17: LUT kernels vs plain versions, BFP on the int kernels ({tol_a})")
    per_kernel_lut, gen, down = phase_lut_kernels(torch, device, 8, [
        (fp4, (None, 16), {"fp4_e2m1_g128_sym": fp_spec("fp4", 2, 1, group_size=128),
                           "fp4_e1m2_g64_sym": fp_spec("fp4", 1, 2, group_size=64)}),
        (fp8, (None,), {"fp8_e4m3_perchannel_asym": fp_spec("fp8", 4, 3, group_size=PER_CHANNEL,
                                                            symmetric=False),
                        "fp8_e3m4_g128_sym": fp_spec("fp8", 3, 4, group_size=128)})])
    per_kernel.update(per_kernel_lut)
    check_bfp_on_int_kernels(torch, down, gen, device)

    header("== phase 18: fp4 (also A16) and fp8 two-layer 7B-width logits, kernels vs "
           "plain path")
    phase_two_layers(torch, device, fp4, cfg, abits_list=(None, 16))
    phase_two_layers(torch, device, fp8, cfg)

    header("== phase 19: 32-layer 7B-width fp4 generate, serve, and serve with A16 "
           "waves and decode")
    res_fp4, serve_fp4, params_fp4 = phase_generate(
        torch, device, fp4, cfg, card, names=(dm.LUT4, dm.LUT4), label="FP4",
        serve_runs=SERVE_RUNS)
    print("  -- FP4 serve, A16 waves, A16 decode", flush=True)
    serve_fp4_a = phase_serve(torch, params_fp4, cfg, (dm.LUT4A16, dm.LUT4A16), SERVE_RUNS,
                              card, abits=(16, 16))
    del params_fp4
    torch.cuda.empty_cache()

    header(f"== phase 20: {CUT_LAYERS}-layer 7B-width fp8 serve")
    serve_fp8, params_fp8 = phase_w8_serve(torch, device, fp8, cfg_cut, card,
                                           names=(dm.LUT8, dm.LUT8), label="FP8")
    del params_fp8
    torch.cuda.empty_cache()

    fp6 = fp_spec("fp6", 2, 3, group_size=128)
    header(f"== phase 21: fp6 (nq42) kernels vs plain versions ({tol_a})")
    e3m2 = fp_spec("fp6", 3, 2, group_size=128, symmetric=False)
    per_kernel_lut, gen, down = phase_lut_kernels(torch, device, 9, [
        (fp6, (None, 16), {"fp6_e3m2_g128_asym": e3m2,
                           "fp6_e2m3_g64_sym": fp_spec("fp6", 2, 3, group_size=64),
                           "fp6_e2m3_perchannel_asym": fp_spec("fp6", 2, 3,
                                                               group_size=PER_CHANNEL,
                                                               symmetric=False)})],
        pad_k_to=FP6_PAD_K)
    per_kernel.update(per_kernel_lut)
    check_a16_without_grid(torch, down, e3m2, gen, device)

    header("== phase 22: fp6 two-layer 7B-width logits (also A16), kernels vs plain path")
    phase_two_layers(torch, device, fp6, cfg, abits_list=(None, 16), pad_k_to=FP6_PAD_K)

    header("== phase 23: 32-layer 7B-width fp6 generate, serve, and serve with A16 "
           "waves and decode")
    res_fp6, serve_fp6, params_fp6 = phase_generate(
        torch, device, fp6, cfg, card, names=(dm.LUT6, dm.LUT6), label="FP6",
        pad_k_to=FP6_PAD_K, serve_runs=SERVE_RUNS)
    print("  -- FP6 serve, A16 waves, A16 decode", flush=True)
    serve_fp6_a = phase_serve(torch, params_fp6, cfg, (dm.LUT6A16, dm.LUT6A16), SERVE_RUNS,
                              card, abits=(16, 16))
    del params_fp6
    torch.cuda.empty_cache()

    header(f"== phase 24: W4 inner-loop probes ({tol_a})")
    per_kernel_inner, _, probe_counts = phase_w4_inner(torch, device, w4)
    per_kernel.update(per_kernel_inner)

    header("== phase 25: report")
    names_of = lambda run, names: {k: v for k, v in run["launches"].items()  # noqa: E731
                                   if k in names}
    launches = {**names_of(res, (dm.W4, dm.W4_PRENORM)),
                **names_of(serve_w8, (dm.W8, dm.W8_PRENORM)),
                **names_of(serve_w4_a, (dm.W4A8, dm.W4A16)),
                **names_of(serve_w8_a, (dm.W8A8, dm.W8A16)),
                **names_of(serve_w3, (dm.W3,)),
                **names_of(serve_w3_a, (dm.W3A8, dm.W3A16)),
                **names_of(serve_fp4, (dm.LUT4,)),
                **names_of(serve_fp4_a, (dm.LUT4A16,)),
                **names_of(serve_fp8, (dm.LUT8,)),
                **names_of(serve_fp6, (dm.LUT6,)),
                **names_of(serve_fp6_a, (dm.LUT6A16,)),
                dm.W4_INNER_F32: probe_counts[dm.W4_INNER_F32],
                dm.W4_INNER_MAGIC: probe_counts[dm.W4_INNER_MAGIC]}
    rows = kernel_rows(per_kernel, launches)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"generate": {k: v for k, v in res.items() if k != "launches"}}))
    print(json.dumps({"serve_w4": serve_w4}))
    print(json.dumps({"serve_w8": serve_w8}))
    print(json.dumps({"serve_w4_a8_waves_a16_decode": serve_w4_a}))
    print(json.dumps({"serve_w8_a16_waves_a8_decode": serve_w8_a}))
    print(json.dumps({"generate_w3": {k: v for k, v in res_w3.items() if k != "launches"}}))
    print(json.dumps({"serve_w3": serve_w3}))
    print(json.dumps({"serve_w3_a8_waves_a16_decode": serve_w3_a}))
    print(json.dumps({"row_pass_bit_equal_calls": row_pass_checks}))
    print(json.dumps({"generate_fp4": {k: v for k, v in res_fp4.items() if k != "launches"}}))
    print(json.dumps({"serve_fp4": serve_fp4}))
    print(json.dumps({"serve_fp4_a16": serve_fp4_a}))
    print(json.dumps({"serve_fp8": serve_fp8}))
    print(json.dumps({"generate_fp6": {k: v for k, v in res_fp6.items() if k != "launches"}}))
    print(json.dumps({"serve_fp6": serve_fp6}))
    print(json.dumps({"serve_fp6_a16": serve_fp6_a}))
    print(json.dumps({"route": route, "zoo_bytes_equal_artifacts": zoo_checks}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
