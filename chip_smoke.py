#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``iron_weight_only_quant_tpu_torch`` only (no JAX) through five
phases; any failing phase ends the run with a non-zero exit code.

1. Build: compile the CUDA kernels in ``csrc/`` with ``nvcc`` (one process
   per source, all at once) and print the card's name and power limit.
2. Kernel vs plain: each W4 kernel against its plain PyTorch version at the
   five main-path shapes of a LLaMA-2-7B W4 g128 model, at decode M=8 and a
   prefill M, plus a ``k_pad`` artifact and a layer-stacked call with
   layer > 0.  Prints error, kernel time, plain time, ``torch.matmul`` on
   a pre-dequantized bf16 weight (a yardstick, never used by the port) and
   the byte/operation bound of each call.
3. Two-layer model: ``llama_forward`` logits at full 7B width with the
   kernels on the card against the same params through the plain path on
   the CPU, in float32 and in bfloat16.
4. Full model: 32-layer 7B-width W4 model quantized layer by layer on the
   card, ``InferenceEngine.generate`` on 8 prompts of different lengths,
   greedy, 32 new tokens.  The launch counters are zeroed just before this
   run and read just after: both kernels must have run exactly as often
   as the model's shape says, and the plain versions never.
5. Report: the per-kernel JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
when the port's package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
REL_TOL_BF16 = 1e-2  # kernel vs plain, max|y - y_ref| / max|y_ref|, bf16 x
LOGITS_TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # same measure on logits
DECODE_M = 8
PREFILL_M = 256
BATCH = 8
NEW_TOKENS = 32
PROMPT_LENS = (9, 13, 17, 21, 25, 29, 33, 37)
EXTRA_K, EXTRA_N = 11008, 4096  # the down shape, for the k_pad and stacked calls


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ model

def build_quantized_llama(cfg, generator, spec, dtype, device):
    """Random W4 LLaMA built on the card, quantizing each linear as it is
    made, so the dense model never exists whole.  Norm gammas are 1, so
    marking them folded (``None``) is exact; every linear, the lm_head
    included, is an int4 artifact with N padded to 512."""
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
                                     pad_n_to=512), "b": None}

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


# --------------------------------------------------------------- timing

def device_ms(fn, iters: int) -> float:
    """Device time of one ``fn(i)`` call, from CUDA events around ``iters``
    calls.  A sleep kernel queued first keeps the card busy while the host
    enqueues the calls, so host overhead between launches is not counted."""
    import torch

    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def copies_for(nbytes: int) -> int:
    """Distinct copies to rotate through so that repeated calls find the
    50 MB L2 cold, as the layers of a decode step do."""
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


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


def call_cost(qt, m: int, x_bytes: int):
    """(bytes, operations) the call needs: each input read once, the
    output written once; operations 2*M*K*N."""
    k, n = qt.shape
    side = qt.scales.numel() * qt.scales.element_size()
    side += qt.zeros.numel() * qt.zeros.element_size()
    nbytes = qt.qweight.numel() + side + m * k * x_bytes + m * n * x_bytes
    return nbytes, 2 * m * k * n


def bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_call(torch, name, qt, x, run, run_plain, w_lib=None):
    """One kernel call against its plain version; records errors and times."""
    y = run(x, qt)
    y_ref = run_plain(x, qt)
    torch.cuda.synchronize()
    if y.shape != y_ref.shape or not torch.isfinite(y).all():
        fail(f"{name}: shape {tuple(y.shape)} vs {tuple(y_ref.shape)} or non-finite output")
    diff = (y.float() - y_ref.float()).abs().max().item()
    ref_max = y_ref.float().abs().max().item()
    rel = diff / max(ref_max, 1e-30)
    ok = rel <= REL_TOL_BF16
    rec = {"call": name, "M": x.shape[0], "K": qt.shape[0], "N": qt.shape[1],
           "max_abs_err": diff, "rel_err": rel, "ok": ok}
    if w_lib is not None:  # timed: a main-path shape
        nbytes, ops = call_cost(qt, x.shape[0], x.element_size())
        reps = copies_for(qt.qweight.numel())
        qts = [qt] + [qt.map_arrays(torch.clone) for _ in range(reps - 1)]
        rec["ms"] = device_ms(lambda i: run(x, qts[i % reps]), 20)
        rec["plain_ms"] = device_ms(lambda i: run_plain(x, qts[i % reps]), 4)
        lib_reps = copies_for(w_lib.numel() * w_lib.element_size())
        ws = [w_lib] + [w_lib.clone() for _ in range(lib_reps - 1)]
        rec["library_ms"] = device_ms(lambda i: torch.matmul(x, ws[i % lib_reps]), 20)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        rec["bytes"], rec["ops"] = nbytes, ops
        del qts, ws
    print("  " + json.dumps(rec), flush=True)
    if not ok:
        fail(f"{name}: kernel vs plain rel err {rel:.3e} > {REL_TOL_BF16}")
    return rec


def phase_kernels(torch, device):
    from iron_weight_only_quant_tpu_torch.config import QuantSpec
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    spec = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    per_kernel = {dm.W4: [], dm.W4_PRENORM: []}
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
        kname = dm.W4_PRENORM if prenorm else dm.W4
        for m in (DECODE_M, PREFILL_M):
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            rec = check_call(torch, f"{kname}:{name}:M={m}", qt, x, run,
                             run_plain, w_lib)
            rec.update(kernel=kname, shape=name, per_step=per_step,
                       stored_n=qt.qweight.shape[-1], spans=spans)
            per_kernel[kname].append(rec)
        del qt, w_lib
        torch.cuda.empty_cache()

    # a k_pad artifact (K=11008 stored as 11264) and a stacked call, layer 2
    # of 3, with side info padded by 2 rows (side_pad=2), for both kernels
    for prenorm in (False, True):
        run, run_plain = runner(prenorm)
        kname = dm.W4_PRENORM if prenorm else dm.W4
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

def phase_two_layers(torch, device, spec, cfg_full):
    import dataclasses

    from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
    from iron_weight_only_quant_tpu_torch.models.llama import (
        fuse_llama_projections,
        llama_forward,
    )

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = fuse_llama_projections(
        build_quantized_llama(cfg, gen, spec, torch.float32, device))
    cpu_params = params_from_numpy(params, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=device)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for p in (params, cpu_params):
            p["embed"] = p["embed"].to(dtype)
            p["final_norm"] = p["final_norm"].to(dtype)
        with torch.inference_mode():
            lg, _ = llama_forward(params, tokens, cfg)
            lg_ref, _ = llama_forward(cpu_params, tokens.cpu(), cfg)
        torch.cuda.synchronize()
        lg, lg_ref = lg.float().cpu(), lg_ref.float()
        if not torch.isfinite(lg).all():
            fail("two-layer logits are not finite")
        rel = ((lg - lg_ref).abs().max() / lg_ref.abs().max()).item()
        agree = (lg.argmax(-1) == lg_ref.argmax(-1)).float().mean().item()
        name = str(dtype).split(".")[-1]
        out[name] = {"rel_err": rel, "tol": LOGITS_TOL[name], "argmax_agree": agree}
        print(f"  logits {name}: max|d|/max|ref| = {rel:.3e} (tol "
              f"{LOGITS_TOL[name]}), argmax agreement {agree:.4f}", flush=True)
        if rel > LOGITS_TOL[name]:
            fail(f"two-layer logits ({name}) rel err {rel:.3e} > {LOGITS_TOL[name]}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 4

def phase_generate(torch, device, spec, cfg, card):
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = build_quantized_llama(cfg, gen, spec, torch.bfloat16, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"  built {cfg.num_layers}-layer W4 model in {build_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)

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
    launches = dict(dm.LAUNCHES)
    plain = dict(dm.PLAIN_CALLS)

    forwards = 1 + (NEW_TOKENS - 1)
    want = {dm.W4_PRENORM: forwards * 2 * cfg.num_layers,
            dm.W4: forwards * (2 * cfg.num_layers + 1)}
    print(f"  launches {launches}, expected {want}, plain calls {plain}", flush=True)
    if launches != want:
        fail(f"kernel launches {launches} != expected {want}")
    if any(plain.values()):
        fail(f"the plain path ran on the main path: {plain}")
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
    return res


# --------------------------------------------------------------- report

def kernel_rows(per_kernel, launches):
    """One row per kernel: times summed over the launches one decode step
    (M=8) makes at each main-path shape."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    meta = {
        dm.W4: ("iron_weight_only_quant_tpu_torch/csrc/w4_matmul.cu",
                "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:319"),
        dm.W4_PRENORM: ("iron_weight_only_quant_tpu_torch/csrc/w4_matmul_prenorm.cu",
                        "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:328"),
    }
    rows = []
    for name, recs in per_kernel.items():
        dec = [r for r in recs if r["M"] == DECODE_M]
        step = lambda key: sum(r[key] * r["per_step"] for r in dec)  # noqa: E731
        nbytes, ops = step("bytes"), step("ops")
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": step("ms"), "plain_ms": step("plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": step("library_ms"),
        })
    return rows


def main() -> int:
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

    print("== phase 1: build", flush=True)
    from iron_weight_only_quant_tpu_torch.config import QuantSpec
    from iron_weight_only_quant_tpu_torch.models.llama import LlamaConfig
    from iron_weight_only_quant_tpu_torch.ops.kernels import build as kbuild

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

    print("== phase 2: kernels vs plain versions (tolerance "
          f"max|y-y_ref|/max|y_ref| <= {REL_TOL_BF16}, bf16 x)", flush=True)
    per_kernel = phase_kernels(torch, device)

    spec = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    cfg = LlamaConfig.llama2_7b()
    print("== phase 3: two-layer 7B-width logits, kernels vs plain path", flush=True)
    phase_two_layers(torch, device, spec, cfg)

    print("== phase 4: 32-layer 7B-width W4 generate", flush=True)
    res = phase_generate(torch, device, spec, cfg, card)

    print("== phase 5: report", flush=True)
    rows = kernel_rows(per_kernel, res["launches"])
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"generate": {k: v for k, v in res.items() if k != "launches"}}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
