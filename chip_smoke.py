#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``iron_weight_only_quant_tpu_torch`` only (no JAX) through
thirty-six phases; any failing phase ends the run with a non-zero exit
code.  The W4 model, the main path, runs all 32 layers of LLaMA-2-7B,
flat, on the scan path (layer-stacked params and caches) and through the
tensor-parallel forward at world size 1 (phase 27); its A-serve
and KV-mode serves, the W8, W3, fp4, fp8 and fp6 models, the OPT and
BLOOM models and the two ranks of phase 27, whose kernels or paths the
main path does not carry but which add time, run ``CUT_LAYERS`` (8)
layers at full width; the GPTQ-calibrated W4 model ``GPTQ_LAYERS`` (4),
the CLI phase ``CLI_LAYERS`` (2).

1. Build: compile the CUDA kernels in ``csrc/`` with ``nvcc`` (one process
   per source, all at once) and the host library
   (``csrc/host/iwoq_native.cpp``) with ``g++``, each with its time, and
   print the card's name and power limit.
2. W4 kernels vs plain: each W4 kernel against its plain PyTorch version at
   the five main-path shapes of a LLaMA-2-7B W4 g128 model, at decode M=8
   and a prefill M, plus a ``k_pad`` artifact, an f32 x and a layer-stacked
   call with layer > 0; untimed, at every other row count the main paths
   give the kernels (serve's prefill waves, generate's prefill).  The
   stacked forms (rows ``w4_matmul_pfx``, ``w4_matmul_prenorm_pfx``; in
   phase 5 the W8 ones) are timed at the five shapes too, at M=8 and
   M=256, on stacked artifacts of as many layers as a cold L2 needs, the
   calls rotating through the layers.  Prints
   error, kernel time, plain time, ``torch.matmul`` on a pre-dequantized
   bf16 weight (a yardstick, never used by the port) and the byte/operation
   bound of each call.  The bf16-x calls of ``w4_matmul`` and
   ``w4_matmul_prenorm`` run on the bf16 tensor cores (the affine nib4 case
   of the bf16 family of ``csrc/wa_slab_mma.cuh``, the prenorm kernel's row
   factor in its epilogue), the f32-x calls on their CUDA-core kernels.
   Then that route on ragged artifacts (per-channel K=1088, whose range
   ends inside a window; groups of 16; K=1408, whose groups straddle the K
   halves) at M=8 and 64, with and without ``pre_norm``, and on an x it
   must copy; the prenorm kernel with one split and with a K-split, and a
   flat call with one split, each counted by ``torch.profiler`` (one
   kernel with one split, two with a K-split: no copy of x); and the SASS
   counts and registers of their kernels, as in phase 12 (HMMA, else the
   phase fails).  The bf16 routes of ``w8_matmul`` and ``lut8_matmul``
   (phases 5 and 17) are counted here the same way, before any profiled
   serve: a flat W8 call with one split and one with a K-split, the W8
   prenorm kernel with one split and with a K-split (no row pass: its row
   factor in the epilogue or the reduce), and an fp8 call with one split,
   and with the pre-norm (its row pass) with one split and with a K-split.
   So are the W4 inner-loop probe kernel's calls of phase 24, both modes:
   its tensor-core routes with one split and with a K-split, and its
   CUDA-core kernel for f32 x.
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
   per-channel symmetric artifact.  The bf16-x calls of ``w8_matmul`` and
   ``w8_matmul_prenorm`` run on the bf16 tensor cores (the affine byte
   case of the bf16 family of ``csrc/wa_slab_mma.cuh``, the prenorm
   kernel's row factor in its epilogue), their f32-x calls on their
   CUDA-core kernels.  Then that route on g128 asymmetric, per-channel
   symmetric, groups of 16 and per-channel asymmetric K=1088 (whose range
   ends inside a window) artifacts at M=8 and 64, with and without
   ``pre_norm``, and on an x it must copy, also with ``pre_norm`` (its
   calls counted by ``torch.profiler`` in phase 2); and the SASS counts and
   registers of both kernels' libraries, as in phase 12 (HMMA, else the
   phase fails).
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
   and an f32 x; and the slab kernel's row pass (its int8 planes, row
   scales and group sums) bit-equal to the plain ``quantize_activations``
   and ``activation_group_sums`` on the card, in its byte, nib4 and s21
   layouts (one, two and eight slabs), one plane and two; with the norm,
   its sums equal those of its own planes and its codes and scales stay
   within one code and one step of x's type of the plain version's (the
   norm's sum of squares is reduced in another order).  ``w4a8_matmul`` and
   ``w8a8_matmul`` run as the one-plane (A8) mode of the tensor-core slab
   kernel (``csrc/wa_slab_mma.cuh``; affine nib4, byte), ``w4a16_matmul``
   and ``w8a16_matmul`` as its two-plane (A16) mode.  Then
   ``w8a16_matmul`` on a per-channel asymmetric K=1088 artifact
   (the last of its range's four parts ends early) and groups of 16, at
   M=8 and 64, bf16 and f32 x, and its SASS counts and registers as in
   phase 12, and ``w8a8_matmul`` on the same two artifacts; and
   ``w4a16_matmul`` likewise, with a K=1408 g128 artifact (groups straddle
   the K halves: split in two per call), and ``w4a8_matmul`` on the same
   three artifacts (SASS: IMMA, no IDP in every product kernel).
9. Two-layer logits with activation bits: phase 3 under A8 and A16, W4
   and W8.
10. W4 A-serve: the first ``CUT_LAYERS`` layers of phase 4's W4 model,
    ``serve`` of phase 7's traffic with ``prefill_activation_bits=8`` and
    ``activation_bits=16``
    (waves on W4A8, the slab kernel's one-plane mode; decode steps on
    W4A16); warm-up, median of 3, one profiled run; launch counts exact per
    run.
10a. KV codec on the card: the int8 and int4 (split-D nibble-packed) KV
    encode and decode of seeded bf16 and f32 k ``[8, S, 32, 128]``, S = 1
    and 64, groups of 128 and 64: codes, scales, zeros and decoded values
    bit-equal to the same calls on the CPU; paged write/read round trips:
    a 16-bit pool read back exactly, an int8 pool equal to the contiguous
    int8 cache.
10b. Two-layer 7B-width W4 logits with ``kv_bits`` 8 and 4 (the forward
    writes and reads a quantized cache), kernels vs the plain path on the
    CPU, as phase 3; limits ``LOGITS_TOL_KV``.
10c. KV-mode serves: the first ``CUT_LAYERS`` layers of phase 4's W4 model,
    ``serve`` of phase 7's traffic (median of 3, profiled run; no warm-up,
    the kernels are warm) with paged 16-bit pages (``KV_PAGE`` = 32 tokens), int8 paged,
    int4 contiguous and paged, and int8 paged in the least pool that
    traffic runs in (its peak plus the garbage page: pages are recycled).
    The cache holds 96 columns, three pages, so paged and contiguous
    timelines are equally long: paged tokens equal the contiguous serve's
    of the same ``kv_bits`` (one untimed run each, 16-bit and int8), the
    small pool's the full pool's.  Per serve also the bytes the KV
    buffers hold.
10d. Long-context ``generate``: phase 4's prompts on the same model with
    an int8 paged cache of 2048 columns (LLaMA-2's context), 32 new
    tokens; wall ms per decode step (gather and decode read the whole
    timeline each step).
10e. The CLI, as a user runs it (on the card by default), at LLaMA-2-7B
    widths and ``CLI_LAYERS`` layers (the depth is cut because the save
    is host deflate, most of it the bf16 embedding and lm_head): (a) a
    float16 HF checkpoint (``config.json``, ``model.safetensors``) written
    by the script; (b) ``cli.quantize --model_path ... --w_bits 4
    --w_group_size 128 --pad_n 512`` (RTN on the card, where the weights
    are: its summary must name no host-library linear; no kernel launch)
    into the run's only artifact save, loaded onto the card: every leaf
    bit-equal to ``quantize_model_params`` of the same converted weights
    quantized on the card, and ``generate``'s tokens equal; the host
    library's RTN (``--platform cpu``'s) timed alone on two linears, its
    bytes equal to the card's; (c)
    ``cli.generate`` on the artifact, plain and ``--continuous``, with
    integer prompts: the printed tokens equal ``InferenceEngine`` called
    directly, launches exact (every linear on ``w4_matmul``: the norms are
    not folded, so ``w4_matmul_prenorm`` launches none), no plain or route
    call; (d) ``cli.eval_ppl --w_bits 16 --datasets synthetic``: the PPL
    equal to ``SequentialPPLEvaluator``'s bit for bit, launches exact;
    (e) ``cli.eval_zeroshot`` on piqa, arc_easy, boolq, copa and lambada
    (local documents in place of ``tasks._load``; launches exact): its
    results equal ``evaluate`` through the kernels, and are held against
    ``evaluate`` on the CPU's plain path with the same documents and
    token ids (every pair's loglikelihood within ``ZS_LL_TOL``, the dense
    model's distance beside it; per-task results equal unless a decision
    flips); then ``greedy_until`` (launches exact); (f) ``tokenshard:``
    windows through ``get_loaders`` equal to a numpy read of the file; (g)
    ``analysis.stats.codeword_histogram`` of a linear equal on the card
    and the CPU.  The seconds of each step.
10f. The scan path: phase 4's 32-layer W4 model; two-layer logits of
    ``llama_forward_scan`` against ``llama_forward`` on the card; one
    untimed flat serve with an int8 cache; then the fused params stacked
    (``stack_model_layers``, a copy), ``generate`` of phase 4's prompts
    through ``llama_forward_scan``; ``serve`` of phase 7's traffic with the
    16-bit cache, scan and flat in turns (scan, flat, flat, scan, scan,
    flat: both meet the same host; medians and best), a profiled scan
    run, and the int8 cache on the scan path (median of 3): the flat
    path's tokens, and every linear but the lm_head on the stacked kernels
    (``dm.STACKED_LAUNCHES``: ``2L`` a forward for each W4 kernel).
11. W8 A-serve: the 8-layer W8 model of phase 7 with ``prefill_activation_bits=16``
    and ``activation_bits=8`` (waves on W8A16, decode steps on W8A8).
11a. W8 on the scan path: phase 7's model stacked in place
    (``consume=True``: each layer's buffers free as they are copied), one
    timed ``serve`` of phase 7's traffic and one with A16 waves and A8
    decode: phase 7's and phase 11's tokens, the stacked launches exact.
11b. OPT: an 8-layer W4 model at OPT-6.7B widths (``OPTConfig.opt_6_7b()``,
    random from a seed, every linear W4 g128 with ``pad_n_to=512`` and a
    bf16 bias); two-layer logits on the card against the plain path on
    the CPU (float32, bfloat16) and scan against flat; the params stacked
    (a copy), ``generate`` flat and scan, ``serve`` one untimed run then
    scan and flat in turns as in 10f, with the flat tokens.  Every linear
    takes ``w4_matmul`` (no fusion, no pre-norm): ``6L`` a forward, all
    stacked on the scan path; the tied head is a plain matmul.
11c. BLOOM: phase 11b at BLOOM-7b1 widths (hidden 4096, 32 heads, FFN
    16384, vocab 250880).
12. W3 kernels vs plain: the three s21 3-bit kernels (``w3_matmul``,
    ``w3a8_matmul``, ``w3a16_matmul``) against their plain versions at the
    five main-path shapes of a LLaMA-2-7B W3 g128 model (down's K=11008
    stored as 11264, ``pad_k_to=1024``; lm_head N padded to 32256), timed at
    M=8 and M=256 as in phase 2, untimed at the other main-path row counts;
    qkv and gate_up also once with ``pre_norm`` (x normalized in the row
    pass of the bf16 route of ``w3_matmul`` and of the A-kernels); per kernel also
    an f32 x, g128 symmetric, per-channel asymmetric and per-tensor
    symmetric artifacts, and a layer-stacked call (layer 2 of 3, side info
    padded by 2 rows).  Then ``w3a16_matmul`` and ``w3a8_matmul`` (the s21
    case of the tensor-core slab kernel of ``csrc/wa_slab_mma.cuh``, two
    planes and one) on a per-channel K=1088 artifact (K/8 = 136 slab rows,
    no multiple of its 32-row window) and groups of 16, at M=8 and 64, bf16
    and f32 x; the static SASS counts of their kernels (IMMA, no IDP in the
    product kernels, else the phase fails) and their ``-Xptxas -v``
    registers, spills and shared memory.  The bf16-x calls
    of ``w3_matmul`` run on the bf16 tensor cores (the s21 case of the bf16
    family of ``csrc/wa_slab_mma.cuh``; a ``pre_norm`` in its row pass), the
    f32-x call on its CUDA-core kernel; the bf16 route is also checked as
    ``lut4_matmul``'s in phase 17, on per-channel K=1088, groups of 16 and
    g128 symmetric artifacts, and its SASS must hold HMMA (or HGMMA).
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
    card-built fp4 E2M1 g128 asymmetric, fp8 E4M3 g128 symmetric, bfp4 g128,
    bfp8 g128, int4 g128 asymmetric and int8 g128 symmetric artifacts
    (``pad_n_to=512``) are byte-equal to CPU-built ones, scales, zeros and
    codebooks included.
17. LUT kernels vs plain: ``lut4_matmul`` (fp4 E2M1 g128 asymmetric),
    ``lut4a16_matmul`` (the same under A16) and ``lut8_matmul`` (fp8 E4M3
    g128 symmetric) at the five main-path shapes, timed at M=8 and M=256
    as in phase 2, untimed at the other main-path row counts; qkv and
    gate_up also once with ``pre_norm`` (x normalized in the row pass of
    the bf16 route or under A16); at the down shape fp4 E2M1 symmetric and
    E1M2 g64 (lut4, lut4a16), fp8 E4M3 per-channel asymmetric and E3M4
    g128 (lut8), an f32 x and a layer-stacked call per kernel; and bfp4 and
    bfp8 artifacts on ``w4_matmul``, ``w4a16_matmul``, ``w8_matmul`` and
    ``w8a16_matmul``.  Then ``lut4a16_matmul`` (the nib4 LUT case of the
    slab kernel) on a per-channel asymmetric K=1088 artifact, fp4 groups of
    16 and a K=1408 g128 artifact (groups straddle the K halves: split in
    two per call), and its SASS counts and registers, as in phase 12.  The
    bf16-x calls of ``lut4_matmul`` run on the bf16 tensor cores (the bf16
    family of ``csrc/wa_slab_mma.cuh``; a ``pre_norm`` in its row pass),
    the f32-x call on its CUDA-core kernel; the bf16 route is also checked
    at M=8 and 64, with and without ``pre_norm``, on the same ragged
    artifacts, fp4 E1M2 g64 and an x it must copy, and its SASS must hold
    HMMA (or HGMMA).  The bf16-x calls of ``lut8_matmul`` run on the bf16
    family too (its byte LUT case; f32 x and the byte-per-code fp6 with K
    % 4 != 0, checked in ``tests/test_torch_cuda.py``, on the CUDA cores):
    that route is checked likewise on fp8 E4M3 g128 symmetric, E4M3
    per-channel asymmetric K=1088, E3M4 g128 symmetric and E2M5 g128
    asymmetric artifacts (its calls counted by ``torch.profiler`` in phase
    2: one kernel with one split and no pre-norm, the row pass only with
    one), and its SASS as ``lut4_matmul``'s.
18. Two-layer 7B-width fp4 (also under A16) and fp8 logits, kernels vs
    the plain path on the CPU, as phase 3.
19. FP4 model: ``CUT_LAYERS``-layer 7B-width fp4 E2M1 g128 asymmetric model built
    on the card (``pad_n_to=512``, the lm_head included); ``generate`` as
    in phase 4, ``serve`` of phase 7's traffic (warm-up, median of 3,
    profiled run) and a serve with A16 waves and A16 decode (LUT has no
    A8).  Every linear takes ``lut4_matmul`` (``lut4a16_matmul`` under
    A16): ``forwards * (4L + 1)`` launches, no plain call, no route call.
20. FP8 model: 8-layer 7B-width fp8 E4M3 g128 symmetric model,
    ``serve`` as in phase 7, every linear on ``lut8_matmul`` (bf16 x: its
    bf16 route, the qkv and gate_up pre-norms in its row pass).
21. FP6 kernels vs plain: ``lut6_matmul`` and ``lut6a16_matmul`` on fp6
    E2M3 g128 symmetric artifacts in the nq42 layout (``pad_k_to=1024``:
    down's K=11008 stored as 11264) at the five main-path shapes, timed at
    M=8 and M=256, untimed at the other main-path row counts, qkv and
    gate_up also with ``pre_norm``; at the down shape E3M2 g128
    asymmetric, E2M3 g64 symmetric and per-channel asymmetric artifacts, an
    f32 x and a stacked call per kernel; E3M2 under A16 warns and launches
    ``lut6_matmul``.  Then ``lut6a16_matmul`` on E2M3 per-channel K=1088
    (K/4 = 272 slab rows), E2M3 groups of 16 and E1M4 g128 artifacts, and
    its SASS counts and registers, as in phase 12; and the bf16 route of
    ``lut6_matmul`` as in phase 17, on those artifacts and E3M2 g128.
22. FP6 two-layer 7B-width logits (bf16/f32 activations and A16), kernels
    vs the plain path on the CPU, as phase 3.
23. FP6 model: ``CUT_LAYERS``-layer 7B-width fp6 E2M3 g128 symmetric model built
    on the card (``pad_n_to=512``, ``pad_k_to=1024``, the lm_head
    included); ``generate`` as in phase 4, ``serve`` of phase 7's traffic
    (warm-up, median of 3, profiled run) and a serve with A16 waves and A16
    decode.  Every linear takes ``lut6_matmul`` (``lut6a16_matmul`` under
    A16): ``forwards * (4L + 1)`` launches, no plain call, no route call.
24. W4 inner-loop probes: both modes of ``w4_inner_matmul`` (``f32``,
    ``magic``) against their plain versions at the five main-path shapes of
    a W4 g128 model, at M = 1, 8, 9, 64 and 256 (timed at 8 and 256), plus
    an f32 x (the CUDA-core kernel, at the f32 tolerance), a ``k_pad``
    artifact (down, 11008 stored as 11264), an unaligned x, a per-channel
    artifact, and untimed at M=8 at each of the probe's three shapes
    (4096x11264 among them) with the probe's spec; every call one launch
    under its mode's name.  bf16 x takes the tensor-core route (magic on
    the bf16 tensor cores, f32 on the TF32 ones): one device kernel with
    one split, two with a K-split, the CUDA-core kernel and its reduce for
    f32 x (``torch.profiler``, read in phase 2).  The accuracy check of the magic decode's
    fold (ROADMAP B item 4): x of mean 4 and spread 0.1, one-sign weights
    with zero points 0 and 15, base, magic and f32 against the f32 oracle
    at M = 8 and 256, maxrels and the share of outputs off the
    bf16-rounded oracle.  The product kernels' SASS and registers (as in
    phase 12); then the probe entry point
    (``probes/probe_w4_inner.py``) at its three shapes, its lines and JSON
    passed through, with exact launch counts (``base``, ``f32``, ``magic``,
    ``w4a8``, ``a16``), no plain call, no route call.  Its ``base`` is
    ``w4_matmul`` with bf16 x: the bf16 route of phase 2, so the probe
    kernel is read on the redesigned W4 kernel's skeleton.
27. Parallelism (``parallel/``; run after 10f, on phase 4's model): at
    world size 1, ``tp_block=True`` on the 32-layer W4 model, unfused
    (``unfuse_llama``: its fused linears sliced back into their members)
    and re-fused shard-blocked by the engine (d = 1): prefill logits
    against the one-device forward (bf16 tolerance), ``generate`` and one
    ``serve`` of the serving traffic against phase 4's tokens (equal where
    the logits were bit-equal, else the agreement reported), exact
    launches of rows 1 and 2, then the scan ``generate`` (the engine
    prepares and stacks), its tokens the flat TP ones, rows 3 and 4
    exact.  Then ``TP_RANKS`` (2) ranks sharing the one card (gloo; NCCL
    refuses two ranks on one device), model = 2, on a ``CUT_LAYERS``-layer
    W4 model with an unpadded lm_head, each rank building it from the same
    seed: prefill logits, ``generate`` and ``serve`` against one process
    on the same weights (logits within the bf16 tolerance, token agreement
    reported; both ranks' tokens equal), each rank's launches exact (its
    shards: down's local K = 5504), no plain or route call; then a
    two-stage ``make_pp_llama_forward`` pass of 2 micro-batches against
    ``llama_forward`` on rank 0, with each stage's stacked launches.  The
    kernels are built before the ranks start, which only load them.
26. GPTQ (run before the report): the path of ``cli/quantize.py`` and
    ``cli/eval_ppl.py`` on a ``GPTQ_LAYERS``-layer 7B-width LLaMA with
    random f32 weights: ``fold_llama_norms``, ``quantize_model_gptq`` (W4
    g128 asym, 16 ``synthetic`` windows of 512 tokens) with exact launch
    counts (its quantized re-forwards: 5 prenorm and 2 flat calls a sample
    and layer, f32 x, unpadded N; every solve's blocks on the block
    kernel ``csrc/gptq_block.cu``, ``ceil(cols / 128)`` launches a solve,
    no plain block call), seconds per layer (Hessian forwards,
    solve, quantized re-forward), each linear's proxy loss
    ``tr(dW H dW^T)`` below its RTN artifact's, layer 0's q solved on the
    card against the CPU solve of the same H (at least 99.5% of q equal,
    all within 0.3 max|w|) and once more under ``torch.profiler`` (the
    solve's device busy time, idle share and device events a column, and
    the same bits); the block kernel against the plain block loop on the
    card, in turns (layer 0's q and down and a TrueOBS ``sparseout`` solve
    of q bit-equal, their wall seconds; one block's time at 4096 and 11008
    rows against its bound, summed over a layer's launches for the
    ``gptq_block`` row of the report); the artifacts'
    calls of ``w4_matmul`` and ``w4_matmul_prenorm`` against their plain
    versions (f32 x at M=512, bf16 x at M=8); then fused and in bf16 the
    perplexity through the kernels against that of
    ``dequantize_model_params`` (``|d ln PPL| <= PPL_TOL``; the RTN and
    dense models' beside them), ``generate`` and ``serve`` (the lm_head
    dense: ``2L`` launches of each kernel a forward).  Its save and load
    are the CLI phase's (10e), whose artifact holds the same leaf kinds
    (W4 nib4 tensors, a bf16 embedding, a dense lm_head).
25. Report: the generate and serve JSON lines, the card line, the
    per-kernel JSON line (per kernel also ``prefill_ms``,
    ``prefill_bound_ms`` and ``prefill_library_ms``: the M=256 records
    summed as the decode step's; the ``gptq_block`` row a 7B layer's
    launches, from phase 26), and as the last line ``{"ok": true,
    "device": ...}``.

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
    # the reference's layer-stacked forms, timed as rows of their own: the
    # same kernels reading layer l of [L, ...] buffers
    "w4_matmul_pfx": ("iron_weight_only_quant_tpu_torch/csrc/w4_matmul.cu",
                      "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:1712"),
    "w4_matmul_prenorm_pfx": ("iron_weight_only_quant_tpu_torch/csrc/w4_matmul_prenorm.cu",
                              "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:408"),
    "w8_matmul_pfx": ("iron_weight_only_quant_tpu_torch/csrc/w8_matmul.cu",
                      "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:1717"),
    "w8_matmul_prenorm_pfx": ("iron_weight_only_quant_tpu_torch/csrc/w8_matmul_prenorm.cu",
                              "iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:413"),
    "w4_inner_f32": ("iron_weight_only_quant_tpu_torch/csrc/w4_inner_matmul.cu",
                     "scripts/probe_w4_inner.py:67"),
    "w4_inner_magic": ("iron_weight_only_quant_tpu_torch/csrc/w4_inner_matmul.cu",
                       "scripts/probe_w4_inner.py:67"),
    # no Pallas kernel: the JAX solvers' compiled column loop (lax.fori_loop)
    "gptq_block": ("iron_weight_only_quant_tpu_torch/csrc/gptq_block.cu",
                   "iron_weight_only_quant_tpu/quantize/gptq.py:263"),
}
W3_PAD_K = 1024  # down's K=11008 stored as 11264: K/8 = 1408 = 11 groups of 128
FP6_PAD_K = 1024  # the same for nq42: K/4 = 2816 = 22 groups of 128
PFX = "_pfx"  # suffix of a kernel's stacked-form row in the report
CUT_LAYERS = 8  # depth of the model paths beside the 32-layer W4 main path
KV_PAGE = 32  # page size of the paged serves: the 96-column cache is 3 pages
LONG_CONTEXT = 2048  # LLaMA-2's context, for the long-context generate
# Card vs CPU two-layer logits with a quantized KV cache.  A k or v element
# whose card and CPU values straddle a rounding boundary lands one code
# apart: a step of 1/255 (int8) or 1/15 (int4) of its group's range, far
# above rounding.  On the CPU (hidden 1024, 2 layers, W4 g128, four seeds)
# a bf16-sized perturbation (bf16 vs f32 logits, 0.9-1.0e-2 with a 16-bit
# cache) moved the logits 1.3-1.5e-2 with int8 KV and 6.6-8.9e-2 with int4
# KV; the int4 cache itself moves them 0.20 from the 16-bit one, so 1e-1
# still catches a cache that skipped the int4 quantization.  int8 keeps
# the 16-bit bf16 limit.
LOGITS_TOL_KV = {8: 3e-2, 4: 1e-1}


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


def check_call(torch, name, qt, x, run, run_plain, w_lib=None, abits=None, rotate=None):
    """One kernel call against its plain version; records errors and times.
    ``rotate`` = (kernel call, plain call) of (x, i): the timed calls run
    those, which rotate through the layers of a stacked artifact, in place
    of copies of ``qt`` (then one layer's artifact, for the bound)."""
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
        if rotate is None:
            reps = copies_for(qt.qweight.numel())
            qts = [qt] + [qt.map_arrays(torch.clone) for _ in range(reps - 1)]
            rotate = (lambda x, i: run(x, qts[i % reps]),
                      lambda x, i: run_plain(x, qts[i % reps]))
        rec["ms"] = device_ms(lambda i: rotate[0](x, i), 20)
        rec["plain_ms"] = device_ms(lambda i: rotate[1](x, i), 4)
        lib_reps = copies_for(w_lib.numel() * w_lib.element_size())
        ws = [w_lib] + [w_lib.clone() for _ in range(lib_reps - 1)]
        rec["library_ms"] = device_ms(lambda i: torch.matmul(x, ws[i % lib_reps]), 20)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, peak)
        rec["bytes"], rec["ops"], rec["peak"] = nbytes, ops, peak
        del rotate, ws
    print("  " + json.dumps(rec), flush=True)
    if not ok:
        fail(f"{name}: kernel vs plain rel err {rel:.3e} > {tol}")
    return rec


def phase_kernels(torch, device, spec, names, extra_specs=()):
    """Both kernels of a layout (``names``: flat, prenorm) against their
    plain versions; ``extra_specs`` are further (label, spec) artifacts
    checked once at the down shape, untimed, as are an f32 x on the
    ``k_pad`` artifact and a stacked call.  At each main-path shape also
    the stacked form (rows ``<kernel>_pfx``), timed at M=8 and M=256 on a
    stacked artifact of as many layers as the L2 needs to be cold, the
    calls rotating through its layers as a scan forward does."""
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    from iron_weight_only_quant_tpu_torch.models.common import stack_model_layers
    from iron_weight_only_quant_tpu_torch.utils.timing import copies_for

    per_kernel = {name: [] for name in names}
    per_kernel.update({name + PFX: [] for name in names})
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
        n_layers = copies_for(qt.qweight.numel())
        layers = [qt] + [make_artifact(torch, gen, spec, k, widths, device)[0]
                         for _ in range(n_layers - 1)]
        st = stack_model_layers({"layers": [{"lin": {"w": q, "b": None}} for q in layers]},
                                consume=True)["layers_stacked"]["lin"]["w"]
        del layers
        run_st, plain_st = runner(prenorm, n_layers - 1)
        rotate = (lambda x, i: runner(prenorm, i % n_layers)[0](x, st),
                  lambda x, i: runner(prenorm, i % n_layers)[1](x, st))
        for m in (DECODE_M, PREFILL_M):
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            # checked at the last layer; the bound is one layer's (qt's)
            rec = check_call(torch, f"{kname}{PFX}:{name}:M={m}:L={n_layers}", qt, x,
                             lambda x, _: run_st(x, st), lambda x, _: plain_st(x, st),
                             w_lib, rotate=rotate)
            rec.update(kernel=kname + PFX, shape=name, per_step=per_step,
                       stored_n=qt.qweight.shape[-1], spans=spans, layers=n_layers,
                       side_pad=st.side_pad)
            per_kernel[kname + PFX].append(rec)
        del qt, w_lib, st, rotate
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
        check_call(torch, f"{kname}:f32", qt, x.float(), run, run_plain)
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

def phase_two_layers(torch, device, spec, cfg_full, abits_list=(None,), pad_k_to=1,
                     kv_bits_list=(16,)):
    """Two-layer logits, kernels on the card against the plain path on the
    CPU, in f32 and bf16, under each activation-bits setting of
    ``abits_list`` (None: bf16/f32 activations) and each KV cache of
    ``kv_bits_list`` (16: no cache; 8, 4: the forward writes its k and v
    into a quantized cache and attends over their decoded values)."""
    import dataclasses

    from iron_weight_only_quant_tpu_torch.config import KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine.kvcache import make_caches
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
    for dtype, abits, kv_bits in [(d, a, b) for a in abits_list for b in kv_bits_list
                                  for d in (torch.float32, torch.bfloat16)]:
        for p in (params, cpu_params):
            p["embed"] = p["embed"].to(dtype)
            p["final_norm"] = p["final_norm"].to(dtype)

        def caches(dev):
            if kv_bits >= 16:
                return None
            return make_caches(cfg.num_layers, tokens.shape[0], cfg.num_kv_heads, cfg.hd,
                               KVCacheConfig(max_seq_len=tokens.shape[1], kv_bits=kv_bits),
                               dtype, dev)

        with torch.inference_mode(), activation_quant(abits):
            lg, _ = llama_forward(params, tokens, cfg, caches=caches(device))
            lg_ref, _ = llama_forward(cpu_params, tokens.cpu(), cfg, caches=caches("cpu"))
        torch.cuda.synchronize()
        lg, lg_ref = lg.float().cpu(), lg_ref.float()
        if not torch.isfinite(lg).all():
            fail("two-layer logits are not finite")
        rel = ((lg - lg_ref).abs().max() / lg_ref.abs().max()).item()
        agree = (lg.argmax(-1) == lg_ref.argmax(-1)).float().mean().item()
        name = str(dtype).split(".")[-1]
        label = name if abits is None else f"{name} A{abits}"
        tol = LOGITS_TOL_A8 if abits == 8 else LOGITS_TOL[name]
        if kv_bits < 16:
            label, tol = f"{label} KV{kv_bits}", max(tol, LOGITS_TOL_KV[kv_bits])
        out[label] = {"rel_err": rel, "tol": tol, "argmax_agree": agree}
        print(f"  logits {label}: max|d|/max|ref| = {rel:.3e} (tol "
              f"{tol}), argmax agreement {agree:.4f}", flush=True)
        if rel > tol:
            fail(f"two-layer logits ({label}) rel err {rel:.3e} > {tol}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 4

def expected_launches(names, forwards: int, n_layers: int, stacked: bool = False,
                      dense_head: bool = False):
    """Launch counts of ``forwards`` model forwards whose linears all take
    the kernels ``names`` (flat, prenorm): o, down and the lm_head go to the
    flat kernel, the fused qkv and gate_up to the prenorm one (the same
    kernel for W3, whose pre-norm runs in torch).  ``stacked``: the stacked
    launches among them on the scan path, every linear but the lm_head.
    ``dense_head``: the lm_head is a dense matmul (GPTQ models)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    want = {name: 0 for name in dm.LAUNCHES}
    want[names[0]] += forwards * (2 * n_layers + int(not (stacked or dense_head)))
    want[names[1]] += forwards * 2 * n_layers
    return want


def expected_a_launches(names, waves: int, steps: int, n_layers: int,
                        stacked: bool = False):
    """Launch counts of ``waves`` prefill forwards on ``names[0]`` and
    ``steps`` decode forwards on ``names[1]``: under activation bits every
    linear of a forward (4 per layer and the lm_head) takes the phase's
    int-activation kernel.  ``stacked``: those of the layers, without the
    lm_head (the scan path's stacked launches)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    want = {name: 0 for name in dm.LAUNCHES}
    want[names[0]] += waves * (4 * n_layers + int(not stacked))
    want[names[1]] += steps * (4 * n_layers + int(not stacked))
    return want


def check_counts(what, want, want_stacked=None):
    """Read the counters after a run: exactly the launches ``want``, of
    them exactly ``want_stacked`` on stacked artifacts (None: none), no
    plain call, no call of the XLA route."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    launches, plain = dict(dm.LAUNCHES), dict(dm.PLAIN_CALLS)
    stacked = dict(dm.STACKED_LAUNCHES)
    want_stacked = want_stacked or {name: 0 for name in dm.LAUNCHES}
    print(f"  {what}: launches {launches}, expected {want}; stacked "
          f"{ {k: v for k, v in stacked.items() if v} }; plain calls {plain}, "
          f"route calls {dm.ROUTE_CALLS}", flush=True)
    if launches != want:
        fail(f"{what}: kernel launches {launches} != expected {want}")
    if stacked != want_stacked:
        fail(f"{what}: stacked launches {stacked} != expected {want_stacked}")
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
    res = run_generate(torch, eng, prompts, cfg, card,
                       lambda f: (expected_launches(names, f, cfg.num_layers), None))
    res["build_s"] = build_s

    print(f"  -- {label} serve (one warm-up run, {serve_runs} timed)", flush=True)
    serve = phase_serve(torch, eng.params, cfg, names, serve_runs, card)
    fused = eng.params  # kept for the A-serve
    del eng, params
    torch.cuda.empty_cache()
    return res, serve, fused


def run_generate(torch, eng, prompts, cfg, card, expect, label="generate"):
    """``eng.generate`` of ``prompts``, greedy: a warm-up run of
    ``NEW_TOKENS`` (on the card it captures the decode chunks' CUDA graphs,
    16 and 15 steps), a prefill-only run (its wall time), then
    ``NEW_TOKENS`` with the counters zeroed before and read after (the
    chunks replay): ``expect(forwards)`` gives the launches and the stacked
    launches (None: none) the run must make, and the tokens must be the
    warm-up's.  The result holds the tokens and the prompts (dropped from
    the report) and the engine's graph counts."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    warm = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
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
    want, want_stacked = expect(1 + (NEW_TOKENS - 1))
    launches = check_counts(label, want, want_stacked)
    if len(out) != len(prompts) or any(len(o) != NEW_TOKENS for o in out):
        fail(f"{label} returned {[len(o) for o in out]} tokens")
    if any(not 0 <= t < cfg.vocab_size for o in out for t in o):
        fail(f"{label}: a generated token is out of the vocabulary")
    if out != warm:
        fail(f"{label}: greedy tokens differ between two runs of the same prompts")
    decode_s = gen_s - prefill_s
    tok_s = len(prompts) * (NEW_TOKENS - 1) / decode_s
    res = {"prefill_s": prefill_s, "generate_s": gen_s,
           "decode_tok_per_s": tok_s, "decode_step_ms": decode_s * 1e3 / (NEW_TOKENS - 1),
           "prefill_tokens": len(prompts) * max(len(p) for p in prompts),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "stacked_launches": dict(dm.STACKED_LAUNCHES),
           "graphs": graph_stats(eng), "card": card, "tokens": out, "prompts": prompts}
    print(f"  {label}: decode {tok_s:.1f} tok/s at batch {len(prompts)} "
          f"({res['decode_step_ms']:.2f} ms/step), prefill "
          f"{prefill_s * 1e3:.1f} ms for {res['prefill_tokens']} tokens, on {card}",
          flush=True)
    print("  first tokens: " + json.dumps([o[:8] for o in out[:2]]), flush=True)
    return res


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


def serve_engine(torch, params, cfg, kv=None, forward=None, family="llama", tp_block=False,
                 **ecfg):
    """(engine, requests) of the serving traffic; the cache holds the
    longest request plus the new tokens, as bench.py sizes it.  ``kv``
    adds KV cache options (``kv_bits``, paging), ``ecfg`` engine options
    (the activation bits, the mesh); ``forward`` is ``llama_forward``
    unless given (a LLaMA engine fuses q|k|v and gate|up); ``tp_block``
    asks for the tensor-parallel forward."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward

    reqs = serve_requests(cfg.vocab_size)
    t_need = max(len(r) for r in reqs) + NEW_TOKENS
    ecfg = EngineConfig(kv=KVCacheConfig(max_seq_len=t_need, **(kv or {})),
                        max_batch_size=SERVE_SLOTS, fuse_projections=family == "llama",
                        **ecfg)
    eng = InferenceEngine(params, cfg, forward or llama_forward, family=family,
                          engine_cfg=ecfg, dtype=torch.bfloat16,
                          device=params["embed"].device, tp_block=tp_block)
    return eng, reqs


def device_time_by_name(prof):
    """{kernel name: (count, us)} of a trace's device records, read from
    the profiler's raw records (``prof.events()`` would first build a
    Python event for each host and device record, which is slow)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return by_name


def profile_serve(torch, eng, reqs):
    """One more serve run under ``torch.profiler``: its wall time, the
    device's busy time (the sum of its kernel and copy intervals: one
    stream, so they do not overlap), the idle share, and the device time
    by kernel.  The profiler slows the host, so the idle share is an upper
    bound for an unprofiled run.  The device intervals are read from the
    profiler's raw records: ``prof.events()`` would first build a Python
    event for each of the run's host and device records, hundreds of
    thousands, which is slow."""
    from iron_weight_only_quant_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_time_by_name(prof)
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


def ab_serve(torch, sides, reqs, card, rounds=SERVE_RUNS, warmup=False):
    """The serving traffic on two engines in turns, A B B A A B ..., so
    that both meet the same host (after one untimed run of each side if
    ``warmup``: on the card it captures the engine's CUDA graphs):
    ``sides`` = [(label, engine, expect)], ``expect(stats)`` = (launches,
    stacked launches) each run must make.  Both sides must give the same
    tokens.  Per side the median run's wall time, tok/s and TTFT/TPOT
    percentiles, the best tok/s, every wall time, the most device memory
    allocated in a run, the engine's graph counts after the runs, and the
    tokens; ``<A>_over_<B>``: the ratio of the median tok/s."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    if warmup:
        for _, eng, _ in sides:
            eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK)
    order = [sides[(i + i // 2) % 2] for i in range(2 * rounds)]
    engines = {label: eng for label, eng, _ in sides}
    runs = {label: [] for label in engines}
    peak = {label: 0 for label in engines}
    for label, eng, expect in order:
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dm.reset_counts()
        t0 = time.perf_counter()
        out = eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak[label] = max(peak[label], torch.cuda.max_memory_allocated())
        launches = check_counts(f"serve ({label})", *expect(stats))
        runs[label].append((wall, stats, launches, out))
        print(f"  serve ({label}): {wall:.3f} s", flush=True)
    res = {}
    for label, rs in runs.items():
        if any(r[3] != rs[0][3] for r in rs) or rs[0][3] != runs[sides[0][0]][0][3]:
            fail(f"serve ({label}): tokens differ between runs or from the other side's")
        rs = sorted(rs, key=lambda r: r[0])
        wall, stats, launches, out = rs[len(rs) // 2]
        n_gen = sum(len(o) for o in out)
        res[label] = {
            "wall_s": wall, "toks_per_s": n_gen / wall, "best_toks_per_s": n_gen / rs[0][0],
            "walls_s": [r[0] for r in rs], "timed_runs": len(rs),
            "ttft_p50_ms": percentile_ms(stats["ttft_s"], 50),
            "ttft_p95_ms": percentile_ms(stats["ttft_s"], 95),
            "tpot_p50_ms": percentile_ms(stats["tpot_s"], 50),
            "tpot_p95_ms": percentile_ms(stats["tpot_s"], 95),
            "device_steps": stats["n_steps"], "launches": launches,
            "peak_gib": peak[label] / 2**30,
            "graphs": graph_stats(engines[label]), "card": card,
            "tokens": out}
        print(f"  serve ({label}) {res[label]['toks_per_s']:.1f} generated tok/s (median of "
              f"{len(rs)}, in turns; best {res[label]['best_toks_per_s']:.1f}), TTFT p50/p95 "
              f"{res[label]['ttft_p50_ms']:.1f}/{res[label]['ttft_p95_ms']:.1f} ms, TPOT p50/p95 "
              f"{res[label]['tpot_p50_ms']:.1f}/{res[label]['tpot_p95_ms']:.1f} ms, on {card}",
              flush=True)
    (a, _, _), (b, _, _) = sides
    res[f"{a}_over_{b}"] = res[a]["toks_per_s"] / res[b]["toks_per_s"]
    print(f"  {a} / {b} generated tok/s (medians): {res[f'{a}_over_{b}']:.3f}", flush=True)
    return res


def phase_serve(torch, params, cfg, names, runs, card, abits=None, kv=None, warmup=True,
                forward=None, profile=True, dense_head=False):
    """``InferenceEngine.serve`` of the serving traffic: one warm-up run
    (unless ``warmup`` is false: the model's kernels are warm already),
    then ``runs`` timed runs (the median run is reported, the best wall
    time beside it), then one profiled run.  ``params`` may be fused
    already (fusing is idempotent).  Every counted run must launch
    the kernels ``names`` exactly ``n_steps`` forwards' worth, never the
    plain path, and give 32 in-vocabulary tokens per request, the same in
    every run.  With ``abits`` = (prefill_activation_bits,
    activation_bits), ``names`` are the (wave, decode) int-activation
    kernels: the waves (one per combo) launch the first, the other device
    steps the second.  ``kv``: KV cache options (``kv_bits``, paging).  The
    result holds the tokens (``tokens``) and the bytes the KV buffers hold
    (``kv_bytes``); under paging also the pages handed out and the most
    held at once.  ``forward`` (``llama_forward`` unless given) is the
    model's forward; on a scan forward every linear but the lm_head must
    take the stacked kernels.  ``profile=False`` skips the profiled run;
    ``dense_head``: the lm_head is a dense matmul (GPTQ models)."""
    from iron_weight_only_quant_tpu_torch.engine.kvcache import cache_bytes
    from iron_weight_only_quant_tpu_torch.models.common import is_scan_forward
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    ecfg = {} if abits is None else dict(prefill_activation_bits=abits[0],
                                         activation_bits=abits[1])
    eng, reqs = serve_engine(torch, params, cfg, kv=kv, forward=forward, **ecfg)
    scan = forward is not None and is_scan_forward(forward)
    kv_bytes = cache_bytes(eng._fresh_caches(SERVE_SLOTS))
    first = None
    timed = []
    for i in range(1 - int(warmup), 1 + runs):
        stats = {}
        torch.cuda.synchronize()
        dm.reset_counts()
        t0 = time.perf_counter()
        out = eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK,
                        stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if abits is None:
            want, want_stacked = (expected_launches(names, stats["n_steps"], cfg.num_layers,
                                                    stacked=st, dense_head=dense_head)
                                  for st in (False, True))
        else:  # one wave per combo
            want, want_stacked = (expected_a_launches(
                names, stats["n_combos"], stats["n_steps"] - stats["n_combos"],
                cfg.num_layers, stacked=st) for st in (False, True))
        launches = check_counts(f"serve run {i}", want, want_stacked if scan else None)
        stacked_launches = dict(dm.STACKED_LAUNCHES)
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
            timed.append((wall, stats, launches, stacked_launches))
    timed.sort(key=lambda t: t[0])
    wall, stats, launches, stacked_launches = timed[len(timed) // 2]
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
        "launches": launches, "stacked_launches": stacked_launches, "card": card,
        "kv": kv or {}, "kv_bytes": kv_bytes, "graphs": graph_stats(eng), "tokens": first,
    }
    if "pages_peak" in stats:
        res.update(n_page_allocs=stats["n_page_allocs"], pages_peak=stats["pages_peak"])
    print(f"  serve {res['toks_per_s']:.1f} generated tok/s, "
          f"{res['total_toks_per_s']:.1f} total tok/s, wall {wall:.3f} s (median of "
          f"{runs}; best {res['best_toks_per_s']:.1f} tok/s), {res['syncs']} syncs, "
          f"{res['device_steps']} device steps; "
          f"TTFT p50/p95 {res['ttft_p50_ms']:.1f}/{res['ttft_p95_ms']:.1f} ms, "
          f"TPOT p50/p95 {res['tpot_p50_ms']:.1f}/{res['tpot_p95_ms']:.1f} ms "
          f"(measured at sync granularity), KV buffers {kv_bytes / 2**20:.1f} MiB, "
          f"on {card}", flush=True)
    print("  first tokens: " + json.dumps([o[:8] for o in first[:2]]), flush=True)
    if profile:
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


# ------------------------------------------------------- phases 10a-10e

def phase_kv_codec(torch, device):
    """The KV codec on the card bit-equal to the CPU, and paged round trips."""
    from iron_weight_only_quant_tpu_torch.config import KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import kvcache as kvc

    gen = torch.Generator().manual_seed(5)
    checks = 0
    for dtype in (torch.bfloat16, torch.float32):
        for s in (1, 64):
            x = (torch.randn((8, s, 32, 128), generator=gen) * 2).to(dtype)
            x_card = x.to(device)
            for bits in (8, 4):
                for g in (128, 64):
                    packed = bits == 4
                    card = kvc._encode(x_card, bits, g, packed)
                    cpu = kvc._encode(x, bits, g, packed)
                    card += (kvc._decode(*card, 128, dtype, packed),)
                    cpu += (kvc._decode(*cpu, 128, dtype, packed),)
                    for what, a, b in zip(("codes", "scales", "zeros", "decoded"), card, cpu):
                        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                            fail(f"KV codec {dtype} S={s} bits={bits} g={g}: the card's "
                                 f"{what} differ from the CPU's")
                    checks += 1
    print(f"  KV codec: {checks} encode/decode calls bit-equal to the CPU "
          "(codes, scales, zeros, decoded values)", flush=True)

    # paged round trips: two appends of 40 and 24 tokens into 32-token pages
    k = torch.randn((8, 64, 32, 128), generator=gen).to(device, torch.bfloat16)
    v = torch.randn((8, 64, 32, 128), generator=gen).to(device, torch.bfloat16)
    read = {}
    for label, kv in (("paged 16-bit", dict(paged=True)), ("paged int8", dict(paged=True, kv_bits=8)),
                      ("contiguous int8", dict(kv_bits=8))):
        cfg = KVCacheConfig(max_seq_len=256, page_size=KV_PAGE, **kv)
        (view,) = kvc.make_caches(1, 8, 32, 128, cfg, torch.bfloat16, device)
        for a, b in ((0, 40), (40, 64)):
            view, k_all, v_all = kvc.update_and_fetch(view, k[:, a:b], v[:, a:b])
        read[label] = (k_all[:, :64], v_all[:, :64])
    if not (torch.equal(read["paged 16-bit"][0], k) and torch.equal(read["paged 16-bit"][1], v)):
        fail("paged 16-bit KV: the pool does not read back what was written")
    if not all(torch.equal(a, b) for a, b in zip(read["paged int8"], read["contiguous int8"])):
        fail("paged int8 KV reads other values than the contiguous int8 cache")
    torch.cuda.synchronize()
    print("  paged KV: a 16-bit pool reads back exactly; an int8 pool reads the "
          "contiguous int8 cache's values", flush=True)
    return checks


def serve_once(torch, params, cfg, kv):
    """The serving traffic's tokens from one untimed serve run with the
    KV cache ``kv`` (W4 kernels, exact launches)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    eng, reqs = serve_engine(torch, params, cfg, kv=kv)
    stats = {}
    dm.reset_counts()
    out = eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK, stats=stats)
    torch.cuda.synchronize()
    check_counts(f"serve, KV {kv}", expected_launches((dm.W4, dm.W4_PRENORM),
                                                      stats["n_steps"], cfg.num_layers))
    return {"tokens": out}


def phase_kv_serves(torch, params, cfg, card):
    """``serve`` of the serving traffic under each KV cache of the phase
    (three timed runs and a profiled one each; the kernels are warm from
    phase 4); paged tokens must equal the contiguous serve's of the same
    ``kv_bits`` (one untimed run each, 16-bit and int8)."""
    from iron_weight_only_quant_tpu_torch.engine.kvcache import pool_pages
    from iron_weight_only_quant_tpu_torch.config import KVCacheConfig
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    t_need = max(len(r) for r in serve_requests(cfg.vocab_size)) + NEW_TOKENS
    if t_need % KV_PAGE:
        fail(f"the serve cache's {t_need} columns are no whole number of {KV_PAGE}-token "
             "pages: paged and contiguous timelines would differ in length")
    paged = dict(paged=True, page_size=KV_PAGE)
    settings = [("paged16", paged), ("paged_kv8", {**paged, "kv_bits": 8}),
                ("kv4", dict(kv_bits=4)), ("paged_kv4", {**paged, "kv_bits": 4})]
    runs = {}

    def run(label, kv):
        print(f"  -- serve, KV {label}: {kv}", flush=True)
        runs[label] = phase_serve(torch, params, cfg, (dm.W4, dm.W4_PRENORM), SERVE_RUNS,
                                  card, kv=kv, warmup=False)

    for label, kv in settings:
        run(label, kv)
    serve_16 = serve_once(torch, params, cfg, None)
    kv8 = serve_once(torch, params, cfg, dict(kv_bits=8))
    # the least pool this traffic runs in: its peak and the garbage page
    full = pool_pages(SERVE_SLOTS, KVCacheConfig(max_seq_len=t_need, **paged))
    small = runs["paged_kv8"]["pages_peak"] + 1
    run("paged_kv8_small_pool", {**paged, "kv_bits": 8, "num_pages": small})
    pool = runs["paged_kv8_small_pool"]
    print(f"  small pool: {small} of {full} pages, {pool['n_page_allocs']} pages handed out, "
          f"at most {pool['pages_peak']} held", flush=True)
    if not (small < full and pool["n_page_allocs"] > small - 1):
        fail("the small pool is not smaller than the full pool, or recycled no page")
    for got, want in (("paged16", serve_16), ("paged_kv8", kv8),
                      ("paged_kv4", runs["kv4"]), ("paged_kv8_small_pool", runs["paged_kv8"])):
        if runs[got]["tokens"] != want["tokens"]:
            fail(f"serve with KV {got} gave other tokens than its contiguous (or full-pool) "
                 "serve")
    print("  paged serves: the tokens of their contiguous serves; the small pool: the full "
          "pool's", flush=True)
    return runs


def phase_long_generate(torch, params, cfg, card, step_ms_short):
    """``generate`` of phase 4's prompt lengths on an int8 paged cache of
    ``LONG_CONTEXT`` columns: wall ms per decode step."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.engine.kvcache import cache_bytes
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    kv = KVCacheConfig(max_seq_len=LONG_CONTEXT, kv_bits=8, paged=True, page_size=KV_PAGE)
    eng = InferenceEngine(params, cfg, llama_forward, family="llama",
                          engine_cfg=EngineConfig(fuse_projections=True, kv=kv),
                          dtype=torch.bfloat16, device=params["embed"].device)
    gen = torch.Generator(device=eng.device).manual_seed(4)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=eng.device).tolist() for n in PROMPT_LENS]
    kv_bytes = cache_bytes(eng._fresh_caches(BATCH))
    warm = eng.generate(prompts, max_new_tokens=NEW_TOKENS)  # captures the chunks' graphs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    dm.reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check_counts("long-context generate", expected_launches(
        (dm.W4, dm.W4_PRENORM), NEW_TOKENS, cfg.num_layers))
    if any(len(o) != NEW_TOKENS for o in out) or out != warm:
        fail("long-context generate: wrong token counts, or tokens that differ between runs")
    step_ms = (gen_s - prefill_s) * 1e3 / (NEW_TOKENS - 1)
    res = {"max_seq_len": LONG_CONTEXT, "kv": "int8 paged", "page_size": KV_PAGE,
           "prefill_s": prefill_s, "generate_s": gen_s, "decode_step_ms": step_ms,
           "decode_step_ms_phase4": step_ms_short, "kv_bytes": kv_bytes,
           "graphs": graph_stats(eng), "card": card}
    print(f"  {LONG_CONTEXT}-column int8 paged cache ({kv_bytes / 2**30:.2f} GiB): decode "
          f"{step_ms:.2f} ms/step at batch {BATCH} (phase 4, 16-bit, "
          f"{max(PROMPT_LENS) + NEW_TOKENS + 8} columns: {step_ms_short:.2f}), on {card}",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------- phase 10e

CLI_LAYERS = 2  # depth of the CLI phase's model (its save is host deflate)
CLI_NEW_TOKENS = 8
CLI_SEQ = 64  # --max_seq_len of the CLI's generate: the longest prompt's 33 tokens, 8 new
CLI_PPL_SEQLEN = 512
CLI_PPL_CHUNKS = 8  # two batches of four chunks
ZS_TASKS = ("piqa", "arc_easy", "boolq", "copa", "lambada")
ZS_LIMIT = 16  # documents a task
# pairs a batch of the CPU's plain path: two batches, as each batch
# dequantizes every linear anew (batches of 32 took 36.1 s on the H100's host)
ZS_CPU_BATCH = 88
# the linears the host library's RTN is timed on alone: a 4096-row one and
# the 11008-row one
HOST_RTN_LINEARS = ("q", "down")
# |loglikelihood through the kernels - the CPU plain path's|, bf16, summed
# over a continuation's tokens, the largest over a run's pairs.  Set
# between the readings of the H100 runs that first held it: 4.105e-2 over
# all 176 pairs (9.491e-3, 1.964e-2, 4.281e-2 over 6), and the dense
# model against the W4 one up to 1.030-2.135 (median 0.343), so that a
# forward that skipped the quantized weights would fail
ZS_LL_TOL = 1e-1


def artifact_leaves(t):
    """The tensors and artifact fields of a param tree in a fixed order;
    None leaves (folded norms, absent biases) are left out, as a saved
    artifact leaves them out."""
    from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor

    if isinstance(t, dict):
        return [x for k in sorted(t) for x in artifact_leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in artifact_leaves(v)]
    if isinstance(t, QuantizedTensor):
        return [(t.spec, t.shape, t.mode, t.k_shards, t.n_pad, t.k_pad)] + [
            getattr(t, f) for f in ("qweight", "scales", "zeros", "codebook")
            if getattr(t, f) is not None]
    return [] if t is None else [t]


def check_same_leaves(torch, what, got, want):
    """Every tensor of ``got`` equals ``want``'s in device, dtype and bits,
    every artifact field is equal; else the phase fails.  Returns the count."""
    got, want = artifact_leaves(got), artifact_leaves(want)
    if len(got) != len(want):
        fail(f"{what}: the trees have other structures")
    for a, b in zip(got, want):
        same = (a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                if torch.is_tensor(b) else a == b)
        if not same:
            fail(f"{what}: a tensor or artifact field differs")
    return len(want)


def write_hf_checkpoint(torch, path, cfg, seed, device):
    """A LLaMA checkpoint in the HF layout, float16 (the published LLaMA-2-7B
    checkpoint's dtype), random from ``seed``: ``config.json`` and one
    ``model.safetensors`` written here (an 8-byte little-endian header
    length, a JSON header padded to 8 bytes, the raw bytes).  Returns the
    file's bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, hd = cfg.hidden_size, cfg.hd
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def lin(rows, cols):  # HF [out, in]
        return (torch.randn((rows, cols), generator=gen, device=device)
                * cols**-0.5).to(torch.float16)

    def norm():
        return (1 + 0.1 * torch.randn((h,), generator=gen, device=device)).to(torch.float16)

    tensors = {"model.embed_tokens.weight": (torch.randn(
        (cfg.vocab_size, h), generator=gen, device=device) * 0.02).to(torch.float16)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": norm(),
            p + "self_attn.q_proj.weight": lin(qdim, h),
            p + "self_attn.k_proj.weight": lin(kvdim, h),
            p + "self_attn.v_proj.weight": lin(kvdim, h),
            p + "self_attn.o_proj.weight": lin(h, qdim),
            p + "post_attention_layernorm.weight": norm(),
            p + "mlp.gate_proj.weight": lin(cfg.intermediate_size, h),
            p + "mlp.up_proj.weight": lin(cfg.intermediate_size, h),
            p + "mlp.down_proj.weight": lin(h, cfg.intermediate_size),
        })
    tensors["model.norm.weight"] = norm()
    tensors["lm_head.weight"] = lin(cfg.vocab_size, h)
    header, offset = {}, 0
    for name, t in tensors.items():
        header[name] = {"dtype": "F16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + 2 * t.numel()]}
        offset += 2 * t.numel()
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for t in tensors.values():
            f.write(t.cpu().numpy().tobytes())
    config = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
              "torch_dtype": "float16", "vocab_size": cfg.vocab_size, "hidden_size": h,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
              "num_key_value_heads": cfg.num_kv_heads,
              "max_position_embeddings": cfg.max_position_embeddings,
              "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
              "tie_word_embeddings": cfg.tie_word_embeddings}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return 8 + len(head) + offset


def run_cli(main, argv):
    """``main(argv)`` with its standard output captured: (return value,
    printed lines, seconds).  The lines are echoed, indented."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    secs = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines[:40]:
        print(f"    | {line}", flush=True)
    return out, lines, secs


def zeroshot_docs(task, n, seed):
    """``n`` local documents of ``task`` (the fields its prompts read), made
    from ``seed``: the card machine has no ``datasets`` and no network."""
    import random

    rng = random.Random(f"{task}-{seed}")
    words = ("the a cat dog sun rain water fire stone tree bird fish red blue green old "
             "new runs jumps sleeps eats holds opens falls grows because then").split()

    def s(k):
        return " ".join(rng.choice(words) for _ in range(k))

    docs = []
    for i in range(n):
        if task == "piqa":
            docs.append({"goal": s(8), "sol1": s(6), "sol2": s(7), "label": i % 2})
        elif task == "arc_easy":
            docs.append({"question": s(10), "choices": {"text": [s(3) for _ in range(4)],
                                                        "label": list("ABCD")},
                         "answerKey": "ABCD"[i % 4]})
        elif task == "boolq":
            docs.append({"passage": s(30), "question": s(6), "label": i % 2})
        elif task == "copa":
            docs.append({"premise": s(7) + ".", "question": ("cause", "effect")[i % 2],
                         "choice1": "He " + s(4), "choice2": "She " + s(4), "label": i % 2})
        elif task == "lambada":
            docs.append({"text": s(24)})
    return docs


# the datasets the zero-shot phase's tasks would load (tasks.py ``dataset``)
ZS_DATASETS = {("piqa", None): "piqa", ("ai2_arc", "ARC-Easy"): "arc_easy",
               ("super_glue", "boolq"): "boolq", ("super_glue", "copa"): "copa",
               ("EleutherAI/lambada_openai", "default"): "lambada"}
ZS_CHOICES = {"piqa": 2, "arc_easy": 4, "boolq": 2, "copa": 2, "lambada": 1}


def phase_cli(torch, device, cfg_full, card):
    """The CLI path (``cli.quantize``, ``cli.generate``, ``cli.eval_ppl``,
    ``cli.eval_zeroshot``) at LLaMA-2-7B widths and ``CLI_LAYERS`` layers,
    run as a user runs it, on the card by default: a float16 HF checkpoint
    written here, quantized to W4 g128 (``--pad_n 512``) on the card (RTN
    runs where the weights are) into the run's only artifact save, then
    served, scored and evaluated from that artifact; the zero-shot results
    are held against ``evaluate`` on the CPU's plain path.  The host
    library's RTN (what ``--platform cpu`` runs) is timed on its own on
    two of layer 0's linears and held to the card's bytes.  The depth is cut because the save is
    host deflate, most of it the bf16 embedding and lm_head; two layers
    keep a layer-to-layer path.  Also ``tokenshard:`` windows and
    ``analysis.stats`` on the artifact."""
    import dataclasses
    import random
    import shutil
    import tempfile

    import numpy as np

    from iron_weight_only_quant_tpu_torch.analysis import codeword_histogram
    from iron_weight_only_quant_tpu_torch.cli import eval_ppl as cli_ppl
    from iron_weight_only_quant_tpu_torch.cli import eval_zeroshot as cli_zs
    from iron_weight_only_quant_tpu_torch.cli import generate as cli_generate
    from iron_weight_only_quant_tpu_torch.cli import quantize as cli_quantize
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig, QuantSpec
    from iron_weight_only_quant_tpu_torch.data import get_loaders
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.evals import EvalLM, SequentialPPLEvaluator
    from iron_weight_only_quant_tpu_torch.evals.zeroshot import evaluate
    from iron_weight_only_quant_tpu_torch.evals.zeroshot import tasks as zs_tasks
    from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
    from iron_weight_only_quant_tpu_torch.models.convert_hf import load_checkpoint_dir
    from iron_weight_only_quant_tpu_torch.models.llama import fuse_llama_projections, llama_forward
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor
    from iron_weight_only_quant_tpu_torch.quantize.artifact import load_artifact
    from iron_weight_only_quant_tpu_torch.quantize.model_pass import quantize_model_params
    from iron_weight_only_quant_tpu_torch.quantize.rtn import native_quantize_tensor

    cfg = dataclasses.replace(cfg_full, num_layers=CLI_LAYERS)
    n_layers = cfg.num_layers
    spec = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    res = {"layers": n_layers, "card": card}

    def w4_only(forwards, per_forward):
        want = {name: 0 for name in dm.LAUNCHES}
        want[dm.W4] = forwards * per_forward * n_layers
        return want

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_cli_", dir=root)
    try:
        ckpt, art = os.path.join(tmp, "ckpt"), os.path.join(tmp, "art")
        os.makedirs(ckpt)
        print("  -- a: a float16 HF checkpoint", flush=True)
        t0 = time.perf_counter()
        res["checkpoint_bytes"] = write_hf_checkpoint(torch, ckpt, cfg, 50, device)
        res["write_s"] = time.perf_counter() - t0
        print(f"  checkpoint: {res['checkpoint_bytes'] / 2**20:.1f} MiB written in "
              f"{res['write_s']:.2f} s", flush=True)

        print("  -- b: cli.quantize (RTN on the card, W4 g128, --pad_n 512): the run's only "
              "artifact save", flush=True)
        dm.reset_counts()
        _, lines, res["quantize_cli_s"] = run_cli(cli_quantize.main, [
            "--model_path", ckpt, "--w_bits", "4", "--w_group_size", "128", "--pad_n", "512",
            "--out", art])
        torch.cuda.synchronize()
        check_counts("cli quantize", w4_only(0, 0))
        if not lines or f"quantized {7 * n_layers} linears (int4 g128)" not in lines[-1] \
                or "via native lib" in lines[-1]:
            # a weight on the card is quantized there, never through the host
            fail(f"cli quantize printed {lines[-1:]}")
        res["artifact_bytes"] = sum(os.path.getsize(os.path.join(art, f))
                                    for f in os.listdir(art))
        t0 = time.perf_counter()
        family, cfg2, loaded = load_artifact(art, device=device)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
        if family != "llama" or cfg2 != cfg:
            fail("load_artifact gave another family or config")
        t0 = time.perf_counter()
        cfg3, dense, _ = load_checkpoint_dir(ckpt, device=device)
        torch.cuda.synchronize()
        res["checkpoint_load_s"] = time.perf_counter() - t0
        if cfg3 != cfg or dense["embed"].dtype != torch.bfloat16:
            fail("load_checkpoint_dir gave another config or dtype")
        t0 = time.perf_counter()
        ref, report = quantize_model_params(
            dense, spec, quantize_fn=lambda w, path: quantize_tensor(w, spec, pad_n_to=512),
            device=device)
        torch.cuda.synchronize()
        res["rtn_card_s"] = time.perf_counter() - t0
        if report["n_quantized"] != 7 * n_layers or report["n_skipped"] != 1:
            fail(f"model pass: {report['n_quantized']} quantized, {report['n_skipped']} skipped")
        res["leaves"] = check_same_leaves(torch, "the CLI's artifact vs RTN on the card",
                                          loaded, ref)
        print(f"  artifact: {res['artifact_bytes'] / 2**20:.1f} MiB; cli.quantize "
              f"{res['quantize_cli_s']:.2f} s (checkpoint read, card RTN, save); load onto "
              f"the card {res['load_s']:.2f} s; the checkpoint alone read onto the card in "
              f"{res['checkpoint_load_s']:.2f} s, quantized there in {res['rtn_card_s']:.2f} s: "
              f"{res['leaves']} leaves bit-equal", flush=True)
        # the host library alone (what --platform cpu runs), on two of layer
        # 0's linears already in host memory, against the card's RTN of them
        host_s = card_s = 0.0
        n_weights = 0
        for name in HOST_RTN_LINEARS:
            w = dense["layers"][0][name]["w"]
            w_host = w.cpu()
            t0 = time.perf_counter()
            host_qt = native_quantize_tensor(w_host, spec, pad_n_to=512)
            host_s += time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quantize_tensor(w, spec, pad_n_to=512)
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t0
            n_weights += w.numel()
            check_same_leaves(torch, f"the host library vs the card's RTN ({name})", host_qt,
                              ref["layers"][0][name]["w"].map_arrays(lambda a: a.cpu()))
        res["host_rtn"] = {"linears": HOST_RTN_LINEARS, "weights": n_weights,
                           "host_s": host_s, "card_s": card_s}
        print(f"  RTN of layer 0's {' and '.join(HOST_RTN_LINEARS)} ({n_weights / 1e6:.1f} M "
              f"weights): "
              f"the host library {host_s:.3f} s (one thread, from host memory), the card "
              f"{card_s:.4f} s; bytes equal", flush=True)
        docs = {t: zeroshot_docs(t, ZS_LIMIT, 52) for t in ZS_TASKS}
        tasks = [zs_tasks.get_task(t, docs=docs[t]) for t in ZS_TASKS]

        def encode(s):  # the CLI's demo tokenizer: Python's hash, salted per
            # process, so these are the CLI's ids only within this process
            return [(hash(w) % (cfg.vocab_size - 2)) + 2 for w in s.split()] or [1]

        # the pairs evaluate() builds, in its order
        pairs = [(encode(r.context), encode(r.continuation)) for t in tasks
                 for d in docs[t.name][:ZS_LIMIT] for r in t.requests(d)]
        # what a forward that skipped the quantized weights would read: the
        # dense bf16 model's loglikelihoods
        dense_ll = EvalLM(dense, llama_forward, cfg).loglikelihood(pairs)
        del dense

        gen = torch.Generator(device=device).manual_seed(51)
        prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen, device=device).tolist()
                   for n in PROMPT_LENS[::2]]
        ecfg = EngineConfig(fuse_projections=True, kv=KVCacheConfig(max_seq_len=CLI_SEQ))
        engines = {k: InferenceEngine(p, cfg, llama_forward, family="llama", engine_cfg=ecfg,
                                      device=device) for k, p in (("ref", ref), ("art", loaded))}
        del ref
        toks = {}
        for k, eng in engines.items():
            dm.reset_counts()
            toks[k] = eng.generate(prompts, max_new_tokens=CLI_NEW_TOKENS)
            torch.cuda.synchronize()
            # gammas not folded: the fused and unfused linears (4 a layer)
            # on w4_matmul, the dense lm_head in torch
            check_counts(f"generate ({k})", w4_only(CLI_NEW_TOKENS, 4))
        if toks["ref"] != toks["art"]:
            fail("the loaded artifact generates other tokens than the card-quantized model")
        eng = engines["art"]
        stats = {}
        served = eng.serve(prompts, max_new_tokens=CLI_NEW_TOKENS, stats=stats)
        del engines

        print("  -- c: cli.generate, plain and --continuous", flush=True)
        argv = ["--artifact", art, "--max_new_tokens", str(CLI_NEW_TOKENS), "--max_seq_len",
                str(CLI_SEQ), "--prompt"] + [" ".join(map(str, p)) for p in prompts]
        for extra, want_toks, forwards in (([], toks["art"], CLI_NEW_TOKENS),
                                           (["--continuous"], served, stats["n_steps"])):
            dm.reset_counts()
            outs, lines, secs = run_cli(cli_generate.main, argv + extra)
            torch.cuda.synchronize()
            label = "cli generate" + (" --continuous" if extra else "")
            res["cli_generate" + ("_continuous" if extra else "")] = {
                "s": secs, "launches": check_counts(label, w4_only(forwards, 4))}
            printed = [f"prompt {p} -> {o}" for p, o in zip(prompts, want_toks)]
            if outs != want_toks or [ln for ln in lines if "->" in ln] != printed:
                fail(f"{label} gave other tokens than InferenceEngine called directly")
        res["generate_tokens"] = [o[:CLI_NEW_TOKENS] for o in toks["art"][:2]]

        print("  -- d: cli.eval_ppl (--w_bits 16 on the W4 artifact, fused)", flush=True)
        dm.reset_counts()
        out, _, secs = run_cli(cli_ppl.main, [
            "--artifact", art, "--w_bits", "16", "--datasets", "synthetic", "--ppl_seqlen",
            str(CLI_PPL_SEQLEN), "--sample_size", str(CLI_PPL_CHUNKS)])
        torch.cuda.synchronize()
        ppl_launches = check_counts("cli eval_ppl", w4_only(-(-CLI_PPL_CHUNKS // 4), 4))
        got = out["w16_int_group128"]["datasets"]["synthetic"]
        ev = SequentialPPLEvaluator(fuse_llama_projections(loaded), llama_forward, cfg,
                                    seqlen=CLI_PPL_SEQLEN)
        want = ev.calculate_ppl("synthetic", max_chunks=CLI_PPL_CHUNKS)
        if (got["perplexity"], got["num_tokens"], got["num_chunks"]) != want:
            fail(f"cli eval_ppl gave {got}, SequentialPPLEvaluator {want}")
        res["ppl"] = {"ppl": want[0], "tokens": want[1], "chunks": want[2], "s": secs,
                      "launches": ppl_launches}
        print(f"  PPL {want[0]:.4f} over {want[1]} tokens, equal to SequentialPPLEvaluator's "
              f"bit for bit", flush=True)

        print(f"  -- e: cli.eval_zeroshot ({', '.join(ZS_TASKS)}; local documents)", flush=True)
        n_pairs = sum(ZS_CHOICES[t] * len(docs[t]) for t in ZS_TASKS)
        if n_pairs != len(pairs):
            fail(f"{len(pairs)} zero-shot pairs, {n_pairs} expected")
        load_docs = zs_tasks._load
        zs_tasks._load = lambda path, name, split: docs[ZS_DATASETS[(path, name)]]
        try:
            dm.reset_counts()
            out, _, secs = run_cli(cli_zs.main, ["--artifact", art, "--w_bits", "16",
                                                 "--tasks", *ZS_TASKS, "--limit", str(ZS_LIMIT)])
            torch.cuda.synchronize()
        finally:
            zs_tasks._load = load_docs
        # unfused: q, k, v, o, gate, up, down on w4_matmul, batches of 8 pairs
        zs_launches = check_counts("cli eval_zeroshot", w4_only(-(-n_pairs // 8), 7))
        if list(out["w16"]) != list(ZS_TASKS) or not all(
                0.0 <= r["acc"] <= 1.0 for r in out["w16"].values()):
            fail(f"cli eval_zeroshot gave {out}")
        res["zeroshot"] = {"results": out["w16"], "pairs": n_pairs, "s": secs,
                           "launches": zs_launches}

        class Scored:
            """An EvalLM that keeps what evaluate() had it score."""

            def __init__(self, lm):
                self.lm = lm

            def loglikelihood(self, requests):
                self.pairs, self.scores = requests, self.lm.loglikelihood(requests)
                return self.scores

        lm = EvalLM(loaded, llama_forward, cfg)
        on_card = Scored(lm)
        if evaluate(on_card, tasks, encode, limit=ZS_LIMIT) != out["w16"] \
                or on_card.pairs != pairs:
            fail("cli eval_zeroshot's results differ from evaluate() through the kernels")
        t0 = time.perf_counter()
        on_cpu = Scored(EvalLM(params_from_numpy(loaded, "cpu"), llama_forward, cfg,
                               batch_size=ZS_CPU_BATCH))
        cpu_res = evaluate(on_cpu, tasks, encode, limit=ZS_LIMIT)
        cpu_s = time.perf_counter() - t0
        if on_cpu.pairs != pairs:
            fail("evaluate() on the CPU scored other pairs")
        card_ll, cpu_ll = on_card.scores, on_cpu.scores
        d_ll = max(abs(a[0] - b[0]) for a, b in zip(card_ll, cpu_ll))
        d_dense = sorted(abs(a[0] - b[0]) for a, b in zip(card_ll, dense_ll))
        if not all(math.isfinite(a[0]) for a in card_ll) or d_ll > ZS_LL_TOL:
            fail(f"loglikelihood through the kernels is {d_ll:.3e} from the CPU's plain path")
        # a document's decision may differ from the CPU's only where its lls
        # are within ZS_LL_TOL of a tie (or, for lambada's greedy flag, its
        # logits are); a task holds the CPU's results exactly unless one did
        flips, at = {}, 0
        for t in tasks:
            flips[t.name] = 0
            for d in docs[t.name][:ZS_LIMIT]:
                n = len(t.requests(d))
                a = t.process_results(d, card_ll[at:at + n])
                b = t.process_results(d, cpu_ll[at:at + n])
                flips[t.name] += any(a[k] != b[k] for k in a if k != "nll")
                at += n
        for name, want in cpu_res.items():
            for m, v in want.items():
                got = out["w16"][name][m]
                if m == "ppl":  # exp(mean nll): within the lls' limit in log
                    ok = abs(math.log(got / v)) <= ZS_LL_TOL
                elif not flips[name]:
                    ok = got == v
                else:  # a mean over documents moves 1/limit a flip
                    ok = m.endswith("_stderr") or abs(got - v) <= flips[name] / ZS_LIMIT + 1e-12
                if not ok:
                    fail(f"cli eval_zeroshot {name} {m} is {got}; evaluate() on the CPU's plain "
                         f"path gives {v} ({flips[name]} decisions differ)")
        print(f"  cli.eval_zeroshot == evaluate() through the kernels; vs evaluate() on the "
              f"CPU's plain path ({cpu_s:.1f} s, {len(pairs)} pairs): max |d ll| {d_ll:.3e} "
              f"(limit {ZS_LL_TOL}; the dense model is {d_dense[0]:.3e} to {d_dense[-1]:.3e} "
              f"away, median {d_dense[len(d_dense) // 2]:.3e}), decisions differing {flips}; "
              f"per-task results {'equal' if not any(flips.values()) else 'within the flips'}",
              flush=True)
        dm.reset_counts()
        outs = lm.greedy_until([(p[0], []) for p in pairs[:2]], max_gen=4)
        torch.cuda.synchronize()
        check_counts("greedy_until", w4_only(2 * 4, 7))
        if [len(o) for o in outs] != [4, 4] or any(not 0 <= t < cfg.vocab_size
                                                     for o in outs for t in o):
            fail(f"greedy_until gave {outs}")
        res["zeroshot"].update(cpu_results=cpu_res, ll_pairs_vs_cpu=len(pairs),
                               ll_max_abs_diff=d_ll, ll_tol=ZS_LL_TOL,
                               ll_abs_diff_dense=[d_dense[0], d_dense[-1]],
                               decisions_differing=flips, cpu_s=cpu_s, greedy_until=outs)

        print("  -- f: tokenshard: windows through get_loaders vs a numpy read", flush=True)
        shard = os.path.join(tmp, "corpus.tokens")
        tokens = np.random.default_rng(53).integers(0, cfg.vocab_size, 300_000, dtype=np.int32)
        tokens.tofile(shard)
        t0 = time.perf_counter()
        train, test = get_loaders("tokenshard:" + shard, nsamples=4, seed=5,
                                  seqlen=CLI_PPL_SEQLEN)
        shard_s = time.perf_counter() - t0
        disk = np.fromfile(shard, np.int32)
        draw = random.Random(5)
        offs = [draw.randint(0, len(disk) - CLI_PPL_SEQLEN - 1) for _ in range(4)]
        if [s.input_ids.tolist() for s in train] != \
                [[disk[o:o + CLI_PPL_SEQLEN].tolist()] for o in offs] \
                or test.input_ids.tolist() != [disk[:256 * CLI_PPL_SEQLEN].tolist()]:
            fail("tokenshard windows differ from a numpy read of the file")
        res["tokenshard_s"] = shard_s

        print("  -- g: analysis.stats.codeword_histogram, card vs CPU", flush=True)
        qt = loaded["layers"][0]["gate"]["w"]
        got = codeword_histogram(qt)
        want = codeword_histogram(qt.map_arrays(lambda a: a.cpu()))
        if any(a.dtype != b.dtype or not np.array_equal(a, b) for a, b in zip(got, want)) \
                or int(got[1].sum()) != qt.k * qt.qweight.shape[1]:
            fail("codeword_histogram on the card differs from the CPU's")
        print(f"  tokenshard windows equal ({shard_s:.3f} s); gate codeword histogram equal on "
              f"card and CPU ({len(got[0])} codes)", flush=True)
    finally:
        shutil.rmtree(tmp)
    del loaded
    torch.cuda.empty_cache()
    print(f"  CLI phase on {card}: write {res['write_s']:.1f} s, quantize+save "
          f"{res['quantize_cli_s']:.1f} s, load {res['load_s']:.1f} s, host RTN of two "
          f"linears {res['host_rtn']['host_s']:.2f} s", flush=True)
    return res


# ------------------------------------------------------- phases 10f-10i

def scan_expect(names, n_layers):
    """``expect`` of :func:`run_generate` on the LLaMA scan path: the flat
    counts, of which every linear but the lm_head on a stacked artifact."""
    return lambda f: (expected_launches(names, f, n_layers),
                      expected_launches(names, f, n_layers, stacked=True))


def compare_logits(torch, what, got, want, tol):
    """max|got - want| / max|want| <= ``tol``, else the phase fails."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{what}: logits of shape {tuple(got.shape)} (want {tuple(want.shape)}) or "
             "not finite")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"  logits {what}: max|d|/max|ref| = {rel:.3e} (tol {tol}), argmax agreement "
          f"{agree:.4f}, bit-equal {torch.equal(got, want)}", flush=True)
    if rel > tol:
        fail(f"logits {what}: rel err {rel:.3e} > {tol}")
    return {"rel_err": rel, "tol": tol, "argmax_agree": agree,
            "bit_equal": torch.equal(got, want)}


# ------------------------------------------------------------- phase 28

def graph_stats(eng):
    """The engine's CUDA graph counts (None where it holds no graphs: the
    eager side of an A/B, a rank mesh): keys captured, seconds spent
    capturing (each key's eager warm-up included), replays, and the GiB of
    the graphs' memory pool."""
    g = eng._graphs
    if g is None:
        return None
    return {"captures": g.captures, "capture_s": g.capture_s, "replays": g.replays,
            "pool_gib": g.pool_bytes() / 2**30}


def eager_side(eng):
    """The eager side of a graphs A/B: an engine that holds no graphs runs
    the module's eager chunk functions (``_generate_chunk``, ``_serve_chunk``,
    ``_serve_combo``), as it does on the CPU; the rest of its path is the
    graphed engine's."""
    eng._graphs = None
    return eng


def ab_decode_step(torch, sides, prompts, cfg, card, rounds=SERVE_RUNS):
    """``generate`` at batch 8 on two engines in turns (A B B A ...), after
    one untimed ``NEW_TOKENS`` run of each (the graphed side captures its
    chunks): per side a prefill-only run and a ``NEW_TOKENS`` run a round,
    exact launches, the same tokens on both sides and in every round; the
    decode wall ms a step, (median generate - median prefill) / 31."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    names = (dm.W4, dm.W4_PRENORM)
    want = {label: eng.generate(prompts, max_new_tokens=NEW_TOKENS) for label, eng in sides}
    if len({json.dumps(w) for w in want.values()}) != 1:
        fail("generate: the graphed engine's tokens differ from the eager bodies'")
    times = {label: ([], []) for label, _ in sides}
    for i in range(2 * rounds):
        label, eng = sides[(i + i // 2) % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dm.reset_counts()
        out = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check_counts(f"generate ({label})", expected_launches(names, NEW_TOKENS, cfg.num_layers))
        if out != want[label]:
            fail(f"generate ({label}): tokens differ between runs")
        times[label][0].append(t1 - t0)
        times[label][1].append(t2 - t1)
    res = {}
    for label, (pre, gen) in times.items():
        med_pre, med_gen = sorted(pre)[len(pre) // 2], sorted(gen)[len(gen) // 2]
        res[label] = {"prefill_s": med_pre, "generate_s": med_gen,
                      "decode_step_ms": (med_gen - med_pre) * 1e3 / (NEW_TOKENS - 1),
                      "generate_walls_s": gen, "prefill_walls_s": pre}
    (a, _), (b, _) = sides
    res[f"{a}_over_{b}"] = res[a]["decode_step_ms"] / res[b]["decode_step_ms"]
    print(f"  generate at batch {len(prompts)}, in turns: decode {a} "
          f"{res[a]['decode_step_ms']:.2f} ms/step, {b} {res[b]['decode_step_ms']:.2f} ms/step "
          f"(medians of {rounds}); tokens equal: yes; on {card}", flush=True)
    return res


def phase_graphs(torch, params, cfg, card):
    """CUDA graphs against the eager chunk bodies on phase 4's 32-layer W4
    model (fused params): two engines over the same params, one graphed
    (the engine's rule on a card), one running the module's eager chunk
    functions (:func:`eager_side`), in turns, ``SERVE_RUNS`` rounds each:

    * ``generate`` at batch 8: the decode wall ms a step;
    * ``serve`` of the serving traffic: tok/s, TTFT and TPOT p50/p95, the
      most device memory allocated in a run, then one profiled graphed
      serve (busy time, idle share);
    * the same serve A/B on the 32-layer scan path (the params stacked
      once, shared by both engines) and on 8 layers with an int8 paged KV
      cache.

    Every run has exact launches; the two sides' tokens must be equal;
    the graphed engines' timed runs capture nothing new (their keys came
    in the warm-up runs).  Per graphed engine: captures, seconds spent
    capturing, replays, the graph pool's GiB."""
    import dataclasses

    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.common import stack_model_layers
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward, llama_forward_scan
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    names = (dm.W4, dm.W4_PRENORM)
    res = {"card": card}

    def graphed_and_eager(make):
        graphed, eager = make(), eager_side(make())
        if graphed._graphs is None:
            fail("the engine on the card holds no CUDA graphs")
        return graphed, eager

    def captured_nothing(what, eng, before):
        if eng._graphs.captures != before:
            fail(f"{what}: the graphed engine captured {eng._graphs.captures - before} keys "
                 "in its timed runs (the warm-up run had them)")

    print("  -- generate, graphed and eager in turns", flush=True)
    ecfg = EngineConfig(fuse_projections=True,
                        kv=KVCacheConfig(max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8))
    graphed, eager = graphed_and_eager(lambda: InferenceEngine(
        params, cfg, llama_forward, family="llama", engine_cfg=ecfg, dtype=torch.bfloat16,
        device=params["embed"].device))
    gen = torch.Generator(device=params["embed"].device).manual_seed(28)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=gen.device).tolist() for n in PROMPT_LENS]
    res["generate"] = ab_decode_step(torch, [("graphed", graphed), ("eager", eager)],
                                     prompts, cfg, card)
    g = graph_stats(graphed)
    # one key a chunk length (16 and 15 steps), all from the warm-up run
    lengths = {min(ecfg.decode_chunk, NEW_TOKENS - 1 - i)
               for i in range(0, NEW_TOKENS - 1, ecfg.decode_chunk)}
    if g["captures"] != len(lengths):
        fail(f"generate: {g['captures']} captures, not {len(lengths)}")
    res["generate"]["graphs"] = g
    del graphed, eager

    def serve_ab(label, params_, cfg_, kv=None, forward=None, profile=False):
        print(f"  -- serve ({label}), graphed and eager in turns", flush=True)
        scan = forward is llama_forward_scan
        graphed, eager = graphed_and_eager(
            lambda: serve_engine(torch, params_, cfg_, kv=kv, forward=forward)[0])
        reqs = serve_requests(cfg_.vocab_size)

        def expect(st):
            want, want_stacked = (expected_launches(names, st["n_steps"], cfg_.num_layers,
                                                    stacked=s) for s in (False, True))
            return want, (want_stacked if scan else None)

        for eng in (graphed, eager):  # untimed; the graphed one captures its keys
            eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK)
        before = graphed._graphs.captures
        ab = ab_serve(torch, [("graphed", graphed, expect), ("eager", eager, expect)], reqs,
                      card)
        captured_nothing(f"serve ({label})", graphed, before)
        g = ab["graphed"]["graphs"]
        print(f"  serve ({label}): tokens equal: yes; {g['captures']} captures in "
              f"{g['capture_s']:.2f} s, {g['replays']} replays, graph pool "
              f"{g['pool_gib']:.3f} GiB; peak allocated graphed "
              f"{ab['graphed']['peak_gib']:.2f} GiB, eager {ab['eager']['peak_gib']:.2f} GiB",
              flush=True)
        if profile:
            ab["graphed"]["profile"] = profile_serve(torch, graphed, reqs)
        return ab

    res["serve"] = serve_ab("32 layers, 16-bit KV", params, cfg, profile=True)
    stacked = stack_model_layers(params)
    res["serve_scan"] = serve_ab("32 layers, scan, 16-bit KV", stacked, cfg,
                                 forward=llama_forward_scan)
    del stacked
    torch.cuda.empty_cache()
    cfg_cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    res["serve_paged_kv8"] = serve_ab(
        f"{CUT_LAYERS} layers, int8 paged KV", {**params, "layers": params["layers"][:CUT_LAYERS]},
        cfg_cut, kv=dict(kv_bits=8, paged=True, page_size=KV_PAGE))
    torch.cuda.empty_cache()
    return res


def phase_scan_w4(torch, params, cfg, card, flat_gen, flat_serve):
    """The W4 main path on the scan path: two-layer logits, scan vs flat on
    the card; one untimed flat serve with an int8 cache; then the flat
    model's fused params stacked (a copy: the flat ones stay for the A/B),
    ``generate`` through ``llama_forward_scan``, ``serve`` with the 16-bit
    cache, scan and flat in turns (:func:`ab_serve`), then a profiled scan
    serve, and the int8 scan serve (median of 3).  The scan tokens must
    equal the flat path's (phase 4's; the int8 flat serve's) and its every
    linear but the lm_head must launch the stacked kernels."""
    import dataclasses

    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.common import stack_model_layers
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward, llama_forward_scan
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    names = (dm.W4, dm.W4_PRENORM)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    two = {**params, "layers": params["layers"][:2]}
    gen = torch.Generator(device=params["embed"].device).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=gen.device)
    with torch.inference_mode():
        flat, _ = llama_forward(two, tokens, cfg2)
        scan, _ = llama_forward_scan(stack_model_layers(two), tokens, cfg2)
    logits = compare_logits(torch, "bfloat16 two layers, scan vs flat", scan, flat,
                            LOGITS_TOL["bfloat16"])
    del two, flat, scan
    kv8_tokens = serve_once(torch, params, cfg, dict(kv_bits=8))["tokens"]

    t0 = time.perf_counter()
    stacked = stack_model_layers(params)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    print(f"  stacked {cfg.num_layers} layers in {stack_s:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    eng = InferenceEngine(stacked, cfg, llama_forward_scan, family="llama",
                          engine_cfg=EngineConfig(fuse_projections=True, kv=KVCacheConfig(
                              max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8)),
                          dtype=torch.bfloat16, device=params["embed"].device)
    gen_res = run_generate(torch, eng, flat_gen["prompts"], cfg, card,
                           scan_expect(names, cfg.num_layers), "scan generate")
    del eng
    if gen_res["tokens"] != flat_gen["tokens"]:
        fail("scan generate gave other tokens than the flat path's (phase 4)")
    gen_res["stack_s"] = stack_s

    print("  -- serve, 16-bit KV cache: scan and flat in turns", flush=True)
    scan_eng, reqs = serve_engine(torch, stacked, cfg, forward=llama_forward_scan)
    flat_eng, _ = serve_engine(torch, params, cfg)
    n_layers = cfg.num_layers
    ab = ab_serve(torch, [
        ("scan", scan_eng, lambda st: scan_expect(names, n_layers)(st["n_steps"])),
        ("flat", flat_eng, lambda st: (expected_launches(names, st["n_steps"], n_layers),
                                       None))], reqs, card)
    if ab["scan"]["tokens"] != flat_serve["tokens"]:
        fail("scan serve (16-bit KV) gave other tokens than the flat path's (phase 4)")
    ab["scan"]["profile"] = profile_serve(torch, scan_eng, reqs)
    del scan_eng, flat_eng
    print("  -- scan serve, int8 KV cache", flush=True)
    kv8 = phase_serve(torch, stacked, cfg, names, SERVE_RUNS, card, kv=dict(kv_bits=8),
                      warmup=False, forward=llama_forward_scan, profile=False)
    if kv8["tokens"] != kv8_tokens:
        fail("scan serve (int8 KV) gave other tokens than the flat path's")
    print("  scan generate and serves: the flat path's tokens", flush=True)
    del stacked
    torch.cuda.empty_cache()
    return {"logits_scan_vs_flat": logits, "generate": gen_res, "serve_ab": ab,
            "serve_kv8": kv8}


def phase_scan_w8(torch, params, cfg, card, flat_serve, flat_serve_a):
    """The W8 model of phase 7 stacked in place, ``serve`` of phase 7's
    traffic and one serve with A16 waves and A8 decode (phase 11) through
    ``llama_forward_scan``: a warm-up run (the engine's graph captures) and
    one timed run each, the flat serves' tokens, every linear but the
    lm_head on the stacked kernels."""
    from iron_weight_only_quant_tpu_torch.models.common import stack_model_layers
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward_scan
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    stacked = stack_model_layers(params, consume=True)
    serve = phase_serve(torch, stacked, cfg, (dm.W8, dm.W8_PRENORM), 1, card,
                        forward=llama_forward_scan, profile=False)
    print("  -- scan serve, A16 waves, A8 decode", flush=True)
    serve_a = phase_serve(torch, stacked, cfg, (dm.W8A16, dm.W8A8), 1, card, abits=(16, 8),
                          forward=llama_forward_scan, profile=False)
    for got, want, what in ((serve, flat_serve, "serve"), (serve_a, flat_serve_a, "A-serve")):
        if got["tokens"] != want["tokens"]:
            fail(f"W8 scan {what} gave other tokens than the flat path's")
    print("  W8 scan serves: the flat serves' tokens", flush=True)
    del stacked
    torch.cuda.empty_cache()
    return serve, serve_a


def build_quantized_family(torch, family, cfg, spec, device, seed):
    """A random OPT or BLOOM model built on the card, every linear a
    ``spec`` artifact with N padded to 512 (its bias bf16), LayerNorms of
    ones and zeros, a bf16 embedding (the tied lm_head)."""
    from iron_weight_only_quant_tpu_torch.models.opt import POS_OFFSET
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    gen = torch.Generator(device=device).manual_seed(seed)
    h = cfg.hidden_size
    ffn = cfg.ffn_dim if family == "opt" else 4 * h
    bf16 = torch.bfloat16

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    def qlin(kin, kout):
        return {"w": quantize_tensor(normal(kin, kout) * kin**-0.5, spec, pad_n_to=512),
                "b": (normal(kout) * 0.02).to(bf16)}

    def ln():
        return {"w": torch.ones((h,), dtype=bf16, device=device),
                "b": torch.zeros((h,), dtype=bf16, device=device)}

    norm2 = "final_norm" if family == "opt" else "post_norm"
    layers = [{"attn_norm": ln(), "q": qlin(h, h), "k": qlin(h, h), "v": qlin(h, h),
               "o": qlin(h, h), norm2: ln(), "fc1": qlin(h, ffn), "fc2": qlin(ffn, h)}
              for _ in range(cfg.num_layers)]
    params = {"embed": (normal(cfg.vocab_size, h) * 0.02).to(bf16), "layers": layers,
              "final_norm": ln()}
    if family == "opt":
        params["embed_pos"] = (normal(cfg.max_position_embeddings + POS_OFFSET, h)
                               * 0.02).to(bf16)
    else:
        params["embed_norm"] = ln()
    return params, gen


def cast_dense(tree, dtype):
    """``tree`` with its floating dense tensors cast to ``dtype`` (packed
    artifacts as they are)."""
    import torch

    if isinstance(tree, dict):
        return {k: cast_dense(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_dense(v, dtype) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def phase_family(torch, device, family, cfg, spec, card, seed):
    """An 8-layer OPT or BLOOM W4 model at published widths: two-layer
    logits, kernels on the card vs the plain path on the CPU (float32 and
    bfloat16), and scan vs flat on the card; the params stacked (a copy),
    ``generate`` flat and scan, and ``serve`` (one untimed run, then scan
    and flat in turns, :func:`ab_serve`), with the flat path's tokens.
    Every linear (q, k, v, o, fc1, fc2; no fusion, no pre-norm) takes
    ``w4_matmul``: 6 launches a layer and forward, all stacked on the scan
    path; the tied lm_head is a plain matmul."""
    import dataclasses

    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
    from iron_weight_only_quant_tpu_torch.models import bloom, opt
    from iron_weight_only_quant_tpu_torch.models.common import stack_model_layers
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    mod = opt if family == "opt" else bloom
    fwd, fwd_scan = getattr(mod, f"{family}_forward"), getattr(mod, f"{family}_forward_scan")
    t0 = time.perf_counter()
    params, gen = build_quantized_family(torch, family, cfg, spec, device, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"  built {cfg.num_layers}-layer {family} W4 model in {build_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=device)
    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        two = cast_dense({**params, "layers": params["layers"][:2]}, dtype)
        with torch.inference_mode():
            lg, _ = fwd(two, tokens, cfg2)
            lg_ref, _ = fwd(params_from_numpy(two, "cpu"), tokens.cpu(), cfg2)
            logits[name] = compare_logits(torch, f"{family} {name} two layers, kernels vs "
                                          "plain", lg, lg_ref, LOGITS_TOL[name])
            if dtype == torch.bfloat16:
                lg_scan, _ = fwd_scan(stack_model_layers(two), tokens, cfg2)
                logits["scan_vs_flat"] = compare_logits(
                    torch, f"{family} {name} two layers, scan vs flat", lg_scan, lg,
                    LOGITS_TOL[name])
        del two
    torch.cuda.empty_cache()

    def want(forwards, stacked):
        w = {name: 0 for name in dm.LAUNCHES}
        w[dm.W4] = forwards * 6 * cfg.num_layers
        return w, (w if stacked else None)

    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=device).tolist() for n in PROMPT_LENS]
    ecfg = EngineConfig(kv=KVCacheConfig(max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8))
    res = {"build_s": build_s, "logits": logits, "card": card}
    stacked = stack_model_layers(params)  # a copy: the flat params stay for the A/B
    for path, forward, p in (("flat", fwd, params), ("scan", fwd_scan, stacked)):
        eng = InferenceEngine(p, cfg, forward, engine_cfg=ecfg, dtype=torch.bfloat16,
                              device=device)
        res[f"generate_{path}"] = run_generate(
            torch, eng, prompts, cfg, card, lambda f: want(f, path == "scan"),
            f"{path} generate")
        del eng
    if res["generate_scan"]["tokens"] != res["generate_flat"]["tokens"]:
        fail(f"{family}: the scan generate gave other tokens than the flat one")
    print(f"  -- {family} serve: scan and flat in turns", flush=True)
    scan_eng, reqs = serve_engine(torch, stacked, cfg, forward=fwd_scan, family=None)
    flat_eng, _ = serve_engine(torch, params, cfg, forward=fwd, family=None)
    res["serve_ab"] = ab_serve(torch, [
        ("scan", scan_eng, lambda st: want(st["n_steps"], True)),
        ("flat", flat_eng, lambda st: want(st["n_steps"], False))], reqs, card, warmup=True)
    print(f"  {family}: scan generate and serve give the flat path's tokens", flush=True)
    del params, stacked, scan_eng, flat_eng
    torch.cuda.empty_cache()
    return res


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
    """The slab kernel's row pass against the plain ``quantize_activations``
    on the card, at the main path's K (4096, 11008 padded to 11264) and row
    counts, bf16 and f32 x, with an all-zero row, one plane (A8) and two
    (A16), in the byte (one slab of K rows), nib4 (two of K/2) and s21
    (eight of K/8) layouts, groups of 128: int8 planes, f32 row scales and
    group sums bit-equal to the plain version's and its
    ``activation_group_sums``.  With the norm (``pre_norm``) the pass's sum
    of squares is reduced in another order than torch's, so its group sums
    are held to its own planes, and its codes and row scales to within one
    code and one step of x's type (bf16: 2^-8 relative; f32: 1e-6) of the
    plain version on the normalized x."""
    from iron_weight_only_quant_tpu_torch.ops import qmatmul
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    checked = 0
    for bits in dm.ACTIVATION_BITS:
        for k, k_stored in ((4096, 4096), (11008, 11264)):
            for m in (DECODE_M, 512):
                for dtype in (torch.bfloat16, torch.float32):
                    x = (torch.randn((m, k), generator=gen, device=device) * 3).to(dtype)
                    x[1] = 0
                    want, want_sx = dm.quantize_activations(x, bits)
                    padded = torch.nn.functional.pad(want, (0, k_stored - k))
                    want_sums = dm.activation_group_sums(padded, 128)
                    for slabs in (1, 2, 8):
                        what = f"row pass A{bits} S={slabs} K={k} M={m} {dtype}"
                        planes, sx, sums = dm.quantize_activations_slab_kernel(
                            x, slabs, k_stored // slabs, 128, bits=bits)
                        torch.cuda.synchronize()
                        if not (torch.equal(planes[..., :k], want) and torch.equal(sx, want_sx)
                                and not planes[..., k:].any()):
                            fail(f"{what}: codes or row scales differ from "
                                 "quantize_activations")
                        if not torch.equal(sums.long(), want_sums):
                            fail(f"{what}: group sums differ from activation_group_sums")
                        checked += 1
                    if m != DECODE_M:
                        continue
                    xn = qmatmul._rms_nogamma(x, 1e-5)
                    want, want_sx = dm.quantize_activations(xn, bits)
                    for slabs in (1, 2, 8):
                        what = f"row pass with the norm A{bits} S={slabs} K={k} {dtype}"
                        planes, sx, sums = dm.quantize_activations_slab_kernel(
                            x, slabs, k_stored // slabs, 128, 1e-5, bits=bits)
                        torch.cuda.synchronize()
                        code_gap = (planes[..., :k].int() - want.int()).abs().max().item()
                        sx_gap = ((sx - want_sx).abs() / want_sx).max().item()
                        sx_tol = 2.0**-8 if dtype == torch.bfloat16 else 1e-6
                        if code_gap > 1 or sx_gap > sx_tol or planes[..., k:].any():
                            fail(f"{what}: codes {code_gap} or row scales {sx_gap:.2e} off "
                                 "the plain version's")
                        if not torch.equal(sums.long(), dm.activation_group_sums(planes, 128)):
                            fail(f"{what}: group sums differ from those of its planes")
                        checked += 1
    print(f"  row pass: int8 planes, row scales and group sums bit-equal to the plain "
          f"version in {checked} calls (S = 1, 2, 8; one plane and two; the normed calls "
          "within one code)", flush=True)
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
    ``pre_norm`` as the main path calls them (x normalized in the row pass
    of ``w3_matmul``'s bf16 route and of the A-kernels)."""
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


def slab_kernel_report(name):
    """The static SASS counts (``build.sass``, counted by the probe's
    ``sass_counts``) and the ``-Xptxas -v`` registers, spills and shared
    memory of the slab kernels (``csrc/wa_slab_mma.cuh``) of a library: the
    A16 slab kernels and the A8 ones (one plane: "A8"), or the bf16 route of
    ``lut4_matmul``, ``lut6_matmul``, ``lut8_matmul``, ``w3_matmul``,
    ``w4_matmul``, ``w4_matmul_prenorm``, ``w8_matmul`` and
    ``w8_matmul_prenorm`` (the prenorm forms' epilogue norm: "norm"), or the
    two tensor-core routes of ``w4_inner_matmul`` (TF32 counts as HMMA); fails
    unless the product kernels run their products on
    the tensor cores: the int8 ones (IMMA) with no ``__dp4a`` (IDP), the
    bf16 ones (HMMA or HGMMA).  FFMA is counted beside them (a W4 product
    kernel keeps it for its group epilogue only: no FFMA main loop)."""
    import re

    from iron_weight_only_quant_tpu_torch.ops.kernels import build as kbuild
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.probes.probe_w4_inner import sass_counts

    layouts = {str(v): k for k, v in dm.SLAB_LAYOUT_IDS.items()}  # slab_tile.cuh Layout

    def key(fn):  # wa_slab_mma_kernel<LAYOUT, NT, VEC16, BZ, NORM, PLANES>, the row passes
        m = re.search(r"wa_slab_mma_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E"
                      r"(?:Lb(\d)E)?(?:Li(\d)E)?", fn)
        if m:
            return (f"product {layouts.get(m.group(1), m.group(1))} NT={m.group(2)}"
                    f"{'' if m.group(3) == '1' else ' 4-byte copies'}"
                    f"{' zeros' if m.group(4) == '1' else ''}"
                    f"{' norm' if m.group(5) == '1' else ''}"
                    f"{' A8' if m.group(6) == '1' else ''}")
        if "rows_bf16_slab" in fn:
            return "bf16 row pass"
        return "row pass" if "quantize_rows_slab" in fn and name in dm.SLAB_MMA else None

    counts = sass_counts(kbuild.sass(name), ops=("IMMA", "IGMMA", "IDP", "HMMA", "HGMMA", "LDS",
                                                  "LDGSTS", "PRMT", "LOP3", "HFMA2", "FFMA"),
                         key=key)
    for k, c in sorted(counts.items()):
        print(f"  sass {name} {k}: " + " ".join(f"{op}={v}" for op, v in c.items() if v),
              flush=True)
        if k.startswith("product") and "bf16" in k and c["HMMA"] + c["HGMMA"] == 0:
            fail(f"{name} {k}: the bf16 products are not on the tensor cores: {c}")
        if k.startswith("product") and "bf16" not in k and (
                c["IMMA"] + c["IGMMA"] == 0 or c["IDP"] > 0):
            fail(f"{name} {k}: the products are not on the tensor cores: {c}")
    if not any(k.startswith("product") for k in counts):
        fail(f"{name}: no wa_slab_mma_kernel in its SASS")
    log = kbuild.build_log(name).splitlines()
    for i, line in enumerate(log):
        fn = re.search(r"entry function '(\S+)'", line)
        if fn and key(fn.group(1)):
            used = next((x.split(":", 1)[1].strip() for x in log[i + 1:i + 4] if "Used" in x), "")
            spill = next((x.strip() for x in log[i + 1:i + 4] if "spill" in x), "")
            print(f"  ptxas {name} {key(fn.group(1))}: {used}; {spill}", flush=True)
    return counts


def check_slab_ragged(torch, device, specs, seed, abits=16):
    """The slab kernel (A16, or with ``abits`` 8 its one-plane mode) on
    artifacts whose groups or slabs are not a multiple of its 32-row window
    (``specs``: label -> (spec, K)), N = 4096, at M = 8 and 64, bf16 and f32
    x, against the plain version."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for label, (spec, k) in specs.items():
        qt = make_artifact(torch, gen, spec, k, (4096,), device)[0]
        kname = dm.kernel_name(qt, None, abits)
        if kname not in dm.SLAB_MMA:
            fail(f"{label}: the artifact does not take a slab kernel ({kname})")
        for m in (DECODE_M, 64):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), generator=gen, device=device).to(dtype)
                check_call(torch, f"{kname}:{label}:M={m}", qt, x, *a_runner(None, abits))
        del qt
    torch.cuda.empty_cache()


def check_bf16_mma_ragged(torch, device, specs, seed):
    """The bf16 route of ``lut4_matmul``, ``lut6_matmul``, ``lut8_matmul``,
    ``w3_matmul``, ``w4_matmul`` or ``w8_matmul`` (the bf16 family of
    ``csrc/wa_slab_mma.cuh``) on artifacts whose groups or slabs are not a
    multiple of its 32-row window (``specs``: label -> (spec, K)), N = 4096,
    at M = 8 and 64, with and without ``pre_norm`` (in its row pass; W4 and
    W8: ``w4_matmul_prenorm`` and ``w8_matmul_prenorm``, in their
    epilogue), and on an x 2 bytes off a 16-byte boundary (which the row
    pass copies; W4 and W8 also with the pre-norm, whose row factor the
    epilogue applies to the raw copy), against the plain version."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for label, (spec, k) in specs.items():
        qt = make_artifact(torch, gen, spec, k, (4096,), device)[0]
        kname = dm.kernel_name(qt)
        if kname not in dm.BF16_MMA or not dm.bf16_mma_route(qt, torch.bfloat16):
            fail(f"{label}: the artifact does not take the bf16 route ({kname})")
        for m in (DECODE_M, 64):
            for pre in (None, 1e-5):
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                check_call(torch, f"{dm.kernel_name(qt, pre)}:{label}:M={m}"
                           f"{':pre_norm' if pre else ''}", qt, x, *a_runner(pre, None))
        x = torch.empty((DECODE_M * k + 1,), dtype=torch.bfloat16, device=device)[1:]
        x = x.view(DECODE_M, k)
        x.copy_(torch.randn((DECODE_M, k), generator=gen, device=device))
        if not dm.x_needs_copy(x, k // dm.SLAB_TILES[dm.BF16_MMA[kname]][0]):
            fail(f"{label}: the unaligned x is read in place")
        check_call(torch, f"{kname}:{label}:unaligned_x", qt, x, *a_runner(None, None))
        if dm.prenorm_supported(qt):
            pname = dm.kernel_name(qt, 1e-5)
            if not dm.bf16_mma_route(qt, torch.bfloat16, 1e-5):
                fail(f"{label}: {pname} is not on the bf16 route")
            check_call(torch, f"{pname}:{label}:unaligned_x", qt, x, *a_runner(1e-5, None))
        del qt
    torch.cuda.empty_cache()


def check_device_kernels(label, fn, want, first=(), row_pass=False):
    """The device kernels one call of ``fn`` runs, read by ``torch.profiler``
    (``device_kernel_names``, up to three traces): exactly ``want`` of them,
    the first named by one of ``first`` where given, and a row pass
    (``rows_bf16``) among them exactly when ``row_pass``.  Fails where no
    trace recorded a device event: an empty trace checks nothing."""
    from iron_weight_only_quant_tpu_torch.utils.profiling import device_kernel_names

    names = device_kernel_names(fn, want)
    print(f"  {label}: device kernels {names}", flush=True)
    if not names:
        fail(f"{label}: no device event in three profiler traces")
    if len(names) != want or (first and not any(p in names[0] for p in first)) \
            or ("rows_bf16" in " ".join(names)) != row_pass:
        fail(f"{label}: {len(names)} device kernels, want {want} (the first "
             f"{first[0] if first else 'any'}, row pass {row_pass}): {names}")


# (label, M, K, N, pre_norm) of the calls check_route_kernels counts: W4's
# and W8's prenorm kernels with one split (the row factor in the product
# kernel's epilogue) and with a K-split (in the reduce), and w4_matmul with
# one split; w8_matmul with one split and with a K-split; lut8_matmul with
# one split, and with the pre-norm (its row pass) with one split and a
# K-split
W4_ROUTE_CALLS = (("prenorm_one_split", PREFILL_M, 4096, 4096, 1e-5),
                  ("prenorm_k_split", DECODE_M, 4096, 4096, 1e-5),
                  ("flat_one_split", DECODE_M, 4096, 32000, None))
W8_ROUTE_CALLS = (("flat_one_split", PREFILL_M, 4096, 12288, None),
                  ("flat_k_split", DECODE_M, 4096, 4096, None),
                  ("prenorm_one_split", PREFILL_M, 4096, 12288, 1e-5),
                  ("prenorm_k_split", DECODE_M, 4096, 12288, 1e-5))
LUT8_ROUTE_CALLS = (("flat_one_split", DECODE_M, 4096, 32000, None),
                    ("prenorm_one_split", PREFILL_M, 4096, 12288, 1e-5),
                    ("prenorm_k_split", DECODE_M, 4096, 12288, 1e-5))


def check_route_kernels(torch, device, spec, seed, calls):
    """The bf16 route of a kernel where the output is formed (``calls``:
    label, M, K, N, pre_norm; a label ends in ``one_split`` where the plan
    has one split), against the plain version; each call runs one product
    kernel with one split and a reduce besides it with a K-split, and a row
    pass before it only where it normalizes a copy of x (a pre-norm on a
    layout without the epilogue norm: x aligned, never copied otherwise).
    The W4 and W8 prenorm forms run none: their row factor is in their
    epilogue."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    for label, m, k, n, pre in calls:
        qt = make_artifact(torch, gen, spec, k, (n,), device)[0]
        kname = dm.kernel_name(qt, pre)
        layout = dm.BF16_MMA.get(kname)
        routed = dm.bf16_mma_route(qt, torch.bfloat16, pre)
        if layout is None or not routed:
            fail(f"{kname}:{label}: not on the bf16 route")
        kb = qt.k_stored // dm.SLAB_TILES[layout][0]
        splits = dm.plan_slab_splits(m, qt.qweight.shape[1], kb, layout, sm)[1]
        if (splits == 1) != label.endswith("one_split"):
            fail(f"{kname}:{label}: {splits} splits")
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        check_call(torch, f"{kname}:{label}:M={m}", qt, x, *a_runner(pre, None))
        row_pass = pre is not None and kname not in (dm.W4_PRENORM, dm.W8_PRENORM)
        check_device_kernels(f"{kname}:{label}: {splits} split(s)",
                             lambda: dm.fused_quantized_matmul(x, qt, pre_norm=pre),
                             (1 if splits == 1 else 2) + row_pass, row_pass=row_pass)
        del qt
    torch.cuda.empty_cache()


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
    """Card-built int4/int8/fp4/fp8/bfp artifacts byte-equal to CPU-built ones."""
    from iron_weight_only_quant_tpu_torch.config import QuantSpec, fp_spec
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    specs = {"fp4_e2m1_g128_asym": fp_spec("fp4", 2, 1, group_size=128, symmetric=False),
             "fp8_e4m3_g128_sym": fp_spec("fp8", 4, 3, group_size=128),
             "bfp4_g128": QuantSpec(fmt="bfp", bits=4, group_size=128),
             "bfp8_g128": QuantSpec(fmt="bfp", bits=8, group_size=128),
             "int4_g128_asym": QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False),
             "int8_g128_sym": QuantSpec(fmt="int", bits=8, group_size=128, symmetric=True)}
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


# (label, M, K, N, x dtype) of the calls check_inner_kernels counts for each
# mode: the tensor-core route with one split (the lm_head at decode, o at
# prefill) and with a K-split (o at decode), and an f32 x on the CUDA-core
# kernel, whose K-split reduce always runs
W4_INNER_KERNEL_CALLS = (("route_one_split", DECODE_M, 4096, 32000, "bfloat16"),
                         ("route_k_split", DECODE_M, 4096, 4096, "bfloat16"),
                         ("route_one_split", PREFILL_M, 4096, 4096, "bfloat16"),
                         ("cuda_core_f32x", DECODE_M, 4096, 4096, "float32"))
INNER_K, INNER_N = 4096, 4096  # the o shape: the per-channel artifact, the accuracy check
INNER_ACC_RATIO = 1.5  # magic's maxrel at most this times base's
# magic's share of outputs off the bf16-rounded oracle at most base's plus
# this, over the accuracy check's four cases together (2.16M outputs): the
# maxrel is the output's own bf16 rounding and cannot see the fold's lost
# bits, this share can (each extra bit of f32 sum lost about doubles it)
INNER_OFF_SLACK = 5e-5


def inner_once(torch, label, qt, x, mode):
    """One call of ``w4_inner_matmul`` in ``mode``: exactly one launch under
    the mode's name, no plain call, no route call; its output."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import w4_inner_matmul

    name = dm.W4_INNER_MAGIC if mode == "magic" else dm.W4_INNER_F32
    dm.reset_counts()
    y = w4_inner_matmul(x, qt, mode)
    torch.cuda.synchronize()
    if dm.LAUNCHES != {**{k: 0 for k in dm.LAUNCHES}, name: 1} or any(
            dm.PLAIN_CALLS.values()) or any(dm.ROUTE_CALLS.values()):
        fail(f"{name}:{label}: launches {dict(dm.LAUNCHES)}, plain {dict(dm.PLAIN_CALLS)}")
    return y


def check_inner_kernels(torch, device, spec, seed):
    """Per mode and call of ``W4_INNER_KERNEL_CALLS``: the device kernels one
    ``w4_inner_matmul`` call runs, read by ``torch.profiler``: on the route
    its mode's product kernel (``wa_slab_mma_kernel`` of its layout), alone
    with one split, then the reduce with a K-split; for f32 x the CUDA-core
    kernel and its reduce.  Run in phase 2, beside ``check_route_kernels``:
    in phase 24, after the profiled serves, every such trace came back
    empty on the H100."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import MODES, w4_inner_matmul

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    for label, m, k, n, dtype in W4_INNER_KERNEL_CALLS:
        qt = make_artifact(torch, gen, spec, k, (n,), device)[0]
        x = torch.randn((m, k), generator=gen, device=device).to(getattr(torch, dtype))
        route = dtype == "bfloat16"
        if dm.bf16_mma_route(qt, x.dtype) != route:
            fail(f"w4_inner:{label}: route rule {not route}")
        for mode in MODES:
            name = dm.W4_INNER_MAGIC if mode == "magic" else dm.W4_INNER_F32
            if route:
                layout = dm.W4_INNER_MMA[name]
                splits = dm.plan_slab_splits(m, qt.qweight.shape[1], k // 2, layout, sm)[1]
                if (splits == 1) != label.endswith("one_split"):
                    fail(f"{name}:{label}: {splits} splits")
                lid = dm.SLAB_LAYOUT_IDS[layout]
                product = (f"wa_slab_mma_kernel<{lid},", f"wa_slab_mma_kernelILi{lid}E")
                want = 1 if splits == 1 else 2
            else:
                product, want = ("w4_inner_partial_kernel",), 2
            inner_once(torch, label, qt, x, mode)
            check_device_kernels(f"{name}:{label}:M={m}",
                                 lambda: w4_inner_matmul(x, qt, mode), want, product)
        del qt
    torch.cuda.empty_cache()


def inner_accuracy(torch, device, gen):
    """The accuracy check of folding the W4 bf16 route's 128 into the zero
    point (the magic decode): x of one sign with a mean far above its
    spread (``4 + 0.1 N(0, 1)``, bf16), so that each group's sum of x is
    large, against one-sign weights whose zero points are all 0 and all 15;
    base (``w4_matmul``'s bf16 route), magic and f32, each against the f32
    oracle (``dequantize_weight`` to f32, an f32 matmul with TF32 off), at
    M = 8 and 256: each maxrel at most ``REL_TOL_BF16`` and magic's within
    ``INNER_ACC_RATIO`` of base's; over the four cases together, magic's
    share of outputs that are not the oracle rounded to bf16 at most base's
    plus ``INNER_OFF_SLACK``."""
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import w4_inner_matmul
    from iron_weight_only_quant_tpu_torch.probes import probe_w4_inner as probe
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    k, n = INNER_K, INNER_N
    out = []
    off_count = {"base": 0, "magic": 0, "f32": 0}
    for zero, sign in ((0, 1.0), (15, -1.0)):
        w = torch.randn((k, n), generator=gen, device=device).abs() * (0.02 * sign)
        qt = quantize_tensor(w, probe.SPEC)
        if not bool((qt.zeros == zero).all()):
            fail(f"accuracy check: the artifact's zero points are not all {zero}")
        w_ref = dequantize_weight(qt, torch.float32)
        for m in (DECODE_M, PREFILL_M):
            x = (4.0 + 0.1 * torch.randn((m, k), generator=gen, device=device)).to(torch.bfloat16)
            ref = x.float() @ w_ref
            ys = {"base": dm.fused_quantized_matmul(x, qt),
                  "magic": w4_inner_matmul(x, qt, "magic"),
                  "f32": w4_inner_matmul(x, qt, "f32")}
            torch.cuda.synchronize()
            rel = {tag: ((y.float() - ref).abs().max() / ref.abs().max()).item()
                   for tag, y in ys.items()}
            # below the output's rounding: the outputs that are not the
            # oracle rounded to bf16
            ref_bf = ref.to(torch.bfloat16)
            off = {tag: int((y != ref_bf).sum().item()) for tag, y in ys.items()}
            for tag in off:
                off_count[tag] += off[tag]
            rec = {"zero": zero, "M": m, "K": k, "N": n, "maxrel": rel,
                   "magic_over_base": rel["magic"] / max(rel["base"], 1e-30),
                   "share_not_rounded_oracle": {t: c / (m * n) for t, c in off.items()}}
            print("  accuracy " + json.dumps(rec), flush=True)
            if max(rel.values()) > REL_TOL_BF16 or \
                    rel["magic"] > INNER_ACC_RATIO * rel["base"]:
                fail(f"accuracy check, zero {zero}, M={m}: {rel}")
            out.append(rec)
        del qt, w, w_ref
    torch.cuda.empty_cache()
    total = 2 * (DECODE_M + PREFILL_M) * n
    share = {tag: c / total for tag, c in off_count.items()}
    print("  accuracy, four cases: share of outputs off the bf16-rounded oracle "
          + json.dumps(share) + f"; magic at most base + {INNER_OFF_SLACK}", flush=True)
    if share["magic"] > share["base"] + INNER_OFF_SLACK:
        fail(f"accuracy check: magic's share off the rounded oracle {share}")
    out.append({"four_cases_share_not_rounded_oracle": share})
    return out


def phase_w4_inner(torch, device, spec):
    """Both modes of ``w4_inner_matmul`` against their plain versions at the
    main-path shapes (M = 1, 8, 9, 64 and 256; timed at 8 and 256) and at
    the probe's own shapes, each call with exact launches: bf16 x on the
    tensor-core route (one and several K-splits, ``n_pad``, ``k_pad``, a
    per-channel side, an unaligned x), f32 x on the CUDA-core kernel (the
    device kernels of a call are read in phase 2: ``check_inner_kernels``);
    the accuracy check; the SASS and registers of the product kernels; then
    the probe entry point's run (as its ``main``
    calls it) on its main path, the launch counters zeroed before it and
    read after it.  The kernel records of the qkv and gate_up shapes count
    no launch a decode step: as row 1, the probe kernel stands for o, down
    and the lm_head."""
    from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, QuantSpec
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import (
        MODES,
        SOURCE,
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

    def check(label, qt, x, mode, w_lib=None):
        inner_once(torch, label, qt, x, mode)
        return check_call(torch, f"{names[mode]}:{label}", qt, x, *runners[mode], w_lib)

    per_kernel = {}
    for name, k, widths, prenorm, per_step in MAIN_SHAPES:
        qt, spans = make_artifact(torch, gen, spec, k, widths, device)
        if not dm.bf16_mma_route(qt, torch.bfloat16):
            fail(f"w4_inner:{name}: not on the tensor-core route")
        w_lib = dequantize_weight(qt, torch.bfloat16)
        for mode in MODES:
            for m in (1, DECODE_M, 9, 64, PREFILL_M):
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                timed = m in (DECODE_M, PREFILL_M)
                rec = check(f"{name}:M={m}", qt, x, mode, w_lib if timed else None)
                if timed:
                    rec.update(kernel=names[mode], shape=name,
                               per_step=0 if prenorm else per_step,
                               stored_n=qt.qweight.shape[-1], spans=spans)
                    per_kernel.setdefault(names[mode], []).append(rec)
        del qt, w_lib
        torch.cuda.empty_cache()

    qt = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device)[0]
    qt_kp = make_artifact(torch, gen, spec, EXTRA_K, (EXTRA_N,), device, pad_k_to=1024)[0]
    if qt_kp.k_pad == 0:
        fail("the k_pad artifact has no padding")
    qt_pc = make_artifact(torch, gen, QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL,
                                                symmetric=False), INNER_K, (INNER_N,), device)[0]
    x = torch.randn((DECODE_M, EXTRA_K), generator=gen, device=device)
    xu = torch.empty((DECODE_M * EXTRA_K + 1,), dtype=torch.bfloat16, device=device)[1:]
    xu = xu.view(DECODE_M, EXTRA_K)
    xu.copy_(x)
    if not dm.x_needs_copy(xu, EXTRA_K // 2):
        fail("the unaligned x is read in place")
    for mode in MODES:
        check("f32", qt, x, mode)  # the CUDA-core kernel, at the f32 tolerance
        check("k_pad", qt_kp, x.to(torch.bfloat16), mode)
        check("unaligned_x", qt, xu, mode)
        for m in (DECODE_M, 64):
            check(f"per_channel:M={m}", qt_pc,
                  torch.randn((m, INNER_K), generator=gen, device=device).to(torch.bfloat16),
                  mode)
    del qt, qt_kp, qt_pc
    torch.cuda.empty_cache()

    for k, n in probe.SHAPES:  # the probe's own shapes, as it quantizes them
        qt = quantize_tensor(torch.randn((k, n), generator=gen, device=device) * 0.02,
                             probe.SPEC)
        x = torch.randn((probe.M, k), generator=gen, device=device).to(torch.bfloat16)
        for mode in MODES:
            check(f"probe:{k}x{n}", qt, x, mode)
        del qt
    torch.cuda.empty_cache()

    accuracy = inner_accuracy(torch, device, gen)
    slab_kernel_report(SOURCE)

    print(f"  -- the probe entry point at {len(probe.SHAPES)} shapes, M={probe.M}, "
          f"{probe.ROUNDS} rounds of {probe.ITERS} timed calls; errors and times read "
          "against its base, w4_matmul on its bf16 tensor-core route (the redesigned W4 "
          "kernel); f32 and magic on their tensor-core routes", flush=True)
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
    for tag in ("base", "magic", "f32"):
        if not any(k.startswith(f"{tag}-mma/NT=") and c["HMMA"] for k, c in res["sass"].items()):
            fail(f"probe: no {tag}-mma product kernel with HMMA in its SASS: {res['sass']}")
    res["accuracy"] = accuracy
    return per_kernel, res, launches


# ------------------------------------------------------------- phase 26

GPTQ_LAYERS = 4  # phase 26's depth: its solve takes 5-10 s a layer on an H100, and phase 27's
# time there (46 s) was paid from it
GPTQ_SAMPLES = 16  # calibration windows (GPTQConfig.nsamples) ...
GPTQ_SEQLEN = 512  # ... of 512 tokens: 8192 tokens a Hessian
# |ln PPL through the kernels - ln PPL dequantized|, both bf16.  Set between
# the two readings of an H100 run at GPTQ_LAYERS = 4, about 8x from each:
# 3.583e-5 for this pair, 2.524e-3 for the dense model against the GPTQ
# one, so that a forward that skipped the quantized weights would fail (at
# 8 layers the readings were 1.591e-4 and 9.2e-3)
PPL_TOL = 3e-4


def proxy_loss(h, w, qt):
    """``tr(dW^T H dW)`` with ``dW = dequant(qt) - w`` (``[K, N]``): the
    output error the calibration Hessian predicts for an artifact."""
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight

    d = dequantize_weight(qt) - w.float()
    return ((h @ d) * d).sum().item()


def gptq_block_cost(rows: int, count: int, gsize: int):
    """(bytes, operations) of one block's column loop: the block of w in
    (the refresh reads the same columns when the group is the block), the
    factor's upper triangle in, each group's scale and zero out, q, codes
    and err1 out; the rank-1 updates (a product and a difference an element
    of the triangle a row) and about a dozen operations a column."""
    nbytes = 4 * (rows * count + count * (count + 1) // 2 + 2 * rows * -(-count // gsize)
                  + 3 * rows * count)
    return nbytes, rows * (count * (count - 1) + 12 * count)


def ab_solve(torch, label, w, h, kw, solve, blocks, card):
    """The solve of ``w`` with ``h`` through the plain block loop and the
    kernel on the card, in turns (plain, kernel, kernel, plain): the wall
    seconds of each, exact launches and plain calls, each side repeatable,
    the kernel's result bit-equal to the plain loop's (no ``mse``)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import gptq_block as gb
    from iron_weight_only_quant_tpu_torch.quantize.gptq import gptq_block, gptq_block_plain

    secs, res = {"plain": [], "kernel": []}, {}
    for side in ("plain", "kernel", "kernel", "plain"):
        gb.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(w, h, gptq_block if side == "kernel" else gptq_block_plain, **kw)
        torch.cuda.synchronize()
        secs[side].append(time.perf_counter() - t0)
        want = {"kernel": (blocks, 0), "plain": (0, blocks)}[side]
        got = (gb.LAUNCHES[gb.GPTQ_BLOCK], gb.PLAIN_CALLS[gb.GPTQ_BLOCK])
        if got != want:
            fail(f"{label} ({side}): launches, plain calls {got} != {want}")
        for name, a, b in zip(out._fields, out, res.get(side, out)):
            if torch.is_tensor(a) and not torch.equal(a, b):
                fail(f"{label}: two {side} solves differ in {name}")
        res[side] = out
    max_err = (res["kernel"].q - res["plain"].q).abs().max().item()
    for name, a, b in zip(res["kernel"]._fields, res["kernel"], res["plain"]):
        if torch.is_tensor(a) and not torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b):
            fail(f"{label}: the kernel's {name} is not the plain loop's bit for bit "
                 f"(max |dq| {max_err:.3e})")
    print(f"  {label} ({w.shape[0]} x {w.shape[1]}, {blocks} blocks): kernel solve "
          f"{secs['kernel'][0]:.3f} / {secs['kernel'][1]:.3f} s, plain loop "
          f"{secs['plain'][0]:.3f} / {secs['plain'][1]:.3f} s in turns, "
          f"{blocks} launches a solve; q, codes and params bit-equal; on {card}", flush=True)
    return {"rows": w.shape[0], "cols": w.shape[1], "blocks": blocks, "kernel_s": secs["kernel"],
            "plain_s": secs["plain"], "max_abs_err": max_err}


def phase_gptq_block(torch, kept, shapes, gcfg, card):
    """The block kernel against the plain loop on the card, at layer 0's
    shapes: whole solves of q and down (4096 x 4096 and 4096 x 11008, the
    calibration's H, W4 g128 asym) and one TrueOBS ``sparseout`` solve of
    q, timed in turns; each block's device time at 4096 rows (q) and at
    11008 rows (gate) with its bound, and a layer's sum over its
    launches (``shapes``: name -> (rows, cols) of layer 0's linears)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import gptq_block as gb
    from iron_weight_only_quant_tpu_torch.quantize.gptq import (
        ColumnLoop,
        damped_hinv_upper,
        gptq_block_plain,
        solve_gptq,
    )
    from iron_weight_only_quant_tpu_torch.quantize.trueobs import solve_trueobs
    from iron_weight_only_quant_tpu_torch.utils.profiling import H100_F32_TFLOPS
    from iron_weight_only_quant_tpu_torch.utils.timing import device_ms

    bs = gcfg.blocksize
    kw = dict(bits=4, sym=False, groupsize=128, blocksize=bs, percdamp=gcfg.percdamp)
    out = {"solves": {}}
    for name in ("q", "down"):
        w, h = kept[name]
        out["solves"][name] = ab_solve(torch, f"GPTQ {name}", w, h, kw, solve_gptq,
                                       -(-w.shape[1] // bs), card)
    w, h = kept["q"]
    out["solves"]["q_trueobs_sparseout"] = ab_solve(
        torch, "TrueOBS sparseout q", w, h, dict(bits=4, sym=False, blocksize=bs,
                                                  percdamp=gcfg.percdamp, sparseout=True),
        solve_trueobs, -(-w.shape[1] // bs), card)
    # one block's time by CUDA events (the block's inputs warm in L2); the
    # plain loop's ~1,700 launches a block outrun the launch queue behind
    # device_ms's sleep kernel, so its time includes host gaps
    per_block = {}
    for name in ("q", "gate"):
        w, h = kept[name]
        rows, cols = w.shape
        hinv = damped_hinv_upper(h, gcfg.percdamp)
        n_groups = -(-cols // 128)
        loop = ColumnLoop(w.new_zeros((rows, n_groups)), w.new_zeros((rows, n_groups)), None,
                          128, True, 4, False, False, False, torch.zeros_like(w),
                          torch.zeros_like(w))
        gb.reset_counts()
        ms = device_ms(lambda i: gb.gptq_block_kernel(w, hinv, 0, bs, loop), 20)
        plain_ms = device_ms(lambda i: gptq_block_plain(w, hinv, 0, bs, loop), 1)
        nbytes, ops = gptq_block_cost(rows, bs, 128)
        bound_ms, bound_by = bound(nbytes, ops, H100_F32_TFLOPS * 1e12)
        per_block[rows] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        print(f"  one block's column loop, {rows} x {bs} (layer 0 {name}, g128): kernel "
              f"{ms:.4f} ms, plain loop {plain_ms:.3f} ms (CUDA events, host gaps included), "
              f"bound {bound_ms:.4f} "
              f"ms ({bound_by}: {nbytes} bytes, {ops} operations over 3.35 TB/s and "
              f"{H100_F32_TFLOPS:.0f} TFLOP/s f32; the chain of {bs} columns a row is "
              f"serial), on {card}", flush=True)
        del hinv, loop
    # a layer's launches by rows (every block of a 7B layer is a full one)
    layer_blocks = {}
    for rows, cols in shapes.values():
        if cols % bs or rows not in per_block:
            fail(f"GPTQ block timing: no timed block of {rows} rows and {bs} columns")
        layer_blocks[rows] = layer_blocks.get(rows, 0) + cols // bs
    layer = {k: sum(n * per_block[r][k] for r, n in layer_blocks.items())
             for k in ("ms", "plain_ms", "bytes", "ops")}
    layer["bound_ms"], layer["bound_by"] = bound(layer["bytes"], layer["ops"],
                                                 H100_F32_TFLOPS * 1e12)
    print(f"  a layer's {sum(layer_blocks.values())} launches "
          f"({', '.join(f'{n} of {r} rows' for r, n in layer_blocks.items())}): kernel "
          f"{layer['ms']:.3f} ms, plain loop {layer['plain_ms']:.1f} ms, bound "
          f"{layer['bound_ms']:.3f} ms, on {card}", flush=True)
    out.update(per_block=per_block, layer_blocks=layer_blocks, layer=layer)
    return out


def phase_gptq(torch, device, cfg_full, card):
    """The GPTQ path of ``cli/quantize.py`` and ``cli/eval_ppl.py`` at
    7B width, ``GPTQ_LAYERS`` layers: dense f32 params, norms folded,
    ``quantize_model_gptq`` (W4 g128 asym, 16 synthetic windows of 512
    tokens) with exact launch counts, seconds per layer (Hessian forwards,
    solve, quantized re-forward), every solve's blocks on the block kernel
    (``ceil(cols / blocksize)`` launches a solve, no plain block call), each
    linear's proxy loss against the RTN artifact's (GPTQ must be lower for
    every one), layer 0's q solved on the card against the CPU solve of the
    same H, traced, then the block kernel against the plain block loop on
    the card (:func:`phase_gptq_block`), the artifacts' calls of
    rows 1 and 2 against their plain versions; then fused, bf16: the
    perplexity through the kernels against ``dequantize_model_params``'s,
    ``generate`` and ``serve`` (the lm_head dense).  Its artifacts' save
    and load are the CLI phase's (10e: W4 nib4 tensors, a bf16 embedding,
    a dense lm_head)."""
    import dataclasses

    from iron_weight_only_quant_tpu_torch.config import (
        EngineConfig,
        GPTQConfig,
        KVCacheConfig,
        QuantSpec,
    )
    from iron_weight_only_quant_tpu_torch.data import get_loaders
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.evals import SequentialPPLEvaluator
    from iron_weight_only_quant_tpu_torch.models.llama import (
        fold_llama_norms,
        fuse_llama_projections,
        llama_forward,
        llama_init,
    )
    from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels import gptq_block as gb
    from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor, quantize_tensor
    from iron_weight_only_quant_tpu_torch.quantize.gptq import gptq_quantize
    from iron_weight_only_quant_tpu_torch.quantize.gptq_model import quantize_model_gptq
    from iron_weight_only_quant_tpu_torch.quantize.model_pass import (
        dequantize_model_params,
        quantize_model_params,
    )
    from iron_weight_only_quant_tpu_torch.utils.profiling import trace

    cfg = dataclasses.replace(cfg_full, num_layers=GPTQ_LAYERS)
    n_layers = cfg.num_layers
    names = (dm.W4, dm.W4_PRENORM)
    spec = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    gcfg = GPTQConfig(nsamples=GPTQ_SAMPLES)
    gen = torch.Generator(device=device).manual_seed(40)
    t0 = time.perf_counter()
    dense = fold_llama_norms(llama_init(cfg, gen, device=device))
    torch.cuda.synchronize()
    print(f"  dense f32 {n_layers}-layer model, norms folded, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    train, _ = get_loaders("synthetic", nsamples=GPTQ_SAMPLES, seed=0, seqlen=GPTQ_SEQLEN,
                           vocab_size=cfg.vocab_size)

    losses, kept, kept_card, shapes = [], {}, {}, {}
    stats = [{"hessian_s": 0.0, "solve_s": 0.0, "forward_s": 0.0} for _ in range(n_layers)]

    def observer(li, phase, secs, info):
        stats[li][f"{phase}_s"] += secs
        if phase != "solve":
            return
        name, h, w, new_w = info["name"], info["h"], info["w"], info["new_w"]
        g = proxy_loss(h, w, new_w)
        r = proxy_loss(h, w, quantize_tensor(w, spec))
        losses.append({"layer": li, "linear": name, "gptq": g, "rtn": r, "ratio": g / r})
        if li == 0:
            shapes[name] = (w.shape[1], w.shape[0])  # the solve's rows, cols
            if name in ("q", "gate", "down"):  # [rows, cols] and H, on the card
                kept_card[name] = (w.t().contiguous().float(), h.clone())
        if li == 0 and name == "q":
            kept.update(h=h.cpu(), w=w.t().contiguous().cpu(),
                        q=dequantize_weight(new_w).t().cpu())

    dm.reset_counts()
    gb.reset_counts()
    t0 = time.perf_counter()
    params = quantize_model_gptq(dense, cfg, "llama", [s.input_ids for s in train], spec,
                                 gcfg, progress=None, observer=observer)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    # the quantized re-forwards: q, k, v, gate, up on the prenorm kernel,
    # o and down on the flat one, a sample and a layer, f32 x
    want = {name: 0 for name in dm.LAUNCHES}
    want[dm.W4_PRENORM] = 5 * GPTQ_SAMPLES * n_layers
    want[dm.W4] = 2 * GPTQ_SAMPLES * n_layers
    calib_launches = check_counts("GPTQ calibration", want)
    # every solve's blocks on the block kernel: ceil(cols / blocksize) a solve
    want_blocks = n_layers * sum(-(-cols // gcfg.blocksize) for _, cols in shapes.values())
    block_launches = gb.LAUNCHES[gb.GPTQ_BLOCK]
    print(f"  GPTQ calibration: gptq_block launches {block_launches}, expected {want_blocks} "
          f"({want_blocks // n_layers} a layer: ceil(cols / {gcfg.blocksize}) a solve of "
          f"{sorted(shapes.values())}); plain block calls {gb.PLAIN_CALLS[gb.GPTQ_BLOCK]}",
          flush=True)
    if len(shapes) != 7 or block_launches != want_blocks or gb.PLAIN_CALLS[gb.GPTQ_BLOCK]:
        fail("GPTQ calibration did not solve every block through the block kernel")
    for li, st in enumerate(stats):
        print(f"  layer {li}: Hessian forwards {st['hessian_s']:.3f} s, solve "
              f"{st['solve_s']:.3f} s, quantized re-forward {st['forward_s']:.3f} s", flush=True)
    per_layer = {k: sum(st[k] for st in stats) / n_layers for k in stats[0]}
    print(f"  calibration {calib_s:.1f} s in all ({n_layers} layers, {GPTQ_SAMPLES} x "
          f"{GPTQ_SEQLEN} tokens, proxy losses and RTN artifacts included); per layer: "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_layer.items()) + f", on {card}",
          flush=True)
    for rec in losses:
        print(f"  proxy loss tr(dW H dW^T) layer {rec['layer']} {rec['linear']:5s}: GPTQ "
              f"{rec['gptq']:.6g}, RTN {rec['rtn']:.6g} (ratio {rec['ratio']:.4f})", flush=True)
    worse = [(r["layer"], r["linear"]) for r in losses if not r["gptq"] < r["rtn"]]
    if len(losses) != 7 * n_layers or worse:
        fail(f"GPTQ proxy loss not below RTN's for {worse} ({len(losses)} linears)")
    for li, layer in enumerate(params["layers"]):
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            qt = layer[key]["w"]
            if not isinstance(qt, QuantizedTensor) or qt.n_pad or qt.spec != spec:
                fail(f"layer {li} {key}: not an unpadded {spec} artifact")
    if isinstance(params["lm_head"]["w"], QuantizedTensor):
        fail("the lm_head was quantized; GPTQ calibrates the layers only")

    t0 = time.perf_counter()
    ref = gptq_quantize(kept["w"], kept["h"], bits=4, sym=False, groupsize=128,
                        blocksize=gcfg.blocksize, percdamp=gcfg.percdamp)
    cpu_solve_s = time.perf_counter() - t0
    equal = torch.isclose(kept["q"], ref.q, rtol=1e-5, atol=1e-7).float().mean().item()
    worst = (kept["q"] - ref.q).abs().max().item()
    limit = 0.3 * kept["w"].abs().max().item()
    print(f"  layer 0 q ({' x '.join(map(str, kept['w'].shape))}) solved on the card vs the "
          f"CPU, same H: {equal:.6f} "
          f"of q equal (rtol 1e-5, atol 1e-7; need > 0.995), max |dq| {worst:.3e} (limit "
          f"{limit:.3e}); CPU solve {cpu_solve_s:.1f} s", flush=True)
    if equal <= 0.995 or worst > limit:
        fail("the card's GPTQ solve of layer 0 q differs from the CPU's")
    # the same solve again on the card, traced: its device busy time
    # against its wall time says whether the column loop is host-bound
    w0, h0 = kept["w"].to(device), kept["h"].to(device)
    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        again = gptq_quantize(w0, h0, bits=4, sym=False, groupsize=128,
                              blocksize=gcfg.blocksize, percdamp=gcfg.percdamp)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if not torch.equal(again.q.cpu(), kept["q"]):
        fail("two card solves of layer 0 q with the same H differ")
    by_name = device_time_by_name(prof)
    solve_trace = {"wall_s": traced_s, "columns": w0.shape[1]}
    if by_name:
        busy = sum(us for _, us in by_name.values()) / 1e3
        events = sum(n for n, _ in by_name.values())
        solve_trace.update(device_busy_ms=busy, device_idle_share=1 - busy / (traced_s * 1e3),
                           device_events=events, events_per_column=events / w0.shape[1])
        print(f"  layer 0 q solve again on the card, traced: wall {traced_s:.3f} s, device "
              f"busy {busy:.1f} ms (idle {100 * solve_trace['device_idle_share']:.1f}%), "
              f"{events} device events ({events / w0.shape[1]:.1f} a column); repeatable",
              flush=True)
    else:
        solve_trace.update(device_busy_ms="not measured", device_idle_share="not measured")
        print("  profiler: no device events; the solve's device busy time not measured",
              flush=True)
    del kept, ref, w0, h0, again, prof
    print(f"  -- the block kernel against the plain loop on the card, in turns", flush=True)
    block_ab = phase_gptq_block(torch, kept_card, shapes, gcfg, card)
    del kept_card
    torch.cuda.empty_cache()
    errs = [r["max_abs_err"] for r in block_ab["solves"].values()]
    layer = block_ab["layer"]
    block_row = {
        "name": "gptq_block", "route": "cuda", "source": KERNEL_SOURCES["gptq_block"][0],
        "replaces": KERNEL_SOURCES["gptq_block"][1], "launches": block_launches,
        "max_abs_err": max(errs), "ms": layer["ms"], "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"], "library_ms": None,
        "per": f"one layer's {sum(block_ab['layer_blocks'].values())} launches",
        "block_ms": {r: b["ms"] for r, b in block_ab["per_block"].items()},
        "block_plain_ms": {r: b["plain_ms"] for r, b in block_ab["per_block"].items()},
        "block_bound_ms": {r: b["bound_ms"] for r, b in block_ab["per_block"].items()},
    }

    eps = cfg.rms_norm_eps
    kernel_checks = []
    for key, pre in (("q", eps), ("gate", eps), ("o", None), ("down", None)):
        qt = params["layers"][0][key]["w"]
        kname = dm.kernel_name(qt, pre)
        if kname != names[pre is not None]:
            fail(f"GPTQ {key} dispatches to {kname}")
        for m, dtype in ((GPTQ_SEQLEN, torch.float32), (DECODE_M, torch.bfloat16)):
            x = torch.randn((m, qt.shape[0]), generator=gen, device=device).to(dtype)
            kernel_checks.append(check_call(
                torch, f"{kname}:gptq_{key}:M={m}", qt, x,
                lambda x, qt, pre=pre: dm.fused_quantized_matmul(x, qt, pre_norm=pre),
                lambda x, qt, pre=pre: dm.dequant_matmul_plain(x, qt, pre_norm=pre)))

    fused = fuse_llama_projections(params)
    if not all("qkv" in layer and "gate_up" in layer for layer in fused["layers"]):
        fail("GPTQ artifacts did not fuse")
    model = cast_dense(fused, torch.bfloat16)
    del fused

    def ppl(p, label, expect=None):
        ev = SequentialPPLEvaluator(p, llama_forward, cfg, seqlen=GPTQ_SEQLEN)
        dm.reset_counts()
        t0 = time.perf_counter()
        value, n_tok, n_chunks = ev.calculate_ppl("synthetic")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if expect is not None:
            check_counts(f"PPL ({label})", expect(-(-n_chunks // ev.batch_size)))
        if not math.isfinite(value):
            fail(f"PPL ({label}) is not finite")
        print(f"  PPL ({label}, bf16): {value:.4f} over {n_tok} tokens in {n_chunks} chunks "
              f"of {GPTQ_SEQLEN}, {secs:.2f} s", flush=True)
        return {"ppl": value, "tokens": n_tok, "chunks": n_chunks, "s": secs}

    ppls = {"gptq_kernels": ppl(model, "GPTQ W4 through the kernels", lambda f: (
        expected_launches(names, f, n_layers, dense_head=True)))}
    deq = cast_dense(dequantize_model_params(params), torch.bfloat16)
    ppls["gptq_dequantized"] = ppl(deq, "GPTQ W4 dequantized, dense matmuls")
    del deq
    rtn, _ = quantize_model_params(dense, spec, device=device)
    ppls["rtn_kernels"] = ppl(cast_dense(fuse_llama_projections(rtn), torch.bfloat16),
                              "RTN W4 of the same weights, through the kernels")
    ppls["dense"] = ppl(cast_dense(dense, torch.bfloat16), "the dense model")
    del rtn, dense
    torch.cuda.empty_cache()
    d_ln = abs(math.log(ppls["gptq_kernels"]["ppl"]) - math.log(ppls["gptq_dequantized"]["ppl"]))
    print(f"  |ln PPL(kernels) - ln PPL(dequantized)| = {d_ln:.3e} (limit {PPL_TOL})",
          flush=True)
    if d_ln > PPL_TOL:
        fail(f"GPTQ PPL through the kernels is {d_ln:.3e} in ln from the dequantized model's")

    print("  -- GPTQ W4 generate and serve (bf16, 16-bit cache, the lm_head dense)",
          flush=True)
    ecfg = EngineConfig(fuse_projections=True,
                        kv=KVCacheConfig(max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8))
    eng = InferenceEngine(model, cfg, llama_forward, family="llama", engine_cfg=ecfg,
                          dtype=torch.bfloat16, device=device)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=device).tolist() for n in PROMPT_LENS]
    gen_res = run_generate(torch, eng, prompts, cfg, card, lambda f: (
        expected_launches(names, f, n_layers, dense_head=True), None), "GPTQ generate")
    del eng
    serve = phase_serve(torch, model, cfg, names, SERVE_RUNS, card, dense_head=True)
    del model
    torch.cuda.empty_cache()

    del params
    torch.cuda.empty_cache()
    return {
        "layers": n_layers, "samples": GPTQ_SAMPLES, "seqlen": GPTQ_SEQLEN,
        "calibration_s": calib_s, "per_layer_s": per_layer, "layers_s": stats,
        "calibration_launches": calib_launches, "proxy_losses": losses,
        "gptq_over_rtn_max": max(r["ratio"] for r in losses),
        "solve_card_vs_cpu": {"equal": equal, "max_abs": worst, "limit": limit,
                              "cpu_solve_s": cpu_solve_s},
        "solve_trace": solve_trace, "block_launches": block_launches,
        "block_ab": block_ab, "block_row": block_row,
        "kernel_checks": [{k: r[k] for k in ("call", "max_abs_err", "rel_err", "tol")}
                          for r in kernel_checks],
        "ppl": ppls, "ppl_d_ln": d_ln, "generate": gen_res, "serve": serve,
        "card": card,
    }


# --------------------------------------------------------------- report

# ------------------------------------------------------------- phase 27

TP_RANKS = 2  # model-axis ranks of the two-rank run (gloo, sharing the one card)
PP_MICRO = 2  # micro-batches of the two-stage pipeline scoring pass


def unfuse_llama(params):
    """Fused LLaMA params (phase 4's) with each fused linear split back
    into its members' logical columns (``tp_block._slice_cols``: views, no
    copy; the members' N padding is dropped)."""
    from iron_weight_only_quant_tpu_torch.parallel.tp_block import _slice_cols

    layers = []
    for p in params["layers"]:
        p = dict(p)
        for fused, names in (("qkv", ("q", "k", "v")), ("gate_up", ("gate", "up"))):
            fl = p.pop(fused)
            for name, (a, b) in zip(names, fl.spans):
                p[name] = {"w": _slice_cols(fl.w, a, b), "b": None}
        layers.append(p)
    return {**params, "layers": layers}


def token_agreement(got, want):
    """The share of generated tokens equal to ``want``'s, position by position."""
    pairs = [(g, w) for go, wo in zip(got, want) for g, w in zip(go, wo)]
    return sum(g == w for g, w in pairs) / max(len(pairs), 1)


def hold_tokens(what, got, want, logits):
    """Greedy tokens against another path's: where the logits were
    bit-equal the whole computation is, and the tokens must be equal; else
    the logits bound held and the agreement is reported."""
    agree = token_agreement(got, want)
    print(f"  {what}: token agreement {agree:.4f} with the one-device engine's", flush=True)
    if logits["bit_equal"] and got != want:
        fail(f"{what}: bit-equal logits, yet other tokens than the one-device engine's")
    return agree


def ab_generate(torch, sides, prompts, card, rounds=SERVE_RUNS):
    """``generate`` of ``prompts`` (``NEW_TOKENS`` new) on two engines in
    turns, A B B A A B ..., so that both meet the same host: per side the
    median wall time and every wall time, and A's median over B's."""
    walls = {label: [] for label, _ in sides}
    for i in range(2 * rounds):
        label, eng = sides[(i + i // 2) % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t0)
    res = {label: {"median_s": sorted(w)[len(w) // 2], "walls_s": w}
           for label, w in walls.items()}
    (a, _), (b, _) = sides
    res[f"{a}_over_{b}"] = res[a]["median_s"] / res[b]["median_s"]
    print(f"  generate in turns: {a} {res[a]['median_s']:.3f} s, {b} {res[b]['median_s']:.3f} s "
          f"(medians of {rounds}), {a} / {b} = {res[f'{a}_over_{b}']:.3f}, on {card}", flush=True)
    return res


def phase_tp_one_rank(torch, params, cfg, card, flat_gen, flat_serve):
    """``tp_block=True`` at world size 1 on phase 4's 32-layer W4 model,
    unfused and re-fused shard-blocked (``parallel.tp_block``, d = 1):
    logits against the one-device forward, ``generate`` and one ``serve``
    against phase 4's tokens (``generate`` also timed in turns with the
    one-device engine's), then the scan ``generate`` (prepared and
    stacked by the engine), whose tokens must equal the flat TP ones;
    exact launches of rows 1 and 2 (and 3 and 4 on the scan path), no
    plain or route call."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward, llama_forward_scan
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    names, n_layers = (dm.W4, dm.W4_PRENORM), cfg.num_layers
    device = params["embed"].device
    unfused = unfuse_llama(params)
    ecfg = EngineConfig(fuse_projections=True,
                        kv=KVCacheConfig(max_seq_len=max(PROMPT_LENS) + NEW_TOKENS + 8))
    t0 = time.perf_counter()
    eng = InferenceEngine(unfused, cfg, llama_forward, family="llama", engine_cfg=ecfg,
                          dtype=torch.bfloat16, device=device, tp_block=True)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    l0 = eng.params["layers"][0]
    widths = {k: l0[k].w.shape[1] for k in ("qkv", "gate_up")}
    print(f"  prepared (shard-blocked fusion, d = 1) in {prepare_s:.2f} s: fused widths "
          f"{widths}, world {eng.mesh.world}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"on the card, on {card}", flush=True)
    hd, pad = cfg.hd, lambda n: -(-n // 128) * 128  # noqa: E731 (the blocks' pad_to)
    if eng.mesh.world != 1 or widths != {
            "qkv": pad((cfg.num_heads + 2 * cfg.num_kv_heads) * hd),
            "gate_up": pad(2 * cfg.intermediate_size)}:
        fail(f"tp_block at d = 1: world {eng.mesh.world}, fused widths {widths}")

    gen = torch.Generator(device=device).manual_seed(27)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=device)
    with torch.inference_mode():
        got, _ = eng.forward(eng.params, tokens, cfg)
        want, _ = llama_forward(params, tokens, cfg)
    logits = compare_logits(torch, f"bfloat16 {n_layers} layers, TP d = 1 vs one device", got,
                            want, LOGITS_TOL["bfloat16"])
    del got, want

    t0 = time.perf_counter()
    gen_res = run_generate(torch, eng, flat_gen["prompts"], cfg, card,
                           lambda f: (expected_launches(names, f, n_layers), None),
                           "TP d = 1 generate")
    gen_res["token_agreement"] = hold_tokens("TP d = 1 generate", gen_res["tokens"],
                                             flat_gen["tokens"], logits)
    gen_res["phase_s"] = time.perf_counter() - t0
    one_eng = InferenceEngine(params, cfg, llama_forward, family="llama", engine_cfg=ecfg,
                              dtype=torch.bfloat16, device=device)
    gen_res["ab"] = ab_generate(torch, [("tp_d1", eng), ("one_device", one_eng)],
                                flat_gen["prompts"], card)
    del one_eng

    # the serve engine takes the prepared params: at d = 1 they pass through
    serve_eng, reqs = serve_engine(torch, eng.params, cfg, tp_block=True)
    stats = {}
    torch.cuda.synchronize()
    dm.reset_counts()
    t0 = time.perf_counter()
    out = serve_eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_counts("TP d = 1 serve", expected_launches(names, stats["n_steps"],
                                                                n_layers))
    n_gen = sum(len(o) for o in out)
    serve_res = {"wall_s": wall, "toks_per_s": n_gen / wall, "device_steps": stats["n_steps"],
                 "launches": launches, "card": card,
                 "token_agreement": hold_tokens("TP d = 1 serve", out, flat_serve["tokens"],
                                                logits)}
    print(f"  TP d = 1 serve: {wall:.3f} s, {serve_res['toks_per_s']:.1f} generated tok/s "
          f"(one run), on {card}", flush=True)
    del serve_eng, eng

    t0 = time.perf_counter()
    scan_eng = InferenceEngine(unfused, cfg, llama_forward_scan, family="llama",
                               engine_cfg=ecfg, dtype=torch.bfloat16, device=device,
                               tp_block=True)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    print(f"  prepared and stacked (d = 1) in {stack_s:.2f} s, on {card}", flush=True)
    scan_res = run_generate(torch, scan_eng, flat_gen["prompts"], cfg, card,
                            scan_expect(names, n_layers), "TP d = 1 scan generate")
    if scan_res["tokens"] != gen_res["tokens"]:
        fail("TP d = 1 scan generate gave other tokens than the flat TP generate")
    scan_res.update(stack_s=stack_s,
                    token_agreement=token_agreement(scan_res["tokens"], flat_gen["tokens"]))
    del scan_eng, unfused
    torch.cuda.empty_cache()
    return {"logits": logits, "prepare_s": prepare_s, "generate": gen_res,
            "serve": serve_res, "scan_generate": scan_res}


def build_tp_llama(torch, cfg, seed, device):
    """:func:`build_quantized_llama` from ``seed`` with its lm_head
    quantized again without N padding (a padded column-parallel head is
    refused under d > 1); the same numbers on every process of one card."""
    from iron_weight_only_quant_tpu_torch.config import QuantSpec
    from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

    w4 = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = build_quantized_llama(cfg, gen, w4, torch.bfloat16, device)
    head = torch.randn((cfg.hidden_size, cfg.vocab_size), generator=gen, device=device) * 0.02
    params["lm_head"] = {"w": quantize_tensor(head, w4), "b": None}
    return params


def tp_inputs(torch, cfg, device):
    """(prompts, requests, logits tokens, pipeline tokens) of the two-rank run."""
    gen = torch.Generator(device=device).manual_seed(28)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen, device=device).tolist()
               for n in PROMPT_LENS]
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=device)
    pp_tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen, device=device)
    return prompts, serve_requests(cfg.vocab_size), tokens.cpu(), pp_tokens.cpu()


def counts_now(torch):
    """The launch, stacked launch, plain and route counters after a sync."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"launches": dict(dm.LAUNCHES), "stacked": dict(dm.STACKED_LAUNCHES),
            "plain": dict(dm.PLAIN_CALLS), "route": dict(dm.ROUTE_CALLS)}


def run_tp_model(torch, params, cfg, device, prompts, reqs, tokens, mesh_cfg, tp_block):
    """Logits of ``tokens``, ``generate`` of ``prompts`` and ``serve`` of
    ``reqs`` on one engine (``mesh_cfg``), each timed, with its launch
    counts (zeroed before, read after)."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    eng, _ = serve_engine(torch, params, cfg, tp_block=tp_block, mesh=mesh_cfg)
    res = {}
    with torch.inference_mode():
        res["logits"] = eng.forward(eng.params, tokens.to(device), cfg)[0].float().cpu()
    dm.reset_counts()
    t0 = time.perf_counter()
    res["generate"] = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    res["generate_counts"] = counts_now(torch)
    res["generate_s"] = time.perf_counter() - t0
    stats = {}
    dm.reset_counts()
    t0 = time.perf_counter()
    res["serve"] = eng.serve(reqs, max_new_tokens=NEW_TOKENS, chunk=SERVE_CHUNK, stats=stats)
    res["serve_counts"] = counts_now(torch)
    res["serve_s"] = time.perf_counter() - t0
    res["serve_steps"] = stats["n_steps"]
    return res


def tp_rank_main(rank, world, device, cfg, seed, inputs, out_prefix):
    """One rank of the two-rank run: the TP engine (model = 2) on the
    model built from ``seed``, then the two-stage pipeline scoring pass
    and, on rank 0, ``llama_forward`` of the same tokens on the whole
    model; writes its results to ``{out_prefix}.{rank}``."""
    import torch

    from iron_weight_only_quant_tpu_torch.config import MeshConfig
    from iron_weight_only_quant_tpu_torch.models.llama import llama_forward
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.parallel import pp
    from iron_weight_only_quant_tpu_torch.parallel.mesh import make_mesh
    from iron_weight_only_quant_tpu_torch.parallel.sharding import apply_sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, reqs, tokens, pp_tokens = inputs
    t0 = time.perf_counter()
    params = build_tp_llama(torch, cfg, seed, device)
    res = {"build_s": time.perf_counter() - t0}
    res.update(run_tp_model(torch, params, cfg, device, prompts, reqs, tokens,
                            MeshConfig(model=world), True))
    print(f"  [rank {rank}] generate {res['generate_s']:.2f} s, serve {res['serve_s']:.2f} s",
          flush=True)

    mesh = make_mesh(MeshConfig(model=world), device)
    staged = pp.stage_stack_llama_layers(params, world)
    staged = apply_sharding(staged, pp.pp_param_specs(staged), mesh)
    fwd = pp.make_pp_llama_forward(cfg, mesh, PP_MICRO)
    with torch.inference_mode():
        fwd(staged, pp_tokens.to(device))  # warm-up
        dm.reset_counts()
        t0 = time.perf_counter()
        res["pp_logits"] = fwd(staged, pp_tokens.to(device)).float().cpu()
        res["pp_counts"] = counts_now(torch)
        res["pp_s"] = time.perf_counter() - t0
        if rank == 0:
            res["pp_ref"] = llama_forward(params, pp_tokens.to(device), cfg)[0].float().cpu()
    torch.save(res, f"{out_prefix}.{rank}")


def pp_expected(cfg, stage, n_stages):
    """Launches of stage ``stage``'s part of one pipeline pass: its
    ``L/S`` layers (q, k, v, gate, up on the stacked prenorm kernel, o and
    down on the stacked flat one) per micro-batch, and the packed lm_head
    (flat) on the last stage."""
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

    per = PP_MICRO * cfg.num_layers // n_stages
    stacked = {name: 0 for name in dm.LAUNCHES}
    stacked.update({dm.W4: 2 * per, dm.W4_PRENORM: 5 * per})
    launches = dict(stacked)
    launches[dm.W4] += int(stage == n_stages - 1)
    return launches, stacked


def phase_tp_two_ranks(torch, device, cfg, card):
    """Two gloo ranks sharing the one card, model = 2, on a ``cfg``-layer
    W4 model with an unpadded head: logits, ``generate`` and ``serve``
    against one process on the same weights (logits within the bf16
    tolerance, token agreement reported), each rank's exact launches;
    then a two-stage ``make_pp_llama_forward`` pass against
    ``llama_forward``."""
    import shutil

    from iron_weight_only_quant_tpu_torch.config import MeshConfig
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.parallel.mesh import spawn_ranks

    names = (dm.W4, dm.W4_PRENORM)
    inputs = tp_inputs(torch, cfg, device)
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase27")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    t0 = time.perf_counter()
    spawn_ranks(tp_rank_main, TP_RANKS, (cfg, 29, inputs, os.path.join(folder, "out")),
                platform="cuda")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(folder, f"out.{r}"), weights_only=False)
             for r in range(TP_RANKS)]
    shutil.rmtree(folder, ignore_errors=True)
    print(f"  {TP_RANKS} ranks ran in {ranks_s:.1f} s (spawn, build, runs), on {card}",
          flush=True)

    t0 = time.perf_counter()
    params = build_tp_llama(torch, cfg, 29, device)
    one = run_tp_model(torch, params, cfg, device, *inputs[:3], MeshConfig(), False)
    one_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    res = {"ranks_s": ranks_s, "one_process_s": one_s, "card": card, "ranks": []}
    for r, got in enumerate(ranks):
        logits = compare_logits(torch, f"bfloat16 {cfg.num_layers} layers, rank {r} of TP "
                                f"d = {TP_RANKS} vs one process", got["logits"],
                                one["logits"], LOGITS_TOL["bfloat16"])
        for what, forwards in (("generate", NEW_TOKENS), ("serve", got["serve_steps"])):
            counts = got[f"{what}_counts"]
            want = expected_launches(names, forwards, cfg.num_layers)
            print(f"  [rank {r}] {what}: launches {counts['launches']}, plain "
                  f"{counts['plain']}, route {counts['route']}", flush=True)
            if (counts["launches"] != want or any(counts["plain"].values())
                    or any(counts["route"].values())):
                fail(f"rank {r} {what}: launches {counts} != expected {want}")
        want, want_stacked = pp_expected(cfg, r, TP_RANKS)
        pc = got["pp_counts"]
        print(f"  [rank {r}] pipeline pass: launches {pc['launches']}, stacked "
              f"{ {k: v for k, v in pc['stacked'].items() if v} }", flush=True)
        if (pc["launches"] != want or pc["stacked"] != want_stacked
                or any(pc["plain"].values()) or any(pc["route"].values())):
            fail(f"rank {r} pipeline pass: counts {pc} != expected {want}, {want_stacked}")
        res["ranks"].append({
            "logits": logits, "build_s": got["build_s"], "generate_s": got["generate_s"],
            "serve_s": got["serve_s"], "pp_s": got["pp_s"],
            "generate_launches": got["generate_counts"]["launches"],
            "serve_launches": got["serve_counts"]["launches"],
            "pp_launches": pc["launches"],
            "generate_agreement": token_agreement(got["generate"], one["generate"]),
            "serve_agreement": token_agreement(got["serve"], one["serve"])})
        print(f"  [rank {r}] token agreement with one process: generate "
              f"{res['ranks'][-1]['generate_agreement']:.4f}, serve "
              f"{res['ranks'][-1]['serve_agreement']:.4f}; generate "
              f"{got['generate_s']:.2f} s, serve {got['serve_s']:.2f} s, on {card}", flush=True)
        if got["generate"] != ranks[0]["generate"] or got["serve"] != ranks[0]["serve"]:
            fail(f"rank {r} gave other tokens than rank 0")
    res["pp_logits"] = compare_logits(
        torch, f"bfloat16 {cfg.num_layers} layers, {TP_RANKS}-stage pipeline vs llama_forward",
        ranks[0]["pp_logits"], ranks[0]["pp_ref"], LOGITS_TOL["bfloat16"])
    if not torch.equal(ranks[1]["pp_logits"], ranks[0]["pp_logits"]):
        fail("the pipeline's logits differ between the ranks")
    res["pp_s"] = ranks[0]["pp_s"]
    res["one_process"] = {"generate_s": one["generate_s"], "serve_s": one["serve_s"]}
    return res


def kernel_rows(per_kernel, launches, stacked):
    """One row per kernel: times summed over the launches one decode step
    (M=8) makes at each main-path shape, and the same sums of the M=256
    records (``prefill_*``: one such launch per shape and step's launch);
    ``launches`` from the run of the kernel's flat main path, ``stacked``
    the stacked launches of its scan main path.  A kernel's row gives its
    flat launches (``launches_flat`` = ``launches``) and, beside them, the
    stacked ones of the same kernel (``launches_stacked``); its stacked-form
    row (``<kernel>_pfx``, timed on stacked calls) gives the stacked ones as
    its ``launches``."""
    rows = []
    for name, recs in per_kernel.items():
        def at(m):  # (sum of key over the step's launches at M=m, bound, bound_by)
            sel = [r for r in recs if r["M"] == m and "ms" in r]
            step = lambda key: sum(r[key] * r["per_step"] for r in sel)  # noqa: E731
            return step, bound(step("bytes"), step("ops"), sel[0]["peak"])
        step, (bound_ms, bound_by) = at(DECODE_M)
        pstep, (pbound_ms, _) = at(PREFILL_M)
        base = name[:-len(PFX)] if name.endswith(PFX) else name
        n_stacked = stacked.get(base, 0)
        n_flat = 0 if base != name else launches[name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1],
            "launches": n_stacked if base != name else n_flat,
            "launches_flat": n_flat, "launches_stacked": n_stacked,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": step("ms"), "plain_ms": step("plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": step("library_ms"),
            "prefill_ms": pstep("ms"), "prefill_bound_ms": pbound_ms,
            "prefill_library_ms": pstep("library_ms"),
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

    from iron_weight_only_quant_tpu_torch import native

    t0 = time.perf_counter()
    paths = kbuild.build()
    print(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    host_lib = native.build()
    print(f"  built the host library {os.path.basename(host_lib)} (g++) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
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
    fp8 = fp_spec("fp8", 4, 3, group_size=128)
    cfg = LlamaConfig.llama2_7b()
    cfg_cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    tol = f"tolerance max|y-y_ref|/max|y_ref| <= {REL_TOL_BF16}, bf16 x"

    tol_a = f"{tol}; {REL_TOL_F32} for f32 x"
    header(f"== phase 2: W4 kernels vs plain versions ({tol_a})")
    per_kernel = phase_kernels(torch, device, w4, (dm.W4, dm.W4_PRENORM))
    print("  -- w4 bf16 route: ranges whose last part ends early, groups off the 32-row "
          "window, groups straddling the K halves, x copied; the row factor with one split "
          "and with a K-split; SASS and registers", flush=True)
    check_bf16_mma_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=4, group_size=16, symmetric=False), 4096),
        "g128_asym_k1408_straddle": (w4, 1408)}, 19)
    check_route_kernels(torch, device, w4, 20, W4_ROUTE_CALLS)
    # the W8 and fp8 routes' calls are counted here too: a profiler session
    # after a profiled serve (phase 4 on) recorded no device event for one
    # call on the H100
    print("  -- device kernels a call of the W8 (flat and prenorm) and fp8 bf16 routes",
          flush=True)
    check_route_kernels(torch, device, w8, 22, W8_ROUTE_CALLS)
    check_route_kernels(torch, device, fp8, 24, LUT8_ROUTE_CALLS)
    print("  -- device kernels a call of the W4 inner-loop probe kernel (phase 24's), both "
          "modes: the tensor-core routes, and the CUDA-core kernel for f32 x", flush=True)
    check_inner_kernels(torch, device, w4, 26)
    slab_kernel_report(dm.W4)
    slab_kernel_report(dm.W4_PRENORM)

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
    print("  -- w8 bf16 route (flat and prenorm): ranges whose last part ends early, groups "
          "off the 32-row window, x copied; SASS and registers", flush=True)
    check_bf16_mma_ragged(torch, device, {
        "g128_asym": (w8, 4096),
        "perchannel_sym": (QuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL,
                                     symmetric=True), 4096),
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=8, group_size=16, symmetric=False), 4096)}, 21)
    slab_kernel_report(dm.W8)
    slab_kernel_report(dm.W8_PRENORM)

    header("== phase 6: W8 two-layer 7B-width logits, kernels vs plain path")
    phase_two_layers(torch, device, w8, cfg)

    header(f"== phase 7: {CUT_LAYERS}-layer 7B-width W8 serve")
    serve_w8, params_w8 = phase_w8_serve(torch, device, w8, cfg_cut, card)

    header(f"== phase 8: int-activation kernels vs plain versions ({tol_a})")
    per_kernel_a, row_pass_checks = phase_a_kernels(torch, device, {4: w4, 8: w8})
    per_kernel.update(per_kernel_a)
    print("  -- w8a16: ranges whose last part ends early, groups off the 32-row window; "
          "SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=8, group_size=16, symmetric=False), 4096)}, 13)
    slab_kernel_report(dm.W8A16)
    print("  -- w8a8 (one plane): as w8a16; SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=8, group_size=16, symmetric=False), 4096)}, 25,
        abits=8)
    slab_kernel_report(dm.W8A8)
    print("  -- w4a16: ranges whose last part ends early, groups off the 32-row window, "
          "groups straddling the K halves; SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=4, group_size=16, symmetric=False), 4096),
        "g128_asym_k1408_straddle": (w4, 1408)}, 17)
    slab_kernel_report(dm.W4A16)
    print("  -- w4a8 (one plane): ranges whose last part ends early, groups off the 32-row "
          "window, groups straddling the K halves; SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=4, group_size=16, symmetric=False), 4096),
        "g128_asym_k1408_straddle": (w4, 1408)}, 23, abits=8)
    slab_kernel_report(dm.W4A8)

    header("== phase 9: two-layer 7B-width logits under A8 and A16, kernels vs "
           "plain path")
    for spec in (w4, w8):
        phase_two_layers(torch, device, spec, cfg, abits_list=dm.ACTIVATION_BITS)

    header(f"== phase 10: {CUT_LAYERS}-layer 7B-width W4 serve, A8 waves, A16 decode")
    serve_w4_a = phase_serve(torch, {**params_w4, "layers": params_w4["layers"][:CUT_LAYERS]},
                             cfg_cut, (dm.W4A8, dm.W4A16), SERVE_RUNS, card, abits=(8, 16))

    header("== phase 10a: KV codec on the card vs the CPU, paged round trips")
    kv_codec_checks = phase_kv_codec(torch, device)

    header("== phase 10b: W4 two-layer 7B-width logits with int8 and int4 KV caches, "
           f"kernels vs plain path (limits {LOGITS_TOL_KV})")
    phase_two_layers(torch, device, w4, cfg, kv_bits_list=(8, 4))

    header(f"== phase 10c: {CUT_LAYERS}-layer 7B-width W4 serve with paged, int8 and int4 KV "
           "caches")
    serve_kv = phase_kv_serves(torch, {**params_w4, "layers": params_w4["layers"][:CUT_LAYERS]},
                               cfg_cut, card)

    header(f"== phase 10d: 32-layer 7B-width W4 generate on a {LONG_CONTEXT}-column int8 "
           "paged cache")
    long_gen = phase_long_generate(
        torch, params_w4, cfg, card,
        (res["generate_s"] - res["prefill_s"]) * 1e3 / (NEW_TOKENS - 1))

    header("== phase 10f: 32-layer 7B-width W4 on the scan path (layer-stacked params and "
           "KV caches): generate, serve with 16-bit and int8 caches")
    scan_w4 = phase_scan_w4(torch, params_w4, cfg, card, res, serve_w4)

    header("== phase 28: CUDA graphs against the eager chunk bodies: 32-layer W4 generate "
           f"and serve, the scan serve, the {CUT_LAYERS}-layer int8 paged serve")
    t0 = time.perf_counter()
    graphs_ab = phase_graphs(torch, params_w4, cfg, card)
    print(f"  phase 28: {time.perf_counter() - t0:.1f} s, on {card}", flush=True)

    header("== phase 27: parallelism: tp_block at world size 1 on the 32-layer W4 model, "
           f"then {TP_RANKS} gloo ranks on the card (model = {TP_RANKS}, {CUT_LAYERS} "
           "layers) and a two-stage pipeline")
    tp_one = phase_tp_one_rank(torch, params_w4, cfg, card, res, serve_w4)
    del params_w4
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_two = phase_tp_two_ranks(torch, device, cfg_cut, card)
    print(f"  phase 27 two-rank part: {time.perf_counter() - t0:.1f} s, on {card}", flush=True)

    header(f"== phase 10e: the CLI at 7B width, {CLI_LAYERS} layers: an f16 HF checkpoint "
           "through cli.quantize (the run's only artifact save), cli.generate, cli.eval_ppl, "
           "cli.eval_zeroshot; tokenshard and analysis")
    cli = phase_cli(torch, device, cfg, card)

    header(f"== phase 11: {CUT_LAYERS}-layer 7B-width W8 serve, A16 waves, A8 decode")
    serve_w8_a = phase_serve(torch, params_w8, cfg_cut, (dm.W8A16, dm.W8A8), SERVE_RUNS,
                             card, abits=(16, 8))

    header(f"== phase 11a: {CUT_LAYERS}-layer 7B-width W8 serve on the scan path, and with "
           "A16 waves, A8 decode")
    serve_w8_scan, serve_w8_scan_a = phase_scan_w8(torch, params_w8, cfg_cut, card, serve_w8,
                                                   serve_w8_a)
    del params_w8
    torch.cuda.empty_cache()

    from iron_weight_only_quant_tpu_torch.models import BloomConfig, OPTConfig

    header(f"== phase 11b: {CUT_LAYERS}-layer OPT-6.7B-width W4, flat and scan")
    opt_res = phase_family(torch, device, "opt",
                           dataclasses.replace(OPTConfig.opt_6_7b(), num_layers=CUT_LAYERS),
                           w4, card, 30)
    header(f"== phase 11c: {CUT_LAYERS}-layer BLOOM-7b1-width W4, flat and scan")
    bloom_res = phase_family(torch, device, "bloom",
                             BloomConfig(vocab_size=250880, hidden_size=4096,
                                         num_layers=CUT_LAYERS, num_heads=32),
                             w4, card, 31)

    w3 = QuantSpec(fmt="int", bits=3, group_size=128, symmetric=False)
    header(f"== phase 12: W3 kernels vs plain versions ({tol_a})")
    per_kernel.update(phase_w3_kernels(torch, device, w3))
    print("  -- w3a16: groups and slabs off the 32-row window; SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=3, group_size=16, symmetric=False), 4096)}, 11)
    slab_kernel_report(dm.W3A16)
    print("  -- w3a8 (one plane): as w3a16; SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=3, group_size=16, symmetric=False), 4096)}, 26,
        abits=8)
    slab_kernel_report(dm.W3A8)
    print("  -- w3 bf16 route: groups and slabs off the 32-row window, x copied; SASS and "
          "registers", flush=True)
    check_bf16_mma_ragged(torch, device, {
        "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL,
                                            symmetric=False), 1088),
        "g16_asym": (QuantSpec(fmt="int", bits=3, group_size=16, symmetric=False), 4096),
        "g128_sym": (QuantSpec(fmt="int", bits=3, group_size=128, symmetric=True), 4096)}, 18)
    slab_kernel_report(dm.W3)

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
    header(f"== phase 17: LUT kernels vs plain versions, BFP on the int kernels ({tol_a})")
    per_kernel_lut, gen, down = phase_lut_kernels(torch, device, 8, [
        (fp4, (None, 16), {"fp4_e2m1_g128_sym": fp_spec("fp4", 2, 1, group_size=128),
                           "fp4_e1m2_g64_sym": fp_spec("fp4", 1, 2, group_size=64)}),
        (fp8, (None,), {"fp8_e4m3_perchannel_asym": fp_spec("fp8", 4, 3, group_size=PER_CHANNEL,
                                                            symmetric=False),
                        "fp8_e3m4_g128_sym": fp_spec("fp8", 3, 4, group_size=128)})])
    per_kernel.update(per_kernel_lut)
    check_bfp_on_int_kernels(torch, down, gen, device)
    print("  -- lut4a16: ranges whose last part ends early, groups off the 32-row window, "
          "groups straddling the K halves; SASS and registers", flush=True)
    check_slab_ragged(torch, device, {
        "fp4_e2m1_perchannel_asym_k1088": (fp_spec("fp4", 2, 1, group_size=PER_CHANNEL,
                                                   symmetric=False), 1088),
        "fp4_e2m1_g16_sym": (fp_spec("fp4", 2, 1, group_size=16), 4096),
        "fp4_e2m1_g128_asym_k1408_straddle": (fp4, 1408)}, 14)
    slab_kernel_report(dm.LUT4A16)
    print("  -- lut4 bf16 route: ranges whose last part ends early, groups off the 32-row "
          "window, groups straddling the K halves, E1M2, x copied; SASS and registers",
          flush=True)
    check_bf16_mma_ragged(torch, device, {
        "fp4_e2m1_perchannel_asym_k1088": (fp_spec("fp4", 2, 1, group_size=PER_CHANNEL,
                                                   symmetric=False), 1088),
        "fp4_e2m1_g16_sym": (fp_spec("fp4", 2, 1, group_size=16), 4096),
        "fp4_e1m2_g64_sym": (fp_spec("fp4", 1, 2, group_size=64), 4096),
        "fp4_e2m1_g128_asym_k1408_straddle": (fp4, 1408)}, 15)
    slab_kernel_report(dm.LUT4)
    print("  -- lut8 bf16 route: ranges whose last part ends early, E3M4, E2M5, x copied; "
          "SASS and registers", flush=True)
    check_bf16_mma_ragged(torch, device, {
        "fp8_e4m3_g128_sym": (fp8, 4096),
        "fp8_e4m3_perchannel_asym_k1088": (fp_spec("fp8", 4, 3, group_size=PER_CHANNEL,
                                                   symmetric=False), 1088),
        "fp8_e3m4_g128_sym": (fp_spec("fp8", 3, 4, group_size=128), 4096),
        "fp8_e2m5_g128_asym": (fp_spec("fp8", 2, 5, group_size=128, symmetric=False), 4096)},
        23)
    slab_kernel_report(dm.LUT8)

    header("== phase 18: fp4 (also A16) and fp8 two-layer 7B-width logits, kernels vs "
           "plain path")
    phase_two_layers(torch, device, fp4, cfg, abits_list=(None, 16))
    phase_two_layers(torch, device, fp8, cfg)

    header(f"== phase 19: {CUT_LAYERS}-layer 7B-width fp4 generate, serve, and serve with A16 "
           "waves and decode")
    res_fp4, serve_fp4, params_fp4 = phase_generate(
        torch, device, fp4, cfg_cut, card, names=(dm.LUT4, dm.LUT4), label="FP4",
        serve_runs=SERVE_RUNS)
    print("  -- FP4 serve, A16 waves, A16 decode", flush=True)
    serve_fp4_a = phase_serve(torch, params_fp4, cfg_cut, (dm.LUT4A16, dm.LUT4A16), SERVE_RUNS,
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
    print("  -- lut6a16: groups and slabs off the 32-row window, E1M4; SASS and registers",
          flush=True)
    check_slab_ragged(torch, device, {
        "fp6_e2m3_perchannel_asym_k1088": (fp_spec("fp6", 2, 3, group_size=PER_CHANNEL,
                                                   symmetric=False), 1088),
        "fp6_e2m3_g16_sym": (fp_spec("fp6", 2, 3, group_size=16), 4096),
        "fp6_e1m4_g128_asym": (fp_spec("fp6", 1, 4, group_size=128, symmetric=False), 4096)},
        12)
    slab_kernel_report(dm.LUT6A16)
    print("  -- lut6 bf16 route: groups and slabs off the 32-row window, E1M4, E3M2, x copied; "
          "SASS and registers", flush=True)
    check_bf16_mma_ragged(torch, device, {
        "fp6_e2m3_perchannel_asym_k1088": (fp_spec("fp6", 2, 3, group_size=PER_CHANNEL,
                                                   symmetric=False), 1088),
        "fp6_e2m3_g16_sym": (fp_spec("fp6", 2, 3, group_size=16), 4096),
        "fp6_e1m4_g128_asym": (fp_spec("fp6", 1, 4, group_size=128, symmetric=False), 4096),
        "fp6_e3m2_g128_asym": (e3m2, 4096)}, 16)
    slab_kernel_report(dm.LUT6)

    header("== phase 22: fp6 two-layer 7B-width logits (also A16), kernels vs plain path")
    phase_two_layers(torch, device, fp6, cfg, abits_list=(None, 16), pad_k_to=FP6_PAD_K)

    header(f"== phase 23: {CUT_LAYERS}-layer 7B-width fp6 generate, serve, and serve with A16 "
           "waves and decode")
    res_fp6, serve_fp6, params_fp6 = phase_generate(
        torch, device, fp6, cfg_cut, card, names=(dm.LUT6, dm.LUT6), label="FP6",
        pad_k_to=FP6_PAD_K, serve_runs=SERVE_RUNS)
    print("  -- FP6 serve, A16 waves, A16 decode", flush=True)
    serve_fp6_a = phase_serve(torch, params_fp6, cfg_cut, (dm.LUT6A16, dm.LUT6A16), SERVE_RUNS,
                              card, abits=(16, 16))
    del params_fp6
    torch.cuda.empty_cache()

    header(f"== phase 24: W4 inner-loop probes ({tol_a})")
    per_kernel_inner, _, probe_counts = phase_w4_inner(torch, device, w4)
    per_kernel.update(per_kernel_inner)

    header(f"== phase 26: {GPTQ_LAYERS}-layer 7B-width GPTQ W4 calibration through the block "
           "kernel, the kernel vs the plain loop, perplexity, generate and serve")
    gptq = phase_gptq(torch, device, cfg, card)

    header("== phase 25: report")
    names_of = lambda run, names: {k: v for k, v in run["launches"].items()  # noqa: E731
                                   if k in names}
    # stacked launches of the scan main paths: the W4 scan generate, the W8
    # scan serves (the flat main paths launch none)
    stacked = {k: 0 for k in dm.LAUNCHES}
    for run, names in ((scan_w4["generate"], (dm.W4, dm.W4_PRENORM)),
                       (serve_w8_scan, (dm.W8, dm.W8_PRENORM)),
                       (serve_w8_scan_a, (dm.W8A16, dm.W8A8))):
        stacked.update({k: run["stacked_launches"][k] for k in names})
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
    rows = kernel_rows(per_kernel, launches, stacked) + [gptq["block_row"]]
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    def report(key, run, drop=()):
        drop += ("tokens", "prompts")
        print(json.dumps({key: {k: v for k, v in run.items() if k not in drop}}))

    report("generate", res, ("launches",))
    report("serve_w4", serve_w4)
    report("serve_w8", serve_w8)
    report("serve_w4_a8_waves_a16_decode", serve_w4_a)
    for label, run in serve_kv.items():
        report(f"serve_w4_{label}", run)
    report("generate_w4_long_context", long_gen)
    report("cli", cli)
    print(json.dumps({"kv_codec_bit_equal_calls": kv_codec_checks}))
    report("generate_w4_scan", scan_w4["generate"])
    for side in ("scan", "flat"):
        report(f"serve_w4_{side}_in_turns", scan_w4["serve_ab"][side])
    report("serve_w4_scan_kv8", scan_w4["serve_kv8"])
    report("graphs_generate_w4", graphs_ab["generate"])
    for key in ("serve", "serve_scan", "serve_paged_kv8"):
        for side in ("graphed", "eager"):
            report(f"graphs_{key}_w4_{side}", graphs_ab[key][side])
        print(json.dumps({f"graphs_{key}_w4_graphed_over_eager":
                          graphs_ab[key]["graphed_over_eager"]}))
    print(json.dumps({"logits_w4_scan_vs_flat": scan_w4["logits_scan_vs_flat"],
                      "serve_w4_scan_over_flat": scan_w4["serve_ab"]["scan_over_flat"]}))
    report("serve_w8_a16_waves_a8_decode", serve_w8_a)
    report("serve_w8_scan", serve_w8_scan)
    report("serve_w8_scan_a16_waves_a8_decode", serve_w8_scan_a)
    for family, fam_res in (("opt", opt_res), ("bloom", bloom_res)):
        print(json.dumps({f"logits_{family}": fam_res["logits"],
                          f"build_s_{family}": fam_res["build_s"]}))
        for path in ("flat", "scan"):
            report(f"generate_{family}_{path}", fam_res[f"generate_{path}"])
            report(f"serve_{family}_{path}_in_turns", fam_res["serve_ab"][path])
        print(json.dumps({f"serve_{family}_scan_over_flat":
                          fam_res["serve_ab"]["scan_over_flat"]}))
    report("generate_w3", res_w3, ("launches",))
    report("serve_w3", serve_w3)
    report("serve_w3_a8_waves_a16_decode", serve_w3_a)
    print(json.dumps({"row_pass_bit_equal_calls": row_pass_checks}))
    report("generate_fp4", res_fp4, ("launches",))
    report("serve_fp4", serve_fp4)
    report("serve_fp4_a16", serve_fp4_a)
    report("serve_fp8", serve_fp8)
    report("generate_fp6", res_fp6, ("launches",))
    report("serve_fp6", serve_fp6)
    report("serve_fp6_a16", serve_fp6_a)
    print(json.dumps({"route": route, "zoo_bytes_equal_artifacts": zoo_checks}))
    print(json.dumps({"tp_d1": {"logits": tp_one["logits"], "prepare_s": tp_one["prepare_s"]}}))
    report("generate_w4_tp_d1", tp_one["generate"], ("launches",))
    report("serve_w4_tp_d1", tp_one["serve"])
    report("generate_w4_tp_d1_scan", tp_one["scan_generate"], ("launches",))
    report("tp_two_ranks", tp_two)
    report("gptq_w4", {k: v for k, v in gptq.items()
                       if k not in ("generate", "serve", "block_row")})
    report("generate_gptq_w4", gptq["generate"], ("launches",))
    report("serve_gptq_w4", gptq["serve"])
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
