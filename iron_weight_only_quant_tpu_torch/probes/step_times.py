"""Decode-step and prefill sums of the int-activation kernels and of the W4
inner-loop probe kernel's tensor-core routes of a source tree, on the
card: the A/B harness of kernel redesigns.

    python3 iron_weight_only_quant_tpu_torch/probes/step_times.py \
        [--tree DIR] [--label NAME] [--kernels w8a8_matmul w3a8_matmul] \
        [--ms 8 64 128 256]

Runs as a file, not as a module: it imports ``chip_smoke.py`` and the
port's package from ``--tree`` (default: the checkout that holds this
file), so a parent commit unpacked into a directory (``git archive``) or
a variant of the tree is timed with its own code.  Run each tree in a
process of its own (two copies of one library in a process break
launches), interleaved: parent, change, change, parent.

For each kernel (``w4a8``, ``w4a16``, ``w8a8``, ``w8a16``, ``w3a8``,
``w3a16``; ``w4_inner_magic`` and ``w4_inner_f32``, the probe kernel's two
modes with bf16 x, every shape flat) it builds the five LLaMA-2-7B
main-path artifacts of
``chip_smoke.py`` (g128 asymmetric; 3-bit with ``pad_k_to=1024``), and at
each row count of ``--ms`` checks one call against the plain version
(bf16 x, ``max|y - y_ref| / max|y_ref| <= 1e-2``) and times it with CUDA
events over artifact copies that the L2 cache does not hold
(``device_ms``, ``copies_for``).  qkv and gate_up take the pre-norm where
``chip_smoke.py`` times them so (W4 and W8).  Prints a line per call and
one JSON line: per kernel and row count the sum of the five shapes'
times weighted by their launches a decode step (``chip_smoke.MAIN_SHAPES``),
the sum ``chip_smoke.py``'s ``kernels`` line reports as ``ms`` (M = 8) and
``prefill_ms`` (M = 256).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# kernel -> (storage bits, pad_k_to, pre-norm on qkv and gate_up)
KERNELS = {"w4a8_matmul": (4, 1, True), "w4a16_matmul": (4, 1, True),
           "w8a8_matmul": (8, 1, True), "w8a16_matmul": (8, 1, True),
           "w3a8_matmul": (3, 1024, False), "w3a16_matmul": (3, 1024, False)}
# the probe kernel's modes (ops/kernels/w4_inner.py), by launch counter name
INNER = {"w4_inner_magic": "magic", "w4_inner_f32": "f32"}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=here, help="root of the source tree to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--kernels", nargs="+", default=["w8a8_matmul", "w3a8_matmul"],
                    choices=sorted(KERNELS) + sorted(INNER))
    ap.add_argument("--ms", nargs="+", type=int, default=[8, 64, 128, 256])
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("step_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from iron_weight_only_quant_tpu_torch.config import QuantSpec
    from iron_weight_only_quant_tpu_torch.ops.kernels import build as kbuild
    from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import (
        w4_inner_matmul,
        w4_inner_plain,
    )
    from iron_weight_only_quant_tpu_torch.utils.timing import copies_for, device_ms

    if not os.path.abspath(dm.__file__).startswith(tree + os.sep):
        print(f"step_times: imported {dm.__file__}, not the tree {tree}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    kbuild.build({"w4_inner_matmul" if k in INNER else k for k in args.kernels})
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    out = {"label": args.label, "tree": tree}
    for kname in args.kernels:
        bits, pad_k, use_pre = KERNELS.get(kname, (4, 1, False))
        abits = 8 if "a8" in kname else 16
        spec = QuantSpec(fmt="int", bits=bits, group_size=128, symmetric=False)
        steps = {m: 0.0 for m in args.ms}
        worst = 0.0
        for shape, k, widths, prenorm, per_step in cs.MAIN_SHAPES:
            qt = cs.make_artifact(torch, gen, spec, k, widths, device, pad_k_to=pad_k)[0]
            pre = 1e-5 if prenorm and use_pre else None
            if kname in INNER:
                mode = INNER[kname]
                ok = dm.kernel_name(qt) == dm.W4 and dm.bf16_mma_route(qt, torch.bfloat16)
                run = lambda x, qt, md=mode: w4_inner_matmul(x, qt, md)  # noqa: E731
                run_plain = lambda x, qt, md=mode: w4_inner_plain(x, qt, md)  # noqa: E731
            else:
                ok = dm.kernel_name(qt, pre, abits) == kname
                run, run_plain = cs.a_runner(pre, abits)
            if not ok:
                print(f"step_times: {shape} does not dispatch to {kname}", file=sys.stderr)
                return 1
            reps = copies_for(qt.qweight.numel())
            qts = [qt] + [qt.map_arrays(torch.clone) for _ in range(reps - 1)]
            for m in args.ms:
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                y, y_ref = run(x, qt).float(), run_plain(x, qt).float()
                rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
                worst = max(worst, rel)
                if not rel <= 1e-2:
                    print(f"step_times: {kname} {shape} M={m}: rel err {rel:.3e}",
                          file=sys.stderr)
                    return 1
                ms = device_ms(lambda i: run(x, qts[i % reps]), 20)
                steps[m] += ms * per_step
                print(f"{args.label} {kname} {shape} M={m}: {ms:.4f} ms, rel err {rel:.2e}",
                      flush=True)
            del qts, qt
            torch.cuda.empty_cache()
        out[kname] = {"step_ms": steps, "max_rel_err": worst}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
