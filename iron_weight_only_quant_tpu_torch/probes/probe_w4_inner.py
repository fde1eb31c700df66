"""W4 inner-loop probe: two cheaper decodes of the W4 artifact beside the
base kernel and the int-activation kernels, at 7B decode shapes.

Counterpart of the JAX package's ``scripts/probe_w4_inner.py``.  Run on
the card (``--device cpu`` runs the plain versions, with host-clock times):

    python -m iron_weight_only_quant_tpu_torch.probes.probe_w4_inner
    python -m iron_weight_only_quant_tpu_torch.probes.probe_w4_inner \\
        --device cpu --shapes 256x128

Variants, on one ``QuantSpec(int, 4, 128, asym)`` artifact per shape:

  base   ``w4_matmul``: codes converted and dequantized per element
  f32    ``w4_inner_matmul(mode="f32")``: int -> float converts, the
         factored group form (scales, zeros and activation sums once per
         group)
  magic  ``w4_inner_matmul(mode="magic")``: the bf16 bias-trick decode, no
         arithmetic convert, the same factored form
  w4a8   ``activation_bits=8`` (``w4a8_matmul``, raw codes in ``__dp4a``;
         no error check: its activations are quantized)
  a16    ``activation_bits=16`` (``w4a16_matmul``)

One line per shape and variant: time, GB/s over ``k*n/2 +
scales.size*8 + m*k*2 + m*n*2`` bytes, the share of :class:`Roofline`'s
bound, the max relative error against ``base``, and ``torch.matmul`` on the
pre-dequantized bf16 weight as a yardstick (never used by the port); then
one JSON line.  The variants are interleaved over ``--rounds`` rounds and
each keeps its minimum.  On the card each timed call rotates
``copies_for`` distinct artifacts, so that the 50 MB L2 holds none of
them between calls, as the layers of a decode step find it; the times are
CUDA-event device times (``utils.timing.device_ms``), printed with the
card's name and power limit and with static SASS instruction counts of the
partial-product kernels of ``w4_inner_matmul`` and ``w4_matmul``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import QuantSpec
from ..device import resolve_device
from ..ops.kernels import dequant_matmul as dm
from ..ops.kernels.w4_inner import w4_inner_matmul
from ..ops.qmatmul import dequantize_weight
from ..quantize import quantize_tensor
from ..utils.profiling import Roofline, card_line
from ..utils.timing import copies_for, device_ms, host_ms

SHAPES = ((4096, 4096), (4096, 11264), (11008, 4096))
SPEC = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
M = 8
ROUNDS = 4
ITERS = 20
# tag: (kernel's launch counter, call, checked against the reference)
VARIANTS: Dict[str, Tuple[str, Callable, bool]] = {
    "base": (dm.W4, lambda x, qt: dm.fused_quantized_matmul(x, qt), True),
    "f32": (dm.W4_INNER_F32, lambda x, qt: w4_inner_matmul(x, qt, "f32"), True),
    "magic": (dm.W4_INNER_MAGIC, lambda x, qt: w4_inner_matmul(x, qt, "magic"), True),
    "w4a8": (dm.W4A8, lambda x, qt: dm.fused_quantized_matmul(x, qt, activation_bits=8),
             False),
    "a16": (dm.W4A16, lambda x, qt: dm.fused_quantized_matmul(x, qt, activation_bits=16),
            True),
}
REFERENCE = "base"  # the variant the errors are taken against
# opcodes counted in the SASS of each kernel (the decode and the product)
SASS_OPS = ("I2F", "I2FP", "F2F", "FFMA", "FMUL", "FADD", "LOP3", "SHF", "PRMT",
            "IMAD", "IDP", "LDS", "LDG")


def sass_counts(text: str) -> Dict[str, Dict[str, int]]:
    """Static instruction counts of each partial-product kernel in
    ``cuobjdump -sass`` output, by demangled-enough name: the opcodes of
    ``SASS_OPS`` (any suffix) and the total."""
    out: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts = None
            if "partial_kernel" in name:
                mode = ("magic" if "ILb1E" in name else "f32") if "inner" in name else "base"
                xt = "bf16" if "bfloat16" in name else "f32x"
                counts = out.setdefault(f"{mode}/{xt}", {op: 0 for op in SASS_OPS + ("total",)})
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if counts is not None and op:
            counts["total"] += 1
            if op.group(1) in counts:
                counts[op.group(1)] += 1
    return out


def parse_shapes(text: str) -> Tuple[Tuple[int, int], ...]:
    """``"4096x4096,11008x4096"`` -> ``((4096, 4096), (11008, 4096))``."""
    return tuple(tuple(int(v) for v in s.split("x")) for s in text.split(","))


def run(device=None, shapes: Sequence[Tuple[int, int]] = SHAPES, m: int = M,
        rounds: int = ROUNDS, iters: int = ITERS, seed: int = 0,
        out=print) -> dict:
    """Run the probe; prints its lines through ``out`` and returns what the
    JSON line holds."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    timer = device_ms if on_card else host_ms
    roof = Roofline()
    rng = np.random.default_rng(seed)
    res: dict = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
                 "clock": "cuda events (device)" if on_card else "host (plain versions)",
                 "m": m, "rounds": rounds, "iters": iters, "spec": "int4 g128 asym",
                 "shapes": []}
    if on_card:
        res["card"] = card_line()
        out(f"card: {res['card']}")
        res["sass"] = _sass()
        for kern, counts in sorted(res["sass"].items()):
            out(f"sass {kern:11s}: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    for k, n in shapes:
        w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.02).to(dev)
        qt = quantize_tensor(w, SPEC)
        del w
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
        x = x.to(torch.bfloat16)
        weight_bytes = k * n / 2 + qt.scales.numel() * 8
        nbytes = weight_bytes + m * k * 2 + m * n * 2
        bound_s = roof.matmul_time_floor(m, k, n, weight_bytes)
        ref = VARIANTS[REFERENCE][1](x, qt).float()
        errs = {}
        for tag, (_, fn, check) in VARIANTS.items():
            errs[tag] = ((fn(x, qt).float() - ref).abs().max()
                         / (ref.abs().max() + 1e-9)).item() if check else math.nan
        art_bytes = qt.qweight.numel() + (qt.scales.numel() + qt.zeros.numel()) * 4
        reps = copies_for(art_bytes) if on_card else 1
        qts = [qt] + [qt.map_arrays(torch.clone) for _ in range(reps - 1)]
        w_lib = dequantize_weight(qt, torch.bfloat16)
        lib_reps = copies_for(w_lib.numel() * 2) if on_card else 1
        ws = [w_lib] + [w_lib.clone() for _ in range(lib_reps - 1)]
        best = {tag: math.inf for tag in list(VARIANTS) + ["matmul"]}
        for _ in range(rounds):
            for tag, (_, fn, _) in VARIANTS.items():
                best[tag] = min(best[tag], timer(lambda i: fn(x, qts[i % reps]), iters))
            best["matmul"] = min(best["matmul"],
                                 timer(lambda i: torch.matmul(x, ws[i % lib_reps]), iters))
        shape = {"k": k, "n": n, "bytes": nbytes, "bound_us": bound_s * 1e6,
                 "copies": reps, "matmul_us": best["matmul"] * 1e3, "variants": {}}
        for tag in VARIANTS:
            t_s = best[tag] / 1e3
            rec = {"us": t_s * 1e6, "gbps": nbytes / t_s / 1e9,
                   "share": roof.fraction(t_s, m, k, n, weight_bytes), "maxrel": errs[tag]}
            shape["variants"][tag] = rec
            out(f"{k}x{n} {tag:6s}: {rec['us']:8.1f}us {rec['gbps']:7.1f} GB/s "
                f"{100 * rec['share']:5.1f}% of bound  maxrel={rec['maxrel']:.2e}  "
                f"matmul(bf16) {shape['matmul_us']:.1f}us")
        res["shapes"].append(shape)
        del qts, ws, qt, w_lib
        if on_card:
            torch.cuda.empty_cache()
    return res


def _sass() -> Dict[str, Dict[str, int]]:
    from ..ops.kernels import build

    counts = sass_counts(build.sass("w4_inner_matmul"))
    counts.update(sass_counts(build.sass(dm.W4)))
    return counts


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--shapes", type=parse_shapes, default=SHAPES,
                    help="comma-separated KxN weight shapes (default: %(default)s)")
    args = ap.parse_args(argv)
    res = run(args.device, args.shapes)
    print(json.dumps({"probe_w4_inner": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
