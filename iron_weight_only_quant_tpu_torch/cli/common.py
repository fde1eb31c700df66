"""Shared CLI plumbing (port of ``cli/common.py``): spec construction, the
device, and model loading."""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import torch

from ..config import PER_CHANNEL, PER_TENSOR, AlignSpec, QuantSpec, fp_spec
from ..device import resolve_device


def add_quant_args(p: argparse.ArgumentParser) -> None:
    """The reference CLI's quantization surface (main.py:153-178), typed."""
    p.add_argument("--w_bits", nargs="+", type=int, default=[4],
                   help="bit-widths to run (16 = no quantization)")
    p.add_argument("--w_format", default="int",
                   choices=["int", "fp4", "fp6", "fp8", "bfp", "fp4_e1m2"])
    p.add_argument("--w_group_size", type=int, default=128,
                   help="-1 per-tensor, -2 per-channel, >0 per-group")
    p.add_argument("--w_symmetric", action="store_true")
    p.add_argument("--quant_dim", type=int, default=0, choices=[0, 1])
    p.add_argument("--approximate", action="store_true")
    p.add_argument("--double_approximate", action="store_true")
    p.add_argument("--fp_exp_bits", type=int, default=None,
                   help="minifloat exponent bits (defaults per format)")
    p.add_argument("--fp_mantissa_bits", type=int, default=None)
    p.add_argument("--hi_align_start", type=int, default=None)
    p.add_argument("--hi_align_exp_field", type=int, default=None)
    p.add_argument("--tail_pad_bits", type=int, default=None)
    # GPTQ
    p.add_argument("--gptq", action="store_true")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--act_order", action="store_true")
    p.add_argument("--trits", action="store_true",
                   help="ternary {min,0,max} GPTQ grid (reference quant.py:33)")
    p.add_argument("--true_sequential", action="store_true")
    p.add_argument("--mse", action="store_true",
                   help="GPTQ grid-shrink scale search")
    p.add_argument("--calib_dataset", default="wikitext2")
    # TrueOBS variant (reference zeroShot/models/fast_trueobs.py)
    p.add_argument("--solver", default="gptq", choices=["gptq", "trueobs"])
    p.add_argument("--sparseout", action="store_true",
                   help="TrueOBS: keep high-error weights at fp (sparse outliers)")
    p.add_argument("--nearest", action="store_true",
                   help="TrueOBS: skip Hessian error propagation")


_DEFAULT_EM = {"fp4": (2, 1), "fp6": (3, 2), "fp8": (4, 3)}


def spec_from_args(args, w_bit: int) -> QuantSpec:
    align = None
    if args.hi_align_start is not None:
        align = AlignSpec(
            hi_align_start=args.hi_align_start,
            hi_align_exp_field=args.hi_align_exp_field,
            tail_pad_bits=args.tail_pad_bits or 0,
        )
    common = dict(
        group_size=args.w_group_size,
        symmetric=args.w_symmetric,
        quant_axis=args.quant_dim,
        approximate=args.approximate,
        double_approximate=args.double_approximate,
        align=align,
    )
    if args.w_format == "int":
        return QuantSpec(fmt="int", bits=w_bit, **common)
    if args.w_format == "bfp":
        return QuantSpec(fmt="bfp", bits=w_bit, **common)
    if args.w_format == "fp4_e1m2":
        return QuantSpec(fmt="fp4_e1m2", bits=4, **common)
    e, m = _DEFAULT_EM[args.w_format]
    if args.fp_exp_bits is not None:
        e = args.fp_exp_bits
    if args.fp_mantissa_bits is not None:
        m = args.fp_mantissa_bits
    return fp_spec(args.w_format, e, m, **common)


def granularity_name(group_size: int) -> str:
    if group_size == PER_TENSOR:
        return "tensor"
    if group_size == PER_CHANNEL:
        return "channel"
    return f"group{group_size}"


def load_model(args, device=None) -> Tuple[str, object, dict, object]:
    """(family, cfg, params, forward) from --artifact, --model_path, or
    --demo, with params on ``device`` (default: :func:`apply_platform`)."""
    from ..models import bloom_forward, llama_forward, opt_forward

    device = apply_platform(args) if device is None else resolve_device(device)
    forwards = {"llama": llama_forward, "opt": opt_forward, "bloom": bloom_forward}
    if getattr(args, "artifact", None):
        from ..quantize.artifact import load_artifact

        family, cfg, params = load_artifact(args.artifact, device=device)
        return family, cfg, params, forwards[family]
    if getattr(args, "model_path", None):
        from ..models.convert_hf import load_checkpoint_dir

        cfg, params, fwd = load_checkpoint_dir(args.model_path, device=device)
        family = json.loads(
            (Path(args.model_path) / "config.json").read_text()
        )["model_type"]
        return family, cfg, params, fwd
    # demo: tiny random llama, drawn from a seeded generator on the device
    # (the port's own numbers, not the JAX package's PRNG bits)
    from ..models import LlamaConfig, llama_init

    cfg = LlamaConfig.tiny(vocab_size=512)
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama_init(cfg, gen, device=device)
    return "llama", cfg, params, llama_forward


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_path", default=None, help="HF checkpoint dir (safetensors)")
    p.add_argument("--artifact", default=None, help="saved quantized artifact dir")
    p.add_argument("--demo", action="store_true", help="tiny random model")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="device to run on; by default the current CUDA card "
                        "(with no GPU present the command raises: pass "
                        "--platform cpu for the plain PyTorch path)")


def apply_platform(args) -> torch.device:
    """The device of a CLI run: ``--platform`` (``cpu`` or ``cuda``), else
    the current CUDA card.  Every CLI main() calls it first, so a run with
    no GPU and no ``--platform cpu`` raises before it loads anything."""
    return resolve_device(getattr(args, "platform", None))
