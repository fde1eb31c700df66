"""Quantize + perplexity sweep (the reference's ``main.py --eval_mode ppl``).

Example:
  python -m iron_weight_only_quant_tpu_torch.cli.eval_ppl --model_path /ckpts/llama-2-7b \
      --w_bits 16 8 4 --w_group_size 128 --datasets wikitext ptb c4 \
      --output All_results/llama7b.json
  python -m iron_weight_only_quant_tpu_torch.cli.eval_ppl --demo --datasets synthetic \
      --platform cpu
"""

from __future__ import annotations

import argparse
import time

from ..evals import SequentialPPLEvaluator
from ..utils import append_results
from .common import (
    add_model_args,
    add_quant_args,
    apply_platform,
    granularity_name,
    load_model,
    spec_from_args,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    add_quant_args(ap)
    ap.add_argument("--datasets", nargs="+", default=["wikitext", "ptb", "c4"])
    ap.add_argument("--ppl_seqlen", type=int, default=2048)
    ap.add_argument("--sample_size", type=int, default=None,
                    help="max chunks per dataset (None = all)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--output", default=None, help="results JSON path")
    ap.add_argument("--no_fuse", action="store_true",
                    help="disable fused qkv/gate_up packed artifacts during "
                         "evaluation (exact transform; fewer kernel launches)")
    args = ap.parse_args(argv)
    device = apply_platform(args)

    family, cfg, params, fwd = load_model(args, device)
    results = {}
    for w_bit in args.w_bits:
        name = f"w{w_bit}_{args.w_format}_{granularity_name(args.w_group_size)}"
        print(f"=== {name} ===")
        if w_bit >= 16:
            qparams = params
        else:
            spec = spec_from_args(args, w_bit)
            if args.gptq:
                from ..config import GPTQConfig
                from ..data import get_loaders
                from ..quantize.gptq_model import quantize_model_gptq

                train, _ = get_loaders(
                    args.calib_dataset, nsamples=args.nsamples, seed=0,
                    seqlen=args.ppl_seqlen, model=args.model_path or "",
                    vocab_size=cfg.vocab_size)
                qparams = quantize_model_gptq(
                    params, cfg, family, [s.input_ids for s in train], spec,
                    GPTQConfig(nsamples=args.nsamples, percdamp=args.percdamp,
                               act_order=args.act_order, mse=args.mse, trits=args.trits,
                               solver=args.solver, sparseout=args.sparseout,
                               nearest=args.nearest),
                    true_sequential=args.true_sequential)
            else:
                from ..quantize.model_pass import quantize_model_params

                qparams, _ = quantize_model_params(params, spec, device=device)

        if family == "llama" and not args.no_fuse:
            # column-exact concat of packed projections (no-op on dense w16
            # params); fewer kernel launches per block.  Wider matmuls can
            # reorder f32 accumulation at ulp level (~1e-7 PPL)
            from ..models.llama import fuse_llama_projections

            qparams = fuse_llama_projections(qparams)

        ev = SequentialPPLEvaluator(
            qparams, fwd, cfg, model_path=args.model_path or "",
            seqlen=args.ppl_seqlen, batch_size=args.batch_size,
            vocab_size=cfg.vocab_size)
        entry = {"quant_args": {"w_bit": w_bit, "format": args.w_format,
                                "group_size": args.w_group_size,
                                "symmetric": args.w_symmetric,
                                "gptq": args.gptq,
                                # fused projections reorder f32 accumulation at
                                # ulp level; reference-parity tables (per-
                                # projection matmuls, as the reference runs)
                                # should use --no_fuse -- recorded here so
                                # published numbers carry their provenance
                                "fused_projections": family == "llama"
                                and not args.no_fuse},
                 "datasets": {}}
        for ds in args.datasets:
            t0 = time.time()
            ppl, ntok, nchunk = ev.calculate_ppl(ds, max_chunks=args.sample_size)
            entry["datasets"][ds] = {
                "perplexity": ppl, "num_tokens": ntok, "num_chunks": nchunk,
                "eval_time": time.time() - t0,
            }
            print(f"  {ds}: chunks={nchunk} tokens={ntok} ppl={ppl:.4f} "
                  f"({entry['datasets'][ds]['eval_time']:.1f}s)")
        results[name] = entry

    if args.output:
        append_results(args.output, results)
        print(f"results -> {args.output}")
    return results


if __name__ == "__main__":
    main()
