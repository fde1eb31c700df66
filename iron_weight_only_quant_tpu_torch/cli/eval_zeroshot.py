"""Zero-shot task evaluation (the reference's lm_eval mode + zeroShot tree).

Example:
  python -m iron_weight_only_quant_tpu_torch.cli.eval_zeroshot \
      --model_path /ckpts/opt-6.7b --w_bits 4 --tasks piqa arc_easy boolq

The tasks read their documents through ``datasets``.  Without
``--model_path`` (and so without its tokenizer) words are tokenized by a
demo tokenizer that hashes each word with Python's ``hash``, which
``PYTHONHASHSEED`` salts per process: its token ids, and so its scores,
repeat only within one process.
"""

from __future__ import annotations

import argparse
import json

from ..evals.lm import EvalLM
from ..evals.zeroshot import evaluate, get_task, make_table
from ..utils import append_results
from .common import add_model_args, add_quant_args, apply_platform, load_model, spec_from_args


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    add_quant_args(ap)
    ap.add_argument("--tasks", nargs="+", default=["piqa"])
    ap.add_argument("--limit", type=int, default=None, help="docs per task")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    device = apply_platform(args)

    family, cfg, params, fwd = load_model(args, device)

    if args.model_path:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.model_path, use_fast=False)
        encode = lambda s: tok(s, add_special_tokens=False).input_ids  # noqa: E731
    else:
        encode = lambda s: [  # noqa: E731 (demo tokenizer, see the docstring)
            (hash(w) % (cfg.vocab_size - 2)) + 2 for w in s.split()
        ] or [1]

    all_results = {}
    for w_bit in args.w_bits:
        if w_bit >= 16:
            qparams = params
        else:
            from ..quantize.model_pass import quantize_model_params

            qparams, _ = quantize_model_params(params, spec_from_args(args, w_bit),
                                               device=device)
        lm = EvalLM(qparams, fwd, cfg, batch_size=args.batch_size)
        tasks = [get_task(t) for t in args.tasks]
        res = evaluate(lm, tasks, encode, limit=args.limit)
        all_results[f"w{w_bit}"] = res
        print(json.dumps(res, indent=2))
        print(make_table(res))

    if args.output:
        append_results(args.output, all_results)
    return all_results


if __name__ == "__main__":
    main()
