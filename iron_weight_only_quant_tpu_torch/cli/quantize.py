"""Quantize a checkpoint into a packed artifact (RTN or GPTQ).

RTN runs where the weights are: on the card by default, through the host
C++ library with ``--platform cpu``.

Example:
  python -m iron_weight_only_quant_tpu_torch.cli.quantize \
      --model_path /ckpts/llama-2-7b --w_bits 4 --w_group_size 128 \
      --pad_n 512 --out artifacts/llama7b-w4g128
  python -m iron_weight_only_quant_tpu_torch.cli.quantize --demo --gptq \
      --calib_dataset synthetic --out /tmp/demo-art --platform cpu
"""

from __future__ import annotations

import argparse

from ..config import GPTQConfig
from ..utils import Timer
from .common import add_model_args, add_quant_args, apply_platform, load_model, spec_from_args


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    add_quant_args(ap)
    ap.add_argument("--out", required=True, help="output artifact dir")
    ap.add_argument("--pad_n", type=int, default=1,
                    help="pad stored output dims to this multiple (512 gives "
                         "the kernels full-width tiles on shapes like 11008)")
    args = ap.parse_args(argv)
    device = apply_platform(args)

    family, cfg, params, _fwd = load_model(args, device)
    w_bit = args.w_bits[0]
    spec = spec_from_args(args, w_bit)

    with Timer() as t:
        if w_bit >= 16:
            qparams, report = params, {"n_quantized": 0}
        elif args.gptq:
            from ..data import get_loaders
            from ..quantize.gptq_model import quantize_model_gptq

            train, _ = get_loaders(
                args.calib_dataset, nsamples=args.nsamples, seed=0,
                seqlen=min(2048, cfg.max_position_embeddings
                           if hasattr(cfg, "max_position_embeddings") else 2048),
                model=args.model_path or "",
                vocab_size=cfg.vocab_size,
            )
            samples = [s.input_ids for s in train]
            qparams = quantize_model_gptq(
                params, cfg, family, samples, spec,
                GPTQConfig(nsamples=args.nsamples, percdamp=args.percdamp,
                           act_order=args.act_order, mse=args.mse, trits=args.trits,
                           calib_dataset=args.calib_dataset,
                           solver=args.solver, sparseout=args.sparseout,
                           nearest=args.nearest),
                true_sequential=args.true_sequential,
            )
            report = {"n_quantized": "gptq"}
        else:
            from ..quantize.model_pass import quantize_model_params
            from ..quantize.rtn import native_quantize_tensor, quantize_tensor

            used_native = [0]

            def qfn(w, path):
                # a weight in host memory goes through the host C++ library
                # (csrc/host/); one on the card is quantized there: the same
                # bytes, with no round trip through the host
                qt = (native_quantize_tensor(w, spec, pad_n_to=args.pad_n)
                      if w.device.type == "cpu" else None)
                if qt is None:
                    return quantize_tensor(w, spec, pad_n_to=args.pad_n)
                used_native[0] += 1
                return qt

            qparams, report = quantize_model_params(params, spec, quantize_fn=qfn,
                                                    device=device)
            report["n_native"] = used_native[0]

        from ..quantize.artifact import save_artifact

        save_artifact(args.out, family, cfg, qparams)

    native_note = (f", {report['n_native']} via native lib"
                   if report.get("n_native") else "")
    print(f"quantized {report.get('n_quantized')} linears "
          f"({spec.fmt}{spec.storage_bits} g{spec.group_size}"
          f"{' gptq' if args.gptq else ''}) in {t.spans['__total__']:.1f}s"
          f"{native_note} -> {args.out}")


if __name__ == "__main__":
    main()
