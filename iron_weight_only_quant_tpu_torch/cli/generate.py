"""Text generation / engine demo.

Example:
  python -m iron_weight_only_quant_tpu_torch.cli.generate --artifact artifacts/llama7b-w4g128 \
      --prompt "The capital of France is" --max_new_tokens 32
  python -m iron_weight_only_quant_tpu_torch.cli.generate --demo --platform cpu

Without ``--model_path`` (and so without its tokenizer) a prompt is a
string of token ids, ``--prompt "1 5 9 12"``.

``--data_parallel D --model_parallel M`` (D x M > 1) runs D x M ranks: the
command starts them on this host (one card each where there are enough,
else all on card 0 under gloo; ``--platform cpu``: CPU ranks under gloo),
or, with ``IWOQ_NUM_PROCESSES`` set, joins the group that a launcher
started (``IWOQ_COORDINATOR``, ``IWOQ_PROCESS_ID``; ``parallel.mesh.
multihost_init``).  Rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from ..config import EngineConfig, KVCacheConfig, MeshConfig
from ..engine import InferenceEngine
from .common import add_model_args, apply_platform, load_model


def main(argv=None):
    """Runs the command; returns the generated tokens, one list a prompt."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    world = args.data_parallel * args.model_parallel
    if world > 1:
        import torch
        import torch.distributed as dist

        from ..parallel.mesh import multihost_init, spawn_ranks

        if not dist.is_initialized():
            if int(os.environ.get("IWOQ_NUM_PROCESSES", "1")) > 1:
                multihost_init(platform=args.platform)
            else:
                apply_platform(args)  # no GPU and no --platform cpu: raises here
                with tempfile.TemporaryDirectory(prefix="iwoq_generate_") as tmp:
                    out = os.path.join(tmp, "outs.json")
                    spawn_ranks(_rank_main, world, (argv, out), platform=args.platform,
                                threads=max(1, torch.get_num_threads() // world))
                    with open(out) as f:
                        return json.load(f)
    return _run(args)


def _rank_main(rank, world, device, argv, out):
    """One rank of a run that ``main`` started; rank 0 writes the tokens."""
    outs = _run(_parser().parse_args(argv), device)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(outs, f)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    ap.add_argument("--prompt", nargs="+", default=None)
    ap.add_argument("--chat", action="store_true",
                    help="wrap prompts in the model family's chat template "
                         "(reference utils.py:65-77 format_chat_prompt)")
    ap.add_argument("--max_new_tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--max_seq_len", type=int, default=2048)
    ap.add_argument("--kv_bits", type=int, default=16)
    ap.add_argument("--kv_group_size", type=int, default=128)
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="data-parallel ranks: the prompts are split between them")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help="tensor-parallel ranks: each holds 1/M of every linear")
    ap.add_argument("--continuous", action="store_true", help="use serve() batching")
    ap.add_argument("--no_fuse", action="store_true",
                    help="disable fused qkv/gate_up serving artifacts (exact; "
                         "fewer, wider kernel launches when fused)")
    ap.add_argument("--no_tp_block", action="store_true",
                    help="accepted and ignored: the JAX CLI's switch to GSPMD "
                         "partitioning; the port has one tensor-parallel forward (rank per "
                         "shard, the kernels run on each shard) and runs it either way")
    ap.add_argument("--scan", action="store_true",
                    help="layer-stacked serving (stacked weights and caches, "
                         "the scan forwards)")
    return ap


def _run(args, device=None):
    import torch.distributed as dist

    device = apply_platform(args) if device is None else device
    family, cfg, params, fwd = load_model(args, device)
    if args.scan:
        from ..models.bloom import bloom_forward_scan
        from ..models.llama import llama_forward_scan
        from ..models.opt import opt_forward_scan

        fwd = {"llama": llama_forward_scan, "opt": opt_forward_scan,
               "bloom": bloom_forward_scan}[family]
        # flat params are stacked inside the engine (fusion first)
    ecfg = EngineConfig(
        mesh=MeshConfig(data=args.data_parallel, model=args.model_parallel),
        kv=KVCacheConfig(max_seq_len=min(args.max_seq_len,
                                         getattr(cfg, "max_position_embeddings", 4096)),
                         kv_bits=args.kv_bits, kv_group_size=args.kv_group_size),
        fuse_projections=not args.no_fuse and family == "llama",
    )
    engine = InferenceEngine(params, cfg, fwd, family=family, engine_cfg=ecfg, device=device)
    del params
    printer = not dist.is_initialized() or dist.get_rank() == 0

    tok = None
    if args.model_path:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.model_path, use_fast=False)

    if args.prompt and args.chat:
        from ..models.chat import format_chat_prompt

        args.prompt = [
            format_chat_prompt(p, args.model_path or family) for p in args.prompt
        ]
    if args.prompt and tok is not None:
        prompts = [tok(p).input_ids for p in args.prompt]
    elif args.prompt:
        prompts = [[int(t) for t in p.split()] for p in args.prompt]
    else:
        prompts = [[1, 5, 9, 12], [2, 8]]

    run = engine.serve if args.continuous else engine.generate
    outs = run(prompts, max_new_tokens=args.max_new_tokens,
               temperature=args.temperature, top_k=args.top_k)
    for p, o in zip(prompts, outs if printer else ()):
        if tok is not None:
            print(repr(tok.decode(o)))
        else:
            print(f"prompt {p} -> {o}")
    return outs


if __name__ == "__main__":
    main()
