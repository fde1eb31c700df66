"""Experiment sweep runner -- replaces the reference's 21 shell scripts
(scripts/**/*.sh, ~1,476 lines of CLI invocations).

A sweep file is JSON: {"name": ..., "base": [common args], "runs":
[{"name": ..., "args": [...]}, ...]}.  Each run invokes eval_ppl with
base+run args; results accumulate in one valid-JSON file.

Example sweep file (the reference's format-zoo study, condensed):

    {
      "base": ["--model_path", "/ckpts/llama-2-7b", "--datasets", "wikitext"],
      "runs": [
        {"name": "int4_g128",  "args": ["--w_bits", "4", "--w_group_size", "128"]},
        {"name": "fp4_e2m1",   "args": ["--w_bits", "4", "--w_format", "fp4"]},
        {"name": "bfp5_g128",  "args": ["--w_bits", "5", "--w_format", "bfp",
                                         "--w_group_size", "128"]},
        {"name": "fp8_approx", "args": ["--w_bits", "8", "--w_format", "fp8",
                                         "--approximate"]},
        {"name": "gptq_w4",    "args": ["--w_bits", "4", "--gptq"]}
      ]
    }

Each run takes the device eval_ppl takes (``--platform`` in its args).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ..utils import append_results
from . import eval_ppl


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sweep_file", help="JSON sweep description")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    sweep = json.loads(Path(args.sweep_file).read_text())
    base = sweep.get("base", [])
    out = args.output or sweep.get("output", "sweep_results.json")

    for run in sweep["runs"]:
        name = run["name"]
        print(f"\n===== sweep run: {name} =====")
        t0 = time.time()
        res = eval_ppl.main(base + run.get("args", []))
        append_results(out, {name: {"elapsed": time.time() - t0, "results": res}})
    print(f"\nsweep complete -> {out}")


if __name__ == "__main__":
    main()
