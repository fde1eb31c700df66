"""Port parity: the command-line tools, against the JAX package's CLI.

A dense tiny LLaMA source artifact is made once by the JAX CLI (``quantize
--demo --w_bits 16``); from it, on the CPU (``--platform cpu``):

* ``quantize`` writes byte-equal artifacts (``params.npz`` and
  ``manifest.json``) for int4 with padded output columns (the port's host
  library; the JAX side with ``--no_native``, whose ``make`` races between
  test workers) and fp8, and the same summary line;
* ``eval_ppl`` gives each sweep entry's perplexity within rel 2e-3 (token
  and chunk counts and the recorded arguments equal), in equal JSON files;
* ``generate`` prints the same tokens (``generate`` and ``--continuous``
  ``serve``, also on the scan path with an int8 KV cache);
* ``eval_zeroshot``, with ``tasks._load`` replaced on both sides by the
  same local documents, gives equal accuracies;
* ``sweep`` writes the same JSON (times aside);
* GPTQ through the port's CLI writes the bytes of ``quantize_model_gptq``
  called directly (the JAX GPTQ CLI is not run: its solver's compiles
  dominate);
* with no ``--platform`` on a machine without a GPU every command raises;
* ``--data_parallel 2`` and ``--model_parallel 2`` run two CPU ranks that
  print the one-process tokens, and ``--no_tp_block`` is accepted.
"""

import json
import re

import pytest
import torch

from iron_weight_only_quant_tpu.cli import eval_ppl as j_eval_ppl
from iron_weight_only_quant_tpu.cli import eval_zeroshot as j_eval_zeroshot
from iron_weight_only_quant_tpu.cli import generate as j_generate
from iron_weight_only_quant_tpu.cli import quantize as j_quantize
from iron_weight_only_quant_tpu.cli import sweep as j_sweep
from iron_weight_only_quant_tpu.evals.zeroshot import tasks as j_tasks
from iron_weight_only_quant_tpu.utils import append_results as j_append_results
from iron_weight_only_quant_tpu_torch.cli import eval_ppl as t_eval_ppl
from iron_weight_only_quant_tpu_torch.cli import eval_zeroshot as t_eval_zeroshot
from iron_weight_only_quant_tpu_torch.cli import generate as t_generate
from iron_weight_only_quant_tpu_torch.cli import quantize as t_quantize
from iron_weight_only_quant_tpu_torch.cli import sweep as t_sweep
from iron_weight_only_quant_tpu_torch.evals.zeroshot import tasks as t_tasks
from iron_weight_only_quant_tpu_torch.utils import append_results, read_results

CPU = ["--platform", "cpu"]
PPL_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """The JAX CLI's dense tiny demo LLaMA (f32), saved by the JAX package.

    ``quantize --demo --w_bits 16`` would write it, but the JAX CLI builds
    a 16-bit int spec before its ``w_bit >= 16`` branch and refuses it (as
    the port's, which keeps that behaviour)."""
    from iron_weight_only_quant_tpu.cli.common import load_model
    from iron_weight_only_quant_tpu.quantize.artifact import save_artifact

    path = str(tmp_path_factory.mktemp("cli") / "src")
    family, cfg, params, _ = load_model(type("Args", (), {"demo": True})())
    save_artifact(path, family, cfg, params)
    return path


@pytest.mark.parametrize("mod", [j_quantize, t_quantize], ids=["jax", "port"])
def test_quantize_refuses_w16_as_jax(mod, tmp_path):
    with pytest.raises(ValueError, match="2..15 bits"):
        mod.main(["--demo", "--w_bits", "16", "--out", str(tmp_path / "a")] + CPU)


@pytest.fixture(scope="module")
def int4(src, tmp_path_factory):
    """The W4 g32 artifact of ``src``, written by the port's CLI."""
    path = str(tmp_path_factory.mktemp("cli") / "int4")
    t_quantize.main(["--artifact", src, "--w_bits", "4", "--w_group_size", "32",
                     "--out", path] + CPU)
    return path


def _files(path):
    return {f: open(f"{path}/{f}", "rb").read() for f in ("params.npz", "manifest.json")}


def _summary(out):
    return re.sub(r"in [0-9.]+s", "in Ts", out.strip().splitlines()[-1])


# int8 and the other int4 layouts through the host library are held to the
# JAX quantizer tensor by tensor in tests/test_torch_native.py
@pytest.mark.parametrize("args", [
    ["--w_bits", "4", "--w_group_size", "32", "--pad_n", "48"],
    ["--w_bits", "8", "--w_format", "fp8", "--w_group_size", "32"],
], ids=["int4_pad48", "fp8"])
def test_quantize_writes_jax_bytes(src, tmp_path, capsys, args):
    j_quantize.main(["--artifact", src, "--out", str(tmp_path / "j"), "--no_native"]
                    + args + CPU)
    j_line = _summary(capsys.readouterr().out)
    t_quantize.main(["--artifact", src, "--out", str(tmp_path / "t")] + args + CPU)
    t_line = _summary(capsys.readouterr().out)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    native = args[1] in ("4", "8") and "fp8" not in args
    assert t_line == (j_line.replace(f" -> {tmp_path}/j", ", 14 via native lib -> "
                                     f"{tmp_path}/t") if native else
                      j_line.replace(f"{tmp_path}/j", f"{tmp_path}/t"))


def test_gptq_cli_writes_the_bytes_of_quantize_model_gptq(src, tmp_path):
    from iron_weight_only_quant_tpu_torch.config import GPTQConfig, QuantSpec
    from iron_weight_only_quant_tpu_torch.data import get_loaders
    from iron_weight_only_quant_tpu_torch.quantize.artifact import load_artifact, save_artifact
    from iron_weight_only_quant_tpu_torch.quantize.gptq_model import quantize_model_gptq

    t_quantize.main(["--artifact", src, "--out", str(tmp_path / "cli"), "--gptq", "--w_bits",
                     "4", "--w_group_size", "32", "--nsamples", "2", "--calib_dataset",
                     "synthetic"] + CPU)
    family, cfg, params = load_artifact(src, device="cpu")
    train, _ = get_loaders("synthetic", nsamples=2, seed=0, seqlen=cfg.max_position_embeddings,
                           vocab_size=cfg.vocab_size)
    direct = quantize_model_gptq(
        params, cfg, family, [s.input_ids for s in train],
        QuantSpec(fmt="int", bits=4, group_size=32, symmetric=False),
        GPTQConfig(nsamples=2, calib_dataset="synthetic"), progress=None)
    save_artifact(str(tmp_path / "direct"), family, cfg, direct)
    assert _files(tmp_path / "cli") == _files(tmp_path / "direct")


def _same_ppl_results(got, want):
    assert list(got) == list(want)
    for name, entry in want.items():
        assert got[name]["quant_args"] == entry["quant_args"]
        for ds, d in entry["datasets"].items():
            g = got[name]["datasets"][ds]
            assert (g["num_tokens"], g["num_chunks"]) == (d["num_tokens"], d["num_chunks"])
            assert g["perplexity"] == pytest.approx(d["perplexity"], rel=PPL_REL)


def test_eval_ppl_matches_jax(src, tmp_path, capsys):
    args = ["--artifact", src, "--w_bits", "16", "4", "--w_group_size", "32", "--datasets",
            "synthetic", "--ppl_seqlen", "64", "--sample_size", "2"]
    want = j_eval_ppl.main(args + ["--output", str(tmp_path / "j.json")] + CPU)
    got = t_eval_ppl.main(args + ["--output", str(tmp_path / "t.json")] + CPU)
    _same_ppl_results(got, want)
    _same_ppl_results(read_results(str(tmp_path / "t.json")),
                      json.loads((tmp_path / "j.json").read_text()))


def _printed(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if "->" in ln]


@pytest.mark.parametrize("extra", [[], ["--continuous"], ["--scan", "--kv_bits", "8"]],
                         ids=["generate", "serve", "scan_kv8"])
def test_generate_prints_jax_tokens(int4, capsys, extra):
    args = ["--artifact", int4, "--max_new_tokens", "4", "--max_seq_len", "64",
            "--prompt", "1 5 9 12", "2 8 300"] + extra
    j_generate.main(args + CPU)
    want = _printed(capsys)
    outs = t_generate.main(args + CPU)
    assert _printed(capsys) == want
    assert len(want) == 2 and [len(o) for o in outs] == [4, 4]


def _docs(name):
    return {"piqa": [{"goal": "boil water", "sol1": "use a kettle", "sol2": "use a freezer",
                      "label": 0},
                     {"goal": "dry clothes", "sol1": "soak them", "sol2": "hang them up",
                      "label": 1},
                     {"goal": "open a jar", "sol1": "twist the lid", "sol2": "sing", "label": 0}],
            "boolq": [{"passage": "the sky is blue", "question": "is the sky blue", "label": 1},
                      {"passage": "fire is cold", "question": "is fire cold", "label": 0}],
            "lambada": [{"text": "the quick brown fox jumps over the lazy dog"},
                        {"text": "she opened the door and saw the sea"}]}[name]


def test_eval_zeroshot_matches_jax(src, monkeypatch, capsys):
    loads = []
    for mod in (j_tasks, t_tasks):
        monkeypatch.setattr(mod, "_load", lambda path, name, split: loads.append(path) or
                            _docs({"piqa": "piqa", "super_glue": "boolq"}.get(path, "lambada")))
    args = ["--artifact", src, "--w_bits", "16", "4", "--w_group_size", "32",
            "--tasks", "piqa", "boolq", "lambada", "--limit", "2"] + CPU
    want = j_eval_zeroshot.main(args)
    got = t_eval_zeroshot.main(args)
    assert loads == ["piqa", "super_glue", "EleutherAI/lambada_openai"] * 4  # 2 CLIs x 2 w_bits
    assert list(got) == list(want) == ["w16", "w4"]
    for w in want:
        assert list(got[w]) == list(want[w])
        for task, res in want[w].items():
            assert list(got[w][task]) == list(res)
            for key, v in res.items():
                if key.startswith("acc"):
                    assert got[w][task][key] == v, (w, task, key)
                else:
                    assert got[w][task][key] == pytest.approx(v, rel=1e-5), (w, task, key)


def _strip_times(tree):
    if isinstance(tree, dict):
        return {k: _strip_times(v) for k, v in tree.items() if k not in ("elapsed", "eval_time")}
    return tree


def test_sweep_writes_jax_json(src, tmp_path, capsys):
    sweep = {"base": ["--artifact", src, "--datasets", "synthetic", "--ppl_seqlen", "64",
                      "--sample_size", "1"] + CPU,
             "runs": [{"name": "int4_g32", "args": ["--w_bits", "4", "--w_group_size", "32"]},
                      {"name": "dense", "args": ["--w_bits", "16"]}]}
    (tmp_path / "sweep.json").write_text(json.dumps(sweep))
    j_sweep.main([str(tmp_path / "sweep.json"), "--output", str(tmp_path / "j.json")])
    t_sweep.main([str(tmp_path / "sweep.json"), "--output", str(tmp_path / "t.json")])
    got = _strip_times(read_results(str(tmp_path / "t.json")))
    want = _strip_times(json.loads((tmp_path / "j.json").read_text()))
    assert list(got) == list(want) == ["int4_g32", "dense"]
    for run in want:
        _same_ppl_results(got[run]["results"], want[run]["results"])


def test_results_files_equal_jax(tmp_path):
    for append, name in ((j_append_results, "j.json"), (append_results, "t.json")):
        append(str(tmp_path / name), {"a": 1, "b": {"c": [1.5, None]}})
        append(str(tmp_path / name), {"a": 2, "d": "x"})
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert read_results(str(tmp_path / "t.json")) == {"a": 2, "b": {"c": [1.5, None]}, "d": "x"}
    assert read_results(str(tmp_path / "none.json")) == {}


def test_demo_runs_on_the_cpu(tmp_path, capsys):
    t_quantize.main(["--demo", "--w_bits", "4", "--w_group_size", "32", "--out",
                     str(tmp_path / "demo")] + CPU)
    assert "quantized 14 linears (int4 g32) in" in capsys.readouterr().out
    outs = t_generate.main(["--demo", "--max_new_tokens", "3", "--max_seq_len", "64"] + CPU)
    assert [len(o) for o in outs] == [3, 3]


COMMANDS = {"quantize": (t_quantize, ["--demo", "--out", "/nonexistent/never-written"]),
            "generate": (t_generate, ["--demo"]),
            "eval_ppl": (t_eval_ppl, ["--demo", "--datasets", "synthetic"]),
            "eval_zeroshot": (t_eval_zeroshot, ["--demo"])}


@pytest.mark.parametrize("cmd", list(COMMANDS))
def test_no_platform_without_a_gpu_raises(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, args = COMMANDS[cmd]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)


def test_sweep_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "s.json").write_text(json.dumps({"runs": [{"name": "a", "args": ["--demo"]}]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sweep.main([str(tmp_path / "s.json"), "--output", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


@pytest.mark.parametrize("flag", ["--data_parallel", "--model_parallel"])
def test_multi_device_names_the_queue(int4, capfd, flag):
    """``--data_parallel 2`` / ``--model_parallel 2`` start two CPU ranks
    (gloo) that print, from rank 0, the tokens of one process."""
    args = ["--artifact", int4, "--max_new_tokens", "4", "--max_seq_len", "64",
            "--prompt", "1 5 9 12", "2 8 300", "7"] + CPU
    want_outs = t_generate.main(args)
    want = _printed(capfd)
    outs = t_generate.main(args + [flag, "2"])
    out = capfd.readouterr().out
    assert "torch.distributed: 2 ranks, backend gloo" in out
    assert [ln for ln in out.splitlines() if "->" in ln] == want and outs == want_outs
    assert len(want) == 3


def test_no_tp_block_is_accepted(int4, capsys):
    args = ["--artifact", int4, "--max_new_tokens", "3", "--max_seq_len", "64"] + CPU
    want = t_generate.main(args)
    assert t_generate.main(args + ["--no_tp_block"]) == want


def test_platform_takes_cpu_or_cuda(capsys):
    with pytest.raises(SystemExit):
        t_generate.main(["--demo", "--platform", "tpu"])
    err = capsys.readouterr().err
    assert "invalid choice: 'tpu'" in err and "cpu" in err and "cuda" in err
