"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

* every module of ``iron_weight_only_quant_tpu_torch`` (and ``chip_smoke.py``)
  imports in a process where ``jax``, ``flax`` and the JAX package cannot
  be imported, and importing builds no kernel;
* an AST scan finds no import of those packages in the port's sources;
* an entry point given no device raises on a machine with no GPU (the
  CLI's commands: ``tests/test_torch_cli.py``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "iron_weight_only_quant_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "iron_weight_only_quant_tpu")
# the modules of the CLI, parallel, CUDA-graph and GPTQ-block slices, which
# the walk must reach
NEW_MODULES = ("cli.common", "cli.quantize", "cli.generate", "cli.eval_ppl",
               "cli.eval_zeroshot", "cli.sweep", "evals.lm", "evals.metrics",
               "evals.lm_eval_adapter", "evals.zeroshot.base", "evals.zeroshot.tasks",
               "models.convert_hf", "models.chat", "utils.results_io", "native.lib",
               "analysis.stats", "analysis.plots", "parallel.mesh", "parallel.sharding",
               "parallel.tp", "parallel.tp_block", "parallel.pp", "engine.graphs",
               "ops.kernels.gptq_block")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import iron_weight_only_quant_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from iron_weight_only_quant_tpu_torch.native import lib as host_lib
from iron_weight_only_quant_tpu_torch.ops.kernels import build
assert build._LIBS == {{}}, "importing must not build or load a kernel"
assert host_lib._lib is None, "importing must not build or load the host library"
for name in {NEW_MODULES!r}:
    assert "iron_weight_only_quant_tpu_torch." + name in names, name
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v)
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name}:{node.lineno} imports {mod}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_device_raise(no_gpu):
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.device import resolve_device
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine, make_caches
    from iron_weight_only_quant_tpu_torch.models.llama import (
        LlamaConfig,
        llama_forward,
        llama_init,
    )

    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_caches(2, 1, 2, 16, KVCacheConfig(max_seq_len=8))
    from iron_weight_only_quant_tpu_torch.cli.common import apply_platform
    from iron_weight_only_quant_tpu_torch.models.convert_hf import load_checkpoint_dir

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint_dir("/nowhere")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        apply_platform(type("Args", (), {"platform": None})())
    params = llama_init(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(params, cfg, llama_forward, family="llama",
                        engine_cfg=EngineConfig())
    eng = InferenceEngine(params, cfg, llama_forward, family="llama", device="cpu")
    assert len(eng.generate([[1, 2, 3]], max_new_tokens=2)[0]) == 2


def test_engine_refuses_params_on_another_device():
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models.llama import (
        LlamaConfig,
        llama_forward,
        llama_init,
    )

    cfg = LlamaConfig.tiny()
    params = llama_init(cfg, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="lie on"):
        InferenceEngine(params, cfg, llama_forward, device="meta")
