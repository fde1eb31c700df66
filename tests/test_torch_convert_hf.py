"""Port parity: the HF converter, the safetensors reader and chat prompts.

* ``from_hf_model`` on tiny HF LLaMA, OPT (pre- and post-LN) and BLOOM
  models built from configs gives the JAX converter's params bit for bit,
  and logits within 2e-5 of the JAX forward's (float32 on the CPU; both
  within the JAX test's 2e-4 of HF's own);
* ``load_checkpoint_dir`` on ``config.json`` + ``*.safetensors`` written by
  ``safetensors.numpy`` (float32 and float16 files, one shard and two)
  gives the JAX loader's params bit for bit, in float32 and in bfloat16;
* ``read_safetensors`` returns what ``safe_open(framework="numpy")`` returns
  (every dtype numpy has), and where that raises it raises: BF16 without
  ``ml_dtypes`` (a process without JAX), a truncated file;
* ``format_chat_prompt`` gives the JAX package's strings.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import safetensors.numpy as st_np
import transformers
from safetensors import safe_open

from iron_weight_only_quant_tpu.models import chat as j_chat
from iron_weight_only_quant_tpu.models import convert_hf as j_conv
from iron_weight_only_quant_tpu_torch.models import chat as t_chat
from iron_weight_only_quant_tpu_torch.models import convert_hf as t_conv

ROOT = Path(__file__).resolve().parents[1]
HF = {
    "llama": (transformers.LlamaForCausalLM, transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False)),
    "opt": (transformers.OPTForCausalLM, transformers.OPTConfig(
        vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128, do_layer_norm_before=True)),
    "opt_post_ln": (transformers.OPTForCausalLM, transformers.OPTConfig(
        vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128, do_layer_norm_before=False)),
    "bloom": (transformers.BloomForCausalLM, transformers.BloomConfig(
        vocab_size=256, hidden_size=64, n_layer=2, n_head=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_models():
    out = {}
    for name, (cls, cfg) in HF.items():
        torch.manual_seed(0)
        out[name] = cls(cfg).eval()
    return out


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 250, size=(2, 24)).astype(np.int64)


def assert_trees_equal(got, want):
    """Port tree (torch) == JAX tree (jax/numpy): same keys, dtypes, bits."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_trees_equal(a, b)
    elif want is None:
        assert got is None
    else:
        w = np.asarray(want)
        assert got.is_contiguous() and tuple(got.shape) == w.shape
        assert str(got.dtype).split(".")[-1] == w.dtype.name
        if got.dtype == torch.bfloat16:
            got, w = got.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("name", list(HF))
def test_from_hf_model_matches_jax(hf_models, tokens, name):
    hf = hf_models[name]
    j_cfg, j_params, j_fwd = j_conv.from_hf_model(hf)
    t_cfg, t_params, t_fwd = t_conv.from_hf_model(hf, device="cpu")
    assert {f: getattr(t_cfg, f) for f in t_cfg.__dataclass_fields__} == \
        {f: getattr(j_cfg, f) for f in j_cfg.__dataclass_fields__}
    assert_trees_equal(t_params, j_params)
    with torch.inference_mode():
        ours = t_fwd(t_params, torch.from_numpy(tokens), t_cfg)[0].numpy()
        ref = hf(torch.from_numpy(tokens)).logits.float().numpy()
    want = np.asarray(j_fwd(j_params, jnp.asarray(tokens), j_cfg)[0])
    assert np.abs(ours - want).max() <= 2e-5
    assert np.abs(ours - ref).max() < 2e-4


def _write_checkpoint(path, hf, dtype, shards):
    """``config.json`` and the state dict as ``shards`` safetensors files."""
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf.config.to_dict()))
    sd = {k: v.detach().numpy().astype(dtype) for k, v in hf.state_dict().items()}
    keys = sorted(sd)
    for i in range(shards):
        st_np.save_file({k: sd[k] for k in keys[i::shards]},
                        str(path / f"model-{i:05d}.safetensors"))


@pytest.mark.parametrize("name,file_dtype,shards", [
    ("llama", np.float32, 1), ("llama", np.float16, 2), ("opt", np.float16, 1),
    ("bloom", np.float32, 2)])
@pytest.mark.parametrize("load", ["float32", "bfloat16"])
def test_load_checkpoint_dir_matches_jax(tmp_path, hf_models, name, file_dtype, shards, load):
    _write_checkpoint(tmp_path / "ckpt", hf_models[name], file_dtype, shards)
    j_cfg, j_params, j_fwd = j_conv.load_checkpoint_dir(str(tmp_path / "ckpt"),
                                                        dtype=getattr(jnp, load))
    t_cfg, t_params, t_fwd = t_conv.load_checkpoint_dir(str(tmp_path / "ckpt"),
                                                        dtype=getattr(torch, load), device="cpu")
    assert t_cfg.__class__.__name__ == j_cfg.__class__.__name__
    assert t_fwd.__name__ == j_fwd.__name__
    assert_trees_equal(t_params, j_params)


def test_load_checkpoint_dir_refuses_unknown_families(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(ValueError, match="unsupported model family 'gpt2'"):
        t_conv.load_checkpoint_dir(str(tmp_path), device="cpu")


def test_reader_returns_what_safe_open_returns(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"f64": rng.normal(size=(3,)), "f32": rng.normal(size=(2, 3)).astype(np.float32),
              "f16": rng.normal(size=(5, 1, 2)).astype(np.float16),
              "i64": np.arange(7, dtype=np.int64), "i32": -np.arange(4, dtype=np.int32),
              "i16": np.arange(3, dtype=np.int16), "i8": np.arange(-3, 3, dtype=np.int8),
              "u8": np.arange(9, dtype=np.uint8).reshape(3, 3),
              "bool": np.array([True, False, True]), "empty": np.zeros((0, 4), np.float32),
              "scalar": np.array(2.5, np.float32)}
    path = tmp_path / "all.safetensors"
    st_np.save_file(arrays, str(path), metadata={"format": "np"})
    got = t_conv.read_safetensors(path)
    with safe_open(str(path), framework="numpy") as f:
        want = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    got["f32"][0, 0] = 99.0  # copy-on-write: the file keeps its bytes
    assert t_conv.read_safetensors(path)["f32"][0, 0] == arrays["f32"][0, 0]


def _bf16_file(path):
    header = json.dumps({"x": {"dtype": "BF16", "shape": [2], "data_offsets": [0, 4]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\x00\x3f\x00\x40")


def test_bf16_as_safe_open(tmp_path):
    """With ``ml_dtypes`` loaded (JAX is imported here) both give the same
    bfloat16 array; in a process without it both raise TypeError."""
    path = tmp_path / "bf16.safetensors"
    _bf16_file(path)
    with safe_open(str(path), framework="numpy") as f:
        want = f.get_tensor("x")
    got = t_conv.read_safetensors(path)["x"]
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    code = f"""
from safetensors import safe_open
from iron_weight_only_quant_tpu_torch.models.convert_hf import read_safetensors
for read in (lambda p: safe_open(p, framework="numpy").get_tensor("x"),
             lambda p: read_safetensors(p)["x"]):
    try:
        read({str(path)!r})
    except TypeError as e:
        print("TypeError", e)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1], lines


def test_truncated_file_raises(tmp_path):
    path = tmp_path / "cut.safetensors"
    st_np.save_file({"a": np.ones((64,), np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(Exception):
        with safe_open(str(path), framework="numpy") as f:
            f.get_tensor("a")
    with pytest.raises(ValueError, match="offsets"):
        t_conv.read_safetensors(path)


@pytest.mark.parametrize("model", ["llama-2-7b-chat", "Llama-2-13b", "longchat-13b-16k",
                                   "vicuna-7b", "opt-6.7b", "/ckpts/bloom-7b1", ""])
@pytest.mark.parametrize("text", ["hello", "What is 2 + 2?\nExplain.", ""])
def test_chat_prompts_equal_jax(model, text):
    assert t_chat.format_chat_prompt(text, model) == j_chat.format_chat_prompt(text, model)
    assert (t_chat.LLAMA_SYSTEM, t_chat.VICUNA_SYSTEM) == (j_chat.LLAMA_SYSTEM,
                                                          j_chat.VICUNA_SYSTEM)
