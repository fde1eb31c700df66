"""Port parity: artifact IO, the model pass and ``repack_k_shards``.

* Artifacts the JAX package saved (a tiny W4 LLaMA with a bf16 embedding,
  None biases, a fused q|k|v artifact beside unfused linears; W3, fp4 LUT
  with its codebook, BFP4) load in the port to the tensors
  ``interop.params_from_numpy`` makes of the same tree; the port's save of
  that tree equals the JAX files byte for byte (``params.npz`` and
  ``manifest.json``); the JAX ``load_artifact`` reads the port's save.
* ``quantize_model_params`` writes the JAX package's bytes and report;
  ``dequantize_model_params`` gives the JAX package's weights and the
  reference's ``pseudo_quantize`` goldens (``tests/golden``).
* ``repack_k_shards`` gives the JAX package's bytes at bits 4, 3 and 8.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import PER_CHANNEL, PER_TENSOR
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize import artifact as j_art
from iron_weight_only_quant_tpu.quantize import model_pass as j_pass
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu.quantize import qtensor as j_qt
from iron_weight_only_quant_tpu_torch.config import QuantSpec as TSpec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy, spec_from_fields
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor, quantize_tensor
from iron_weight_only_quant_tpu_torch.quantize import artifact as t_art
from iron_weight_only_quant_tpu_torch.quantize import model_pass as t_pass
from iron_weight_only_quant_tpu_torch.quantize import qtensor as t_qt

GOLDEN = Path(__file__).parent / "golden"
J_CFG = j_llama.LlamaConfig.tiny()
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
SPECS = {
    "w4": JSpec(fmt="int", bits=4, group_size=32, symmetric=False),
    "w3": JSpec(fmt="int", bits=3, group_size=PER_CHANNEL, symmetric=False),
    "fp4": j_fp_spec("fp4", 2, 1, group_size=32, symmetric=False),
    "bfp4": JSpec(fmt="bfp", bits=4, group_size=32),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(a):
    """numpy view of a tensor's bytes, for bit-exact comparisons."""
    a = a.detach().cpu().contiguous()
    return a.view(torch.uint8).numpy() if a.dtype != torch.bool else a.numpy()


def assert_same_tree(got, want):
    """Equal structure, tensors equal in dtype, shape and bits, equal
    QuantizedTensor fields."""
    if isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor)
        for f in ("spec", "shape", "mode", "k_shards", "n_pad", "k_pad"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("qweight", "scales", "zeros", "codebook"):
            assert_same_tree(getattr(got, f), getattr(want, f))
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _jax_tree(name):
    """A quantized tiny LLaMA of the JAX package: layer 0 with q|k|v fused
    into one artifact, the lm_head dense (excluded by the model pass), and
    for W4 a bf16 embedding."""
    p = j_llama.llama_init(J_CFG, jax.random.PRNGKey(11))
    qp, _ = j_pass.quantize_model_params(p, SPECS[name])
    l0 = dict(qp["layers"][0])
    l0["qkv"] = {"w": j_qt.concat_n([l0.pop(k)["w"] for k in ("q", "k", "v")]), "b": None}
    qp["layers"] = [l0] + qp["layers"][1:]
    if name == "w4":
        qp["embed"] = qp["embed"].astype(jnp.bfloat16)
    return qp


def _np_tree(tree):
    """The JAX tree as numpy, in its own key order (``jax.tree.map`` would
    sort dict keys, and the artifact keeps the tree's order)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return params_from_numpy(_np_tree(tree), "cpu")


def _files(path):
    return {f: (Path(path) / f).read_bytes() for f in ("params.npz", "manifest.json")}


@pytest.fixture(scope="module")
def jax_trees():
    return {}


def _tree(jax_trees, name):
    if name not in jax_trees:
        jax_trees[name] = _jax_tree(name)
    return jax_trees[name]


@pytest.mark.parametrize("name", list(SPECS))
def test_port_reads_and_writes_jax_artifacts(tmp_path, jax_trees, name):
    tree = _tree(jax_trees, name)
    j_art.save_artifact(str(tmp_path / "jax"), "llama", J_CFG, tree)
    family, cfg, got = t_art.load_artifact(str(tmp_path / "jax"), device="cpu")
    assert family == "llama" and cfg == T_CFG
    want = _port(tree)
    # biases saved as absent come back as None; nothing else is added
    assert_same_tree(got, want)
    if name == "w4":
        assert got["embed"].dtype == torch.bfloat16
        manifest = json.loads((tmp_path / "jax" / "manifest.json").read_text())
        assert manifest["nodes"]["embed"]["dtype"] == "bfloat16"
    # the port's save of the same tree, and of what it loaded: the JAX bytes
    t_art.save_artifact(str(tmp_path / "port"), "llama", T_CFG, want)
    t_art.save_artifact(str(tmp_path / "port2"), "llama", cfg, got)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert _files(tmp_path / "port2") == _files(tmp_path / "jax")
    if name != "w4":  # the JAX loader refuses bf16 arrays, its own included
        _, _, back = j_art.load_artifact(str(tmp_path / "port"))
        assert_same_tree(_port(back), want)


def test_load_casts_dense_floats_only(tmp_path, jax_trees):
    tree = _tree(jax_trees, "w4")
    j_art.save_artifact(str(tmp_path), "llama", J_CFG, tree)
    _, _, got = t_art.load_artifact(str(tmp_path), dtype=torch.float16, device="cpu")
    assert got["embed"].dtype == torch.float16 and got["lm_head"]["w"].dtype == torch.float16
    qt = got["layers"][1]["o"]["w"]
    assert qt.scales.dtype == torch.float32 and qt.qweight.dtype == torch.uint8


def test_other_families_and_versions_raise(tmp_path):
    """OPT and BLOOM manifests load into their configs (as in the JAX
    package; tests/test_torch_opt_bloom.py holds whole models); a family
    neither package knows, and another format version, raise."""
    from iron_weight_only_quant_tpu_torch.models import BloomConfig, OPTConfig

    j_art.save_artifact(str(tmp_path), "llama", J_CFG, {"embed": jnp.ones((4, 8))})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    for family, cls in (("opt", OPTConfig), ("bloom", BloomConfig)):
        (tmp_path / "manifest.json").write_text(json.dumps({**manifest, "family": family}))
        fam, cfg, _ = t_art.load_artifact(str(tmp_path), device="cpu")
        assert fam == family and type(cfg) is cls and cfg.hidden_size == J_CFG.hidden_size
    (tmp_path / "manifest.json").write_text(json.dumps({**manifest, "family": "gpt2"}))
    with pytest.raises(KeyError):
        j_art.load_artifact(str(tmp_path))
    with pytest.raises(KeyError):
        t_art.load_artifact(str(tmp_path), device="cpu")
    (tmp_path / "manifest.json").write_text(json.dumps({**manifest, "version": 1}))
    with pytest.raises(ValueError, match="format v1"):
        t_art.load_artifact(str(tmp_path), device="cpu")


# ------------------------------------------------------------ model pass

@pytest.mark.parametrize("name", ["w4", "fp4"])
def test_quantize_model_params_matches_jax(name):
    p = j_llama.llama_init(J_CFG, jax.random.PRNGKey(12))
    jq, jrep = j_pass.quantize_model_params(p, SPECS[name])
    tq, trep = t_pass.quantize_model_params(
        _port(p),
        spec_from_fields(SPECS[name]), device="cpu")
    assert trep == jrep and jrep["n_skipped"] == 1 and "lm_head" not in jrep["names"]
    assert_same_tree(tq, _port(jq))
    jd = j_pass.dequantize_model_params(jq)
    assert_same_tree(t_pass.dequantize_model_params(tq),
                     _port(jd))


GOLDEN_CASES = [(b, zp, g) for b in (4, 8) for zp in (0, 1) for g in (128, -1)] + [(4, 1, "pt")]


@pytest.mark.parametrize("bits,zp,g", GOLDEN_CASES,
                         ids=[f"b{b}_zp{zp}_g{g}" for b, zp, g in GOLDEN_CASES])
def test_dequantize_model_params_matches_golden(bits, zp, g):
    """A linear ``w = input.T`` ([256, 64]) quantized along K is the
    reference's ``pseudo_quantize`` of ``input`` along its last dim."""
    data = np.load(GOLDEN / "pseudo_quantize.npz")
    key = f"b{bits}_zp{zp}_g-1_pt1" if g == "pt" else f"b{bits}_zp{zp}_g{g}_pt0"
    group = {128: 128, -1: PER_CHANNEL, "pt": PER_TENSOR}[g]
    spec = TSpec(fmt="int", bits=bits, group_size=group, symmetric=not zp)
    tree = {"layers": [{"q": {"w": torch.from_numpy(data["input"].T.copy()), "b": None}}]}
    tq, _ = t_pass.quantize_model_params(tree, spec, device="cpu")
    dense = t_pass.dequantize_model_params(tq)["layers"][0]["q"]["w"]
    np.testing.assert_array_equal(dense.numpy(), data[key].T)
    jq, _ = j_pass.quantize_model_params(
        {"layers": [{"q": {"w": jnp.asarray(data["input"].T), "b": None}}]},
        JSpec(fmt="int", bits=bits, group_size=group, symmetric=not zp))
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(j_pass.dequantize_model_params(jq)["layers"][0]["q"]["w"]))


# --------------------------------------------------------- repack_k_shards

@pytest.mark.parametrize("k_shards", [2, 4])
@pytest.mark.parametrize("bits", [4, 3, 8])
def test_repack_k_shards_matches_jax(bits, k_shards):
    w = np.random.default_rng(bits * 10 + k_shards).normal(size=(1024, 96)).astype(np.float32)
    spec = dict(fmt="int", bits=bits, group_size=128, symmetric=False)
    jq = j_qt.repack_k_shards(j_quantize(jnp.asarray(w), JSpec(**spec)), k_shards)
    tq = t_qt.repack_k_shards(quantize_tensor(torch.from_numpy(w), TSpec(**spec)), k_shards)
    assert tq.k_shards == jq.k_shards == k_shards
    assert_same_tree(tq, _port(jq))
    # and back: the artifact k_shards=1 packs
    assert_same_tree(t_qt.repack_k_shards(tq, 1),
                     quantize_tensor(torch.from_numpy(w), TSpec(**spec)))
