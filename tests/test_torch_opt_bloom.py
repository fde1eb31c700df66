"""Port parity: the OPT and BLOOM forwards, flat and scan, their engines and
artifacts, against the JAX package.

Tiny random models are built once by the JAX package and carried to the
port as numpy: OPT with LayerNorm before each sub-block and after it, BLOOM
with 4 heads and with 6 (no power of two, so ``alibi_slopes`` takes its
second branch).  Logits of ``*_forward`` and ``*_forward_scan`` equal the
JAX package's flat forward's (2e-4, float32), dense and W4 / W8 quantized (groups of 32),
without a cache and with a prefill and a decode step on a cache; greedy
``generate`` and ``serve`` tokens of the port's flat and scan engines equal
the JAX engine's (W8, int8 KV, as the JAX package's own scan tests);
``layernorm`` and ``alibi_slopes`` equal JAX's; OPT and BLOOM artifacts the
JAX package saved load in the port, and the port's saves are byte-equal.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.engine import kvcache as j_kv
from iron_weight_only_quant_tpu.models import bloom as j_bloom
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import opt as j_opt
from iron_weight_only_quant_tpu.quantize import artifact as j_art
from iron_weight_only_quant_tpu.quantize.model_pass import quantize_model_params as j_qmp
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.engine import kvcache as t_kv
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import bloom as t_bloom
from iron_weight_only_quant_tpu_torch.models import common as t_common
from iron_weight_only_quant_tpu_torch.models import opt as t_opt
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor
from iron_weight_only_quant_tpu_torch.quantize import artifact as t_art

ATOL = 2e-4  # port vs JAX, float32 (as tests/test_torch_llama.py)
# name -> (family, JAX config, JAX module, port module)
MODELS = {
    "opt": ("opt", j_opt.OPTConfig.tiny(), j_opt, t_opt),
    "opt_post_ln": ("opt", dataclasses.replace(j_opt.OPTConfig.tiny(),
                                               do_layer_norm_before=False), j_opt, t_opt),
    "bloom": ("bloom", j_bloom.BloomConfig.tiny(), j_bloom, t_bloom),
    "bloom_6_heads": ("bloom", j_bloom.BloomConfig(vocab_size=256, hidden_size=96,
                                                   num_layers=2, num_heads=6),
                      j_bloom, t_bloom),
}
SPECS = {"w4": JSpec(fmt="int", bits=4, group_size=32, symmetric=False),
         "w8": JSpec(fmt="int", bits=8, group_size=32, symmetric=False)}
REQS = [[1, 2, 3], [7, 5], [9, 9, 9, 9], [4, 8, 15, 16, 23]]
PROMPTS = [[5, 2, 8], [1, 7, 3, 9]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t_cfg(name):
    family, jcfg, _, tmod = MODELS[name]
    cls = tmod.OPTConfig if family == "opt" else tmod.BloomConfig
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _forwards(name):
    """(JAX flat forward, port flat forward, port scan forward); the JAX
    package's own tests hold its scan forwards to its flat ones."""
    fam, _, jmod, tmod = MODELS[name]
    return (getattr(jmod, f"{fam}_forward"), getattr(tmod, f"{fam}_forward"),
            getattr(tmod, f"{fam}_forward_scan"))


def _np_tree(tree):
    """The JAX tree as numpy in its own key order (``jax.tree.map`` sorts
    dict keys; an artifact keeps the tree's order)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """(name, quant) -> (JAX params, port params), built on first use."""
    return {}


def _pair(trees, name, quant="dense"):
    key = (name, quant)
    if key not in trees:
        _, jcfg, jmod, _ = MODELS[name]
        init = jmod.opt_init if jmod is j_opt else jmod.bloom_init
        p = init(jcfg, jax.random.PRNGKey(3))
        # non-trivial norms and biases, so every affine term is exercised
        rng = np.random.default_rng(4)

        def perturb(node):
            if isinstance(node, dict):
                return {k: perturb(v) for k, v in node.items()}
            if isinstance(node, list):
                return [perturb(v) for v in node]
            if getattr(node, "ndim", 0) == 1:
                return node + jnp.asarray(0.1 * rng.normal(size=node.shape), node.dtype)
            return node

        p = perturb(p)
        if quant != "dense":
            p, _ = j_qmp(p, SPECS[quant])
        trees[key] = (p, params_from_numpy(_np_tree(p), "cpu"))
    return trees[key]


def _tokens(s=10, seed=0):
    return np.random.default_rng(seed).integers(0, 250, size=(2, s))


@pytest.mark.parametrize("name,quant", [
    (n, q) for n in MODELS for q in ("dense", "w4", "w8")
    if q != "w8" or n in ("opt", "bloom")])
def test_logits_match_jax_flat_and_scan(trees, name, quant):
    """No cache, then a 10-token prefill and one decode step on a cache
    (per-layer views for the flat forwards, one stacked view for the scan
    forwards).  The post-LN and 6-head variants, which differ in the norms'
    place and the slopes, take the dense and W4 params."""
    jp, tp = _pair(trees, name, quant)
    jcfg, tcfg = MODELS[name][1], _t_cfg(name)
    jf, tf, tscan = _forwards(name)
    ts = t_common.stack_model_layers(tp)
    toks = _tokens()
    want, _ = jf(jp, jnp.asarray(toks), jcfg)
    for got, _ in (tf(tp, torch.from_numpy(toks), tcfg), tscan(ts, torch.from_numpy(toks), tcfg)):
        assert got.shape == (2, 10, 256) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    kv = dict(max_seq_len=16)
    shape = (jcfg.num_layers, 2, jcfg.num_heads, jcfg.hd)
    jc = j_kv.make_caches(*shape, JKV(**kv), jnp.float32)
    tc = t_kv.make_caches(*shape, KVCacheConfig(**kv), torch.float32, "cpu")
    tsc = t_kv.make_stacked_caches(*shape, KVCacheConfig(**kv), torch.float32, "cpu")
    x = toks
    for _ in range(2):
        want, jc = jf(jp, jnp.asarray(x), jcfg, caches=jc)
        got, tc = tf(tp, torch.from_numpy(x), tcfg, caches=tc)
        got_scan, tsc = tscan(ts, torch.from_numpy(x), tcfg, caches=tsc)
        for g in (got, got_scan):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        x = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    assert tc[0].length == 11 and tsc.length == (11, 11)


@pytest.mark.parametrize("name", ["opt", "bloom"])
def test_engine_tokens_match_jax_flat_and_scan(trees, name):
    """Greedy ``generate`` and ``serve`` of the port's flat and scan
    engines (the scan one from flat params, stacked by the engine) against
    the JAX flat engine, W8 with an int8 cache."""
    jp, tp = _pair(trees, name, "w8")
    jcfg, tcfg = MODELS[name][1], _t_cfg(name)
    jf, tf, tscan = _forwards(name)
    kv = dict(max_seq_len=48, kv_bits=8, kv_group_size=16)
    je = JEngine(jp, jcfg, jf, engine_cfg=JEngineConfig(kv=JKV(**kv), max_batch_size=2))
    want_gen = je.generate(PROMPTS, max_new_tokens=4)
    want_serve = je.serve(REQS, max_new_tokens=4, chunk=2)
    for fwd in (tf, tscan):
        te = InferenceEngine(tp, tcfg, fwd, engine_cfg=EngineConfig(
            kv=KVCacheConfig(**kv), max_batch_size=2), device="cpu")
        assert ("layers_stacked" in te.params) == (fwd is tscan)
        assert te.generate(PROMPTS, max_new_tokens=4) == want_gen
        assert te.serve(REQS, max_new_tokens=4, chunk=2) == want_serve


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(3, 5, 96)) * 3 + 1, dtype)
    w = jnp.asarray(1 + 0.2 * rng.normal(size=96), dtype)
    b = jnp.asarray(0.2 * rng.normal(size=96), dtype)
    want = np.asarray(j_common.layernorm(x, w, b, 1e-5).astype(jnp.float32))
    t = [params_from_numpy(np.asarray(a), "cpu") for a in (x, w, b)]
    got = t_common.layernorm(*t, 1e-5)
    assert got.dtype == t[0].dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=0)


def test_alibi_slopes_bit_equal_to_jax():
    for n in list(range(1, 41)) + [64, 71, 112]:
        got = t_common.alibi_slopes(n)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_common.alibi_slopes(n)))


def _files(path):
    return {f: (Path(path) / f).read_bytes() for f in ("params.npz", "manifest.json")}


@pytest.mark.parametrize("name", ["opt_post_ln", "bloom"])
def test_artifacts_load_and_save_like_jax(tmp_path, trees, name):
    jp, _ = _pair(trees, name, "w4")
    family, jcfg = MODELS[name][0], MODELS[name][1]
    j_art.save_artifact(str(tmp_path / "jax"), family, jcfg, jp)
    fam, cfg, got = t_art.load_artifact(str(tmp_path / "jax"), device="cpu")
    assert fam == family and cfg == _t_cfg(name)
    want = params_from_numpy(_np_tree(jp), "cpu")
    flat_got, flat_want = _leaves(got), _leaves(want)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert (a == b) if not torch.is_tensor(b) else (a.dtype == b.dtype and torch.equal(a, b))
    t_art.save_artifact(str(tmp_path / "port"), family, cfg, want)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    if isinstance(t, QuantizedTensor):
        return [(t.spec, t.shape, t.mode, t.k_shards, t.n_pad, t.k_pad)] + [
            getattr(t, f) for f in ("qweight", "scales", "zeros", "codebook")]
    return [t]
