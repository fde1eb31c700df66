"""Port parity: LLaMA forward and its building blocks against the JAX package.

A tiny random model (hidden 256, FFN 512, 2 layers, 4 heads, 2 KV heads,
vocab 256) is built once by the JAX package and carried to the port as
numpy; logits must agree within 2e-4 in float32 -- dense, folded and
quantized (W4 g128, N padded to 512), and folded, quantized and fused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.engine.kvcache import make_caches as j_make
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine.kvcache import make_caches
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import common as t_common
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.models.common import FusedLinear
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor

ATOL = 2e-4
J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
SPEC = JSpec(fmt="int", bits=4, group_size=128, symmetric=False)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls and many small ops that
    gain nothing from many torch threads; in the parallel test run those
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _jax_params(variant: str):
    p = j_llama.llama_init(J_CFG, jax.random.PRNGKey(0))
    # non-trivial norm gammas, so folding is really exercised
    rng = np.random.default_rng(5)
    p["layers"] = [{**l, "input_norm": jnp.asarray(1 + 0.1 * rng.normal(size=256), jnp.float32),
                    "post_norm": jnp.asarray(1 + 0.1 * rng.normal(size=256), jnp.float32)}
                   for l in p["layers"]]
    if variant == "dense":
        return p
    p = j_llama.fold_llama_norms(p)

    def q(lin):
        return {**lin, "w": j_quantize(lin["w"], SPEC, pad_n_to=512)}

    p = {**p, "lm_head": q(p["lm_head"]),
         "layers": [{k: (q(v) if isinstance(v, dict) else v) for k, v in l.items()}
                    for l in p["layers"]]}
    if variant == "fused":
        p = j_llama.fuse_llama_projections(p)
    return p


@pytest.fixture(scope="module", params=["dense", "quantized", "fused"])
def pair(request):
    jp = _jax_params(request.param)
    return request.param, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(b=2, s=9, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s))


def test_logits_match_jax(pair):
    variant, jp, tp = pair
    toks = _tokens()
    want, _ = j_llama.llama_forward(jp, jnp.asarray(toks), J_CFG)
    got, _ = t_llama.llama_forward(tp, torch.from_numpy(toks), T_CFG)
    assert got.shape == (2, 9, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    layer = tp["layers"][0]
    if variant == "fused":
        assert isinstance(layer["qkv"], FusedLinear) and "q" not in layer
        assert layer["qkv"].spans == jp["layers"][0]["qkv"].spans
    elif variant == "quantized":
        assert isinstance(layer["q"]["w"], QuantizedTensor) and layer["input_norm"] is None


def test_incremental_decode_matches_full_forward(pair):
    _, _, tp = pair
    toks = torch.from_numpy(_tokens(s=8, seed=1))
    full, _ = t_llama.llama_forward(tp, toks, T_CFG)
    caches = make_caches(T_CFG.num_layers, 2, T_CFG.num_kv_heads, T_CFG.hd,
                         KVCacheConfig(max_seq_len=16), torch.float32, "cpu")
    logits, caches = t_llama.llama_forward(tp, toks[:, :5], T_CFG, caches=caches)
    steps = [logits]
    for t in range(5, 8):
        logits, caches = t_llama.llama_forward(tp, toks[:, t:t + 1], T_CFG, caches=caches)
        steps.append(logits)
    assert caches[0].length == 8
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full.numpy(),
                               atol=ATOL, rtol=0)


def test_incremental_decode_matches_jax(pair):
    _, jp, tp = pair
    toks = _tokens(s=6, seed=2)
    jc = j_make(J_CFG.num_layers, 2, J_CFG.num_kv_heads, J_CFG.hd, JKV(max_seq_len=16),
                jnp.float32)
    tc = make_caches(T_CFG.num_layers, 2, T_CFG.num_kv_heads, T_CFG.hd,
                     KVCacheConfig(max_seq_len=16), torch.float32, "cpu")
    _, jc = j_llama.llama_forward(jp, jnp.asarray(toks[:, :5]), J_CFG, caches=jc)
    _, tc = t_llama.llama_forward(tp, torch.from_numpy(toks[:, :5]), T_CFG, caches=tc)
    want, _ = j_llama.llama_forward(jp, jnp.asarray(toks[:, 5:]), J_CFG, caches=jc)
    got, _ = t_llama.llama_forward(tp, torch.from_numpy(toks[:, 5:]), T_CFG, caches=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ------------------------------------------------------------ building blocks

def _r(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("condense_ratio", [1.0, 4.0])
def test_rope_matches_jax(condense_ratio):
    pos = np.array([[0, 1, 2, 7], [3, 4, 5, 6]])
    jc, js = j_common.rope_tables(jnp.asarray(pos), 32, 10000.0, condense_ratio)
    tc, ts = t_common.rope_tables(torch.from_numpy(pos), 32, 10000.0, condense_ratio)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    x = _r(2, 4, 3, 32)
    want = j_common.apply_rope(jnp.asarray(x), jc, js)
    got = t_common.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_attend_matches_jax(hkv):
    q, k, v = _r(2, 3, 4, 16, seed=1), _r(2, 5, hkv, 16, seed=2), _r(2, 5, hkv, 16, seed=3)
    mask = np.asarray(j_common.causal_mask(3, 5, offset=2))
    mask = np.broadcast_to(mask, (2, 1, 3, 5)).copy()
    mask[1, :, :, 0] = False  # a left pad on row 1
    want = j_common.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    got = t_common.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_causal_mask_matches_jax():
    for s, t, off in [(4, None, 0), (3, 7, 4), (1, 9, 8)]:
        want = np.asarray(j_common.causal_mask(s, t, off))
        np.testing.assert_array_equal(t_common.causal_mask(s, t, off).numpy(), want)


def test_rmsnorm_matches_jax():
    x, g = _r(3, 64, seed=4), _r(64, seed=5)
    want = j_common.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5)
    got = t_common.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["scalar", "scalar_clamped", "per_slot", "valid"])
def test_update_kv_cache_matches_jax(mode):
    b, t_max, h, d, s = 3, 8, 2, 4, 3
    k0, v0 = _r(b, t_max, h, d, seed=6), _r(b, t_max, h, d, seed=7)
    kn, vn = _r(b, s, h, d, seed=8), _r(b, s, h, d, seed=9)
    valid = None
    if mode == "scalar":
        length, t_len = jnp.asarray(2, jnp.int32), 2
    elif mode == "scalar_clamped":
        length, t_len = jnp.asarray(7, jnp.int32), 7
    else:
        arr = np.array([0, 4, 6], np.int32)
        length, t_len = jnp.asarray(arr), torch.from_numpy(arr.astype(np.int64))
        if mode == "valid":
            valid = np.array([3, 1, 0], np.int32)
    jv = j_common.KVCacheView(jnp.asarray(k0), jnp.asarray(v0), length,
                              None if valid is None else jnp.asarray(valid))
    tv = t_common.KVCacheView(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()),
                              t_len, None if valid is None else torch.from_numpy(valid))
    jr = j_common.update_kv_cache(jv, jnp.asarray(kn), jnp.asarray(vn))
    tr = t_common.update_kv_cache(tv, torch.from_numpy(kn), torch.from_numpy(vn))
    np.testing.assert_array_equal(tr.k.numpy(), np.asarray(jr.k))
    np.testing.assert_array_equal(tr.v.numpy(), np.asarray(jr.v))
    np.testing.assert_array_equal(np.asarray(tr.length), np.asarray(jr.length))


def test_fold_llama_norms_matches_jax():
    p = _jax_params("dense")
    want = j_llama.fold_llama_norms(p)
    got = t_llama.fold_llama_norms(params_from_numpy(jax.tree.map(np.asarray, p), "cpu"))
    for jl, tl in zip(want["layers"], got["layers"]):
        assert tl["input_norm"] is None and tl["post_norm"] is None
        for key in ("q", "k", "v", "gate", "up", "o", "down"):
            np.testing.assert_array_equal(tl[key]["w"].numpy(), np.asarray(jl[key]["w"]))


def test_fold_refuses_quantized_weights():
    tp = params_from_numpy(jax.tree.map(np.asarray, _jax_params("dense")), "cpu")
    qp = params_from_numpy(jax.tree.map(np.asarray, _jax_params("quantized")), "cpu")
    tp["layers"][0]["q"] = qp["layers"][0]["q"]
    with pytest.raises(ValueError, match="before quantization"):
        t_llama.fold_llama_norms(tp)


def test_port_fusion_matches_jax_fusion():
    jp = _jax_params("quantized")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = j_llama.fuse_llama_projections(jp)["layers"][0]
    got = t_llama.fuse_llama_projections(tp)["layers"][0]
    for key in ("qkv", "gate_up"):
        assert got[key].spans == want[key].spans
        np.testing.assert_array_equal(got[key].w.qweight.numpy(),
                                      np.asarray(want[key].w.qweight))
        np.testing.assert_array_equal(got[key].w.scales.numpy(),
                                      np.asarray(want[key].w.scales))


def test_interop_carries_bfloat16_and_fused_spans():
    from iron_weight_only_quant_tpu_torch.interop import tensor_from_numpy

    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    jp = jax.tree.map(np.asarray, _jax_params("fused"))
    tp = params_from_numpy(jp, "cpu")
    assert tp["layers"][1]["gate_up"].spans == ((0, 512), (512, 1024))
    assert tp["lm_head"]["w"].n_pad == jp["lm_head"]["w"].n_pad
