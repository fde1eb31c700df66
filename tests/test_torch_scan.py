"""Port parity: the scan path (layer-stacked params and KV caches).

A tiny LLaMA (``LlamaConfig.tiny()``: hidden 64, 2 layers, 4 heads, 2 KV
heads) is built once by the JAX package, dense, W8 and W4 (groups of 32,
asymmetric), and W4 with folded norms and fused projections, and carried to
the port as numpy (``interop.params_from_numpy``, which also carries JAX
``layers_stacked`` trees: ``side_pad``, stacked fused linears, None norms):

* the port's ``stack_model_layers`` equals the JAX package's (shapes,
  ``side_pad``, bytes), ``consume=True`` too;
* ``llama_forward_scan`` logits equal the JAX scan forward's (2e-4) and the
  port's flat forward's (1e-5): without a cache, and a prefill and a decode
  step on stacked 16-bit, int8 and int4 caches;
* layer-by-layer stacked cache writes with slot-local lengths, with and
  without ``valid``, equal the flat views' (and the JAX stacked writes');
* the scan engine's ``generate`` and ``serve`` tokens and integer stats
  equal the JAX scan engine's, on 16-bit, int8 and int4 caches; paged +
  stacked raises; flat params with a scan forward are fused, then stacked;
  the scan path is chosen by the forward's mark, not its name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.engine import engine as j_engine
from iron_weight_only_quant_tpu.engine import kvcache as j_kv
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize.model_pass import quantize_model_params as j_qmp
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.engine import engine as t_engine
from iron_weight_only_quant_tpu_torch.engine import kvcache as t_kv
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import common as t_common
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.models.common import FusedLinear
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor

ATOL = 2e-4  # port vs JAX, float32 (as tests/test_torch_llama.py)
ATOL_SELF = 1e-5  # port scan vs port flat
J_CFG = j_llama.LlamaConfig.tiny()
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
INT_STATS = ("n_combos", "n_chunks", "n_steps", "n_generated", "n_prompt_fed")
VARIANTS = ("dense", "w8", "w4", "w4_fused")
REQS = [[1, 7, 3, 9, 2], [5, 2], [8, 8, 1], [4, 4, 4, 4, 4, 4]]
PROMPTS = [[1, 7, 3], [5, 2, 8, 9]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_params(variant):
    p = j_llama.llama_init(J_CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)  # gammas other than 1, so folding is exercised
    p["layers"] = [{**l, "input_norm": jnp.asarray(1 + 0.1 * rng.normal(size=64), jnp.float32),
                    "post_norm": jnp.asarray(1 + 0.1 * rng.normal(size=64), jnp.float32)}
                   for l in p["layers"]]
    if variant == "dense":
        return p
    if variant == "w4_fused":
        p = j_llama.fold_llama_norms(p)
    bits = 8 if variant == "w8" else 4
    qp, _ = j_qmp(p, JSpec(fmt="int", bits=bits, group_size=32, symmetric=False))
    return j_llama.fuse_llama_projections(qp) if variant == "w4_fused" else qp


@pytest.fixture(scope="module")
def models():
    """variant -> (JAX params, port params), built on first use."""
    return {}


def _pair(models, variant):
    if variant not in models:
        jp = _jax_params(variant)
        models[variant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return models[variant]


def _tokens(s=12, seed=0):
    return np.random.default_rng(seed).integers(0, 250, size=(2, s))


def _bits(a):
    return a.detach().contiguous().view(torch.uint8).numpy()


def assert_same_tree(got, want):
    """Equal structure; tensors equal in dtype, shape and bytes; equal
    artifact and fused-linear fields."""
    if isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor)
        for f in ("spec", "shape", "mode", "k_shards", "n_pad", "k_pad", "side_pad"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("qweight", "scales", "zeros", "codebook"):
            assert_same_tree(getattr(got, f), getattr(want, f))
    elif isinstance(want, FusedLinear):
        assert isinstance(got, FusedLinear) and got.spans == want.spans
        assert_same_tree(got.w, want.w)
        assert_same_tree(got.b, want.b)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _port_of_jax(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("variant", VARIANTS)
def test_stacked_params_equal_jax(models, variant):
    jp, tp = _pair(models, variant)
    want = _port_of_jax(j_common.stack_model_layers(jp))
    got = t_common.stack_model_layers(tp)
    assert "layers" in tp and "layers" not in got  # the caller's tree is kept
    assert_same_tree(got, want)
    if variant == "w4":  # 2 and 4 side rows padded to 8
        assert got["layers_stacked"]["q"]["w"].side_pad == 6
        assert got["layers_stacked"]["down"]["w"].side_pad == 4
    if variant == "w4_fused":
        assert isinstance(got["layers_stacked"]["qkv"], FusedLinear)
        assert got["layers_stacked"]["input_norm"] is None
        copy = {**tp, "layers": [dict(l) for l in tp["layers"]]}
        consumed = t_common.stack_model_layers(copy, consume=True)
        assert "layers" not in copy
        assert_same_tree(consumed, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_scan_forward_matches_jax_and_flat(models, variant):
    jp, tp = _pair(models, variant)
    toks = _tokens()
    want, _ = j_llama.llama_forward_scan(j_common.stack_model_layers(jp), jnp.asarray(toks),
                                         J_CFG)
    flat, _ = t_llama.llama_forward(tp, torch.from_numpy(toks), T_CFG)
    got, caches = t_llama.llama_forward_scan(t_common.stack_model_layers(tp),
                                             torch.from_numpy(toks), T_CFG)
    assert caches is None and got.shape == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), atol=ATOL_SELF, rtol=0)


@pytest.mark.parametrize("variant,kv_bits", [("dense", 16), ("w4", 16), ("dense", 8),
                                             ("w4_fused", 8), ("w4", 4)])
def test_cached_decode_matches_jax_and_flat(models, variant, kv_bits):
    """A 12-token prefill and one decode step on a stacked cache."""
    jp, tp = _pair(models, variant)
    toks = _tokens(seed=1)
    kv = dict(max_seq_len=32, kv_bits=kv_bits, kv_group_size=16)
    shape = (J_CFG.num_layers, 2, J_CFG.num_kv_heads, J_CFG.hd)
    jc = j_kv.make_stacked_caches(*shape, JKV(**kv), jnp.float32)
    tc = t_kv.make_stacked_caches(*shape, KVCacheConfig(**kv), torch.float32, "cpu")
    fc = t_kv.make_caches(*shape, KVCacheConfig(**kv), torch.float32, "cpu")
    js, ts = j_common.stack_model_layers(jp), t_common.stack_model_layers(tp)
    nxt = None
    for step in range(2):
        x = toks if step == 0 else nxt
        want, jc = j_llama.llama_forward_scan(js, jnp.asarray(x), J_CFG, caches=jc)
        got, tc = t_llama.llama_forward_scan(ts, torch.from_numpy(x), T_CFG, caches=tc)
        flat, fc = t_llama.llama_forward(tp, torch.from_numpy(x), T_CFG, caches=fc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), atol=ATOL_SELF, rtol=0)
        nxt = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    assert tc.length == (13, 13) == tuple(int(n) for n in jc.length)


def _stamped(kv_bits, lens, valid):
    shape = (J_CFG.num_layers, 2, J_CFG.num_kv_heads, J_CFG.hd)
    kv = dict(max_seq_len=32, kv_bits=kv_bits, kv_group_size=16)
    flat = t_kv.make_caches(*shape, KVCacheConfig(**kv), torch.float32, "cpu")
    stacked = t_kv.make_stacked_caches(*shape, KVCacheConfig(**kv), torch.float32, "cpu")
    jst = j_kv.make_stacked_caches(*shape, JKV(**kv), jnp.float32)
    tl = torch.tensor(lens)
    tv = None if valid is None else torch.tensor(valid)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    return (t_engine._stamp(flat, tl, tv), t_engine._stamp(stacked, tl, tv),
            j_engine._stamp(jst, jnp.asarray(lens, jnp.int32), jv, None))


@pytest.mark.parametrize("kv_bits,s,lens,valid", [
    (16, 4, [3, 0], [2, 4]), (8, 4, [3, 0], [2, 4]), (4, 4, [3, 0], [2, 4]),
    (8, 1, [5, 2], None), (16, 4, [30, 1], None)])
def test_slot_local_writes_match_flat_and_jax(kv_bits, s, lens, valid):
    """Stacked writes with [L, B] lengths, with valid (the wave) and without
    (the chunk steps) equal the flat views' reads, and the JAX stacked
    writes' but past the end of the cache (a slot whose request has ended:
    the flat rule clamps the start there, the JAX stacked scatter drops the
    columns); the lengths advance on every layer."""
    flat, stacked, jst = _stamped(kv_bits, lens, valid)
    assert len(stacked.length) == J_CFG.num_layers  # [L, B]: one [B] tensor a layer
    rng = np.random.default_rng(7)
    for l in range(J_CFG.num_layers):
        k_new, v_new = (rng.normal(size=(2, s, J_CFG.num_kv_heads, J_CFG.hd)).astype(np.float32)
                        for _ in range(2))
        kt, vt = torch.from_numpy(k_new), torch.from_numpy(v_new)
        flat[l], kf, vf = t_kv.update_and_fetch(flat[l], kt, vt)
        at, ks, vs = t_kv.update_and_fetch(t_kv.StackedCacheAt(stacked, l), kt, vt)
        stacked = at.caches
        jat, kj, vj = j_kv.update_and_fetch(j_kv.StackedCacheAt(jst, l), jnp.asarray(k_new),
                                            jnp.asarray(v_new))
        jst = jat.caches
        if valid is not None:  # kept for the next layer
            assert torch.equal(stacked.valid, torch.tensor(valid))
        np.testing.assert_array_equal(ks.numpy(), kf.numpy())
        np.testing.assert_array_equal(vs.numpy(), vf.numpy())
        if lens != [30, 1]:
            np.testing.assert_array_equal(ks.numpy(), np.asarray(kj))
            np.testing.assert_array_equal(vs.numpy(), np.asarray(vj))
    adv = np.asarray(valid if valid is not None else [s, s])
    got = torch.stack(stacked.length).numpy()
    np.testing.assert_array_equal(got, np.tile(np.asarray(lens) + adv, (2, 1)))
    np.testing.assert_array_equal(np.asarray(jst.length), got)


def _engine_pair(models, kv_bits, forward_pair=(j_llama.llama_forward_scan,
                                                t_llama.llama_forward_scan)):
    jp, tp = _pair(models, "w4")
    kv = dict(max_seq_len=32, kv_bits=kv_bits, kv_group_size=16)
    je = JEngine(jp, J_CFG, forward_pair[0], family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(**kv), max_batch_size=2,
                                          fuse_projections=True))
    te = InferenceEngine(tp, T_CFG, forward_pair[1], family="llama",
                         engine_cfg=EngineConfig(kv=KVCacheConfig(**kv), max_batch_size=2,
                                                 fuse_projections=True), device="cpu")
    return je, te


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_scan_engine_tokens_and_stats_match_jax(models, kv_bits):
    je, te = _engine_pair(models, kv_bits)
    assert "layers" not in te.params
    assert te.generate(PROMPTS, max_new_tokens=4) == je.generate(PROMPTS, max_new_tokens=4)
    js, ts = {}, {}
    want = je.serve(REQS, max_new_tokens=5, chunk=3, stats=js)
    assert te.serve(REQS, max_new_tokens=5, chunk=3, stats=ts) == want
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}


def test_engine_auto_stacks_fused_params(models):
    """Flat params + a scan forward: fused first, then stacked; the same
    tokens as the flat engine."""
    _, tp = _pair(models, "w4")
    ecfg = EngineConfig(kv=KVCacheConfig(max_seq_len=32), max_batch_size=2,
                        fuse_projections=True)
    scan = InferenceEngine(tp, T_CFG, t_llama.llama_forward_scan, family="llama",
                           engine_cfg=ecfg, device="cpu")
    st = scan.params["layers_stacked"]
    assert isinstance(st["qkv"], FusedLinear) and isinstance(st["gate_up"], FusedLinear)
    assert st["qkv"].w.qweight.shape[0] == T_CFG.num_layers and "q" not in st
    assert "layers" in tp  # the caller's params are not consumed
    flat = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                           engine_cfg=ecfg, device="cpu")
    assert scan.generate(PROMPTS, max_new_tokens=4) == flat.generate(PROMPTS, max_new_tokens=4)


def test_scan_path_is_chosen_by_the_mark_not_the_name(models):
    _, tp = _pair(models, "w4")
    ecfg = EngineConfig(kv=KVCacheConfig(max_seq_len=32), max_batch_size=2)

    def llama_forward_scan(*args, **kw):  # the name of a scan forward, no mark
        return t_llama.llama_forward(*args, **kw)

    @t_common.scan_forward
    def stacked_llama(*args, **kw):  # another name, marked
        return t_llama.llama_forward_scan(*args, **kw)

    unmarked = InferenceEngine(tp, T_CFG, llama_forward_scan, engine_cfg=ecfg, device="cpu")
    marked = InferenceEngine(tp, T_CFG, stacked_llama, engine_cfg=ecfg, device="cpu")
    assert "layers" in unmarked.params and "layers_stacked" in marked.params
    assert t_common.is_scan_forward(t_llama.llama_forward_scan)
    assert not t_common.is_scan_forward(t_llama.llama_forward)
    assert marked.generate(PROMPTS, max_new_tokens=3) == unmarked.generate(PROMPTS,
                                                                          max_new_tokens=3)


def test_paged_stacked_raises(models):
    _, tp = _pair(models, "w4")
    kv = KVCacheConfig(max_seq_len=32, paged=True, page_size=8)
    eng = InferenceEngine(t_common.stack_model_layers(tp), T_CFG, t_llama.llama_forward_scan,
                          engine_cfg=EngineConfig(kv=kv, max_batch_size=2), device="cpu")
    with pytest.raises(NotImplementedError):
        eng.generate([[1, 2, 3]], max_new_tokens=2)
    with pytest.raises(NotImplementedError):
        eng.serve([[1, 2, 3]], max_new_tokens=2)
    with pytest.raises(NotImplementedError):
        t_kv.make_stacked_caches(2, 2, 2, 16, kv, torch.float32, "cpu")
