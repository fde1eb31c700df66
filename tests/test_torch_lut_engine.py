"""Port parity: the engine on a minifloat (fp4, fp6) LLaMA gives the JAX tokens.

A tiny fp4 LLaMA (hidden 256, FFN 512, 2 layers, vocab 256; every linear
and the lm_head fp4 E2M1 g128 asymmetric with ``pad_n_to=512``, norms
folded, projections fused), in f32.  The dense weights are drawn once (the
port's ``llama_init``, seeded) and quantized by the port; the JAX model
gets the same bytes and codebooks (the port's fp artifacts are
byte-identical to the JAX quantizer's, ``tests/test_torch_formats.py``).
The same model with fp6 E2M3 g128 symmetric linears (nq42 storage, K
padded to 512: the least stored K whose quarters the JAX kernel's 128-row
tiles divide) takes ``lut6_matmul`` and, under A16, ``lut6a16_matmul``
(the JAX model ``_lut6_kernel_a16``), with the same checks.

* bf16/f32 activations: on the CPU the JAX engine's linears take the XLA
  path (normalize x, then the dequantized matmul); the port's linears take
  the plain ``lut4_matmul`` version (x normalized first: LUT has no prenorm
  kernel).  Greedy ``generate`` tokens, and ``serve`` tokens and integer
  ``stats`` with ``chunk`` 1 and 4, are exactly equal.
* A16 (``prefill_activation_bits`` and ``activation_bits`` 16; LUT has no
  A8): the JAX XLA path ignores activation bits, so the JAX model's
  linears are routed through the Pallas kernels in interpret mode
  (``_lut4_kernel_a16``), as ``tests/test_torch_actquant_engine.py`` does;
  the port's take the plain ``lut4a16_matmul``.  ``serve`` tokens and
  integer ``stats`` are exactly equal.
"""

import functools

import jax.numpy as jnp
import pytest
import torch

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.ops.pallas.dequant_matmul import fused_quantized_matmul
from iron_weight_only_quant_tpu.quantize.qtensor import QuantizedTensor as JQuantizedTensor
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig, fp_spec
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor, quantize_tensor

J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
FP4 = dict(group_size=128, symmetric=False)
# format -> (fp_spec arguments, keyword arguments, pad_k_to)
FORMATS = {"fp4": (("fp4", 2, 1), FP4, 1), "fp6": (("fp6", 2, 3), dict(group_size=128), 512)}

INT_STATS = ("n_combos", "n_chunks", "n_steps", "n_generated", "n_prompt_fed")
T_MAX = 48
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [1, 2], [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
REQS = [[(7 * i + j) % 255 + 1 for j in range(2 + 2 * i)] for i in range(5)]  # 5 over 4 slots
PER_FORWARD = 4 * T_CFG.num_layers + 1  # qkv, o, gate_up, down per layer; the lm_head


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain LUT path runs small CPU matmuls that gain nothing
    from many torch threads; in the parallel test run those only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_jax(v, fmt="fp4"):
    if isinstance(v, dict):
        return {k: _to_jax(x, fmt) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_jax(x, fmt) for x in v]
    if isinstance(v, torch.Tensor):
        return jnp.asarray(v.numpy())
    if isinstance(v, QuantizedTensor):
        args, kw, _ = FORMATS[fmt]
        return JQuantizedTensor(_to_jax(v.qweight), _to_jax(v.scales), _to_jax(v.zeros),
                                _to_jax(v.codebook), j_fp_spec(*args, **kw), v.shape,
                                v.mode, v.k_shards, v.n_pad, v.k_pad, v.side_pad)
    assert v is None, type(v)
    return None


@functools.lru_cache(maxsize=None)
def _models(fmt="fp4"):
    """(JAX params, port params) of the tiny LLaMA of format ``fmt``, unfused."""
    tp = t_llama.fold_llama_norms(t_llama.llama_init(
        T_CFG, torch.Generator().manual_seed(7), device="cpu"))
    args, kw, pad_k_to = FORMATS[fmt]
    spec = fp_spec(*args, **kw)
    for lin in [tp["lm_head"]] + [v for layer in tp["layers"] for v in layer.values()
                                  if isinstance(v, dict)]:
        lin["w"] = quantize_tensor(lin["w"], spec, pad_n_to=512, pad_k_to=pad_k_to)
    return _to_jax(tp, fmt), tp


def _engines(forward=j_llama.llama_forward, fmt="fp4", **ecfg):
    jp, tp = _models(fmt)
    kw = dict(max_batch_size=4, fuse_projections=True, **ecfg)
    je = JEngine(jp, J_CFG, forward, family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=T_MAX), **kw))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=T_MAX), **kw),
                         device="cpu")
    return je, te


def _only(name, n_forwards):
    return {**{k: 0 for k in dm.PLAIN_CALLS}, name: n_forwards * PER_FORWARD}


def test_every_linear_takes_the_lut_kernels():
    _, tp = _models()
    fused = t_llama.fuse_llama_projections(tp)
    lins = [fused["lm_head"]["w"]] + [
        layer[k].w if k in ("qkv", "gate_up") else layer[k]["w"]
        for layer in fused["layers"] for k in ("qkv", "o", "gate_up", "down")]
    assert len(lins) == PER_FORWARD
    for qt in lins:
        assert qt.mode == "lut" and qt.zeros is not None and not dm.xla_route(qt)
        assert dm.kernel_supported(qt) and dm.kernel_name(qt, 1e-5) == dm.LUT4
        assert dm.kernel_supported(qt, 16) and dm.kernel_name(qt, 1e-5, 16) == dm.LUT4A16
        assert not dm.kernel_supported(qt, 8)


def test_generate_tokens_match_jax():
    je, te = _engines(prefill_chunk=4)
    want = je.generate(PROMPTS, max_new_tokens=6)
    dm.reset_counts()
    got = te.generate(PROMPTS, max_new_tokens=6)
    assert [len(o) for o in got] == [6] * len(PROMPTS)
    assert got == want
    # prefill in chunks of 4 (11 tokens: 3 forwards), then 5 decode steps
    assert dm.PLAIN_CALLS == _only(dm.LUT4, 3 + 5)
    assert not any(dm.ROUTE_CALLS.values())


@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_tokens_and_stats_match_jax(chunk):
    je, te = _engines()
    js, ts = {}, {}
    want = je.serve(REQS, max_new_tokens=4, chunk=chunk, stats=js)
    dm.reset_counts()
    got = te.serve(REQS, max_new_tokens=4, chunk=chunk, stats=ts)
    assert [len(o) for o in got] == [4] * len(REQS)
    assert got == want
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert dm.PLAIN_CALLS == _only(dm.LUT4, ts["n_steps"])


def _routed_forward(*args, **kw):
    """Only ever traced with the routing patch (the JAX engine's jitted
    phases key their cache on the forward)."""
    return j_llama.llama_forward(*args, **kw)


@pytest.fixture
def routed(monkeypatch):
    """Route the JAX model's linears through the Pallas kernels (interpret
    mode) with the ambient activation bits."""

    def quantized_matmul(x, qt, bias=None, *, pre_norm=None, **_):
        out = fused_quantized_matmul(x, qt, interpret=True, pre_norm=pre_norm,
                                     activation_bits=j_qmatmul._DEFAULT_ACTIVATION_BITS)
        if bias is not None:
            out = out + bias
        return out.astype(x.dtype)

    monkeypatch.setattr(j_common, "quantized_matmul", quantized_matmul)


def test_a16_serve_tokens_and_stats_match_jax(routed):
    je, te = _engines(_routed_forward, prefill_activation_bits=16, activation_bits=16)
    js, ts = {}, {}
    want = je.serve(REQS, max_new_tokens=4, chunk=4, stats=js)
    dm.reset_counts()
    got = te.serve(REQS, max_new_tokens=4, chunk=4, stats=ts)
    assert [len(o) for o in got] == [4] * len(REQS)
    assert got == want
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert dm.PLAIN_CALLS == _only(dm.LUT4A16, ts["n_steps"])


def test_fp6_every_linear_takes_the_lut6_kernels():
    _, tp = _models("fp6")
    fused = t_llama.fuse_llama_projections(tp)
    lins = [fused["lm_head"]["w"]] + [
        layer[k].w if k in ("qkv", "gate_up") else layer[k]["w"]
        for layer in fused["layers"] for k in ("qkv", "o", "gate_up", "down")]
    assert len(lins) == PER_FORWARD
    for qt in lins:
        assert qt.mode == "lut" and qt.zeros is None and dm.packed_bits(qt) == 6
        assert qt.k_stored == 512 and not dm.xla_route(qt)
        assert dm.kernel_supported(qt) and dm.kernel_name(qt, 1e-5) == dm.LUT6
        assert dm.kernel_supported(qt, 16) and dm.kernel_name(qt, 1e-5, 16) == dm.LUT6A16


def test_fp6_generate_tokens_match_jax():
    je, te = _engines(fmt="fp6", prefill_chunk=4)
    want = je.generate(PROMPTS, max_new_tokens=6)
    dm.reset_counts()
    got = te.generate(PROMPTS, max_new_tokens=6)
    assert [len(o) for o in got] == [6] * len(PROMPTS)
    assert got == want
    assert dm.PLAIN_CALLS == _only(dm.LUT6, 3 + 5)
    assert not any(dm.ROUTE_CALLS.values())


def test_fp6_serve_tokens_and_stats_match_jax():
    je, te = _engines(fmt="fp6")
    js, ts = {}, {}
    want = je.serve(REQS, max_new_tokens=4, chunk=4, stats=js)
    dm.reset_counts()
    got = te.serve(REQS, max_new_tokens=4, chunk=4, stats=ts)
    assert [len(o) for o in got] == [4] * len(REQS)
    assert got == want
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert dm.PLAIN_CALLS == _only(dm.LUT6, ts["n_steps"])


def test_fp6_a16_serve_tokens_and_stats_match_jax(routed):
    """The JAX linears through ``_lut6_kernel_a16`` in interpret mode."""
    je, te = _engines(_routed_forward, fmt="fp6", prefill_activation_bits=16,
                      activation_bits=16)
    js, ts = {}, {}
    want = je.serve(REQS, max_new_tokens=4, chunk=4, stats=js)
    dm.reset_counts()
    got = te.serve(REQS, max_new_tokens=4, chunk=4, stats=ts)
    assert [len(o) for o in got] == [4] * len(REQS)
    assert got == want
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert dm.PLAIN_CALLS == _only(dm.LUT6A16, ts["n_steps"])
