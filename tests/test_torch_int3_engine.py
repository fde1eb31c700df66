"""Port parity: the engine on a 3-bit (s21) LLaMA gives the JAX tokens.

A tiny W3 LLaMA (hidden 1024, FFN 2048, 2 layers, vocab 256: the least
widths whose every linear the s21 kernels take at group 128, in the JAX
package as in the port; every linear and the lm_head int3 g128 asym with
``pad_n_to=512``, norms folded, projections fused), with full-precision
activations in f32.  The dense weights are drawn once (the port's
``llama_init``, seeded) and quantized by the port; the JAX model gets the
same bytes (the port's 3-bit artifacts are byte-identical to the JAX
quantizer's, ``tests/test_torch_rtn.py``; quantizing here saves the JAX
compile of every weight shape); ``tests/test_torch_int3_actquant_engine.py``
uses the same model.

On the CPU the JAX engine's linears take the XLA path (normalize x, then
the dequantized matmul), which is what the port's plain W3 version computes
since a 3-bit ``pre_norm`` normalizes x first: greedy ``generate`` tokens,
and ``serve`` tokens and integer ``stats`` with ``chunk`` 1 and 4, are
exactly equal, and every linear call counts under ``w3_matmul``.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize.qtensor import QuantizedTensor as JQuantizedTensor
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.config import QuantSpec as TSpec
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor, quantize_tensor

J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=1024, intermediate_size=2048,
                            num_layers=2, num_heads=8, num_kv_heads=4,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
W3 = dict(fmt="int", bits=3, group_size=128, symmetric=False)

INT_STATS = ("n_combos", "n_chunks", "n_steps", "n_generated", "n_prompt_fed")
T_MAX = 48
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [1, 2], [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
REQS = [[(7 * i + j) % 255 + 1 for j in range(2 + 2 * i)] for i in range(5)]  # 5 over 4 slots
PER_FORWARD = 4 * T_CFG.num_layers + 1  # qkv, o, gate_up, down per layer; the lm_head


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain W3 path runs small CPU matmuls that gain nothing
    from many torch threads; in the parallel test run those only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_jax(v):
    if isinstance(v, dict):
        return {k: _to_jax(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_jax(x) for x in v]
    if isinstance(v, torch.Tensor):
        return jnp.asarray(v.numpy())
    if isinstance(v, QuantizedTensor):
        return JQuantizedTensor(_to_jax(v.qweight), _to_jax(v.scales), _to_jax(v.zeros),
                                None, JSpec(**W3), v.shape, v.mode, v.k_shards, v.n_pad,
                                v.k_pad, v.side_pad)
    assert v is None, type(v)
    return None


def w3_models(seed: int = 5):
    """(JAX params, port params) of the tiny W3 LLaMA, unfused."""
    tp = t_llama.fold_llama_norms(t_llama.llama_init(
        T_CFG, torch.Generator().manual_seed(seed), device="cpu"))
    spec = TSpec(**W3)
    for lin in [tp["lm_head"]] + [v for layer in tp["layers"] for v in layer.values()
                                  if isinstance(v, dict)]:
        lin["w"] = quantize_tensor(lin["w"], spec, pad_n_to=512)
    return _to_jax(tp), tp


@functools.lru_cache(maxsize=None)
def _models():
    return w3_models()


def _engines(**ecfg):
    jp, tp = _models()
    kw = dict(max_batch_size=4, fuse_projections=True, **ecfg)
    je = JEngine(jp, J_CFG, j_llama.llama_forward, family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=T_MAX), **kw))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=T_MAX), **kw),
                         device="cpu")
    return je, te


def _w3_only(n_forwards):
    return {**{k: 0 for k in dm.PLAIN_CALLS}, dm.W3: n_forwards * PER_FORWARD}


def test_every_linear_takes_the_w3_kernels():
    _, tp = _models()
    fused = t_llama.fuse_llama_projections(tp)
    lins = [fused["lm_head"]["w"]] + [
        layer[k].w if k in ("qkv", "gate_up") else layer[k]["w"]
        for layer in fused["layers"] for k in ("qkv", "o", "gate_up", "down")]
    assert len(lins) == PER_FORWARD
    for qt in lins:
        assert dm.kernel_supported(qt) and dm.kernel_name(qt, 1e-5) == dm.W3
        assert dm.kernel_supported(qt, 8) and dm.kernel_name(qt, 1e-5, 8) == dm.W3A8
        assert dm.kernel_supported(qt, 16) and dm.kernel_name(qt, None, 16) == dm.W3A16
    jp, _ = _models()
    assert jax.tree.leaves(jp)  # the JAX model carries the same artifacts
    assert jp["lm_head"]["w"].shape == tp["lm_head"]["w"].shape == (1024, 256)


def test_generate_tokens_match_jax():
    je, te = _engines(prefill_chunk=4)
    want = je.generate(PROMPTS, max_new_tokens=6)
    dm.reset_counts()
    got = te.generate(PROMPTS, max_new_tokens=6)
    assert [len(o) for o in got] == [6] * len(PROMPTS)
    assert got == want
    # prefill in chunks of 4 (11 tokens: 3 forwards), then 5 decode steps
    assert dm.PLAIN_CALLS == _w3_only(3 + 5)


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
    assert dm.PLAIN_CALLS == _w3_only(ts["n_steps"])
