"""Port parity: ``generate`` and ``serve`` on quantized and paged KV caches.

A tiny W4 LLaMA (2 layers, hidden 256, f32), quantized once by the JAX
package and carried across as numpy: greedy ``generate`` and ``serve``
tokens and the integer ``stats`` equal to the JAX engine's under
``kv_bits`` 8 and 4, paged 16-bit, paged int8 and a small pool (8
requests through 5 pages), at chunk 1 and 4 (the cases of
``tests/test_paged_kv.py``'s ``TestPagedEngine``); paged serves give their
contiguous serves' tokens; a pool below the traffic's peak raises in both
engines.
"""

import numpy as np
import pytest
import torch

import jax

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.engine import kvcache as tkv
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import llama as t_llama

J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
INT_STATS = ("n_combos", "n_chunks", "n_steps", "n_generated", "n_prompt_fed")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls and many small ops that
    gain nothing from many torch threads; in the parallel test run those
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    p = j_llama.fold_llama_norms(j_llama.llama_init(J_CFG, jax.random.PRNGKey(7)))
    spec = JSpec(fmt="int", bits=4, group_size=128, symmetric=False)

    def q(lin):
        return {**lin, "w": j_quantize(lin["w"], spec, pad_n_to=512)}

    jp = {**p, "lm_head": q(p["lm_head"]),
          "layers": [{k: (q(v) if isinstance(v, dict) else v) for k, v in l.items()}
                     for l in p["layers"]]}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


KV_SETTINGS = {
    "kv8": dict(kv_bits=8),
    "kv4_g32": dict(kv_bits=4, kv_group_size=32),
    "paged16": dict(paged=True, page_size=16),
    "paged_kv8_g8": dict(paged=True, page_size=16, kv_bits=8, kv_group_size=8),
    "small_pool": dict(paged=True, page_size=16, num_pages=6),
}
PROMPTS = [[5, 2, 8], [1, 7, 3, 9, 2, 4, 6], [11]]
REQS = [[5, 2, 8], [1, 7, 3], [11, 4], [9, 9, 9, 9], [2, 3], [8], [4, 4, 1], [6, 7]]


def _engines(models, **kv):
    jp, tp = models
    je = JEngine(jp, J_CFG, j_llama.llama_forward, family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=64, **kv), max_batch_size=4))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=64, **kv),
                                                 max_batch_size=4),
                         device="cpu")
    return je, te


@pytest.mark.parametrize("setting", list(KV_SETTINGS))
def test_engine_tokens_and_stats_match_jax(models, setting):
    je, te = _engines(models, **KV_SETTINGS[setting])
    if setting != "small_pool":  # generate runs on the default table, no allocator
        assert te.generate(PROMPTS, max_new_tokens=6) == je.generate(PROMPTS, max_new_tokens=6)
    for chunk in (1, 4):
        js, ts = {}, {}
        want = je.serve(REQS, max_new_tokens=5, chunk=chunk, stats=js)
        got = te.serve(REQS, max_new_tokens=5, chunk=chunk, stats=ts)
        assert got == want
        assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
        if KV_SETTINGS[setting].get("paged"):
            usable = tkv.pool_pages(4, te.engine_cfg.kv) - 1
            assert ts["pages_peak"] <= usable
            if setting == "small_pool":  # 8 requests through 5 pages
                assert ts["n_page_allocs"] > usable


def test_paged_serve_matches_the_contiguous_serve(models):
    """Paging changes where the cache lives, not the tokens."""
    outs = []
    for kv in ({}, dict(paged=True, page_size=16), dict(kv_bits=8),
               dict(kv_bits=8, paged=True, page_size=16)):
        _, te = _engines(models, **kv)
        outs.append(te.serve(REQS, max_new_tokens=5, chunk=4))
    assert outs[0] == outs[1] and outs[2] == outs[3]


def test_pool_too_small_raises_like_jax(models):
    """Admission waits only while the pool has no free page, and a released
    slot always frees one: a pool below the traffic's peak raises, in both
    engines, rather than waiting."""
    je, te = _engines(models, paged=True, page_size=16, num_pages=3)
    reqs = [[1, 2, 3]] * 4
    with pytest.raises(RuntimeError, match="exhausted"):
        je.serve(reqs, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="exhausted"):
        te.serve(reqs, max_new_tokens=2)
    _, te = _engines(models, paged=True, page_size=16, num_pages=1)
    with pytest.raises(ValueError, match="page beside"):
        te.serve(reqs, max_new_tokens=2)
