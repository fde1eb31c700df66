"""Port parity: ``InferenceEngine.generate`` gives the JAX engine's tokens.

Greedy tokens must be exactly equal on a tiny W4 model: prompts of unequal
length (left padding), a prefill chunk shorter than the longest prompt,
``decode_chunk`` 1 and 16, fused and unfused projections, and an EOS that
stops one row early.
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
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig, MeshConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.engine.engine import sample_tokens
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import llama as t_llama

J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [1, 2], [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
NEW = 12


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
    p = j_llama.fold_llama_norms(j_llama.llama_init(J_CFG, jax.random.PRNGKey(3)))
    spec = JSpec(fmt="int", bits=4, group_size=128, symmetric=False)

    def q(lin):
        return {**lin, "w": j_quantize(lin["w"], spec, pad_n_to=512)}

    jp = {**p, "lm_head": q(p["lm_head"]),
          "layers": [{k: (q(v) if isinstance(v, dict) else v) for k, v in l.items()}
                     for l in p["layers"]]}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _run(models, eos=-1, **ecfg):
    jp, tp = models
    kw = dict(prefill_chunk=4, **ecfg)
    je = JEngine(jp, J_CFG, j_llama.llama_forward, family="llama", eos_token=eos,
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=64), **kw))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama", eos_token=eos,
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=64), **kw),
                         device="cpu")
    return je.generate(PROMPTS, max_new_tokens=NEW), te.generate(PROMPTS, max_new_tokens=NEW)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("decode_chunk", [1, 16])
def test_greedy_tokens_match_jax(models, decode_chunk, fuse):
    want, got = _run(models, decode_chunk=decode_chunk, fuse_projections=fuse)
    assert [len(o) for o in got] == [NEW] * len(PROMPTS)
    assert got == want


@pytest.mark.parametrize("decode_chunk", [1, 16])
def test_eos_stops_a_row_like_jax(models, decode_chunk):
    _, free = _run(models, decode_chunk=decode_chunk, fuse_projections=True)
    eos = free[0][3]
    want, got = _run(models, eos=eos, decode_chunk=decode_chunk, fuse_projections=True)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 4


def test_prefill_chunk_does_not_change_tokens(models):
    _, tp = models
    outs = []
    for chunk in (2, 512):
        eng = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                              engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=64),
                                                      prefill_chunk=chunk),
                              device="cpu")
        outs.append(eng.generate(PROMPTS, max_new_tokens=6))
    assert outs[0] == outs[1]


def test_sampling_is_seeded_and_top_k_bounded():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 50)).astype(np.float32))
    draws = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(7)
        draws.append(sample_tokens(logits, g, temperature=1.0, top_k=3))
    assert torch.equal(draws[0], draws[1])
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(t) in top3[i].tolist() for i, t in enumerate(draws[0]))
    np.testing.assert_array_equal(sample_tokens(logits, None, 0.0).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)))


@pytest.mark.parametrize("ecfg", [
    dict(mesh=MeshConfig(model=2)),
], ids=["mesh"])
def test_unported_engine_options_raise(models, ecfg):
    """A mesh of more ranks than the process's world (here one process with
    no group) is refused: no engine runs on fewer ranks than it was given
    (the mesh itself runs across ranks: tests/test_torch_parallel_ranks.py)."""
    _, tp = models
    with pytest.raises(ValueError, match="world size 1 differs from data x model"):
        InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                        engine_cfg=EngineConfig(**ecfg), device="cpu")


def test_generate_refuses_an_overlong_request(models):
    _, tp = models
    eng = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                          engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=16)),
                          device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(PROMPTS, max_new_tokens=8)
    with pytest.raises(ValueError, match="empty"):
        eng.generate([[1], []], max_new_tokens=2)
