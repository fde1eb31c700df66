"""Port parity: ``InferenceEngine.serve`` gives the JAX engine's tokens.

Greedy continuous batching on tiny W4 and W8 LLaMAs (2 layers, hidden 256,
weights quantized once by the JAX package and carried across as numpy)
must give exactly the JAX engine's tokens and the same integer ``stats``
counts: ``chunk`` 1, 4 and 16, more requests than slots, prompts longer
than the prefill bucket (several waves per prompt), and an EOS that frees a
slot early.  Also: the sync-free ``valid`` KV write gives the bytes of the
JAX ``update_kv_cache``, and serve refuses what the JAX engine refuses.
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
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import common as t_common
from iron_weight_only_quant_tpu_torch.models import llama as t_llama

J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
SPECS = {
    "w4": JSpec(fmt="int", bits=4, group_size=128, symmetric=False),
    "w8": JSpec(fmt="int", bits=8, group_size=128, symmetric=False),
}
INT_STATS = ("n_combos", "n_chunks", "n_steps", "n_generated", "n_prompt_fed")
T_MAX = 64


def _requests(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, J_CFG.vocab_size, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


# 6 requests over 4 slots: queued admission and slot reuse
REQS = _requests(6, 2, 13, seed=11)
# prompts of 20-30 tokens with an 8-token prefill bucket: several waves each
LONG = _requests(3, 20, 30, seed=12)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls and many small ops that
    gain nothing from many torch threads; in the parallel test run those
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(SPECS))
def models(request):
    p = j_llama.fold_llama_norms(j_llama.llama_init(J_CFG, jax.random.PRNGKey(5)))
    spec = SPECS[request.param]

    def q(lin):
        return {**lin, "w": j_quantize(lin["w"], spec, pad_n_to=512)}

    jp = {**p, "lm_head": q(p["lm_head"]),
          "layers": [{k: (q(v) if isinstance(v, dict) else v) for k, v in l.items()}
                     for l in p["layers"]]}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engines(models, eos=-1, **ecfg):
    jp, tp = models
    kw = dict(max_batch_size=4, fuse_projections=True, **ecfg)
    je = JEngine(jp, J_CFG, j_llama.llama_forward, family="llama", eos_token=eos,
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=T_MAX), **kw))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama", eos_token=eos,
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=T_MAX), **kw),
                         device="cpu")
    return je, te


def _serve_both(models, reqs, new, chunk, eos=-1, **ecfg):
    je, te = _engines(models, eos=eos, **ecfg)
    js, ts = {}, {}
    want = je.serve(reqs, max_new_tokens=new, chunk=chunk, stats=js)
    got = te.serve(reqs, max_new_tokens=new, chunk=chunk, stats=ts)
    return want, got, js, ts


def _same_counts(js, ts):
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert len(ts["ttft_s"]) == len(js["ttft_s"])
    assert len(ts["tpot_s"]) == len(js["tpot_s"])


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_serve_tokens_match_jax(models, chunk):
    want, got, js, ts = _serve_both(models, REQS, 6, chunk)
    assert [len(o) for o in got] == [6] * len(REQS)
    assert got == want
    _same_counts(js, ts)


@pytest.mark.parametrize("chunk", [1, 16])
def test_serve_multi_wave_prompts_match_jax(models, chunk):
    want, got, js, ts = _serve_both(models, LONG, 5, chunk, prefill_chunk=8)
    assert got == want
    # no prompt fits one 8-token wave: the rest streams through the chunk
    # feed or a later wave
    assert min(len(r) for r in LONG) > 8 and ts["n_combos"] >= 2
    _same_counts(js, ts)


def test_serve_eos_frees_a_slot_like_jax(models):
    _, free, _, _ = _serve_both(models, REQS, 6, 4)
    eos = free[0][1]
    want, got, js, ts = _serve_both(models, REQS, 6, 4, eos=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == 2
    _same_counts(js, ts)


def test_serve_matches_generate_per_request(models):
    _, te = _engines(models)
    served = te.serve(REQS[:2], max_new_tokens=5, chunk=4)
    assert served == [te.generate([r], max_new_tokens=5)[0] for r in REQS[:2]]


def test_serve_sampling_is_seeded(models):
    _, te = _engines(models)
    runs = [te.serve(REQS, max_new_tokens=4, chunk=4, temperature=1.0, top_k=5, seed=s)
            for s in (3, 3)]
    assert runs[0] == runs[1]
    assert all(0 <= t < T_CFG.vocab_size for out in runs[0] for t in out)


def test_serve_refuses_like_jax(models):
    je, te = _engines(models)
    for eng in (je, te):
        with pytest.raises(ValueError, match="empty"):
            eng.serve([[1, 2], []], max_new_tokens=2)
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.serve([[1] * 40], max_new_tokens=T_MAX - 39)


@pytest.mark.parametrize("case", [
    # start, valid per slot (T_MAX 12, S 5)
    ([0, 3, 9, 11], [5, 2, 5, 0]),
    ([10, 0, 7, 2], [1, 0, 5, 3]),
    ([11, 11, 0, 4], [5, 1, 0, 5]),
], ids=["mixed", "piggyback", "at_the_end"])
def test_valid_write_gives_the_jax_bytes(case):
    start, valid = case
    rng = np.random.default_rng(sum(start))
    b, t, h, d, s = 4, 12, 2, 8, 5
    k0, v0 = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    st, va = np.asarray(start, np.int32), np.asarray(valid, np.int32)
    want = j_common.update_kv_cache(
        j_common.KVCacheView(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(st),
                             jnp.asarray(va)),
        jnp.asarray(kn), jnp.asarray(vn))
    view = t_common.KVCacheView(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()),
                                torch.from_numpy(st).long(), torch.from_numpy(va).long())
    got = t_common.update_kv_cache(view, torch.from_numpy(kn), torch.from_numpy(vn))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    assert got.valid is None
