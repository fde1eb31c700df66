"""Port parity: the engine with int8 / A16 activations gives the JAX tokens.

On the CPU the JAX engine's linears take the XLA path, which ignores
activation bits.  So here, and only here, the JAX model's linears are routed
through the Pallas kernels in interpret mode with the ambient activation
bits (``models.common.quantized_matmul`` is patched), while the port's
linears take their plain versions, which compute what the port's kernels
compute.  The tiny LLaMA of ``tests/test_torch_serve.py`` (hidden 256, FFN
512, 2 layers, group 128, ``pad_n_to=512``, norms folded, projections
fused) is quantized once by the JAX package.  Checked: one forward's f32
logits, greedy ``generate`` tokens, ``serve`` tokens and integer ``stats``
with ``chunk`` 1 and 4, under W4 with A8 waves and A16 decode, W8 with A16
waves and A8 decode, and A8-only and A16-only W4; and that the waves and the
decode steps count their plain calls under the kernel of their own bits.
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
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.ops.pallas.dequant_matmul import fused_quantized_matmul
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

J_CFG = j_llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
INT_STATS = ("n_combos", "n_chunks", "n_steps", "n_generated", "n_prompt_fed")
T_MAX = 64
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [1, 2], [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
# (weight bits, prefill_activation_bits, activation_bits)
SETTINGS = {
    "w4_a8_waves_a16_decode": (4, 8, 16),
    "w8_a16_waves_a8_decode": (8, 16, 8),
    "w4_a8": (4, None, 8),
    "w4_a16": (4, None, 16),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls and many small ops that
    gain nothing from many torch threads; in the parallel test run those
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _requests(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, J_CFG.vocab_size, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


REQS = _requests(5, 2, 13, seed=11)  # 5 requests over 4 slots


def _model(bits):
    p = j_llama.fold_llama_norms(j_llama.llama_init(J_CFG, jax.random.PRNGKey(5)))
    spec = JSpec(fmt="int", bits=bits, group_size=128, symmetric=False)

    def q(lin):
        return {**lin, "w": j_quantize(lin["w"], spec, pad_n_to=512)}

    jp = {**p, "lm_head": q(p["lm_head"]),
          "layers": [{k: (q(v) if isinstance(v, dict) else v) for k, v in l.items()}
                     for l in p["layers"]]}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


MODELS = {}


def _models(bits):
    if bits not in MODELS:
        MODELS[bits] = _model(bits)
    return MODELS[bits]


@pytest.fixture
def routed(monkeypatch):
    """Route the JAX model's linears through the Pallas kernels (interpret
    mode) with the ambient activation bits, adding the bias as the original
    ``quantized_matmul`` does."""

    def quantized_matmul(x, qt, bias=None, *, pre_norm=None, **_):
        out = fused_quantized_matmul(x, qt, interpret=True, pre_norm=pre_norm,
                                     activation_bits=j_qmatmul._DEFAULT_ACTIVATION_BITS)
        if bias is not None:
            out = out + bias
        return out.astype(x.dtype)

    monkeypatch.setattr(j_common, "quantized_matmul", quantized_matmul)


def _fresh_forward():
    """A forward the JAX engine has not traced yet: its jitted phases key
    their cache on ``forward``, and a trace made without the patch must not
    be reused."""

    def llama_forward(*args, **kw):
        return j_llama.llama_forward(*args, **kw)

    return llama_forward


def _engines(setting, **ecfg):
    wbits, p_abits, abits = SETTINGS[setting]
    jp, tp = _models(wbits)
    kw = dict(max_batch_size=4, fuse_projections=True, activation_bits=abits,
              prefill_activation_bits=p_abits, **ecfg)
    je = JEngine(jp, J_CFG, _fresh_forward(), family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=T_MAX), **kw))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=T_MAX), **kw),
                         device="cpu")
    return je, te


@pytest.mark.parametrize("bits", [8, 16])
def test_forward_logits_match_jax(routed, bits):
    jp, tp = _models(4)
    jf = j_llama.fuse_llama_projections(jp)
    tf = t_llama.fuse_llama_projections(tp)
    tokens = np.asarray([PROMPTS[0], PROMPTS[2][:7]], np.int32)
    with j_qmatmul.activation_quant(bits):
        want, _ = j_llama.llama_forward(jf, jnp.asarray(tokens), J_CFG)
    with t_qmatmul.activation_quant(bits):
        got, _ = t_llama.llama_forward(tf, torch.from_numpy(tokens).long(), T_CFG)
    want = np.asarray(want)
    # the JAX and torch RMSNorm means and rsqrt differ in the last f32 bit on
    # some rows, so an activation code may round the other way (one step of
    # 1/127 or 1/32512 of the row's maximum): the logits are held to the A8 /
    # A16 tolerances against full precision, the tokens below exactly
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < {8: 1e-2, 16: 2e-4}[bits], rel
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_generate_tokens_match_jax(routed, setting):
    je, te = _engines(setting, prefill_chunk=4)
    want = je.generate(PROMPTS, max_new_tokens=6)
    got = te.generate(PROMPTS, max_new_tokens=6)
    assert [len(o) for o in got] == [6] * len(PROMPTS)
    assert got == want


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("setting", ["w4_a8_waves_a16_decode", "w8_a16_waves_a8_decode"])
def test_serve_tokens_and_stats_match_jax(routed, setting, chunk):
    je, te = _engines(setting)
    js, ts = {}, {}
    want = je.serve(REQS, max_new_tokens=4, chunk=chunk, stats=js)
    got = te.serve(REQS, max_new_tokens=4, chunk=chunk, stats=ts)
    assert [len(o) for o in got] == [4] * len(REQS)
    assert got == want
    assert {k: ts[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}


@pytest.mark.parametrize("setting", ["w4_a8_waves_a16_decode", "w8_a16_waves_a8_decode"])
def test_waves_and_steps_count_under_their_bits(setting):
    """Each forward makes 4 linear calls per layer + the lm_head, the wave's
    under ``prefill_abits()``'s kernel, the decode steps' under
    ``activation_bits``'s; no prenorm kernel stands in under activation bits."""
    wbits, p_abits, abits = SETTINGS[setting]
    _, te = _engines(setting)
    stats = {}
    dm.reset_counts()
    te.serve(REQS, max_new_tokens=5, chunk=4, stats=stats)
    per_forward = 4 * T_CFG.num_layers + 1
    wave, step = (dm.kernel_name(te.params["lm_head"]["w"], None, b) for b in (p_abits, abits))
    assert wave != step
    assert dm.PLAIN_CALLS[wave] == stats["n_combos"] * per_forward
    assert dm.PLAIN_CALLS[step] == (stats["n_steps"] - stats["n_combos"]) * per_forward
    assert sum(dm.PLAIN_CALLS.values()) == stats["n_steps"] * per_forward
    assert not any(dm.LAUNCHES.values())
