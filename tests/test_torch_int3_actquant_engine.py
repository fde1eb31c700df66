"""Port parity: the engine on a 3-bit (s21) LLaMA under activation bits.

The tiny W3 LLaMA of ``tests/test_torch_int3_engine.py`` (the same bytes
in both packages).  The JAX XLA fallback ignores activation bits, so the JAX
model's linears are routed through the Pallas kernels in interpret mode
with the ambient activation bits (``_int3_kernel`` with int8 x under A8,
``_int3_kernel_a16`` under A16), as ``tests/test_torch_actquant_engine.py``
does for W4/W8, while the port's linears take their plain versions.
Checked: one A8 forward's f32 logits, and greedy ``generate`` tokens with
A8 waves and A16 decode steps, each phase counted under its own kernel.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.ops.pallas.dequant_matmul import fused_quantized_matmul
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from test_torch_int3_engine import J_CFG, T_CFG, w3_models

PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [1, 2, 3, 4, 5, 6, 7]]
PER_FORWARD = 4 * T_CFG.num_layers + 1


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain W3 path runs small CPU matmuls that gain nothing
    from many torch threads; in the parallel test run those only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models():
    return w3_models()


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


def test_a8_forward_logits_match_jax(routed):
    jp, tp = _models()
    jf = j_llama.fuse_llama_projections(jp)
    tf = t_llama.fuse_llama_projections(tp)
    tokens = np.asarray(PROMPTS, np.int32)
    with j_qmatmul.activation_quant(8):
        want, _ = j_llama.llama_forward(jf, jnp.asarray(tokens), J_CFG)
    dm.reset_counts()
    with t_qmatmul.activation_quant(8):
        got, _ = t_llama.llama_forward(tf, torch.from_numpy(tokens).long(), T_CFG)
    assert dm.PLAIN_CALLS[dm.W3A8] == PER_FORWARD == sum(dm.PLAIN_CALLS.values())
    full, _ = t_llama.llama_forward(tf, torch.from_numpy(tokens).long(), T_CFG)
    want, got, full = np.asarray(want), got.numpy(), full.numpy()
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
    # the JAX and torch RMSNorms may differ in the last f32 bit, so an A8
    # code may round the other way (1/127 of the row's maximum) and the next
    # layer's codes follow: the two A8 forwards are held closer to each
    # other than A8 is to full precision (its own quantization noise: 3.5e-2
    # here), and to the same argmax
    assert rel(got, want) < rel(want, full), (rel(got, want), rel(want, full))
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_generate_tokens_match_jax_a8_waves_a16_decode(routed):
    jp, tp = _models()
    kw = dict(max_batch_size=4, fuse_projections=True, prefill_activation_bits=8,
              activation_bits=16)
    je = JEngine(jp, J_CFG, _routed_forward, family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(max_seq_len=32), **kw))
    te = InferenceEngine(tp, T_CFG, t_llama.llama_forward, family="llama",
                         engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=32), **kw),
                         device="cpu")
    want = je.generate(PROMPTS, max_new_tokens=4)
    dm.reset_counts()
    got = te.generate(PROMPTS, max_new_tokens=4)
    assert [len(o) for o in got] == [4] * len(PROMPTS)
    assert got == want
    # one A8 prefill forward, then three A16 decode steps
    assert dm.PLAIN_CALLS[dm.W3A8] == PER_FORWARD
    assert dm.PLAIN_CALLS[dm.W3A16] == 3 * PER_FORWARD
    assert sum(dm.PLAIN_CALLS.values()) == 4 * PER_FORWARD
