"""Port parity: RTN quantization writes byte-identical artifacts.

``quantize_tensor`` of the JAX package and of the PyTorch port get the same
numpy weights; ``qweight``, ``scales`` and ``zeros`` must be identical byte
for byte, and ``dequantize_weight`` exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import PER_CHANNEL, PER_TENSOR
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.ops.qmatmul import dequantize_weight as j_dequant
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import FloatFormat
from iron_weight_only_quant_tpu_torch.config import QuantSpec as TSpec
from iron_weight_only_quant_tpu_torch.ops.qmatmul import dequantize_weight as t_dequant
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor, quantize_tensor

# (id, spec fields, kwargs, weight shape)
CASES = [
    ("int4_g128_asym", dict(bits=4, group_size=128, symmetric=False), {}, (256, 96)),
    ("int4_g128_sym", dict(bits=4, group_size=128, symmetric=True), {}, (256, 96)),
    ("int4_g64_asym", dict(bits=4, group_size=64, symmetric=False), {}, (256, 96)),
    ("int4_perchannel_sym", dict(bits=4, group_size=PER_CHANNEL, symmetric=True), {}, (256, 96)),
    ("int4_perchannel_asym", dict(bits=4, group_size=PER_CHANNEL, symmetric=False), {}, (256, 96)),
    ("int4_pertensor_asym", dict(bits=4, group_size=PER_TENSOR, symmetric=False), {}, (256, 96)),
    ("int8_g128_asym", dict(bits=8, group_size=128, symmetric=False), {}, (256, 96)),
    ("int8_g128_sym", dict(bits=8, group_size=128, symmetric=True), {}, (256, 96)),
    ("int2_g64_asym", dict(bits=2, group_size=64, symmetric=False), {}, (256, 96)),
    ("int3_g64_asym", dict(bits=3, group_size=64, symmetric=False), {}, (256, 96)),
    ("int4_pad_n_512", dict(bits=4, group_size=128, symmetric=False),
     dict(pad_n_to=512), (256, 300)),
    ("int4_pad_k_512", dict(bits=4, group_size=128, symmetric=False),
     dict(pad_k_to=512), (384, 128)),
    ("int8_pad_k_512", dict(bits=8, group_size=128, symmetric=False),
     dict(pad_k_to=512, pad_n_to=256), (384, 200)),
    ("int4_side_f16", dict(bits=4, group_size=128, symmetric=False),
     dict(side_dtype="float16"), (256, 96)),
    ("int4_k_shards_2", dict(bits=4, group_size=64, symmetric=False),
     dict(k_shards=2), (256, 96)),
    # the W3 main path's artifact: g128 asym, N padded to 512, K to 1024
    ("int3_g128_pad_n_512_pad_k_1024", dict(bits=3, group_size=128, symmetric=False),
     dict(pad_n_to=512, pad_k_to=1024), (1408, 200)),
]


def _both(spec_fields, kwargs, shape, seed):
    w = (np.random.default_rng(seed).normal(size=shape) * 0.05).astype(np.float32)
    jk, tk = dict(kwargs), dict(kwargs)
    if "side_dtype" in kwargs:
        jk["side_dtype"] = getattr(jnp, kwargs["side_dtype"])
        tk["side_dtype"] = getattr(torch, kwargs["side_dtype"])
    jq = j_quantize(jnp.asarray(w), JSpec(fmt="int", **spec_fields), **jk)
    tq = quantize_tensor(torch.from_numpy(w), TSpec(fmt="int", **spec_fields), **tk)
    return jq, tq


def _same_bytes(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape
    assert t.numpy().dtype == j.dtype
    np.testing.assert_array_equal(t.numpy().view(np.uint8), j.view(np.uint8))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_artifact_bytes_match_jax(case):
    _, spec_fields, kwargs, shape = case
    jq, tq = _both(spec_fields, kwargs, shape, seed=len(case[0]))
    assert isinstance(tq, QuantizedTensor)
    assert (tq.shape, tq.mode, tq.k_shards, tq.n_pad, tq.k_pad) == (
        jq.shape, jq.mode, jq.k_shards, jq.n_pad, jq.k_pad)
    _same_bytes(tq.qweight, jq.qweight)
    _same_bytes(tq.scales, jq.scales)
    _same_bytes(tq.zeros, jq.zeros)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dequantize_matches_jax_exactly(case):
    _, spec_fields, kwargs, shape = case
    jq, tq = _both(spec_fields, kwargs, shape, seed=len(case[0]))
    want = np.asarray(j_dequant(jq))
    got = t_dequant(tq)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_symmetric_zeros_are_a_broadcast_scalar():
    _, tq = _both(dict(bits=4, group_size=128, symmetric=True), {}, (256, 64), 0)
    assert tuple(tq.zeros.shape) == (1, 1) and float(tq.zeros) == 8.0


def test_unported_formats_raise():
    """What the JAX package does not pack, the port does not either: the
    fake-quant-only fp4_e1m2 scheme and double-approximate minifloats
    (bfp and exact minifloats pack: tests/test_torch_formats.py)."""
    w = torch.zeros((128, 64))
    for spec in (TSpec(fmt="fp4_e1m2", bits=4, group_size=128),
                 TSpec(fmt="fp", bits=8, float_format=FloatFormat(4, 3),
                       approximate=True, double_approximate=True)):
        with pytest.raises(NotImplementedError):
            quantize_tensor(w, spec)
    for spec in (TSpec(fmt="bfp", bits=4, group_size=128),
                 TSpec(fmt="fp", bits=4, float_format=FloatFormat(2, 1))):
        assert quantize_tensor(w, spec).mode == ("affine" if spec.fmt == "bfp" else "lut")
