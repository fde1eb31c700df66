"""Port parity: the W4 and W8 dequant-matmuls against the Pallas kernels.

The port's plain PyTorch versions of its CUDA kernels (W4 and W8, each also
with the weightless RMSNorm ``pre_norm``) are what a CPU tensor runs; here
they are held against the JAX package's Pallas kernels run in interpret
mode on the same numpy inputs, in float32, at the Pallas tests' tolerances
(``tests/test_pallas_kernel.py``: rtol 2e-5, atol 2e-4).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import PER_CHANNEL
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.models.common import stack_model_layers
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.ops.pallas.dequant_matmul import (
    fused_quantized_matmul as j_fused,
    fused_quantized_matmul_stacked as j_fused_stacked,
)
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import QuantSpec as TSpec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
W4 = dict(fmt="int", bits=4, group_size=128, symmetric=False)
W8 = dict(W4, bits=8)
# (storage bits, pre_norm, the kernel a CUDA tensor would launch)
KERNELS = [pytest.param((4, None, dm.W4), id="w4"),
           pytest.param((4, EPS, dm.W4_PRENORM), id="w4_prenorm"),
           pytest.param((8, None, dm.W8), id="w8"),
           pytest.param((8, EPS, dm.W8_PRENORM), id="w8_prenorm")]


def _artifact(k, n, spec=W4, seed=0, **kw):
    """The same artifact in both packages (quantized once, by JAX)."""
    w = (np.random.default_rng(seed).normal(size=(k, n)) * 0.05).astype(np.float32)
    jq = j_quantize(jnp.asarray(w), JSpec(**spec), **kw)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(x, jq, tq, kern):
    _, pre_norm, name = kern
    assert dm.kernel_supported(tq) and dm.kernel_name(tq, pre_norm) == name
    want = np.asarray(j_fused(jnp.asarray(x), jq, interpret=True, pre_norm=pre_norm))
    got = dm.fused_quantized_matmul(torch.from_numpy(x), tq, pre_norm=pre_norm)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("m", [1, 8, 16])
def test_plain_matches_pallas(m, kern):
    jq, tq = _artifact(512, 256, spec=dict(W4, bits=kern[0]))
    got, want = _both(_x((m, 512)), jq, tq, kern)
    assert got.shape == (m, 256)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kern", KERNELS)
def test_plain_matches_pallas_3d_x(kern):
    jq, tq = _artifact(512, 256, spec=dict(W4, bits=kern[0]), seed=2)
    got, want = _both(_x((2, 3, 512)), jq, tq, kern)
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kern", KERNELS)
def test_plain_matches_pallas_n_pad(kern):
    jq, tq = _artifact(512, 200, spec=dict(W4, bits=kern[0]), seed=3, pad_n_to=128)
    assert tq.n_pad == 56
    got, want = _both(_x((8, 512)), jq, tq, kern)
    assert got.shape == (8, 200)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kern", KERNELS)
def test_plain_matches_pallas_k_pad(kern):
    jq, tq = _artifact(384, 256, spec=dict(W4, bits=kern[0]), seed=4, pad_k_to=512)
    assert tq.k_pad == 128
    got, want = _both(_x((8, 384)), jq, tq, kern)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("spec", [
    dict(symmetric=True),
    dict(group_size=64),
    dict(group_size=PER_CHANNEL, symmetric=True),
], ids=["g128_sym", "g64_asym", "perchannel_sym"])
@pytest.mark.parametrize("kern", KERNELS)
def test_plain_matches_pallas_other_w4_layouts(spec, kern):
    """The side-info layouts beside g128 asym, for the W4 and W8 storage."""
    jq, tq = _artifact(512, 256, spec=dict(W4, bits=kern[0], **spec), seed=5)
    got, want = _both(_x((8, 512)), jq, tq, kern)
    np.testing.assert_allclose(got, want, **TOL)


@functools.lru_cache(maxsize=None)
def _stacked(bits):
    """Two layers stacked by the JAX package, side info padded 4 -> 8 rows."""
    qts = [j_quantize(jnp.asarray(_x((512, 256), seed=10 + i) * 0.05),
                      JSpec(**dict(W4, bits=bits)))
           for i in range(2)]
    params = {"layers": [{"lin": {"w": q, "b": None}} for q in qts]}
    jst = stack_model_layers(params)["layers_stacked"]["lin"]["w"]
    assert jst.side_pad == 4
    return jst, params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")


@pytest.fixture(scope="module")
def stacked_pair():
    return _stacked(4)


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_pallas_stacked(layer, kern):
    _, pre_norm, name = kern
    jst, tst = _stacked(kern[0])
    assert tst.side_pad == 4 and dm.kernel_supported_stacked(tst)
    assert dm.kernel_name(tst, pre_norm) == name
    x = _x((8, 512), seed=20 + layer)
    want = np.asarray(j_fused_stacked(jnp.asarray(x), jst, layer, interpret=True,
                                      pre_norm=pre_norm))
    got = dm.fused_quantized_matmul_stacked(torch.from_numpy(x), tst, layer,
                                            pre_norm=pre_norm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
def test_quantized_matmul_adds_bias_then_casts(pre_norm):
    jq, tq = _artifact(512, 256, seed=6)
    x = _x((4, 512))
    b = _x((256,), seed=7)
    want = np.asarray(j_qmatmul.quantized_matmul(
        jnp.asarray(x), jq, bias=jnp.asarray(b), pre_norm=pre_norm))
    got = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq,
                                     bias=torch.from_numpy(b), pre_norm=pre_norm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert t_qmatmul.quantized_matmul(xb, tq, bias=torch.from_numpy(b)).dtype == torch.bfloat16


def test_quantized_matmul_stacked_matches_jax(stacked_pair):
    jst, tst = stacked_pair
    x = _x((3, 512), seed=8)
    want = np.asarray(j_qmatmul.quantized_matmul_stacked(jnp.asarray(x), jst, 1))
    got = t_qmatmul.quantized_matmul_stacked(torch.from_numpy(x), tst, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_index_stacked_dequantizes_like_jax(stacked_pair):
    jst, tst = stacked_pair
    want = np.asarray(j_qmatmul.dequantize_weight(j_qmatmul.index_stacked(jst, 1)))
    got = t_qmatmul.dequantize_weight(t_qmatmul.index_stacked(tst, 1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensor_takes_the_plain_version():
    _, tq = _artifact(512, 256)
    _, tq8 = _artifact(512, 256, spec=W8)
    dm.reset_counts()
    dm.fused_quantized_matmul(torch.zeros((2, 512)), tq, pre_norm=EPS)
    dm.fused_quantized_matmul(torch.zeros((2, 512)), tq)
    dm.fused_quantized_matmul(torch.zeros((2, 512)), tq8)
    dm.fused_quantized_matmul(torch.zeros((2, 512)), tq8)
    dm.fused_quantized_matmul(torch.zeros((2, 512)), tq8, pre_norm=EPS)
    none = {name: 0 for name in (dm.W4, dm.W4_PRENORM, dm.W8, dm.W8_PRENORM,
                                 dm.W4A8, dm.W4A16, dm.W8A8, dm.W8A16,
                                 dm.W3, dm.W3A8, dm.W3A16,
                                 dm.LUT4, dm.LUT4A16, dm.LUT8, dm.LUT6, dm.LUT6A16)}
    assert dm.PLAIN_CALLS == {**none, dm.W4: 1, dm.W4_PRENORM: 1, dm.W8: 2,
                              dm.W8_PRENORM: 1}
    assert dm.LAUNCHES == none
    assert dm.ROUTE_CALLS == {dm.ROUTE: 0}
    dm.reset_counts()
    assert dm.PLAIN_CALLS == none


@pytest.mark.parametrize("case", ["int3", "side_f16", "k_shards_2", "int2"])
def test_layouts_without_a_kernel_are_refused(case):
    spec = dict(W4)
    kw = {}
    k = 512
    if case == "int3":  # a group of 64 straddles the K/8 = 136 slabs of K=1088
        spec.update(bits=3, group_size=64)
        k = 1088
    elif case == "int2":
        spec["bits"] = 2
    elif case == "side_f16":
        kw["side_dtype"] = torch.float16
    else:
        kw["k_shards"] = 2
    w = torch.from_numpy(_x((k, 256)) * 0.05)
    tq = quantize_tensor(w, TSpec(**spec), **kw)
    assert not dm.kernel_supported(tq)
    # the JAX package computes these on its XLA path: so does the port's route
    assert dm.xla_route(tq) and dm.kernel_name(tq) is None


def test_w4_main_path_layout_has_a_kernel():
    _, tq = _artifact(512, 300, pad_n_to=512)
    assert dm.kernel_supported(tq)


def test_w8_main_path_layout_has_a_kernel():
    _, tq = _artifact(512, 300, spec=W8, pad_n_to=512)
    assert dm.kernel_supported(tq) and tq.qweight.shape == (512, 512)
    assert dm.kernel_name(tq, EPS) == dm.W8_PRENORM


@pytest.mark.parametrize("m,n,kp", [(8, 12288, 2048), (8, 4096, 5504),
                                    (256, 22528, 2048), (1, 128, 64)])
def test_split_plan_covers_k(m, n, kp):
    kc, splits = dm.plan_splits(m, n, kp, sm_count=132)
    assert kc % 32 == 0 and kc * splits >= kp and kc * (splits - 1) < kp
