"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip with a
reason.  They run without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and chosen for the edges: M not a multiple of the row tile,
N padding, K padding, group rows that straddle the two K halves of the
nibble layout, per-channel and per-tensor side info, float32 and bfloat16 x.
"""

import pytest
import torch

from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, PER_TENSOR, QuantSpec
from iron_weight_only_quant_tpu_torch.ops import qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

pytestmark = pytest.mark.cuda
EPS = 1e-5
SPECS = {
    "g128_asym": QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False),
    "g128_sym": QuantSpec(fmt="int", bits=4, group_size=128, symmetric=True),
    "g64_asym": QuantSpec(fmt="int", bits=4, group_size=64, symmetric=False),
    "perchannel_sym": QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL, symmetric=True),
    "pertensor_asym": QuantSpec(fmt="int", bits=4, group_size=PER_TENSOR, symmetric=False),
}
SHAPES = {  # (K, N, quantize_tensor kwargs)
    "512x256": (512, 256, {}),
    "384x300_npad": (384, 300, dict(pad_n_to=512)),
    "1408x128_straddle": (1408, 128, {}),
    "384x256_kpad": (384, 256, dict(pad_k_to=512)),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from iron_weight_only_quant_tpu_torch.ops.kernels import build

    build.build()
    return torch.device("cuda", 0)


def _artifact(dev, k, n, spec, seed=0, **kw):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=dev) * 0.05
    return quantize_tensor(w, spec, **kw)


def _x(dev, shape, dtype, seed=1):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _close(y, y_ref, dtype):
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_ref, rtol=2e-5, atol=2e-4)
    else:  # bf16 output: one rounding of the same f32 sum, in another order
        err = (y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()
        assert err.item() <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_matches_plain_shapes(dev, shape, m, pre_norm, dtype):
    k, n, kw = SHAPES[shape]
    qt = _artifact(dev, k, n, SPECS["g128_asym"], **kw)
    assert dm.kernel_supported(qt)
    x = _x(dev, (m, k), dtype)
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    _close(y, dm.dequant_matmul_plain(x, qt, pre_norm), dtype)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_kernel_matches_plain_side_layouts(dev, spec, pre_norm):
    qt = _artifact(dev, 512, 256, SPECS[spec], seed=2)
    x = _x(dev, (2, 4, 512), torch.float32)
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    assert y.shape == (2, 4, 256)
    _close(y, dm.dequant_matmul_plain(x, qt, pre_norm), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
@pytest.mark.parametrize("layer", [0, 2])
def test_stacked_kernel_reads_the_layer_in_place(dev, layer, pre_norm):
    qts = [_artifact(dev, 1408, 256, SPECS["g128_asym"], seed=10 + i) for i in range(3)]
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 5))  # noqa: E731
    st = qts[0].replace(qweight=torch.stack([q.qweight for q in qts]),
                        scales=torch.stack([pad(q.scales) for q in qts]),
                        zeros=torch.stack([pad(q.zeros) for q in qts]), side_pad=5)
    assert dm.kernel_supported_stacked(st)
    x = _x(dev, (8, 1408), torch.float32)
    y = dm.fused_quantized_matmul_stacked(x, st, layer, pre_norm=pre_norm)
    _close(y, dm.dequant_matmul_plain(x, qts[layer], pre_norm), torch.float32)


def test_launches_are_counted_and_the_plain_path_is_not_taken(dev):
    qt = _artifact(dev, 512, 256, SPECS["g128_asym"])
    x = _x(dev, (8, 512), torch.bfloat16)
    dm.reset_counts()
    qmatmul.quantized_matmul(x, qt, pre_norm=EPS)
    qmatmul.quantized_matmul(x, qt)
    qmatmul.quantized_matmul(x, qt)
    torch.cuda.synchronize()
    assert dm.LAUNCHES == {dm.W4: 2, dm.W4_PRENORM: 1}
    assert dm.PLAIN_CALLS == {dm.W4: 0, dm.W4_PRENORM: 0}


@pytest.mark.parametrize("case", ["int8", "side_f16", "k_shards_2"])
def test_layouts_without_a_kernel_raise_on_the_card(dev, case):
    spec = QuantSpec(fmt="int", bits=8 if case == "int8" else 4, group_size=128,
                     symmetric=False)
    kw = {"side_f16": dict(side_dtype=torch.float16),
          "k_shards_2": dict(k_shards=2)}.get(case, {})
    qt = _artifact(dev, 512, 256, spec, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        qmatmul.quantized_matmul(_x(dev, (8, 512), torch.bfloat16), qt)


def test_activation_bits_raise_on_the_card(dev):
    qt = _artifact(dev, 512, 256, SPECS["g128_asym"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        qmatmul.quantized_matmul(_x(dev, (8, 512), torch.bfloat16), qt, activation_bits=8)
