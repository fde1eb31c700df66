"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip with a
reason.  They run without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and chosen for the edges: M not a multiple of the row tile,
N padding, K padding, group rows that straddle the two K halves of the
nibble layout, per-channel and per-tensor side info, float32 and bfloat16 x.
The W4 (nib4), W8 (byte) and W3 (s21) kernels run the same grid, with
bf16/f32 activations and with int8 (A8) or split-plane (A16) ones; the W3
shapes keep K/8 a multiple of the group (K=512 with g64 or per-channel side
info, which the TPU kernel refuses, included); the int-activation row pass
must give the plain version's codes bit for bit.  The LUT (minifloat)
kernels run the nib4 (fp4), nq42 (fp6; K/4 a multiple of the group) and
byte (fp8, byte-per-code fp6) layouts with and without zero points, fp4
and fp6 E2M3 also under A16; BFP artifacts run on the W4 and W8 kernels;
card-built fp/bfp artifacts must equal CPU-built ones byte for byte.  The
W4 inner-loop probe kernel runs both its decodes on the W4 shapes.
Artifacts the JAX package computes on its XLA path take the route
(``ROUTE_CALLS``) on the card too.  The serve loop's KV write, a wave and a
chunk (also under activation bits, and on a W3 model) and tiny ``serve``
runs (also fp4, fp6 and fp8) are checked for host syncs, launch counts and
repeatability.
"""

import contextlib
import dataclasses

import pytest
import torch

from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, PER_TENSOR, QuantSpec, fp_spec
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
# (storage bits, pre_norm, the kernel the artifact dispatches to)
KERNELS = [pytest.param((4, None, dm.W4), id="w4"),
           pytest.param((4, EPS, dm.W4_PRENORM), id="w4_prenorm"),
           pytest.param((8, None, dm.W8), id="w8"),
           pytest.param((8, EPS, dm.W8_PRENORM), id="w8_prenorm")]
SHAPES = {  # (K, N, quantize_tensor kwargs)
    "512x256": (512, 256, {}),
    "384x300_npad": (384, 300, dict(pad_n_to=512)),
    "1408x128_straddle": (1408, 128, {}),
    "384x256_kpad": (384, 256, dict(pad_k_to=512)),
}
# the s21 layout needs the group to divide K/8 (a slab)
SHAPES3 = {
    "1024x256": (1024, 256, {}),
    "1024x300_npad": (1024, 300, dict(pad_n_to=512)),
    "3072x128": (3072, 128, {}),
    "896x256_kpad": (896, 256, dict(pad_k_to=1024)),
}
W3_SPEC = dataclasses.replace(SPECS["g128_asym"], bits=3)
# minifloat (LUT) artifacts: (spec, the flat kernel they dispatch to)
LUT_SPECS = {
    "fp4_e2m1_g128_asym": (fp_spec("fp4", 2, 1, group_size=128, symmetric=False), dm.LUT4),
    "fp4_e2m1_g128_sym": (fp_spec("fp4", 2, 1, group_size=128), dm.LUT4),
    "fp4_e1m2_g64_sym": (fp_spec("fp4", 1, 2, group_size=64), dm.LUT4),
    "fp4_e2m1_perchannel_asym": (fp_spec("fp4", 2, 1, group_size=PER_CHANNEL,
                                         symmetric=False), dm.LUT4),
    "fp8_e4m3_g128_sym": (fp_spec("fp8", 4, 3, group_size=128), dm.LUT8),
    "fp8_e4m3_perchannel_asym": (fp_spec("fp8", 4, 3, group_size=PER_CHANNEL,
                                         symmetric=False), dm.LUT8),
    "fp8_e3m4_g128_sym": (fp_spec("fp8", 3, 4, group_size=128), dm.LUT8),
    "fp8_e2m5_g128_asym": (fp_spec("fp8", 2, 5, group_size=128, symmetric=False), dm.LUT8),
}
# fp6 in the nq42 layout (lut6; E2M3 also lut6a16 under A16)
LUT6_SPECS = {
    "fp6_e2m3_g128_sym": fp_spec("fp6", 2, 3, group_size=128),
    "fp6_e3m2_g128_asym": fp_spec("fp6", 3, 2, group_size=128, symmetric=False),
    "fp6_e2m3_g64_asym": fp_spec("fp6", 2, 3, group_size=64, symmetric=False),
    "fp6_e2m3_g32_sym": fp_spec("fp6", 2, 3, group_size=32),
    "fp6_e3m2_perchannel_sym": fp_spec("fp6", 3, 2, group_size=PER_CHANNEL),
}
# the nq42 layout needs the group to divide K/4 (a quarter)
SHAPES6 = {
    "512x256": (512, 256, {}),
    "1024x300_npad": (1024, 300, dict(pad_n_to=512)),
    "1536x128": (1536, 128, {}),
    "384x256_kpad": (384, 256, dict(pad_k_to=512)),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from iron_weight_only_quant_tpu_torch.ops.kernels import build

    build.build()
    return torch.device("cuda", 0)


def _artifact(dev, k, n, spec, seed=0, bits=None, **kw):
    """``spec``, stored at ``bits`` where given, on random weights."""
    if bits is not None:
        spec = dataclasses.replace(spec, bits=bits)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=dev) * 0.05
    return quantize_tensor(w, spec, **kw)


def _stacked(qts):
    """Layer-stacked artifact of ``qts``, side info padded by 5 rows."""
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 5))  # noqa: E731
    zeros = None if qts[0].zeros is None else torch.stack([pad(q.zeros) for q in qts])
    return qts[0].replace(qweight=torch.stack([q.qweight for q in qts]),
                          scales=torch.stack([pad(q.scales) for q in qts]),
                          zeros=zeros, side_pad=5)


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
@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_matches_plain_shapes(dev, shape, m, kern, dtype):
    bits, pre_norm, name = kern
    k, n, kw = SHAPES[shape]
    qt = _artifact(dev, k, n, SPECS["g128_asym"], bits=bits, **kw)
    assert dm.kernel_supported(qt) and dm.kernel_name(qt, pre_norm) == name
    x = _x(dev, (m, k), dtype)
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    _close(y, dm.dequant_matmul_plain(x, qt, pre_norm), dtype)


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_kernel_matches_plain_side_layouts(dev, spec, kern):
    bits, pre_norm, name = kern
    qt = _artifact(dev, 512, 256, SPECS[spec], seed=2, bits=bits)
    assert dm.kernel_name(qt, pre_norm) == name
    x = _x(dev, (2, 4, 512), torch.float32)
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    assert y.shape == (2, 4, 256)
    _close(y, dm.dequant_matmul_plain(x, qt, pre_norm), torch.float32)


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("layer", [0, 2])
def test_stacked_kernel_reads_the_layer_in_place(dev, layer, kern):
    bits, pre_norm, _ = kern
    qts = [_artifact(dev, 1408, 256, SPECS["g128_asym"], seed=10 + i, bits=bits)
           for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st)
    x = _x(dev, (8, 1408), torch.float32)
    y = dm.fused_quantized_matmul_stacked(x, st, layer, pre_norm=pre_norm)
    _close(y, dm.dequant_matmul_plain(x, qts[layer], pre_norm), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES3), ids=list(SHAPES3))
def test_w3_kernel_matches_plain_shapes(dev, shape, m, dtype, pre_norm):
    """The s21 kernel; a ``pre_norm`` normalizes x in torch before it."""
    k, n, kw = SHAPES3[shape]
    qt = _artifact(dev, k, n, W3_SPEC, **kw)
    assert dm.kernel_supported(qt) and dm.kernel_name(qt, pre_norm) == dm.W3
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    assert dm.LAUNCHES[dm.W3] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close(y, dm.dequant_matmul_plain(x, qt, pre_norm), dtype)


@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_w3_kernel_matches_plain_side_layouts(dev, spec):
    qt = _artifact(dev, 1024, 256, SPECS[spec], seed=2, bits=3)
    x = _x(dev, (2, 4, 1024), torch.float32)
    y = dm.fused_quantized_matmul(x, qt)
    assert y.shape == (2, 4, 256)
    _close(y, dm.dequant_matmul_plain(x, qt), torch.float32)


@pytest.mark.parametrize("abits", [None, 8, 16], ids=["w3", "w3a8", "w3a16"])
@pytest.mark.parametrize("spec", ["g64_asym", "perchannel_sym"])
def test_w3_kernels_take_k_the_tpu_kernel_refuses(dev, spec, abits):
    """K=512: K/8 = 64 is not a multiple of the TPU's 128-row tile."""
    qt = _artifact(dev, 512, 256, SPECS[spec], seed=3, bits=3)
    assert dm.kernel_supported(qt, abits)
    x = _x(dev, (5, 512), torch.float32)
    y = dm.fused_quantized_matmul(x, qt, activation_bits=abits)
    _close(y, dm.dequant_matmul_plain(x, qt, activation_bits=abits), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("layer", [0, 2])
def test_w3_stacked_kernel_reads_the_layer_in_place(dev, layer, pre_norm):
    qts = [_artifact(dev, 2048, 256, W3_SPEC, seed=10 + i) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st)
    x = _x(dev, (8, 2048), torch.float32)
    y = dm.fused_quantized_matmul_stacked(x, st, layer, pre_norm=pre_norm)
    _close(y, dm.dequant_matmul_plain(x, qts[layer], pre_norm), torch.float32)


@pytest.mark.parametrize("bits", [4, 8, 3])
def test_launches_are_counted_and_the_plain_path_is_not_taken(dev, bits):
    k = 1024 if bits == 3 else 512
    qt = _artifact(dev, k, 256, SPECS["g128_asym"], bits=bits)
    x = _x(dev, (8, k), torch.bfloat16)
    dm.reset_counts()
    qmatmul.quantized_matmul(x, qt, pre_norm=EPS)
    qmatmul.quantized_matmul(x, qt)
    qmatmul.quantized_matmul(x, qt)
    torch.cuda.synchronize()
    flat, prenorm = {4: (dm.W4, dm.W4_PRENORM), 8: (dm.W8, dm.W8_PRENORM),
                     3: (dm.W3, dm.W3)}[bits]  # s21: x normalized first, then W3
    want = {name: 0 for name in dm.LAUNCHES}
    want[flat] += 2
    want[prenorm] += 1
    assert dm.LAUNCHES == want
    assert not any(dm.PLAIN_CALLS.values())


def _routed(dev, qt, x, **kw):
    """One ``quantized_matmul`` of an artifact the JAX package computes on
    its XLA path: it takes the route (one ``ROUTE_CALLS``, no launch, no
    plain call) and computes what the same route computes on the CPU."""
    dm.reset_counts()
    y = qmatmul.quantized_matmul(x, qt, **kw)
    torch.cuda.synchronize()
    assert dm.ROUTE_CALLS == {dm.ROUTE: 1}
    assert not any(dm.LAUNCHES.values()) and not any(dm.PLAIN_CALLS.values())
    y_cpu = qmatmul.quantized_matmul(x.cpu(), qt.map_arrays(lambda a: a.cpu()), **kw)
    _close_a(y.cpu(), y_cpu, x.dtype)


@pytest.mark.parametrize("case", ["int3", "side_f16", "k_shards_2", "int2", "fp4_approx",
                                  "fp6_straddle"])
def test_layouts_without_a_kernel_raise_on_the_card(dev, case):
    """The artifacts the JAX package never sends to a kernel take the route
    on the card.  ``int3``: K=1088 with g64, a group straddles the K/8 =
    136 slabs; ``fp6_straddle``: K=512 with g256, a group straddles the
    K/4 = 128 quarters."""
    spec = QuantSpec(fmt="int", bits={"int3": 3, "int2": 2}.get(case, 4),
                     group_size=64 if case == "int3" else 128, symmetric=False)
    if case == "fp4_approx":
        spec = fp_spec("fp4", 2, 1, group_size=128, approximate=True)
    if case == "fp6_straddle":
        spec = fp_spec("fp6", 2, 3, group_size=256)
    kw = {"side_f16": dict(side_dtype=torch.float16),
          "k_shards_2": dict(k_shards=2)}.get(case, {})
    k = 1088 if case == "int3" else 512
    qt = _artifact(dev, k, 256, spec, **kw)
    assert dm.xla_route(qt) and not dm.kernel_supported(qt)
    _routed(dev, qt, _x(dev, (8, k), torch.bfloat16))


def test_fp6_nq42_takes_lut6_on_the_card(dev):
    """fp6 in the nq42 layout: ``quantized_matmul`` launches ``lut6_matmul``
    once (and under A16, E3M2 having no int8 grid, the same kernel), no
    plain call, no route call."""
    qt = _artifact(dev, 512, 256, fp_spec("fp6", 3, 2, group_size=128))
    assert dm.packed_bits(qt) == 6 and not dm.xla_route(qt) and dm.kernel_supported(qt)
    x = _x(dev, (8, 512), torch.bfloat16)
    dm.reset_counts()
    y = qmatmul.quantized_matmul(x, qt)
    with pytest.warns(UserWarning, match="full-precision"):
        y16 = qmatmul.quantized_matmul(x, qt, activation_bits=16)
    torch.cuda.synchronize()
    assert dm.LAUNCHES == {**{k: 0 for k in dm.LAUNCHES}, dm.LUT6: 2}
    assert not any(dm.PLAIN_CALLS.values()) and not any(dm.ROUTE_CALLS.values())
    _close_a(y, dm.dequant_matmul_plain(x, qt), torch.bfloat16)
    _close_a(y16, y, torch.bfloat16)


@pytest.mark.parametrize("abits", [None, 8, 16])
def test_w3_with_16_bit_side_info_raises_on_the_card(dev, abits):
    """16-bit side info takes the route, activation bits ignored, as on the
    JAX package's XLA path."""
    qt = _artifact(dev, 1024, 256, W3_SPEC, side_dtype=torch.float16)
    _routed(dev, qt, _x(dev, (8, 1024), torch.bfloat16), activation_bits=abits,
            pre_norm=EPS)


def test_activation_bits_raise_on_the_card(dev):
    """A8 on a LUT artifact raises, as in the JAX package; activation bits
    on an artifact of the route (int2) are ignored, as on its XLA path."""
    lut = _artifact(dev, 512, 256, LUT_SPECS["fp4_e2m1_g128_sym"][0])
    with pytest.raises(NotImplementedError, match="LUT"):
        qmatmul.quantized_matmul(_x(dev, (8, 512), torch.bfloat16), lut, activation_bits=8)
    qt = _artifact(dev, 512, 256, dataclasses.replace(SPECS["g128_asym"], bits=2))
    _routed(dev, qt, _x(dev, (8, 512), torch.bfloat16), activation_bits=8)


# -------------------------------------------------- int-activation kernels

# (storage bits, activation bits, the kernel the artifact dispatches to)
A_KERNELS = [pytest.param((4, 8, dm.W4A8), id="w4a8"),
             pytest.param((4, 16, dm.W4A16), id="w4a16"),
             pytest.param((8, 8, dm.W8A8), id="w8a8"),
             pytest.param((8, 16, dm.W8A16), id="w8a16")]


def _close_a(y, y_ref, dtype):
    """The integer sums are exact; the f32 epilogue runs in another order."""
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype == dtype
    err = (y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()
    assert err.item() <= (1e-4 if dtype == torch.float32 else 1e-2), err.item()


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kern", A_KERNELS)
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_a_kernel_matches_plain_shapes(dev, shape, m, kern, dtype, pre_norm):
    bits, abits, name = kern
    k, n, kw = SHAPES[shape]
    qt = _artifact(dev, k, n, SPECS["g128_asym"], bits=bits, **kw)
    assert dm.kernel_supported(qt, abits) and dm.kernel_name(qt, pre_norm, abits) == name
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm, activation_bits=abits)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm, activation_bits=abits), dtype)


@pytest.mark.parametrize("kern", A_KERNELS)
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_a_kernel_matches_plain_side_layouts(dev, spec, kern):
    bits, abits, _ = kern
    qt = _artifact(dev, 512, 256, SPECS[spec], seed=2, bits=bits)
    x = _x(dev, (2, 4, 512), torch.float32)
    y = dm.fused_quantized_matmul(x, qt, activation_bits=abits)
    assert y.shape == (2, 4, 256)
    _close_a(y, dm.dequant_matmul_plain(x, qt, activation_bits=abits), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("abits", [8, 16], ids=["w3a8", "w3a16"])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES3), ids=list(SHAPES3))
def test_w3_a_kernel_matches_plain_shapes(dev, shape, m, abits, dtype, pre_norm):
    k, n, kw = SHAPES3[shape]
    qt = _artifact(dev, k, n, W3_SPEC, **kw)
    name = dm.W3A8 if abits == 8 else dm.W3A16
    assert dm.kernel_supported(qt, abits) and dm.kernel_name(qt, pre_norm, abits) == name
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm, activation_bits=abits)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm, activation_bits=abits), dtype)


@pytest.mark.parametrize("abits", [8, 16], ids=["w3a8", "w3a16"])
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_w3_a_kernel_matches_plain_side_layouts(dev, spec, abits):
    qt = _artifact(dev, 1024, 256, SPECS[spec], seed=2, bits=3)
    x = _x(dev, (2, 4, 1024), torch.float32)
    y = dm.fused_quantized_matmul(x, qt, activation_bits=abits)
    assert y.shape == (2, 4, 256)
    _close_a(y, dm.dequant_matmul_plain(x, qt, activation_bits=abits), torch.float32)


@pytest.mark.parametrize("abits", [8, 16], ids=["w3a8", "w3a16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_w3_a_stacked_kernel_reads_the_layer_in_place(dev, layer, abits):
    qts = [_artifact(dev, 2048, 256, W3_SPEC, seed=10 + i) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st, abits)
    x = _x(dev, (8, 2048), torch.float32)
    y = dm.fused_quantized_matmul_stacked(x, st, layer, activation_bits=abits)
    _close_a(y, dm.dequant_matmul_plain(x, qts[layer], activation_bits=abits), torch.float32)


@pytest.mark.parametrize("kern", A_KERNELS)
@pytest.mark.parametrize("layer", [0, 2])
def test_a_stacked_kernel_reads_the_layer_in_place(dev, layer, kern):
    bits, abits, _ = kern
    qts = [_artifact(dev, 1408, 256, SPECS["g128_asym"], seed=10 + i, bits=bits)
           for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st, abits)
    x = _x(dev, (8, 1408), torch.float32)
    y = dm.fused_quantized_matmul_stacked(x, st, layer, activation_bits=abits)
    _close_a(y, dm.dequant_matmul_plain(x, qts[layer], activation_bits=abits), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 16])
def test_row_pass_codes_are_bit_equal_to_plain(dev, bits, dtype):
    x = _x(dev, (17, 1408), dtype) * 3
    x[4] = 0
    planes, sx = dm.quantize_activations_kernel(x, bits, 1536)
    want, want_sx = dm.quantize_activations(x, bits)
    assert torch.equal(planes[..., :1408], want) and not planes[..., 1408:].any()
    assert torch.equal(sx, want_sx)


# ------------------------------------------------------------- LUT kernels

@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("spec", list(LUT_SPECS), ids=list(LUT_SPECS))
def test_lut_kernel_matches_plain_shapes(dev, spec, shape, m, dtype, pre_norm):
    """``lut4``/``lut8`` (no prenorm kernel: a ``pre_norm`` normalizes x in
    torch first)."""
    spec, name = LUT_SPECS[spec]
    k, n, kw = SHAPES[shape]
    qt = _artifact(dev, k, n, spec, **kw)
    assert dm.kernel_supported(qt) and dm.kernel_name(qt, pre_norm) == name
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm), dtype)


def test_lut8_takes_byte_per_code_fp6(dev):
    """fp6 with K % 4 != 0 is stored a byte per code: ``lut8`` takes it."""
    qt = _artifact(dev, 510, 256, fp_spec("fp6", 3, 2, group_size=PER_CHANNEL,
                                          symmetric=False))
    assert dm.packed_bits(qt) == 8 and dm.kernel_name(qt) == dm.LUT8
    x = _x(dev, (5, 510), torch.float32)
    _close_a(dm.fused_quantized_matmul(x, qt), dm.dequant_matmul_plain(x, qt), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("spec", [s for s in LUT_SPECS if s.startswith("fp4")])
def test_lut4a16_kernel_matches_plain_shapes(dev, spec, shape, m, dtype, pre_norm):
    k, n, kw = SHAPES[shape]
    qt = _artifact(dev, k, n, LUT_SPECS[spec][0], **kw)
    assert dm.kernel_supported(qt, 16) and dm.kernel_name(qt, pre_norm, 16) == dm.LUT4A16
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm, activation_bits=16)
    assert dm.LAUNCHES[dm.LUT4A16] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm, activation_bits=16), dtype)


def test_lut8_under_a16_warns_and_runs_at_full_precision(dev):
    qt = _artifact(dev, 512, 256, LUT_SPECS["fp8_e4m3_g128_sym"][0])
    x = _x(dev, (8, 512), torch.bfloat16)
    dm.reset_counts()
    with pytest.warns(UserWarning, match="full-precision"):
        y = qmatmul.quantized_matmul(x, qt, activation_bits=16)
    assert dm.LAUNCHES[dm.LUT8] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt), torch.bfloat16)


@pytest.mark.parametrize("abits", [None, 16], ids=["flat", "a16"])
@pytest.mark.parametrize("spec", ["fp4_e2m1_g128_asym", "fp4_e1m2_g64_sym",
                                  "fp8_e4m3_g128_sym", "fp8_e2m5_g128_asym"])
@pytest.mark.parametrize("layer", [0, 2])
def test_lut_stacked_kernel_reads_the_layer_in_place(dev, layer, spec, abits):
    qts = [_artifact(dev, 1408, 256, LUT_SPECS[spec][0], seed=10 + i) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st, abits)
    x = _x(dev, (8, 1408), torch.float32)
    warns = abits and spec.startswith("fp8")  # fp8 has no A16 path: full precision
    with pytest.warns(UserWarning) if warns else contextlib.nullcontext():
        y = dm.fused_quantized_matmul_stacked(x, st, layer, activation_bits=abits)
    want = dm.dequant_matmul_plain(x, qts[layer], activation_bits=abits
                                   if dm.a16_supported(st) else None)
    _close_a(y, want, torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("shape", list(SHAPES6), ids=list(SHAPES6))
@pytest.mark.parametrize("spec,abits", [(s, None) for s in LUT6_SPECS] + [
    (s, 16) for s in LUT6_SPECS if "e2m3" in s], ids=[f"lut6-{s}" for s in LUT6_SPECS] + [
    f"lut6a16-{s}" for s in LUT6_SPECS if "e2m3" in s])
def test_lut6_kernel_matches_plain_shapes(dev, spec, abits, shape, m, dtype, pre_norm):
    """``lut6`` (no prenorm kernel: a ``pre_norm`` normalizes x in torch
    first) and, for E2M3 (the int8 grid; E3M2 under A16 runs ``lut6``,
    ``test_fp6_nq42_takes_lut6_on_the_card``), ``lut6a16`` (the norm in
    the row pass)."""
    spec = LUT6_SPECS[spec]
    k, n, kw = SHAPES6[shape]
    qt = _artifact(dev, k, n, spec, **kw)
    name = dm.LUT6A16 if abits else dm.LUT6
    assert dm.kernel_supported(qt, abits) and dm.kernel_name(qt, pre_norm, abits) == name
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm, activation_bits=abits)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm, activation_bits=abits), dtype)


@pytest.mark.parametrize("abits", [None, 16], ids=["lut6", "lut6a16"])
@pytest.mark.parametrize("spec", ["fp6_e2m3_g64_asym", "fp6_e2m3_g128_sym"])
@pytest.mark.parametrize("layer", [0, 2])
def test_lut6_stacked_kernel_reads_the_layer_in_place(dev, layer, spec, abits):
    qts = [_artifact(dev, 1536, 256, LUT6_SPECS[spec], seed=10 + i) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st, abits)
    x = _x(dev, (8, 1536), torch.float32)
    dm.reset_counts()
    y = dm.fused_quantized_matmul_stacked(x, st, layer, activation_bits=abits)
    assert dm.LAUNCHES[dm.LUT6A16 if abits else dm.LUT6] == 1
    _close_a(y, dm.dequant_matmul_plain(x, qts[layer], activation_bits=abits), torch.float32)


@pytest.mark.parametrize("kern", [pytest.param((4, None, dm.W4), id="bfp4_w4"),
                                  pytest.param((8, None, dm.W8), id="bfp8_w8"),
                                  pytest.param((4, EPS, dm.W4_PRENORM), id="bfp4_w4_prenorm"),
                                  pytest.param((4, 16, dm.W4A16), id="bfp4_w4a16"),
                                  pytest.param((8, 8, dm.W8A8), id="bfp8_w8a8")])
def test_bfp_artifacts_run_on_the_int_kernels(dev, kern):
    bits, arg, name = kern
    pre_norm, abits = (arg, None) if arg is None or arg < 1 else (None, arg)
    qt = _artifact(dev, 1408, 300, QuantSpec(fmt="bfp", bits=bits, group_size=128),
                   pad_n_to=512)
    assert qt.mode == "affine" and dm.kernel_name(qt, pre_norm, abits) == name
    x = _x(dev, (8, 1408), torch.bfloat16)
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm, activation_bits=abits)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm, activation_bits=abits),
             torch.bfloat16)


@pytest.mark.parametrize("spec", [LUT_SPECS["fp4_e2m1_g128_asym"][0],
                                  LUT_SPECS["fp8_e4m3_g128_sym"][0],
                                  fp_spec("fp6", 3, 2, group_size=64, symmetric=False),
                                  QuantSpec(fmt="bfp", bits=4, group_size=128),
                                  QuantSpec(fmt="bfp", bits=8, group_size=128)],
                         ids=["fp4", "fp8", "fp6", "bfp4", "bfp8"])
def test_card_built_artifacts_equal_cpu_built(dev, spec):
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w = torch.randn((1408, 300), generator=g, device=dev) * 0.05
    w[:, 7] *= 1e-4  # subnormal fp16 for BFP, tiny groups for the minifloats
    on_card = quantize_tensor(w, spec, pad_n_to=512, pad_k_to=512)
    on_cpu = quantize_tensor(w.cpu(), spec, pad_n_to=512, pad_k_to=512)
    for name in ("qweight", "scales", "zeros", "codebook"):
        a, b = getattr(on_card, name), getattr(on_cpu, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)), name


# ------------------------------------------------------- W4 inner-loop probe

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["f32", "magic"])
@pytest.mark.parametrize("m", [1, 8, 256])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_w4_inner_kernel_matches_plain_shapes(dev, shape, m, mode, dtype):
    """Both modes of the probe kernel, ``n_pad`` and ``k_pad`` artifacts and
    groups straddling the K halves included; one launch, no plain call."""
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import (
        w4_inner_matmul,
        w4_inner_plain,
    )

    k, n, kw = SHAPES[shape]
    qt = _artifact(dev, k, n, SPECS["g128_asym"], **kw)
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = w4_inner_matmul(x, qt, mode)
    name = dm.W4_INNER_MAGIC if mode == "magic" else dm.W4_INNER_F32
    assert dm.LAUNCHES == {**{k_: 0 for k_ in dm.LAUNCHES}, name: 1}
    assert not any(dm.PLAIN_CALLS.values())
    _close(y, w4_inner_plain(x, qt, mode), dtype)


@pytest.mark.parametrize("mode", ["f32", "magic"])
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_w4_inner_kernel_matches_plain_side_layouts(dev, spec, mode):
    from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import (
        w4_inner_matmul,
        w4_inner_plain,
    )

    qt = _artifact(dev, 512, 256, SPECS[spec], seed=2)
    x = _x(dev, (2, 4, 512), torch.float32)
    y = w4_inner_matmul(x, qt, mode)
    assert y.shape == (2, 4, 256)
    _close(y, w4_inner_plain(x, qt, mode), torch.float32)
    _close(y, dm.dequant_matmul_plain(x, qt), torch.float32)


# ------------------------------------------------------------------- serve

def test_valid_kv_write_does_not_sync(dev):
    from iron_weight_only_quant_tpu_torch.models.common import KVCacheView, update_kv_cache

    k = torch.zeros((4, 12, 2, 8), device=dev)
    view = KVCacheView(k, k.clone(), torch.tensor([0, 3, 11, 4], device=dev),
                       torch.tensor([5, 1, 5, 0], device=dev))
    new = torch.ones((4, 5, 2, 8), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = update_kv_cache(view, new, new)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.k[0, :5].eq(1).all() and out.k[1, 3].eq(1).all()
    assert out.k[1, 4:].eq(0).all() and out.k[2, 11].eq(1).all() and out.k[3].eq(0).all()


def _tiny_engine(dev, bits, spec=None, **ecfg):
    """Tiny 2-layer LLaMA, every linear ``bits``-bit g128 (or ``spec``); W3
    at hidden 1024 and FFN 2048, the least widths whose K/8 the group
    divides."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models import llama

    h, f, heads = (1024, 2048, 8) if bits == 3 else (256, 512, 4)
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=h, intermediate_size=f,
                            num_layers=2, num_heads=heads, num_kv_heads=heads // 2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = llama.fold_llama_norms(llama.llama_init(cfg, g, device=dev))
    spec = spec or QuantSpec(fmt="int", bits=bits, group_size=128, symmetric=False)
    for lin in [params["lm_head"]] + [v for p in params["layers"] for v in p.values()
                                      if isinstance(v, dict)]:
        lin["w"] = quantize_tensor(lin["w"], spec, pad_n_to=512)
    return InferenceEngine(params, cfg, llama.llama_forward, family="llama",
                           engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=48),
                                                   max_batch_size=4, fuse_projections=True,
                                                   **ecfg),
                           dtype=torch.bfloat16, device=dev)


@pytest.mark.parametrize("bits", [4, 8, 3])
def test_tiny_serve_on_the_card_is_repeatable(dev, bits):
    eng = _tiny_engine(dev, bits)
    n_layers = eng.cfg.num_layers
    reqs = [[(7 * i + j) % 255 + 1 for j in range(3 + 5 * i)] for i in range(6)]
    outs, stats = [], {}
    for _ in range(2):
        dm.reset_counts()
        outs.append(eng.serve(reqs, max_new_tokens=8, chunk=4, stats=stats))
    assert outs[0] == outs[1] and [len(o) for o in outs[0]] == [8] * 6
    if bits == 3:  # no prenorm kernel: every linear on w3_matmul
        assert dm.LAUNCHES[dm.W3] == stats["n_steps"] * (4 * n_layers + 1)
    else:
        names = (dm.W4, dm.W4_PRENORM) if bits == 4 else (dm.W8, dm.W8_PRENORM)
        assert dm.LAUNCHES[names[0]] == stats["n_steps"] * (2 * n_layers + 1)
        assert dm.LAUNCHES[names[1]] == stats["n_steps"] * 2 * n_layers
    assert sum(dm.LAUNCHES.values()) == stats["n_steps"] * (4 * n_layers + 1)
    assert not any(dm.PLAIN_CALLS.values())


@pytest.mark.parametrize("abits", [None, (8, 16)], ids=["bf16", "a8_wave_a16_chunk"])
def test_serve_device_calls_do_not_sync(dev, abits):
    """Between the meta copy and the token fetch, nothing waits for the card."""
    _serve_wave_and_chunk_without_sync(dev, 8, abits)


@pytest.mark.parametrize("abits", [None, (8, 16)], ids=["bf16", "a8_wave_a16_chunk"])
def test_w3_serve_device_calls_do_not_sync(dev, abits):
    """The same on a W3 model: the torch pre-norm before each W3 launch
    does not sync either."""
    _serve_wave_and_chunk_without_sync(dev, 3, abits)


def _serve_wave_and_chunk_without_sync(dev, bits, abits):
    from iron_weight_only_quant_tpu_torch.engine.engine import _serve_chunk, _serve_combo

    p_abits, d_abits = abits or (None, None)
    eng = _tiny_engine(dev, bits)
    c, s_len, ns = 4, 8, 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    combo_meta = torch.cat([
        torch.randint(1, 255, (ns * s_len,)), torch.tensor([8, 3, 1, 0]),
        torch.zeros(ns, dtype=torch.long), torch.tensor([1, 1, 1, 0]),
        torch.zeros(ns, dtype=torch.long), torch.zeros(ns * c, dtype=torch.long),
        torch.zeros(ns, dtype=torch.long)]).to(dev)
    chunk_meta = torch.cat([torch.tensor([5, 6, 7, 8]), torch.zeros(ns * c, dtype=torch.long),
                            torch.zeros(ns, dtype=torch.long),
                            torch.tensor([12, 7, 5, 0])]).to(dev)
    caches = eng._fresh_caches(ns)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            dm.reset_counts()
            out, caches = _serve_combo(eng.params, combo_meta, caches, gen, eng.forward,
                                       eng.cfg, 0.0, 0, 48, s_len, c, d_abits, p_abits)
            out2, caches = _serve_chunk(eng.params, chunk_meta, caches, gen, eng.forward,
                                        eng.cfg, 0.0, 0, 48, c, d_abits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (ns, 1 + c) and out2.shape == (ns, c)
    per_forward = 4 * eng.cfg.num_layers + 1
    if abits is not None:  # the wave on A8, the 2 * c steps on A16
        wave, step = (dm.W8A8, dm.W8A16) if bits == 8 else (dm.W3A8, dm.W3A16)
        assert dm.LAUNCHES[wave] == per_forward
        assert dm.LAUNCHES[step] == 2 * c * per_forward
    elif bits == 3:
        assert dm.LAUNCHES[dm.W3] == (1 + 2 * c) * per_forward


@pytest.mark.parametrize("abits", [(8, 16), (16, 8)], ids=["a8_waves", "a16_waves"])
@pytest.mark.parametrize("bits", [4, 8, 3])
def test_tiny_a_serve_on_the_card_is_repeatable(dev, bits, abits):
    eng = _tiny_engine(dev, bits, prefill_activation_bits=abits[0],
                       activation_bits=abits[1])
    n_layers = eng.cfg.num_layers
    reqs = [[(7 * i + j) % 255 + 1 for j in range(3 + 5 * i)] for i in range(6)]
    outs, stats = [], {}
    for _ in range(2):
        dm.reset_counts()
        outs.append(eng.serve(reqs, max_new_tokens=8, chunk=4, stats=stats))
    assert outs[0] == outs[1] and [len(o) for o in outs[0]] == [8] * 6
    wave, step = (dm.kernel_name(eng.params["lm_head"]["w"], None, b) for b in abits)
    per_forward = 4 * n_layers + 1
    assert dm.LAUNCHES[wave] == stats["n_combos"] * per_forward
    assert dm.LAUNCHES[step] == (stats["n_steps"] - stats["n_combos"]) * per_forward
    assert sum(dm.LAUNCHES.values()) == stats["n_steps"] * per_forward
    assert not any(dm.PLAIN_CALLS.values())


@pytest.mark.parametrize("case", ["fp4", "fp4_a16", "fp8", "fp6", "fp6_a16"])
def test_tiny_lut_serve_on_the_card_is_repeatable(dev, case):
    """Every linear of a forward on ``lut4`` (fp4 E2M1 g128 asym), ``lut4a16``
    (A16 waves and decode), ``lut8`` (fp8 E4M3 g128 sym), ``lut6`` (fp6
    E2M3 g64 sym: the group divides the K/4 = 64 quad rows of hidden 256)
    or ``lut6a16``: no prenorm kernel, so ``forwards * (4L + 1)``
    launches."""
    spec = {"fp8": LUT_SPECS["fp8_e4m3_g128_sym"][0],
            "fp6": fp_spec("fp6", 2, 3, group_size=64)}.get(
        case.split("_")[0], LUT_SPECS["fp4_e2m1_g128_asym"][0])
    ecfg = dict(activation_bits=16) if case.endswith("a16") else {}
    eng = _tiny_engine(dev, 4, spec=spec, **ecfg)
    name = {"fp4": dm.LUT4, "fp4_a16": dm.LUT4A16, "fp8": dm.LUT8, "fp6": dm.LUT6,
            "fp6_a16": dm.LUT6A16}[case]
    reqs = [[(7 * i + j) % 255 + 1 for j in range(3 + 5 * i)] for i in range(6)]
    outs, stats = [], {}
    for _ in range(2):
        dm.reset_counts()
        outs.append(eng.serve(reqs, max_new_tokens=8, chunk=4, stats=stats))
    assert outs[0] == outs[1] and [len(o) for o in outs[0]] == [8] * 6
    per_forward = 4 * eng.cfg.num_layers + 1
    assert dm.LAUNCHES == {**{k: 0 for k in dm.LAUNCHES},
                           name: stats["n_steps"] * per_forward}
    assert not any(dm.PLAIN_CALLS.values()) and not any(dm.ROUTE_CALLS.values())
