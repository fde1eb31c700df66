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
and fp6 E2M3 also under A16; every A16 kernel and ``w4a8`` (one plane) run
on the tensor-core slab kernel (``-k slab``: token tiles, ragged groups,
side layouts, stacked calls, unaligned x, the row pass), and the bf16-x
calls of ``lut4``, ``lut6``, ``lut8``, ``w3``, ``w4``, ``w4_prenorm``,
``w8`` and ``w8_prenorm`` on its bf16 family (``-k mma``: the W4, W8 and
fp8 routes also at the five LLaMA-2-7B shapes, the W4 and W8 row factors
with one split and with a K-split, every byte of the byte layouts decoded
exactly); BFP artifacts run on the W4 and W8 kernels;
card-built int/fp/bfp artifacts must equal CPU-built ones byte for byte.  The
W4 inner-loop probe kernel runs both its decodes on the W4 shapes.
Artifacts the JAX package computes on its XLA path take the route
(``ROUTE_CALLS``) on the card too.  The serve loop's KV write, a wave and a
chunk (also under activation bits, on a W3 model, and on paged caches) and
tiny ``serve`` runs (also fp4, fp6 and fp8, and on int8, int4 and paged KV
caches, the paged ones against their contiguous caches' tokens) are
checked for host syncs, launch counts and repeatability; the KV codec on
the card must give the CPU's bits; an artifact saved and loaded onto the
card must give the same tensors and tokens.  The scan path (stacked params
and caches) gives the flat path's tokens with exact stacked launches, on
LLaMA (W4, W8; 16-bit and int8 caches), OPT and BLOOM, and its waves,
chunks and decode steps do not sync.  The GPTQ solver on the card meets
``tests/test_gptq.py``'s criterion against its CPU solve (4-bit g128,
3-bit per-channel, 8-bit, with TF32 left on by the caller), and an
unpadded N = 11008 W4 artifact (GPTQ artifacts carry no ``pad_n_to``)
goes through ``w4_matmul`` and ``w4_matmul_prenorm`` at M = 1, 8, 512.
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
                                  QuantSpec(fmt="bfp", bits=8, group_size=128),
                                  SPECS["g128_asym"],
                                  QuantSpec(fmt="int", bits=8, group_size=128, symmetric=True),
                                  QuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL,
                                            symmetric=False)],
                         ids=["fp4", "fp8", "fp6", "bfp4", "bfp8", "int4", "int8_sym",
                              "int3_perchannel"])
def test_card_built_artifacts_equal_cpu_built(dev, spec):
    """Every format, int included: the int codec divides by a tensor (a
    Python-scalar divisor is a reciprocal product on CUDA)."""
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


# ------------------------------------- A16 slab kernels on the tensor cores

# (kernel, spec, K, N, quantize_tensor kwargs) of the slab A16 kernels
# (csrc/wa_slab_mma.cuh): the main-path group, and the artifacts whose
# groups or slabs are not a multiple of the kernel's 32-row window
W8_SPEC = dataclasses.replace(SPECS["g128_asym"], bits=8)
SLAB_A16 = {
    "w4a16": (dm.W4A16, SPECS["g128_asym"], 1024, 256, {}),
    "w3a16": (dm.W3A16, W3_SPEC, 1024, 256, {}),
    "lut6a16": (dm.LUT6A16, LUT6_SPECS["fp6_e2m3_g128_sym"], 1024, 256, {}),
    "w8a16": (dm.W8A16, W8_SPEC, 1024, 256, {}),
    "lut4a16": (dm.LUT4A16, LUT_SPECS["fp4_e2m1_g128_asym"][0], 1024, 256, {}),
}
SLAB_RAGGED = {  # Kb = 136 (w3) and Kq = 272 (fp6) at K = 1088; groups of 16 rows
    "w3_perchannel_asym_k1088": (dm.W3A16, dataclasses.replace(
        SPECS["perchannel_sym"], bits=3, symmetric=False), 1088, 256, {}),
    "fp6_e2m3_perchannel_asym_k1088": (dm.LUT6A16, fp_spec(
        "fp6", 2, 3, group_size=PER_CHANNEL, symmetric=False), 1088, 256, {}),
    "w3_g16_asym": (dm.W3A16, dataclasses.replace(W3_SPEC, group_size=16), 1024, 256, {}),
    "fp6_e2m3_g16_sym": (dm.LUT6A16, fp_spec("fp6", 2, 3, group_size=16), 1024, 256, {}),
    "fp6_e1m4_g128_asym": (dm.LUT6A16, fp_spec("fp6", 1, 4, group_size=128,
                                               symmetric=False), 1024, 256, {}),
    "w3_npad_300": (dm.W3A16, W3_SPEC, 1024, 300, {}),
    "fp6_npad_300": (dm.LUT6A16, LUT6_SPECS["fp6_e2m3_g128_sym"], 1024, 300, {}),
    "fp6_kpad": (dm.LUT6A16, LUT6_SPECS["fp6_e2m3_g128_sym"], 384, 256, dict(pad_k_to=512)),
    "w3_kpad": (dm.W3A16, W3_SPEC, 896, 256, dict(pad_k_to=1024)),
    # the byte (K rows split in four parts a block) and nib4 (two slabs of
    # K/2 rows, two parts) layouts: K = 1088 is 8.5 windows of 128 (byte)
    # and 8.5 of 64 (nib4) rows
    "w8_perchannel_asym_k1088": (dm.W8A16, dataclasses.replace(
        SPECS["perchannel_sym"], bits=8, symmetric=False), 1088, 256, {}),
    "w8_g16_asym": (dm.W8A16, dataclasses.replace(W8_SPEC, group_size=16), 1024, 256, {}),
    "w8_npad_300": (dm.W8A16, W8_SPEC, 1024, 300, {}),
    "w8_kpad": (dm.W8A16, W8_SPEC, 896, 256, dict(pad_k_to=1024)),
    "bfp8_npad_300": (dm.W8A16, QuantSpec(fmt="bfp", bits=8, group_size=128), 1408, 300,
                      dict(pad_n_to=512)),
    "fp4_e2m1_perchannel_asym_k1088": (dm.LUT4A16, fp_spec(
        "fp4", 2, 1, group_size=PER_CHANNEL, symmetric=False), 1088, 256, {}),
    "fp4_e2m1_g16_sym": (dm.LUT4A16, fp_spec("fp4", 2, 1, group_size=16), 1024, 256, {}),
    "fp4_e1m2_g64_sym": (dm.LUT4A16, LUT_SPECS["fp4_e1m2_g64_sym"][0], 1024, 256, {}),
    "fp4_straddle_k1408": (dm.LUT4A16, LUT_SPECS["fp4_e2m1_g128_asym"][0], 1408, 128, {}),
    "fp4_npad_300": (dm.LUT4A16, LUT_SPECS["fp4_e2m1_g128_asym"][0], 1024, 300, {}),
    "fp4_kpad": (dm.LUT4A16, LUT_SPECS["fp4_e2m1_g128_asym"][0], 384, 256,
                 dict(pad_k_to=512)),
    # the affine nib4 layout (w4a16): the same packing as lut4a16's
    "w4_perchannel_asym_k1088": (dm.W4A16, dataclasses.replace(
        SPECS["perchannel_sym"], symmetric=False), 1088, 256, {}),
    "w4_g16_asym": (dm.W4A16, dataclasses.replace(SPECS["g128_asym"], group_size=16), 1024,
                    256, {}),
    "w4_straddle_k1408": (dm.W4A16, SPECS["g128_asym"], 1408, 128, {}),
    "w4_npad_300": (dm.W4A16, SPECS["g128_asym"], 1024, 300, {}),
    "w4_kpad": (dm.W4A16, SPECS["g128_asym"], 384, 256, dict(pad_k_to=512)),
    "bfp4_npad_300": (dm.W4A16, QuantSpec(fmt="bfp", bits=4, group_size=128), 1408, 300,
                      dict(pad_n_to=512)),
}
SLAB_SIDES = {  # the side layouts of the earlier kernel tests
    "fp6_e2m3_g32_sym": (dm.LUT6A16, LUT6_SPECS["fp6_e2m3_g32_sym"], 1024, 256, {}),
    "fp6_e2m3_g64_asym": (dm.LUT6A16, LUT6_SPECS["fp6_e2m3_g64_asym"], 1024, 256, {}),
    "w3_g128_sym": (dm.W3A16, dataclasses.replace(SPECS["g128_sym"], bits=3), 1024, 256, {}),
    "w3_perchannel_asym": (dm.W3A16, dataclasses.replace(
        SPECS["perchannel_sym"], bits=3, symmetric=False), 1024, 256, {}),
    "w3_pertensor_sym": (dm.W3A16, dataclasses.replace(
        SPECS["pertensor_asym"], bits=3, symmetric=True), 1024, 256, {}),
    "w8_g128_sym": (dm.W8A16, dataclasses.replace(SPECS["g128_sym"], bits=8), 1024, 256, {}),
    "w8_pertensor_asym": (dm.W8A16, dataclasses.replace(SPECS["pertensor_asym"], bits=8),
                          1024, 256, {}),
    "fp4_e2m1_g128_sym": (dm.LUT4A16, LUT_SPECS["fp4_e2m1_g128_sym"][0], 1024, 256, {}),
    "w4_g128_sym": (dm.W4A16, SPECS["g128_sym"], 1024, 256, {}),
    "w4_perchannel_asym": (dm.W4A16, dataclasses.replace(SPECS["perchannel_sym"],
                                                         symmetric=False), 1024, 256, {}),
    "w4_pertensor_sym": (dm.W4A16, dataclasses.replace(SPECS["pertensor_asym"],
                                                       symmetric=True), 1024, 256, {}),
}


def _slab_call(dev, case, m, dtype, pre_norm=None, seed=3, abits=16):
    name, spec, k, n, kw = case
    qt = _artifact(dev, k, n, spec, seed=seed, **kw)
    assert dm.kernel_supported(qt, abits) and dm.kernel_name(qt, pre_norm, abits) == name
    assert name in dm.SLAB_MMA
    x = _x(dev, (m, k), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm, activation_bits=abits)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm, activation_bits=abits), dtype)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 512])
@pytest.mark.parametrize("kern", list(SLAB_A16))
def test_slab_a16_kernel_matches_plain_token_tiles(dev, kern, m, dtype, pre_norm):
    """The decode tile (M <= 8), the wide tiles (9 .. 512 rows, several
    token tiles), one and several K-splits, against the plain versions."""
    _slab_call(dev, SLAB_A16[kern], m, dtype, pre_norm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 8, 40])
@pytest.mark.parametrize("case", list(SLAB_RAGGED) + list(SLAB_SIDES))
def test_slab_a16_kernel_takes_ragged_groups_and_side_layouts(dev, case, m, dtype):
    """Groups and slabs that are not a multiple of the 32-row window (the
    MMA's K then masks the activations outside the segment), ranges whose
    last part ends early (byte, nib4), nib4 groups that straddle the K
    halves, N not a multiple of 16 (4-byte copies), K padding, E1M4, fp4
    E1M2, BFP8, BFP4, and the side layouts."""
    _slab_call(dev, {**SLAB_RAGGED, **SLAB_SIDES}[case], m, dtype)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("kern", list(SLAB_A16))
def test_slab_a16_kernel_reads_x_off_a_16_byte_boundary(dev, kern, m):
    """x 2 bytes (bf16) or 4 bytes (f32) off a 16-byte boundary: the row
    pass reads it element by element."""
    name, spec, k, n, kw = SLAB_A16[kern]
    qt = _artifact(dev, k, n, spec, **kw)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.empty((m * k + 1,), dtype=dtype, device=dev)[1:].view(m, k)
        x.copy_(_x(dev, (m, k), dtype) * 3)
        assert x.is_contiguous() and x.data_ptr() % 16
        dm.reset_counts()
        y = dm.fused_quantized_matmul(x, qt, pre_norm=EPS, activation_bits=16)
        assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
        _close_a(y, dm.dequant_matmul_plain(x, qt, EPS, activation_bits=16), dtype)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("kern", list(SLAB_A16))
def test_slab_a16_stacked_kernel_reads_layer_2_of_3(dev, kern, m):
    name, spec, k, n, _ = SLAB_A16[kern]
    qts = [_artifact(dev, k, n, spec, seed=20 + i) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st, 16)
    x = _x(dev, (m, k), torch.float32)
    dm.reset_counts()
    y = dm.fused_quantized_matmul_stacked(x, st, 2, activation_bits=16)
    assert dm.LAUNCHES[name] == 1
    _close_a(y, dm.dequant_matmul_plain(x, qts[2], activation_bits=16), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slabs,kb,g", [(8, 128, 128), (8, 136, 136), (4, 272, 16),
                                        (4, 1024, 128), (8, 1408, 128), (1, 1088, 1088),
                                        (1, 1024, 128), (2, 704, 64), (2, 2048, 128)])
def test_slab_row_pass_codes_and_sums_are_bit_equal_to_plain(dev, slabs, kb, g, dtype,
                                                             pre_norm):
    """The slab kernels' row pass: codes and row scales bit-equal to
    quantize_activations (of the normalized x under pre_norm), K padding
    zero, and its per-group sums equal to activation_group_sums."""
    k = slabs * kb - 8  # a K-padded artifact's logical K
    x = _x(dev, (9, k), dtype) * 3
    x[4] = 0
    planes, sx, sums = dm.quantize_activations_slab_kernel(x, slabs, kb, g, pre_norm)
    xn = x if pre_norm is None else qmatmul._rms_nogamma(x, pre_norm)
    want, want_sx = dm.quantize_activations(xn, 16)
    if pre_norm is None:  # the plain norm reduces in another order
        assert torch.equal(planes[..., :k], want) and torch.equal(sx, want_sx)
    assert not planes[..., k:].any()
    assert torch.equal(sums.long(), dm.activation_group_sums(planes, g))
    padded = torch.nn.functional.pad(want, (0, 8))
    if pre_norm is None:
        assert torch.equal(sums.long(), dm.activation_group_sums(padded, g))


# ------------------- w4a8, w8a8, w3a8 on the int8 slab kernel, one plane

# (kernel, spec, K, N, quantize_tensor kwargs): the main-path group of each
# A8 kernel (w4a8, w8a8, w3a8: the affine nib4, byte and s21 layouts with
# one plane), and the affine artifacts of the A16 slab tests on the same
# layouts (ragged groups and slabs, ranges whose last part ends early, K
# halves straddled, N padding and 4-byte copies, K padding, BFP4, BFP8,
# side layouts), now under A8
_A8_OF = {dm.W4A16: dm.W4A8, dm.W8A16: dm.W8A8, dm.W3A16: dm.W3A8}
SLAB_A8_MAIN = {"w4a8": (dm.W4A8, SPECS["g128_asym"], 1024, 256, {}),
                "w8a8": (dm.W8A8, W8_SPEC, 1024, 256, {}),
                "w3a8": (dm.W3A8, W3_SPEC, 1024, 256, {})}
SLAB_A8 = {**SLAB_A8_MAIN,
           **{c.replace("_", "a8_", 1): (_A8_OF[v[0]], *v[1:])
              for c, v in {**SLAB_RAGGED, **SLAB_SIDES}.items() if v[0] in _A8_OF}}


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 512])
@pytest.mark.parametrize("kern", list(SLAB_A8_MAIN))
def test_slab_a8_kernel_matches_plain_token_tiles(dev, kern, m, dtype, pre_norm):
    """``w4a8``, ``w8a8``, ``w3a8``: the decode tile, the wide tiles, one
    and several K-splits, the pre-norm in the row pass, against the plain
    version."""
    _slab_call(dev, SLAB_A8[kern], m, dtype, pre_norm, abits=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 8, 40])
@pytest.mark.parametrize("case", [c for c in SLAB_A8 if c not in SLAB_A8_MAIN])
def test_slab_a8_kernel_takes_ragged_groups_and_side_layouts(dev, case, m, dtype):
    _slab_call(dev, SLAB_A8[case], m, dtype, abits=8)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("kern", list(SLAB_A8_MAIN))
def test_slab_a8_stacked_kernel_reads_layer_2_of_3_and_unaligned_x(dev, kern, m):
    name, spec, k, n, _ = SLAB_A8[kern]
    qts = [_artifact(dev, k, n, spec, seed=20 + i) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st, 8)
    x = _x(dev, (m, k), torch.float32)
    dm.reset_counts()
    y = dm.fused_quantized_matmul_stacked(x, st, 2, activation_bits=8)
    assert dm.LAUNCHES[name] == 1
    _close_a(y, dm.dequant_matmul_plain(x, qts[2], activation_bits=8), torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        xu = torch.empty((m * k + 1,), dtype=dtype, device=dev)[1:].view(m, k)
        xu.copy_(x * 3)
        y = dm.fused_quantized_matmul(xu, qts[0], pre_norm=EPS, activation_bits=8)
        _close_a(y, dm.dequant_matmul_plain(xu, qts[0], EPS, activation_bits=8), dtype)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slabs,kb,g", [(2, 704, 64), (2, 2048, 128), (2, 544, 544),
                                        (1, 1024, 128), (1, 1088, 1088), (1, 1024, 16),
                                        (8, 136, 136), (8, 1408, 128), (8, 128, 16)])
def test_slab_a8_row_pass_codes_and_sums_are_bit_equal_to_plain(dev, slabs, kb, g, dtype,
                                                                pre_norm):
    """The one-plane row pass: codes and row scales bit-equal to
    ``quantize_activations(x, 8)`` (of the normalized x under pre_norm), K
    padding zero, and its per-group sums (the plain sums of the codes)
    equal to ``activation_group_sums`` of the one plane."""
    k = slabs * kb - 8
    x = _x(dev, (9, k), dtype) * 3
    x[4] = 0
    planes, sx, sums = dm.quantize_activations_slab_kernel(x, slabs, kb, g, pre_norm, bits=8)
    assert planes.shape == (1, 9, slabs * kb)
    xn = x if pre_norm is None else qmatmul._rms_nogamma(x, pre_norm)
    want, want_sx = dm.quantize_activations(xn, 8)
    if pre_norm is None:  # the plain norm reduces in another order
        assert torch.equal(planes[..., :k], want) and torch.equal(sx, want_sx)
    assert not planes[..., k:].any()
    assert torch.equal(sums.long(), dm.activation_group_sums(planes, g))


# ------------------------------- bf16-x LUT calls on the bf16 tensor cores

# (spec, K, N, quantize_tensor kwargs) of the bf16 route of lut4_matmul and
# lut6_matmul (the bf16 family of csrc/wa_slab_mma.cuh): every fp4 entry of
# LUT_SPECS and every LUT6_SPECS entry, then the ragged cases: per-channel
# K = 1088 (Kb = 544 and 272: the last range ends inside a window, a part or
# a K-split cuts a group), groups of 16 rows (two a window), nib4 groups
# straddling the K halves, N = 300 stored as 512 (n_pad) and as 300 (4-byte
# weight copies), and K padding
LUT_MMA_CASES = {
    **{s: (LUT_SPECS[s][0], 1024, 256, {}) for s in LUT_SPECS if s.startswith("fp4")},
    **{s: (LUT6_SPECS[s], 1024, 256, {}) for s in LUT6_SPECS},
    "fp4_e2m1_g16_sym": (fp_spec("fp4", 2, 1, group_size=16), 1024, 256, {}),
    "fp4_e2m1_perchannel_asym_k1088": (LUT_SPECS["fp4_e2m1_perchannel_asym"][0], 1088, 256, {}),
    "fp4_straddle_k1408": (LUT_SPECS["fp4_e2m1_g128_asym"][0], 1408, 128, {}),
    "fp4_npad_300": (LUT_SPECS["fp4_e2m1_g128_asym"][0], 1024, 300, dict(pad_n_to=512)),
    "fp4_n300": (LUT_SPECS["fp4_e2m1_g128_asym"][0], 1024, 300, {}),
    "fp4_kpad": (LUT_SPECS["fp4_e1m2_g64_sym"][0], 384, 256, dict(pad_k_to=512)),
    "fp6_e2m3_g16_sym": (fp_spec("fp6", 2, 3, group_size=16), 1024, 256, {}),
    "fp6_e2m3_perchannel_asym_k1088": (fp_spec("fp6", 2, 3, group_size=PER_CHANNEL,
                                               symmetric=False), 1088, 256, {}),
    "fp6_e1m4_g128_asym": (fp_spec("fp6", 1, 4, group_size=128, symmetric=False), 1024, 256, {}),
    "fp6_npad_300": (LUT6_SPECS["fp6_e3m2_g128_asym"], 1024, 300, dict(pad_n_to=512)),
    "fp6_n300": (LUT6_SPECS["fp6_e2m3_g128_sym"], 1024, 300, {}),
    "fp6_kpad": (LUT6_SPECS["fp6_e2m3_g64_asym"], 384, 256, dict(pad_k_to=512)),
}


def _lut_mma_call(dev, qt, x, pre_norm=None, layer=None):
    """One bf16-x call on the bf16 route: exactly one launch of the
    artifact's kernel (LUT, W3, W4 or W8), no plain call, no route call; the
    result."""
    name = dm.kernel_name(qt, pre_norm)
    assert name in dm.BF16_MMA and dm.bf16_mma_route(qt, torch.bfloat16, pre_norm)
    dm.reset_counts()
    if layer is None:
        y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    else:
        y = dm.fused_quantized_matmul_stacked(x, qt, layer, pre_norm=pre_norm)
    assert dm.LAUNCHES == {**{k_: 0 for k_ in dm.LAUNCHES}, name: 1}
    assert not any(dm.PLAIN_CALLS.values()) and not any(dm.ROUTE_CALLS.values())
    return y


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 64, 256])
@pytest.mark.parametrize("case", list(LUT_MMA_CASES))
def test_lut_mma_route_matches_plain(dev, case, m, pre_norm):
    """The decode tile (M <= 8) and the 64-token tile, one and several
    K-splits, with the pre-norm in the row pass, against the plain version
    (which normalizes x in torch first)."""
    spec, k, n, kw = LUT_MMA_CASES[case]
    qt = _artifact(dev, k, n, spec, **kw)
    x = _x(dev, (m, k), torch.bfloat16) * 3
    y = _lut_mma_call(dev, qt, x, pre_norm)
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm), torch.bfloat16)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["fp4_e2m1_g128_asym", "fp4_e1m2_g64_sym",
                                  "fp6_e2m3_g128_sym", "fp6_e2m3_g64_asym"])
def test_lut_mma_stacked_reads_layer_2_of_3(dev, case, m):
    spec, k, n, kw = LUT_MMA_CASES[case]
    qts = [_artifact(dev, k, n, spec, seed=30 + i, **kw) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st)
    x = _x(dev, (m, k), torch.bfloat16) * 3
    y = _lut_mma_call(dev, st, x, EPS, layer=2)
    _close_a(y, dm.dequant_matmul_plain(x, qts[2], EPS), torch.bfloat16)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["fp4_e2m1_g128_asym", "fp6_e3m2_g128_asym"])
def test_lut_mma_copies_x_it_cannot_read_in_place(dev, case, m):
    """x 2 bytes off a 16-byte boundary: the row pass copies it."""
    spec, k, n, kw = LUT_MMA_CASES[case]
    qt = _artifact(dev, k, n, spec, **kw)
    x = torch.empty((m * k + 1,), dtype=torch.bfloat16, device=dev)[1:].view(m, k)
    x.copy_(_x(dev, (m, k), torch.bfloat16) * 3)
    slabs = dm.SLAB_TILES[dm.BF16_MMA[dm.kernel_name(qt)]][0]
    assert x.is_contiguous() and dm.x_needs_copy(x, k // slabs)
    y = _lut_mma_call(dev, qt, x)
    _close_a(y, dm.dequant_matmul_plain(x, qt), torch.bfloat16)


def test_lut_mma_decodes_every_code_exactly(dev):
    """Every code of every format of the route (subnormals among them):
    random packed bytes, so that each code occurs, against one-hot rows of
    x, whose products are the values themselves (per-channel sides: one
    group), bit-equal to the plain version."""
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    for spec in [fp_spec("fp4", e, 3 - e, group_size=PER_CHANNEL, symmetric=False)
                 for e in (1, 2, 3)] + [fp_spec("fp6", e, 5 - e, group_size=PER_CHANNEL)
                                        for e in (1, 2, 3)]:
        qt = _artifact(dev, 1024, 256, spec)
        qt = qt.replace(qweight=torch.randint(0, 256, qt.qweight.shape, generator=g,
                                              device=dev, dtype=torch.uint8))
        x = torch.eye(1024, device=dev, dtype=torch.bfloat16)
        y = _lut_mma_call(dev, qt, x)
        assert torch.equal(y, dm.dequant_matmul_plain(x, qt)), spec


# ------------------------------------ bf16-x W3 calls on the bf16 tensor cores

# (spec, K, N, quantize_tensor kwargs) of the bf16 route of w3_matmul (the
# s21 case of the bf16 family): the main-path group, the side layouts, and
# the ragged cases: per-channel K = 1088 (Kb = 136: the range ends inside a
# window), groups of 16 rows, N = 300 stored as 512 (n_pad) and as 300
# (4-byte weight copies), and K padding
W3_MMA_CASES = {
    "w3_g128_asym": (W3_SPEC, 1024, 256, {}),
    "w3_g128_sym": (dataclasses.replace(W3_SPEC, symmetric=True), 1024, 256, {}),
    "w3_perchannel_asym": (dataclasses.replace(W3_SPEC, group_size=PER_CHANNEL), 1024, 256,
                           {}),
    "w3_pertensor_sym": (dataclasses.replace(W3_SPEC, group_size=PER_TENSOR, symmetric=True),
                         1024, 256, {}),
    "w3_perchannel_asym_k1088": (dataclasses.replace(W3_SPEC, group_size=PER_CHANNEL), 1088,
                                 256, {}),
    "w3_g16_asym": (dataclasses.replace(W3_SPEC, group_size=16), 1024, 256, {}),
    "w3_npad_300": (W3_SPEC, 1024, 300, dict(pad_n_to=512)),
    "w3_n300": (W3_SPEC, 1024, 300, {}),
    "w3_kpad": (W3_SPEC, 896, 256, dict(pad_k_to=1024)),
}


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 9, 40, 64, 256])
@pytest.mark.parametrize("case", list(W3_MMA_CASES))
def test_w3_mma_route_matches_plain(dev, case, m, pre_norm):
    """The decode tile (M <= 8) and the 32-token tile (one, a partial one,
    several), one and several K-splits, with the pre-norm in the row pass,
    against the plain version (which normalizes x in torch first); f32 x
    stays on the CUDA-core kernel at the f32 tolerance."""
    spec, k, n, kw = W3_MMA_CASES[case]
    qt = _artifact(dev, k, n, spec, **kw)
    x = _x(dev, (m, k), torch.bfloat16) * 3
    y = _lut_mma_call(dev, qt, x, pre_norm)
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm), torch.bfloat16)
    if m == 8 and pre_norm is None:
        xf = x.float()
        dm.reset_counts()
        y = dm.fused_quantized_matmul(xf, qt)
        assert dm.LAUNCHES[dm.W3] == 1 == sum(dm.LAUNCHES.values())
        _close(y, dm.dequant_matmul_plain(xf, qt), torch.float32)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["w3_g128_asym", "w3_perchannel_asym"])
def test_w3_mma_stacked_reads_layer_2_of_3(dev, case, m):
    spec, k, n, kw = W3_MMA_CASES[case]
    qts = [_artifact(dev, k, n, spec, seed=40 + i, **kw) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st)
    x = _x(dev, (m, k), torch.bfloat16) * 3
    y = _lut_mma_call(dev, st, x, EPS, layer=2)
    _close_a(y, dm.dequant_matmul_plain(x, qts[2], EPS), torch.bfloat16)


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["w3_g128_asym", "w3_kpad"])
def test_w3_mma_copies_x_it_cannot_read_in_place(dev, case, m):
    """x 2 bytes off a 16-byte boundary: the row pass copies it."""
    spec, k, n, kw = W3_MMA_CASES[case]
    qt = _artifact(dev, k, n, spec, **kw)
    x = torch.empty((m * k + 1,), dtype=torch.bfloat16, device=dev)[1:].view(m, k)
    x.copy_(_x(dev, (m, k), torch.bfloat16) * 3)
    assert x.is_contiguous() and x.data_ptr() % 16
    y = _lut_mma_call(dev, qt, x)
    _close_a(y, dm.dequant_matmul_plain(x, qt), torch.bfloat16)


# ----------------------- bf16-x W4 calls (flat and prenorm) on the bf16 tensor cores

# (spec, K, N, quantize_tensor kwargs) of the bf16 route of w4_matmul and
# w4_matmul_prenorm (the affine nib4 case of the bf16 family): the five
# LLaMA-2-7B shapes (qkv, o, gate_up, down, lm_head; N padded to 512), the
# side layouts, and the ragged cases: per-channel K = 1088 (Kb = 544: the
# range ends inside a window, a part or a K-split cuts a group), groups of
# 16 rows (two a window), groups straddling the K halves (K = 1408: split in
# two per call), N = 300 stored as 512 (n_pad) and as 300 (4-byte weight
# copies), K padding, and BFP4
W4_SPEC = SPECS["g128_asym"]
W4_MMA_7B = {
    "7b_qkv": (W4_SPEC, 4096, 12288, {}),
    "7b_o": (W4_SPEC, 4096, 4096, {}),
    "7b_gate_up": (W4_SPEC, 4096, 22016, {}),
    "7b_down": (W4_SPEC, 11008, 4096, dict(pad_n_to=512)),
    "7b_lm_head": (W4_SPEC, 4096, 32000, dict(pad_n_to=512)),
}
W4_MMA_CASES = {
    "w4_g128_asym": (W4_SPEC, 1024, 256, {}),
    "w4_g128_sym": (SPECS["g128_sym"], 1024, 256, {}),
    "w4_g64_asym": (SPECS["g64_asym"], 1024, 256, {}),
    "w4_perchannel_sym": (SPECS["perchannel_sym"], 1024, 256, {}),
    "w4_pertensor_asym": (SPECS["pertensor_asym"], 1024, 256, {}),
    "w4_perchannel_asym_k1088": (dataclasses.replace(SPECS["perchannel_sym"], symmetric=False),
                                 1088, 256, {}),
    "w4_g16_asym": (dataclasses.replace(W4_SPEC, group_size=16), 1024, 256, {}),
    "w4_straddle_k1408": (W4_SPEC, 1408, 128, {}),
    "w4_npad_300": (W4_SPEC, 1024, 300, dict(pad_n_to=512)),
    "w4_n300": (W4_SPEC, 1024, 300, {}),
    "w4_kpad": (W4_SPEC, 384, 256, dict(pad_k_to=512)),
    "bfp4_npad_300": (QuantSpec(fmt="bfp", bits=4, group_size=128), 1408, 300,
                      dict(pad_n_to=512)),
}


def _w4_mma_check(dev, case, m, pre_norm, x=None, layer=None):
    """One bf16-x W4 call on the route (``_lut_mma_call``: one launch of
    ``w4_matmul`` or, with ``pre_norm``, ``w4_matmul_prenorm``) against the
    plain version, which applies the row factor to the f32 sum."""
    spec, k, n, kw = case
    qt = _artifact(dev, k, n, spec, **kw)
    if x is None:
        x = _x(dev, (m, k), torch.bfloat16) * 3
    assert dm.kernel_name(qt, pre_norm) == (dm.W4 if pre_norm is None else dm.W4_PRENORM)
    y = _lut_mma_call(dev, qt, x, pre_norm)
    _close_a(y, dm.dequant_matmul_plain(x, qt, pre_norm), torch.bfloat16)
    return qt, x


@pytest.mark.parametrize("m", [1, 8, 9, 64, 256])
@pytest.mark.parametrize("case", list(W4_MMA_7B))
def test_w4_mma_route_matches_plain_7b_shapes(dev, case, m):
    """The main path's five shapes, qkv and gate_up with the pre-norm (the
    prenorm kernel), the others flat, at decode and prefill row counts."""
    pre_norm = EPS if case in ("7b_qkv", "7b_gate_up") else None
    _w4_mma_check(dev, W4_MMA_7B[case], m, pre_norm)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 9, 64, 256])
@pytest.mark.parametrize("case", list(W4_MMA_CASES))
def test_w4_mma_route_matches_plain(dev, case, m, pre_norm):
    """The decode tile (M <= 8) and the 64-token tile (one, a partial one,
    several), one and several K-splits, the prenorm kernel's row factor in
    its epilogue, against the plain version; f32 x stays on the CUDA-core
    kernel at the f32 tolerance."""
    qt, x = _w4_mma_check(dev, W4_MMA_CASES[case], m, pre_norm)
    if m == 8:
        xf = x.float()
        dm.reset_counts()
        y = dm.fused_quantized_matmul(xf, qt, pre_norm=pre_norm)
        assert dm.LAUNCHES[dm.kernel_name(qt, pre_norm)] == 1 == sum(dm.LAUNCHES.values())
        _close(y, dm.dequant_matmul_plain(xf, qt, pre_norm), torch.float32)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m,k,n,one_split", [(256, 1024, 4096, True), (8, 1024, 256, False),
                                             (8, 4096, 32256, True), (64, 4096, 4096, False)])
def test_w4_mma_prenorm_with_one_split_and_with_a_k_split(dev, m, k, n, one_split, pre_norm):
    """The row factor where the output is formed: in the product kernel's
    epilogue with one split, in the reduce (from the splits' sums of x^2)
    with a K-split."""
    splits = dm.plan_slab_splits(m, n, k // 2, "nib4_bf16", dm._sm_count(dev))[1]
    assert (splits == 1) == one_split
    _w4_mma_check(dev, (W4_SPEC, k, n, {}), m, pre_norm)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["w4_g128_asym", "w4_perchannel_sym"])
def test_w4_mma_stacked_reads_layer_2_of_3(dev, case, m, pre_norm):
    spec, k, n, kw = W4_MMA_CASES[case]
    qts = [_artifact(dev, k, n, spec, seed=50 + i, **kw) for i in range(3)]
    st = _stacked(qts)
    assert dm.kernel_supported_stacked(st) and dm.bf16_mma_route(st, torch.bfloat16)
    x = _x(dev, (m, k), torch.bfloat16) * 3
    y = _lut_mma_call(dev, st, x, pre_norm, layer=2)
    _close_a(y, dm.dequant_matmul_plain(x, qts[2], pre_norm), torch.bfloat16)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["w4_g128_asym", "w4_kpad"])
def test_w4_mma_copies_x_it_cannot_read_in_place(dev, case, m, pre_norm):
    """x 2 bytes off a 16-byte boundary: the row pass copies it (raw: the
    prenorm kernel's epilogue still applies the row factor)."""
    spec, k, n, kw = W4_MMA_CASES[case]
    x = torch.empty((m * k + 1,), dtype=torch.bfloat16, device=dev)[1:].view(m, k)
    x.copy_(_x(dev, (m, k), torch.bfloat16) * 3)
    assert x.is_contiguous() and x.data_ptr() % 16
    _w4_mma_check(dev, W4_MMA_CASES[case], m, pre_norm, x=x)


# ------------- bf16-x W8 and lut8 calls on the bf16 tensor cores (byte layouts)

# (spec, K, N, quantize_tensor kwargs) of the bf16 routes of w8_matmul and
# w8_matmul_prenorm (the affine byte case kByteB of the bf16 family, the
# prenorm form's row factor in its epilogue) and lut8_matmul (the byte LUT
# case kLut8B): the five LLaMA-2-7B shapes (N padded to 512; qkv and
# gate_up with the pre-norm: lut8's in the row pass, w8's the prenorm
# kernel), the side layouts, and the
# ragged cases: per-channel K = 1088 (the range ends inside a window, a part
# or a K-split cuts a group), groups of 16 rows (two a window), N = 300
# stored as 512 (n_pad) and as 300 (4-byte weight copies), K padding, BFP8,
# and the other byte minifloats (fp3, fp5, fp7)
W8_SPEC = dataclasses.replace(W4_SPEC, bits=8)
FP8_SPEC = LUT_SPECS["fp8_e4m3_g128_sym"][0]
BYTE_MMA_7B = {f"{tag}_{shape}": (spec, *W4_MMA_7B[shape][1:])
               for tag, spec in (("w8", W8_SPEC), ("fp8", FP8_SPEC)) for shape in W4_MMA_7B}
BYTE_MMA_CASES = {
    "w8_g128_asym": (W8_SPEC, 1024, 256, {}),
    "w8_g128_sym": (dataclasses.replace(W8_SPEC, symmetric=True), 1024, 256, {}),
    "w8_perchannel_sym": (dataclasses.replace(SPECS["perchannel_sym"], bits=8), 1024, 256, {}),
    "w8_pertensor_asym": (dataclasses.replace(SPECS["pertensor_asym"], bits=8), 1024, 256, {}),
    "w8_perchannel_asym_k1088": (dataclasses.replace(SPECS["perchannel_sym"], bits=8,
                                                     symmetric=False), 1088, 256, {}),
    "w8_g16_asym": (dataclasses.replace(W8_SPEC, group_size=16), 1024, 256, {}),
    "w8_npad_300": (W8_SPEC, 1024, 300, dict(pad_n_to=512)),
    "w8_n300": (W8_SPEC, 1024, 300, {}),
    "w8_kpad": (W8_SPEC, 384, 256, dict(pad_k_to=512)),
    "bfp8_npad_300": (QuantSpec(fmt="bfp", bits=8, group_size=128), 1408, 300,
                      dict(pad_n_to=512)),
    **{s: (LUT_SPECS[s][0], 1024, 256, {}) for s in LUT_SPECS if s.startswith("fp8")},
    "fp8_e4m3_perchannel_asym_k1088": (LUT_SPECS["fp8_e4m3_perchannel_asym"][0], 1088, 256,
                                       {}),
    "fp8_e4m3_g16_sym": (fp_spec("fp8", 4, 3, group_size=16), 1024, 256, {}),
    "fp8_npad_300": (FP8_SPEC, 1024, 300, dict(pad_n_to=512)),
    "fp8_n300": (LUT_SPECS["fp8_e2m5_g128_asym"][0], 1024, 300, {}),
    "fp8_kpad": (FP8_SPEC, 384, 256, dict(pad_k_to=512)),
    "fp5_e2m2_g64_asym": (fp_spec("fp5", 2, 2, group_size=64, symmetric=False), 1024, 256, {}),
    "fp7_e3m3_g128_sym": (fp_spec("fp7", 3, 3, group_size=128), 1024, 256, {}),
    "fp3_e1m1_g128_sym": (fp_spec("fp3", 1, 1, group_size=128), 1024, 256, {}),
}


def _byte_mma_check(dev, case, m, pre_norm, x=None, layer=None):
    """One bf16-x call of a byte artifact on the route (``_lut_mma_call``:
    one launch of ``w8_matmul``, ``w8_matmul_prenorm`` or ``lut8_matmul``)
    against the plain version.  Returns the artifact(s) and x."""
    spec, k, n, kw = case
    qts = [_artifact(dev, k, n, spec, seed=60 + i, **kw) for i in range(3 if layer else 1)]
    qt = _stacked(qts) if layer else qts[0]
    if x is None:
        x = _x(dev, (m, k), torch.bfloat16) * 3
    name = dm.kernel_name(qt, pre_norm)
    assert dm.packed_bits(qt) == 8 and name in (dm.W8, dm.W8_PRENORM, dm.LUT8)
    y = _lut_mma_call(dev, qt, x, pre_norm, layer)
    _close_a(y, dm.dequant_matmul_plain(x, qts[-1], pre_norm), torch.bfloat16)
    return qt, x


@pytest.mark.parametrize("m", [1, 8, 64, 256])
@pytest.mark.parametrize("case", list(BYTE_MMA_7B))
def test_byte_mma_route_matches_plain_7b_shapes(dev, case, m):
    """The main paths' five shapes at decode and prefill row counts, qkv
    and gate_up with the pre-norm as the main paths call them: W8's on the
    prenorm kernel (its row factor in the epilogue), fp8's in the route's
    row pass."""
    pre_norm = EPS if case.endswith(("_qkv", "_gate_up")) else None
    _byte_mma_check(dev, BYTE_MMA_7B[case], m, pre_norm)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 9, 64, 256])
@pytest.mark.parametrize("case", list(BYTE_MMA_CASES))
def test_byte_mma_route_matches_plain(dev, case, m, pre_norm):
    """The decode tile (M <= 8) and the 64-token tile (one, a partial one,
    several), one and several K-splits, against the plain version; f32 x
    stays on the CUDA-core kernel at the f32 tolerance."""
    qt, x = _byte_mma_check(dev, BYTE_MMA_CASES[case], m, pre_norm)
    if m == 8:
        xf = x.float()
        dm.reset_counts()
        y = dm.fused_quantized_matmul(xf, qt, pre_norm=pre_norm)
        assert dm.LAUNCHES[dm.kernel_name(qt, pre_norm)] == 1 == sum(dm.LAUNCHES.values())
        _close(y, dm.dequant_matmul_plain(xf, qt, pre_norm), torch.float32)


@pytest.mark.parametrize("m,k,n,one_split", [(256, 4096, 12288, True), (8, 1024, 256, False),
                                             (8, 4096, 32256, True), (64, 4096, 4096, False)])
def test_w8_mma_prenorm_with_one_split_and_with_a_k_split(dev, m, k, n, one_split):
    """The W8 row factor where the output is formed: in the product
    kernel's epilogue with one split, in the reduce (from the splits' sums
    of x^2) with a K-split."""
    splits = dm.plan_slab_splits(m, n, k, "byte_bf16", dm._sm_count(dev))[1]
    assert (splits == 1) == one_split
    _byte_mma_check(dev, (W8_SPEC, k, n, {}), m, EPS)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["w8_g128_asym", "w8_perchannel_sym", "fp8_e4m3_g128_sym",
                                  "fp8_e4m3_perchannel_asym"])
def test_byte_mma_stacked_reads_layer_2_of_3(dev, case, m, pre_norm):
    _byte_mma_check(dev, BYTE_MMA_CASES[case], m, pre_norm, layer=2)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("case", ["w8_g128_asym", "w8_kpad", "fp8_e4m3_g128_sym", "fp8_kpad"])
def test_byte_mma_copies_x_it_cannot_read_in_place(dev, case, m, pre_norm):
    """x 2 bytes off a 16-byte boundary: the row pass copies it (and, for
    lut8 with a pre-norm, normalizes the copy)."""
    spec, k, n, kw = BYTE_MMA_CASES[case]
    x = torch.empty((m * k + 1,), dtype=torch.bfloat16, device=dev)[1:].view(m, k)
    x.copy_(_x(dev, (m, k), torch.bfloat16) * 3)
    assert x.is_contiguous() and x.data_ptr() % 16
    _byte_mma_check(dev, BYTE_MMA_CASES[case], m, pre_norm, x=x)


@pytest.mark.parametrize("bits", [3, 5, 7, 8])
def test_lut8_mma_decodes_every_byte_exactly(dev, bits):
    """Every code of every byte minifloat of ``bits`` (every E >= 1, M =
    bits - 1 - E; subnormals among them), stored as code - 128 and drawn at
    random so that each occurs, against one-hot rows of x, whose products
    are the values times the per-channel scale: the route's bf16 output is
    bit-equal to the CUDA-core kernel's f32 output (its 256-entry table)
    rounded to bf16, and to the plain version's where that version's codec
    (``code_to_float``, whose ``exp2`` is exact for |e| < 13) is exact:
    every format with E <= 4."""
    g = torch.Generator(device=dev)
    g.manual_seed(bits)
    x = torch.eye(1024, device=dev, dtype=torch.bfloat16)
    for e in range(1, bits):
        qt = _artifact(dev, 1024, 256, fp_spec(f"fp{bits}", e, bits - 1 - e,
                                               group_size=PER_CHANNEL))
        codes = torch.randint(0, 1 << bits, qt.qweight.shape, generator=g, device=dev)
        qt = qt.replace(qweight=((codes + 128) % 256).to(torch.uint8))
        y = _lut_mma_call(dev, qt, x)
        if e <= 4:
            assert torch.equal(y, dm.dequant_matmul_plain(x, qt)), (bits, e)
        assert torch.equal(y, dm.fused_quantized_matmul(x.float(), qt).to(torch.bfloat16))


def test_w8_mma_decodes_every_byte_exactly(dev):
    """Every stored byte of W8, read as int8 (-128..127), against one-hot
    rows of x with unit scales and zero zeros: the route's output is the
    code itself, exactly."""
    qt = _artifact(dev, 1024, 256, dataclasses.replace(SPECS["perchannel_sym"], bits=8))
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    qw = torch.randint(0, 256, qt.qweight.shape, generator=g, device=dev).to(torch.uint8)
    qt = qt.replace(qweight=qw, scales=torch.ones_like(qt.scales),
                    zeros=torch.zeros_like(qt.zeros))
    x = torch.eye(1024, device=dev, dtype=torch.bfloat16)
    y = _lut_mma_call(dev, qt, x)
    assert torch.equal(y, qw.view(torch.int8).to(torch.bfloat16)[:, :qt.n])


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


def _tiny_engine(dev, bits, spec=None, kv=None, scan=False, **ecfg):
    """Tiny 2-layer LLaMA, every linear ``bits``-bit g128 (or ``spec``); W3
    at hidden 1024 and FFN 2048, the least widths whose K/8 the group
    divides.  ``kv``: the KV cache (default contiguous 16-bit, 48 columns);
    ``scan``: the scan forward (the engine stacks the fused params)."""
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
    forward = llama.llama_forward_scan if scan else llama.llama_forward
    return InferenceEngine(params, cfg, forward, family="llama",
                           engine_cfg=EngineConfig(kv=kv or KVCacheConfig(max_seq_len=48),
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


def _serve_wave_and_chunk_without_sync(dev, bits, abits, kv=None, scan=False):
    from iron_weight_only_quant_tpu_torch.engine.engine import _serve_chunk, _serve_combo

    p_abits, d_abits = abits or (None, None)
    eng = _tiny_engine(dev, bits, kv=kv, scan=scan)
    c, s_len, ns = 4, 8, 4
    # under paging the page table [ns, mp] follows each meta vector
    mp = 48 // kv.page_size if kv is not None and kv.paged else 0
    table = torch.arange(1, 1 + ns * mp).reshape(ns, mp)
    table[3] = 0  # an idle slot: the garbage page
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    combo_meta = torch.cat([
        torch.randint(1, 255, (ns * s_len,)), torch.tensor([8, 3, 1, 0]),
        torch.zeros(ns, dtype=torch.long), torch.tensor([1, 1, 1, 0]),
        torch.zeros(ns, dtype=torch.long), torch.zeros(ns * c, dtype=torch.long),
        torch.zeros(ns, dtype=torch.long), table.ravel()[: ns * mp]]).to(dev)
    chunk_meta = torch.cat([torch.tensor([5, 6, 7, 8]), torch.zeros(ns * c, dtype=torch.long),
                            torch.zeros(ns, dtype=torch.long),
                            torch.tensor([12, 7, 5, 0]), table.ravel()[: ns * mp]]).to(dev)
    caches = eng._fresh_caches(ns)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            dm.reset_counts()
            out, caches = _serve_combo(eng.params, combo_meta, caches, gen, eng.forward,
                                       eng.cfg, 0.0, 0, 48, s_len, c, d_abits, p_abits, mp)
            out2, caches = _serve_chunk(eng.params, chunk_meta, caches, gen, eng.forward,
                                        eng.cfg, 0.0, 0, 48, c, d_abits, mp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (ns, 1 + c) and out2.shape == (ns, c)
    per_forward = 4 * eng.cfg.num_layers + 1
    if scan:  # every linear but the lm_head on the stacked kernels
        assert sum(dm.STACKED_LAUNCHES.values()) == (1 + 2 * c) * 4 * eng.cfg.num_layers
    if abits is not None:  # the wave on A8, the 2 * c steps on A16
        wave, step = (dm.W8A8, dm.W8A16) if bits == 8 else (dm.W3A8, dm.W3A16)
        assert dm.LAUNCHES[wave] == per_forward
        assert dm.LAUNCHES[step] == 2 * c * per_forward
    elif bits == 3:
        assert dm.LAUNCHES[dm.W3] == (1 + 2 * c) * per_forward


# ------------------------------------------------------------ scan path

@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_tiny_scan_serve_gives_the_flat_tokens(dev, bits, kv_bits):
    """The scan path (stacked params and caches) gives the flat path's
    generate and serve tokens on the card, every linear but the lm_head on
    the stacked kernels."""
    from iron_weight_only_quant_tpu_torch.config import KVCacheConfig

    kv = KVCacheConfig(max_seq_len=48, kv_bits=kv_bits)
    flat, scan = (_tiny_engine(dev, bits, kv=kv, scan=s) for s in (False, True))
    assert "layers_stacked" in scan.params
    n_layers = scan.cfg.num_layers
    names = (dm.W4, dm.W4_PRENORM) if bits == 4 else (dm.W8, dm.W8_PRENORM)
    reqs = [[(7 * i + j) % 255 + 1 for j in range(3 + 5 * i)] for i in range(6)]
    prompts = reqs[:4]
    outs = []
    for eng in (flat, scan):
        stats = {}
        dm.reset_counts()
        outs.append((eng.generate(prompts, max_new_tokens=6),
                     eng.serve(reqs, max_new_tokens=8, chunk=4, stats=stats)))
        stacked = dm.STACKED_LAUNCHES
        assert dm.LAUNCHES[names[0]] == (6 + stats["n_steps"]) * (2 * n_layers + 1)
        assert dm.LAUNCHES[names[1]] == (6 + stats["n_steps"]) * 2 * n_layers
        if eng is scan:
            assert stacked[names[0]] == stacked[names[1]] == (6 + stats["n_steps"]) * 2 * n_layers
        else:
            assert not any(stacked.values())
        assert not any(dm.PLAIN_CALLS.values())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("abits", [None, (8, 16)], ids=["bf16", "a8_wave_a16_chunk"])
def test_scan_serve_device_calls_do_not_sync(dev, abits):
    """The stacked caches' [L, B] lengths advance on the card: a wave and a
    chunk on the scan path do not sync either."""
    _serve_wave_and_chunk_without_sync(dev, 8, abits, scan=True)


def test_scan_generate_chunk_does_not_sync(dev):
    """``generate``'s stacked lengths stay on the host: its decode steps
    read no device value."""
    from iron_weight_only_quant_tpu_torch.engine.engine import _generate_chunk

    eng = _tiny_engine(dev, 4, scan=True)
    caches = eng._fresh_caches(2)
    pads = torch.zeros(2, dtype=torch.long, device=dev)
    tok = torch.tensor([[3], [5]], device=dev)
    cols = torch.arange(48, device=dev)
    gen = torch.Generator(device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            sampled, caches = _generate_chunk(eng.params, tok, pads, 0, caches, gen,
                                              eng.forward, eng.cfg, 0.0, 0, cols, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sampled.shape == (2, 4) and caches.length == (4,) * eng.cfg.num_layers


@pytest.mark.parametrize("family", ["opt", "bloom"])
def test_tiny_opt_bloom_scan_gives_the_flat_tokens(dev, family):
    """Tiny W4 OPT and BLOOM, flat and scan: equal tokens, 6 launches a
    layer and forward (q, k, v, o, fc1, fc2), all stacked on the scan
    path; the tied head is a plain matmul."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models import bloom, opt

    g = torch.Generator(device=dev).manual_seed(0)
    if family == "opt":
        cfg = opt.OPTConfig(vocab_size=256, hidden_size=256, ffn_dim=512, num_layers=2,
                            num_heads=4, max_position_embeddings=64)
        params, fwds = opt.opt_init(cfg, g, device=dev), (opt.opt_forward, opt.opt_forward_scan)
    else:
        cfg = bloom.BloomConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4)
        params = bloom.bloom_init(cfg, g, device=dev)
        fwds = (bloom.bloom_forward, bloom.bloom_forward_scan)
    params["embed"] = params["embed"].to(torch.bfloat16)
    spec = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    for lin in [v for p in params["layers"] for v in p.values() if v["w"].dim() == 2]:
        lin["w"] = quantize_tensor(lin["w"], spec, pad_n_to=512)
    reqs = [[(7 * i + j) % 255 + 1 for j in range(3 + 5 * i)] for i in range(6)]
    outs = []
    for fwd in fwds:
        eng = InferenceEngine(params, cfg, fwd, engine_cfg=EngineConfig(
            kv=KVCacheConfig(max_seq_len=48), max_batch_size=4), dtype=torch.bfloat16,
            device=dev)
        stats = {}
        dm.reset_counts()
        outs.append((eng.generate(reqs[:4], max_new_tokens=6),
                     eng.serve(reqs, max_new_tokens=8, chunk=4, stats=stats)))
        want = (6 + stats["n_steps"]) * 6 * cfg.num_layers
        assert dm.LAUNCHES[dm.W4] == sum(dm.LAUNCHES.values()) == want
        assert dm.STACKED_LAUNCHES[dm.W4] == (want if fwd is fwds[1] else 0)
        assert not any(dm.PLAIN_CALLS.values())
    assert outs[0] == outs[1]


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


# ------------------------------------------------------ quantized and paged KV

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [128, 64])
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_codec_on_the_card_is_bit_equal_to_the_cpu(dev, bits, g, dtype):
    """Codes, scales, zeros and decoded values: no reciprocal product on the
    card (the int codec divides by a tensor)."""
    from iron_weight_only_quant_tpu_torch.engine import kvcache as kvc

    gen = torch.Generator().manual_seed(bits * g)
    for s in (1, 64):
        x = (torch.randn((8, s, 32, 128), generator=gen) * 3).to(dtype)
        on_card = kvc._encode(x.to(dev), bits, g, bits == 4)
        on_cpu = kvc._encode(x, bits, g, bits == 4)
        for a, b in zip(on_card, on_cpu):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        for out in (dtype, torch.float32):
            dec = kvc._decode(*on_card, 128, out, bits == 4)
            assert torch.equal(dec.cpu(), kvc._decode(*on_cpu, 128, out, bits == 4))


KV_CASES = {
    "kv8": dict(kv_bits=8),
    "kv4": dict(kv_bits=4),
    "paged16": dict(paged=True, page_size=16),
    "paged_kv8": dict(paged=True, page_size=16, kv_bits=8),
    # the traffic's peak of 6 pages and the garbage page: 11 pages recycled
    "paged_kv4_small_pool": dict(paged=True, page_size=16, kv_bits=4, num_pages=7),
}


@pytest.mark.parametrize("case", list(KV_CASES))
def test_tiny_kv_serve_on_the_card_is_repeatable(dev, case):
    """W4 serves under each KV cache: repeatable tokens, exact launches, no
    plain call; a paged cache gives its contiguous cache's tokens."""
    from iron_weight_only_quant_tpu_torch.config import KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine.kvcache import pool_pages

    reqs = [[(7 * i + j) % 255 + 1 for j in range(3 + 5 * i)] for i in range(6)]
    kw = KV_CASES[case]
    eng = _tiny_engine(dev, 4, kv=KVCacheConfig(max_seq_len=48, **kw))
    outs, stats = [], {}
    for _ in range(2):
        dm.reset_counts()
        outs.append(eng.serve(reqs, max_new_tokens=8, chunk=4, stats=stats))
    assert outs[0] == outs[1] and [len(o) for o in outs[0]] == [8] * 6
    n_layers = eng.cfg.num_layers
    assert dm.LAUNCHES[dm.W4] == stats["n_steps"] * (2 * n_layers + 1)
    assert dm.LAUNCHES[dm.W4_PRENORM] == stats["n_steps"] * 2 * n_layers
    assert sum(dm.LAUNCHES.values()) == stats["n_steps"] * (4 * n_layers + 1)
    assert not any(dm.PLAIN_CALLS.values()) and not any(dm.ROUTE_CALLS.values())
    if kw.get("paged"):
        flat = {k: v for k, v in kw.items() if k not in ("paged", "page_size", "num_pages")}
        contiguous = _tiny_engine(dev, 4, kv=KVCacheConfig(max_seq_len=48, **flat))
        assert contiguous.serve(reqs, max_new_tokens=8, chunk=4) == outs[0]
        assert stats["pages_peak"] <= pool_pages(4, eng.engine_cfg.kv) - 1
        assert stats["n_page_allocs"] > stats["pages_peak"]  # pages were recycled


@pytest.mark.parametrize("kv", ["paged16", "paged_kv8"])
def test_paged_serve_device_calls_do_not_sync(dev, kv):
    """The page table rides in the meta vector: no host sync is added."""
    from iron_weight_only_quant_tpu_torch.config import KVCacheConfig

    _serve_wave_and_chunk_without_sync(dev, 4, None,
                                       kv=KVCacheConfig(max_seq_len=48, **KV_CASES[kv]))


def test_artifact_round_trip_onto_the_card(dev, tmp_path):
    """A W4 tree quantized on the card, saved and loaded back onto the card:
    every tensor bit-equal, and ``generate`` gives the same tokens."""
    from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
    from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
    from iron_weight_only_quant_tpu_torch.models import llama
    from iron_weight_only_quant_tpu_torch.quantize.artifact import load_artifact, save_artifact
    from iron_weight_only_quant_tpu_torch.quantize.model_pass import quantize_model_params

    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    dense = llama.llama_init(cfg, gen, device=dev)
    dense["embed"] = dense["embed"].to(torch.bfloat16)
    params, report = quantize_model_params(
        dense, QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False), device=dev)
    assert report["n_quantized"] == 14 and report["n_skipped"] == 1
    save_artifact(str(tmp_path), "llama", cfg, params)
    family, cfg2, loaded = load_artifact(str(tmp_path), device=dev)
    assert family == "llama" and cfg2 == cfg

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        if dataclasses.is_dataclass(t):
            return [t.spec, t.shape, t.mode] + [getattr(t, f) for f in
                                                ("qweight", "scales", "zeros", "codebook")]
        return [t]

    for a, b in zip(leaves(loaded), leaves(params), strict=True):
        if torch.is_tensor(b):
            assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    prompts = [[5, 6, 7, 8], [1, 2]]
    toks = [InferenceEngine(p, cfg, llama.llama_forward, family="llama",
                            engine_cfg=EngineConfig(kv=KVCacheConfig(max_seq_len=32)),
                            dtype=torch.bfloat16, device=dev).generate(prompts, max_new_tokens=6)
            for p in (params, loaded)]
    assert toks[0] == toks[1]


def _gptq_problem(dev, rows, cols, seed):
    """(w [rows, cols], H from 2 * cols tokens of correlated inputs), on ``dev``."""
    from iron_weight_only_quant_tpu_torch.quantize.gptq import hessian_update

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((rows, cols), generator=g, device=dev) * cols**-0.5
    mix = torch.randn((cols, cols), generator=g, device=dev) * 0.3 + torch.eye(cols, device=dev)
    h, n = torch.zeros((cols, cols), device=dev), torch.zeros((), device=dev)
    for _ in range(4):
        x = torch.randn((cols // 2, cols), generator=g, device=dev) @ mix
        h, n = hessian_update(h, n, x)
    return w, h


@pytest.mark.parametrize("bits,sym,groupsize", [(4, False, 128), (3, True, -1), (8, False, 128)],
                         ids=["w4_g128", "w3_perchannel_sym", "w8_g128"])
def test_gptq_solver_on_the_card_matches_the_cpu(dev, bits, sym, groupsize):
    """The same H and weights solved on the card and on the CPU: at least
    99.5% of q equal (rtol 1e-5, atol 1e-7), all within 0.3 max|w|
    (tests/test_gptq.py's criterion); TF32 left on by the caller changes
    nothing (the solver turns it off); the 8-bit artifact decodes to q."""
    from iron_weight_only_quant_tpu_torch.ops.qmatmul import dequantize_weight
    from iron_weight_only_quant_tpu_torch.quantize.gptq import gptq_quantize
    from iron_weight_only_quant_tpu_torch.quantize.gptq_model import gptq_result_to_qtensor

    w, h = _gptq_problem(dev, 512, 1024, 7)
    kw = dict(bits=bits, sym=sym, groupsize=groupsize, blocksize=128)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res = gptq_quantize(w, h, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ref = gptq_quantize(w.cpu(), h.cpu(), **kw)
    q, q_ref = res.q.cpu(), ref.q
    exact = torch.isclose(q, q_ref, rtol=1e-5, atol=1e-7).float().mean().item()
    assert exact > 0.995, exact
    assert (q - q_ref).abs().max().item() <= 0.3 * w.abs().max().item()
    spec = QuantSpec(fmt="int", bits=bits, group_size=groupsize if groupsize > 0 else PER_CHANNEL,
                     symmetric=sym)
    qt = gptq_result_to_qtensor(res, spec, w.shape[1], w.shape[0])
    assert torch.equal(dequantize_weight(qt).t(), res.q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
@pytest.mark.parametrize("m", [1, 8, 512])
def test_unpadded_gptq_width_through_rows_1_and_2(dev, m, pre_norm, dtype):
    """GPTQ artifacts carry no ``pad_n_to``: gate and up (N = 11008) take
    the W4 kernels unpadded during calibration (f32 x, M = 512 tokens a
    sample) and in a bf16 forward."""
    qt = _artifact(dev, 4096, 11008, SPECS["g128_asym"], seed=8)
    assert qt.n_pad == 0 and dm.kernel_supported(qt)
    name = dm.kernel_name(qt, pre_norm)
    assert name == (dm.W4 if pre_norm is None else dm.W4_PRENORM)
    x = _x(dev, (m, 4096), dtype) * 3
    dm.reset_counts()
    y = dm.fused_quantized_matmul(x, qt, pre_norm=pre_norm)
    assert dm.LAUNCHES[name] == 1 and sum(dm.LAUNCHES.values()) == 1
    _close(y, dm.dequant_matmul_plain(x, qt, pre_norm), dtype)
