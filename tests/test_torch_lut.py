"""Port parity: the LUT (minifloat) dequant-matmuls and the XLA route
against the JAX package.

The port's plain versions of its LUT kernels are what a CPU tensor runs.
Here, on the same numpy inputs (artifacts quantized once, by JAX):

* ``lut_matmul_plain`` (``lut4_matmul``, ``lut8_matmul``) matches the JAX
  Pallas kernels ``_lut4_kernel`` and ``_lut8_kernel`` run in interpret
  mode at the Pallas tests' tolerance (rtol 2e-5, atol 2e-4, f32), flat and
  layer-stacked, with and without zero points;
* ``lut_int_matmul_plain`` (``lut4a16_matmul``) matches ``_lut4_kernel_a16``
  at ``rel < 2e-4`` (the tolerance of ``tests/test_pallas_kernel.py``'s A16
  test), flat and stacked;
* the dispatch rules are the JAX package's: A8 on a LUT artifact raises,
  A16 on fp8 warns and runs at full precision, ``a16_supported`` agrees,
  fp6 in the nq42 layout takes ``lut6_matmul`` (``lut6a16_matmul`` for
  E2M3 under A16);
* JAX LUT and BFP artifacts (codebook, ``zeros=None``, nq42 or byte
  storage) carry across through ``interop.params_from_numpy`` and compute
  the same;
* every artifact class the JAX package computes on its XLA path takes the
  port's route and gives the JAX ``quantized_matmul`` result on the CPU
  (``pre_norm`` first, activation bits ignored, bias in f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import PER_CHANNEL
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
LUT_SPECS = {  # (spec, the kernel a CUDA tensor launches)
    "fp4_e2m1_g128_asym": (fp_spec("fp4", 2, 1, group_size=128, symmetric=False), dm.LUT4),
    "fp4_e2m1_g128_sym": (fp_spec("fp4", 2, 1, group_size=128), dm.LUT4),
    "fp4_e1m2_g64_sym": (fp_spec("fp4", 1, 2, group_size=64), dm.LUT4),
    "fp8_e4m3_g128_sym": (fp_spec("fp8", 4, 3, group_size=128), dm.LUT8),
    "fp8_e4m3_perchannel_asym": (fp_spec("fp8", 4, 3, group_size=PER_CHANNEL,
                                         symmetric=False), dm.LUT8),
    "fp8_e3m4_g128_sym": (fp_spec("fp8", 3, 4, group_size=128), dm.LUT8),
    "fp8_e2m5_g64_asym": (fp_spec("fp8", 2, 5, group_size=64, symmetric=False), dm.LUT8),
}


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _artifact(spec, k=512, n=256, seed=0, **kw):
    """The same artifact in both packages (quantized once, by JAX)."""
    jq = j_quantize(jnp.asarray(_x((k, n), seed=seed, scale=0.05)), spec, **kw)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ------------------------------------------------------------ plain vs Pallas

@pytest.mark.parametrize("spec", list(LUT_SPECS), ids=list(LUT_SPECS))
def test_plain_lut_matches_pallas(spec):
    """M=16 (M=1 for one spec: the row tile's padding)."""
    spec, name = LUT_SPECS[spec]
    jq, tq = _artifact(spec, seed=3)
    assert tq.mode == "lut" and (tq.zeros is None) == spec.symmetric
    assert j_dm.kernel_supported(jq) and dm.kernel_supported(tq)
    assert dm.kernel_name(tq) == dm.kernel_name(tq, EPS) == name
    m = 1 if spec.float_format.exp_bits == 1 else 16
    x = _x((m, 512), seed=4)
    want = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x), jq, interpret=True))
    dm.reset_counts()
    got = dm.fused_quantized_matmul(torch.from_numpy(x), tq)
    assert dm.PLAIN_CALLS[name] == 1 == sum(dm.PLAIN_CALLS.values())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_lut_decodes_the_format_not_the_codebook():
    """The kernels decode by bit assembly from the format: a codebook that
    disagrees with the format cannot change what they compute."""
    jq, tq = _artifact(LUT_SPECS["fp4_e2m1_g128_asym"][0], seed=5)
    x = torch.from_numpy(_x((3, 512), seed=6))
    want = dm.fused_quantized_matmul(x, tq)
    np.testing.assert_allclose(want.numpy(), (x @ t_qmatmul.dequantize_weight(tq)).numpy(),
                               **TOL)
    bad = tq.replace(codebook=torch.zeros_like(tq.codebook))
    torch.testing.assert_close(dm.fused_quantized_matmul(x, bad), want, rtol=0, atol=0)


@pytest.mark.parametrize("spec", ["fp4_e2m1_g128_asym", "fp8_e4m3_g128_sym"])
def test_plain_lut_matches_pallas_stacked(spec):
    spec, name = LUT_SPECS[spec]
    pairs = [_artifact(spec, seed=10 + i) for i in range(2)]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    tst = params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    assert dm.kernel_supported_stacked(tst) and dm.kernel_name(tst) == name
    x = _x((8, 512), seed=7)
    want = np.asarray(j_dm.fused_quantized_matmul_stacked(jnp.asarray(x), jst, 1,
                                                          interpret=True))
    got = dm.fused_quantized_matmul_stacked(torch.from_numpy(x), tst, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("spec", ["fp4_e2m1_g128_asym", "fp4_e1m2_g64_sym"])
def test_plain_lut_a16_matches_pallas(spec):
    """Flat (M=4) and stacked (layer 1) A16 against ``_lut4_kernel_a16``;
    the integer sums are exact, only the f32 epilogue's order differs."""
    spec, _ = LUT_SPECS[spec]
    pairs = [_artifact(spec, seed=20 + i) for i in range(2)]
    (jq, tq) = pairs[0]
    assert j_dm.a16_supported(jq) and dm.a16_supported(tq)
    assert dm.kernel_supported(tq, 16) and dm.kernel_name(tq, EPS, 16) == dm.LUT4A16
    x = _x((4, 512), seed=8, scale=2.0)
    want = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x), jq, interpret=True,
                                                  activation_bits=16))
    dm.reset_counts()
    got = dm.fused_quantized_matmul(torch.from_numpy(x), tq, activation_bits=16).numpy()
    assert dm.PLAIN_CALLS[dm.LUT4A16] == 1 == sum(dm.PLAIN_CALLS.values())
    assert _rel(got, want) < 2e-4
    full = (torch.from_numpy(x) @ t_qmatmul.dequantize_weight(tq)).numpy()
    assert _rel(got, full) < 2e-4  # as close to full precision as the JAX test asks
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    tst = params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    want1 = np.asarray(j_dm.fused_quantized_matmul_stacked(
        jnp.asarray(x), jst, 1, interpret=True, activation_bits=16))
    got1 = dm.fused_quantized_matmul_stacked(torch.from_numpy(x), tst, 1,
                                             activation_bits=16).numpy()
    assert _rel(got1, want1) < 2e-4


def test_a16_int_grid_is_exact():
    """``value * 2**t`` is the integer grid of the A16 decode, for every
    code of the formats that take it, and fits int8."""
    from iron_weight_only_quant_tpu_torch.config import FloatFormat
    from iron_weight_only_quant_tpu_torch.formats.minifloat import code_to_float

    for em, mult in (((2, 1), 0.5), ((1, 2), 0.5), ((2, 3), 0.125)):
        fmt = FloatFormat(*em)
        assert dm._lut_a16_mult(fmt) == mult == j_dm._lut_a16_mult(fmt)
        codes = torch.arange(1 << fmt.total_bits, dtype=torch.int32)
        ivals = dm._minifloat_int(codes, fmt)
        assert ivals.abs().max() <= 127
        torch.testing.assert_close(ivals.float() * mult, code_to_float(codes, fmt).abs()
                                   * torch.where(codes >> (fmt.total_bits - 1) == 1, -1.0, 1.0),
                                   rtol=0, atol=0)
        want = np.asarray(j_dm._minifloat_decode_int(jnp.asarray(codes.numpy()), *em))
        np.testing.assert_array_equal(ivals.numpy(), want.astype(np.int32))
    for em in ((3, 2), (4, 3), (3, 4), (2, 5)):
        assert dm._lut_a16_mult(FloatFormat(*em)) is None


@pytest.mark.parametrize("spec", [fp_spec("fp4", 2, 1, group_size=128),
                                  fp_spec("fp6", 3, 2, group_size=128, symmetric=False),
                                  fp_spec("fp6", 2, 3, group_size=PER_CHANNEL),
                                  fp_spec("fp8", 4, 3, group_size=128, symmetric=False),
                                  JSpec(fmt="bfp", bits=4, group_size=128)],
                         ids=["fp4_sym_nozeros", "fp6_nq42", "fp6_e2m3_nq42_a16",
                              "fp8_byte", "bfp4"])
def test_jax_artifacts_carry_across(spec):
    """``interop.params_from_numpy`` carries a JAX artifact (codebook,
    ``zeros=None``, nq42 or byte storage, BFP) across: the same dequantized
    weight bit for bit, the same product as the JAX ``quantized_matmul``,
    and where the format has the A16 grid the same A16 product as the JAX
    Pallas kernel (``_lut4_kernel_a16``, ``_lut6_kernel_a16``) in interpret
    mode."""
    jq, tq = _artifact(spec, seed=40)
    assert (tq.codebook is None) == (jq.codebook is None)
    assert (tq.zeros is None) == (jq.zeros is None) and tq.mode == jq.mode
    assert dm.packed_bits(tq) == j_qmatmul.packed_bits(jq)
    np.testing.assert_array_equal(t_qmatmul.dequantize_weight(tq).numpy(),
                                  np.asarray(j_qmatmul.dequantize_weight(jq)))
    x = _x((6, 512), seed=41)
    want = np.asarray(j_qmatmul.quantized_matmul(jnp.asarray(x), jq))
    got = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if spec.fmt == "fp" and dm.a16_supported(tq):
        want16 = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x), jq, interpret=True,
                                                        activation_bits=16))
        got16 = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq, activation_bits=16)
        assert _rel(got16.numpy(), want16) < 2e-4


# ------------------------------------------------------------ dispatch rules

def test_dispatch_rules_match_jax():
    """A8 on LUT raises; A16 on fp8 warns and runs the full-precision kernel
    (and its plain version); ``a16_supported`` and kernel support agree with
    the JAX package's for every format the port packs."""
    x = torch.from_numpy(_x((2, 512), seed=9))
    for key, (spec, name) in LUT_SPECS.items():
        jq, tq = _artifact(spec, seed=1)
        assert dm.a16_supported(tq) == j_dm.a16_supported(jq), key
        assert not dm.xla_route(tq) and dm.kernel_supported(tq), key
        with pytest.raises(NotImplementedError, match="LUT"):
            t_qmatmul.quantized_matmul(x, tq, activation_bits=8)
        if not dm.a16_supported(tq):
            dm.reset_counts()
            with pytest.warns(UserWarning, match="full-precision"):
                y = t_qmatmul.quantized_matmul(x, tq, activation_bits=16)
            assert dm.kernel_name(tq, None, 16) == name and dm.PLAIN_CALLS[name] == 1
            torch.testing.assert_close(y, t_qmatmul.quantized_matmul(x, tq), rtol=0, atol=0)
    # fp6 (nq42): E2M3 has the A16 grid and takes lut6a16, E3M2 runs lut6
    for em, a16 in (((2, 3), True), ((3, 2), False)):
        jq, tq = _artifact(fp_spec("fp6", *em, group_size=128), seed=2)
        assert dm.packed_bits(tq) == 6 and dm.a16_supported(tq) == a16 == j_dm.a16_supported(jq)
        assert j_dm.kernel_supported(jq) and not dm.xla_route(tq)
        assert dm.kernel_name(tq) == dm.LUT6 and dm.kernel_supported(tq)
        assert dm.kernel_name(tq, EPS, 16) == (dm.LUT6A16 if a16 else dm.LUT6)
    # BFP artifacts are affine and take the int kernels, as in JAX
    jq, tq = _artifact(JSpec(fmt="bfp", bits=4, group_size=128), seed=3)
    assert j_dm.kernel_supported(jq) and dm.kernel_name(tq, EPS, 16) == dm.W4A16
    assert dm.kernel_name(tq, EPS) == dm.W4_PRENORM


# -------------------------------------------------------------- the route

ROUTE_CASES = {  # id: (JAX spec, quantize_tensor kwargs, K)
    "int2": (JSpec(fmt="int", bits=2, group_size=128, symmetric=False), {}, 512),
    "int3_k1088_g64": (JSpec(fmt="int", bits=3, group_size=64, symmetric=False), {}, 1088),
    "int4_side_bf16": (JSpec(fmt="int", bits=4, group_size=128, symmetric=False),
                       dict(side_dtype=jnp.bfloat16), 512),
    "int4_k_shards_2": (JSpec(fmt="int", bits=4, group_size=64, symmetric=False),
                        dict(k_shards=2), 512),
    "fp4_approx": (fp_spec("fp4", 2, 1, group_size=128, approximate=True), {}, 512),
    "fp8_approx": (fp_spec("fp8", 4, 3, group_size=128, approximate=True), {}, 512),
    "fp8_side_f16_asym": (fp_spec("fp8", 4, 3, group_size=128, symmetric=False),
                          dict(side_dtype=jnp.float16), 512),
    "bfp4_k_shards_2": (JSpec(fmt="bfp", bits=4, group_size=64), dict(k_shards=2), 512),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES), ids=list(ROUTE_CASES))
def test_route_matches_jax_quantized_matmul(case):
    """With ``pre_norm``, a bias and activation bits (which the route
    ignores), flat and layer-stacked, against the JAX ``quantized_matmul``
    on the CPU backend (its XLA path)."""
    spec, kw, k = ROUTE_CASES[case]
    pairs = [_artifact(spec, k=k, seed=30 + i, **kw) for i in range(2)]
    jq, tq = pairs[0]
    assert not j_dm.kernel_supported(jq) and dm.xla_route(tq)
    assert not dm.kernel_supported(tq) and dm.kernel_name(tq) is None
    x = _x((5, k), seed=11, scale=2.0)
    bias = _x((256,), seed=12)
    want = np.asarray(j_qmatmul.quantized_matmul(jnp.asarray(x), jq, jnp.asarray(bias),
                                                 pre_norm=EPS, activation_bits=8))
    dm.reset_counts()
    got = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq, torch.from_numpy(bias),
                                     pre_norm=EPS, activation_bits=8)
    assert dm.ROUTE_CALLS == {dm.ROUTE: 1} and not any(dm.PLAIN_CALLS.values())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    tst = params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    want1 = np.asarray(j_qmatmul.quantized_matmul_stacked(jnp.asarray(x), jst, 1,
                                                          activation_bits=16))
    got1 = t_qmatmul.quantized_matmul_stacked(torch.from_numpy(x), tst, 1,
                                              activation_bits=16)
    assert dm.ROUTE_CALLS == {dm.ROUTE: 2}
    np.testing.assert_allclose(got1.numpy(), want1, **TOL)
    # the kernel entry points take the route too, in x's dtype
    xb = torch.from_numpy(x).to(torch.bfloat16)
    torch.testing.assert_close(dm.fused_quantized_matmul(xb, tq, activation_bits=16),
                               t_qmatmul.quantized_matmul(xb, tq), rtol=0, atol=0)
