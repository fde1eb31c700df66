"""Port parity: int8 / A16 activations against the JAX package.

The port's plain versions of its four int-activation kernels (W4A8, W8A8,
W4A16, W8A16) are what a CPU tensor runs.  Here, on the same numpy inputs:

* ``quantize_activations`` gives exactly the int8 planes and f32 row scales
  of the JAX ``_prep_x`` (A8 and A16, f32 and bf16 x, an all-zero row, codes
  on exact ``.5`` boundaries, a ``k_pad`` artifact);
* the plain versions match the JAX Pallas kernels run in interpret mode at
  the Pallas tests' tolerance (rtol 2e-5, atol 2e-4, f32): the integer sums
  are exact, only the order of the f32 epilogue differs; and they stay as
  close to full precision as the JAX tests ask (A16 2e-4, A8 1e-2 relative
  norm);
* under activation bits a ``pre_norm`` normalizes x before quantizing, as
  ``fused_quantized_matmul`` of the JAX package does.
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
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.ops.qmatmul import dequantize_weight as j_dequantize
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

TOL = dict(rtol=2e-5, atol=2e-4)
REL_NORM = {8: 1e-2, 16: 2e-4}  # against full precision (tests/test_pallas_kernel.py)
EPS = 1e-5
SPECS = {
    "w4_g128_asym": dict(fmt="int", bits=4, group_size=128, symmetric=False),
    "w4_g64_sym": dict(fmt="int", bits=4, group_size=64, symmetric=True),
    "w8_g128_asym": dict(fmt="int", bits=8, group_size=128, symmetric=False),
    "w8_perchannel_sym": dict(fmt="int", bits=8, group_size=PER_CHANNEL, symmetric=True),
}
KERNEL = {(4, 8): dm.W4A8, (4, 16): dm.W4A16, (8, 8): dm.W8A8, (8, 16): dm.W8A16}


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _artifact(spec, k=512, n=256, seed=0, **kw):
    """The same artifact in both packages (quantized once, by JAX)."""
    jq = j_quantize(jnp.asarray(_x((k, n), seed=seed, scale=0.05)), JSpec(**spec), **kw)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _jax_codes(x, bits, k_pad=0):
    """(planes [P, M, K_stored] int8, sx [M]) from the JAX ``_prep_x``."""
    x2, m, _, _, _, sx = j_dm._prep_x(x, x.shape[-1], bits)
    if k_pad:
        x2 = j_dm._pad_x_k(x2, k_pad)
    planes = x2 if isinstance(x2, tuple) else (x2,)
    return np.stack([np.asarray(p)[:m] for p in planes]), np.asarray(sx)[:, 0]


def _port_codes(x, bits, k_pad=0):
    planes, sx = dm.quantize_activations(x, bits)
    if k_pad:
        planes = torch.nn.functional.pad(planes, (0, k_pad))
    return planes.numpy(), sx.numpy()


def _assert_same_codes(xj, xt, bits, k_pad=0):
    pj, sj = _jax_codes(xj, bits, k_pad)
    pt, st = _port_codes(xt, bits, k_pad)
    assert pt.dtype == np.int8 and st.dtype == np.float32
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(st.view(np.uint32), sj.view(np.uint32))
    return pt, st


# ------------------------------------------------------ activation codes

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 16])
def test_codes_match_prep_x(bits, dtype):
    x = _x((40, 512), seed=3, scale=2.0)
    x[5] = 0.0  # the 1e-8 clip of an all-zero row
    x[7, :17] *= 1e4  # one large outlier row
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    planes, sx = _assert_same_codes(xj, xt, bits)
    assert planes.shape == (1 if bits == 8 else 2, 40, 512)
    assert not planes[:, 5].any() and sx[5] == np.float32(1e-8) / np.float32(
        127.0 if bits == 8 else 32512.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 16])
def test_codes_on_half_boundaries_round_to_even(bits, dtype):
    top = 127.0 if bits == 8 else 32512.0  # row max -> sx == 1 exactly
    row = np.array([top, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5, 4.0],
                   np.float32)
    x = np.tile(row, (3, 1))
    x[1] *= -1
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    planes, sx = _assert_same_codes(xj, xt, bits)
    np.testing.assert_array_equal(sx, np.ones(3, np.float32))
    q = planes[0].astype(np.int32) if bits == 8 else \
        256 * planes[0].astype(np.int32) + planes[1]
    np.testing.assert_array_equal(q[0], np.round(row).astype(np.int32))
    np.testing.assert_array_equal(q[0, 1:8], [0, 2, 2, 0, -2, -2, 126])


@pytest.mark.parametrize("bits", [8, 16])
def test_codes_pad_k_after_quantizing(bits):
    _, tq = _artifact(SPECS["w4_g128_asym"], k=384, seed=4, pad_k_to=512)
    assert tq.k_pad == 128
    x = _x((6, 384), seed=5)
    planes, _ = _assert_same_codes(jnp.asarray(x), torch.from_numpy(x), bits,
                                   k_pad=tq.k_pad)
    assert planes.shape[-1] == 512 and not planes[..., 384:].any()


# ------------------------------------------------- plain versions vs Pallas

def _both(x, jq, tq, bits, pre_norm=None):
    name = KERNEL[(tq.spec.storage_bits, bits)]
    assert dm.kernel_supported(tq, bits) and dm.kernel_name(tq, pre_norm, bits) == name
    want = np.asarray(j_dm.fused_quantized_matmul(
        jnp.asarray(x), jq, interpret=True, activation_bits=bits, pre_norm=pre_norm))
    dm.reset_counts()
    got = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq, pre_norm=pre_norm,
                                     activation_bits=bits)
    assert dm.PLAIN_CALLS[name] == 1 and sum(dm.PLAIN_CALLS.values()) == 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


def _rel_norm(y, ref):
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("m", [1, 4, 40])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("spec", list(SPECS))
def test_plain_matches_pallas(spec, bits, m):
    jq, tq = _artifact(SPECS[spec])
    x = _x((m, 512), seed=10 + m)
    got, want = _both(x, jq, tq, bits)
    np.testing.assert_allclose(got, want, **TOL)
    full = x @ np.asarray(j_dequantize(jq))
    assert _rel_norm(got, full) < REL_NORM[bits]


@pytest.mark.parametrize("bits", [8, 16])
def test_plain_matches_pallas_k_pad_and_n_pad(bits):
    jq, tq = _artifact(SPECS["w4_g128_asym"], k=384, n=200, seed=6,
                       pad_k_to=512, pad_n_to=128)
    assert tq.k_pad == 128 and tq.n_pad == 56
    got, want = _both(_x((2, 3, 384), seed=7), jq, tq, bits)
    assert got.shape == (2, 3, 200)
    np.testing.assert_allclose(got, want, **TOL)


@functools.lru_cache(maxsize=None)
def _stacked(bits):
    """Two layers stacked by the JAX package, side info padded 4 -> 8 rows."""
    qts = [j_quantize(jnp.asarray(_x((512, 256), seed=20 + i, scale=0.05)),
                      JSpec(**dict(SPECS["w4_g128_asym"], bits=bits)))
           for i in range(2)]
    params = {"layers": [{"lin": {"w": q, "b": None}} for q in qts]}
    jst = stack_model_layers(params)["layers_stacked"]["lin"]["w"]
    assert jst.side_pad == 4
    return jst, params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")


@pytest.mark.parametrize("abits", [8, 16])
@pytest.mark.parametrize("wbits", [4, 8])
def test_stacked_plain_matches_pallas_at_layer_1(wbits, abits):
    jst, tst = _stacked(wbits)
    assert dm.kernel_supported_stacked(tst, abits)
    x = _x((8, 512), seed=30)
    want = np.asarray(j_dm.fused_quantized_matmul_stacked(
        jnp.asarray(x), jst, 1, interpret=True, activation_bits=abits))
    dm.reset_counts()
    got = t_qmatmul.quantized_matmul_stacked(torch.from_numpy(x), tst, 1,
                                             activation_bits=abits)
    assert dm.PLAIN_CALLS[KERNEL[(wbits, abits)]] == 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ambient_bits_and_explicit_bits_agree():
    _, tq = _artifact(SPECS["w8_g128_asym"], seed=8)
    x = torch.from_numpy(_x((4, 512), seed=9))
    with t_qmatmul.activation_quant(16):
        ambient = t_qmatmul.quantized_matmul(x, tq)
        with t_qmatmul.activation_quant(None):
            plain = t_qmatmul.quantized_matmul(x, tq)
    assert t_qmatmul._DEFAULT_ACTIVATION_BITS is None
    torch.testing.assert_close(ambient, t_qmatmul.quantized_matmul(x, tq, activation_bits=16),
                               rtol=0, atol=0)
    torch.testing.assert_close(plain, t_qmatmul.quantized_matmul(x, tq), rtol=0, atol=0)
    assert not torch.equal(ambient, plain)


# ------------------------------------------------------------ pre-norm rule

@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("wbits", [4, 8])
def test_pre_norm_normalizes_before_quantizing(wbits, bits):
    """The normalized activations are NOT bit-equal on the CPU: JAX's mean
    and ``lax.rsqrt`` and torch's mean and ``torch.rsqrt`` each differ in the
    last f32 bit on some rows.  So the rest of the path is held at the strict
    tolerance on the JAX-normalized x, and the whole path, whose activation
    codes may round the other way where x differs by an ulp, at the A8
    relative-norm tolerance."""
    jq, tq = _artifact(SPECS["w4_g128_asym" if wbits == 4 else "w8_g128_asym"], seed=11)
    x = _x((40, 512), seed=12, scale=3.0)
    xn_j = np.array(j_dm._rms_nogamma(jnp.asarray(x), EPS))
    xn_t = t_qmatmul._rms_nogamma(torch.from_numpy(x), EPS).numpy()
    assert np.abs(xn_t - xn_j).max() <= 2 * np.spacing(np.abs(xn_j).max())
    assert not np.array_equal(xn_t, xn_j), "bit-equal now: tighten the tolerance below"
    got, want = _both(x, jq, tq, bits, pre_norm=EPS)
    assert dm.PLAIN_CALLS[KERNEL[(wbits, bits)]] == 1  # no prenorm kernel under abits
    assert _rel_norm(got, want) < REL_NORM[8]
    on_jax_norm = t_qmatmul.quantized_matmul(torch.from_numpy(xn_j), tq, activation_bits=bits)
    np.testing.assert_allclose(on_jax_norm.numpy(), want, **TOL)


def test_lut_and_odd_bits_are_refused():
    """A8 on a LUT artifact raises, as in the JAX package; A16 exists for
    fp4 (E2M1, E1M2) but not for fp8 (its values span no 16-bit grid)."""
    from iron_weight_only_quant_tpu.config import fp_spec

    _, tq = _artifact(SPECS["w4_g128_asym"], seed=13)
    _, lut = _artifact(vars(fp_spec("fp4", 2, 1, group_size=128)), seed=13)
    _, lut8 = _artifact(vars(fp_spec("fp8", 4, 3, group_size=128)), seed=13)
    x = torch.zeros((2, 512))
    with pytest.raises(NotImplementedError, match="LUT"):
        t_qmatmul.quantized_matmul(x, lut, activation_bits=8)
    with pytest.raises(NotImplementedError, match="8 or 16"):
        t_qmatmul.quantized_matmul(x, tq, activation_bits=4)
    assert dm.a16_supported(tq) and dm.a16_supported(lut) and not dm.a16_supported(lut8)
