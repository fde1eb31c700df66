"""Port parity: the 3-bit (s21) dequant-matmuls against the JAX package.

The port's plain versions of its W3 kernels (``w3_matmul``, and
``w3a8_matmul`` / ``w3a16_matmul`` under activation bits) are what a CPU
tensor runs.  Here, on the same numpy inputs, quantized once by the JAX
package:

* the plain W3 version matches the JAX s21 Pallas kernel (``_int3_kernel``)
  run in interpret mode at the Pallas tests' tolerance (rtol 2e-5, atol
  2e-4, f32): the four side layouts of ``tests/test_pallas_kernel.py``'s
  ``SPECS3`` at K=1024, N padding, K padding, a 3-D x and a stacked layer;
* the A8 and A16 plain versions match ``_int3_kernel`` with int8 x and
  ``_int3_kernel_a16`` in interpret mode at the same tolerance (the integer
  sums are exact, only the order of the f32 epilogue differs);
* a ``pre_norm`` on a 3-bit artifact normalizes x first, as the JAX package
  does for a layout without a prenorm kernel; the nib4 and byte layouts
  keep their kernels' epilogue order;
* ``kernel_supported`` takes every 3-bit artifact the JAX kernel takes and
  refuses a group that straddles two K/8 slabs, as JAX does.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import PER_CHANNEL, PER_TENSOR
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.ops.qmatmul import dequantize_weight as j_dequantize
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
W3 = dict(fmt="int", bits=3, group_size=128, symmetric=False)
SPECS3 = {  # tests/test_pallas_kernel.py TestInt3Kernel.SPECS3
    "g128_asym": W3,
    "g128_sym": dict(W3, symmetric=True),
    "perchannel_asym": dict(W3, group_size=PER_CHANNEL),
    "pertensor_sym": dict(W3, group_size=PER_TENSOR, symmetric=True),
}
A_KERNEL = {None: dm.W3, 8: dm.W3A8, 16: dm.W3A16}


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _artifact(k=1024, n=256, spec="g128_asym", seed=0, **kw):
    """The same artifact in both packages (quantized once, by JAX)."""
    jq = j_quantize(jnp.asarray(_x((k, n), seed=seed, scale=0.05)), JSpec(**SPECS3[spec]),
                    **kw)
    assert jq.spec.storage_bits == 3
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _both(x, jq, tq, abits=None, pre_norm=None):
    """(port plain, JAX interpret-mode Pallas) for the same x; the port's call
    must be one plain call under the W3 kernel of ``abits``."""
    name = A_KERNEL[abits]
    assert dm.kernel_supported(tq, abits) and dm.kernel_name(tq, pre_norm, abits) == name
    assert j_dm.kernel_supported(jq)
    want = np.asarray(j_dm.fused_quantized_matmul(
        jnp.asarray(x), jq, interpret=True, activation_bits=abits, pre_norm=pre_norm))
    dm.reset_counts()
    got = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq, pre_norm=pre_norm,
                                     activation_bits=abits)
    assert dm.PLAIN_CALLS[name] == 1 and sum(dm.PLAIN_CALLS.values()) == 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


# ------------------------------------------------- plain versions vs Pallas

@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("spec", list(SPECS3))
def test_plain_matches_pallas(spec, m):
    jq, tq = _artifact(spec=spec)
    got, want = _both(_x((m, 1024), seed=8 + m), jq, tq)
    assert got.shape == (m, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_matches_pallas_k_pad():
    jq, tq = _artifact(k=896, seed=2, pad_k_to=1024)
    assert tq.k_pad == 128 and tq.qweight.shape == (384, 256)
    got, want = _both(_x((8, 896), seed=3), jq, tq)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_matches_pallas_n_pad_and_3d_x():
    jq, tq = _artifact(n=200, seed=4, pad_n_to=128)
    assert tq.n_pad == 56
    got, want = _both(_x((2, 3, 1024), seed=5), jq, tq)
    assert got.shape == (2, 3, 200)
    np.testing.assert_allclose(got, want, **TOL)


@functools.lru_cache(maxsize=None)
def _stacked():
    """Three K=2048 layers stacked (the JAX stacked int3 plan needs an even
    number of K tiles, which K=2048 gives)."""
    qts = [_artifact(k=2048, seed=20 + i)[0] for i in range(3)]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *qts)
    assert j_dm.kernel_supported_stacked(jst)
    return jst, params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")


@pytest.mark.parametrize("abits", [None, 8, 16])
def test_stacked_plain_matches_pallas_at_layer_1(abits):
    jst, tst = _stacked()
    assert dm.kernel_supported_stacked(tst, abits)
    x = _x((4, 2048), seed=30)
    want = np.asarray(j_dm.fused_quantized_matmul_stacked(
        jnp.asarray(x), jst, 1, interpret=True, activation_bits=abits))
    dm.reset_counts()
    got = t_qmatmul.quantized_matmul_stacked(torch.from_numpy(x), tst, 1,
                                             activation_bits=abits)
    assert dm.PLAIN_CALLS[A_KERNEL[abits]] == 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("abits,spec", [
    (8, "g128_asym"), (8, "pertensor_sym"), (16, "g128_sym"), (16, "perchannel_asym"),
], ids=["a8-g128_asym", "a8-pertensor_sym", "a16-g128_sym", "a16-perchannel_asym"])
def test_a_plain_matches_pallas(abits, spec):
    """``_int3_kernel`` with int8 x (A8) and ``_int3_kernel_a16`` (A16); the
    four side layouts, two under each."""
    jq, tq = _artifact(spec=spec)
    x = _x((16, 1024), seed=40, scale=2.0)
    got, want = _both(x, jq, tq, abits)
    np.testing.assert_allclose(got, want, **TOL)
    full = x @ np.asarray(j_dequantize(jq))
    rel = np.linalg.norm(got - full) / np.linalg.norm(full)
    assert rel < {8: 2e-2, 16: 2e-4}[abits]  # tests/test_pallas_kernel.py's bounds


@pytest.mark.parametrize("abits", [8, 16])
def test_a_plain_matches_pallas_k_pad(abits):
    jq, tq = _artifact(k=896, seed=2, pad_k_to=1024)
    got, want = _both(_x((3, 896), seed=41), jq, tq, abits)
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------ pre-norm rule

def test_pre_norm_normalizes_x_first_for_3_bit():
    """Exact in torch: the plain W3 version with ``pre_norm`` is the plain W3
    version of the normalized x, in bf16 (the norm's output is rounded to
    bf16 before the matmul, as in JAX), and counts under ``w3_matmul``."""
    _, tq = _artifact(seed=6)
    x = torch.from_numpy(_x((5, 1024), seed=7, scale=3.0)).to(torch.bfloat16)
    dm.reset_counts()
    got = dm.dequant_matmul_plain(x, tq, pre_norm=EPS)
    assert dm.PLAIN_CALLS[dm.W3] == 1 and sum(dm.PLAIN_CALLS.values()) == 1
    want = dm.dequant_matmul_plain(t_qmatmul._rms_nogamma(x, EPS), tq)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # the epilogue order rounds elsewhere: the two orders differ in bf16
    w = t_qmatmul.dequantize_weight(tq)
    xf = x.float()
    epilogue = ((xf @ w) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)).to(x.dtype)
    assert not torch.equal(got, epilogue)
    assert not dm.prenorm_supported(tq)


def test_pre_norm_matches_pallas_for_3_bit():
    """JAX normalizes x in XLA, then runs the s21 kernel; the two norms may
    differ in the last f32 bit, well inside the tolerance."""
    jq, tq = _artifact(seed=6)
    got, want = _both(_x((4, 1024), seed=9, scale=3.0), jq, tq, pre_norm=EPS)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bits", [4, 8])
def test_nib4_and_byte_keep_the_epilogue_order(bits):
    """The layouts with a prenorm kernel keep its order: the f32 product
    times ``rsqrt(mean(x^2) + eps)``, then one cast."""
    jq = j_quantize(jnp.asarray(_x((512, 256), seed=10, scale=0.05)),
                    JSpec(**dict(W3, bits=bits)))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert dm.prenorm_supported(tq)
    x = torch.from_numpy(_x((5, 512), seed=11, scale=3.0)).to(torch.bfloat16)
    got = dm.dequant_matmul_plain(x, tq, pre_norm=EPS)
    xf = x.float()
    want = ((xf @ t_qmatmul.dequantize_weight(tq))
            * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)).to(x.dtype)
    assert torch.equal(got, want)


# ----------------------------------------------------------- kernel support

@pytest.mark.parametrize("case", [
    (1024, "g128_asym", {}), (1024, "perchannel_asym", {}), (1024, "pertensor_sym", {}),
    (2048, "g128_sym", {}), (896, "g128_asym", dict(pad_k_to=1024)),
], ids=["k1024_g128", "k1024_perchannel", "k1024_pertensor", "k2048_g128_sym", "k896_kpad"])
def test_kernel_takes_what_the_jax_kernel_takes(case):
    k, spec, kw = case
    jq, tq = _artifact(k=k, spec=spec, seed=12, **kw)
    assert j_dm.kernel_supported(jq) and dm.kernel_supported(tq)
    for abits in (8, 16):
        assert dm.kernel_supported(tq, abits)


def test_group_straddling_two_slabs_is_refused_like_jax():
    """K=1088, g=64 (tests/test_pallas_kernel.py test_misaligned_group_rejected):
    K/8 = 136 rows a slab, 64 does not divide it."""
    w = _x((1088, 256), seed=10)
    jq = j_quantize(jnp.asarray(w), JSpec(**dict(W3, group_size=64)))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert not j_dm.kernel_supported(jq)
    assert not dm.kernel_supported(tq) and not dm.kernel_supported(tq, 8)


def test_kernel_takes_more_than_the_jax_kernel():
    """K/8 need not be a multiple of 128 here (the TPU tile): K=512 with
    g=64 or per-channel side info has a kernel in the port, none in JAX."""
    for spec in (dict(W3, group_size=64), dict(W3, group_size=PER_CHANNEL)):
        jq = j_quantize(jnp.asarray(_x((512, 256), seed=14, scale=0.05)), JSpec(**spec))
        tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
        assert not j_dm.kernel_supported(jq)
        assert dm.kernel_supported(tq) and dm.kernel_supported(tq, 16)
