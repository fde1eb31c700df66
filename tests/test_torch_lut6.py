"""Port parity: the fp6 (nq42) dequant-matmuls against the JAX package.

The plain versions of ``lut6_matmul`` and ``lut6a16_matmul`` are what a CPU
tensor runs (``lut_matmul_plain`` and ``lut_int_matmul_plain`` over the
nq42 decode).  Here, on the same numpy inputs (artifacts quantized once, by
JAX):

* ``lut6_matmul``'s plain version matches ``_lut6_kernel`` (flat) and
  ``_lut6_kernel_pfx`` (layer-stacked) run in interpret mode at the Pallas
  tests' tolerance (rtol 2e-5, atol 2e-4, f32), for fp6 E2M3 and E3M2,
  with and without zero points, groups of 32, 64, 128 and per-channel, a
  ``k_pad`` artifact, and M of 1, 4 and 8;
* ``lut6a16_matmul``'s plain version matches ``_lut6_kernel_a16`` and its
  stacked form at ``rel < 2e-4`` (``tests/test_pallas_kernel.py``'s A16
  tolerance);
* the dispatch rules are the JAX package's: E2M3 takes A16, E3M2 under A16
  warns and runs ``lut6_matmul`` at full precision, A8 raises;
* an nq42 artifact whose groups straddle the K/4 quarters takes the route,
  as the JAX package sends it to its XLA path (``_layout6_supported``):
  under A16 it gives the JAX ``quantized_matmul`` result at full precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import PER_CHANNEL, fp_spec
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops import qmatmul as t_qmatmul
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
CASES = {  # id: (spec, K, quantize_tensor kwargs, M)
    "e2m3_g128_sym_m8": (fp_spec("fp6", 2, 3, group_size=128), 512, {}, 8),
    "e2m3_g64_asym_m1": (fp_spec("fp6", 2, 3, group_size=64, symmetric=False), 1024, {}, 1),
    "e3m2_g32_sym_m4": (fp_spec("fp6", 3, 2, group_size=32), 512, {}, 4),
    "e3m2_perchannel_asym_m8": (fp_spec("fp6", 3, 2, group_size=PER_CHANNEL,
                                        symmetric=False), 512, {}, 8),
    "e2m3_g128_kpad_m4": (fp_spec("fp6", 2, 3, group_size=128), 384, dict(pad_k_to=512), 4),
}
A16_CASES = ["e2m3_g128_sym_m8", "e2m3_g64_asym_m1", "e2m3_g128_kpad_m4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls and many small ops that
    gain nothing from many torch threads; in the parallel test run those
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _artifacts(spec, k, kw, n=256, layers=2, seed=0):
    """Per layer (JAX artifact, port artifact), and the stacked pair."""
    jqs = [j_quantize(jnp.asarray(_x((k, n), seed=seed + i, scale=0.05)), spec, **kw)
           for i in range(layers)]
    tqs = [params_from_numpy(jax.tree.map(np.asarray, q), "cpu") for q in jqs]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jqs)
    return jqs, tqs, jst, params_from_numpy(jax.tree.map(np.asarray, jst), "cpu")


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_lut6_matches_pallas(case):
    """Flat against ``_lut6_kernel``, layer 1 of a stack against
    ``_lut6_kernel_pfx``, both in interpret mode."""
    spec, k, kw, m = CASES[case]
    jqs, tqs, jst, tst = _artifacts(spec, k, kw, seed=3)
    jq, tq = jqs[0], tqs[0]
    assert dm.packed_bits(tq) == 6 and (tq.zeros is None) == spec.symmetric
    assert tq.k_pad == kw.get("pad_k_to", k) - k
    assert j_dm.kernel_supported(jq) and dm.kernel_supported(tq) and not dm.xla_route(tq)
    assert j_dm.kernel_supported_stacked(jst) and dm.kernel_supported_stacked(tst)
    assert dm.kernel_name(tq) == dm.kernel_name(tq, EPS) == dm.kernel_name(tst) == dm.LUT6
    x = _x((m, k), seed=4)
    want = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x), jq, interpret=True))
    dm.reset_counts()
    got = dm.fused_quantized_matmul(torch.from_numpy(x), tq)
    assert dm.PLAIN_CALLS[dm.LUT6] == 1 == sum(dm.PLAIN_CALLS.values())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want1 = np.asarray(j_dm.fused_quantized_matmul_stacked(jnp.asarray(x), jst, 1,
                                                           interpret=True))
    got1 = dm.fused_quantized_matmul_stacked(torch.from_numpy(x), tst, 1)
    np.testing.assert_allclose(got1.numpy(), want1, **TOL)


@pytest.mark.parametrize("case", A16_CASES)
def test_plain_lut6_a16_matches_pallas(case):
    """Flat and stacked (layer 1) A16 against ``_lut6_kernel_a16``; the
    integer sums are exact, only the f32 epilogue's order differs."""
    spec, k, kw, m = CASES[case]
    jqs, tqs, jst, tst = _artifacts(spec, k, kw, seed=20)
    jq, tq = jqs[0], tqs[0]
    assert j_dm.a16_supported(jq) and dm.a16_supported(tq)
    assert dm.kernel_supported(tq, 16) and dm.kernel_supported_stacked(tst, 16)
    assert dm.kernel_name(tq, EPS, 16) == dm.LUT6A16
    x = _x((m, k), seed=8, scale=2.0)
    want = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x), jq, interpret=True,
                                                  activation_bits=16))
    dm.reset_counts()
    got = dm.fused_quantized_matmul(torch.from_numpy(x), tq, activation_bits=16).numpy()
    assert dm.PLAIN_CALLS[dm.LUT6A16] == 1 == sum(dm.PLAIN_CALLS.values())
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    assert rel(got, want) < 2e-4
    full = (torch.from_numpy(x) @ t_qmatmul.dequantize_weight(tq)).numpy()
    assert rel(got, full) < 2e-4  # as close to full precision as the JAX test asks
    want1 = np.asarray(j_dm.fused_quantized_matmul_stacked(
        jnp.asarray(x), jst, 1, interpret=True, activation_bits=16))
    got1 = dm.fused_quantized_matmul_stacked(torch.from_numpy(x), tst, 1,
                                             activation_bits=16).numpy()
    assert rel(got1, want1) < 2e-4


def test_lut6_dispatch_rules_match_jax():
    """E2M3 has the A16 grid and takes ``lut6a16``; E3M2 under A16 warns and
    runs ``lut6`` (and its plain version) at full precision; A8 raises; a
    ``pre_norm`` names the flat kernel (no prenorm kernel: x is normalized
    first).  The kernels' group rule: G must divide the K/4 quad rows."""
    x = torch.from_numpy(_x((3, 512), seed=9))
    for em, a16 in (((2, 3), True), ((3, 2), False)):
        jqs, tqs, _, _ = _artifacts(fp_spec("fp6", *em, group_size=128), 512, {}, layers=1)
        jq, tq = jqs[0], tqs[0]
        assert dm.a16_supported(tq) == a16 == j_dm.a16_supported(jq)
        assert dm.kernel_supported(tq) and dm.kernel_supported(tq, 16)
        assert not dm.kernel_supported(tq, 8) and not dm.prenorm_supported(tq)
        assert dm.kernel_name(tq, EPS, 16) == (dm.LUT6A16 if a16 else dm.LUT6)
        with pytest.raises(NotImplementedError, match="LUT"):
            t_qmatmul.quantized_matmul(x, tq, activation_bits=8)
        if not a16:
            dm.reset_counts()
            with pytest.warns(UserWarning, match="full-precision"):
                y = t_qmatmul.quantized_matmul(x, tq, activation_bits=16)
            assert dm.PLAIN_CALLS == {**{k: 0 for k in dm.PLAIN_CALLS}, dm.LUT6: 1}
            torch.testing.assert_close(y, t_qmatmul.quantized_matmul(x, tq), rtol=0, atol=0)
    assert dm._slab_groups(512, 128, 4, 4) == 128 and dm._slab_groups(512, 128, 1, 4) == 128
    with pytest.raises(ValueError, match="straddles the K/4"):
        dm._slab_groups(512, 128, 2, 4)


def test_quarter_straddling_groups_take_the_route():
    """K=512 with g=256: a group straddles the K/4 = 128 quad rows, so the
    JAX package computes on its XLA path (activation bits ignored) and the
    port takes the route, with one route call and no plain call; g=128 at
    the same K takes ``lut6a16``'s plain version."""
    x = _x((5, 512), seed=11, scale=2.0)
    jqs, tqs, jst, tst = _artifacts(fp_spec("fp6", 2, 3, group_size=256), 512, {}, seed=30)
    jq, tq = jqs[0], tqs[0]
    assert dm.packed_bits(tq) == 6 and tq.scales.shape[0] == 2
    assert not j_dm.kernel_supported(jq) and dm.xla_route(tq)
    assert not dm.kernel_supported(tq, 16) and dm.kernel_name(tq, None, 16) is None
    want = np.asarray(j_qmatmul.quantized_matmul(jnp.asarray(x), jq, activation_bits=16))
    dm.reset_counts()
    got = t_qmatmul.quantized_matmul(torch.from_numpy(x), tq, activation_bits=16)
    assert dm.ROUTE_CALLS == {dm.ROUTE: 1} and not any(dm.PLAIN_CALLS.values())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert dm.xla_route(tst)
    want1 = np.asarray(j_qmatmul.quantized_matmul_stacked(jnp.asarray(x), jst, 1,
                                                          activation_bits=16))
    got1 = t_qmatmul.quantized_matmul_stacked(torch.from_numpy(x), tst, 1, activation_bits=16)
    assert dm.ROUTE_CALLS == {dm.ROUTE: 2}
    np.testing.assert_allclose(got1.numpy(), want1, **TOL)
    _, (tq128,), _, _ = _artifacts(fp_spec("fp6", 2, 3, group_size=128), 512, {}, layers=1)
    assert not dm.xla_route(tq128)
    dm.reset_counts()
    t_qmatmul.quantized_matmul(torch.from_numpy(x), tq128, activation_bits=16)
    assert dm.PLAIN_CALLS[dm.LUT6A16] == 1 and dm.ROUTE_CALLS == {dm.ROUTE: 0}
