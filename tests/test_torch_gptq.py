"""Port parity: the GPTQ and TrueOBS solvers and the GPTQ artifact packing.

The same numpy inputs go through the JAX package's functions and the
port's, on the CPU:

* ``hessian_update`` equals the JAX recurrence and ``tests/golden/gptq.npz``
  (rtol 1e-4, atol 1e-5, as ``tests/test_gptq.py``);
* ``_find_params`` (plain, ``trits``) and ``_quantize_col`` are bit-equal
  to the JAX functions; with ``mse`` the same shrink step is chosen on
  every row (XLA's fused loop rounds its scales a few ulps apart);
* ``gptq_quantize`` with the JAX solver's H, over the six golden cases and
  static groups, ``mse``, groups narrower than a block, a group wider than
  the matrix, a last partial group and dead columns, meets
  ``tests/test_gptq.py``'s criterion against the JAX solve (and the
  golden weights): at least 99.5% of the entries equal (rtol 1e-5, atol
  1e-7), all within 0.3 max|w|;
* ``trueobs_quantize`` (plain, ``nearest``, ``sparseout``) against JAX: q,
  codes, outliers and losses;
* packed 4-bit and 3-bit GPTQ artifacts are byte-equal to JAX's
  ``gptq_result_to_qtensor`` of the same solve; the port's 8-bit artifact
  dequantizes to the solver's q exactly, where the JAX package's does not
  (ROADMAP C17: it packs unshifted codes with unshifted zeros).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.ops import qmatmul as j_qmatmul
from iron_weight_only_quant_tpu.quantize import gptq as j_gptq
from iron_weight_only_quant_tpu.quantize import gptq_model as j_gm
from iron_weight_only_quant_tpu.quantize import trueobs as j_obs
from iron_weight_only_quant_tpu_torch.config import QuantSpec
from iron_weight_only_quant_tpu_torch.ops.qmatmul import dequantize_weight
from iron_weight_only_quant_tpu_torch.quantize import gptq as t_gptq
from iron_weight_only_quant_tpu_torch.quantize import gptq_model as t_gm
from iron_weight_only_quant_tpu_torch.quantize import trueobs as t_obs

GOLDEN = Path(__file__).parent / "golden"
# tests/test_gptq.py's cases, each with its golden weights and H
CASES = {
    "pc_sym_b4": dict(bits=4, sym=True, groupsize=-1),
    "pc_asym_b4": dict(bits=4, sym=False, groupsize=-1),
    "g16_asym_b4": dict(bits=4, sym=False, groupsize=16),
    "g16_asym_b4_act": dict(bits=4, sym=False, groupsize=16, actorder=True),
    "pc_sym_b3": dict(bits=3, sym=True, groupsize=-1),
    "pc_trits": dict(bits=2, sym=True, groupsize=-1, trits=True),
}
# further options, on the g16 case's H
EXTRA = {
    "g16_static": dict(bits=4, sym=False, groupsize=16, static_groups=True),
    "g16_static_act": dict(bits=4, sym=False, groupsize=16, static_groups=True,
                           actorder=True),
    "pc_mse": dict(bits=3, sym=False, groupsize=-1, mse=True),
    "g16_mse_sym": dict(bits=4, sym=True, groupsize=16, mse=True),
    "g128_wider_than_matrix": dict(bits=4, sym=False, groupsize=128),
    "g24_partial_last_group": dict(bits=4, sym=False, groupsize=24),
    "g8_block32": dict(bits=3, sym=False, groupsize=8, blocksize=32),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "gptq.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _hessians(calib):
    """(JAX H, port H) of the same samples through both recurrences."""
    hj, nj = jnp.zeros((calib.shape[-1],) * 2, jnp.float32), jnp.asarray(0.0)
    ht = torch.zeros((calib.shape[-1],) * 2)
    nt = torch.zeros(())
    for x in calib:
        hj, nj = j_gptq.hessian_update(hj, nj, jnp.asarray(x))
        ht, nt = t_gptq.hessian_update(ht, nt, torch.from_numpy(x))
    return np.asarray(hj), _np(ht), float(nt)


def _assert_gptq_close(ours, ref, w):
    """tests/test_gptq.py's criterion."""
    exact = np.isclose(ours, ref, rtol=1e-5, atol=1e-7)
    assert exact.mean() > 0.995, f"{100 * (1 - exact.mean()):.2f}% differ"
    np.testing.assert_allclose(ours, ref, atol=np.abs(w).max() * 0.3)


def test_hessian_update_matches_jax_and_golden(golden):
    hj, ht, n = _hessians(golden["calib"])
    assert n == golden["calib"].shape[0]
    np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ht, golden["pc_sym_b4_H"], rtol=1e-4, atol=1e-5)


def _param_inputs():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(12, 40)).astype(np.float32)
    w[0] = np.abs(w[0])  # a row without negatives: xmin = 0, zero = round(-0)
    w[1] = -np.abs(w[1])
    w[2] = 0.0  # degenerate
    return w


@pytest.mark.parametrize("bits,sym,mse,trits", [
    (4, False, False, False), (4, True, False, False), (3, False, True, False),
    (4, True, True, False), (8, False, True, False), (2, True, False, True),
])
def test_find_params_and_quantize_col_bit_equal(bits, sym, mse, trits):
    w = _param_inputs()
    sj, zj = j_gptq._find_params(jnp.asarray(w), bits, sym, mse, trits=trits)
    st, zt = t_gptq._find_params(torch.from_numpy(w), bits, sym, mse, trits=trits)
    np.testing.assert_array_equal(_np(zt).view(np.uint32), np.asarray(zj).view(np.uint32))
    if mse:
        # XLA compiles the JAX shrink loop into one fused body: it divides
        # by the constant maxq as a product with its reciprocal and
        # contracts multiply-adds, so its scales lie a few ulps from the
        # port's divisions (the reference's).  The same shrink step is
        # chosen on every row: the zero points are bit-equal, the scales
        # within 5e-7.
        np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=5e-7, atol=0)
        sj = jnp.asarray(_np(st))
    else:
        np.testing.assert_array_equal(_np(st).view(np.uint32), np.asarray(sj).view(np.uint32))
    maxq = float(2**bits - 1)
    col = w[:, 5]
    qj, cj = j_gptq._quantize_col(jnp.asarray(col), sj, zj, maxq, trits=trits)
    qt, ct = t_gptq._quantize_col(torch.from_numpy(col), st, zt, maxq, trits=trits)
    np.testing.assert_array_equal(_np(qt).view(np.uint32), np.asarray(qj).view(np.uint32))
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))


def test_trits_with_mse_raises_as_in_jax():
    w = _param_inputs()
    with pytest.raises(ValueError, match="trits"):
        j_gptq._find_params(jnp.asarray(w), 2, True, True, trits=True)
    with pytest.raises(ValueError, match="trits"):
        t_gptq._find_params(torch.from_numpy(w), 2, True, True, trits=True)


@pytest.mark.parametrize("key", list(CASES) + list(EXTRA))
def test_gptq_quantize_matches_jax(golden, key):
    kw = {"blocksize": 16, **CASES.get(key, EXTRA.get(key))}
    w = golden["weight"]
    h = golden[(key if key in CASES else "g16_asym_b4") + "_H"]
    ref = j_gptq.gptq_quantize(jnp.asarray(w), jnp.asarray(h), percdamp=0.01, **kw)
    res = t_gptq.gptq_quantize(_t(w), _t(h), percdamp=0.01, **kw)
    _assert_gptq_close(_np(res.q), np.asarray(ref.q), w)
    if key in CASES:
        _assert_gptq_close(_np(res.q), golden[key], w)
    assert res.scales.shape == ref.scales.shape and res.zeros.shape == ref.zeros.shape
    codes_equal = (_np(res.codes) == np.asarray(ref.codes)).mean()
    assert codes_equal > 0.995, key
    assert (res.perm is None) == (ref.perm is None)
    if res.perm is not None:
        np.testing.assert_array_equal(_np(res.perm), np.asarray(ref.perm))
    # q is the grid's value of the codes (affine cases, one group a row or g | cols)
    if not kw.get("trits") and not kw.get("actorder") and w.shape[1] % (
            kw["groupsize"] if kw["groupsize"] > 0 else w.shape[1]) == 0:
        g = w.shape[1] // res.scales.shape[1]
        recon = _np(res.scales).repeat(g, 1) * (_np(res.codes).astype(np.float32)
                                                - _np(res.zeros).repeat(g, 1))
        np.testing.assert_array_equal(recon, _np(res.q))


def test_gptq_dead_columns_match_jax(golden):
    """Columns no input reached: zero weights out, the JAX solve's q."""
    w = golden["weight"]
    h = golden["pc_asym_b4_H"].copy()
    dead = [3, 17, 40]
    h[dead, :] = 0.0
    h[:, dead] = 0.0
    ref = j_gptq.gptq_quantize(jnp.asarray(w), jnp.asarray(h), bits=4, sym=False,
                               groupsize=16, blocksize=16)
    res = t_gptq.gptq_quantize(_t(w), _t(h), bits=4, sym=False, groupsize=16, blocksize=16)
    _assert_gptq_close(_np(res.q), np.asarray(ref.q), w)
    assert np.abs(_np(res.q)[:, dead]).max() <= np.abs(_np(res.scales)).max()


@pytest.mark.parametrize("mode", ["plain", "nearest", "sparseout"])
def test_trueobs_matches_jax(golden, mode):
    w = golden["weight"]
    h = golden["pc_asym_b4_H"]
    kw = dict(bits=2 if mode == "sparseout" else 4, sym=False, blocksize=16,
              nearest=mode == "nearest", sparseout=mode == "sparseout")
    ref = j_obs.trueobs_quantize(jnp.asarray(w), jnp.asarray(h), **kw)
    res = t_obs.trueobs_quantize(_t(w), _t(h), **kw)
    _assert_gptq_close(_np(res.q), np.asarray(ref.q), w)
    assert (_np(res.codes) == np.asarray(ref.codes)).mean() > 0.995
    assert (_np(res.outliers) == np.asarray(ref.outliers)).mean() > 0.995
    if mode == "sparseout":
        assert _np(res.outliers).any()
    # the jitted JAX solve divides by the constant maxq as a product with
    # its reciprocal: its scales lie an ulp from the port's division
    np.testing.assert_allclose(_np(res.scale), np.asarray(ref.scale), rtol=5e-7, atol=0)
    np.testing.assert_array_equal(_np(res.zero), np.asarray(ref.zero))
    close = np.isclose(_np(res.losses), np.asarray(ref.losses), rtol=1e-4, atol=1e-6)
    assert close.mean() > 0.995
    assert float(res.outlier_fraction) == pytest.approx(float(ref.outlier_fraction), abs=0.005)


def _jax_result(w, h, **kw):
    return j_gptq.gptq_quantize(jnp.asarray(w), jnp.asarray(h), blocksize=16, **kw)


def _as_torch_result(res):
    return t_gptq.GPTQResult(*(None if a is None else _t(a) for a in res))


@pytest.mark.parametrize("bits,sym,groupsize", [
    (4, False, 16), (4, True, -1), (3, False, 16), (3, True, -1),
])
def test_packed_artifact_bytes_equal_jax(golden, bits, sym, groupsize):
    """The same solve packed by both packages: the same bytes and sides."""
    w, h = golden["weight"], golden["g16_asym_b4_H"]
    res = _jax_result(w, h, bits=bits, sym=sym, groupsize=groupsize)
    k, n = w.shape[1], w.shape[0]
    gs = groupsize if groupsize > 0 else -2
    jq = j_gm.gptq_result_to_qtensor(res, JSpec(fmt="int", bits=bits, group_size=gs,
                                                symmetric=sym), k, n)
    tq = t_gm.gptq_result_to_qtensor(_as_torch_result(res),
                                     QuantSpec(fmt="int", bits=bits, group_size=gs,
                                               symmetric=sym), k, n)
    for f in ("qweight", "scales", "zeros"):
        a, b = _np(getattr(tq, f)), np.asarray(getattr(jq, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=f)
    assert (tq.shape, tq.mode, tq.k_shards, tq.n_pad) == (tuple(jq.shape), jq.mode, 1, 0)
    np.testing.assert_array_equal(_np(dequantize_weight(tq)).T, np.asarray(res.q))


@pytest.mark.parametrize("sym,groupsize", [(False, 16), (True, -1)])
def test_c17_8bit_artifact_dequantizes_to_the_solve(golden, sym, groupsize):
    """The byte layout stores code - 128 with zero - 128 (the RTN path's
    rule): the port's 8-bit artifact decodes to the solver's q exactly.
    The JAX package packs the codes as ``codes & 0xFF`` with unshifted
    zeros, so its own decode is off for every code >= 128."""
    w, h = golden["weight"], golden["g16_asym_b4_H"]
    res = _jax_result(w, h, bits=8, sym=sym, groupsize=groupsize)
    k, n = w.shape[1], w.shape[0]
    gs = groupsize if groupsize > 0 else -2
    tq = t_gm.gptq_result_to_qtensor(_as_torch_result(res),
                                     QuantSpec(fmt="int", bits=8, group_size=gs,
                                               symmetric=sym), k, n)
    np.testing.assert_array_equal(_np(dequantize_weight(tq)).T, np.asarray(res.q))
    jq = j_gm.gptq_result_to_qtensor(res, JSpec(fmt="int", bits=8, group_size=gs,
                                                symmetric=sym), k, n)
    j_err = np.abs(np.asarray(j_qmatmul.dequantize_weight(jq)).T - np.asarray(res.q)).max()
    assert (np.asarray(res.codes) >= 128).any() and j_err > 0.5 * np.abs(w).max()
