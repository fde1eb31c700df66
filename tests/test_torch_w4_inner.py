"""Port parity: the W4 inner-loop probe kernel and its entry point.

The plain version of ``w4_inner_matmul`` (``w4_inner_plain``) is what a CPU
tensor runs.  Here, on the same numpy inputs (artifacts quantized once, by
JAX, and carried across by ``interop``):

* in each mode (``f32``, ``magic``) it matches the JAX probe's
  ``_kernel_variant`` (``scripts/probe_w4_inner.py``) run through
  ``pl.pallas_call`` in interpret mode: with f32 x at the Pallas tests'
  tolerance (rtol 2e-5, atol 2e-4), with bf16 x to ``max|d|/max|ref| <=
  1e-2`` (one bf16 rounding of sums taken in another order), for int4 g128,
  g64 and per-channel asymmetric, g128 symmetric and an ``n_pad`` artifact,
  at M of 1, 4 and 8;
* both modes match the oracle (``dequantize_weight`` and a matmul) on the
  port's own artifacts, ``k_pad`` and groups that straddle the two K halves
  included;
* it takes exactly the artifacts ``w4_matmul`` takes on the card, and its
  calls are counted under the kernel's names;
* the probe entry point runs on the CPU at a tiny shape;
* the port's ``utils``: ``Roofline`` gives the JAX ``Roofline``'s floor at
  the same peaks, ``Timer`` accumulates spans, ``host_ms`` makes its
  warm-up and timed calls, ``trace`` writes a file only when given one.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from iron_weight_only_quant_tpu.config import PER_CHANNEL, QuantSpec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu.utils.profiling import Roofline as JRoofline
from iron_weight_only_quant_tpu_torch.config import fp_spec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops import dequantize_weight
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.ops.kernels.w4_inner import (
    MODES,
    w4_inner_matmul,
    w4_inner_plain,
)
from iron_weight_only_quant_tpu_torch.probes import probe_w4_inner as probe
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor
from iron_weight_only_quant_tpu_torch.utils import WARMUP, Roofline, Timer, host_ms, trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import probe_w4_inner as j_probe  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-4)
BF16_TOL = 1e-2


def _w4(group_size, symmetric=False):
    return QuantSpec(fmt="int", bits=4, group_size=group_size, symmetric=symmetric)


CASES = {  # id: (spec, K, N, quantize_tensor kwargs, M)
    "g128_asym_m8": (_w4(128), 512, 256, {}, 8),
    "g64_asym_m1": (_w4(64), 1024, 256, {}, 1),
    "perchannel_asym_m4": (_w4(PER_CHANNEL), 512, 256, {}, 4),
    "g128_sym_m8": (_w4(128, True), 512, 256, {}, 8),
    "g128_npad_m4": (_w4(128), 512, 300, dict(pad_n_to=512), 4),
}
ORACLE_CASES = {  # quantized by the port
    "g128_kpad": (_w4(128), 384, 256, dict(pad_k_to=512), 3),
    "g128_straddle": (_w4(128), 1408, 128, {}, 5),
    "perchannel_sym": (_w4(PER_CHANNEL, True), 512, 256, {}, 8),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls that gain nothing from
    many torch threads; in the parallel test run those threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(case):
    """(JAX artifact, port artifact) of a case, quantized once by JAX."""
    spec, k, n, kw, _ = CASES[case]
    jq = j_quantize(jnp.asarray(_x((k, n), seed=len(case)) * 0.05), spec, **kw)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _port_artifact(spec, k, n, seed=3, **kw):
    return quantize_tensor(torch.from_numpy(_x((k, n), seed=seed) * 0.05), spec, **kw)


def _inputs(case, dtype):
    """(JAX x, port x) of a case: the same values, rounded once to ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    _, k, _, _, m = CASES[case]
    xj = jnp.asarray(_x((m, k), seed=7)).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _jax_variant(x, qt, mode):
    """``scripts/probe_w4_inner.py``'s ``run_variant`` with ``interpret=True``
    (the script hard-codes the TPU): ``_kernel_variant`` on the JAX
    package's tile plan."""
    k, n_logical = qt.shape
    n = n_logical + qt.n_pad
    x2, m, m_pad, tm, out_dtype, _ = j_dm._prep_x(x, k, None)
    rows = qt.scales.shape[0]
    kp = k // 2
    tn, tpk, rs, g_target = j_dm._plan_tiles(n, kp, k, rows, tm, slabs=2)
    nk = kp // tpk
    scales = j_dm._normalize_side(qt.scales, k, n, g_target)
    zeros = j_dm._normalize_side(qt.zeros, k, n, g_target)
    srows = scales.shape[0]
    common = j_dm._common_params(tm, tn, m_pad, n, k, kp, srows, out_dtype, True)
    side_spec = pl.BlockSpec((srows, tn), lambda i, j, kk: (0, j))
    kernel = functools.partial(j_probe._kernel_variant, rs=rs, nk=nk,
                               out_dtype=out_dtype, mode=mode)
    out = pl.pallas_call(
        kernel,
        grid=(m_pad // tm, n // tn, nk),
        in_specs=[
            pl.BlockSpec((tm, tpk), lambda i, j, kk: (i, kk)),
            pl.BlockSpec((tm, tpk), lambda i, j, kk, _nk=nk: (i, _nk + kk)),
            pl.BlockSpec((tpk, tn), lambda i, j, kk: (kk, j)),
            side_spec,
            side_spec,
        ],
        **common,
    )(x2, x2, qt.qweight, scales, zeros)
    return j_dm._finish(out, x, qt, m, m_pad, None)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= BF16_TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_jax_probe_kernel(case, dtype, mode):
    jq, tq = _pair(case)
    assert j_dm.kernel_supported(jq) and dm.kernel_supported(tq)
    xj, xt = _inputs(case, dtype)
    want = np.asarray(_jax_variant(xj, jq, mode).astype(jnp.float32))
    got = w4_inner_plain(xt, tq, mode)
    assert got.dtype == xt.dtype
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_plain_matches_the_oracle(case, mode):
    spec, k, n, kw, m = ORACLE_CASES[case]
    tq = _port_artifact(spec, k, n, **kw)
    x = torch.from_numpy(_x((1, m, k), seed=7))
    want = x @ dequantize_weight(tq)
    got = w4_inner_matmul(x, tq, mode)
    assert got.shape == want.shape == (1, m, n)
    _close(got[0].numpy(), want[0].numpy(), "f32")


def test_calls_are_counted_under_the_kernel_names():
    _, tq = _pair("g128_asym_m8")
    x = torch.zeros((2, 512))
    dm.reset_counts()
    w4_inner_matmul(x, tq, "f32")
    w4_inner_matmul(x, tq, "f32")
    w4_inner_matmul(x.bfloat16(), tq, "magic")
    assert dm.PLAIN_CALLS == {**{k: 0 for k in dm.PLAIN_CALLS},
                              dm.W4_INNER_F32: 2, dm.W4_INNER_MAGIC: 1}
    assert not any(dm.LAUNCHES.values()) and not any(dm.ROUTE_CALLS.values())
    dm.reset_counts()
    assert not any(dm.PLAIN_CALLS.values())


@pytest.mark.parametrize("case", ["int8", "int3", "fp4", "side_f16", "stacked"])
def test_artifacts_w4_matmul_does_not_take_are_refused(case):
    """Only what ``w4_matmul`` takes on the card: no other storage, no
    format of the route, no stacked artifact; on the CPU too."""
    spec = {"int8": QuantSpec(fmt="int", bits=8, group_size=128, symmetric=False),
            "int3": QuantSpec(fmt="int", bits=3, group_size=128, symmetric=False),
            "fp4": fp_spec("fp4", 2, 1, group_size=128, symmetric=False)}.get(case, _w4(128))
    kw = dict(side_dtype=torch.float16) if case == "side_f16" else {}
    tq = _port_artifact(spec, 512, 128, **kw)
    if case == "stacked":
        tq = tq.replace(qweight=tq.qweight[None], scales=tq.scales[None], zeros=tq.zeros[None])
    assert not (dm.kernel_supported(tq) and dm.kernel_name(tq) == dm.W4)
    for mode in MODES:
        with pytest.raises(NotImplementedError, match="no CUDA kernel"):
            w4_inner_matmul(torch.zeros((2, 512)), tq, mode)
        with pytest.raises(NotImplementedError, match="no CUDA kernel"):
            w4_inner_plain(torch.zeros((2, 512)), tq, mode)


def test_bad_mode_and_dtype_are_refused():
    _, tq = _pair("g128_asym_m8")
    with pytest.raises(ValueError, match="mode"):
        w4_inner_matmul(torch.zeros((2, 512)), tq, "bf16")
    with pytest.raises(ValueError, match="dtype"):
        w4_inner_matmul(torch.zeros((2, 512), dtype=torch.float16), tq, "f32")


def test_probe_entry_point_runs_on_the_cpu(capsys):
    assert probe.main(["--device", "cpu", "--shapes", "256x128"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[1] for line in lines[:-1]] == list(probe.VARIANTS)
    assert all(line.startswith("256x128 ") for line in lines[:-1])
    res = json.loads(lines[-1])["probe_w4_inner"]
    assert res["device"] == "cpu" and res["clock"].startswith("host")
    (shape,) = res["shapes"]
    assert (shape["k"], shape["n"]) == (256, 128)
    assert list(shape["variants"]) == list(probe.VARIANTS)
    for tag, rec in shape["variants"].items():
        assert rec["us"] > 0
        if tag != "w4a8":  # quantized activations: not checked, as in the JAX probe
            assert rec["maxrel"] <= BF16_TOL


def test_probe_counts_the_sass_of_each_kernel():
    text = """
        Function : _ZN4iwoq23w4_inner_partial_kernelILb1E13__nv_bfloat16EEvPKT0_i
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 LOP3.LUT R2, R3, 0xf000f, RZ, 0xc0, !PT ;
        /*0020*/                   FFMA R4, R5, R6, R4 ;
        Function : _ZN4iwoq17w4_partial_kernelILb0EfEEvPKT0_i
        /*0000*/                   I2FP.F32.U32 R2, R3 ;
        Function : _ZN4iwoq16w4_reduce_kernelILb0EfEEvPKfS2_PT0_iiii
        /*0000*/                   FADD R2, R3, R4 ;
    """
    counts = probe.sass_counts(text)
    assert set(counts) == {"magic/bf16", "base/f32x"}
    assert (counts["magic/bf16"]["LOP3"], counts["magic/bf16"]["FFMA"],
            counts["magic/bf16"]["total"]) == (1, 1, 3)
    assert counts["base/f32x"]["I2FP"] == 1 and counts["base/f32x"]["FADD"] == 0


def test_roofline_floor_equals_jax_at_the_same_peaks():
    for m, k, n, wb in ((8, 4096, 4096, 4096 * 4096 / 2 + 32 * 4096 * 8),
                        (256, 11008, 4096, 11008 * 4096 / 2), (1, 128, 128, 0.0)):
        ours, theirs = Roofline(), JRoofline(hbm_gbps=3350.0, bf16_tflops=989.0)
        assert ours.matmul_time_floor(m, k, n, wb) == theirs.matmul_time_floor(m, k, n, wb)
        assert ours.fraction(1e-3, m, k, n, wb) == theirs.fraction(1e-3, m, k, n, wb)


def test_timer_accumulates_spans():
    with Timer() as t:
        for _ in range(2):
            t.start("a")
            assert t.stop("a") >= 0
    assert set(t.spans) == {"a", "__total__"}
    assert 0 <= t.spans["a"] <= t.spans["__total__"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "run")):
        torch.ones((4, 4)) @ torch.ones((4, 4))
    events = json.loads((tmp_path / "run" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_without_logdir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace() as prof:
        torch.ones((4, 4)) @ torch.ones((4, 4))
    assert any("mm" in e.key for e in prof.key_averages())
    assert list(tmp_path.iterdir()) == []


def test_host_ms_makes_warmup_and_timed_calls():
    calls = []
    assert host_ms(calls.append, 3) >= 0
    assert calls == list(range(WARMUP)) + list(range(3))
