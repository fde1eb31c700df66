"""Port parity: the analysis tools on the same artifacts and data.

The artifacts are quantized by the JAX package and carried across by
``interop`` (so both sides read the same bytes): codeword and exponent
histograms and exponent-outlier statistics equal the JAX package's;
``fp16_bit_sparsity`` and ``activation_pre_align`` (numpy only) equal
them; ``capture_linear_inputs`` on a tiny OPT records the JAX inputs
within 1e-6 (float32 forwards); the plots write their files, as the JAX
ones do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu import analysis as JA
from iron_weight_only_quant_tpu.analysis import plots as j_plots
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.models import opt as j_opt
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize_tensor
from iron_weight_only_quant_tpu.quantize.gptq_model import annotate_linears as j_annotate
from iron_weight_only_quant_tpu_torch import analysis as TA
from iron_weight_only_quant_tpu_torch.analysis import plots as t_plots
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import opt as t_opt
from iron_weight_only_quant_tpu_torch.quantize.gptq_model import annotate_linears as t_annotate

SPECS = {
    "int4_g64": JSpec(fmt="int", bits=4, group_size=64),
    "int8_sym": JSpec(fmt="int", bits=8, group_size=128, symmetric=True),
    "int3_g32": JSpec(fmt="int", bits=3, group_size=32),
    "bfp4": JSpec(fmt="bfp", bits=4, group_size=32),
    "fp8_e4m3": j_fp_spec("fp8", 4, 3, group_size=128),
    "fp4_e2m1_asym": j_fp_spec("fp4", 2, 1, group_size=64, symmetric=False),
    "fp6_e3m2": j_fp_spec("fp6", 3, 2, group_size=32),
}
FP = [k for k in SPECS if k.startswith("fp")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts():
    """name -> (JAX artifact, the same artifact in the port)."""
    w = jnp.asarray(np.random.default_rng(0).normal(size=(256, 96)).astype(np.float32) * 0.05)
    out = {}
    for name, spec in SPECS.items():
        jq = j_quantize_tensor(w, spec, k_shards=2 if name == "int4_g64" else 1)
        out[name] = (jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu"))
    return out


def _equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(SPECS))
def test_codeword_histogram_equals_jax(artifacts, name):
    jq, tq = artifacts[name]
    _equal(TA.codeword_histogram(tq), JA.codeword_histogram(jq))


@pytest.mark.parametrize("name", FP)
def test_exponent_stats_equal_jax(artifacts, name):
    jq, tq = artifacts[name]
    _equal(TA.exponent_histogram(tq), JA.exponent_histogram(jq))
    bits = jq.spec.float_format.exp_bits
    for lo, hi, group in ((1, (1 << bits) - 2, 4), (0, 1, 8)):
        assert TA.exponent_outlier_stats(tq, lo, hi, group) == \
            JA.exponent_outlier_stats(jq, lo, hi, group)


def test_exponent_stats_refuse_affine_artifacts_as_jax(artifacts):
    jq, tq = artifacts["int4_g64"]
    for fn in ("exponent_histogram", "exponent_outlier_stats"):
        args = () if fn == "exponent_histogram" else (1, 2)
        with pytest.raises(ValueError) as want:
            getattr(JA, fn)(jq, *args)
        with pytest.raises(ValueError) as got:
            getattr(TA, fn)(tq, *args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("keep_bits", [13, 9])
def test_fp16_bit_sparsity_equals_jax(keep_bits):
    x = np.random.default_rng(2).normal(size=200) * np.logspace(-6, 2, 200)
    x[:3] = [0.0, 6e-8, -1.5]  # zero, subnormal
    _equal(TA.fp16_bit_sparsity(x, keep_bits), JA.fp16_bit_sparsity(x, keep_bits))


@pytest.mark.parametrize("mantissa_bits", [12, 7])
def test_activation_pre_align_equals_jax(mantissa_bits):
    x = np.random.default_rng(3).normal(size=(5, 24)).astype(np.float32)
    x[1] = 0.0
    _equal(TA.activation_pre_align(x, mantissa_bits), JA.activation_pre_align(x, mantissa_bits))
    with pytest.raises(ValueError, match="2-D"):
        TA.activation_pre_align(x[0])


@pytest.mark.parametrize("names", [["q", "fc1"], None])
def test_capture_linear_inputs_matches_jax(names):
    cfg = j_opt.OPTConfig.tiny()
    jp = j_opt.opt_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jp["layers"] = [j_annotate(b) for b in jp["layers"]]
    tp["layers"] = [t_annotate(b) for b in tp["layers"]]
    t_cfg = t_opt.OPTConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    toks = np.array([[1, 2, 3, 4, 9]])
    want = JA.capture_linear_inputs(j_opt.opt_forward, jp, cfg, jnp.asarray(toks, jnp.int32),
                                    names=names)
    got = TA.capture_linear_inputs(t_opt.opt_forward, tp, t_cfg, torch.from_numpy(toks),
                                   names=names)
    assert list(got) == list(want) and len(want) == (2 if names else 6)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == np.asarray(want[k]).shape
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6)


def test_plots_write_their_files(artifacts, tmp_path):
    pytest.importorskip("matplotlib")
    jq, tq = artifacts["fp8_e4m3"]
    x = np.random.default_rng(4).normal(size=64)
    for mod, side, q in ((j_plots, "j", jq), (t_plots, "t", tq)):
        paths = [mod.plot_codeword_histogram(q, str(tmp_path / f"{side}_cw.png")),
                 mod.plot_exponent_histogram(q, str(tmp_path / f"{side}_exp.png")),
                 mod.plot_bit_sparsity(x, str(tmp_path / f"{side}_bits.png"))]
        assert all((tmp_path / p.rsplit("/", 1)[1]).stat().st_size > 1000 for p in paths)
