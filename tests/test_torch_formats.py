"""Port parity: the format zoo (minifloat, BFP, FP4-E1M2) against the JAX package.

* the port's ``fake_quantize`` reproduces every case of the reference
  fixtures ``tests/golden/quant_linear.npz`` and ``quant_linear_custom.npz``
  bit for bit, and ``fp4_cpu.npz`` at the tolerance of
  ``tests/test_formats.py`` (the reference computed it in fp16);
* each codec gives the JAX function's values exactly on the same seeded
  numpy data: ``float_to_code``, ``code_to_float``, the aligned and
  double-approximate decodes, ``encode_minifloat`` (the f16-rounded zero
  included), ``minifloat_codebook``, ``encode_bfp``/``decode_bfp`` (scales
  of all-zero and subnormal groups included), ``quantize_fp4_two_step`` and
  ``pseudo_quantize``;
* ``quantize_tensor`` writes the JAX package's bytes for fp and bfp specs
  (nib4, nq42, byte storage; ``pad_n_to``, ``pad_k_to``; approximate
  codebooks), and refuses what JAX refuses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import AlignSpec as JAlign
from iron_weight_only_quant_tpu.config import FloatFormat as JFloat
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.formats import bfp as j_bfp
from iron_weight_only_quant_tpu.formats import int_codec as j_int
from iron_weight_only_quant_tpu.formats import minifloat as j_mf
from iron_weight_only_quant_tpu.formats import quantize_fp4_two_step as j_fp4
from iron_weight_only_quant_tpu.ops.qmatmul import dequantize_weight as j_dequant
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch import config as tcfg
from iron_weight_only_quant_tpu_torch.formats import bfp as t_bfp
from iron_weight_only_quant_tpu_torch.formats import fake_quantize, pseudo_quantize
from iron_weight_only_quant_tpu_torch.formats import minifloat as t_mf
from iron_weight_only_quant_tpu_torch.formats import quantize_fp4_two_step
from iron_weight_only_quant_tpu_torch.interop import spec_from_fields
from iron_weight_only_quant_tpu_torch.ops.qmatmul import dequantize_weight as t_dequant
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor
from test_formats import GOLDEN, _spec_for_key

GOLDEN_KEYS = [k for k in np.load(GOLDEN / "quant_linear.npz").files if k != "input"]
CUSTOM = {  # the cases of tests/test_formats.py::TestCustomAlignGolden
    "fp8_approx_custom": j_fp_spec("fp8", 4, 3, group_size=128, approximate=True,
                                   align=JAlign(hi_align_start=10, hi_align_exp_field=14,
                                                tail_pad_bits=2)),
    "fp8_approx_negpad": j_fp_spec("fp8", 4, 3, group_size=128, approximate=True,
                                   align=JAlign(hi_align_start=12, hi_align_exp_field=15,
                                                tail_pad_bits=-1)),
    "fp6_dapprox_negpad": j_fp_spec("fp6", 3, 2, group_size=64, approximate=True,
                                    double_approximate=True,
                                    align=JAlign(hi_align_start=3, hi_align_exp_field=6,
                                                 tail_pad_bits=-1)),
}
FORMATS = [(2, 1), (1, 2), (3, 2), (2, 3), (4, 3), (3, 4), (2, 5)]
FMT_IDS = [f"e{e}m{m}" for e, m in FORMATS]


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _exact(got: torch.Tensor, want) -> None:
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.numpy())
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ------------------------------------------------------------ golden fixtures

@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "quant_linear.npz")


@pytest.mark.parametrize("key", GOLDEN_KEYS)
def test_fake_quantize_matches_reference_golden(golden, key):
    # golden weights are [out, in]; the port's are [in, out]
    spec = spec_from_fields(_spec_for_key(key))
    ours = fake_quantize(torch.from_numpy(golden["input"]).t(), spec).t()
    np.testing.assert_array_equal(ours.numpy(), golden[key])


@pytest.mark.parametrize("key", list(CUSTOM))
def test_fake_quantize_matches_custom_align_golden(key):
    data = np.load(GOLDEN / "quant_linear_custom.npz")
    ours = fake_quantize(torch.from_numpy(data["input"]).t(), spec_from_fields(CUSTOM[key]))
    np.testing.assert_array_equal(ours.t().numpy(), data[key])


@pytest.mark.parametrize("key,kw", [("g128", dict(group_size=128)),
                                    ("g64", dict(group_size=64)),
                                    ("pt", dict(group_size=-1, per_tensor=True))],
                         ids=["g128", "g64", "pt"])
def test_fp4_two_step_matches_reference_golden(key, kw):
    """At the tolerance of tests/test_formats.py: the reference ran in fp16."""
    data = np.load(GOLDEN / "fp4_cpu.npz")
    ours = quantize_fp4_two_step(torch.from_numpy(data["input"].astype(np.float32)), **kw)
    ours16 = ours.numpy().astype(np.float16).astype(np.float32)
    want = data[key].astype(np.float32).reshape(ours16.shape)
    assert np.isclose(ours16, want, rtol=2e-3, atol=1e-4).mean() > 0.995


def test_fp4_two_step_matches_jax_exactly():
    x = _x((256, 256), seed=3, scale=0.1)
    for kw in (dict(group_size=128), dict(group_size=64), dict(group_size=-1, per_tensor=True)):
        _exact(quantize_fp4_two_step(_t(x), **kw), j_fp4(jnp.asarray(x), **kw))
    spec = tcfg.QuantSpec(fmt="fp4_e1m2", group_size=128)
    want = j_fp4(jnp.asarray(x).T, group_size=128).T
    _exact(fake_quantize(_t(x), spec), want)


# ------------------------------------------------------------------ codecs

def _normalized(fmt, seed):
    """Values across the format's range: subnormals, normals, exact zeros,
    exact codewords and values near the top (which must not carry)."""
    x = _x((4096,), seed=seed) * fmt.max_value / 3
    book = np.asarray(j_mf.minifloat_codebook(JFloat(fmt.exp_bits, fmt.mant_bits)))
    tiny = _x((512,), seed=seed + 1) * 2.0 ** (fmt.min_normal_exp - 1)
    x = np.concatenate([x, tiny, book, book * 0.999, [0.0, -0.0, fmt.max_value]])
    return np.clip(x, -fmt.max_value, fmt.max_value).astype(np.float32)


@pytest.mark.parametrize("em", FORMATS, ids=FMT_IDS)
def test_float_to_code_and_back_match_jax(em):
    jf, tf = JFloat(*em), tcfg.FloatFormat(*em)
    assert (tf.bias, tf.max_exp_field, tf.max_value, tf.min_normal_exp) == (
        jf.bias, jf.max_exp_field, jf.max_value, jf.min_normal_exp)
    x = _normalized(jf, seed=em[0] * 10 + em[1])
    codes = t_mf.float_to_code(_t(x), tf)
    _exact(codes, j_mf.float_to_code(jnp.asarray(x), jf))
    _exact(t_mf.code_to_float(codes, tf), j_mf.code_to_float(jnp.asarray(codes.numpy()), jf))
    _exact(torch.from_numpy(t_mf.minifloat_codebook(tf)), j_mf.minifloat_codebook(jf))


@pytest.mark.parametrize("em", FORMATS, ids=FMT_IDS)
def test_encode_minifloat_matches_jax(em):
    jf, tf = JFloat(*em), tcfg.FloatFormat(*em)
    g = _x((48, 128), seed=sum(em), scale=0.05)
    g[3] = 0.0  # an all-zero group: scale clamps, codes 0
    g[5, :7] = -1e-9  # negative values that round to a -0 code
    for sym in (True, False):
        got = t_mf.encode_minifloat(_t(g), tf, sym)
        want = j_mf.encode_minifloat(jnp.asarray(g), jf, sym)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                _exact(a, b)


@pytest.mark.parametrize("kind,em,align", [
    ("fp4", (2, 1), None), ("fp4", (1, 2), None), ("fp6", (3, 2), None),
    ("fp6", (2, 3), None), ("fp8", (4, 3), None), ("fp8", (3, 4), None),
    ("fp8", (4, 3), JAlign(10, 14, 2, True, True, True)),
    ("fp8", (4, 3), JAlign(12, 15, -1, False, False, False)),
    ("fp6", (3, 2), JAlign(3, 6, -1, True, False, True)),
], ids=["fp4e2m1", "fp4e1m2", "fp6e3m2", "fp6e2m3", "fp8e4m3", "fp8e3m4",
        "fp8_custom", "fp8_negpad_plain", "fp6_negpad_nolimit"])
def test_approximate_decodes_match_jax(kind, em, align):
    """Every codeword through the aligned decode and through the
    double-approximate decode (int8 wrap included), on a code matrix whose
    transposed runs of 4 mix exponents."""
    jf, tf = JFloat(*em), tcfg.FloatFormat(*em)
    ja = align if align is not None else JSpec(
        fmt="fp", bits=jf.total_bits, float_format=jf).effective_align(kind)
    ta = spec_from_fields(JSpec(fmt="fp", bits=jf.total_bits, float_format=jf,
                                align=ja)).align
    n = 1 << jf.total_bits
    codes = np.random.default_rng(n).integers(0, n, size=(64, 96)).astype(np.int32)
    codes.reshape(-1)[:n] = np.arange(n)  # every codeword at least once
    _exact(t_mf.decode_minifloat_aligned(_t(codes), tf, ta),
           j_mf.decode_minifloat_aligned(jnp.asarray(codes), jf, ja))
    _exact(t_mf.decode_minifloat_double_approx(_t(codes), tf, ta),
           j_mf.decode_minifloat_double_approx(jnp.asarray(codes), jf, ja))
    _exact(torch.from_numpy(t_mf.minifloat_codebook(tf, ta)),
           j_mf.minifloat_codebook(jf, ja))


@pytest.mark.parametrize("bits", [4, 5, 6, 8, 12])
def test_bfp_codec_matches_jax(bits):
    """Scales of every shared exponent, including the all-zero group's
    (exp 0, where the JAX package's ``exp2`` is not an exact power of 2)."""
    g = _x((40, 64), seed=bits, scale=0.05)
    g[0] = 0.0
    g[1] *= 1e-4  # fp16 subnormals
    g[2] *= 1e3
    g[3:35] *= (2.0 ** np.arange(-16, 16))[:, None].astype(np.float32)
    codes, exp_block = t_bfp.encode_bfp(_t(g), bits)
    jc, je = j_bfp.encode_bfp(jnp.asarray(g), bits)
    _exact(codes, jc)
    _exact(exp_block, je)
    _exact(t_bfp.decode_bfp(codes, exp_block, bits), j_bfp.decode_bfp(jc, je, bits))
    e = np.arange(-40, 41, dtype=np.int32)
    _exact(t_mf.exp2(_t(e)), jnp.exp2(jnp.asarray(e, jnp.float32)))


@pytest.mark.parametrize("kw", [dict(bits=8), dict(bits=4, zero_point=False),
                                dict(bits=4, group_size=128),
                                dict(bits=8, zero_point=False, per_tensor=True)],
                         ids=["b8_zp", "b4_sym", "b4_g128", "b8_pt_sym"])
def test_pseudo_quantize_matches_jax(kw):
    x = _x((6, 256), seed=9, scale=2.0)
    _exact(pseudo_quantize(_t(x), **kw), j_int.pseudo_quantize(jnp.asarray(x), **kw))


# ------------------------------------------------------------------ RTN

RTN_CASES = [  # (id, JAX spec, quantize_tensor kwargs, weight shape)
    ("fp4_e2m1_g128_asym", j_fp_spec("fp4", 2, 1, group_size=128, symmetric=False),
     {}, (256, 96)),
    ("fp4_e2m1_g128_sym", j_fp_spec("fp4", 2, 1, group_size=128), {}, (256, 96)),
    ("fp4_e1m2_g64_sym", j_fp_spec("fp4", 1, 2, group_size=64), {}, (256, 96)),
    ("fp4_e2m1_perchannel_asym", j_fp_spec("fp4", 2, 1, group_size=-2, symmetric=False),
     {}, (256, 96)),
    ("fp4_e2m1_pad_n_512_pad_k_512", j_fp_spec("fp4", 2, 1, group_size=128, symmetric=False),
     dict(pad_n_to=512, pad_k_to=512), (384, 300)),
    ("fp4_approx", j_fp_spec("fp4", 2, 1, group_size=128, approximate=True), {}, (256, 96)),
    ("fp6_e3m2_nq42", j_fp_spec("fp6", 3, 2, group_size=128), {}, (512, 96)),
    ("fp6_e2m3_byte_perchannel", j_fp_spec("fp6", 2, 3, group_size=-2),
     {}, (134, 96)),  # K % 4 != 0: byte storage
    ("fp4_e2m1_k_shards_2", j_fp_spec("fp4", 2, 1, group_size=64), dict(k_shards=2),
     (256, 96)),
    ("fp8_e4m3_g128_sym", j_fp_spec("fp8", 4, 3, group_size=128), {}, (256, 96)),
    ("fp8_e4m3_perchannel_asym", j_fp_spec("fp8", 4, 3, group_size=-2, symmetric=False),
     {}, (256, 96)),
    ("fp8_e3m4_pad_n_512_pad_k_512", j_fp_spec("fp8", 3, 4, group_size=128),
     dict(pad_n_to=512, pad_k_to=512), (384, 200)),
    ("fp8_e2m5_side_f16", j_fp_spec("fp8", 2, 5, group_size=128, symmetric=False),
     dict(side_dtype="float16"), (256, 96)),
    ("fp8_approx", j_fp_spec("fp8", 4, 3, group_size=128, approximate=True), {}, (256, 96)),
    ("bfp4_g128", JSpec(fmt="bfp", bits=4, group_size=128), {}, (256, 96)),
    ("bfp8_g128_pad_n_512_pad_k_512", JSpec(fmt="bfp", bits=8, group_size=128),
     dict(pad_n_to=512, pad_k_to=512), (384, 300)),
    ("bfp4_g64_pad_n_512", JSpec(fmt="bfp", bits=4, group_size=64),
     dict(pad_n_to=512), (256, 300)),
    ("bfp5_g128", JSpec(fmt="bfp", bits=5, group_size=128), {}, (256, 96)),
]


@pytest.mark.parametrize("case", RTN_CASES, ids=[c[0] for c in RTN_CASES])
def test_rtn_bytes_match_jax(case):
    _, jspec, kwargs, shape = case
    w = _x(shape, seed=len(case[0]), scale=0.05)
    jk, tk = dict(kwargs), dict(kwargs)
    if "side_dtype" in kwargs:
        jk["side_dtype"] = getattr(jnp, kwargs["side_dtype"])
        tk["side_dtype"] = getattr(torch, kwargs["side_dtype"])
    jq = j_quantize(jnp.asarray(w), jspec, **jk)
    tq = quantize_tensor(torch.from_numpy(w), spec_from_fields(jspec), **tk)
    assert (tq.shape, tq.mode, tq.k_shards, tq.n_pad, tq.k_pad) == (
        jq.shape, jq.mode, jq.k_shards, jq.n_pad, jq.k_pad)
    for name in ("qweight", "scales", "zeros", "codebook"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _exact(a, b)
    _exact(t_dequant(tq), j_dequant(jq))


def test_rtn_refusals_match_jax():
    w = torch.zeros((128, 64))
    for spec in (tcfg.QuantSpec(fmt="fp4_e1m2", group_size=128),
                 tcfg.fp_spec("fp8", 4, 3, group_size=128, approximate=True,
                              double_approximate=True)):
        with pytest.raises(NotImplementedError):
            quantize_tensor(w, spec)
    # E=1 formats decode single-approx, so they pack
    qt = quantize_tensor(w, tcfg.fp_spec("fp4", 1, 2, group_size=128, approximate=True,
                                         double_approximate=True))
    assert qt.mode == "lut" and qt.zeros is None


def test_ported_config_matches_jax():
    import iron_weight_only_quant_tpu.config as jcfg

    for name in ("FP4_E2M1", "FP4_E1M2", "FP6_E3M2", "FP6_E2M3", "FP8_E4M3",
                 "FP8_E3M4", "FP8_E2M5"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert (t.exp_bits, t.mant_bits, t.max_value) == (j.exp_bits, j.mant_bits, j.max_value)
    assert {k: vars(v) for k, v in tcfg.DEFAULT_ALIGN.items()} == {
        k: vars(v) for k, v in jcfg.DEFAULT_ALIGN.items()}
    jax_spec = jcfg.fp_spec("fp6", 3, 2, group_size=64)
    assert tcfg.fp_spec("fp6", 3, 2, group_size=64) == spec_from_fields(jax_spec)
