"""The bf16 routes of ``w8_matmul`` and ``lut8_matmul`` against the JAX
package and the kernels' own tables, on the CPU.

The bf16-x calls of both kernels, and of ``w8_matmul_prenorm``, run as the
byte layouts of the bf16 family of ``csrc/wa_slab_mma.cuh``: ``kByteB``
(affine, the stored byte read as int8; the prenorm form with its row factor
in the epilogue) and ``kLut8B`` (byte minifloats, stored as code - 128).
What the kernels compute is held to the plain versions on the card
(``tests/test_torch_cuda.py -k byte_mma``).  Here:

* a numpy model of each decode, over all 256 byte values in every byte of a
  word: ``byte_codes_bf16`` (the low seven bits under bf16's exponent byte
  of 128, plus the sign bit under that of -128, in one bf16x2 fma) gives
  the JAX ``bitcast(qw, int8)`` exactly; ``codes_bf16`` on the byte XORed
  with 0x80 gives the JAX ``_minifloat_decode(bitcast(qw, int8) + 128)`` in
  bf16, and the port's ``code_to_float``, for every format of one to seven
  exponent and mantissa bits that ``lut8`` takes;
* a numpy model of each group epilogue (``acc += part*s - xsum*(s*z)``;
  ``acc += part*s (+ xsum*z)``) equals the JAX ``_int8_kernel`` and
  ``_lut8_kernel`` (interpret mode) at bf16 and f32 x on g128 asymmetric
  and per-channel symmetric W8 and on fp8 E4M3 g128 symmetric and
  per-channel asymmetric artifacts, and so does the port's plain version;
  the affine model times ``rsqrt(sum(x^2) / K + eps)`` applied to its f32
  sum equals the JAX ``_int8_kernel_prenorm``;
* dispatch: bf16 W8 calls ``iwoq_w8_matmul_mma``, with a pre-norm
  ``iwoq_w8_matmul_prenorm_mma`` (no copy of x; its scratch holds the
  splits' sums of x^2 after the partials); bf16 lut8 calls
  ``iwoq_lut8_matmul_mma`` with
  and without a pre-norm (then in its row pass, on a copy of x); f32 x, the
  byte-per-code fp6 (K % 4 != 0) and shapes outside the route's rule take
  the CUDA-core entry points; stacked calls read their layer; each counts
  under its kernel's name (the wrapper called on CPU tensors with a
  recording stand-in for the library);
* the byte layouts' tiles and scratch.

That the routes' split plans cover the slab rows once is held, with the
other bf16 layouts', by ``test_bf16_split_plans_cover_every_row_once`` in
``tests/test_torch_lut_mma.py``.
"""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iron_weight_only_quant_tpu.config import PER_CHANNEL as J_PER_CHANNEL
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, QuantSpec, fp_spec
from iron_weight_only_quant_tpu_torch.formats.minifloat import code_to_float
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
U32 = np.uint32
# every (E, M) of a byte minifloat lut8 takes: 1 + E + M <= 8, E >= 1
LUT8_FORMATS = [(e, m) for e in range(1, 8) for m in range(0, 8 - e)]


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


# ------------------------------------------------------------ the decodes

def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)``: byte n of the result is byte (nibble n of
    sel) of y:x."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(v.shape, dtype=np.uint64)
    for n in range(4):
        idx = (sel >> (4 * n)) & 7
        out |= ((v >> np.uint64(8 * idx)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def _bf16_fma(a, b, c):
    """``bf16x2_fma(a, b, c)`` where every result is exact in bf16 (the
    model checks that no rounding happened)."""
    out = np.zeros_like(a)
    for h in (0, 16):
        half = lambda w: ((((w >> U32(h)) & U32(0xFFFF)) << U32(16))  # noqa: E731
                          .view(np.float32).astype(np.float64))
        f = (half(a) * half(b) + half(c)).astype(np.float32)
        assert np.array_equal(f.astype(np.float64), half(a) * half(b) + half(c))
        assert np.array_equal(f.view(U32) & U32(0xFFFF), np.zeros_like(a))
        out |= (f.view(U32) >> U32(16)) << U32(h)
    return out


def _byte_codes_bf16(c):
    """``byte_codes_bf16``: (c & 0x7F7F7F7F) under the high byte 0x43 (128 +
    b & 127), (c & 0x80808080) under 0xC3 (-128 or -256), added by one
    bf16x2 fma with 1.0: pairs (0, 1) and (2, 3)."""
    m, sg = c & U32(0x7F7F7F7F), c & U32(0x80808080)
    hi, neg, one = (np.full_like(c, v) for v in (0x43434343, 0xC3C3C3C3, 0x3F803F80))
    return tuple(_bf16_fma(_byte_perm(m, hi, sel), one, _byte_perm(sg, neg, sel))
                 for sel in (0x5140, 0x7362))


def _bf16_mul(p, mult):
    """``bf16x2_mul``: each bf16 half times ``mult`` (a power of two), in
    f32 (exact here, subnormal inputs included), back to bf16."""
    out = np.zeros_like(p)
    for h in (0, 16):
        f = (((p >> U32(h)) & U32(0xFFFF)) << U32(16)).view(np.float32) * np.float32(mult)
        out |= (f.view(U32) >> U32(16)) << U32(h)
    return out


def _codes_bf16(c, exp_bits, mant_bits):
    """``codes_bf16`` of csrc/wa_slab_mma.cuh on words of four codes."""
    sh, ssh = 7 - mant_bits, 7 - (exp_bits + mant_bits)
    mlo = U32(((0xFF << sh) & 0xFF) * 0x01010101)
    mhi = U32(((1 << (exp_bits - 1)) - 1) * 0x01010101)
    lo = (c << U32(sh)) & mlo
    hi = ((c >> U32(8 - sh)) & mhi) | ((c << U32(ssh)) & U32(0x80808080))
    mult = 2.0 ** (127 - ((1 << (exp_bits - 1)) - 1))
    return (_bf16_mul(_byte_perm(lo, hi, 0x5140), mult),
            _bf16_mul(_byte_perm(lo, hi, 0x7362), mult))


def _lut8_codes_bf16(words, exp_bits, mant_bits):
    """The ``kLut8B`` decode: the stored bytes (code - 128) XORed with 0x80,
    then ``codes_bf16``."""
    return _codes_bf16(words ^ U32(0x80808080), exp_bits, mant_bits)


def _values(pairs):
    """bf16 pairs (0, 1), (2, 3) -> the four values in byte order, f32."""
    halves = [(p >> U32(sh)) & U32(0xFFFF) for p in pairs for sh in (0, 16)]
    return [(h << U32(16)).view(np.float32) for h in halves]


def _every_byte_in_every_position():
    """(stored bytes [64, 4], the words of four of them) for each rotation:
    every byte value once in each byte of a word."""
    b = np.arange(256, dtype=np.uint8)
    for rot in range(4):
        qw = np.roll(b.reshape(-1, 4), rot, axis=1).copy()
        yield qw, qw.view(U32).reshape(-1)


def test_byte_decode_gives_the_jax_int8_codes_for_every_byte():
    """Every byte value in every byte of a word: the JAX ``bitcast(qw,
    int8)`` (the stored byte read as int8, code - 128), an exact bf16."""
    for qw, words in _every_byte_in_every_position():
        got = _values(_byte_codes_bf16(words))
        want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(qw), jnp.int8)
                          .astype(jnp.float32))
        for pos in range(4):
            np.testing.assert_array_equal(got[pos], want[:, pos])


@pytest.mark.parametrize("exp_bits,mant_bits", LUT8_FORMATS,
                         ids=[f"e{e}m{m}" for e, m in LUT8_FORMATS])
def test_lut8_decode_gives_the_jax_values_for_every_byte(exp_bits, mant_bits):
    """Every stored byte whose code fits the format (code - 128 for codes
    below ``2**(1 + E + M)``), in every byte of a word: the bf16 of the JAX
    ``_minifloat_decode(bitcast(qw, int8) + 128, E, M, bfloat16)``, and the
    port's ``code_to_float``.  That codec takes its powers of two from the
    formats' ``exp2`` (``exp(log(2) * e)`` in f32, as the JAX package's),
    exact for |e| < 13: there (every fp8 format of the zoo, E <= 4) it is
    equal, beyond within that product's rounding, ``|e| * ln 2 * 2**-24``
    relative (below 2**-18 for |e| <= 64)."""
    bits = 1 + exp_bits + mant_bits
    fmt = fp_spec(f"fp{bits}", exp_bits, mant_bits).float_format
    for qw, words in _every_byte_in_every_position():
        got = _values(_lut8_codes_bf16(words, exp_bits, mant_bits))
        codes = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(qw), jnp.int8)
                           .astype(jnp.int32)) + 128
        want = np.asarray(j_dm._minifloat_decode(jnp.asarray(codes), exp_bits, mant_bits,
                                                 jnp.bfloat16).astype(jnp.float32))
        port = code_to_float(torch.from_numpy(codes).to(torch.int32), fmt).numpy()
        fits = codes < (1 << bits)
        exact = np.abs(((codes >> mant_bits) & ((1 << exp_bits) - 1)) - fmt.bias) < 13
        for pos in range(4):
            f, e = fits[:, pos], fits[:, pos] & exact[:, pos]
            np.testing.assert_array_equal(got[pos][f], want[f, pos])
            np.testing.assert_array_equal(got[pos][e], port[e, pos])
            np.testing.assert_allclose(got[pos][f], port[f, pos], rtol=2.0**-18, atol=0)


# ------------------------------------------------------------ the epilogues

EPILOGUE_CASES = {  # id: (JAX spec, port spec) at K = 512, N = 256
    "w8_g128_asym": JSpec(fmt="int", bits=8, group_size=128, symmetric=False),
    "w8_perchannel_sym": JSpec(fmt="int", bits=8, group_size=J_PER_CHANNEL, symmetric=True),
    "fp8_e4m3_g128_sym": j_fp_spec("fp8", 4, 3, group_size=128),
    "fp8_e4m3_perchannel_asym": j_fp_spec("fp8", 4, 3, group_size=J_PER_CHANNEL,
                                          symmetric=False),
}


@functools.lru_cache(maxsize=None)
def _artifact(case):
    """One tiny artifact a case (K = 512, N = 256), quantized by JAX, in
    both packages."""
    jq = j_quantize(jnp.asarray(_x((512, 256), seed=0, scale=0.05)), EPILOGUE_CASES[case])
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _route_model(x, qw, s, z, g, fmt):
    """The kByteB (``fmt`` None) or kLut8B kernel in numpy: the codes
    decoded to their bf16 values; per group the products exact, summed in
    f32 (the MMA's f32 sums), ``acc += part * s + xsum * zc`` with ``zc =
    -(s * z)`` (affine) or ``z`` (LUT, where the artifact has zeros) and
    ``xsum`` the f32 sum of the group's x.  x is [M, K] f32 (bf16 values
    where x is bf16); sides [rows or 1, N or 1]."""
    k, n = qw.shape
    words = qw.T.copy().view(U32).reshape(-1)  # [N, K/4]: four rows of a channel a word
    pairs = _byte_codes_bf16(words) if fmt is None else _lut8_codes_bf16(words, *fmt)
    vals = np.stack(_values(pairs), axis=-1).reshape(n, k).T
    rows = k // g
    s = np.broadcast_to(s, (rows, n))
    z = None if z is None else np.broadcast_to(z, (rows, n))
    acc = np.zeros((x.shape[0], n), np.float32)
    xd = x.astype(np.float64)
    for r in range(rows):
        sl = slice(r * g, (r + 1) * g)
        part = (xd[:, sl] @ vals[sl].astype(np.float64)).astype(np.float32)
        acc = acc + part * s[r]
        if z is not None:
            xsum = xd[:, sl].sum(1).astype(np.float32)
            zc = z[r] if fmt is not None else -(s[r] * z[r])
            acc = acc + xsum[:, None] * zc
    return acc


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(EPILOGUE_CASES))
def test_route_model_equals_jax_int8_and_lut8_kernels(case, dtype):
    """The model equals ``_int8_kernel`` or ``_lut8_kernel`` (interpret
    mode), and so does the port's plain version: at the Pallas tests'
    tolerance for f32 x, within 1e-2 of the largest output for bf16 x (the
    JAX kernel rounds its output to bf16)."""
    jq, tq = _artifact(case)
    assert j_dm._layout_supported(jq, jq.scales.shape[0]) and dm.packed_bits(tq) == 8
    x = _x((6, 512), seed=7, scale=2.0)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_dm.fused_quantized_matmul(xj, jq, interpret=True), dtype=np.float32)
    xr = np.array(xj.astype(jnp.float32))  # x as the kernel reads it
    qw = np.asarray(jq.qweight)
    s = np.asarray(jq.scales, np.float32)
    z = None if jq.zeros is None else np.asarray(jq.zeros, np.float32)
    fmt = (tq.spec.float_format.exp_bits, tq.spec.float_format.mant_bits) \
        if tq.mode == "lut" else None
    got = _route_model(xr, qw, s, z, 512 // max(1, s.shape[0]), fmt)
    xt = torch.from_numpy(xr).to(torch.float32 if dtype == np.float32 else torch.bfloat16)
    dm.reset_counts()
    plain = dm.fused_quantized_matmul(xt, tq).float().numpy()
    assert dm.PLAIN_CALLS[dm.kernel_name(tq)] == 1 == sum(dm.PLAIN_CALLS.values())
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(plain, want, **TOL)
    else:
        for y in (got, plain):
            assert np.abs(y - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["w8_g128_asym", "w8_perchannel_sym"])
def test_prenorm_route_model_equals_jax_int8_kernel_prenorm(case, dtype):
    """The prenorm form of the route: the affine model's f32 sum times ``r =
    rsqrt(sum(x^2) / K + eps)`` of the raw x (not x normalized first), as
    the kernel's epilogue or its K-split reduce applies it, equals
    ``_int8_kernel_prenorm`` (interpret mode), and so does the port's plain
    version: at the Pallas tests' tolerance for f32 x, within 1e-2 of the
    largest output for bf16 x."""
    jq, tq = _artifact(case)
    assert dm.prenorm_supported(tq) and dm.kernel_name(tq, EPS) == dm.W8_PRENORM
    x = _x((6, 512), seed=8, scale=2.0)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_dm.fused_quantized_matmul(xj, jq, pre_norm=EPS, interpret=True),
                      dtype=np.float32)
    xr = np.array(xj.astype(jnp.float32))  # x as the kernel reads it
    s = np.asarray(jq.scales, np.float32)
    acc = _route_model(xr, np.asarray(jq.qweight), s, np.asarray(jq.zeros, np.float32),
                       512 // s.shape[0], None)
    r = np.float32(1) / np.sqrt((xr * xr).sum(1, dtype=np.float32) / np.float32(512)
                                + np.float32(EPS))
    got = acc * r[:, None]
    xt = torch.from_numpy(xr).to(torch.float32 if dtype == np.float32 else torch.bfloat16)
    dm.reset_counts()
    plain = dm.fused_quantized_matmul(xt, tq, pre_norm=EPS).float().numpy()
    assert dm.PLAIN_CALLS[dm.W8_PRENORM] == 1 == sum(dm.PLAIN_CALLS.values())
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(plain, want, **TOL)
    else:
        for y in (got, plain):
            assert np.abs(y - want).max() <= 1e-2 * np.abs(want).max()


# ---------------------------------------------------------------- dispatch

class _Library:
    """A stand-in for a kernel library: records each entry point's symbol
    and arguments, returns success."""

    def __init__(self):
        self.calls = []

    def load(self, name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls.append((name, symbol, args))
            return 0
        return self, fn


@pytest.fixture()
def card_free_launch(monkeypatch):
    """``dm._launch`` on CPU tensors: the library, the SM count, the device
    context and the stream are stand-ins; the wrapper's checks, plan and
    scratch are its own."""
    lib = _Library()
    monkeypatch.setattr(dm, "_load_fn", lib.load)
    monkeypatch.setattr(dm, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    dm.reset_counts()
    return lib


def _launch(qt, x, pre_norm=None, layer=None):
    """The wrapper's launch, as fused_quantized_matmul(_stacked) calls it."""
    x2 = dm._prep_x(x, qt)
    fmt = dm._lut_format(qt)
    if layer is None:
        return dm._launch(8, pre_norm, x2, qt.qweight, qt.scales, qt.zeros, qt.scales.shape[0],
                          qt.shape[0], qt.shape[1], None, fmt)
    return dm._launch(8, pre_norm, x2, qt.qweight[layer], qt.scales[layer],
                      None if qt.zeros is None else qt.zeros[layer],
                      qt.scales.shape[1] - qt.side_pad, qt.shape[0], qt.shape[1], None, fmt)


DISPATCH = {  # id: (spec, K, N, quantize_tensor kwargs)
    "w8_g128_asym": (QuantSpec(fmt="int", bits=8, group_size=128, symmetric=False), 1024, 256,
                     {}),
    "w8_perchannel_sym": (QuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL, symmetric=True),
                          1088, 256, {}),
    "bfp8": (QuantSpec(fmt="bfp", bits=8, group_size=128), 1408, 300, dict(pad_n_to=512)),
    "w8_kpad": (QuantSpec(fmt="int", bits=8, group_size=128, symmetric=False), 384, 256,
                dict(pad_k_to=512)),
    "fp8_e4m3_g128_sym": (fp_spec("fp8", 4, 3, group_size=128), 1024, 256, {}),
    "fp8_e4m3_perchannel_asym": (fp_spec("fp8", 4, 3, group_size=PER_CHANNEL, symmetric=False),
                                 1088, 256, {}),
    "fp5_e2m2_g64_sym": (fp_spec("fp5", 2, 2, group_size=64), 512, 256, {}),
}


def _quantized(case, seed=0):
    spec, k, n, kw = DISPATCH[case]
    return quantize_tensor(torch.from_numpy(_x((k, n), seed=seed, scale=0.05)), spec, **kw)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 64, 256])
@pytest.mark.parametrize("case", list(DISPATCH))
def test_bf16_byte_calls_take_their_route_and_f32_the_cuda_core_kernel(card_free_launch, case,
                                                                      m, pre_norm):
    """bf16 x: ``iwoq_w8_matmul_mma``, ``iwoq_w8_matmul_prenorm_mma`` or
    ``iwoq_lut8_matmul_mma`` on the layout's plan, the format widths for
    lut8 (0, 0 for W8); a lut8 pre-norm in the route's row pass (norm 1, a
    scratch copy of x), a W8 pre-norm in the epilogue (norm 1, no copy).
    f32 x: ``iwoq_<name>``.  One launch each under the kernel's name."""
    qt = _quantized(case)
    lut = qt.mode == "lut"
    name = dm.kernel_name(qt, pre_norm)
    assert dm.packed_bits(qt) == 8 and name == (
        dm.LUT8 if lut else dm.W8 if pre_norm is None else dm.W8_PRENORM)
    assert name in dm.BF16_MMA and dm.bf16_mma_route(qt, torch.bfloat16, pre_norm)
    assert not dm.bf16_mma_route(qt, torch.float32, pre_norm)
    ks, n = qt.k_stored, qt.qweight.shape[1]
    x = torch.from_numpy(_x((m, qt.shape[0]), seed=2))
    _launch(qt, x.to(torch.bfloat16), pre_norm)
    (lib_name, symbol, args), = card_free_launch.calls
    layout = "lut8_bf16" if lut else "byte_bf16"
    assert dm.BF16_MMA[name] == layout and (lib_name, symbol) == (name, f"iwoq_{name}_mma")
    kc, splits = dm.plan_slab_splits(m, n, ks, layout, 132)
    assert args[1:6] == (ks, 0, qt.shape[0], int(pre_norm is not None), pre_norm or 0.0)
    assert (args[13] is None) == (pre_norm is None or not lut)  # the row pass's copy
    fmt = qt.spec.float_format if lut else None
    assert args[19:25] == (ks, dm._group_size(qt, qt.scales.shape[0]), kc, splits,
                           fmt.exp_bits if lut else 0, fmt.mant_bits if lut else 0)
    assert (args[10] is None) == (qt.zeros is None)
    card_free_launch.calls.clear()
    if lut and pre_norm is not None:  # f32 x: normalized in torch first (no kernel takes it)
        _launch(qt, dm._rms_nogamma(x, pre_norm))
    else:
        _launch(qt, x, pre_norm)
    (lib_name, symbol, args), = card_free_launch.calls
    assert (lib_name, symbol) == (name, f"iwoq_{name}")
    assert dm.LAUNCHES[name] == 2 == sum(dm.LAUNCHES.values())


def _stacked(qts):
    """Layer-stacked artifact of ``qts``, side info padded by 2 rows."""
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 2))  # noqa: E731
    return qts[0].replace(qweight=torch.stack([q.qweight for q in qts]),
                          scales=torch.stack([pad(q.scales) for q in qts]),
                          zeros=torch.stack([pad(q.zeros) if q.zeros.shape[0] > 1 else q.zeros
                                             for q in qts]), side_pad=2)


@pytest.mark.parametrize("case", ["w8_g128_asym", "fp8_e4m3_perchannel_asym"])
def test_stacked_byte_calls_take_the_route_at_their_layer(card_free_launch, case):
    """A layer-stacked artifact (side info padded by 2 rows): the route
    reads layer 1's weights and sides in place."""
    st = _stacked([_quantized(case, seed=i) for i in range(2)])
    assert dm.kernel_supported_stacked(st) and dm.bf16_mma_route(st, torch.bfloat16)
    x = torch.from_numpy(_x((8, st.shape[0]), seed=3)).to(torch.bfloat16)
    _launch(st, x, layer=1)
    (name, symbol, args), = card_free_launch.calls
    assert symbol == f"iwoq_{dm.kernel_name(st)}_mma"
    assert args[6] == st.qweight[1].data_ptr() and args[7] == st.scales[1].data_ptr()
    assert args[13] is None and dm.LAUNCHES[name] == 1


def test_unaligned_x_is_copied_raw(card_free_launch):
    """x 2 bytes off a 16-byte boundary: the row pass copies it (x_copy 1,
    scratch for the copy), unnormalized without a pre-norm."""
    for case in ("w8_g128_asym", "fp8_e4m3_g128_sym"):
        qt = _quantized(case)
        x = torch.empty((8 * 1024 + 1,), dtype=torch.bfloat16)[1:].view(8, 1024)
        x.copy_(torch.from_numpy(_x((8, 1024), seed=4)))
        assert dm.x_needs_copy(x, 1024)
        _launch(qt, x)
    for _, symbol, args in card_free_launch.calls:
        assert symbol.endswith("_mma") and args[2:5] == (1, 1024, 0) and args[13] is not None


@pytest.mark.parametrize("layer", [None, 1], ids=["flat", "stacked"])
@pytest.mark.parametrize("m", [1, 8, 64, 256])
def test_bf16_w8_prenorm_calls_take_the_route_with_the_epilogue_norm(card_free_launch,
                                                                    monkeypatch, m, layer):
    """bf16 ``w8_matmul_prenorm``, flat and stacked at its layer:
    ``iwoq_w8_matmul_prenorm_mma`` on the byte_bf16 plan, norm 1, no copy
    of x, and ``ws`` of ``splits*M*N`` partials then ``splits*M`` sums of
    x^2; an unaligned x is copied raw (norm 1 still); f32 x takes
    ``iwoq_w8_matmul_prenorm``.  Each counts as one ``w8_matmul_prenorm``
    launch."""
    sizes = []
    real = torch.empty

    def empty(*a, **kw):  # the f32 scratch the wrapper allocates: ws
        t = real(*a, **kw)
        if kw.get("dtype") == torch.float32 and t.dim() == 1:
            sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", empty)
    qts = [_quantized("w8_g128_asym", seed=i) for i in range(2)]
    qt = qts[0] if layer is None else _stacked(qts)
    ks, n = qts[0].k_stored, qts[0].qweight.shape[1]
    x = torch.from_numpy(_x((m, ks), seed=6)).to(torch.bfloat16)
    _launch(qt, x, EPS, layer)
    (name, symbol, args), = card_free_launch.calls
    kc, splits = dm.plan_slab_splits(m, n, ks, "byte_bf16", 132)
    assert (name, symbol) == (dm.W8_PRENORM, "iwoq_w8_matmul_prenorm_mma")
    assert args[1:6] == (ks, 0, ks, 1, EPS) and args[13] is None
    assert args[19:25] == (ks, 128, kc, splits, 0, 0)
    assert sizes == [splits * m * n + splits * m]
    if layer is not None:
        assert args[6] == qt.qweight[1].data_ptr() and args[7] == qt.scales[1].data_ptr()
    xu = real((m * ks + 1,), dtype=torch.bfloat16)[1:].view(m, ks)
    xu.copy_(x)
    assert dm.x_needs_copy(xu, ks)
    _launch(qt, xu, EPS, layer)
    assert card_free_launch.calls[-1][1] == "iwoq_w8_matmul_prenorm_mma"
    assert card_free_launch.calls[-1][2][2:5] == (1, ks, 1)  # copied, raw
    assert card_free_launch.calls[-1][2][13] is not None
    _launch(qt, x.float(), EPS, layer)
    assert card_free_launch.calls[-1][1] == "iwoq_w8_matmul_prenorm"
    assert dm.LAUNCHES[dm.W8_PRENORM] == 3 == sum(dm.LAUNCHES.values())


@pytest.mark.parametrize("bits", [6, 8])
def test_byte_calls_outside_the_route_rule_stay_on_the_cuda_core_kernels(card_free_launch,
                                                                         bits):
    """Byte-per-code fp6 (K = 510: K % 4 != 0 keeps it off the nq42 layout)
    and a per-channel K = 1030 W8 or fp8 artifact: 510 and 1030 slab rows,
    no multiple of 4; bf16 x takes the CUDA-core kernel, with and without a
    pre-norm (lut8's in torch first, as for f32 x)."""
    if bits == 6:
        specs = [(fp_spec("fp6", 3, 2, group_size=PER_CHANNEL, symmetric=False), 510)]
    else:
        specs = [(QuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL, symmetric=False), 1030),
                 (fp_spec("fp8", 4, 3, group_size=PER_CHANNEL), 1030)]
    want = []
    for spec, k in specs:
        qt = quantize_tensor(torch.from_numpy(_x((k, 64), scale=0.05)), spec)
        assert dm.packed_bits(qt) == 8 and dm.kernel_supported(qt)
        for pre_norm in (None, EPS):
            assert not dm.bf16_mma_route(qt, torch.bfloat16, pre_norm)
            x = torch.from_numpy(_x((8, k), seed=5)).to(torch.bfloat16)
            if qt.mode == "lut" and pre_norm is not None:
                _launch(qt, dm._rms_nogamma(x, pre_norm))  # fused_quantized_matmul's order
            else:
                _launch(qt, x, pre_norm)
            want.append(f"iwoq_{dm.kernel_name(qt, pre_norm)}")
    assert [c[1] for c in card_free_launch.calls] == want
    assert all(not s.endswith("_mma") for s in want)


def test_byte_tiles_and_scratch():
    """Decode: the int8 byte tile (8 tokens, 128 channels, four parts);
    beyond: 64 tokens, the eight warps on the one slab, one part, 256
    channels.  The scratch is the bf16 copy of x, padded to 32 rows; the
    affine byte plan never starts a partial round, the LUT byte plan
    rounds."""
    for layout in ("byte_bf16", "lut8_bf16"):
        assert dm.SLAB_TILES[layout][0] == 1
        assert dm.slab_tile(8, layout) == dm.slab_tile(8, "byte") == (8, 128, 4)
        assert dm.slab_tile(9, layout) == dm.slab_tile(256, layout) == (64, 256, 1)
        assert dm.bf16_mma_scratch_bytes(3, 1088, layout) == 2 * 3 * 1088
        assert dm.bf16_mma_scratch_bytes(3, 1000, layout) == 2 * 3 * 1024
    assert "byte_bf16" in dm.SLAB_WHOLE_ROUNDS and "lut8_bf16" not in dm.SLAB_WHOLE_ROUNDS
    assert dm.plan_slab_splits(8, 12288, 4096, "lut8_bf16", 132) == (1408, 3)
    assert dm.plan_slab_splits(8, 12288, 4096, "byte_bf16", 132) == (2048, 2)
