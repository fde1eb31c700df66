"""The bf16 route of ``w4_matmul`` and ``w4_matmul_prenorm`` against the JAX
package and the kernel's own tables, on the CPU.

The bf16-x calls of both kernels run as the affine nib4 layout (``kNib4B``)
of the bf16 family of ``csrc/wa_slab_mma.cuh``; the prenorm form keeps its
row factor in the epilogue.  What the kernel computes is held to the plain
versions on the card (``tests/test_torch_cuda.py -k w4_mma``).  Here:

* a numpy model of the ``kNib4B`` decode (a mask for the low codes; a shift
  and a mask with the flip undone for the high ones; ``prmt`` under bf16's
  exponent byte of 128; one bf16x2 subtraction of 128), over all 256 byte
  values in every byte of a word, gives the exact bf16 of the JAX ``lo``
  code and of the logical high code ``(hi + 128) / 16``;
* a numpy model of the group epilogue (per group ``acc += part*s -
  xsum*(s*z)`` on the decoded codes; the prenorm form's row factor applied
  to the f32 sum, not to a copy of x) equals the JAX ``_int4_kernel`` and
  ``_int4_kernel_prenorm`` (interpret mode) at bf16 and f32 x on a ``k_pad``
  artifact, and so does the port's plain version;
* dispatch: bf16 W4 calls ``iwoq_w4_matmul_mma`` (flat, stacked, BFP4,
  per-channel) and, with a pre-norm, ``iwoq_w4_matmul_prenorm_mma`` without
  a copy of x, while f32 x calls the CUDA-core entry points; each counts
  under its kernel's name (the wrapper called on CPU tensors with a
  recording stand-in for the library);
* the probe's SASS counts read the route's product kernel.

That the route's split plan covers the slab rows once is held, with the
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

from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, QuantSpec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
U32 = np.uint32
W4_SPEC = dict(fmt="int", bits=4, group_size=128, symmetric=False)


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


@functools.lru_cache(maxsize=None)
def _kpad_artifact():
    """The file's tiny artifact: K = 384 stored as 512 (k_pad 128), N = 256,
    int4 g128 asymmetric, quantized by JAX, in both packages."""
    jq = j_quantize(jnp.asarray(_x((384, 256), seed=0, scale=0.05)), JSpec(**W4_SPEC),
                    pad_k_to=512)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


# ------------------------------------------------------------ the decode

def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)``: byte n of the result is byte (nibble n of
    sel) of y:x."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(v.shape, dtype=np.uint64)
    for n in range(4):
        idx = (sel >> (4 * n)) & 7
        out |= ((v >> np.uint64(8 * idx)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def _bf16_fma_minus128(p):
    """``bf16x2_fma(p, 1.0, -128.0)``: each bf16 half minus 128, exact."""
    out = np.zeros_like(p)
    for h in (0, 16):
        f = (((p >> U32(h)) & U32(0xFFFF)) << U32(16)).view(np.float32) - np.float32(128)
        assert np.array_equal(f.view(U32) & U32(0xFFFF), np.zeros_like(p))
        out |= (f.view(U32) >> U32(16)) << U32(h)
    return out


def _int_codes_bf16(c):
    """``int_codes_bf16``: four codes below 128 (bytes of c) under the high
    byte 0x43 (bf16 128 + q), minus 128: pairs (0, 1) and (2, 3)."""
    hi = np.full_like(c, 0x43434343)
    return (_bf16_fma_minus128(_byte_perm(c, hi, 0x5140)),
            _bf16_fma_minus128(_byte_perm(c, hi, 0x7362)))


def _nib4_bf16x2(w):
    """``nib4_bf16x2`` (the decode tile: both slabs of a word of four packed
    rows): the low codes ``w & 0x0F0F0F0F``, the logical high codes
    ``((w >> 4) & 0x0F0F0F0F) ^ 0x08080808``, each to bf16 pairs."""
    return (_int_codes_bf16(w & U32(0x0F0F0F0F)),
            _int_codes_bf16(((w >> U32(4)) & U32(0x0F0F0F0F)) ^ U32(0x08080808)))


def _nib4_codes(a, i):
    """``nib4_codes`` (the wide tile, one slab a warp, before the transpose)."""
    return ((a >> U32(4 * i)) & U32(0x0F0F0F0F)) ^ U32(0x08080808 if i else 0)


def _values(pairs):
    """bf16 pairs (0, 1), (2, 3) -> the four values in byte order, f32."""
    halves = [(p >> U32(sh)) & U32(0xFFFF) for p in pairs for sh in (0, 16)]
    return [(h << U32(16)).view(np.float32) for h in halves]


def _decode(words, tile):
    """(low values, high values) of each byte of ``words``, per byte
    position, by the decode tile's or the wide tile's path."""
    if tile == "decode":
        lo, hi = _nib4_bf16x2(words)
    else:
        lo, hi = (_int_codes_bf16(_nib4_codes(words, i)) for i in (0, 1))
    return _values(lo), _values(hi)


@pytest.mark.parametrize("tile", ["decode", "wide"])
def test_nib4_bf16_decode_gives_the_jax_codes_for_every_byte(tile):
    """Every byte value in every byte of a word: the low value is the JAX
    ``qw & 0xF`` exactly, the high value the logical code ``(hi + 128) /
    16`` of the JAX ``bitcast(qw, int8) & -16`` (the stored nibble with its
    MSB flip undone), each an exact bf16."""
    b = np.arange(256, dtype=np.uint8)
    for rot in range(4):
        qw = np.roll(b.reshape(-1, 4), rot, axis=1).copy()
        lo, hi = _decode(qw.view(U32).reshape(-1), tile)
        jq = jnp.asarray(qw)
        j_lo = np.asarray((jq & 0xF).astype(jnp.int32))
        j_hi = np.asarray((jax.lax.bitcast_convert_type(jq, jnp.int8)
                           & jnp.int8(-16)).astype(jnp.int32))
        for pos in range(4):
            np.testing.assert_array_equal(lo[pos], j_lo[:, pos].astype(np.float32))
            np.testing.assert_array_equal(hi[pos], ((j_hi[:, pos] + 128) // 16)
                                          .astype(np.float32))
            np.testing.assert_array_equal(hi[pos], ((qw[:, pos] >> 4) ^ 8).astype(np.float32))


# ------------------------------------------------------------ the epilogue

def _route_model(x, qw, s, z, g, pre_norm, k_logical):
    """The kNib4B kernel in numpy: the codes decoded (decode tile) to their
    bf16 values; per slab (low, high nibbles) and group the products exact,
    summed in f32 (the MMA's f32 sums), ``acc += part * s + xsum * zc`` with
    ``zc = -(s * z)`` and ``xsum`` the f32 sum of the group's x; with a
    pre-norm ``r = 1 / sqrt(sum(x^2) / k_logical + eps)`` of the raw x times
    the f32 sum.  x is [M, 2 Kp] f32 (bf16 values where x is bf16)."""
    kp, n = qw.shape
    words = qw.T.copy().view(U32)  # [N, Kp/4]: four rows of a channel a word
    lo, hi = _decode(words.reshape(-1), "decode")
    vals = [np.stack(v, axis=-1).reshape(n, kp).T for v in (lo, hi)]
    rows = kp // g
    acc = np.zeros((x.shape[0], n), np.float32)
    for slab in (0, 1):
        xs = x[:, slab * kp:(slab + 1) * kp].astype(np.float64)
        for r in range(rows):
            sl = slice(r * g, (r + 1) * g)
            part = (xs[:, sl] @ vals[slab][sl].astype(np.float64)).astype(np.float32)
            xsum = xs[:, sl].sum(1).astype(np.float32)
            sv, zv = s[slab * rows + r], z[slab * rows + r]
            acc = acc + part * sv + xsum[:, None] * (-(sv * zv))
    if pre_norm is not None:
        xf = x.astype(np.float32)
        r = np.float32(1) / np.sqrt((xf * xf).sum(1) / np.float32(k_logical)
                                    + np.float32(pre_norm))
        acc = acc * r[:, None]
    return acc


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_route_model_equals_jax_int4_kernels_on_a_k_pad_artifact(dtype, pre_norm):
    """The model equals ``_int4_kernel`` (flat) and ``_int4_kernel_prenorm``
    (interpret mode) on K = 384 stored as 512, and so does the port's plain
    version: at the Pallas tests' tolerance for f32 x, within 1e-2 of the
    largest output for bf16 x (the JAX kernel rounds its output to bf16)."""
    jq, tq = _kpad_artifact()
    assert j_dm._layout_supported(jq, jq.scales.shape[0]) and tq.k_pad == 128
    x = _x((6, 384), seed=7, scale=2.0)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_dm.fused_quantized_matmul(xj, jq, interpret=True, pre_norm=pre_norm),
                      dtype=np.float32)
    xr = np.array(xj.astype(jnp.float32))  # x as the kernel reads it
    qw = np.asarray(jq.qweight)
    s, z = (np.asarray(a, np.float32) for a in (jq.scales, jq.zeros))
    got = _route_model(np.pad(xr, ((0, 0), (0, 128))), qw, s, z, qw.shape[0] // 2, pre_norm,
                       384)
    xt = torch.from_numpy(xr).to(torch.float32 if dtype == np.float32 else torch.bfloat16)
    dm.reset_counts()
    plain = dm.fused_quantized_matmul(xt, tq, pre_norm=pre_norm).float().numpy()
    assert dm.PLAIN_CALLS[dm.kernel_name(tq, pre_norm)] == 1 == sum(dm.PLAIN_CALLS.values())
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
    if layer is None:
        return dm._launch(4, pre_norm, x2, qt.qweight, qt.scales, qt.zeros, qt.scales.shape[0],
                          qt.shape[0], qt.shape[1])
    return dm._launch(4, pre_norm, x2, qt.qweight[layer], qt.scales[layer], qt.zeros[layer],
                      qt.scales.shape[1] - qt.side_pad, qt.shape[0], qt.shape[1])


DISPATCH = {  # id: (spec, K, N, quantize_tensor kwargs)
    "g128_asym": (QuantSpec(**W4_SPEC), 1024, 256, {}),
    "perchannel_asym": (QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL, symmetric=False),
                        1088, 256, {}),
    "bfp4": (QuantSpec(fmt="bfp", bits=4, group_size=128), 1408, 300, dict(pad_n_to=512)),
    "kpad": (QuantSpec(**W4_SPEC), 384, 256, dict(pad_k_to=512)),
}


def _w4(case, seed=0):
    spec, k, n, kw = DISPATCH[case]
    return quantize_tensor(torch.from_numpy(_x((k, n), seed=seed, scale=0.05)), spec, **kw)


def _group_rows(qt, rows):
    """The group (in slab rows) the wrapper passes: ``_nib4_groups``'s."""
    return dm._group_size(qt, rows)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
@pytest.mark.parametrize("m", [1, 8, 64, 256])
@pytest.mark.parametrize("case", list(DISPATCH))
def test_bf16_w4_takes_the_route_and_f32_w4_the_cuda_core_kernel(card_free_launch, case, m,
                                                                  pre_norm):
    """bf16 x: ``iwoq_w4_matmul_mma`` (flat) or ``iwoq_w4_matmul_prenorm_mma``
    (pre-norm: norm 1, no copy of x, the row factor in the epilogue), the
    nib4_bf16 plan, no format widths; f32 x: ``iwoq_w4_matmul`` /
    ``iwoq_w4_matmul_prenorm``; one launch each under the kernel's name."""
    qt = _w4(case)
    name = dm.W4 if pre_norm is None else dm.W4_PRENORM
    assert dm.kernel_name(qt, pre_norm) == name and dm.BF16_MMA[name] == "nib4_bf16"
    assert dm.bf16_mma_route(qt, torch.bfloat16) and not dm.bf16_mma_route(qt, torch.float32)
    ks, kp, n = qt.k_stored, qt.k_stored // 2, qt.qweight.shape[1]
    x = torch.from_numpy(_x((m, qt.shape[0]), seed=2))
    _launch(qt, x.to(torch.bfloat16), pre_norm)
    (lib_name, symbol, args), = card_free_launch.calls
    assert (lib_name, symbol) == (name, f"iwoq_{name}_mma")
    kc, splits = dm.plan_slab_splits(m, n, kp, "nib4_bf16", 132)
    assert args[1:6] == (ks, 0, qt.shape[0], int(pre_norm is not None), pre_norm or 0.0)
    assert args[13] is None  # no copy of x, with or without the pre-norm
    assert args[19:25] == (kp, _group_rows(qt, qt.scales.shape[0]), kc, splits, 0, 0)
    card_free_launch.calls.clear()
    _launch(qt, x, pre_norm)
    (lib_name, symbol, args), = card_free_launch.calls
    assert (lib_name, symbol) == (name, f"iwoq_{name}")
    assert dm.LAUNCHES[name] == 2 == sum(dm.LAUNCHES.values())


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
def test_stacked_w4_takes_the_route_at_its_layer(card_free_launch, pre_norm):
    """A layer-stacked artifact (side info padded by 2 rows): the route
    reads layer 1's weights and sides in place."""
    qts = [_w4("g128_asym", seed=i) for i in range(2)]
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 2))  # noqa: E731
    st = qts[0].replace(qweight=torch.stack([q.qweight for q in qts]),
                        scales=torch.stack([pad(q.scales) for q in qts]),
                        zeros=torch.stack([pad(q.zeros) for q in qts]), side_pad=2)
    assert dm.kernel_supported_stacked(st) and dm.bf16_mma_route(st, torch.bfloat16)
    x = torch.from_numpy(_x((8, 1024), seed=3)).to(torch.bfloat16)
    _launch(st, x, pre_norm, layer=1)
    (name, symbol, args), = card_free_launch.calls
    assert symbol == f"iwoq_{dm.kernel_name(st, pre_norm)}_mma"
    assert args[6] == st.qweight[1].data_ptr() and args[7] == st.scales[1].data_ptr()
    assert args[8:10] == (256, 1) and args[13] is None


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["w4", "w4_prenorm"])
def test_unaligned_x_is_copied_raw(card_free_launch, pre_norm):
    """x 2 bytes off a 16-byte boundary: the row pass copies it (x_copy 1,
    scratch for the copy), unnormalized for the prenorm kernel, whose
    epilogue still applies the row factor (norm 1)."""
    qt = _w4("g128_asym")
    x = torch.empty((8 * 1024 + 1,), dtype=torch.bfloat16)[1:].view(8, 1024)
    x.copy_(torch.from_numpy(_x((8, 1024), seed=4)))
    assert dm.x_needs_copy(x, 512)
    _launch(qt, x, pre_norm)
    (_, symbol, args), = card_free_launch.calls
    assert symbol.endswith("_mma") and args[2:5] == (1, 1024, int(pre_norm is not None))
    assert args[13] is not None


def test_w4_outside_the_route_rule_stays_on_the_cuda_core_kernel(card_free_launch):
    """K = 1028 per-channel: 514 slab rows, no multiple of 4: bf16 x takes
    the CUDA-core kernel, with and without a pre-norm."""
    spec = QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL, symmetric=False)
    qt = quantize_tensor(torch.from_numpy(_x((1028, 64), scale=0.05)), spec)
    assert dm.kernel_supported(qt) and not dm.bf16_mma_route(qt, torch.bfloat16)
    x = torch.from_numpy(_x((8, 1028), seed=5)).to(torch.bfloat16)
    for pre_norm in (None, EPS):
        _launch(qt, x, pre_norm)
    assert [c[1] for c in card_free_launch.calls] == ["iwoq_w4_matmul",
                                                      "iwoq_w4_matmul_prenorm"]


def test_probe_counts_the_sass_of_the_route():
    """The W4 inner-loop probe's SASS counts read ``w4_matmul``'s bf16
    route (its ``base``) by token tile, beside its CUDA-core kernel."""
    from iron_weight_only_quant_tpu_torch.probes import probe_w4_inner as probe

    text = """
        Function : _ZN4iwoq18wa_slab_mma_kernelILi8ELi1ELb1ELb1ELb0EEvPKvS2_i
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   PRMT R2, R3, 0x5140, R4 ;
        Function : _ZN4iwoq18wa_slab_mma_kernelILi8ELi1ELb0ELb1ELb0EEvPKvS2_i
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _ZN4iwoq18wa_slab_mma_kernelILi8ELi8ELb1ELb1ELb0EEvPKvS2_i
        /*0000*/                   FFMA R4, R5, R6, R4 ;
        Function : _ZN4iwoq17w4_partial_kernelILb0EfEEvPKT0_i
        /*0000*/                   I2FP.F32.U32 R2, R3 ;
    """
    counts = probe.sass_counts(text, ops=("HMMA", "PRMT", "FFMA", "I2FP"))
    assert set(counts) == {"base-mma/NT=1", "base-mma/NT=8", "base/f32x"}
    assert (counts["base-mma/NT=1"]["HMMA"], counts["base-mma/NT=1"]["PRMT"],
            counts["base-mma/NT=1"]["total"]) == (1, 1, 2)
    assert counts["base-mma/NT=8"]["FFMA"] == 1 and counts["base/f32x"]["I2FP"] == 1
