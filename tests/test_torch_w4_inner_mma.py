"""The tensor-core routes of the W4 inner-loop probe kernel against the JAX
probe and the kernel's own tables, on the CPU.

With bf16 x, ``w4_inner_matmul`` runs its two modes as two layouts of the
bf16 family of ``csrc/wa_slab_mma.cuh``: ``magic`` (``kNib4M``: the codes
left as bf16(128 + q), bf16 products, the 128 folded into the zero point)
and ``f32`` (``kNib4T``: the codes converted to f32, TF32 products, the
high slab's mult 1/16 and zshift 8 in its sides).  What the kernels compute
is held to the plain version on the card (``tests/test_torch_cuda.py -k
w4_inner``).  Here:

* numpy models of the two decodes, over all 256 byte values in every byte
  of a word, give the JAX probe's values: ``magic`` the bf16 of ``128 +
  q`` of both halves (the JAX ``(qw & 0xF) | 0x4300`` for the low one),
  ``f32`` the JAX ``qw & 0xF`` and ``bitcast(qw, int8) & -16`` as f32,
  each exact in TF32;
* numpy models of the two epilogues (per slab and group ``acc += part *
  sc + xsum * zc``: ``magic`` ``zc = -(s * (z + 128))``; ``f32`` the low
  slab ``s``, ``-(s * z)``, the high one ``s / 16``, ``-(s * (z - 8))``)
  equal the JAX ``_kernel_variant`` (interpret mode) at bf16 x, on random x
  and on x of mean 4 and spread 0.1 against columns whose zero points are
  all 0, all 15 and random (the file's one artifact);
* dispatch: bf16 x calls ``iwoq_w4_inner_matmul_mma`` with the mode's
  layout's split plan, an unaligned x with a copy, while f32 x and shapes
  off the bf16 family's rule call the CUDA-core ``iwoq_w4_inner_matmul``,
  each counted under the mode's name (the wrapper called on CPU tensors
  with a recording stand-in for the library);
* the probe's SASS counts key both routes' product kernels by layout.

The new layouts' rows of ``SLAB_TILES`` are held to ``csrc/slab_tile.cuh``
with the others' in ``tests/test_torch_w4a16_w3_mma.py``.
"""

import contextlib
import functools
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import PER_CHANNEL, QuantSpec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.ops.kernels import w4_inner
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import probe_w4_inner as j_probe  # noqa: E402

U32 = np.uint32
W4_SPEC = dict(fmt="int", bits=4, group_size=128, symmetric=False)
MODES = ("f32", "magic")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain CPU path gains nothing from many torch threads; in the
    parallel test run they only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _artifact():
    """The file's artifact, quantized once by JAX: K = 512, N = 384, int4
    g128 asymmetric; columns 0..127 positive weights (every zero point 0),
    128..255 negative ones (every zero point 15), 256..383 of both signs."""
    w = _x((512, 384), seed=0, scale=0.05)
    w[:, :128], w[:, 128:256] = np.abs(w[:, :128]), -np.abs(w[:, 128:256])
    jq = j_quantize(jnp.asarray(w), JSpec(**W4_SPEC))
    z = np.asarray(jq.zeros)
    assert (z[:, :128] == 0).all() and (z[:, 128:256] == 15).all()
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


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


def _biased_codes_bf16(c):
    """``biased_codes_bf16``: four codes below 128 (bytes of c) under the
    high byte 0x43, bf16 pairs (0, 1) and (2, 3): the values 128 + q."""
    hi = np.full_like(c, 0x43434343)
    return _byte_perm(c, hi, 0x5140), _byte_perm(c, hi, 0x7362)


def _bf16_values(pairs):
    """bf16 pairs (0, 1), (2, 3) -> the four values in byte order, f32."""
    halves = [(p >> U32(sh)) & U32(0xFFFF) for p in pairs for sh in (0, 16)]
    return [(h << U32(16)).view(np.float32) for h in halves]


def _magic_decode(words, tile):
    """(low values, high values) per byte position of ``words`` by the
    ``kNib4M`` decode: the decode tile's ``nib4_bf16x2<true>`` (both slabs
    of a word) or the wide tile's ``nib4_codes`` of each slab (before the
    transpose, which moves bytes only), then ``biased_codes_bf16``."""
    if tile == "decode":
        lo = words & U32(0x0F0F0F0F)
        hi = ((words >> U32(4)) & U32(0x0F0F0F0F)) ^ U32(0x08080808)
    else:
        lo, hi = (((words >> U32(4 * i)) & U32(0x0F0F0F0F)) ^ U32(0x08080808 if i else 0)
                  for i in (0, 1))
    return _bf16_values(_biased_codes_bf16(lo)), _bf16_values(_biased_codes_bf16(hi))


def _f32_decode(words):
    """(low values, high values) per byte position by ``nib4_f32``: the
    code q, and the high nibble read as int8, each converted to f32."""
    b = [(words >> U32(8 * j)) & U32(0xFF) for j in range(4)]
    return ([(v & U32(0xF)).astype(np.float32) for v in b],
            [(v & U32(0xF0)).astype(np.uint8).view(np.int8).astype(np.float32) for v in b])


@pytest.mark.parametrize("decode", ["magic_decode_tile", "magic_wide_tile", "f32"])
def test_decode_gives_the_jax_probe_values_for_every_byte(decode):
    """Every byte value in every byte of a word: ``magic`` gives the bf16 of
    128 + q for both halves, the low one bit for bit the JAX ``(qw & 0xF) |
    0x4300``; ``f32`` gives the JAX f32 mode's codes ``qw & 0xF`` and
    ``bitcast(qw, int8) & -16`` as f32, whose low 13 mantissa bits are zero
    (exact in TF32, as bf16 x widened by a 16-bit shift is)."""
    b = np.arange(256, dtype=np.uint8)
    for rot in range(4):
        qw = np.roll(b.reshape(-1, 4), rot, axis=1).copy()
        words = qw.view(U32).reshape(-1)
        jq = jnp.asarray(qw)
        j_lo = np.asarray((jq & 0xF).astype(jnp.float32))
        j_hi = np.asarray((jax.lax.bitcast_convert_type(jq, jnp.int8)
                           & jnp.int8(-16)).astype(jnp.float32))
        if decode == "f32":
            lo, hi = _f32_decode(words)
        else:
            lo, hi = _magic_decode(words, decode.split("_")[1])
            j_magic = np.asarray(jax.lax.bitcast_convert_type(
                (jq & 0xF).astype(jnp.uint16) | jnp.uint16(0x4300), jnp.bfloat16)
                .astype(jnp.float32))
        for pos in range(4):
            if decode == "f32":
                np.testing.assert_array_equal(lo[pos], j_lo[:, pos])
                np.testing.assert_array_equal(hi[pos], j_hi[:, pos])
                for v in (lo[pos], hi[pos]):
                    assert not (v.view(U32) & U32(0x1FFF)).any()
            else:
                np.testing.assert_array_equal(lo[pos], j_magic[:, pos])
                np.testing.assert_array_equal(lo[pos], 128 + j_lo[:, pos])
                np.testing.assert_array_equal(hi[pos], 128 + 8 + j_hi[:, pos] / 16)


# ------------------------------------------------------------ the epilogues

def _route_model(x, qw, s, z, mode):
    """The kNib4M (magic) or kNib4T (f32) kernel in numpy: per slab (low,
    high nibbles) and group the products exact, summed in f32 (the MMA's f32
    sums), ``acc += part * sc + xsum * zc`` in f32, with ``xsum`` the f32 sum
    of the group's x and the sides of the mode.  x is [M, 2 Kp] (bf16
    values), s and z [2 rows, N]."""
    kp, n = qw.shape
    words = qw.copy().view(U32).reshape(-1)  # a byte's value is the same in any word
    vals = _magic_decode(words, "decode") if mode == "magic" else _f32_decode(words)
    vals = [np.stack(v, axis=-1).reshape(kp, n) for v in vals]
    rows = s.shape[0] // 2
    g = kp // rows
    acc = np.zeros((x.shape[0], n), np.float32)
    for slab in (0, 1):
        xs = x[:, slab * kp:(slab + 1) * kp].astype(np.float64)
        for r in range(rows):
            sl = slice(r * g, (r + 1) * g)
            part = (xs[:, sl] @ vals[slab][sl].astype(np.float64)).astype(np.float32)
            xsum = xs[:, sl].sum(1).astype(np.float32)
            sv, zv = s[slab * rows + r], z[slab * rows + r]
            if mode == "magic":
                sc, zc = sv, -(sv * (zv + np.float32(128)))
            elif slab:
                sc, zc = sv * np.float32(1 / 16), -(sv * (zv - np.float32(8)))
            else:
                sc, zc = sv, -(sv * zv)
            acc = acc + part * sc + xsum[:, None] * zc
    return acc


def _jax_variant(x, qt, mode):
    """``scripts/probe_w4_inner.py``'s ``run_variant`` with ``interpret=True``
    (the script hard-codes the TPU)."""
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


@pytest.mark.parametrize("inputs", ["normal", "one_sign"])
@pytest.mark.parametrize("mode", MODES)
def test_epilogue_model_equals_jax_kernel_variant(mode, inputs):
    """The model equals ``_kernel_variant`` (interpret mode) at bf16 x
    within 1e-2 of the largest output (the JAX kernel rounds its output to
    bf16), on N(0, 1) x and on x of mean 4 and spread 0.1 (each group's sum
    of x large, the magic decode's cancellation at its worst); so does the
    port's plain version; on the one-sign x the model stays within 2e-3 of
    the f32 oracle, where the output's rounding alone allows 2^-9."""
    jq, tq = _artifact()
    x = _x((8, 512), seed=7) if inputs == "normal" else 4 + _x((8, 512), seed=7, scale=0.1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(_jax_variant(xj, jq, mode).astype(jnp.float32))
    xr = np.array(xj.astype(jnp.float32))
    qw = np.asarray(jq.qweight)
    s, z = (np.asarray(a, np.float32) for a in (jq.scales, jq.zeros))
    got = _route_model(xr, qw, s, z, mode)
    plain = w4_inner.w4_inner_plain(torch.from_numpy(xr).to(torch.bfloat16), tq, mode)
    for y in (got, plain.float().numpy()):
        assert np.abs(y - want).max() <= 1e-2 * np.abs(want).max()
    if inputs == "one_sign":
        oracle = xr.astype(np.float64) @ _dequant(qw, s, z)
        assert np.abs(got - oracle).max() <= 2e-3 * np.abs(oracle).max()


def _dequant(qw, s, z):
    """The affine nib4 artifact dequantized in f64: [K, N]."""
    kp = qw.shape[0]
    codes = np.concatenate([qw & 0xF, (qw >> 4) ^ 8]).astype(np.float64)
    g = 2 * kp // s.shape[0]
    return (codes - np.repeat(z, g, axis=0)) * np.repeat(s, g, axis=0)


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
    """``w4_inner._launch`` on CPU tensors: the library, the SM count, the
    device context and the stream are stand-ins; the wrapper's rule, plan
    and scratch are its own."""
    lib = _Library()
    monkeypatch.setattr(dm, "_load_fn", lib.load)
    monkeypatch.setattr(dm, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    dm.reset_counts()
    return lib


DISPATCH = {  # id: (spec, K, N, quantize_tensor kwargs)
    "g128_asym": (QuantSpec(**W4_SPEC), 1024, 256, {}),
    "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL,
                                        symmetric=False), 1088, 256, {}),
    "npad": (QuantSpec(**W4_SPEC), 1024, 300, dict(pad_n_to=512)),
    "kpad": (QuantSpec(**W4_SPEC), 384, 256, dict(pad_k_to=512)),
}


def _w4(spec, k, n, kw, seed=0):
    return quantize_tensor(torch.from_numpy(_x((k, n), seed=seed, scale=0.05)), spec, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_x_takes_the_route_and_f32_x_the_cuda_core_kernel(card_free_launch, mode):
    """bf16 x: ``iwoq_w4_inner_matmul_mma`` with the mode's flag, x read in
    place, the split plan of the mode's layout (``W4_INNER_MMA``); f32 x:
    ``iwoq_w4_inner_matmul``; one launch each under the mode's name."""
    name = dm.W4_INNER_MAGIC if mode == "magic" else dm.W4_INNER_F32
    layout = dm.W4_INNER_MMA[name]
    assert layout == ("nib4_magic_bf16" if mode == "magic" else "nib4_tf32_bf16")
    for case, (spec, k, n, kw) in DISPATCH.items():
        qt = _w4(spec, k, n, kw)
        assert dm.bf16_mma_route(qt, torch.bfloat16), case
        ks, kp, ns = qt.k_stored, qt.k_stored // 2, qt.qweight.shape[1]
        for m in (1, 8, 64, 256):
            card_free_launch.calls.clear()
            dm.reset_counts()
            x = torch.from_numpy(_x((m, k), seed=2))
            w4_inner._launch(dm._prep_x(x.to(torch.bfloat16), qt), qt, mode)
            (lib_name, symbol, args), = card_free_launch.calls
            assert (lib_name, symbol) == ("w4_inner_matmul", "iwoq_w4_inner_matmul_mma")
            kc, splits = dm.plan_slab_splits(m, ns, kp, layout, 132)
            assert args[1:4] == (ks, 0, k) and args[11] is None
            assert args[14:] == (m, ns, qt.n, kp, dm._group_size(qt, qt.scales.shape[0]), kc,
                                 splits, int(mode == "magic"), 0)
            card_free_launch.calls.clear()
            w4_inner._launch(dm._prep_x(x, qt), qt, mode)
            (_, symbol, args), = card_free_launch.calls
            assert symbol == "iwoq_w4_inner_matmul" and args[1] == 0  # x_bf16
            assert dm.LAUNCHES == {**{k_: 0 for k_ in dm.LAUNCHES}, name: 2}


def test_unaligned_x_is_copied_and_shapes_off_the_rule_take_the_cuda_core_kernel(
        card_free_launch):
    """x 2 bytes off a 16-byte boundary: x_copy 1 and scratch for the copy;
    K = 1028 per-channel (514 slab rows, no multiple of 4): bf16 x takes
    the CUDA-core kernel in both modes."""
    qt = _w4(*DISPATCH["g128_asym"][:3], {})
    x = torch.empty((8 * 1024 + 1,), dtype=torch.bfloat16)[1:].view(8, 1024)
    x.copy_(torch.from_numpy(_x((8, 1024), seed=4)))
    assert dm.x_needs_copy(x, 512)
    for mode in MODES:
        w4_inner._launch(dm._prep_x(x, qt), qt, mode)
    for (_, symbol, args), mode in zip(card_free_launch.calls, MODES):
        assert symbol == "iwoq_w4_inner_matmul_mma" and args[2] == 1 and args[11] is not None
    spec = QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL, symmetric=False)
    qt = _w4(spec, 1028, 64, {})
    assert dm.kernel_supported(qt) and not dm.bf16_mma_route(qt, torch.bfloat16)
    card_free_launch.calls.clear()
    x = torch.from_numpy(_x((8, 1028), seed=5)).to(torch.bfloat16)
    for mode in MODES:
        w4_inner._launch(dm._prep_x(x, qt), qt, mode)
    assert [(c[1], c[2][1], c[2][-2]) for c in card_free_launch.calls] == [
        ("iwoq_w4_inner_matmul", 1, 0), ("iwoq_w4_inner_matmul", 1, 1)]


def test_probe_keys_each_route_s_product_kernel():
    """The probe's SASS counts key the tensor-core product kernels by their
    layout (``w4_matmul``'s kNib4B as base, kNib4M as magic, kNib4T as f32)
    and token tile, their 16-byte-copy forms only, and no other layout."""
    from iron_weight_only_quant_tpu_torch.probes import probe_w4_inner as probe

    text = """
        Function : _ZN4iwoq18wa_slab_mma_kernelILi8ELi1ELb1ELb1ELb0ELi2EEEvPKv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   HFMA2 R2, R3, R4, R5 ;
        Function : _ZN4iwoq18wa_slab_mma_kernelILi11ELi1ELb1ELb1ELb0ELi2EEEvPKv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   PRMT R2, R3, 0x5140, R4 ;
        Function : _ZN4iwoq18wa_slab_mma_kernelILi12ELi8ELb1ELb1ELb0ELi2EEEvPKv
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0010*/                   I2FP.F32.S32 R2, R3 ;
        Function : _ZN4iwoq18wa_slab_mma_kernelILi12ELi8ELb0ELb1ELb0ELi2EEEvPKv
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        Function : _ZN4iwoq18wa_slab_mma_kernelILi5ELi1ELb1ELb1ELb0ELi2EEEvPKv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
    """
    counts = probe.sass_counts(text)
    assert set(counts) == {"base-mma/NT=1", "magic-mma/NT=1", "f32-mma/NT=8"}
    assert (counts["base-mma/NT=1"]["HMMA"], counts["base-mma/NT=1"]["HFMA2"]) == (1, 1)
    assert (counts["magic-mma/NT=1"]["PRMT"], counts["magic-mma/NT=1"]["HFMA2"]) == (1, 0)
    assert (counts["f32-mma/NT=8"]["HMMA"], counts["f32-mma/NT=8"]["I2FP"],
            counts["f32-mma/NT=8"]["total"]) == (1, 1, 2)
