"""The A16 slab kernels' host-side pieces against the JAX package.

``w8a16_matmul``, ``w3a16_matmul``, ``lut4a16_matmul`` and
``lut6a16_matmul`` (``csrc/wa_slab_mma.cuh``) run their products on the
int8 tensor cores; what they compute is held to the plain versions on the
card (``tests/test_torch_cuda.py``).  Here, on the CPU:

* the activation sums the row pass writes once per (token, group) -- the
  plain ``activation_group_sums`` of the port's planes -- equal ``256*Σxa +
  Σxb`` of the JAX ``_prep_x`` planes on the same x, over the kernel's
  groups of the s21 and nq42 layouts, K-padded and per-channel included;
* the K-split plan (``plan_slab_splits``) covers every slab row exactly
  once, starts every split on a 32-row window, and depends on the shapes
  alone;
* the kernel's arithmetic decode of 6-bit minifloat codes to their int8
  grid (``nq42_grid``), written out here word for word in numpy, equals
  ``_minifloat_int`` for every code of the formats ``a16_supported`` lets
  through in the nq42 layout (E2M3, E1M4);
* the same for the byte (one slab of K rows, a block's range split in four
  parts over its warps) and nib4 (two slabs of K/2 rows, two parts)
  layouts: the group sums, the split plans with their parts at the 7B
  shapes, and the 4-bit grid decodes (``lut4_grid``, ``lut4_grid2``:
  byte-permute lookups and a sign select) for every fp4 format with an int8
  grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iron_weight_only_quant_tpu.config import PER_CHANNEL
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu_torch.config import FloatFormat
from iron_weight_only_quant_tpu_torch.config import QuantSpec as TQuantSpec
from iron_weight_only_quant_tpu_torch.config import fp_spec as t_fp_spec
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's plain CPU path runs small matmuls and many small ops that
    gain nothing from many torch threads; in the parallel test run those
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=1, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# id: (port spec, K, quantize_tensor kwargs); the kernel's group follows
# from the artifact's side rows as _launch derives it
SUM_CASES = {
    "s21_g128": (TQuantSpec(fmt="int", bits=3, group_size=128, symmetric=False), 1024, {}),
    "s21_perchannel": (TQuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL,
                                  symmetric=False), 1088, {}),
    "s21_g16_kpad": (TQuantSpec(fmt="int", bits=3, group_size=16, symmetric=False), 896,
                     dict(pad_k_to=1024)),
    "nq42_g128": (t_fp_spec("fp6", 2, 3, group_size=128, symmetric=False), 1024, {}),
    "nq42_perchannel": (t_fp_spec("fp6", 2, 3, group_size=PER_CHANNEL, symmetric=False),
                        1088, {}),
    "nq42_g64_kpad": (t_fp_spec("fp6", 2, 3, group_size=64, symmetric=False), 384,
                      dict(pad_k_to=512)),
}


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_group_sums_equal_the_jax_xsum(case):
    """``activation_group_sums`` of the port's A16 planes, over the groups
    the kernel walks, equals 256*Σxa + Σxb of the JAX planes (the xsum of
    ``_group_accum_a16`` and ``_lut_accum_a16``), as integers."""
    spec, k, kw = SUM_CASES[case]
    qt = quantize_tensor(torch.from_numpy(_x((k, 64), seed=2, scale=0.05)), spec, **kw)
    slabs = 8 if spec.bits == 3 else 4
    ks = qt.k_stored
    kb = ks // slabs
    g = dm._slab_groups(ks, kb, qt.scales.shape[0] - qt.side_pad, slabs)
    x = _x((5, k), seed=3)
    planes, _ = dm.quantize_activations(torch.from_numpy(x), 16)
    planes = torch.nn.functional.pad(planes, (0, ks - k))  # the K padding after quantizing
    ours = dm.activation_group_sums(planes, g).numpy()

    (xa, xb), m, *_ = j_dm._prep_x(jnp.asarray(x), k, 16)
    xa = np.pad(np.asarray(xa)[:m].astype(np.int64), ((0, 0), (0, ks - k)))
    xb = np.pad(np.asarray(xb)[:m].astype(np.int64), ((0, 0), (0, ks - k)))
    want = (256 * xa.reshape(m, ks // g, g).sum(-1) + xb.reshape(m, ks // g, g).sum(-1))
    np.testing.assert_array_equal(ours, want)
    if g == kb:  # per-channel: one sum a slab
        assert ours.shape == (5, slabs)


@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 512])
@pytest.mark.parametrize("n,kb,slabs", [(4096, 512, 8), (12288, 1024, 4), (4096, 1408, 8),
                                        (32256, 512, 8), (22528, 1024, 4), (256, 136, 8),
                                        (300, 17 * 4, 4)])
def test_slab_split_plan_covers_every_row_once(m, n, kb, slabs):
    layout = {8: "s21", 4: "lut6"}[slabs]
    assert dm.SLAB_TILES[layout][0] == slabs
    kc, splits = dm.plan_slab_splits(m, n, kb, layout, 132)
    assert kc % dm.SLAB_WINDOW == 0 and splits >= 1
    starts = [i * kc for i in range(splits)]
    rows = [r for s0 in starts for r in range(s0, min(kb, s0 + kc))]
    assert rows == list(range(kb))  # each row once, in order
    assert all(s0 % dm.SLAB_WINDOW == 0 and s0 < kb for s0 in starts)
    assert (kc, splits) == dm.plan_slab_splits(m, n, kb, layout, 132)


def test_slab_split_plan_fills_the_card_at_decode():
    """At M = 8 a 7B o projection (s21: K/8 = 512 rows, 64 tiles of 64
    channels) is split into 4 (256 blocks, two an SM of 132); the lm_head
    (504 tiles) is not split."""
    assert dm.plan_slab_splits(8, 4096, 512, "s21", 132) == (128, 4)
    assert dm.plan_slab_splits(8, 32256, 512, "s21", 132)[1] == 1


def _byte_sign_mask(v):
    """prmt's sign mode: 0xFF in each byte whose bit 7 is set."""
    b = np.stack([(v >> np.uint32(8 * i)) & np.uint32(0x80) for i in range(4)])
    return sum(np.where(b[i] != 0, np.uint32(0xFF << 8 * i), np.uint32(0))
               for i in range(4)).astype(np.uint32)


def _nq42_grid(c, wide):
    """``nq42_grid`` of csrc/wa_slab_mma.cuh on uint32 words of four codes."""
    u32 = np.uint32
    e_hi = _byte_sign_mask((c << u32(3)) & u32(0xFFFFFFFF)) & u32(wide)
    e_3 = _byte_sign_mask((c << u32(4)) & u32(0xFFFFFFFF)) & e_hi
    v = ((c & u32(0x1F1F1F1F)) + (c & e_hi & u32(0x0F0F0F0F))
         + ((c << u32(1)) & e_3 & u32(0x0E0E0E0E))) & u32(0xFFFFFFFF)
    neg = ((u32(0x80808080) - v) & u32(0xFFFFFFFF)) ^ u32(0x80808080)
    sgn = _byte_sign_mask((c << u32(2)) & u32(0xFFFFFFFF))
    return (v & ~sgn) | (neg & sgn)


@pytest.mark.parametrize("exp_bits,mant_bits", [(2, 3), (1, 4)])
def test_nq42_grid_decode_equals_minifloat_int(exp_bits, mant_bits):
    """Every 6-bit code, four to a word in every byte position, decodes to
    the byte of ``_minifloat_int`` (E2M3: wide; E1M4: the low five bits are
    the magnitude); these are the nq42 formats whose grid fits int8."""
    fmt = FloatFormat(exp_bits, mant_bits)
    qt = quantize_tensor(torch.zeros((512, 4)), t_fp_spec("fp6", exp_bits, mant_bits,
                                                          group_size=128))
    assert dm.packed_bits(qt) == 6 and dm.a16_supported(qt)
    codes = np.arange(64, dtype=np.uint32)
    want = dm._minifloat_int(torch.from_numpy(codes.astype(np.int32)), fmt).numpy()
    for rot in range(4):  # each code in each byte of a word
        perm = np.roll(codes.reshape(16, 4), rot, axis=1)
        words = (perm[:, 0] | (perm[:, 1] << 8) | (perm[:, 2] << 16)
                 | (perm[:, 3] << 24)).astype(np.uint32)
        got = _nq42_grid(words, 0xFFFFFFFF if exp_bits == 2 else 0)
        for i in range(4):
            byte = ((got >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
            np.testing.assert_array_equal(byte, want[perm[:, i]])


# ------------------------------------------------ the byte and nib4 layouts

# id: (port spec, K, quantize_tensor kwargs) of the layouts the slab kernel
# takes since w8a16 (byte: one slab of K rows) and lut4a16 (nib4: two slabs
# of K/2 rows, the low nibbles, then the high ones) run on it
SUM_CASES_BYTE_NIB4 = {
    "byte_g128": (TQuantSpec(fmt="int", bits=8, group_size=128, symmetric=False), 1024, {}),
    "byte_perchannel": (TQuantSpec(fmt="int", bits=8, group_size=PER_CHANNEL,
                                   symmetric=False), 1088, {}),
    "byte_g128_kpad": (TQuantSpec(fmt="int", bits=8, group_size=128, symmetric=False), 896,
                       dict(pad_k_to=1024)),
    "nib4_g128": (t_fp_spec("fp4", 2, 1, group_size=128, symmetric=False), 1024, {}),
    "nib4_perchannel": (t_fp_spec("fp4", 2, 1, group_size=PER_CHANNEL, symmetric=False),
                        1088, {}),
    "nib4_g128_halves_straddle": (t_fp_spec("fp4", 2, 1, group_size=128, symmetric=False),
                                  1408, {}),
    "nib4_g64_kpad": (t_fp_spec("fp4", 1, 2, group_size=64), 384, dict(pad_k_to=512)),
}


@pytest.mark.parametrize("case", list(SUM_CASES_BYTE_NIB4))
def test_byte_and_nib4_group_sums_equal_the_jax_xsum(case):
    """As :func:`test_group_sums_equal_the_jax_xsum` for the byte and nib4
    layouts, over the groups ``_launch`` derives (nib4: a group never
    straddles the K halves; ``_nib4_groups`` splits those that do)."""
    spec, k, kw = SUM_CASES_BYTE_NIB4[case]
    qt = quantize_tensor(torch.from_numpy(_x((k, 64), seed=4, scale=0.05)), spec, **kw)
    ks, rows = qt.k_stored, qt.scales.shape[0] - qt.side_pad
    if dm.packed_bits(qt) == 8:
        kb, g = ks, dm._byte_groups(ks, ks, rows)
    else:
        kb = ks // 2
        g = dm._nib4_groups(ks, kb, rows, qt.scales, qt.zeros)[0]
        assert kb % g == 0
    x = _x((5, k), seed=5)
    planes, _ = dm.quantize_activations(torch.from_numpy(x), 16)
    planes = torch.nn.functional.pad(planes, (0, ks - k))
    ours = dm.activation_group_sums(planes, g).numpy()

    (xa, xb), m, *_ = j_dm._prep_x(jnp.asarray(x), k, 16)
    xa = np.pad(np.asarray(xa)[:m].astype(np.int64), ((0, 0), (0, ks - k)))
    xb = np.pad(np.asarray(xb)[:m].astype(np.int64), ((0, 0), (0, ks - k)))
    want = (256 * xa.reshape(m, ks // g, g).sum(-1) + xb.reshape(m, ks // g, g).sum(-1))
    np.testing.assert_array_equal(ours, want)
    if g == kb:  # per-channel: one sum a slab
        assert ours.shape == (5, ks // kb)


SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
             "down": (11008, 4096), "lm_head": (4096, 32256)}


@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 512])
@pytest.mark.parametrize("shape", list(SHAPES_7B))
@pytest.mark.parametrize("kernel", [dm.W8A16, dm.LUT4A16, dm.W4A16])
def test_byte_and_nib4_split_plans_cover_every_row_once(kernel, shape, m):
    """The byte (Kb = K, down: 11008) and nib4 (Kb = K/2, down: 5504; the
    LUT layout of ``lut4a16`` and the affine one of ``w4a16``) plans: every
    split, and every part of a split, starts on a window, the splits cover
    the Kb rows once in order, and so do the parts of each split; the plan
    depends on the shapes alone and passes the kernel's checks."""
    layout = dm.SLAB_MMA[kernel]
    k, n = SHAPES_7B[shape]
    kb = k // dm.SLAB_TILES[layout][0]
    kc, splits = dm.plan_slab_splits(m, n, kb, layout, 132)
    parts = dm.slab_tile(m, layout)[2]
    assert kc % (dm.SLAB_WINDOW * parts) == 0 and splits >= 1
    assert kc * splits >= kb > kc * (splits - 1)
    kq = kc // parts
    rows = []
    for i in range(splits):
        k0, k1 = i * kc, min(kb, (i + 1) * kc)
        for p in range(parts):
            p0, p1 = k0 + p * kq, min(k1, k0 + (p + 1) * kq)
            assert p0 % dm.SLAB_WINDOW == 0
            rows += range(p0, p1)
    assert rows == list(range(kb))  # each row once, in order
    assert (kc, splits) == dm.plan_slab_splits(m, n, kb, layout, 132)


def _lut4_grid(c, tab):
    """``lut4_grid`` of csrc/wa_slab_mma.cuh on uint32 words of four 4-bit
    codes (one a byte), with ``tab`` its four table words."""
    u32 = np.uint32
    m = c & u32(0x07070707)
    x = m | (m >> u32(4))
    sel = _byte_perm(x, np.zeros_like(x), 0x0020)
    sgn = _byte_sign_mask((c << u32(4)) & u32(0xFFFFFFFF))
    pos = _byte_perm(np.full_like(c, tab[0]), np.full_like(c, tab[1]), sel)
    neg = _byte_perm(np.full_like(c, tab[2]), np.full_like(c, tab[3]), sel)
    return (pos & ~sgn) | (neg & sgn)


def _prmt(x, y, s, sign_mode=True):
    """``prmt`` in its generic mode: byte n of the result is byte ``s``
    nibble n (its low three bits) of the eight bytes of ``y:x``, or, where
    the nibble's bit 3 is set (and ``sign_mode``), that byte's sign bit
    replicated; ``s`` per element or scalar.  ``__byte_perm`` is the form
    without the sign mode."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    s = np.broadcast_to(np.asarray(s, dtype=np.uint64), v.shape)
    out = np.zeros(v.shape, dtype=np.uint64)
    for n in range(4):
        nib = (s >> np.uint64(4 * n)) & np.uint64(15)
        byte = (v >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(0xFF)
        if sign_mode:
            rep = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
            byte = np.where(nib & np.uint64(8), rep, byte)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def _byte_perm(x, y, s):
    return _prmt(x, y, s, sign_mode=False)


def _lut4_grid2(w, tab):
    """``lut4_grid2`` of csrc/wa_slab_mma.cuh: the packed nib4 words ``w``
    (bytes = four rows of one channel) -> (slab 0's, slab 1's) int8 grid
    words, in row order."""
    u32 = np.uint32
    m = w & u32(0x77777777)
    t = w ^ u32(0x80808080)
    t4 = (t << u32(4)) & u32(0xFFFFFFFF)
    v = []
    for h, sel_sign in ((0, 0xD9C8), (1, 0xFBEA)):
        sel = m >> u32(16) if h else m
        sgn = _prmt(t4, t, sel_sign)
        pos = _byte_perm(np.full_like(w, tab[0]), np.full_like(w, tab[1]), sel)
        neg = _byte_perm(np.full_like(w, tab[2]), np.full_like(w, tab[3]), sel)
        v.append((pos & ~sgn) | (neg & sgn))
    return _byte_perm(v[0], v[1], 0x6420), _byte_perm(v[0], v[1], 0x7531)


def _minifloat_int_c(code, e, m):
    """``minifloat_int`` of csrc/lut_common.cuh, for one code."""
    sign = (code >> (e + m)) & 1
    expf = (code >> m) & ((1 << e) - 1)
    mant_full = (int(expf != 0) << m) | (code & ((1 << m) - 1))
    ival = mant_full << (max(expf, 1) - 1)
    return -ival if sign else ival


@pytest.mark.parametrize("exp_bits,mant_bits", [
    (e, 3 - e) for e in (1, 2, 3) if dm._lut_a16_mult(FloatFormat(e, 3 - e)) is not None])
def test_lut4_grid_decode_equals_minifloat_int(exp_bits, mant_bits):
    """The nib4 kernel's decodes, written out word for word: the table of
    codes 0..7 and their negations as the kernel builds it per thread; the
    wide tiles take one slab's codes from a packed word (the low nibble, or
    the MSB-flipped high nibble: ``nib4_codes``), then ``lut4_grid``; the
    decode tile both slabs' at once from the word of one channel's four
    packed rows (``lut4_grid2``).  Every code of every 4-bit format
    ``_lut_a16_mult`` admits, in every byte of a word and both nibbles,
    decodes to the byte of ``_minifloat_int`` and of the JAX
    ``_minifloat_decode_int``."""
    fmt = FloatFormat(exp_bits, mant_bits)
    tab = [0, 0, 0, 0]
    for c in range(8):
        v = _minifloat_int_c(c, exp_bits, mant_bits) & 0xFF
        tab[c // 4] |= v << (8 * (c % 4))
        tab[2 + c // 4] |= ((-v) & 0xFF) << (8 * (c % 4))
    codes = np.arange(16, dtype=np.int64)
    want = dm._minifloat_int(torch.from_numpy(codes.astype(np.int32)), fmt).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(j_dm._minifloat_decode_int(jnp.asarray(codes.astype(np.int32)),
                                                    exp_bits, mant_bits)))
    rng = np.random.default_rng(6)
    lo = np.concatenate([np.roll(codes.reshape(4, 4), r, axis=1) for r in range(4)])
    hi = rng.permutation(lo.reshape(-1)).reshape(lo.shape)  # other codes in the high nibbles
    packed = (lo | ((hi ^ 8) << 4)).astype(np.uint32)  # the high nibble stored flipped
    words = packed[:, 0] | (packed[:, 1] << 8) | (packed[:, 2] << 16) | (packed[:, 3] << 24)
    for stream, logical in ((0, lo), (1, hi)):
        c = ((words >> np.uint32(4 * stream)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(
            0x08080808 if stream else 0)
        got = _lut4_grid(c.astype(np.uint32), tab)
        for i in range(4):
            byte = ((got >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
            np.testing.assert_array_equal(byte, want[logical[:, i]])
    for stream, got in enumerate(_lut4_grid2(words.astype(np.uint32), tab)):
        logical = (lo, hi)[stream]
        for i in range(4):
            byte = ((got >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
            np.testing.assert_array_equal(byte, want[logical[:, i]])
