"""The A16 slab kernels' host-side pieces against the JAX package.

``w3a16_matmul`` and ``lut6a16_matmul`` (``csrc/wa_slab_mma.cuh``) run
their products on the int8 tensor cores; what they compute is held to the
plain versions on the card (``tests/test_torch_cuda.py``).  Here, on the
CPU:

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
  through in the nq42 layout (E2M3, E1M4).
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
    kc, splits = dm.plan_slab_splits(m, n, kb, slabs, 132)
    assert kc % dm.SLAB_WINDOW == 0 and splits >= 1
    starts = [i * kc for i in range(splits)]
    rows = [r for s0 in starts for r in range(s0, min(kb, s0 + kc))]
    assert rows == list(range(kb))  # each row once, in order
    assert all(s0 % dm.SLAB_WINDOW == 0 and s0 < kb for s0 in starts)
    assert (kc, splits) == dm.plan_slab_splits(m, n, kb, slabs, 132)


def test_slab_split_plan_fills_the_card_at_decode():
    """At M = 8 a 7B o projection (s21: K/8 = 512 rows, 64 tiles of 64
    channels) is split into 4 (256 blocks, two an SM of 132); the lm_head
    (504 tiles) is not split."""
    assert dm.plan_slab_splits(8, 4096, 512, 8, 132) == (128, 4)
    assert dm.plan_slab_splits(8, 32256, 512, 8, 132)[1] == 1


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
