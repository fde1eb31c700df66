"""The bf16 route of the LUT kernels against the JAX package, on the CPU.

``lut4_matmul`` and ``lut6_matmul`` take bf16 x on the bf16 family of
``csrc/wa_slab_mma.cuh`` (codes decoded to their exact bf16 values, bf16
products on the tensor cores) and f32 x on their CUDA-core kernel, as does
``lut8_matmul`` (tests/test_torch_byte_mma.py); what the kernels compute is
held to the plain versions on the card (``tests/test_torch_cuda.py``).
Here, on the CPU:

* the dispatch rule: bf16 x on the nib4, nq42 and byte layouts takes the
  route (:func:`bf16_mma_route`), f32 x and shapes outside the route's rule
  do not, and the kernel names and launch counters stay the kernels' own;
* the route's split plan covers every slab row once, at the decode tile (the
  A16 slab kernel's) and at the 64-token tile (one part), and the scratch
  and copy rules size what the kernel writes;
* the kernel's decodes, written out word for word in numpy (the widths-based
  bytewise assembly and its product by ``2**(127 - bias)``; the nib4 decode
  tile's table lookups), give the bf16 of the JAX ``_minifloat_decode`` for
  every code of every 4-bit and 6-bit format;
* a ``pre_norm`` call, which on the card normalizes x in the route's row
  pass, still equals the JAX package's normalize-then-kernel result (Pallas
  in interpret mode) on the port's CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iron_weight_only_quant_tpu.config import PER_CHANNEL
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import fp_spec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5


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


def _port(spec, k, n=64, seed=0, **kw):
    return quantize_tensor(torch.from_numpy(_x((k, n), seed=seed, scale=0.05)), spec, **kw)


# ------------------------------------------------------------ dispatch rule

ROUTE_CASES = {  # id: (spec, K, quantize_tensor kwargs, kernel)
    "fp4_e2m1_g128_asym": (fp_spec("fp4", 2, 1, group_size=128, symmetric=False), 512, {},
                           dm.LUT4),
    "fp4_e1m2_g64_sym": (fp_spec("fp4", 1, 2, group_size=64), 512, {}, dm.LUT4),
    "fp4_e2m1_g16_kpad": (fp_spec("fp4", 2, 1, group_size=16), 368, dict(pad_k_to=512),
                          dm.LUT4),
    "fp6_e2m3_g128_sym": (fp_spec("fp6", 2, 3, group_size=128), 1024, {}, dm.LUT6),
    "fp6_e3m2_perchannel_asym": (fp_spec("fp6", 3, 2, group_size=PER_CHANNEL,
                                         symmetric=False), 1088, {}, dm.LUT6),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_bf16_x_takes_the_mma_route_and_f32_x_the_cuda_core_kernel(case):
    """The route is chosen by x's dtype; the kernel's name (the launch
    counter) is the same either way, with or without a pre-norm, flat and
    stacked."""
    spec, k, kw, name = ROUTE_CASES[case]
    qt = _port(spec, k, **kw)
    assert dm.kernel_supported(qt) and dm.kernel_name(qt) == dm.kernel_name(qt, EPS) == name
    assert name in dm.BF16_MMA and not dm.prenorm_supported(qt)
    assert dm.bf16_mma_route(qt, torch.bfloat16)
    assert not dm.bf16_mma_route(qt, torch.float32)
    st = qt.map_arrays(lambda a: torch.stack([a, a]))
    assert dm.kernel_supported_stacked(st) and dm.bf16_mma_route(st, torch.bfloat16)


def test_the_route_keeps_the_kernels_names_and_leaves_other_layouts():
    """No new launch counter; fp8 (the byte layout) takes the route under
    its kernel's name, as do ``w8_matmul`` and ``w8_matmul_prenorm``
    (tests/test_torch_byte_mma.py); the A16 kernels and a nib4 artifact
    whose K/2 slab rows are no multiple of 4 stay off it (which also takes
    the s21 kernel, tests/test_torch_w4a16_w3_mma.py, and the two affine
    nib4 kernels, tests/test_torch_w4_mma.py)."""
    assert set(dm.BF16_MMA) == {dm.LUT4, dm.LUT6, dm.LUT8, dm.W3, dm.W4, dm.W4_PRENORM,
                                dm.W8, dm.W8_PRENORM} <= set(dm.LAUNCHES)
    assert set(dm.LAUNCHES) == set(dm.PLAIN_CALLS)
    assert len(dm.LAUNCHES) == 18  # sixteen serving kernels, the probe's two modes
    fp8 = _port(fp_spec("fp8", 4, 3, group_size=128), 512)
    assert dm.kernel_name(fp8) == dm.LUT8 and dm.bf16_mma_route(fp8, torch.bfloat16)
    assert dm.BF16_MMA[dm.LUT8] == "lut8_bf16"
    assert dm.BF16_MMA[dm.W8_PRENORM] == dm.BF16_MMA[dm.W8] == "byte_bf16"
    ragged = _port(fp_spec("fp4", 2, 1, group_size=PER_CHANNEL), 1090)
    assert dm.kernel_supported(ragged) and dm.kernel_name(ragged) == dm.LUT4
    assert not dm.bf16_mma_route(ragged, torch.bfloat16)  # K/2 = 545 rows
    a16 = _port(fp_spec("fp4", 2, 1, group_size=128), 512)
    assert dm.kernel_name(a16, None, 16) == dm.LUT4A16


# --------------------------------------------------- split plan and scratch

SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
             "down": (11264, 4096), "lm_head": (4096, 32256)}


# each bf16 layout's packing: the int8 layout that reads it (lut8_bf16 has no
# A16 kernel; its byte packing is the affine one's)
INT8_PACKING = {"lut4_bf16": "lut4", "lut6_bf16": "lut6", "s21_bf16": "s21",
                "nib4_bf16": "nib4", "byte_bf16": "byte", "lut8_bf16": "byte"}


@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 512])
@pytest.mark.parametrize("shape", list(SHAPES_7B))
@pytest.mark.parametrize("kernel", [dm.LUT4, dm.LUT6, dm.LUT8, dm.W3, dm.W4, dm.W8])
def test_bf16_split_plans_cover_every_row_once(kernel, shape, m):
    """nib4 (Kb = K/2; LUT and affine), nq42 and s21 (Kb = K/4 and K/8;
    down stored as 11264) and byte (Kb = K; LUT and affine): every split
    and every part starts on a window, the splits and the parts of each
    split cover the Kb rows once in order, the plan depends on the shapes
    alone; the decode tile splits as the A16 slab kernel of the same
    packing does (where both take the same rounding of their plan), the
    wide tile has one part."""
    layout = dm.BF16_MMA[kernel]
    int8_layout = INT8_PACKING[layout]
    assert set(INT8_PACKING) == set(dm.BF16_MMA.values())
    k, n = SHAPES_7B[shape]
    kb = k // dm.SLAB_TILES[layout][0]
    kc, splits = dm.plan_slab_splits(m, n, kb, layout, 132)
    parts = dm.slab_tile(m, layout)[2]
    assert parts == (dm.slab_tile(m, int8_layout)[2] if m <= 8 else 1)
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
    assert rows == list(range(kb))
    assert (kc, splits) == dm.plan_slab_splits(m, n, kb, layout, 132)
    whole = layout in dm.SLAB_WHOLE_ROUNDS
    if m <= 8 and whole == (int8_layout in dm.SLAB_WHOLE_ROUNDS):
        assert (kc, splits) == dm.plan_slab_splits(m, n, kb, int8_layout, 132)


def test_bf16_tiles_and_scratch():
    """Decode: 8 tokens and 128 channels a block, as the A16 slab kernel;
    beyond: 64 tokens, the warps of a slab each 32 channels (nib4, LUT and
    affine, 128; nq42 64).  The scratch is the bf16 copy of x the row pass writes, each slab
    padded to 32 rows."""
    for layout, bn in (("lut4", 128), ("lut6", 64), ("nib4", 128)):
        bf16 = layout + "_bf16"
        assert dm.slab_tile(8, bf16)[:2] == (8, 128) == dm.slab_tile(8, layout)[:2]
        assert dm.slab_tile(9, bf16) == dm.slab_tile(256, bf16) == (64, bn, 1)
    assert dm.plan_slab_splits(256, 4096, 2048, "lut4_bf16", 132) == (2048, 1)
    assert dm.bf16_mma_scratch_bytes(8, 2048, "lut4_bf16") == 2 * 8 * 2 * 2048
    assert dm.bf16_mma_scratch_bytes(3, 272, "lut6_bf16") == 2 * 3 * 4 * 288


def test_x_is_copied_only_where_the_kernel_cannot_read_it_in_place():
    x = torch.zeros((4, 1024), dtype=torch.bfloat16)
    assert not dm.x_needs_copy(x, 256) and not dm.x_needs_copy(x, 512)
    assert dm.x_needs_copy(torch.zeros((4 * 1024 + 1,), dtype=torch.bfloat16)[1:].view(4, 1024),
                           256)
    assert dm.x_needs_copy(x, 68)  # slab rows no multiple of 8
    assert dm.x_needs_copy(torch.zeros((4, 1020), dtype=torch.bfloat16), 255)


# -------------------------------------------------------- the decodes, in numpy

U32 = np.uint32


def _byte_perm(a, b, s):
    """``__byte_perm`` (prmt without its sign mode) on uint32 arrays."""
    v = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    s = np.broadcast_to(np.asarray(s, dtype=np.uint64), v.shape)
    out = np.zeros(v.shape, dtype=np.uint64)
    for n in range(4):
        idx = (s >> np.uint64(4 * n)) & np.uint64(7)
        out |= ((v >> (np.uint64(8) * idx)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def _prmt_sign(a, b, s):
    """``prmt`` in its generic mode: a selector nibble with bit 3 set gives
    the selected byte's sign bit replicated."""
    v = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(v.shape, dtype=np.uint64)
    for n in range(4):
        nib = (s >> (4 * n)) & 15
        byte = (v >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * n)
    return out.astype(U32)


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


def _jax_bf16_bits(bits, exp_bits, mant_bits):
    """The bf16 bits of the JAX ``_minifloat_decode`` of every code."""
    codes = jnp.arange(1 << bits, dtype=jnp.int32)
    f = np.asarray(j_dm._minifloat_decode(codes, exp_bits, mant_bits, jnp.float32))
    bf = np.asarray(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(bf, f)  # every value is exact in bf16
    return (f.view(U32) >> U32(16)).astype(U32)


def _halves(p01, p23):
    return [(p01 & U32(0xFFFF)), p01 >> U32(16), (p23 & U32(0xFFFF)), p23 >> U32(16)]


@pytest.mark.parametrize("bits,exp_bits", [(4, 1), (4, 2), (4, 3), (6, 1), (6, 2), (6, 3),
                                           (6, 4)])
def test_widths_decode_gives_the_jax_values_in_bf16(bits, exp_bits):
    """Every code, in every byte of a word: the bf16 of its exact value,
    subnormals (bf16 subnormals before the product) included."""
    mant_bits = bits - 1 - exp_bits
    want = _jax_bf16_bits(bits, exp_bits, mant_bits)
    codes = np.arange(1 << bits, dtype=U32)
    for rot in range(4):
        perm = np.roll(codes.reshape(-1, 4), rot, axis=1)
        words = (perm[:, 0] | (perm[:, 1] << U32(8)) | (perm[:, 2] << U32(16))
                 | (perm[:, 3] << U32(24))).astype(U32)
        for i, got in enumerate(_halves(*_codes_bf16(words, exp_bits, mant_bits))):
            np.testing.assert_array_equal(got, want[perm[:, i]])


@pytest.mark.parametrize("exp_bits", [1, 2, 3])
def test_nib4_decode_tile_gives_the_jax_values_in_bf16(exp_bits):
    """``lut4_bf16x2``: the packed word of one channel's four rows (low
    nibble slab 0's code, high nibble slab 1's stored MSB-flipped) -> both
    slabs' bf16 values by table lookups (the table from the format's
    widths, as ``lut4_bf16_table`` builds it) and prmt's sign mode."""
    mant_bits = 3 - exp_bits
    want = _jax_bf16_bits(4, exp_bits, mant_bits)
    tab = [0, 0, 0, 0]
    for c in range(8):
        b = int(want[c])
        tab[c // 4] |= (b & 0xFF) << (8 * (c % 4))
        tab[2 + c // 4] |= (b >> 8) << (8 * (c % 4))
    rng = np.random.default_rng(3)
    codes = np.arange(16, dtype=np.int64)
    lo = np.concatenate([np.roll(codes.reshape(4, 4), r, axis=1) for r in range(4)])
    hi = rng.permutation(lo.reshape(-1)).reshape(lo.shape)
    packed = (lo | ((hi ^ 8) << 4)).astype(U32)
    w = (packed[:, 0] | (packed[:, 1] << U32(8)) | (packed[:, 2] << U32(16))
         | (packed[:, 3] << U32(24))).astype(U32)
    m = w & U32(0x77777777)
    t = w ^ U32(0x80808080)
    t4 = (t << U32(4)).astype(U32)
    s0, s1 = [], []
    for h, ssel in ((0, 0xD9C8), (1, 0xFBEA)):
        sel = m >> U32(16) if h else m
        sgn = _prmt_sign(t4, t, ssel)
        full = lambda v: np.full_like(w, v)  # noqa: E731
        lo_b = _byte_perm(full(tab[0]), full(tab[1]), sel)
        hi_b = _byte_perm(full(tab[2]), full(tab[3]), sel) | (sgn & U32(0x80808080))
        s0.append(_byte_perm(lo_b, hi_b, 0x6240))
        s1.append(_byte_perm(lo_b, hi_b, 0x7351))
    for logical, got in ((lo, _halves(*s0)), (hi, _halves(*s1))):
        for i in range(4):
            np.testing.assert_array_equal(got[i], want[logical[:, i]])


# ------------------------------------------------- pre_norm against the JAX kernel

PRENORM_CASES = {
    "fp4_e2m1_g128_asym": (j_fp_spec("fp4", 2, 1, group_size=128, symmetric=False), 512),
    "fp6_e2m3_g128_sym": (j_fp_spec("fp6", 2, 3, group_size=128), 512),
    "fp6_e3m2_g64_asym": (j_fp_spec("fp6", 3, 2, group_size=64, symmetric=False), 512),
}


@pytest.mark.parametrize("case", list(PRENORM_CASES))
def test_pre_norm_call_equals_jax_normalize_then_kernel(case):
    """The JAX package normalizes x, casts it back to x's type and runs the
    Pallas LUT kernel (interpret mode); the port's CPU path is held to it
    at the LUT tests' tolerance in f32, and at the bf16 route's (1e-2 of the
    largest output) in bf16; the artifact is the route's."""
    spec, k = PRENORM_CASES[case]
    jq = j_quantize(jnp.asarray(_x((k, 256), seed=2, scale=0.05)), spec)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert dm.bf16_mma_route(tq, torch.bfloat16) and not dm.prenorm_supported(tq)
    x = _x((6, k), seed=3, scale=2.0)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        want = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x).astype(jdtype), jq,
                                                      interpret=True, pre_norm=EPS),
                          dtype=np.float32)
        dm.reset_counts()
        got = dm.fused_quantized_matmul(xt, tq, pre_norm=EPS).float().numpy()
        assert dm.PLAIN_CALLS[dm.kernel_name(tq)] == 1 == sum(dm.PLAIN_CALLS.values())
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, **TOL)
        else:
            assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
