"""``w4a8_matmul``, ``w8a8_matmul`` and ``w3a8_matmul`` as the one-plane
(A8) mode of the int8 slab kernel, against the JAX package, on the CPU.

The three A8 kernels run as the affine nib4, byte and s21 layouts of the
int8 slab kernel (``csrc/wa_slab_mma.cuh``, ``PLANES = 1``): the row pass
writes one int8 plane per slab and the plain sum of each group's codes,
and the product kernel multiplies that plane against the layout's codes on
the int8 tensor cores.  What they compute is held to the plain versions on
the card (``tests/test_torch_cuda.py -k slab_a8``).  Here:

* a numpy model of the one-plane arithmetic (the nib4 decode of the int8
  family, the low codes ``w & 0x0F0F0F0F`` and the high ones ``w &
  0xF0F0F0F0`` read as int8, 16 q - 128; per slab and group ``part = pa``,
  ``acc += part*sc - xsum*(sc*zc)`` with the high slab's sides folded to
  ``s/16`` and ``16z - 128``; then ``acc * sx``) equals the JAX
  ``_int4_kernel`` with int8 x (interpret mode), and so does the port's
  plain version, on g128 asymmetric, per-channel symmetric, g64 and
  ``k_pad`` artifacts, bf16 and f32 x; likewise numpy models of the byte
  layout (the stored byte read as int8 is the code) and of the s21 layout
  (``slab_codes`` of each slab's A and B words, ``f + 4h``) against
  ``_int8_kernel`` and ``_int3_kernel`` with int8 x;
* the one-plane row pass's layout (each slab padded to 32 rows; one slab
  for byte, two for nib4, eight for s21) and group sums, modelled from the
  port's ``quantize_activations``, hold the JAX ``_prep_x`` codes and their
  integer group sums, and fill the scratch that ``slab_scratch_bytes``
  sizes;
* the one-plane tiles (each layout's decode tile; the 64-token wide tile
  of nib4 and byte, the 32-token one of s21) and their split plans, which
  cover every slab row once at the 7B shapes;
* dispatch: bf16 and f32 ``w4a8``, ``w8a8`` and ``w3a8`` calls (flat and
  stacked) reach ``iwoq_w4a8_matmul``, ``iwoq_w8a8_matmul`` and
  ``iwoq_w3a8_matmul`` with the one-plane plan and scratch (the wrapper
  called on CPU tensors with a recording stand-in for the library).
"""

import contextlib
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iron_weight_only_quant_tpu.config import PER_CHANNEL as J_PER_CHANNEL
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


CASES = {  # id: (JAX spec, K, quantize_tensor kwargs) at N = 256, K_stored 512 (s21: 1024)
    "g128_asym": (JSpec(fmt="int", bits=4, group_size=128, symmetric=False), 512, {}),
    "perchannel_sym": (JSpec(fmt="int", bits=4, group_size=J_PER_CHANNEL, symmetric=True),
                       512, {}),
    "g64_asym": (JSpec(fmt="int", bits=4, group_size=64, symmetric=False), 512, {}),
    "g128_asym_kpad": (JSpec(fmt="int", bits=4, group_size=128, symmetric=False), 384,
                       dict(pad_k_to=512)),
    "byte_g128_asym": (JSpec(fmt="int", bits=8, group_size=128, symmetric=False), 512, {}),
    "byte_perchannel_sym": (JSpec(fmt="int", bits=8, group_size=J_PER_CHANNEL,
                                  symmetric=True), 512, {}),
    "byte_g128_asym_kpad": (JSpec(fmt="int", bits=8, group_size=128, symmetric=False), 384,
                            dict(pad_k_to=512)),
    "s21_g128_asym": (JSpec(fmt="int", bits=3, group_size=128, symmetric=False), 1024, {}),
    "s21_perchannel_sym": (JSpec(fmt="int", bits=3, group_size=J_PER_CHANNEL,
                                 symmetric=True), 1024, {}),
    "s21_g128_asym_kpad": (JSpec(fmt="int", bits=3, group_size=128, symmetric=False), 896,
                           dict(pad_k_to=1024)),
}
NIB4_CASES = [c for c in CASES if CASES[c][0].bits == 4]
LAYOUT_OF = {4: ("nib4", 2, dm.W4A8), 8: ("byte", 1, dm.W8A8), 3: ("s21", 8, dm.W3A8)}


@functools.lru_cache(maxsize=None)
def _artifact(case):
    """One tiny artifact a case (N = 256), quantized by JAX, in both
    packages."""
    spec, k, kw = CASES[case]
    jq = j_quantize(jnp.asarray(_x((k, 256), seed=0, scale=0.05)), spec, **kw)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


# ------------------------------------------------- the one-plane arithmetic

def _nib4_decode(words):
    """The int8 family's decode of packed nib4 words (uint32, bytes = rows
    of a channel): (low codes q, high codes 16 q - 128) as int8 bytes."""
    return (words & U32(0x0F0F0F0F)).view(np.int8), (words & U32(0xF0F0F0F0)).view(np.int8)


def _a8_kernel_model(plane, sx, qw, s, z):
    """The affine nib4 case of the int8 slab kernel with one plane, in
    numpy.  ``plane`` [M, K_stored] int8 codes (K padding zero), ``sx``
    [M]; sides [R or 1, N or 1] with g = Kp / R' the group of one slab
    (per-channel: one group a slab).  Per slab (low, high nibbles) and
    group: the exact integer product turned f32 (part = pa), xsum the plain
    sum of the group's codes, acc += part * sc - xsum * (sc * zc) with the
    high slab's sides folded (sc = s / 16, zc = 16 z - 128, as load_sides
    does), then acc * sx."""
    kp, n = qw.shape
    words = qw.T.copy().view(U32)  # [N, Kp/4]: a channel's four rows a word
    lo, hi = (c.reshape(n, kp).T.astype(np.int64) for c in _nib4_decode(words.reshape(-1)))
    g = kp if s.shape[0] == 1 else 2 * kp // s.shape[0]
    rows = kp // g
    s = np.broadcast_to(s, (2 * rows if s.shape[0] > 1 else 1, n))
    z = np.broadcast_to(z, (s.shape[0], n))
    acc = np.zeros((plane.shape[0], n), np.float32)
    for slab, codes in ((0, lo), (1, hi)):
        xp = plane[:, slab * kp:(slab + 1) * kp].astype(np.int64)
        for r in range(rows):
            sl = slice(r * g, (r + 1) * g)
            part = (xp[:, sl] @ codes[sl]).astype(np.float32)
            xsum = xp[:, sl].sum(1).astype(np.float32)
            row = slab * rows + r if s.shape[0] > 1 else 0
            sv, zv = s[row], z[row]
            if slab:
                sv, zv = sv * np.float32(0.0625), zv * np.float32(16) - np.float32(128)
            acc = acc + part * sv - xsum[:, None] * (sv * zv)
    return acc * sx[:, None]


def _slab_codes(a, b, i):
    """``slab_codes<false>`` of csrc/wa_slab_mma.cuh: slab i's four s21 codes
    from an A word and a B word: field i / 2 of A (field 3 flipped back)
    plus 4 * bit i of B (rotated to bit 2 of each byte)."""
    rot = (i + 30) & 31
    rotr = ((b >> U32(rot)) | (b << U32((32 - rot) & 31))) if rot else b
    f = (a >> U32(2 * (i >> 1))) & U32(0x03030303)
    return (f ^ U32(0x02020202 if (i >> 1) == 3 else 0)) | (rotr & U32(0x04040404))


def _slab_kernel_model(plane, sx, qw, s, z, bits):
    """The byte (``bits`` 8) or s21 (3) case of the int8 slab kernel with one
    plane, in numpy.  Each slab's codes as the kernel reads them: the byte
    layout's stored bytes read as int8 (the JAX bitcast; zeros stored
    shifted alike), or ``slab_codes`` of slab i's A rows ((i % 2) Kb ..)
    and the B rows (2 Kb ..), a word holding four channels.  Per slab and
    group (side row ``slab * Kb / g + r``, load_sides' grow; per-channel:
    the one row): part = pa, xsum the plain sum of the group's codes, acc +=
    part * s - xsum * (s * z); then acc * sx."""
    rows_q, n = qw.shape
    if bits == 8:
        slabs, kb = 1, rows_q
        codes = [qw.view(np.int8).astype(np.int64)]
    else:
        slabs, kb = 8, rows_q // 3
        words = qw.reshape(rows_q, n // 4, 4).copy().view(U32)[..., 0]
        a_rows, b_rows = (words[:kb], words[kb:2 * kb]), words[2 * kb:]
        codes = [_slab_codes(a_rows[i % 2], b_rows, i).copy().view(np.uint8)
                 .reshape(kb, n).astype(np.int64) for i in range(slabs)]
    g = kb if s.shape[0] == 1 else slabs * kb // s.shape[0]
    acc = np.zeros((plane.shape[0], n), np.float32)
    for slab in range(slabs):
        xp = plane[:, slab * kb:(slab + 1) * kb].astype(np.int64)
        for r in range(kb // g):
            sl = slice(r * g, (r + 1) * g)
            part = (xp[:, sl] @ codes[slab][sl]).astype(np.float32)
            xsum = xp[:, sl].sum(1).astype(np.float32)
            row = slab * (kb // g) + r if s.shape[0] > 1 else 0
            sv, zv = s[row], z[row if z.shape[0] > 1 else 0]
            acc = acc + part * sv - xsum[:, None] * (sv * zv)
    return acc * sx[:, None]


def _a8_reference(case, dtype):
    """(JAX ``fused_quantized_matmul`` with int8 x in interpret mode, the
    port's plain version, the port's A8 plane [M, K_stored] and sx, the
    f32 scales and zeros) for one case, x of ``dtype``."""
    jq, tq = _artifact(case)
    spec, k, _ = CASES[case]
    layout, _, name = LAYOUT_OF[spec.bits]
    assert j_dm._layout_supported(jq, jq.scales.shape[0])
    assert tq.k_pad == tq.k_stored - k and tq.k_stored in (512, 1024)
    assert dm.kernel_name(tq, None, 8) == name and dm.SLAB_MMA[name] == layout
    x = _x((6, k), seed=7, scale=2.0)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_dm.fused_quantized_matmul(xj, jq, activation_bits=8, interpret=True),
                      dtype=np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    planes, sx = dm.quantize_activations(xt, 8)
    plane = np.pad(planes[0].numpy(), ((0, 0), (0, tq.k_stored - k)))
    dm.reset_counts()
    plain = dm.fused_quantized_matmul(xt.to(torch.float32 if dtype == np.float32
                                            else torch.bfloat16), tq,
                                      activation_bits=8).float().numpy()
    assert dm.PLAIN_CALLS[name] == 1 == sum(dm.PLAIN_CALLS.values())
    s, z = (np.asarray(a, np.float32) for a in (jq.scales, jq.zeros))
    return want, plain, plane, sx.numpy(), s, z


def _assert_a8_close(got, plain, want, dtype):
    """f32 x: the Pallas tests' tolerance; bf16 x: within 1e-2 of the
    largest output (the JAX kernel rounds its output to bf16)."""
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(plain, want, **TOL)
    else:
        for y in (got, plain):
            assert np.abs(y - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [c for c in CASES if c not in NIB4_CASES])
def test_one_plane_byte_and_s21_models_equal_jax_int8_and_int3_kernels_a8(case, dtype):
    """The byte and s21 models on the port's A8 codes equal ``_int8_kernel``
    and ``_int3_kernel`` with int8 x (interpret mode), and so does the
    port's plain version."""
    want, plain, plane, sx, s, z = _a8_reference(case, dtype)
    jq, _ = _artifact(case)
    got = _slab_kernel_model(plane, sx, np.asarray(jq.qweight), s, z, CASES[case][0].bits)
    _assert_a8_close(got, plain, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", NIB4_CASES)
def test_one_plane_model_equals_jax_int4_kernel_a8(case, dtype):
    """The model on the port's A8 codes equals ``_int4_kernel`` with int8 x
    (interpret mode) at the Pallas tests' tolerance for f32 x and within
    1e-2 of the largest output for bf16 x (the JAX kernel rounds its output
    to bf16), and so does the port's plain version."""
    want, plain, plane, sx, s, z = _a8_reference(case, dtype)
    jq, _ = _artifact(case)
    got = _a8_kernel_model(plane, sx, np.asarray(jq.qweight), s, z)
    _assert_a8_close(got, plain, want, dtype)


# ------------------------------------------------------------ the row pass

def _slab_row_pass(x, ks, kb, g):
    """The one-plane row pass as the kernel writes it, from the port's plain
    codes: the plane [1][M][S][Kb32] (slab i's rows r < Kb hold K column
    i*Kb + r, the rest zero; the logical K's padding zero), sx [M], and the
    group sums [M][S*Kb/g] (the plain sum of each group's codes, groups in
    K order)."""
    planes, sx = dm.quantize_activations(torch.from_numpy(x), 8)
    m, k = x.shape
    slabs, kb32 = ks // kb, -(-kb // dm.SLAB_WINDOW) * dm.SLAB_WINDOW
    codes = np.pad(planes[0].numpy(), ((0, 0), (0, ks - k)))
    plane = np.zeros((1, m, slabs, kb32), np.int8)
    plane[0, :, :, :kb] = codes.reshape(m, slabs, kb)
    sums = codes.astype(np.int64).reshape(m, ks // g, g).sum(-1).astype(np.int32)
    return plane, sx.numpy(), sums


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_one_plane_row_pass_holds_the_jax_codes_and_sums(case, dtype):
    """Read back in K order the plane holds the JAX ``_prep_x`` A8 codes,
    its row scales are the JAX ``sx`` bit for bit, its group sums (also
    ``activation_group_sums`` of the one plane) are the JAX xsum (the plain
    int sum of the group's codes), and plane and sums fill
    ``slab_scratch_bytes`` with one plane: S = 2 (nib4), 1 (byte), 8 (s21)."""
    jq, tq = _artifact(case)
    k, ks = CASES[case][1], tq.k_stored
    layout, slabs, _ = LAYOUT_OF[CASES[case][0].bits]
    kb = ks // slabs
    g = dm._group_size(tq, tq.scales.shape[0])
    x = _x((5, k), seed=3, scale=3.0)
    x[2] = 0
    x = np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    plane, sx, sums = _slab_row_pass(x, ks, kb, g)

    xq, m, *_, sxj = j_dm._prep_x(jnp.asarray(x), k, 8)
    xq = np.pad(np.asarray(xq)[:m].astype(np.int64), ((0, 0), (0, ks - k)))
    np.testing.assert_array_equal(plane[0, :, :, :kb].reshape(m, ks), xq)
    assert not plane[0, :, :, kb:].any()
    np.testing.assert_array_equal(sx.view(np.uint32),
                                  np.asarray(sxj)[:m, 0].astype(np.float32).view(np.uint32))
    want = xq.reshape(m, ks // g, g).sum(-1)
    np.testing.assert_array_equal(sums, want)
    padded = torch.from_numpy(xq.astype(np.int8))[None]
    np.testing.assert_array_equal(dm.activation_group_sums(padded, g).numpy(), want)
    assert plane.shape[2] == slabs and sums.shape[1] == ks // g
    assert dm.slab_scratch_bytes(m, kb, layout, g, True, 1) == plane.nbytes + sums.nbytes
    assert dm.slab_scratch_bytes(m, kb, layout, g, True, 2) == 2 * plane.nbytes + sums.nbytes


# ------------------------------------------------------- tiles and plan

SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
             "down": (11008, 4096), "lm_head": (4096, 32256)}


# the one-plane wide tile of each layout (tokens, channels, parts)
WIDE_A8 = {"nib4": (64, 64, 2), "byte": (64, 64, 4), "s21": (32, 64, 1)}


@pytest.mark.parametrize("layout", list(WIDE_A8))
@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 296, 512])
@pytest.mark.parametrize("shape", list(SHAPES_7B))
def test_one_plane_split_plan_covers_every_row_once(shape, m, layout):
    """One plane: the decode tile is the layout's A16 one (nib4: 8 tokens,
    128 channels, two parts; byte: four parts; s21: 64 channels, one part),
    the wide tile 64 tokens of 64 channels in two (nib4) or four (byte)
    parts, or 32 tokens (s21); every split and every part starts on a
    window, the splits and their parts cover the slab rows (K/2, K, the K/8
    B rows of K padded to 1024) once in order, and the plan depends on the
    shapes alone."""
    k, n = SHAPES_7B[shape]
    slabs = {"nib4": 2, "byte": 1, "s21": 8}[layout]
    kb = (-(-k // 1024) * 1024 if layout == "s21" else k) // slabs
    tile = dm.slab_tile(m, layout, 1)
    assert tile == (dm.slab_tile(m, layout) if m <= 8 else WIDE_A8[layout])
    kc, splits = dm.plan_slab_splits(m, n, kb, layout, 132, planes=1)
    parts = tile[2]
    assert kc % (dm.SLAB_WINDOW * parts) == 0 and kc * splits >= kb > kc * (splits - 1)
    kq, rows = kc // parts, []
    for i in range(splits):
        k0, k1 = i * kc, min(kb, (i + 1) * kc)
        for p in range(parts):
            p0, p1 = k0 + p * kq, min(k1, k0 + (p + 1) * kq)
            assert p0 % dm.SLAB_WINDOW == 0
            rows += range(p0, p1)
    assert rows == list(range(kb))
    assert (kc, splits) == dm.plan_slab_splits(m, n, kb, layout, 132, planes=1)


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
    """The wrapper's A8 launch, as fused_quantized_matmul(_stacked) calls it."""
    x2 = dm._prep_x(x, qt, 8)
    if layer is None:
        return dm._launch(dm.packed_bits(qt), pre_norm, x2, qt.qweight, qt.scales, qt.zeros,
                          qt.scales.shape[0], qt.shape[0], qt.shape[1], 8)
    return dm._launch(dm.packed_bits(qt), pre_norm, x2, qt.qweight[layer], qt.scales[layer],
                      qt.zeros[layer], qt.scales.shape[1] - qt.side_pad, qt.shape[0],
                      qt.shape[1], 8)


DISPATCH = {  # id: (spec, K, N, quantize_tensor kwargs)
    "g128_asym": (QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False), 1024, 256,
                  {}),
    "perchannel_asym_k1088": (QuantSpec(fmt="int", bits=4, group_size=PER_CHANNEL,
                                        symmetric=False), 1088, 256, {}),
    "g128_straddle_k1408": (QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False),
                            1408, 256, {}),
    "bfp4_npad": (QuantSpec(fmt="bfp", bits=4, group_size=128), 1024, 300,
                  dict(pad_n_to=512)),
    "g128_kpad": (QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False), 896, 256,
                  dict(pad_k_to=1024)),
}


def _quantized(case, seed=0):
    spec, k, n, kw = DISPATCH[case]
    return quantize_tensor(torch.from_numpy(_x((k, n), seed=seed, scale=0.05)), spec, **kw)


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 9, 256])
@pytest.mark.parametrize("case", list(DISPATCH))
def test_w4a8_launches_the_one_plane_slab_kernel(card_free_launch, monkeypatch, case, m,
                                                 pre_norm):
    """bf16 and f32 x: ``iwoq_w4a8_matmul`` with the nib4 layout's plan
    (parts of the block's range on windows), its group (groups straddling
    the K halves split in two), the pre-norm for the row pass, and the
    scratch of one plane and the group sums; one ``w4a8_matmul`` launch
    each."""
    qt = _quantized(case)
    assert dm.kernel_supported(qt, 8) and dm.kernel_name(qt, pre_norm, 8) == dm.W4A8
    scratch = []
    real = dm.slab_scratch_bytes
    monkeypatch.setattr(dm, "slab_scratch_bytes", lambda *a: scratch.append(a) or real(*a))
    k, ks, n = qt.shape[0], qt.k_stored, qt.qweight.shape[1]
    kp = ks // 2
    g = dm._group_size(qt, qt.scales.shape[0])
    kc, splits = dm.plan_slab_splits(m, n, kp, "nib4", 132, planes=1)
    assert kc % (dm.SLAB_WINDOW * dm.slab_tile(m, "nib4", 1)[2]) == 0
    assert kc * splits >= kp > kc * (splits - 1)
    x = torch.from_numpy(_x((m, k), seed=3))
    for dtype in (torch.bfloat16, torch.float32):
        card_free_launch.calls.clear()
        _launch(qt, x.to(dtype), pre_norm)
        (name, symbol, args), = card_free_launch.calls
        assert (name, symbol) == (dm.W4A8, "iwoq_w4a8_matmul")
        assert args[1:5] == (int(dtype == torch.bfloat16), k, int(pre_norm is not None),
                             pre_norm or 0.0)
        assert args[19:23] == (kp, g, kc, splits)
    assert scratch == [(m, kp, "nib4", g, True, 1)] * 2  # one plane
    assert dm.LAUNCHES[dm.W4A8] == 2 == sum(dm.LAUNCHES.values())


def test_stacked_w4a8_reads_its_layer(card_free_launch):
    """A layer-stacked artifact (side info padded by 2 rows): the one-plane
    slab kernel reads layer 1's weights and sides in place."""
    qts = [_quantized("g128_asym", seed=i) for i in range(2)]
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 2))  # noqa: E731
    st = qts[0].replace(qweight=torch.stack([q.qweight for q in qts]),
                        scales=torch.stack([pad(q.scales) for q in qts]),
                        zeros=torch.stack([pad(q.zeros) for q in qts]), side_pad=2)
    assert dm.kernel_supported_stacked(st, 8)
    _launch(st, torch.from_numpy(_x((8, 1024), seed=4)).to(torch.bfloat16), layer=1)
    (name, symbol, args), = card_free_launch.calls
    assert (name, symbol) == (dm.W4A8, "iwoq_w4a8_matmul")
    assert args[5] == st.qweight[1].data_ptr() and args[6] == st.scales[1].data_ptr()
    assert args[7:9] == (256, 1) and dm.LAUNCHES[dm.W4A8] == 1


A8_DISPATCH = {  # id: (K, quantize_tensor kwargs) of a w8a8 and a w3a8 artifact, N = 256
    "g128_asym": (1024, {}),
    "perchannel_asym_k1088": (1088, dict(group_size=PER_CHANNEL)),
    "g16_asym": (1024, dict(group_size=16)),
    "g128_kpad": (896, dict(pad_k_to=1024)),
}


@pytest.mark.parametrize("case", list(A8_DISPATCH))
@pytest.mark.parametrize("bits", [8, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w8a8_and_w3a8_launch_the_one_plane_slab_kernel(card_free_launch, monkeypatch, bits,
                                                        dtype, case):
    """``w8a8`` and ``w3a8`` are the byte and s21 layouts of the slab
    kernel with one plane: at M = 1, 8, 9 and 256, flat, with the pre-norm,
    and stacked at layer 1 (side info padded by 2 rows), a call reaches
    ``iwoq_w8a8_matmul`` or ``iwoq_w3a8_matmul`` with its slab rows (K, or
    the K/8 B rows), its group in slab rows, ``plan_slab_splits(...,
    planes=1)``'s ``kc, splits`` and the scratch of one plane and the group
    sums; one launch each."""
    k, kw = A8_DISPATCH[case]
    kw = dict(kw)
    spec = QuantSpec(fmt="int", bits=bits, group_size=kw.pop("group_size", 128),
                     symmetric=False)
    qts = [quantize_tensor(torch.from_numpy(_x((k, 256), seed=i, scale=0.05)), spec, **kw)
           for i in range(2)]
    qt = qts[0]
    name, layout = (dm.W8A8, "byte") if bits == 8 else (dm.W3A8, "s21")
    assert dm.kernel_supported(qt, 8) and dm.kernel_name(qt, EPS, 8) == name
    assert dm.SLAB_MMA[name] == layout
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 2))  # noqa: E731
    st = qt.replace(qweight=torch.stack([q.qweight for q in qts]),
                    scales=torch.stack([pad(q.scales) for q in qts]),
                    zeros=torch.stack([pad(q.zeros) for q in qts]), side_pad=2)
    assert dm.kernel_supported_stacked(st, 8)
    scratch = []
    real = dm.slab_scratch_bytes
    monkeypatch.setattr(dm, "slab_scratch_bytes", lambda *a: scratch.append(a) or real(*a))
    ks = qt.k_stored
    kp = ks if bits == 8 else ks // 8
    g = dm._group_size(qt, qt.scales.shape[0])
    calls = [(m, None, None) for m in (1, 8, 9, 256)] + [(8, EPS, None), (9, None, 1)]
    for m, pre_norm, layer in calls:
        card_free_launch.calls.clear()
        x = torch.from_numpy(_x((m, k), seed=5)).to(dtype)
        _launch(st if layer is not None else qt, x, pre_norm, layer)
        (lib_name, symbol, args), = card_free_launch.calls
        assert (lib_name, symbol) == (name, f"iwoq_{name}")
        assert args[1:5] == (int(dtype == torch.bfloat16), k, int(pre_norm is not None),
                             pre_norm or 0.0)
        if layer is not None:
            assert args[5] == st.qweight[layer].data_ptr()
            assert args[6] == st.scales[layer].data_ptr()
        kc, splits = dm.plan_slab_splits(m, 256, kp, layout, 132, planes=1)
        assert kc % (dm.SLAB_WINDOW * dm.slab_tile(m, layout, 1)[2]) == 0
        assert args[16:23] == (m, 256, 256, kp, g, kc, splits)
        assert scratch.pop() == (m, kp, layout, g, True, 1)  # one plane, then the sums
    assert dm.LAUNCHES[name] == len(calls) == sum(dm.LAUNCHES.values())


def test_step_times_probe_times_the_int_activation_kernels(monkeypatch):
    """The A/B harness ``probes/step_times.py`` (a file run on the card)
    names each int-activation kernel of the affine layouts with the storage
    bits that dispatch to it, and refuses to run without a card."""
    import importlib.util
    import pathlib

    path = pathlib.Path(dm.__file__).parents[2] / "probes" / "step_times.py"
    spec = importlib.util.spec_from_file_location("step_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.KERNELS) == {n for n in dm.SLAB_MMA if not n.startswith("lut")}
    for name, (bits, pad_k, _) in mod.KERNELS.items():
        assert dm._KERNELS[bits][2 + dm.ACTIVATION_BITS.index(8 if "a8" in name else 16)] == name
        assert pad_k == (1024 if bits == 3 else 1)
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "path", list(sys.path))  # main puts the tree first
        assert mod.main(["--kernels", "w8a8_matmul", "--ms", "8"]) == 1
