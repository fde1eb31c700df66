"""``w4a16_matmul`` on the int8 slab kernel and the bf16 route of
``w3_matmul``, against the JAX package and the kernels' own tables, on the CPU.

``w4a16_matmul`` runs as the affine nib4 layout of the int8 slab kernel
(``csrc/wa_slab_mma.cuh``), and the bf16-x calls of ``w3_matmul`` as the s21
layout of its bf16 family; what the kernels compute is held to the plain
versions on the card (``tests/test_torch_cuda.py``, ``-k slab`` and ``-k
mma``).  Here:

* the Python tile table (``SLAB_TILES``, ``SLAB_LAYOUT_IDS``, what
  :func:`slab_tile` gives at every row count) equals the C++ ``SlabTile``
  and ``slab_tile_nt`` of ``csrc/slab_tile.cuh``, compiled with the host
  compiler, for every layout;
* a numpy model of the affine nib4 decode and group epilogue (the low codes
  ``w & 0x0F0F0F0F``, the high ones ``w & 0xF0F0F0F0`` read as int8, their
  sides folded to ``s/16`` and ``16z - 128``), over all 256 byte values,
  gives the codes of the JAX ``_int4_kernel_a16`` and, end to end, its
  result (interpret mode), by the ``_group_accum_a16`` algebra;
* ``slab_codes`` and ``int_codes_bf16`` written out in numpy give every
  code of a packed s21 artifact and its exact bf16 value;
* dispatch: bf16 W3 takes the route (``iwoq_w3_matmul_mma``) and f32 W3
  the CUDA-core kernel (``iwoq_w3_matmul``), both counted as
  ``w3_matmul``; ``w4a16`` launches the slab kernel with its scratch and
  split plan (the wrapper called on CPU tensors with a recording stand-in
  for the library);
* a W3 ``pre_norm`` call, which the route applies in its row pass, equals
  the JAX package's normalize-then-``_int3_kernel`` (interpret mode).
"""

import contextlib
import functools
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iron_weight_only_quant_tpu.config import PER_CHANNEL
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.ops.pallas import dequant_matmul as j_dm
from iron_weight_only_quant_tpu.quantize import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import QuantSpec
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.ops.kernels import build
from iron_weight_only_quant_tpu_torch.ops.kernels import dequant_matmul as dm
from iron_weight_only_quant_tpu_torch.ops.packing import pack_codes
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor

TOL = dict(rtol=2e-5, atol=2e-4)
EPS = 1e-5
U32 = np.uint32
W3_SPEC = dict(fmt="int", bits=3, group_size=128, symmetric=False)
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
def _artifact(spec_items, k=512, n=256):
    """The file's tiny artifact of a spec, in both packages (quantized once,
    by JAX)."""
    jq = j_quantize(jnp.asarray(_x((k, n), seed=0, scale=0.05)), JSpec(**dict(spec_items)))
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


# ------------------------------------------------ tiles: Python == C++

ROWS = (1, 8, 9, 64, 256, 512)
_TILE_PROGRAM = r"""
#include <cstdio>
#include <initializer_list>
#include "slab_tile.cuh"
using namespace iwoq;
template <int L, int NT> void tile() {
  using T = SlabTile<L, NT>;
  std::printf(" %d %d %d %d %d", T::S, T::MT, T::BN, T::P, NT);
}
template <int L> void layout() {
  std::printf("%d", L);
  tile<L, 1>();
  tile<L, slab_tile_nt(9, L)>();
  for (int m : {%ROWS%}) std::printf(" %d", slab_tile_nt(m, L));
  tile<L, slab_tile_nt(9, L, 1)>();  // one activation plane (A8)
  for (int m : {%ROWS%}) std::printf(" %d", slab_tile_nt(m, L, 1));
  std::printf("\n");
}
int main() {
  layout<kNib4>(); layout<kByte>(); layout<kS21>(); layout<kLut4>(); layout<kLut6>();
  layout<kLut4B>(); layout<kLut6B>(); layout<kS21B>(); layout<kNib4B>(); layout<kByteB>();
  layout<kLut8B>(); layout<kNib4M>(); layout<kNib4T>();
}
"""


@pytest.fixture(scope="module")
def cuda_tiles(tmp_path_factory):
    """{layout id: (slabs, decode tile, wide tile, NT per row count, the
    one-plane wide tile, its NT per row count)} as the C++ header computes
    them, each tile (tokens, channels, parts, NT)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to read csrc/slab_tile.cuh"
    d = tmp_path_factory.mktemp("slab_tile")
    src = d / "tiles.cpp"
    src.write_text(_TILE_PROGRAM.replace("%ROWS%", ", ".join(map(str, ROWS))))
    exe = d / "tiles"
    done = subprocess.run([cxx, "-std=c++17", "-I", str(build.CSRC_DIR), "-o", str(exe),
                           str(src)], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                         timeout=60).stdout
    tiles = {}
    n = len(ROWS)
    for line in out.splitlines():
        v = [int(t) for t in line.split()]
        a8 = 11 + n  # the one-plane wide tile's fields
        assert v[1] == v[6] == v[a8] and len(v) == a8 + 5 + n  # one slab count a layout
        tiles[v[0]] = (v[1], tuple(v[2:6]), tuple(v[7:11]), tuple(v[11:a8]),
                       tuple(v[a8 + 1:a8 + 5]), tuple(v[a8 + 5:]))
    return tiles


@pytest.mark.parametrize("layout", list(dm.SLAB_TILES))
def test_python_tiles_equal_the_cuda_tiles(cuda_tiles, layout):
    """SLAB_TILES holds SlabTile's S and its (MT, BN, P) at NT = 1 and at
    the wide NT, SLAB_TILES_A8 the one-plane wide tile where slab_tile_nt
    gives one plane another NT, and :func:`slab_tile` picks the tile
    slab_tile_nt picks at every row count, with two planes and with one,
    for every layout of the Layout enum."""
    assert sorted(dm.SLAB_LAYOUT_IDS.values()) == sorted(cuda_tiles) == list(range(13))
    slabs, decode, wide, nts, wide_a8, nts_a8 = cuda_tiles[dm.SLAB_LAYOUT_IDS[layout]]
    assert dm.SLAB_TILES[layout] == (slabs, decode[:3], wide[:3])
    assert decode[3] == 1 and decode[0] == 8
    assert (layout in dm.SLAB_TILES_A8) == (wide_a8 != wide)
    assert dm.SLAB_TILES_A8.get(layout, wide[:3]) == wide_a8[:3]
    for planes, wide_p, nts_p in ((2, wide, nts), (1, wide_a8, nts_a8)):
        for m, nt in zip(ROWS, nts_p):
            assert dm.slab_tile(m, layout, planes) == (decode if nt == 1 else wide_p)[:3]
            assert dm.slab_tile(m, layout, planes)[0] == 8 * nt


def test_every_slab_kernel_has_its_layout():
    """The slab kernels, the bf16 route and the W4 inner-loop probe's two
    tensor-core routes name a layout each, but for five pairs that share
    one: each A8 kernel (one plane) and the A16 kernel (two) of its storage
    bits on the affine nib4, byte and s21 layouts of the int8 family
    (``w4a8`` and ``w4a16``, ``w8a8`` and ``w8a16``, ``w3a8`` and
    ``w3a16``), and each prenorm kernel of the bf16 route with its flat
    kernel (``w4_matmul``, ``w8_matmul``); the nib4 packing is shared by the
    affine and LUT layouts of each family and by the probe's two, and the
    byte packing by the bf16 family's affine and LUT layouts, with the same
    tiles.  Every int-activation kernel is a slab kernel."""
    assert set(dm.SLAB_MMA) == {dm.W4A16, dm.W8A16, dm.W3A16, dm.LUT4A16, dm.LUT6A16,
                                dm.W4A8, dm.W8A8, dm.W3A8}
    assert set(dm.BF16_MMA) == {dm.LUT4, dm.LUT6, dm.LUT8, dm.W3, dm.W4, dm.W4_PRENORM,
                                dm.W8, dm.W8_PRENORM}
    assert {n for table in (dm._KERNELS, dm._LUT_KERNELS) for names in table.values()
            for n in names[2:] if n is not None} == set(dm.SLAB_MMA)
    assert dm.SLAB_MMA[dm.W4A8] == dm.SLAB_MMA[dm.W4A16] == "nib4"
    assert dm.SLAB_MMA[dm.W8A8] == dm.SLAB_MMA[dm.W8A16] == "byte"
    assert dm.SLAB_MMA[dm.W3A8] == dm.SLAB_MMA[dm.W3A16] == "s21"
    assert dm.BF16_MMA[dm.W4] == dm.BF16_MMA[dm.W4_PRENORM] == "nib4_bf16"
    assert dm.BF16_MMA[dm.W8] == dm.BF16_MMA[dm.W8_PRENORM] == "byte_bf16"
    layouts = (list(dm.SLAB_MMA.values()) + list(dm.BF16_MMA.values())
               + list(dm.W4_INNER_MMA.values()))
    assert sorted(set(layouts)) == sorted(dm.SLAB_TILES)
    assert len(set(layouts)) == len(layouts) - 5
    assert dm.SLAB_TILES["nib4"] == dm.SLAB_TILES["lut4"]  # the same packing and tiles
    assert dm.SLAB_TILES["nib4_bf16"] == dm.SLAB_TILES["lut4_bf16"]
    assert dm.SLAB_TILES["byte_bf16"] == dm.SLAB_TILES["lut8_bf16"]
    assert dm.SLAB_TILES["nib4_bf16"] == dm.SLAB_TILES["nib4_magic_bf16"] \
        == dm.SLAB_TILES["nib4_tf32_bf16"]


# ------------------------------------------- affine nib4: decode and epilogue

def _nib4_decode(words):
    """The kernel's decode of packed nib4 words (uint32, bytes = rows of a
    channel): (low codes q, high codes 16 q - 128) as int8 bytes."""
    lo = (words & U32(0x0F0F0F0F)).view(np.int8)
    hi = (words & U32(0xF0F0F0F0)).view(np.int8)
    return lo, hi


def test_nib4_decode_gives_the_jax_codes_for_every_byte():
    """Every byte value, in every byte of a word: the low code is the JAX
    ``(qw & 0xF)``, the high one ``bitcast(qw, int8) & -16``, which is 16
    times the logical high code (the stored nibble flipped back) minus
    128."""
    b = np.arange(256, dtype=np.uint8)
    for rot in range(4):
        words = np.roll(b.reshape(-1, 4), rot, axis=1).copy().view(U32).reshape(-1)
        lo, hi = _nib4_decode(words)
        qw = np.roll(b.reshape(-1, 4), rot, axis=1).reshape(-1)
        jq = jnp.asarray(qw)
        np.testing.assert_array_equal(lo, np.asarray((jq & 0xF).astype(jnp.int8)))
        np.testing.assert_array_equal(
            hi, np.asarray(jax.lax.bitcast_convert_type(jq, jnp.int8) & jnp.int8(-16)))
        q_hi = (qw.astype(np.int32) >> 4) ^ 8  # the logical high code
        np.testing.assert_array_equal(hi.astype(np.int32), 16 * q_hi - 128)


def _nib4_kernel_model(planes, sx, qw, s, z, g):
    """The affine nib4 case of the int8 slab kernel in numpy: per slab
    (low, high nibbles) and group, each plane's exact integer product with
    the decoded codes turned f32, part = 256 pa + pb, and acc += part * sc -
    xsum * (sc * zc) with the high slab's sides folded (sc = s / 16, zc =
    16 z - 128, as load_sides does); then acc * sx."""
    kp, n = qw.shape
    words = qw.T.copy().view(U32)  # [N, Kp/4]: a channel's four rows a word
    lo, hi = (c.reshape(n, kp).T.astype(np.int64) for c in _nib4_decode(words.reshape(-1)))
    rows = kp // g
    acc = np.zeros((planes.shape[1], n), np.float32)
    for slab, codes in ((0, lo), (1, hi)):
        xp = planes[:, :, slab * kp:(slab + 1) * kp].astype(np.int64)
        for r in range(rows):
            sl = slice(r * g, (r + 1) * g)
            pa, pb = (xp[p][:, sl] @ codes[sl] for p in (0, 1))
            part = pa.astype(np.float32) * np.float32(256) + pb.astype(np.float32)
            xsum = (256 * xp[0][:, sl].sum(1) + xp[1][:, sl].sum(1)).astype(np.float32)
            sv, zv = s[slab * rows + r], z[slab * rows + r]
            if slab:
                sv, zv = sv * np.float32(0.0625), zv * np.float32(16) - np.float32(128)
                np.testing.assert_array_equal(  # sc * zc is the JAX s * (z - 8), bit for bit
                    sv * zv, s[rows + r] * (z[rows + r] - np.float32(8)))
            acc = acc + part * sv - xsum[:, None] * (sv * zv)
    return acc * sx[:, None]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_nib4_model_equals_jax_int4_kernel_a16_on_every_byte(dtype):
    """An artifact whose packed bytes take all 256 values, each many times:
    the numpy model of the kernel equals the JAX A16 kernel (interpret
    mode) at the Pallas tests' tolerance, and the port's plain version."""
    jq, _ = _artifact(tuple(W4_SPEC.items()))
    kp, n = jq.qweight.shape
    rng = np.random.default_rng(5)
    qw = rng.permutation(np.resize(np.arange(256, dtype=np.uint8), kp * n)).reshape(kp, n)
    jq = jq.replace(qweight=jnp.asarray(qw))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    x = _x((6, 2 * kp), seed=7, scale=2.0)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_dm.fused_quantized_matmul(xj, jq, interpret=True, activation_bits=16),
                      dtype=np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    planes, sx = dm.quantize_activations(xt, 16)
    s, z = (np.asarray(a, np.float32) for a in (jq.scales, jq.zeros))
    got = _nib4_kernel_model(planes.numpy(), sx.numpy(), qw, s, z, (2 * kp) // s.shape[0])
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, **TOL)
        plain = dm.fused_quantized_matmul(xt, tq, activation_bits=16).numpy()
        np.testing.assert_allclose(plain, want, **TOL)
    else:  # the JAX kernel rounds its output to bf16
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# ------------------------------------------------------- s21 to exact bf16

def _slab_codes(a, b, i):
    """``slab_codes<false>`` of csrc/wa_slab_mma.cuh: slab i's four codes from
    an A word and a B word: field i / 2 of A (field 3 flipped back) plus 4 *
    bit i of B (rotated to bit 2 of each byte)."""
    rot = (i + 30) & 31
    rotr = ((b >> U32(rot)) | (b << U32((32 - rot) & 31))) if rot else b
    f = (a >> U32(2 * (i >> 1))) & U32(0x03030303)
    return (f ^ U32(0x02020202 if (i >> 1) == 3 else 0)) | (rotr & U32(0x04040404))


def _byte_perm(x, y, sel):
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(v.shape, dtype=np.uint64)
    for n in range(4):
        idx = (sel >> (4 * n)) & 7
        out |= ((v >> np.uint64(8 * idx)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def _bf16_fma_minus128(p):
    """``bf16x2_fma(p, 1.0, -128.0)``: each bf16 half times 1, minus 128, in
    f32 (exact here), back to bf16 (truncation: the result is exact)."""
    out = np.zeros_like(p)
    for h in (0, 16):
        f = (((p >> U32(h)) & U32(0xFFFF)) << U32(16)).view(np.float32) - np.float32(128)
        assert np.array_equal(f.view(U32) & U32(0xFFFF), np.zeros_like(p))
        out |= (f.view(U32) >> U32(16)) << U32(h)
    return out


def _int_codes_bf16(c):
    hi = np.full_like(c, 0x43434343)
    return (_bf16_fma_minus128(_byte_perm(c, hi, 0x5140)),
            _bf16_fma_minus128(_byte_perm(c, hi, 0x7362)))


def test_s21_codes_decode_to_their_exact_bf16_values():
    """Random 3-bit codes packed by the port's s21 packing: for every slab
    and B row, slab_codes of the A and B words gives the slab's codes, and
    int_codes_bf16 gives their bf16 values, each byte position and code 0..7."""
    k, n = 256, 64
    codes = np.random.default_rng(8).integers(0, 8, size=(k, n)).astype(np.int32)
    codes[:8, :8] = np.arange(64).reshape(8, 8) % 8  # every code in every byte position
    packed = pack_codes(torch.from_numpy(codes), 3).numpy()
    kb = k // 8
    assert packed.shape == (3 * kb, n)
    words = packed.reshape(3 * kb, n // 4, 4).copy().view(U32)[..., 0]  # 4 channels a word
    bf16_of = (np.arange(8, dtype=np.float32).view(U32) >> U32(16)).astype(U32)
    for i in range(8):
        a, b = words[(i % 2) * kb:(i % 2 + 1) * kb], words[2 * kb:]
        c = _slab_codes(a, b, i)
        got = c.copy().view(np.uint8).reshape(kb, n)
        np.testing.assert_array_equal(got, codes[i * kb:(i + 1) * kb])
        p01, p23 = _int_codes_bf16(c)
        for j, (p, sh) in enumerate(((p01, 0), (p01, 16), (p23, 0), (p23, 16))):
            np.testing.assert_array_equal((p >> U32(sh)) & U32(0xFFFF),
                                          bf16_of[(c >> U32(8 * j)) & U32(0xFF)])


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


def _launch(qt, x, pre_norm=None, activation_bits=None):
    """The wrapper's launch, as fused_quantized_matmul calls it."""
    return dm._launch(dm.packed_bits(qt), pre_norm, dm._prep_x(x, qt, activation_bits),
                      qt.qweight, qt.scales, qt.zeros, qt.scales.shape[0], qt.shape[0],
                      qt.shape[1], activation_bits, dm._lut_format(qt))


@pytest.mark.parametrize("pre_norm", [None, EPS], ids=["flat", "pre_norm"])
@pytest.mark.parametrize("m", [1, 8, 64, 256])
def test_bf16_w3_takes_the_route_and_f32_w3_the_cuda_core_kernel(card_free_launch, m,
                                                                  pre_norm):
    """bf16 x: ``iwoq_w3_matmul_mma`` (no format widths, the zeros, the
    s21_bf16 tile's plan, the row pass's copy only for a pre-norm); f32 x:
    ``iwoq_w3_matmul``; one ``w3_matmul`` launch each, and the route rule
    agrees (a stacked artifact too)."""
    _, tq = _artifact(tuple(W3_SPEC.items()), k=1024)
    k = tq.shape[0]
    assert dm.kernel_name(tq) == dm.kernel_name(tq, pre_norm) == dm.W3
    assert dm.bf16_mma_route(tq, torch.bfloat16) and not dm.bf16_mma_route(tq, torch.float32)
    st = tq.map_arrays(lambda a: torch.stack([a, a]))
    assert dm.kernel_supported_stacked(st) and dm.bf16_mma_route(st, torch.bfloat16)
    x = torch.from_numpy(_x((m, k), seed=2))
    _launch(tq, x.to(torch.bfloat16), pre_norm)
    (name, symbol, args), = card_free_launch.calls
    assert (name, symbol) == (dm.W3, "iwoq_w3_matmul_mma")
    kb, g = k // 8, 128
    kc, splits = dm.plan_slab_splits(m, tq.qweight.shape[1], kb, "s21_bf16", 132)
    assert args[1:6] == (k, 0, k, int(pre_norm is not None), pre_norm or 0.0)
    assert args[10] is not None and (args[13] is None) == (pre_norm is None)
    assert args[19:25] == (kb, g, kc, splits, 0, 0)
    card_free_launch.calls.clear()
    if pre_norm is None:
        _launch(tq, x)
        (name, symbol, args), = card_free_launch.calls
        assert (name, symbol) == (dm.W3, "iwoq_w3_matmul")
    assert dm.LAUNCHES[dm.W3] == (2 if pre_norm is None else 1) == sum(dm.LAUNCHES.values())


def test_w3_outside_the_route_rule_stays_on_the_cuda_core_kernel():
    """K = 1056: K/8 = 132 slab rows, per-channel (one group a slab), a
    multiple of 4: the route; K = 1032 (129 rows): the CUDA-core kernel,
    bf16 or not, and its pre-norm in torch."""
    for k, routed in ((1056, True), (1032, False)):
        spec = QuantSpec(fmt="int", bits=3, group_size=PER_CHANNEL, symmetric=False)
        qt = quantize_tensor(torch.from_numpy(_x((k, 64), scale=0.05)), spec)
        assert dm.kernel_supported(qt) and dm.kernel_name(qt) == dm.W3
        assert dm.bf16_mma_route(qt, torch.bfloat16) == routed


@pytest.mark.parametrize("k", [512, 1408], ids=["k512", "k1408_straddle"])
@pytest.mark.parametrize("m", [1, 8, 9, 256])
def test_w4a16_launches_the_slab_kernel(card_free_launch, monkeypatch, m, k):
    """``iwoq_w4a16_matmul`` with the nib4 layout's plan and scratch: the
    planes padded per slab, then the group sums (an affine artifact always
    has them); K = 1408 has groups straddling the K halves, split in two
    per call (K/2 = 704 = 11 groups of 64)."""
    spec = QuantSpec(fmt="int", bits=4, group_size=128, symmetric=False)
    qt = quantize_tensor(torch.from_numpy(_x((k, 256), scale=0.05)), spec)
    assert dm.kernel_name(qt, None, 16) == dm.W4A16 and dm.SLAB_MMA[dm.W4A16] == "nib4"
    scratch = []
    real = dm.slab_scratch_bytes
    monkeypatch.setattr(dm, "slab_scratch_bytes",
                        lambda *a: scratch.append(a) or real(*a))
    _launch(qt, torch.from_numpy(_x((m, k), seed=3)), EPS, 16)
    (name, symbol, args), = card_free_launch.calls
    assert (name, symbol) == (dm.W4A16, "iwoq_w4a16_matmul")
    kp = k // 2
    g = 128 if kp % 128 == 0 else 64
    kc, splits = dm.plan_slab_splits(m, 256, kp, "nib4", 132)
    assert args[2:4] == (k, 1) and args[19:23] == (kp, g, kc, splits)
    assert scratch == [(m, kp, "nib4", g, True, 2)]  # two planes
    assert kc % (dm.SLAB_WINDOW * 2) == 0 and kc * splits >= kp > kc * (splits - 1)
    assert dm.LAUNCHES[dm.W4A16] == 1 == sum(dm.LAUNCHES.values())


# --------------------------------------------- pre_norm against the JAX kernel

@pytest.mark.parametrize("spec", ["g128_asym", "perchannel_asym"])
def test_w3_pre_norm_equals_jax_normalize_then_int3_kernel(spec):
    """The JAX package normalizes x, casts it back to x's type and runs
    ``_int3_kernel`` (interpret mode); the route applies the same norm in
    its row pass (f32 mean of squares, x*r rounded to bf16).  The port's
    CPU path, which the route is held to on the card, equals it at the
    Pallas tests' tolerance in f32 and at the route's (1e-2 of the largest
    output) in bf16."""
    kw = dict(W3_SPEC, group_size=PER_CHANNEL) if spec == "perchannel_asym" else W3_SPEC
    jq, tq = _artifact(tuple(kw.items()), k=1024)
    assert dm.bf16_mma_route(tq, torch.bfloat16) and not dm.prenorm_supported(tq)
    x = _x((6, 1024), seed=3, scale=2.0)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        want = np.asarray(j_dm.fused_quantized_matmul(jnp.asarray(x).astype(jdtype), jq,
                                                      interpret=True, pre_norm=EPS),
                          dtype=np.float32)
        dm.reset_counts()
        got = dm.fused_quantized_matmul(xt, tq, pre_norm=EPS).float().numpy()
        assert dm.PLAIN_CALLS[dm.W3] == 1 == sum(dm.PLAIN_CALLS.values())
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, **TOL)
        else:
            assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
