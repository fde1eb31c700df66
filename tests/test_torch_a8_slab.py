"""``w4a8_matmul`` as the one-plane (A8) mode of the int8 slab kernel,
against the JAX package, on the CPU.

``w4a8_matmul`` runs as the affine nib4 layout of the int8 slab kernel
(``csrc/wa_slab_mma.cuh``, ``PLANES = 1``): the row pass writes one int8
plane per slab and the plain sum of each group's codes, and the product
kernel multiplies that plane against the nib4 codes on the int8 tensor
cores.  What it computes is held to the plain version on the card
(``tests/test_torch_cuda.py -k slab_a8``).  Here:

* a numpy model of the one-plane arithmetic (the nib4 decode of the int8
  family, the low codes ``w & 0x0F0F0F0F`` and the high ones ``w &
  0xF0F0F0F0`` read as int8, 16 q - 128; per slab and group ``part = pa``,
  ``acc += part*sc - xsum*(sc*zc)`` with the high slab's sides folded to
  ``s/16`` and ``16z - 128``; then ``acc * sx``) equals the JAX
  ``_int4_kernel`` with int8 x (interpret mode), and so does the port's
  plain version, on g128 asymmetric, per-channel symmetric, g64 and
  ``k_pad`` artifacts, bf16 and f32 x;
* the one-plane row pass's layout (each slab padded to 32 rows) and group
  sums, modelled from the port's ``quantize_activations``, hold the JAX
  ``_prep_x`` codes and their integer group sums, and fill the scratch that
  ``slab_scratch_bytes`` sizes;
* the one-plane tiles (the decode tile of ``w4a16``, the 64-token wide
  tile) and their split plan, which covers every slab row once at the 7B
  shapes;
* dispatch: bf16 and f32 ``w4a8`` calls (flat and stacked) reach
  ``iwoq_w4a8_matmul`` with the one-plane plan and scratch, while
  ``w8a8`` and ``w3a8`` stay on their ``__dp4a`` kernels (the wrapper called
  on CPU tensors with a recording stand-in for the library).
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


CASES = {  # id: (JAX spec, K, quantize_tensor kwargs) at N = 256
    "g128_asym": (JSpec(fmt="int", bits=4, group_size=128, symmetric=False), 512, {}),
    "perchannel_sym": (JSpec(fmt="int", bits=4, group_size=J_PER_CHANNEL, symmetric=True),
                       512, {}),
    "g64_asym": (JSpec(fmt="int", bits=4, group_size=64, symmetric=False), 512, {}),
    "g128_asym_kpad": (JSpec(fmt="int", bits=4, group_size=128, symmetric=False), 384,
                       dict(pad_k_to=512)),
}


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


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_one_plane_model_equals_jax_int4_kernel_a8(case, dtype):
    """The model on the port's A8 codes equals ``_int4_kernel`` with int8 x
    (interpret mode) at the Pallas tests' tolerance for f32 x and within
    1e-2 of the largest output for bf16 x (the JAX kernel rounds its output
    to bf16), and so does the port's plain version."""
    jq, tq = _artifact(case)
    k = CASES[case][1]
    assert j_dm._layout_supported(jq, jq.scales.shape[0]) and tq.k_pad == 512 - k
    assert dm.kernel_name(tq, None, 8) == dm.W4A8 and dm.SLAB_MMA[dm.W4A8] == "nib4"
    x = _x((6, k), seed=7, scale=2.0)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_dm.fused_quantized_matmul(xj, jq, activation_bits=8, interpret=True),
                      dtype=np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    planes, sx = dm.quantize_activations(xt, 8)
    plane = np.pad(planes[0].numpy(), ((0, 0), (0, 512 - k)))
    s, z = (np.asarray(a, np.float32) for a in (jq.scales, jq.zeros))
    got = _a8_kernel_model(plane, sx.numpy(), np.asarray(jq.qweight), s, z)
    dm.reset_counts()
    plain = dm.fused_quantized_matmul(xt.to(torch.float32 if dtype == np.float32
                                            else torch.bfloat16), tq,
                                      activation_bits=8).float().numpy()
    assert dm.PLAIN_CALLS[dm.W4A8] == 1 == sum(dm.PLAIN_CALLS.values())
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(plain, want, **TOL)
    else:
        for y in (got, plain):
            assert np.abs(y - want).max() <= 1e-2 * np.abs(want).max()


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
    ``slab_scratch_bytes`` with one plane."""
    jq, tq = _artifact(case)
    k, ks = CASES[case][1], tq.k_stored
    kb = ks // 2
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
    assert dm.slab_scratch_bytes(m, kb, "nib4", g, True, 1) == plane.nbytes + sums.nbytes
    assert dm.slab_scratch_bytes(m, kb, "nib4", g, True, 2) == 2 * plane.nbytes + sums.nbytes


# ------------------------------------------------------- tiles and plan

SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
             "down": (11008, 4096), "lm_head": (4096, 32256)}


@pytest.mark.parametrize("m", [1, 8, 9, 64, 256, 296, 512])
@pytest.mark.parametrize("shape", list(SHAPES_7B))
def test_one_plane_split_plan_covers_every_row_once(shape, m):
    """One plane: the decode tile is w4a16's (8 tokens, 128 channels, two
    parts), the wide tile 64 tokens of 64 channels in two parts; every
    split and every part starts on a window, the splits and their parts
    cover the K/2 slab rows once in order, and the plan depends on the
    shapes alone."""
    k, n = SHAPES_7B[shape]
    kb = k // 2
    tile = dm.slab_tile(m, "nib4", 1)
    assert tile == (dm.slab_tile(m, "nib4") if m <= 8 else (64, 64, 2))
    kc, splits = dm.plan_slab_splits(m, n, kb, "nib4", 132, planes=1)
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
    assert (kc, splits) == dm.plan_slab_splits(m, n, kb, "nib4", 132, planes=1)


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


@pytest.mark.parametrize("bits", [8, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w8a8_and_w3a8_stay_on_their_dp4a_kernels(card_free_launch, bits, dtype):
    """``w8a8`` and ``w3a8`` keep the ``__dp4a`` kernels of
    ``csrc/wa_common.cuh``: off the slab table, the CUDA-core split plan
    and one plane ``[1, M, K_stored]`` of scratch."""
    spec = QuantSpec(fmt="int", bits=bits, group_size=128, symmetric=False)
    qt = quantize_tensor(torch.from_numpy(_x((1024, 256), scale=0.05)), spec)
    name = dm.kernel_name(qt, None, 8)
    assert name == (dm.W8A8 if bits == 8 else dm.W3A8) and name not in dm.SLAB_MMA
    _launch(qt, torch.from_numpy(_x((64, 1024), seed=5)).to(dtype))
    (lib_name, symbol, args), = card_free_launch.calls
    assert (lib_name, symbol) == (name, f"iwoq_{name}")
    kp = 1024 if bits == 8 else 1024 // 8
    kc, splits = dm.plan_splits(64, 256, kp, 132)
    assert args[19:23] == (kp, 128, kc, splits)
    assert dm.LAUNCHES[name] == 1 == sum(dm.LAUNCHES.values())
