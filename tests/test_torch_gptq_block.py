"""Port parity: the GPTQ / TrueOBS block column loop (``gptq_block``).

On the CPU, where the CUDA kernel ``csrc/gptq_block.cu`` cannot run:

* the plain block function (``quantize.gptq.gptq_block_plain``, driven
  block by block through ``solve_gptq`` / ``solve_trueobs``) against the
  JAX solvers on the same numpy inputs, on one-block and two-block
  problems, in every mode the solvers compile: groups as wide as, narrower
  than and wider than a block, per-channel, symmetric, ``trits``, ``mse``,
  static groups under act-order, dead columns, and TrueOBS plain,
  ``nearest`` and ``sparseout``.  Tolerance: ``tests/test_gptq.py``'s
  criterion (at least 99.5% of q equal at rtol 1e-5, atol 1e-7, all
  within 0.3 max|w|; codes 99.5% equal), since XLA's compiled loop divides
  by the constant maxq as a product with its reciprocal;
* a torch model of the kernel's per-row operation order (one warp a row,
  lane ``l`` holding columns ``l + 32 k``, the pivot taken from its lane,
  min / max / mse sums as xor-butterfly reductions, every operation
  rounded on its own as ``__fmul_rn`` / ``__fsub_rn`` / ``__fdiv_rn`` and
  ``rintf`` round, the updates of columns after the pivot only) is bit-equal
  to the plain version in every mode without ``mse``, and meets the
  criterion with it;
* ``gptq_quantize`` and ``trueobs_quantize`` on CPU tensors call the plain
  block function once a block and never build or load the library.

The kernel itself against the plain version on the card:
``tests/test_torch_cuda.py -k gptq_block``.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.quantize import gptq as j_gptq
from iron_weight_only_quant_tpu.quantize import trueobs as j_obs
from iron_weight_only_quant_tpu_torch.ops.kernels import build
from iron_weight_only_quant_tpu_torch.ops.kernels import gptq_block as gb
from iron_weight_only_quant_tpu_torch.quantize import gptq as t_gptq
from iron_weight_only_quant_tpu_torch.quantize import trueobs as t_obs

GOLDEN = Path(__file__).parent / "golden"
# the golden weights are 24 x 64: blocksize 32 gives two blocks, 64 one
GPTQ_MODES = {  # id: (blocksize, gptq_quantize kwargs, dead columns)
    "g32_as_block_dead": (32, dict(bits=4, groupsize=32), (3, 40)),
    "perchannel_sym": (32, dict(bits=4, sym=True, groupsize=-1), ()),
    "g16_below_block_w3_sym": (32, dict(bits=3, sym=True, groupsize=16), ()),
    "g64_above_block": (32, dict(bits=4, groupsize=64), ()),
    "g24_clamped_last_group": (32, dict(bits=4, groupsize=24), ()),
    "trits": (32, dict(bits=2, sym=True, groupsize=-1, trits=True), ()),
    "mse_g16": (32, dict(bits=3, groupsize=16, mse=True), ()),
    "static_actorder_g16": (32, dict(bits=4, groupsize=16, static_groups=True, actorder=True),
                            ()),
    "one_block_g32": (64, dict(bits=4, groupsize=32), (17,)),
    "one_block_perchannel_w3": (64, dict(bits=3, groupsize=-1), ()),
}
OBS_MODES = {  # id: (blocksize, trueobs_quantize kwargs)
    "plain": (32, dict(bits=4)),
    "nearest": (32, dict(bits=4, nearest=True)),
    "sparseout": (32, dict(bits=2, sparseout=True)),
    "one_block_sparseout": (64, dict(bits=2, sparseout=True)),
}
# Each test takes a family of modes, so that the file holds fewer tests
# than tests/test_tp_block.py: pytest-xdist's loadfile queue runs files
# with more tests first, and a file queued ahead of that long one delays
# the whole run's end.
GPTQ_FAMILIES = {
    "groups": ("g32_as_block_dead", "g16_below_block_w3_sym", "g64_above_block",
               "g24_clamped_last_group"),
    "perchannel_trits": ("perchannel_sym", "trits"),
    "mse_static_actorder": ("mse_g16", "static_actorder_g16"),
    "one_block": ("one_block_g32", "one_block_perchannel_w3"),
}
assert sorted(m for f in GPTQ_FAMILIES.values() for m in f) == sorted(GPTQ_MODES)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN / "gptq.npz")
    return g["weight"], g["g16_asym_b4_H"]


def _problem(golden, dead=()):
    w, h = golden
    h = h.copy()
    h[list(dead), :] = 0.0
    h[:, list(dead)] = 0.0
    return w, h


def _np(a):
    return a.detach().cpu().numpy()


def _assert_close(ours, ref, w):
    """tests/test_gptq.py's criterion."""
    exact = np.isclose(ours, ref, rtol=1e-5, atol=1e-7)
    assert exact.mean() > 0.995, f"{100 * (1 - exact.mean()):.2f}% differ"
    np.testing.assert_allclose(ours, ref, atol=np.abs(w).max() * 0.3)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if torch.is_tensor(x):
            assert torch.equal(_bits(x), _bits(y)), name
        else:
            assert x is None and y is None, name


def _each(modes, check):
    for mode in modes:
        try:
            check(mode)
        except AssertionError as e:
            raise AssertionError(f"mode {mode}: {e}") from e


@pytest.mark.parametrize("family", list(GPTQ_FAMILIES))
def test_plain_block_solve_matches_jax(golden, family):
    _each(GPTQ_FAMILIES[family], lambda mode: _plain_vs_jax(golden, mode))


def _plain_vs_jax(golden, mode):
    blocksize, kw, dead = GPTQ_MODES[mode]
    w, h = _problem(golden, dead)
    ref = j_gptq.gptq_quantize(jnp.asarray(w), jnp.asarray(h), blocksize=blocksize, **kw)
    gb.reset_counts()
    res = t_gptq.solve_gptq(torch.from_numpy(w), torch.from_numpy(h), t_gptq.gptq_block_plain,
                            blocksize=blocksize, **kw)
    assert gb.PLAIN_CALLS[gb.GPTQ_BLOCK] == math.ceil(w.shape[1] / blocksize)
    _assert_close(_np(res.q), np.asarray(ref.q), w)
    assert (_np(res.codes) == np.asarray(ref.codes)).mean() > 0.995
    assert res.scales.shape == ref.scales.shape
    np.testing.assert_allclose(_np(res.scales), np.asarray(ref.scales), rtol=1e-5, atol=1e-7)
    if dead:
        assert np.abs(_np(res.q)[:, list(dead)]).max() <= np.abs(_np(res.scales)).max()


def test_plain_block_trueobs_matches_jax(golden):
    _each(OBS_MODES, lambda mode: _plain_vs_jax_trueobs(golden, mode))


def _plain_vs_jax_trueobs(golden, mode):
    blocksize, kw = OBS_MODES[mode]
    w, h = _problem(golden, (9,))
    ref = j_obs.trueobs_quantize(jnp.asarray(w), jnp.asarray(h), blocksize=blocksize, **kw)
    res = t_obs.solve_trueobs(torch.from_numpy(w), torch.from_numpy(h),
                              t_gptq.gptq_block_plain, blocksize=blocksize, **kw)
    _assert_close(_np(res.q), np.asarray(ref.q), w)
    assert (_np(res.codes) == np.asarray(ref.codes)).mean() > 0.995
    assert (_np(res.outliers) == np.asarray(ref.outliers)).mean() > 0.995
    assert _np(res.outliers).any() == kw.get("sparseout", False)
    close = np.isclose(_np(res.losses), np.asarray(ref.losses), rtol=1e-4, atol=1e-6)
    assert close.mean() > 0.995


# ------------------------------------------------- the kernel's arithmetic

def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def _butterfly(x, op):
    """``[rows, 32]`` lane values -> ``[rows]``: the xor-shuffle reduction
    of ``warp_min`` / ``warp_max`` / ``warp_sum``."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[:, lanes ^ o])
    return x[:, 0]


def _lanes(seg):
    """``[rows, width]`` -> ``[rows, ceil(width / 32), 32]``: lane ``l``'s
    values ``l, l + 32, ...``, zero-padded (a missing value adds nothing)."""
    rows, width = seg.shape
    out = torch.zeros((rows, -(-width // 32) * 32))
    out[:, :width] = seg
    return out.view(rows, -1, 32)


def _model_find_params(seg, loop):
    """``find_params`` of the kernel on a ``[rows, width]`` segment."""
    maxq = _f(2**loop.bits - 1)
    lanes = _lanes(seg)
    valid = _lanes(torch.ones_like(seg)).bool()
    mn = torch.where(valid, lanes, _f(math.inf)).amin(dim=1)  # each lane's own min first
    mx = torch.where(valid, lanes, _f(-math.inf)).amax(dim=1)
    xmin = torch.minimum(_butterfly(mn, torch.minimum), _f(0.0))
    xmax = torch.maximum(_butterfly(mx, torch.maximum), _f(0.0))
    if loop.sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    deg = (xmin == 0) & (xmax == 0)
    xmin = torch.where(deg, _f(-1.0), xmin)
    xmax = torch.where(deg, _f(1.0), xmax)
    if loop.trits:
        return xmax, xmin
    scale = (xmax - xmin) / maxq
    zero = ((maxq + 1) * 0.5).expand_as(scale) if loop.sym else torch.round(-xmin / scale)
    if loop.mse:
        best = torch.full_like(scale, math.inf)
        zero_sym = zero
        for s in range(int(gb.MSE_MAXSHRINK * gb.MSE_GRID)):
            p = _f(1.0) - _f(s) / _f(gb.MSE_GRID)
            xmin1, xmax1 = p * xmin, p * xmax
            scale1 = (xmax1 - xmin1) / maxq
            zero1 = zero_sym if loop.sym else torch.round(-xmin1 / scale1)
            c = torch.clamp(torch.round(seg / scale1[:, None]) + zero1[:, None], 0, maxq)
            r = (scale1[:, None] * (c - zero1[:, None]) - seg).abs().pow(gb.MSE_NORM)
            e = torch.zeros((seg.shape[0], 32))
            for part in _lanes(r).unbind(1):  # each lane's sum in its own order
                e = e + part
            e = _butterfly(e, torch.add)
            better = e < best
            best = torch.where(better, e, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)
    return scale, zero


def kernel_model(w, hinv, i1, i2, loop):
    """A torch model of one launch of ``csrc/gptq_block.cu``, vectorized over
    the rows (one warp each): the same operations, each rounded on its own,
    in the kernel's order and layout."""
    rows, cols = w.shape
    count = i2 - i1
    maxq = _f(2**loop.bits - 1)
    half = _f(0.5)
    v = _lanes(w[:, i1:i2].clone())  # [rows, slot, lane]
    out = {k: torch.zeros_like(v) for k in ("q", "code", "err", "loss")}
    sel_out = torch.zeros(v.shape, dtype=torch.bool)
    scale = zero = None
    g_now = -1
    for i in range(count):
        col = i1 + i
        kk, ii = divmod(i, 32)
        g = int(loop.gidx[col]) if loop.gidx is not None else col // loop.gsize
        if loop.refresh and col % loop.gsize == 0:
            start = min(col, cols - loop.gsize)
            scale, zero = _model_find_params(w[:, start:start + loop.gsize], loop)
            loop.scales[:, g] = scale
            loop.zeros[:, g] = zero
        elif g != g_now:
            scale, zero = loop.scales[:, g].clone(), loop.zeros[:, g].clone()
        g_now = g
        x = v[:, kk, ii].clone()  # __shfl_sync from lane ii
        d = hinv[col, col]
        if loop.trits:
            hi = x > scale * half
            lo = x < zero * half
            q = hi.float() * scale + lo.float() * zero
            code = torch.where(hi, _f(2.0), torch.where(lo, _f(0.0), _f(1.0)))
        else:
            code = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
            q = scale * (code - zero)
        loss = torch.zeros_like(x)
        sel = torch.zeros_like(x, dtype=torch.bool)
        if loop.losses is not None:
            e = x - q
            e2 = e * e
            loss = e2 / (d * d)
            if loop.thresh is not None:
                sel = e2 > loop.thresh
                loss = torch.where(sel, _f(0.0), loss)
                q = torch.where(sel, x, q)
            loss = loss * half
        err = (x - q) / d
        for key, val in (("q", q), ("code", code), ("err", err), ("loss", loss)):
            out[key][:, kk, ii] = val  # kept by lane ii
        sel_out[:, kk, ii] = sel
        if not loop.nearest and i + 1 < count:
            flat = v.view(rows, -1)
            flat[:, i + 1:count] = flat[:, i + 1:count] - err[:, None] * hinv[col, col + 1:i2]
    flat = {k: t.view(rows, -1)[:, :count] for k, t in out.items()}
    loop.q[:, i1:i2] = flat["q"]
    loop.codes[:, i1:i2] = flat["code"]
    if loop.losses is not None:
        loop.losses[:, i1:i2] = flat["loss"]
    if loop.thresh is not None:
        loop.outliers[:, i1:i2] = sel_out.view(rows, -1)[:, :count]
    return flat["err"].contiguous()


@pytest.mark.parametrize("family", list(GPTQ_FAMILIES))
def test_kernel_model_equals_plain(golden, family):
    _each(GPTQ_FAMILIES[family], lambda mode: _model_vs_plain(golden, mode))


def _model_vs_plain(golden, mode):
    blocksize, kw, dead = GPTQ_MODES[mode]
    w, h = (torch.from_numpy(a) for a in _problem(golden, dead))
    errs = {}

    def recording(fn, key):
        def block(*args):
            errs.setdefault(key, []).append(fn(*args).clone())
            return errs[key][-1]
        return block

    plain = t_gptq.solve_gptq(w, h, recording(t_gptq.gptq_block_plain, "plain"),
                              blocksize=blocksize, **kw)
    model = t_gptq.solve_gptq(w, h, recording(kernel_model, "model"), blocksize=blocksize, **kw)
    if kw.get("mse"):  # the warp's sum order, not torch's
        _assert_close(_np(model.q), _np(plain.q), _np(w))
        return
    _assert_bit_equal(model, plain)
    for a, b in zip(errs["model"], errs["plain"]):
        assert torch.equal(_bits(a), _bits(b))


def test_kernel_model_equals_plain_trueobs(golden):
    _each(OBS_MODES, lambda mode: _model_vs_plain_trueobs(golden, mode))


def _model_vs_plain_trueobs(golden, mode):
    blocksize, kw = OBS_MODES[mode]
    w, h = (torch.from_numpy(a) for a in _problem(golden, (9,)))
    plain = t_obs.solve_trueobs(w, h, t_gptq.gptq_block_plain, blocksize=blocksize, **kw)
    model = t_obs.solve_trueobs(w, h, kernel_model, blocksize=blocksize, **kw)
    _assert_bit_equal(model, plain)


# ---------------------------------------------------------------- dispatch

def test_cpu_dispatch_never_loads_the_library(golden, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path built or loaded a kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    w, h = (torch.from_numpy(a) for a in golden)
    gb.reset_counts()
    t_gptq.gptq_quantize(w, h, bits=4, groupsize=16, blocksize=16)
    t_obs.trueobs_quantize(w, h, bits=4, blocksize=32, sparseout=True)
    assert gb.PLAIN_CALLS == {gb.GPTQ_BLOCK: 64 // 16 + 64 // 32}
    assert gb.LAUNCHES == {gb.GPTQ_BLOCK: 0}
    assert build._LIBS == {}
    with pytest.raises(NotImplementedError, match="device cpu"):
        gb.gptq_block_kernel(w, h, 0, 16, None)
