"""Port parity: quantized (int8/int4) and paged KV caches.

The same seeded numpy k/v go through the JAX package's ``engine/kvcache.py``
and the port's:

* the codec (``_encode``/``_decode``/``_pack_nibbles``/``_unpack_nibbles``):
  codes, scales, zeros and decoded values bit-equal, int8 and int4 (packed
  split-D for an even head dim, unpacked int8 for an odd one);
* ``update_and_fetch`` on a quantized cache: every buffer bit-equal after a
  shared-start write, a slot-local ``[B]`` write (one start clamped at the
  end) and a serve ``valid`` write;
* the paged cases of ``tests/test_paged_kv.py`` (``TestPagedView``,
  ``TestAllocator``) against the JAX pools.

The engine under these caches: ``tests/test_torch_kvcache_engine.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.engine import kvcache as jkv
from iron_weight_only_quant_tpu_torch.config import KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import kvcache as tkv

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    """JAX or torch array -> numpy (bf16 as its bits)."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _pair(x, dtype="f32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _same(j, t):
    """Equal bits, shape and dtype."""
    jn, tn = _np(j), _np(t)
    assert jn.shape == tn.shape and jn.dtype == tn.dtype
    np.testing.assert_array_equal(jn, tn)


# ------------------------------------------------------------------ codec

CODEC_CASES = [(d, g) for d in (16, 64, 128) for g in (128, 64, 32, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d,g", CODEC_CASES, ids=[f"d{d}_g{g}" for d, g in CODEC_CASES])
def test_codec_bit_equal(d, g, bits, dtype):
    x = np.random.default_rng(d * 1000 + g + bits).normal(size=(2, 3, 2, d)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero group: the eps-clamped scale
    jx, tx = _pair(x, dtype)
    packed = bits == 4
    jc = jkv._encode(jx, bits, g, packed)
    tc = tkv._encode(tx, bits, g, packed)
    assert tc[0].dtype == (torch.uint8 if packed else torch.int8)
    for a, b in zip(jc, tc):
        _same(a, b)
    for jd_, td_ in (DTYPES[dtype], DTYPES["f32"]):
        _same(jkv._decode(*jc, d, jd_, packed), tkv._decode(*tc, d, td_, packed))


@pytest.mark.parametrize("d,group", [(15, 128), (45, 15)], ids=["d15", "d45_g15"])
def test_int4_odd_head_dim_is_unpacked(d, group):
    x = np.random.default_rng(d).normal(size=(2, 4, 3, d)).astype(np.float32)
    jx, tx = _pair(x)
    jc = jkv._encode(jx, 4, group, False)
    tc = tkv._encode(tx, 4, group, False)
    assert tc[0].dtype == torch.int8 and int(tc[0].min()) >= -8 and int(tc[0].max()) <= 7
    for a, b in zip(jc, tc):
        _same(a, b)
    _same(jkv._decode(*jc, d, jnp.float32), tkv._decode(*tc, d, torch.float32))
    kv = dict(max_seq_len=8, kv_bits=4, kv_group_size=group)
    (jv,) = jkv.make_caches(1, 2, 3, d, JKV(**kv), jnp.float32)
    (tv,) = tkv.make_caches(1, 2, 3, d, KVCacheConfig(**kv), torch.float32, "cpu")
    assert not tv.packed and tv.k_codes.shape == tuple(jv.k_codes.shape)


def test_nibble_pack_roundtrip():
    codes = np.random.default_rng(1).integers(0, 16, size=(3, 5, 2, 32)).astype(np.int32)
    jp = jkv._pack_nibbles(jnp.asarray(codes))
    tp = tkv._pack_nibbles(torch.from_numpy(codes))
    _same(jp, tp)
    _same(jkv._unpack_nibbles(jp), tkv._unpack_nibbles(tp))
    np.testing.assert_array_equal(tkv._unpack_nibbles(tp).numpy(), codes)


# ------------------------------------------------------- quantized cache

def _quant_views(bits, b=3, t=16, h=2, d=16, group=8):
    kv = dict(max_seq_len=t, kv_bits=bits, kv_group_size=group)
    (jv,) = jkv.make_caches(1, b, h, d, JKV(**kv), jnp.float32)
    (tv,) = tkv.make_caches(1, b, h, d, KVCacheConfig(**kv), torch.float32, "cpu")
    return jv, tv


def _same_quant(jv, tv):
    for name in ("k_codes", "k_scales", "k_zeros", "v_codes", "v_scales", "v_zeros"):
        _same(getattr(jv, name), getattr(tv, name))
    np.testing.assert_array_equal(np.asarray(jv.length), _np(torch.as_tensor(tv.length)))


def _kv(rng, b, s, h=2, d=16):
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k), torch.from_numpy(v))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_cache_shared_start_writes(bits, rng):
    jv, tv = _quant_views(bits)
    assert tkv.cache_max_len(tv) == jkv.cache_max_len(jv) == 16
    for s in (5, 3, 9):  # the third write is clamped to end at T_max
        (jk, jvv), (tk, tvv) = _kv(rng, 3, s)
        jv, jk_all, jv_all = jkv.update_and_fetch(jv, jk, jvv)
        tv, tk_all, tv_all = tkv.update_and_fetch(tv, tk, tvv)
        _same_quant(jv, tv)
        _same(jk_all, tk_all)
        _same(jv_all, tv_all)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_cache_slot_local_and_valid_writes(bits, rng):
    jv, tv = _quant_views(bits)
    starts = np.array([0, 4, 14])
    jv = jv.replace(length=jnp.asarray(starts, jnp.int32))
    tv = tv._replace(length=torch.from_numpy(starts))
    (jk, jvv), (tk, tvv) = _kv(rng, 3, 3)  # slot 2 clamps to columns 13..15
    jv, _, _ = jkv.update_and_fetch(jv, jk, jvv)
    tv, _, _ = tkv.update_and_fetch(tv, tk, tvv)
    _same_quant(jv, tv)
    # a serve wave: 4 tokens, slot 0 keeps 4, slot 1 keeps 1, slot 2 none
    # (and its column 17 would be past T_max anyway)
    valid = np.array([4, 1, 0])
    jv = jv.replace(valid=jnp.asarray(valid, jnp.int32))
    tv = tv._replace(valid=torch.from_numpy(valid))
    (jk, jvv), (tk, tvv) = _kv(rng, 3, 4)
    jv, jk_all, _ = jkv.update_and_fetch(jv, jk, jvv)
    tv, tk_all, _ = tkv.update_and_fetch(tv, tk, tvv)
    assert tv.valid is None
    _same_quant(jv, tv)
    _same(jk_all, tk_all)
    assert tv.length.tolist() == [7, 8, 17]


# ------------------------------------------------- paged (test_paged_kv)

class TestPagedView:
    def _mk(self, **kv):
        cfg = dict(max_seq_len=32, paged=True, page_size=8, **kv)
        (jv,) = jkv.make_caches(1, 2, 2, 16, JKV(**cfg), jnp.float32)
        (tv,) = tkv.make_caches(1, 2, 2, 16, KVCacheConfig(**cfg), torch.float32, "cpu")
        return jv, tv

    @staticmethod
    def _same_pools(jv, tv):
        """Every pool but the garbage page 0, whose duplicate writes are in
        no defined order."""
        for name in ("k_pages", "v_pages", "k_scales", "k_zeros", "v_scales", "v_zeros"):
            j, t = getattr(jv, name), getattr(tv, name)
            assert (j is None) == (t is None)
            if t is not None:
                _same(j[1:], t[1:])
        np.testing.assert_array_equal(np.asarray(jv.page_table), tv.page_table.numpy())
        np.testing.assert_array_equal(np.asarray(jv.length), tv.length.numpy())

    def test_write_read_roundtrip_dense(self, rng):
        jv, tv = self._mk()
        assert isinstance(tv, tkv.PagedKVCacheView) and tkv.cache_max_len(tv) == 32
        ks = rng.normal(size=(3, 2, 5, 2, 16)).astype(np.float32)
        vs = rng.normal(size=(3, 2, 5, 2, 16)).astype(np.float32)
        for i in range(3):  # three appends of 5 tokens each
            jv, jk_all, jv_all = jkv.update_and_fetch(jv, jnp.asarray(ks[i]), jnp.asarray(vs[i]))
            tv, tk_all, tv_all = tkv.update_and_fetch(tv, torch.from_numpy(ks[i]),
                                                      torch.from_numpy(vs[i]))
        self._same_pools(jv, tv)
        _same(jk_all, tk_all)
        np.testing.assert_array_equal(tk_all.numpy()[:, :15], np.concatenate(list(ks), axis=1))
        np.testing.assert_array_equal(tv_all.numpy()[:, :15], np.concatenate(list(vs), axis=1))

    @pytest.mark.parametrize("bits", [8, 4])
    def test_quantized_pages_match_slab_cache(self, bits, rng):
        _, slab = _quant_views(bits, b=2, t=32, group=8)
        jv, tv = self._mk(kv_bits=bits, kv_group_size=8)
        (jk, jvv), (tk, tvv) = _kv(rng, 2, 7)
        jv, jk_p, _ = jkv.update_and_fetch(jv, jk, jvv)
        tv, tk_p, tv_p = tkv.update_and_fetch(tv, tk, tvv)
        slab, tk_s, tv_s = tkv.update_and_fetch(slab, tk, tvv)
        self._same_pools(jv, tv)
        _same(jk_p, tk_p)
        np.testing.assert_array_equal(tk_s.numpy()[:, :7], tk_p.numpy()[:, :7])
        np.testing.assert_array_equal(tv_s.numpy()[:, :7], tv_p.numpy()[:, :7])

    def test_slot_local_timelines(self, rng):
        """[B] lengths write each row at its own column; a valid write sends
        the dropped tokens to the garbage page."""
        jv, tv = self._mk(kv_bits=8, kv_group_size=8)
        jv = jv.replace(length=jnp.asarray([0, 9], jnp.int32))
        tv = tv._replace(length=torch.tensor([0, 9]))
        (jk, _), (tk, _) = _kv(rng, 2, 1)
        jv, _, _ = jkv.update_and_fetch(jv, jk, jk)
        tv, tk_all, _ = tkv.update_and_fetch(tv, tk, tk)
        assert tv.length.tolist() == [1, 10]
        jv = jv.replace(valid=jnp.asarray([3, 0], jnp.int32))
        tv = tv._replace(valid=torch.tensor([3, 0]))
        (jk, _), (tk, _) = _kv(rng, 2, 4)
        jv, jk_all, _ = jkv.update_and_fetch(jv, jk, jk)
        tv, tk_all, _ = tkv.update_and_fetch(tv, tk, tk)
        self._same_pools(jv, tv)
        _same(jk_all[0, :4], tk_all[0, :4])
        _same(jk_all[1, :10], tk_all[1, :10])
        assert tv.length.tolist() == [4, 10]


class TestAllocator:
    def test_alloc_free_reuse(self):
        for alloc_cls in (jkv.PageAllocator, tkv.PageAllocator):
            a = alloc_cls(4)  # pages 1..3 usable, 0 reserved
            got = [a.alloc() for _ in range(3)]
            assert got == [1, 2, 3]
            with pytest.raises(RuntimeError):
                a.alloc()
            a.free([2])
            assert a.alloc() == 2

    @pytest.mark.parametrize("num_pages", [0, 9])
    def test_pool_pages(self, num_pages):
        kw = dict(max_seq_len=60, paged=True, page_size=16, num_pages=num_pages)
        assert tkv.pool_pages(4, KVCacheConfig(**kw)) == jkv.pool_pages(4, JKV(**kw))
        assert tkv.pages_per_seq(KVCacheConfig(**kw)) == jkv.pages_per_seq(JKV(**kw)) == 4


def test_default_table_and_sizes():
    kw = dict(max_seq_len=40, paged=True, page_size=16, num_pages=6)
    (jv,) = jkv.make_caches(1, 3, 2, 16, JKV(**kw), jnp.float32)
    (tv,) = tkv.make_caches(1, 3, 2, 16, KVCacheConfig(**kw), torch.float32, "cpu")
    # slot 2's pages lie past the pool: page 0
    np.testing.assert_array_equal(np.asarray(jv.page_table), tv.page_table.numpy())
    assert tkv.cache_max_len(tv) == 48
    assert tkv.cache_bytes([tv]) == 2 * 6 * 16 * 2 * 16 * 4
