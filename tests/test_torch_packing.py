"""Port parity: packing, grouping and the integer codec, bit for bit.

The same numpy inputs go through the JAX package and through its PyTorch
port (``iron_weight_only_quant_tpu_torch``); every packed byte and every
code must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.formats import grouping as j_grouping
from iron_weight_only_quant_tpu.formats import int_codec as j_int
from iron_weight_only_quant_tpu.ops import packing as j_packing
from iron_weight_only_quant_tpu_torch.formats import grouping as t_grouping
from iron_weight_only_quant_tpu_torch.formats import int_codec as t_int
from iron_weight_only_quant_tpu_torch.ops import packing as t_packing

BITS = [2, 3, 4, 6, 8]


def _codes(bits, k, n, seed):
    rng = np.random.default_rng(seed)
    if bits == 8:
        return rng.integers(-128, 128, size=(k, n), dtype=np.int32)
    return rng.integers(0, 1 << bits, size=(k, n), dtype=np.int32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k_shards", [1, 2])
def test_pack_bytes_match_jax(bits, k_shards):
    codes = _codes(bits, 64, 24, seed=bits)
    want = np.asarray(j_packing.pack_codes_sharded(jnp.asarray(codes), bits, k_shards))
    got = t_packing.pack_codes_sharded(torch.from_numpy(codes), bits, k_shards)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k_shards", [1, 2])
def test_unpack_matches_jax_and_round_trips(bits, k_shards):
    codes = _codes(bits, 64, 24, seed=10 + bits)
    packed = np.asarray(j_packing.pack_codes_sharded(jnp.asarray(codes), bits, k_shards))
    want = np.asarray(j_packing.unpack_codes_sharded(jnp.asarray(packed), bits, 64, k_shards))
    got = t_packing.unpack_codes_sharded(torch.from_numpy(packed), bits, 64, k_shards)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)


def test_int4_high_nibble_is_msb_flipped():
    codes = np.zeros((2, 1), np.int32)
    codes[1, 0] = 3  # the high nibble of byte 0
    packed = t_packing.pack_codes(torch.from_numpy(codes), 4)
    assert int(packed[0, 0]) == (3 ^ 8) << 4


def test_8bit_codes_are_stored_shifted():
    codes = np.array([[-128], [0], [127]], np.int32)
    packed = t_packing.pack_codes(torch.from_numpy(codes), 8)
    np.testing.assert_array_equal(packed.numpy()[:, 0], [0x80, 0x00, 0x7F])


def test_pack_rejects_indivisible_k():
    with pytest.raises(ValueError):
        t_packing.pack_codes(torch.zeros((6, 2), dtype=torch.int32), 2)


@pytest.mark.parametrize("group_size", [32, -1, -2])
@pytest.mark.parametrize("quant_axis", [0, 1])
def test_grouping_matches_jax(group_size, quant_axis):
    w = np.random.default_rng(3).normal(size=(64, 96)).astype(np.float32)
    want = np.asarray(j_grouping.make_groups(jnp.asarray(w), group_size, quant_axis))
    got = t_grouping.make_groups(torch.from_numpy(w), group_size, quant_axis)
    np.testing.assert_array_equal(got.numpy(), want)
    back = t_grouping.restore_from_groups(got, w.shape, quant_axis)
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("symmetric", [False, True])
def test_int_codec_matches_jax(bits, symmetric):
    g = np.random.default_rng(bits).normal(size=(48, 32)).astype(np.float32)
    g[0] = 0.0  # a flat group exercises the scale floor
    jc, js, jz = j_int.encode_int(jnp.asarray(g), bits, symmetric)
    tc, ts, tz = t_int.encode_int(torch.from_numpy(g), bits, symmetric)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if symmetric:
        assert jz is None and tz is None
    else:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    want = np.asarray(j_int.decode_int(jc, js, jz, symmetric))
    got = t_int.decode_int(tc, ts, tz, symmetric)
    np.testing.assert_array_equal(got.numpy(), want)
