"""Port parity: the host library (``csrc/host/iwoq_native.cpp``, built with
g++ at first use) and what uses it.

* ``native_quantize_tensor`` for int4 and int8, symmetric and asymmetric,
  with and without padded output columns: the bytes of the JAX package's
  ``quantize_tensor`` and of the port's, field by field; ``None`` for every
  layout the JAX version leaves out;
* int4 pack/unpack equal to the JAX ``pack_codes``;
* the memory-mapped token-shard reader, and ``tokenshard:`` windows through
  ``get_loaders`` equal to the JAX loader's (its window draw run over a
  numpy reader of the same file: the JAX package's own library is built by
  ``make`` in its source tree, which this test does not touch);
* a source that does not compile raises with the compiler's output;
* the library's file name changes with the compiler and the platform, so
  a library built elsewhere is not loaded.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu import native as j_native
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.data import loaders as j_loaders
from iron_weight_only_quant_tpu.ops.packing import pack_codes as j_pack_codes
from iron_weight_only_quant_tpu.quantize import rtn as j_rtn
from iron_weight_only_quant_tpu_torch import native
from iron_weight_only_quant_tpu_torch.config import QuantSpec, fp_spec
from iron_weight_only_quant_tpu_torch.data import loaders as t_loaders
from iron_weight_only_quant_tpu_torch.native import lib as native_lib
from iron_weight_only_quant_tpu_torch.quantize.rtn import native_quantize_tensor, quantize_tensor

FIELDS = ("qweight", "scales", "zeros")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weight():
    w = np.random.default_rng(5).normal(size=(256, 200)).astype(np.float32) * 0.05
    w[:, 7] = 0.0  # an all-zero column, as a padded one
    return w


def _bytes(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.mark.parametrize("pad", [1, 64], ids=["unpadded", "pad64"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("bits", [4, 8])
def test_native_bytes_equal_jax_and_port_rtn(weight, bits, symmetric, pad):
    spec = QuantSpec(fmt="int", bits=bits, group_size=64, symmetric=symmetric)
    got = native_quantize_tensor(torch.from_numpy(weight), spec, pad_n_to=pad)
    port = quantize_tensor(torch.from_numpy(weight), spec, pad_n_to=pad)
    want = j_rtn.quantize_tensor(jnp.asarray(weight), JSpec(fmt="int", bits=bits, group_size=64,
                                                            symmetric=symmetric), pad_n_to=pad)
    for f in FIELDS:
        assert _bytes(getattr(got, f)) == _bytes(getattr(port, f)) == _bytes(getattr(want, f)), f
    assert (got.shape, got.mode, got.k_shards, got.n_pad, got.k_pad) == \
        (port.shape, port.mode, port.k_shards, port.n_pad, port.k_pad) == \
        (tuple(want.shape), want.mode, want.k_shards, want.n_pad, want.k_pad)
    assert got.spec == spec and got.qweight.device == torch.device("cpu")


@pytest.mark.parametrize("case", ["fp8", "bfp4", "int3", "per_tensor", "per_channel",
                                  "quant_axis1", "k_off_group", "one_dim"])
def test_native_leaves_out_what_jax_leaves_out(weight, monkeypatch, case):
    w = weight
    specs = {"fp8": (fp_spec("fp8", 4, 3, group_size=64), j_fp_spec("fp8", 4, 3, group_size=64))}
    kw = {"bfp4": dict(fmt="bfp", bits=4, group_size=64), "int3": dict(fmt="int", bits=3,
                                                                     group_size=64),
          "per_tensor": dict(fmt="int", bits=4, group_size=-1),
          "per_channel": dict(fmt="int", bits=4, group_size=-2),
          "quant_axis1": dict(fmt="int", bits=4, group_size=64, quant_axis=1),
          "k_off_group": dict(fmt="int", bits=4, group_size=96),
          "one_dim": dict(fmt="int", bits=8, group_size=64)}.get(case)
    if kw is not None:
        specs[case] = (QuantSpec(**kw), JSpec(**kw))
    if case == "one_dim":
        w = w[:, 0].copy()
    t_spec, j_spec = specs[case]
    # the JAX version asks whether its library is there only after the
    # spec checks; answer yes so that its spec and shape checks decide
    monkeypatch.setattr(j_native, "available", lambda: True)
    assert j_rtn.native_quantize_tensor(jnp.asarray(w), j_spec) is None
    assert native_quantize_tensor(torch.from_numpy(w), t_spec) is None


def test_pack_unpack_int4_equal_jax(rng):
    codes = rng.integers(0, 16, size=(64, 32)).astype(np.int32)
    packed = native.native_pack_int4(codes)
    np.testing.assert_array_equal(packed, np.asarray(j_pack_codes(jnp.asarray(codes), 4)))
    np.testing.assert_array_equal(native.native_unpack_int4(packed, 64), codes)
    with pytest.raises(ValueError):
        native.native_unpack_int4(packed, 63)


def test_quantize_refuses_groups_that_do_not_divide_k(weight):
    with pytest.raises(ValueError, match="groups of 96"):
        native.native_quantize_int4(weight, 96, False)


def test_token_shard_reader(tmp_path, rng):
    tokens = rng.integers(0, 1000, size=4096).astype(np.int32)
    path = tmp_path / "shard.bin"
    tokens.tofile(path)
    with native.TokenShardReader(str(path)) as r:
        assert len(r) == 4096
        batch = r.batch([0, 100, 4096 - 16], seqlen=16)
        np.testing.assert_array_equal(batch[0], tokens[:16])
        np.testing.assert_array_equal(batch[1], tokens[100:116])
        np.testing.assert_array_equal(batch[2], tokens[-16:])
        with pytest.raises(ValueError):
            r.batch([4090], seqlen=16)  # out of range
    with pytest.raises(OSError, match="cannot open token shard"):
        native.TokenShardReader(str(tmp_path / "missing.bin"))


class _NumpyShard:
    """The JAX reader's interface over ``np.fromfile``."""

    def __init__(self, path):
        self.tokens = np.fromfile(path, np.int32)

    def __len__(self):
        return len(self.tokens)

    def batch(self, offsets, seqlen):
        return np.stack([self.tokens[o:o + seqlen] for o in offsets])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("n,nsamples,seed,seqlen", [(4096, 3, 7, 128), (9000, 5, 0, 16),
                                                    (130, 2, 1, 64)])
def test_tokenshard_windows_equal_jax(tmp_path, monkeypatch, n, nsamples, seed, seqlen):
    toks = np.random.default_rng(seed).integers(0, 32000, size=n, dtype=np.int32)
    shard = tmp_path / "corpus.tokens"
    toks.tofile(shard)
    monkeypatch.setattr(j_native, "TokenShardReader", _NumpyShard)
    want = j_loaders.get_loaders(f"tokenshard:{shard}", nsamples=nsamples, seed=seed,
                                 seqlen=seqlen)
    got = t_loaders.get_loaders(f"tokenshard:{shard}", nsamples=nsamples, seed=seed,
                                seqlen=seqlen)
    assert len(got[0]) == len(want[0]) == nsamples
    for a, b in zip(got[0], want[0]):
        assert a.input_ids.dtype == b.input_ids.dtype == np.int64
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
    assert got[1].input_ids.dtype == np.int64
    np.testing.assert_array_equal(got[1].input_ids, want[1].input_ids)
    np.testing.assert_array_equal(got[1].input_ids[0], toks[:min(n, 256 * seqlen)])


def test_short_tokenshard_raises(tmp_path):
    shard = tmp_path / "short.tokens"
    np.arange(10, dtype=np.int32).tofile(shard)
    with pytest.raises(ValueError, match="shorter than seqlen"):
        t_loaders.get_loaders(f"tokenshard:{shard}", nsamples=1, seqlen=16)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native_lib, "SOURCE", bad)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for .*bad.cpp") as e:
        native_lib.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_name_follows_the_compiler_and_the_platform(monkeypatch):
    import platform
    import subprocess

    cxx = native_lib.compiler()
    ident = native_lib.toolchain(cxx)
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    assert version.strip() and version in ident and platform.platform() in ident
    here = native_lib.lib_path()
    for other in (ident.replace(platform.platform(), "Linux-other-x86_64"),
                  "g++ (another build) 99.0\n" + platform.platform()):
        monkeypatch.setattr(native_lib, "toolchain", lambda c, other=other: other)
        assert native_lib.lib_path() != here
