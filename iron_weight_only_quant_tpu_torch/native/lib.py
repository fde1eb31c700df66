"""Build, load and call the host library (port of ``native/lib.py``).

``csrc/host/iwoq_native.cpp`` is compiled with ``g++`` at first use into
``build/host/`` beside the package (a directory ``.gitignore`` lists); the
library's file name carries a hash of the source, the flags, the
compiler's ``--version`` and the platform, so an edited source, or a
library built by another compiler or on another system, is rebuilt.  Concurrent processes (test workers) build it
once: the build runs under an exclusive lock on ``build/host/.lock`` and
the library appears by an atomic rename.  A build that fails raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "host" / "iwoq_native.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "host"
# no -march=native and no contraction: the codes must equal the torch
# quantizer's bit for bit, on any host
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off", "-Wall")
_BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library csrc/host/iwoq_native.cpp "
                           "is compiled at first use")
    return cxx


@functools.lru_cache(maxsize=None)
def toolchain(cxx: str) -> str:
    """What else than the source and the flags decides the library's
    bytes: the compiler's ``--version`` and the platform (machine, OS,
    C library)."""
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=_BUILD_TIMEOUT_S)
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed:\n{out.stdout}{out.stderr}")
    return f"{out.stdout}\n{platform.platform()}"


def lib_path(cxx: Optional[str] = None) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(toolchain(cxx or compiler()).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libiwoq_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiling it first if it is missing."""
    cxx = compiler()
    path = lib_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it while this one waited
            return path
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE}:\n{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, f32p, u8p, i32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.POINTER(ctypes.c_int32))
        lib.iwoq_version.restype = ctypes.c_int
        for name in ("iwoq_quantize_int4", "iwoq_quantize_int8"):
            fn = getattr(lib, name)
            fn.argtypes = [f32p, i64, i64, i64, ctypes.c_int, u8p, f32p, f32p]
            fn.restype = ctypes.c_int
        lib.iwoq_pack_int4.argtypes = [i32p, i64, i64, u8p]
        lib.iwoq_pack_int4.restype = ctypes.c_int
        lib.iwoq_unpack_int4.argtypes = [u8p, i64, i64, i32p]
        lib.iwoq_unpack_int4.restype = ctypes.c_int
        lib.iwoq_shard_open.argtypes = [ctypes.c_char_p]
        lib.iwoq_shard_open.restype = ctypes.c_void_p
        lib.iwoq_shard_len.argtypes = [ctypes.c_void_p]
        lib.iwoq_shard_len.restype = i64
        lib.iwoq_shard_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(i64),
                                         i64, i64, i32p]
        lib.iwoq_shard_batch.restype = ctypes.c_int
        lib.iwoq_shard_close.argtypes = [ctypes.c_void_p]
        lib.iwoq_shard_close.restype = None
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _quantize(name: str, rows_per_byte: int, w: np.ndarray, group: int,
              symmetric: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    w = np.ascontiguousarray(w, np.float32)
    if w.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D [K, N] weight, got {w.shape}")
    k, n = w.shape
    if group <= 0 or k % group or k % rows_per_byte:
        raise ValueError(f"{name}: K={k} does not split into groups of {group}")
    packed = np.empty((k // rows_per_byte, n), np.uint8)
    scales = np.empty((k // group, n), np.float32)
    zeros = np.empty((k // group, n), np.float32)
    rc = getattr(load(), name)(
        _ptr(w, ctypes.c_float), k, n, group, int(symmetric),
        _ptr(packed, ctypes.c_uint8), _ptr(scales, ctypes.c_float),
        _ptr(zeros, ctypes.c_float))
    if rc != 0:
        raise ValueError(f"{name} failed: {rc}")
    return packed, scales, zeros


def native_quantize_int4(
    w: np.ndarray, group: int, symmetric: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[K, N] f32 -> (packed u8 [K/2, N], scales f32 [K/G, N], zeros f32)."""
    return _quantize("iwoq_quantize_int4", 2, w, group, symmetric)


def native_quantize_int8(
    w: np.ndarray, group: int, symmetric: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[K, N] f32 -> (codes - 128 as u8 [K, N], scales, zeros - 128)."""
    return _quantize("iwoq_quantize_int8", 1, w, group, symmetric)


def native_pack_int4(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.int32)
    k, n = codes.shape
    packed = np.empty((k // 2, n), np.uint8)
    rc = load().iwoq_pack_int4(_ptr(codes, ctypes.c_int32), k, n,
                               _ptr(packed, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"pack failed: {rc}")
    return packed


def native_unpack_int4(packed: np.ndarray, k: int) -> np.ndarray:
    packed = np.ascontiguousarray(packed, np.uint8)
    n = packed.shape[1]
    if packed.shape[0] * 2 != k:
        raise ValueError(f"unpack: {packed.shape[0]} packed rows do not hold K={k}")
    codes = np.empty((k, n), np.int32)
    rc = load().iwoq_unpack_int4(_ptr(packed, ctypes.c_uint8), k, n,
                                 _ptr(codes, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"unpack failed: {rc}")
    return codes


class TokenShardReader:
    """Memory-mapped raw-int32 token shard with batched window fetches."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.iwoq_shard_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open token shard {path}")

    def __len__(self) -> int:
        return int(self._lib.iwoq_shard_len(self._h))

    def batch(self, offsets, seqlen: int) -> np.ndarray:
        offs = np.ascontiguousarray(offsets, np.int64)
        out = np.empty((len(offs), seqlen), np.int32)
        rc = self._lib.iwoq_shard_batch(
            self._h, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offs), seqlen, _ptr(out, ctypes.c_int32))
        if rc != 0:
            raise ValueError(f"shard batch failed: {rc}")
        return out

    def close(self):
        if self._h:
            self._lib.iwoq_shard_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
