"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``build/kernels/`` beside the
package (a directory ``.gitignore`` lists).  The library's file name carries
a hash of the sources, headers and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  :func:`build` compiles every missing
library at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
KERNEL_SOURCES = ("w4_matmul", "w4_matmul_prenorm", "w8_matmul", "w8_matmul_prenorm",
                  "w4a8_matmul", "w4a16_matmul", "w8a8_matmul", "w8a16_matmul",
                  "w3_matmul", "w3a8_matmul", "w3a16_matmul",
                  "lut4_matmul", "lut4a16_matmul", "lut8_matmul",
                  "lut6_matmul", "lut6a16_matmul", "w4_inner_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled on the machine "
            "with the GPU (CUDA toolkit on PATH or under /usr/local/cuda)")
    return nvcc


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is missing, all in parallel.

    Returns ``{name: library path}``.  The compiler's output (including the
    ``-Xptxas -v`` register and spill report) is kept beside each library
    as ``<library>.log``.  Raises if any ``nvcc`` fails.
    """
    names = list(names)
    paths = {n: lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    try:
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(source_path(n))]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs.append((n, tmp, proc))
        failures = []
        for n, tmp, proc in procs:
            out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            Path(str(paths[n]) + ".log").write_text(out)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {source_path(n)}:\n{out}")
                continue
            os.replace(tmp, paths[n])
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return paths


def build_log(name: str) -> str:
    log = Path(str(lib_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The SASS of the library of ``csrc/<name>.cu`` (built first if
    missing), as ``cuobjdump -sass`` prints it; ``cuobjdump`` is taken from
    beside ``nvcc``."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(build([name])[name])],
                          capture_output=True, text=True, check=True,
                          timeout=_BUILD_TIMEOUT_S).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        lib.iwoq_cuda_error_string.argtypes = [ctypes.c_int]
        lib.iwoq_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
