"""The host C++ library (``csrc/host/iwoq_native.cpp``) through ctypes: int4
and int8 RTN quantize+pack on the host, int4 pack/unpack, and a
memory-mapped token-shard reader.  Built with ``g++`` at first use; a build
or load that fails raises (there is no quiet fallback)."""

from .lib import (  # noqa: F401
    TokenShardReader,
    build,
    load,
    native_pack_int4,
    native_quantize_int4,
    native_quantize_int8,
    native_unpack_int4,
)
