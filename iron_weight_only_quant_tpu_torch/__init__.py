"""PyTorch + CUDA port of ``iron_weight_only_quant_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; module names and public
function names match it so each counterpart is easy to find.  This package
imports torch and numpy only.  The dequant-matmuls of the int (W4, W8,
W3), BFP and exact-minifloat (fp4, fp6, fp8) artifacts, with bf16/f32 or
int8/A16 activations, run as hand-written CUDA kernels (``csrc/``), built
with ``nvcc`` at first use; every other op is plain PyTorch.  ``probes/``
holds measurements that no serving path runs (the W4 inner-loop probe),
``utils/`` the timers, roofline accounting and results files, ``cli/``
the command-line tools, ``native/`` the bindings of the host C++ library
(``csrc/host/``, built with ``g++`` at first use).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device named and no GPU present they raise.
"""

from .config import (  # noqa: F401
    PER_CHANNEL,
    PER_TENSOR,
    AlignSpec,
    EngineConfig,
    FloatFormat,
    GPTQConfig,
    KVCacheConfig,
    MeshConfig,
    QuantSpec,
)
from .device import resolve_device  # noqa: F401
