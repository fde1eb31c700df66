"""Typed, hashable configuration objects (the port's own copy).

Same dataclasses, fields and defaults as the JAX package's ``config.py``, so
artifacts and engine settings mean the same thing in both packages.  The
port keeps its own copy instead of importing the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# Group-size sentinels (same convention as the reference CLI:
# reference main.py:155 "--w_group_size ... -1: per-tensor, -2: per-channel").
PER_TENSOR = -1
PER_CHANNEL = -2


@dataclass(frozen=True)
class FloatFormat:
    """A parametric minifloat format: 1 sign bit + ``exp_bits`` + ``mant_bits``.

    The bias is ``2**(exp_bits-1) - 1``; subnormals are supported and the
    top exponent field is a normal value (no inf/nan encodings), as in the
    JAX package.
    """

    exp_bits: int
    mant_bits: int

    def __post_init__(self):
        if self.exp_bits < 1 or self.mant_bits < 0:
            raise ValueError(f"invalid minifloat format E{self.exp_bits}M{self.mant_bits}")

    @property
    def bias(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.mant_bits

    @property
    def max_exp_field(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def max_value(self) -> float:
        """Largest magnitude, ``(1 + (2^M-1)/2^M) * 2^(2^E - 1 - bias)``."""
        m = self.mant_bits
        return (1.0 + ((1 << m) - 1) / (1 << m)) * 2.0 ** (self.max_exp_field - self.bias)

    @property
    def min_normal_exp(self) -> int:
        return 1 - self.bias


# The default formats of the JAX package.
FP4_E2M1 = FloatFormat(2, 1)
FP4_E1M2 = FloatFormat(1, 2)
FP6_E3M2 = FloatFormat(3, 2)
FP6_E2M3 = FloatFormat(2, 3)
FP8_E4M3 = FloatFormat(4, 3)
FP8_E3M4 = FloatFormat(3, 4)
FP8_E2M5 = FloatFormat(2, 5)


@dataclass(frozen=True)
class AlignSpec:
    """Knobs of the approximate aligned minifloat decode (same fields as the
    JAX package's ``AlignSpec``):

    * codewords whose exponent field is in ``[hi_align_start,
      hi_align_exp_field]`` decode by right-shifting their mantissa to the
      shared exponent ``hi_align_exp_field`` instead of exactly;
    * ``tail_pad_bits`` zero-pads (or, if negative, pre-truncates) the
      mantissa before the alignment shift;
    * ``align_subnorm_exp_as_one`` treats subnormal codes as exponent 1
      when deciding alignment;
    * ``handle_max_outlier`` (double-approximate decode only): a group of 4
      holding a max-exponent outlier aligns to the max exponent field.
    """

    hi_align_start: int
    hi_align_exp_field: int
    tail_pad_bits: int = 0
    align_subnorm_exp_as_one: bool = True
    limit_align_exp_to_field: bool = True
    handle_max_outlier: bool = True


# Default alignment per minifloat width (the JAX package's DEFAULT_ALIGN).
DEFAULT_ALIGN = {
    "fp4": AlignSpec(hi_align_start=1, hi_align_exp_field=1, tail_pad_bits=0),
    "fp6": AlignSpec(hi_align_start=4, hi_align_exp_field=7, tail_pad_bits=2),
    "fp8": AlignSpec(hi_align_start=12, hi_align_exp_field=15, tail_pad_bits=1),
}


@dataclass(frozen=True)
class QuantSpec:
    """Full description of one weight-quantization scheme.

    ``fmt`` selects the codec:
      * ``"int"``       -- uniform integer, ``bits`` wide (C3 in SURVEY.md)
      * ``"fp"``        -- minifloat via ``float_format``          (C4)
      * ``"bfp"``       -- block floating point, ``bits`` wide     (C6)
      * ``"fp4_e1m2"``  -- standalone two-step FP4 scheme          (C8)

    ``group_size`` follows the reference convention: -1 per-tensor,
    -2 per-channel, >0 per-group along the reduction dim.

    ``quant_axis``: 0 groups along the input-feature (reduction) axis of the
    ``[in, out]`` weight -- the reference's default ``quant_dim=0`` on its
    ``[out, in]`` weights; 1 groups along output features (reference
    ``quant_dim=1``, transpose-first grouping, quant_linear.py:640-647).
    """

    fmt: str = "int"
    bits: int = 4
    group_size: int = 128
    symmetric: bool = True
    quant_axis: int = 0
    float_format: Optional[FloatFormat] = None
    approximate: bool = False
    double_approximate: bool = False
    align: Optional[AlignSpec] = None

    def __post_init__(self):
        if self.fmt not in ("int", "fp", "bfp", "fp4_e1m2"):
            raise ValueError(f"unknown fmt {self.fmt!r}")
        if self.fmt == "int" and not (2 <= self.bits < 16):
            raise ValueError("int quantization supports 2..15 bits")
        if self.fmt == "fp" and self.float_format is None:
            raise ValueError("fmt='fp' requires float_format")
        if self.fmt in ("bfp",) and self.group_size <= 0:
            # Mirrors reference quant_wrapper.py:19-20.
            raise ValueError("BFP requires per-group quantization (group_size > 0)")
        if self.approximate and self.group_size <= 0:
            # Mirrors reference quant_linear.py:475-476.
            raise ValueError("approximate decode requires per-group quantization")
        if self.quant_axis not in (0, 1):
            raise ValueError("quant_axis must be 0 or 1")

    @property
    def storage_bits(self) -> int:
        if self.fmt == "int" or self.fmt == "bfp":
            return self.bits
        if self.fmt == "fp":
            return self.float_format.total_bits
        return 4  # fp4_e1m2

    def effective_align(self, kind: str) -> AlignSpec:
        return self.align if self.align is not None else DEFAULT_ALIGN[kind]


def fp_spec(kind: str, exp_bits: int, mant_bits: int, **kw) -> QuantSpec:
    """A minifloat (``fmt="fp"``) spec of E``exp_bits``M``mant_bits``, as
    the JAX package's ``fp_spec``; ``kind`` ("fp4", "fp6", "fp8") names the
    width, as there, and is not read."""
    fmt = FloatFormat(exp_bits, mant_bits)
    return QuantSpec(fmt="fp", bits=fmt.total_bits, float_format=fmt, **kw)


@dataclass(frozen=True)
class GPTQConfig:
    """GPTQ solver knobs (the JAX package's fields and defaults; reference
    ``gptq/gptq.py:60-61`` fasterquant arguments)."""

    nsamples: int = 128
    blocksize: int = 128
    percdamp: float = 0.01
    act_order: bool = False
    static_groups: bool = False
    mse: bool = False  # grid-shrink scale search (reference quant.py:78-95)
    trits: bool = False  # ternary {min, 0, max} mode (reference quant.py:33-34)
    calib_dataset: str = "wikitext2"
    calib_seqlen: int = 2048
    seed: int = 0
    # the TrueOBS variant solver (reference zeroShot/models/fast_trueobs.py):
    # per-channel params found once; optional sparse fp-outlier escape and
    # propagation-free nearest rounding.  sparseout output is fake-quant
    # dense (fp outliers are not grid-representable).
    solver: str = "gptq"  # "gptq" | "trueobs"
    sparseout: bool = False
    nearest: bool = False


@dataclass(frozen=True)
class KVCacheConfig:
    """KV-cache layout + quantization (same fields as the JAX package's):
    contiguous or paged, 16-bit or int8/int4 codes
    (``engine/kvcache.py``); the scan path takes contiguous caches only."""

    max_seq_len: int = 2048
    kv_bits: int = 16  # 16 = no quantization
    kv_group_size: int = 128
    # paged layout: KV lives in a shared page pool instead of per-slot slabs
    # of max_seq_len; continuous batching allocates/frees pages per request,
    # so pool memory tracks the *live* token count, not worst-case x batch.
    paged: bool = False
    page_size: int = 64
    # pool size in pages; 0 = worst case (batch * ceil(max_seq_len/page) + 1)
    num_pages: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: data x model (tensor-parallel) axes."""

    data: int = 1
    model: int = 1

    @property
    def ndevices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class EngineConfig:
    mesh: MeshConfig = MeshConfig()
    kv: KVCacheConfig = KVCacheConfig()
    max_batch_size: int = 8
    prefill_chunk: int = 512
    activation_dtype: str = "bfloat16"
    # 8 = W4A8/W8A8 (int8 activations), 16 = split-int8 fixed point (A16);
    # None = bf16/f32 activations
    activation_bits: Optional[int] = None
    # activation bits for prefill phases only (generate's chunked prefill,
    # serve's waves); None = inherit activation_bits
    prefill_activation_bits: Optional[int] = None

    def prefill_abits(self) -> Optional[int]:
        return (self.prefill_activation_bits
                if self.prefill_activation_bits is not None
                else self.activation_bits)
    # fuse q|k|v and gate|up packed artifacts at engine build (an exact
    # column concat: fewer, wider kernel launches).  llama family only.
    fuse_projections: bool = False
    # generate() samples this many decode steps on the device per host
    # sync; tokens are identical to per-token stepping (post-EOS tokens
    # are discarded on the host).  1 = per-token stepping.
    decode_chunk: int = 16
