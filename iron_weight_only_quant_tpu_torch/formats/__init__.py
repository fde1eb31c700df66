"""Quantization codecs (port of ``formats/``).

Every codec works on a 2-D grouped view ``[n_groups, group_width]`` in
float32 and returns integer codes plus the side information (scales, zeros,
shared exponents) needed to decode; :mod:`.grouping` maps weights to and
from that view.

  * :mod:`.int_codec`   -- uniform integer, symmetric or asymmetric
  * :mod:`.minifloat`   -- parametric E/M minifloat and its approximate decodes
  * :mod:`.bfp`         -- block floating point
  * :mod:`.fp4_e1m2`    -- the standalone two-step FP4 scheme (fake-quant only)
  * :mod:`.api`         -- ``quantize_groups``, ``dequantize_groups``, ``fake_quantize``
"""

from .grouping import group_view_shape, make_groups, restore_from_groups
from .int_codec import decode_int, encode_int, pseudo_quantize
from .minifloat import (
    decode_minifloat,
    decode_minifloat_aligned,
    decode_minifloat_double_approx,
    encode_minifloat,
    minifloat_codebook,
)
from .bfp import decode_bfp, encode_bfp
from .fp4_e1m2 import quantize_fp4_two_step
from .api import dequantize_groups, fake_quantize, quantize_groups

__all__ = [
    "make_groups",
    "restore_from_groups",
    "group_view_shape",
    "encode_int",
    "decode_int",
    "pseudo_quantize",
    "encode_minifloat",
    "decode_minifloat",
    "decode_minifloat_aligned",
    "decode_minifloat_double_approx",
    "minifloat_codebook",
    "encode_bfp",
    "decode_bfp",
    "quantize_fp4_two_step",
    "quantize_groups",
    "dequantize_groups",
    "fake_quantize",
]
