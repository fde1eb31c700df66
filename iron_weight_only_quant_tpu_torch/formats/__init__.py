"""Quantization codecs ported so far: grouping and the uniform integer codec.

The minifloat, BFP and standalone FP4 codecs are still to be ported
(ROADMAP queue A, "Format zoo").
"""

from .grouping import group_view_shape, make_groups, restore_from_groups  # noqa: F401
from .int_codec import decode_int, encode_int  # noqa: F401
