from .packing import (  # noqa: F401
    pack_codes,
    pack_codes_sharded,
    unpack_codes,
    unpack_codes_sharded,
)
from .qmatmul import (  # noqa: F401
    dequantize_weight,
    index_stacked,
    packed_bits,
    quantized_matmul,
    quantized_matmul_stacked,
)
