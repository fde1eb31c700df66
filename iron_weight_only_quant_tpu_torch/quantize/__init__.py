from .qtensor import QuantizedTensor, concat_n, stored_spans  # noqa: F401
from .rtn import quantize_tensor  # noqa: F401
