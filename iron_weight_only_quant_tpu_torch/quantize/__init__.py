"""Weight quantization: packed artifacts, RTN, and GPTQ calibration
(``gptq``, ``trueobs``; the whole-model pass in ``gptq_model``, smoothing
in ``smooth``)."""

from .qtensor import QuantizedTensor, concat_n, stored_spans  # noqa: F401
from .rtn import quantize_tensor  # noqa: F401
from .trueobs import TrueOBSResult, trueobs_quantize  # noqa: F401
