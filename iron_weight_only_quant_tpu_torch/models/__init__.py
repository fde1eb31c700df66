"""Model families ported so far: LLaMA.

Linear weights may be dense tensors or packed
:class:`~iron_weight_only_quant_tpu_torch.quantize.QuantizedTensor`
artifacts; the model code is agnostic (``models/common.py`` ``linear``).
OPT and BLOOM are still to be ported (ROADMAP queue A).
"""

from .common import linear  # noqa: F401
from .llama import LlamaConfig, llama_forward, llama_init  # noqa: F401
