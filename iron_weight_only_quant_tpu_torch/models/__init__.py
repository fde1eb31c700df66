"""Model families: LLaMA, OPT and BLOOM, each with a forward over per-layer
params and a scan forward over layer-stacked ones.

Linear weights may be dense tensors or packed
:class:`~iron_weight_only_quant_tpu_torch.quantize.QuantizedTensor`
artifacts; the model code is agnostic (``models/common.py`` ``linear``).
``convert_hf`` reads HF checkpoints (``config.json`` + ``*.safetensors``)
into these trees, ``chat`` formats chat prompts.
"""

from .bloom import (  # noqa: F401
    BloomConfig,
    bloom_forward,
    bloom_forward_scan,
    bloom_init,
    stack_bloom_layers,
)
from .common import linear, stack_model_layers  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_forward_scan,
    llama_init,
    stack_llama_layers,
)
from .opt import OPTConfig, opt_forward, opt_forward_scan, opt_init, stack_opt_layers  # noqa: F401
