"""Tensor, data and pipeline parallelism over ``torch.distributed`` ranks.

One process a rank, one device a rank: a ``(data, model)`` mesh of ranks
(``mesh``), megatron-style partition specs over packed quantized weights
(``sharding``), column- and row-parallel quantized linears (``tp``), the
whole-model tensor-parallel forwards of LLaMA, OPT and BLOOM, flat and
layer-stacked (``tp_block``; the engine's ``mesh`` / ``tp_block`` branch),
and a GPipe scoring forward over stage ranks (``pp``).  Collectives replace
the JAX package's ``shard_map`` psums and ppermutes: an all-reduce after
each row-parallel linear, an all-gather of the column-parallel lm_head's
logits, ``send``/``recv`` between pipeline stages.
"""

from .mesh import make_mesh, multihost_init
from .pp import make_pp_llama_forward, stage_stack_llama_layers
from .sharding import apply_sharding, param_specs

__all__ = [
    "make_mesh",
    "multihost_init",
    "apply_sharding",
    "param_specs",
    "make_pp_llama_forward",
    "stage_stack_llama_layers",
]
