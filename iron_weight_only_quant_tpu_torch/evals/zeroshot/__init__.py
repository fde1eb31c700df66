"""Native zero-shot evaluation harness (port of ``evals/zeroshot``).

A from-scratch, lm-eval-style task framework over the port's own
loglikelihood API (:class:`~iron_weight_only_quant_tpu_torch.evals.lm.EvalLM`),
the equivalent of the reference's vendored EleutherAI mini-harness
(gptq/zeroShot/**).
"""

from .base import MultipleChoiceTask, Task, evaluate, make_table
from .tasks import TASK_REGISTRY, get_task

__all__ = ["Task", "MultipleChoiceTask", "evaluate", "make_table",
           "TASK_REGISTRY", "get_task"]
