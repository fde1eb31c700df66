"""Evaluation harnesses: the sequential perplexity evaluator, the
loglikelihood API (``EvalLM``) and the zero-shot tasks over it, and the
metrics.

``lm_eval_adapter`` (external lm-evaluation-harness glue, reference
main.py:427-466) is import-gated on the optional ``lm_eval`` package and
not re-exported here.
"""

from .lm import EvalLM  # noqa: F401
from .ppl import SequentialPPLEvaluator  # noqa: F401
