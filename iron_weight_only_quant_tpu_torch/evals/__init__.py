"""Evaluation harnesses: the sequential perplexity evaluator.  The
language-model wrapper, the zero-shot tasks, the metrics and the
lm-evaluation-harness adapter are still to be ported (ROADMAP queue A
item 8)."""

from .ppl import SequentialPPLEvaluator  # noqa: F401
