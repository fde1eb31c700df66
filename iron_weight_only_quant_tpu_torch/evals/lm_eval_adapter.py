"""EleutherAI lm-evaluation-harness adapter (port of
``evals/lm_eval_adapter.py``; reference main.py:427-466).

The reference wraps its quantized torch model in ``lm_eval``'s ``HFLM`` and
calls ``evaluator.simple_evaluate``.  Here the equivalent glue wraps this
port's :class:`~iron_weight_only_quant_tpu_torch.evals.lm.EvalLM` in an
``lm_eval.api.model.LM`` subclass, so any lm-eval task runs against the
port's model on its device.  The import is gated: the package is optional
(the native harness in ``evals/zeroshot`` covers the same 13-task surface
without it).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

from .lm import EvalLM


def make_lm_eval_model(
    evallm: EvalLM,
    encode: Callable[[str], List[int]],
    decode: Callable[[Sequence[int]], str],
    eot_token: str = "",
    max_gen_toks: int = 256,
):
    """Build an ``lm_eval.api.model.LM`` driving ``evallm``.

    ``encode``/``decode`` map strings <-> token ids (e.g. a HF tokenizer's
    bound methods).  Raises ImportError with guidance if lm_eval is absent.
    """
    try:
        from lm_eval.api.model import LM
    except ImportError as e:  # pragma: no cover - exercised via stub in tests
        raise ImportError(
            "lm_eval is not installed; install lm-evaluation-harness or use "
            "the native harness (iron_weight_only_quant_tpu_torch.evals.zeroshot)"
        ) from e

    class IronLM(LM):
        """Adapter: lm-eval request objects -> EvalLM batched calls."""

        def __init__(self):
            super().__init__()
            self.evallm = evallm

        # --- helpers -----------------------------------------------------
        @staticmethod
        def _args(req) -> tuple:
            return req.args if hasattr(req, "args") else tuple(req)

        def _encode_pair(self, context: str, continuation: str):
            # whole-string tokenization split at the boundary, like the
            # reference harness: tokenize(ctx+cont) and carve the cont ids
            # off the end so mid-word merges stay consistent
            n_spaces = len(context) - len(context.rstrip())
            if n_spaces:
                continuation = context[-n_spaces:] + continuation
                context = context[:-n_spaces]
            whole = encode(context + continuation)
            ctx = encode(context)
            cont_ids = whole[len(ctx):] if whole[: len(ctx)] == ctx else []
            if not cont_ids:  # boundary merge; fall back to separate encode
                cont_ids = encode(continuation)
            return ctx, cont_ids

        # --- LM interface ------------------------------------------------
        def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
            pairs = []
            for req in requests:
                context, continuation = self._args(req)[:2]
                if not context and eot_token:
                    context = eot_token
                ctx_ids, cont_ids = self._encode_pair(context, continuation) \
                    if context else ([], encode(continuation))
                if not ctx_ids:
                    # prime on the model's real EOT id, like the reference
                    # harness (models_utils.py:192-196)
                    ctx_ids = [self.evallm.eot_token_id]
                pairs.append((ctx_ids, cont_ids))
            return self.evallm.loglikelihood(pairs)

        def loglikelihood_rolling(self, requests) -> List[float]:
            return [
                self.evallm.loglikelihood_rolling(encode(self._args(req)[0]))
                for req in requests
            ]

        def generate_until(self, requests) -> List[str]:
            outs = []
            for req in requests:
                args = self._args(req)
                context = args[0]
                gen_kwargs: dict = args[1] if len(args) > 1 and isinstance(
                    args[1], dict) else {}
                until = gen_kwargs.get("until", []) or []
                if isinstance(until, str):
                    until = [until]
                max_toks = int(gen_kwargs.get("max_gen_toks", max_gen_toks))
                stops = [encode(u) for u in until if u]
                toks = self.evallm.greedy_until(
                    [(encode(context), stops)], max_gen=max_toks
                )[0]
                text = decode(toks)
                for u in until:  # string-level stop trim, like the reference
                    text = text.split(u)[0]
                outs.append(text)
            return outs

        # legacy alias (lm_eval < 0.4 calls greedy_until)
        greedy_until = generate_until

    return IronLM()


def run_lm_eval(
    evallm: EvalLM,
    tokenizer: Any,
    tasks: Sequence[str],
    num_fewshot: Optional[int] = None,
    limit: Optional[int] = None,
    **simple_evaluate_kwargs,
):
    """``evaluator.simple_evaluate`` over the engine (main.py:445-451).

    ``tokenizer`` is any object with HF-style ``__call__``/``decode``.
    """
    from lm_eval import evaluator

    encode = lambda s: tokenizer(s, add_special_tokens=False).input_ids  # noqa: E731
    decode = tokenizer.decode
    # derive the real EOT token so empty contexts are primed correctly
    eot = getattr(tokenizer, "eos_token", None) or ""
    eot_id = getattr(tokenizer, "eos_token_id", None)
    if eot_id is not None:
        evallm.eot_token_id = int(eot_id)
    model = make_lm_eval_model(evallm, encode, decode, eot_token=eot)
    return evaluator.simple_evaluate(
        model=model, tasks=list(tasks), num_fewshot=num_fewshot, limit=limit,
        **simple_evaluate_kwargs,
    )
