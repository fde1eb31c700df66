"""Loglikelihood API over a (params, forward, cfg) model (port of
``evals/lm.py``).

The engine-side counterpart of the reference's vendored BaseLM
(gptq/zeroShot/models/models_utils.py:138-451): batched, length-bucketed
scoring of (context, continuation) pairs for zero-shot tasks.  The forward
runs on the device the params lie on; log-softmax terms are taken in
float32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


@torch.inference_mode()
def _score_batch(params, tokens: torch.Tensor, forward, cfg):
    """tokens [B, L] -> (logprob of each next token [B, L-1], greedy flag
    per position [B, L-1]), both on the host."""
    logits, _ = forward(params, tokens, cfg)
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    greedy = torch.argmax(logits, dim=-1) == targets
    return (tgt - logz).cpu().numpy(), greedy.cpu().numpy()


class EvalLM:
    """Scores continuations; truncates from the left to the model window."""

    def __init__(self, params, forward: Callable, cfg, max_len: int = 2048,
                 batch_size: int = 8, pad_token: int = 0,
                 eot_token_id: int | None = None):
        self.params = params
        self.forward = forward
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_len = min(max_len, getattr(cfg, "max_position_embeddings", max_len))
        self.batch_size = batch_size
        self.pad_token = pad_token
        # end-of-text id used to prime empty contexts / rolling windows
        # (the reference conditions the first token on <eos>,
        # gptq/zeroShot/models/models_utils.py:192-196, 216)
        self.eot_token_id = pad_token if eot_token_id is None else eot_token_id

    def loglikelihood(
        self, pairs: Sequence[Tuple[List[int], List[int]]]
    ) -> List[Tuple[float, bool]]:
        """[(context_tokens, continuation_tokens)] -> [(ll_sum, is_greedy)].

        Contexts are left-truncated so context+continuation fits the window;
        batches are right-padded (pad positions scored but ignored).
        """
        results: List[Tuple[float, bool]] = [None] * len(pairs)  # type: ignore
        order = sorted(range(len(pairs)), key=lambda i: -(len(pairs[i][0]) + len(pairs[i][1])))
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            seqs, spans = [], []
            for i in idxs:
                ctx, cont = pairs[i]
                if not cont:
                    raise ValueError("empty continuation")
                ctx = list(ctx) if ctx else [self.eot_token_id]
                full = (ctx + list(cont))[-self.max_len :]
                cont_start = len(full) - len(cont)
                seqs.append(full)
                spans.append((cont_start, len(full)))
            L = max(len(s) for s in seqs)
            batch = np.full((len(seqs), L), self.pad_token, np.int64)
            for j, s in enumerate(seqs):
                batch[j, : len(s)] = s
            ll, greedy = _score_batch(
                self.params, torch.from_numpy(batch).to(self.device), self.forward, self.cfg
            )
            for j, i in enumerate(idxs):
                a, b = spans[j]
                # next-token position k is predicted at index k-1
                results[i] = (
                    float(ll[j, a - 1 : b - 1].sum()),
                    bool(greedy[j, a - 1 : b - 1].all()),
                )
        return results

    def rolling_windows(
        self, tokens: List[int]
    ) -> List[Tuple[List[int], List[int]]]:
        """Split a document into disjoint (context, continuation) windows
        that together score EVERY token once.

        Mirrors the reference's get_rolling_token_windows(context_len=1) +
        make_disjoint_window (gptq/zeroShot/models/models_utils.py:480-518,
        453-456): the first window conditions on the EOT prefix token and
        predicts up to ``max_len`` tokens; each later window conditions on
        exactly one preceding token and predicts the next ``max_len`` chunk.
        """
        if not tokens:
            return []
        max_len = self.max_len
        windows: List[Tuple[List[int], List[int]]] = []
        first = min(max_len, len(tokens))
        windows.append(([self.eot_token_id], tokens[:first]))
        predicted = first
        while predicted < len(tokens):
            n = min(len(tokens) - predicted, max_len)
            end = predicted + n
            # full-width input window, then trim the overlap so only the
            # last n tokens are scored (make_disjoint_window semantics):
            # short tail windows KEEP their extra left context
            inp = tokens[end - max_len - 1 : end - 1]
            windows.append((inp[: len(inp) - (n - 1)], tokens[end - n : end]))
            predicted = end
        return windows

    def loglikelihood_rolling(self, tokens: List[int]) -> float:
        """Full-document nll: sum of disjoint rolling windows, so documents
        longer than the model window are scored in full (the reference's
        loglikelihood_rolling, models_utils.py:206-238) instead of
        silently truncating to the last ``max_len`` tokens."""
        windows = self.rolling_windows(list(tokens))
        if not windows:
            return 0.0
        return float(sum(ll for ll, _ in self.loglikelihood(windows)))

    @torch.inference_mode()
    def greedy_until(
        self,
        requests: Sequence[Tuple[List[int], Sequence[List[int]]]],
        max_gen: int = 64,
    ) -> List[List[int]]:
        """[(context_tokens, stop_sequences)] -> generated continuations.

        The third method of the reference's BaseLM API
        (gptq/zeroShot/models/models_utils.py:122-135 greedy_until):
        token-by-token argmax decode until the generated suffix ends with
        any stop sequence (the stop itself is trimmed, like the reference
        splits on the ``until`` string) or ``max_gen`` tokens.
        """
        outs: List[List[int]] = []
        for ctx, stops in requests:
            ctx = list(ctx) if ctx else [self.eot_token_id]
            gen: List[int] = []
            for _ in range(max_gen):
                window = (ctx + gen)[-self.max_len :]
                tokens = torch.tensor([window], dtype=torch.int64, device=self.device)
                logits, _ = self.forward(self.params, tokens, self.cfg)
                nxt = int(torch.argmax(logits[0, -1].to(torch.float32)))
                gen.append(nxt)
                hit = next(
                    (s for s in stops if s and gen[-len(s):] == list(s)), None
                )
                if hit is not None:
                    gen = gen[: len(gen) - len(hit)]
                    break
            outs.append(gen)
        return outs
