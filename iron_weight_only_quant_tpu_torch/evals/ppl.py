"""Sequential perplexity evaluator (port of ``evals/ppl.py``).

The reference's ``SequentialPPLEvaluator`` (main.py:42-140), for PPL
parity: the whole test split is cut into ``seqlen`` chunks (the remainder
dropped), chunks go in batches of 4, and each chunk contributes ``seqlen -
1`` shifted tokens to a token-weighted NLL in float32 whatever the
activation dtype; PPL = exp(mean NLL).  The forward runs on the device the
params lie on.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data import get_loaders

DATASET_MAP = {"wikitext": "wikitext2", "ptb": "ptb", "c4": "c4"}


@torch.inference_mode()
def _chunk_nll(params, batch: torch.Tensor, forward, cfg) -> Tuple[torch.Tensor, int]:
    """Sum of the shifted-token NLL of a ``[B, S]`` batch (a device
    scalar) and its token count."""
    logits, _ = forward(params, batch, cfg)
    logits = logits[:, :-1].to(torch.float32)
    targets = batch[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt
    return nll.sum(), nll.numel()


class SequentialPPLEvaluator:
    def __init__(
        self,
        params,
        forward: Callable,
        cfg,
        model_path: str = "",
        seqlen: int = 2048,
        batch_size: int = 4,
        vocab_size: Optional[int] = None,
    ):
        self.params = params
        self.forward = forward
        self.cfg = cfg
        self.model_path = model_path
        self.seqlen = seqlen
        self.batch_size = batch_size
        self.vocab_size = vocab_size or getattr(cfg, "vocab_size", 256)
        self.device = params["embed"].device
        self._token_cache: Dict[str, np.ndarray] = {}

    def _load_tokens(self, dataset: str) -> np.ndarray:
        key = DATASET_MAP.get(dataset.lower(), dataset)
        if key not in self._token_cache:
            _, test = get_loaders(
                key, nsamples=1, seed=0, seqlen=self.seqlen,
                model=self.model_path, vocab_size=self.vocab_size,
            )
            self._token_cache[key] = np.asarray(test.input_ids, dtype=np.int64)
        return self._token_cache[key]

    def calculate_ppl(
        self, dataset: str, max_chunks: Optional[int] = None
    ) -> Tuple[float, int, int]:
        """(ppl, total_tokens, n_chunks): the reference's
        ``calculate_ppl`` contract (main.py:81-140)."""
        tokens = self._load_tokens(dataset)
        total_len = tokens.shape[1]
        nsamples = total_len // self.seqlen
        if nsamples == 0:
            raise ValueError(f"dataset {dataset} shorter than seqlen {self.seqlen}")
        if max_chunks is not None and max_chunks > 0:
            nsamples = min(nsamples, max_chunks)

        total_nll = 0.0
        total_tokens = 0
        bsz = self.batch_size
        for start in range(0, nsamples, bsz):
            end = min(start + bsz, nsamples)
            chunks = [tokens[:, i * self.seqlen : (i + 1) * self.seqlen]
                      for i in range(start, end)]
            batch = torch.from_numpy(np.concatenate(chunks, axis=0)).to(self.device)
            nll, count = _chunk_nll(self.params, batch, self.forward, self.cfg)
            total_nll += float(nll)
            total_tokens += count
        if total_tokens == 0:
            return float("inf"), 0, nsamples
        return math.exp(total_nll / total_tokens), total_tokens, nsamples
