"""Aggregation metrics + bootstrap standard errors (port of
``evals/metrics.py``; numpy only, the same draws as the JAX package's, so
bootstrap stderrs come out equal).

The capability surface of reference gptq/zeroShot/metrics.py: mean/accuracy
aggregation with bootstrap resampling stderr (metrics.py:207-253), the
f1/matthews helpers used by the SuperGLUE-style tasks, corpus generation
metrics (bleu/chrf/ter, metrics.py:111-154), weighted perplexity /
bits-per-byte aggregations (metrics.py:94-108), and MultiRC's
all-question-answers accuracy (metrics.py:48-82).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np


def mean(items: Sequence[float]) -> float:
    return float(np.mean(items)) if len(items) else float("nan")


def mean_stderr(items: Sequence[float]) -> float:
    """Closed-form standard error of the mean (reference metrics.py:23-24:
    sample stddev / sqrt(n))."""
    items = np.asarray(items, dtype=np.float64)
    if items.size < 2:
        return 0.0
    return float(items.std(ddof=1) / math.sqrt(items.size))


def median(items: Sequence[float]) -> float:
    return float(np.median(items)) if len(items) else float("nan")


def perplexity(log_likelihoods: Sequence[float], token_counts: Sequence[int]) -> float:
    return float(np.exp(-np.sum(log_likelihoods) / max(1, np.sum(token_counts))))


def weighted_mean(items: Sequence[Tuple[float, float]]) -> float:
    """items: (value, weight) pairs (reference metrics.py:98-100)."""
    if not items:
        return float("nan")
    a, b = zip(*items)
    return float(sum(a) / sum(b))


def weighted_perplexity(items: Sequence[Tuple[float, float]]) -> float:
    """items: (loglikelihood, token_count) pairs (reference metrics.py:103-104)."""
    return float(math.exp(-weighted_mean(items)))


def bits_per_byte(items: Sequence[Tuple[float, float]]) -> float:
    """items: (loglikelihood, byte_count) pairs (reference metrics.py:107-108)."""
    return float(-weighted_mean(items) / math.log(2))


def acc_all(items: Sequence[Tuple[int, dict]]) -> float:
    """MultiRC grouped accuracy: a question scores 1 only if every one of its
    answer candidates is labeled correctly (reference metrics.py:48-64).

    items: (pred, doc) where doc has ``idx: {paragraph, question}`` and
    ``label`` keys.
    """
    question_map: Dict[Tuple[int, int], list] = {}
    for pred, doc in items:
        key = (doc["idx"]["paragraph"], doc["idx"]["question"])
        question_map.setdefault(key, []).append(int(pred) == int(doc["label"]))
    if not question_map:
        return float("nan")
    return float(np.mean([all(v) for v in question_map.values()]))


def acc_all_stderr(items: Sequence[Tuple[int, dict]]) -> float:
    """Stderr companion of :func:`acc_all` (reference metrics.py:67-82).

    NOTE: the reference's stderr variant groups by question id ONLY (no
    paragraph id) — a deliberate quirk mirror; the point estimate groups by
    (paragraph, question)."""
    question_map: Dict[int, list] = {}
    for pred, doc in items:
        key = doc["idx"]["question"]
        question_map.setdefault(key, []).append(int(pred) == int(doc["label"]))
    if not question_map:
        return 0.0
    return mean_stderr([float(all(v)) for v in question_map.values()])


def metric_max_over_ground_truths(metric_fn: Callable, prediction, ground_truths) -> float:
    """Best score of a prediction against any reference (metrics.py:85-91)."""
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def _squad_normalize(text: str) -> str:
    """SQuAD answer normalization (mirrors transformers
    squad_metrics.normalize_answer: lower -> strip punctuation -> strip
    articles -> collapse whitespace)."""
    import re
    import string

    text = text.lower()
    text = "".join(ch for ch in text if ch not in set(string.punctuation))
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def squad_em(prediction: str, ground_truth: str) -> float:
    """SQuAD exact match on normalized strings (squad_metrics.compute_exact,
    used by ReCoRD at reference superglue.py:356-358)."""
    return float(_squad_normalize(prediction) == _squad_normalize(ground_truth))


def squad_f1(prediction: str, ground_truth: str) -> float:
    """SQuAD token-overlap F1 (squad_metrics.compute_f1, used by ReCoRD at
    reference superglue.py:353-355)."""
    from collections import Counter

    pred_toks = _squad_normalize(prediction).split()
    gold_toks = _squad_normalize(ground_truth).split()
    if not pred_toks or not gold_toks:
        return float(pred_toks == gold_toks)
    num_same = sum((Counter(pred_toks) & Counter(gold_toks)).values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def cb_multi_f1(items: Sequence[Tuple[int, int]]) -> float:
    """CB's 3-class averaged binary F1 over (pred, gold) pairs (reference
    superglue.py:151-160 cb_multi_fi)."""
    if not items:
        return float("nan")
    preds, golds = zip(*items)
    preds = np.asarray(preds)
    golds = np.asarray(golds)
    per_class = [
        f1_score((golds == c).astype(int), (preds == c).astype(int))
        for c in (0, 1, 2)
    ]
    return float(np.mean(per_class))


def _corpus_pairs(items: Sequence[Tuple[str, str]]):
    refs, preds = zip(*items)
    # sacrebleu wants List[List[str]] refs: one stream per reference set
    return [list(refs)], list(preds)


def bleu(items: Sequence[Tuple[str, str]]) -> float:
    """Corpus BLEU over (reference, prediction) pairs (metrics.py:111-125)."""
    import sacrebleu

    refs, preds = _corpus_pairs(items)
    return float(sacrebleu.corpus_bleu(preds, refs).score)


def chrf(items: Sequence[Tuple[str, str]]) -> float:
    """Corpus chrF over (reference, prediction) pairs (metrics.py:128-139)."""
    import sacrebleu

    refs, preds = _corpus_pairs(items)
    return float(sacrebleu.corpus_chrf(preds, refs).score)


def ter(items: Sequence[Tuple[str, str]]) -> float:
    """Corpus TER over (reference, prediction) pairs (metrics.py:142-154).
    Lower is better."""
    import sacrebleu

    refs, preds = _corpus_pairs(items)
    return float(sacrebleu.corpus_ter(preds, refs).score)


def matthews_corrcoef(golds: Sequence[int], preds: Sequence[int]) -> float:
    golds = np.asarray(golds)
    preds = np.asarray(preds)
    tp = np.sum((golds == 1) & (preds == 1))
    tn = np.sum((golds == 0) & (preds == 0))
    fp = np.sum((golds == 0) & (preds == 1))
    fn = np.sum((golds == 1) & (preds == 0))
    denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def f1_score(golds: Sequence[int], preds: Sequence[int]) -> float:
    golds = np.asarray(golds)
    preds = np.asarray(preds)
    tp = np.sum((golds == 1) & (preds == 1))
    fp = np.sum((golds == 0) & (preds == 1))
    fn = np.sum((golds == 1) & (preds == 0))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def bootstrap_stderr(items: Sequence[float], iters: int = 1000, seed: int = 1234) -> float:
    """Bootstrap-resampled standard error of the mean."""
    items = np.asarray(items, dtype=np.float64)
    if items.size < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    means = np.empty(iters)
    for i in range(iters):
        means[i] = rng.choice(items, size=items.size, replace=True).mean()
    return float(means.std(ddof=1))


def bootstrap_stderr_fn(fn: Callable, items: Sequence, iters: int = 1000,
                        seed: int = 1234) -> float:
    """Bootstrap stderr of an arbitrary aggregation (reference metrics.py:
    207-233): resample the item list, re-apply ``fn``, take the std."""
    if len(items) < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    idx = np.arange(len(items))
    vals = np.empty(iters)
    for i in range(iters):
        sample = [items[j] for j in rng.choice(idx, size=len(items), replace=True)]
        vals[i] = fn(sample)
    return float(vals.std(ddof=1))


def matthews_items(items: Sequence[Tuple[int, int]]) -> float:
    """Matthews corrcoef over (gold, pred) item pairs (the reference's
    aggregation signature, metrics.py:31-36)."""
    golds, preds = zip(*items)
    return matthews_corrcoef(golds, preds)


def f1_items(items: Sequence[Tuple[int, int]]) -> float:
    """Binary F1 over (gold, pred) item pairs (reference metrics.py:39-45)."""
    golds, preds = zip(*items)
    return f1_score(golds, preds)


def perplexity_items(items: Sequence[float]) -> float:
    """exp(-mean(lls)) over per-token loglikelihood items (reference
    metrics.py:94-95)."""
    return float(math.exp(-mean(items)))


def stderr_for_metric(metric: Callable, bootstrap_iters: int = 1000):
    """Return a stderr estimator for a metric aggregation, or None
    (reference metrics.py:236-253): bootstrappable aggregations (median/
    matthews/f1/perplexity/bleu/chrf/ter, plus this framework's weighted
    aggregations) bootstrap with the full ``bootstrap_iters``; ``mean`` and
    ``acc_all`` use the reference's closed-form estimators."""
    bootstrappable = {median, matthews_items, f1_items, perplexity_items,
                      bleu, chrf, ter, weighted_mean, weighted_perplexity,
                      bits_per_byte}
    if metric in bootstrappable:
        return lambda items: bootstrap_stderr_fn(
            metric, items, iters=bootstrap_iters)
    closed = {mean: mean_stderr, acc_all: acc_all_stderr}
    return closed.get(metric)
