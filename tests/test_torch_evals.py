"""Port parity: the metrics, ``EvalLM`` and the zero-shot tasks.

* every function of ``evals/metrics.py`` gives the JAX package's value on
  the same items (the bootstraps draw the same samples: equal, not close);
* ``EvalLM`` on one tiny LLaMA carried across by ``interop`` (float32 on
  the CPU): ``loglikelihood`` sums within abs 1e-4 + rel 1e-5 of the JAX
  ``EvalLM``'s and equal greedy flags (batching, left truncation, empty
  contexts), equal rolling windows and ``loglikelihood_rolling`` sums,
  equal ``greedy_until`` tokens (with a stop sequence trimmed);
* ``evaluate`` on injected documents for all 13 tasks: equal accuracies
  (and f1/em/ppl within the same tolerance), and ``make_table`` gives the
  same markdown and latex text.
"""

import zlib

import numpy as np
import pytest
import torch

import jax

from iron_weight_only_quant_tpu.evals import lm as j_lm
from iron_weight_only_quant_tpu.evals import metrics as JM
from iron_weight_only_quant_tpu.evals import zeroshot as j_zs
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu_torch.evals import lm as t_lm
from iron_weight_only_quant_tpu_torch.evals import metrics as TM
from iron_weight_only_quant_tpu_torch.evals import zeroshot as t_zs
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import llama as t_llama

J_CFG = j_llama.LlamaConfig.tiny()
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
LL_ABS, LL_REL = 1e-4, 1e-5  # f32 forwards on the CPU, summed over a few tokens
WORDS = ("the a cat dog sun rain water fire stone tree bird fish red blue green "
         "runs jumps sleeps eats holds opens because therefore yes no").split()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lms():
    """(JAX EvalLM, port EvalLM) over the same tiny LLaMA, window 48."""
    jp = j_llama.llama_init(J_CFG, jax.random.PRNGKey(3))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    kw = dict(max_len=48, batch_size=4, eot_token_id=2)
    # jitted: greedy_until calls the forward itself, eagerly op by op
    j_forward = jax.jit(j_llama.llama_forward, static_argnames="cfg")
    return (j_lm.EvalLM(jp, j_forward, J_CFG, **kw),
            t_lm.EvalLM(tp, t_llama.llama_forward, T_CFG, **kw))


def encode(text):
    """A tokenizer that is the same in every process (crc32 of each word)."""
    return [zlib.crc32(w.encode()) % (J_CFG.vocab_size - 3) + 3 for w in text.split()] or [1]


# ----------------------------------------------------------------- metrics

_BIN = [1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 1.0]
_PAIRS = [(1, 1), (0, 1), (1, 0), (0, 0), (1, 1), (1, 1), (0, 0), (1, 0)]
_CB = [(0, 0), (1, 2), (2, 2), (0, 1), (1, 1), (2, 0), (0, 0)]
_WEIGHTED = [(-3.5, 4.0), (-1.25, 2.0), (-7.0, 9.0)]
_MULTIRC = [(p, {"idx": {"paragraph": i // 3, "question": i // 2}, "label": lab})
            for i, (p, lab) in enumerate(_PAIRS)]
METRIC_CASES = {
    "mean": ("mean", (_BIN,)),
    "mean_empty": ("mean", ([],)),
    "mean_stderr": ("mean_stderr", ([0.3, 1.7, 2.2, -0.4],)),
    "median": ("median", ([3.0, 1.0, 2.0, 8.0],)),
    "perplexity": ("perplexity", ([-3.0, -5.5], [2, 3])),
    "weighted_mean": ("weighted_mean", (_WEIGHTED,)),
    "weighted_perplexity": ("weighted_perplexity", (_WEIGHTED,)),
    "bits_per_byte": ("bits_per_byte", (_WEIGHTED,)),
    "acc_all": ("acc_all", (_MULTIRC,)),
    "acc_all_stderr": ("acc_all_stderr", (_MULTIRC,)),
    "squad_em": ("squad_em", ("The  Cat!", "cat")),
    "squad_f1": ("squad_f1", ("a big red dog", "the red dog barked")),
    "squad_f1_empty": ("squad_f1", ("the", "a")),
    "cb_multi_f1": ("cb_multi_f1", (_CB,)),
    "matthews": ("matthews_corrcoef", ([1, 0, 1, 1, 0], [1, 0, 0, 1, 1])),
    "f1_score": ("f1_score", ([1, 0, 1, 1, 0], [1, 0, 0, 1, 1])),
    "bootstrap_stderr": ("bootstrap_stderr", (_BIN,)),
    "bootstrap_stderr_seed": ("bootstrap_stderr", (_BIN, 200, 7)),
    "matthews_items": ("matthews_items", (_PAIRS,)),
    "f1_items": ("f1_items", (_PAIRS,)),
    "perplexity_items": ("perplexity_items", ([-1.5, -0.25, -2.0],)),
    "max_over_ground_truths": ("metric_max_over_ground_truths",
                               ("squad_f1", "red dog", ["blue cat", "a red dog"])),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metrics_equal_jax(case):
    name, args = METRIC_CASES[case]
    got_args = tuple(getattr(TM, a) if isinstance(a, str) and hasattr(TM, a) and
                     callable(getattr(TM, a)) else a for a in args)
    want_args = tuple(getattr(JM, a) if isinstance(a, str) and hasattr(JM, a) and
                      callable(getattr(JM, a)) else a for a in args)
    got, want = getattr(TM, name)(*got_args), getattr(JM, name)(*want_args)
    assert type(got) is type(want)
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("metric", ["median", "matthews_items", "f1_items", "perplexity_items",
                                    "weighted_mean", "mean", "acc_all", "squad_f1"])
def test_stderr_for_metric_equals_jax(metric):
    items = {"median": _BIN, "mean": _BIN, "perplexity_items": [-1.0, -2.5, -0.5, -3.0],
             "matthews_items": _PAIRS, "f1_items": _PAIRS, "weighted_mean": _WEIGHTED,
             "acc_all": _MULTIRC}.get(metric)
    got = TM.stderr_for_metric(getattr(TM, metric), bootstrap_iters=100)
    want = JM.stderr_for_metric(getattr(JM, metric), bootstrap_iters=100)
    assert (got is None) == (want is None)
    if want is not None:
        assert got(items) == want(items)


@pytest.mark.parametrize("name", ["bleu", "chrf", "ter"])
def test_corpus_metrics_import_as_jax(name):
    items = [("the cat sat", "the cat sat down"), ("a dog", "a dog")]
    try:
        want = getattr(JM, name)(items)
    except ImportError as err:
        with pytest.raises(type(err)):
            getattr(TM, name)(items)
    else:
        assert getattr(TM, name)(items) == want


# ------------------------------------------------------------------ EvalLM

def _close_ll(got, want):
    assert len(got) == len(want)
    for (a, ga), (b, gb) in zip(got, want):
        assert abs(a - b) <= LL_ABS + LL_REL * abs(b)
        assert ga == gb


PAIRS = {
    "short": [([3, 5, 7], [11, 13]), ([9], [8, 7, 6]), ([1, 2, 3, 4, 5], [6])],
    "empty_context": [([], [4, 5]), ([], [9])],
    "truncated": [(list(range(3, 103)), [5, 6]), (list(range(40)), list(range(50, 60)))],
}


@pytest.mark.parametrize("case", list(PAIRS))
def test_loglikelihood_matches_jax(lms, case):
    jlm, tlm = lms
    _close_ll(tlm.loglikelihood(PAIRS[case]), jlm.loglikelihood(PAIRS[case]))


def test_loglikelihood_empty_continuation_raises_as_jax(lms):
    errs = []
    for lm in lms:
        with pytest.raises(ValueError) as e:
            lm.loglikelihood([([1, 2], [])])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("n", [0, 5, 48, 120])
def test_rolling_matches_jax(lms, n):
    jlm, tlm = lms
    tokens = [(7 * i + 3) % 250 + 1 for i in range(n)]
    assert tlm.rolling_windows(tokens) == jlm.rolling_windows(tokens)
    got, want = tlm.loglikelihood_rolling(tokens), jlm.loglikelihood_rolling(tokens)
    assert abs(got - want) <= LL_ABS * max(1, n // 8) + LL_REL * abs(want)


def test_greedy_until_matches_jax(lms):
    jlm, tlm = lms
    reqs = [([3, 5, 7, 11], []), (list(range(3, 60)), [])]  # the second one truncated
    want = jlm.greedy_until(reqs, max_gen=3)
    assert tlm.greedy_until(reqs, max_gen=3) == want
    stop = [[want[0][2]]]  # stop on the third generated token: trimmed
    got = tlm.greedy_until([([3, 5, 7, 11], stop)], max_gen=3)
    assert got == jlm.greedy_until([([3, 5, 7, 11], stop)], max_gen=3)
    assert len(got[0]) <= 2 and got[0] == want[0][:len(got[0])]


# ------------------------------------------------------------------- tasks

def _sentence(rng, n):
    return " ".join(rng.choice(WORDS, size=n))


def task_docs(name, n=4, seed=0):
    """``n`` documents with every field ``name`` reads, from a seed."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) + seed)
    s = lambda k=5: _sentence(rng, k)  # noqa: E731
    docs = []
    for i in range(n):
        if name == "piqa":
            d = {"goal": s(), "sol1": s(3), "sol2": s(4), "label": i % 2}
        elif name in ("arc_easy", "arc_challenge"):
            keys = ["A", "B", "C", "D"] if i % 2 else ["1", "2", "3", "4"]
            d = {"question": s(), "choices": {"text": [s(2) for _ in keys], "label": keys},
                 "answerKey": keys[i % 4]}
        elif name == "boolq":
            d = {"passage": s(8), "question": s(), "label": i % 2}
        elif name == "cb":
            d = {"premise": s(6), "hypothesis": s(), "label": i % 3}
        elif name == "copa":
            d = {"premise": s() + ".", "question": ("cause", "effect")[i % 2],
                 "choice1": "He " + s(3), "choice2": "She " + s(3), "label": i % 2}
        elif name == "rte":
            d = {"premise": s(6), "hypothesis": s(), "label": i % 2}
        elif name == "wic":
            d = {"sentence1": s(), "sentence2": s(), "word": str(rng.choice(WORDS)),
                 "label": i % 2}
        elif name == "wsc":
            d = {"text": s(8), "span1_text": s(1), "span2_text": s(1), "label": i % 2}
        elif name == "storycloze":
            d = {**{f"input_sentence_{j}": s() for j in range(1, 5)},
                 "sentence_quiz1": s(3), "sentence_quiz2": s(3),
                 "answer_right_ending": 1 + i % 2}
        elif name == "lambada":
            d = {"text": s(9)}
        elif name == "multirc":
            d = {"paragraph": s(8), "question": s(), "answer": s(2), "label": i % 2,
                 "idx": {"paragraph": i // 2, "question": i // 2}}
        elif name == "record":
            ents = [str(e) for e in rng.choice(WORDS, size=3, replace=False)]
            d = {"passage": s(7) + "\n@highlight\n" + s(3) + "\n@highlight\n" + s(2),
                 "query": f"{s(2)} @placeholder {s(2)}", "entities": ents + ents[:1],
                 "answers": [ents[i % 3]]}
        docs.append(d)
    return docs


def test_registries_equal():
    assert sorted(t_zs.TASK_REGISTRY) == sorted(j_zs.TASK_REGISTRY)
    assert len(t_zs.TASK_REGISTRY) == 13
    with pytest.raises(ValueError, match="unknown task"):
        t_zs.get_task("nope")


def _compare_results(got, want):
    assert list(got) == list(want)
    for task in want:
        assert list(got[task]) == list(want[task]), task
        for key, v in want[task].items():
            if key.startswith(("acc", "em")):
                assert got[task][key] == v, (task, key)
            else:
                assert got[task][key] == pytest.approx(v, rel=1e-5, abs=1e-6), (task, key)


@pytest.mark.parametrize("tasks", [
    ["piqa", "arc_easy", "arc_challenge", "boolq", "cb", "copa", "rte"],
    ["wic", "wsc", "storycloze", "lambada", "multirc", "record"]], ids=["mc7", "rest6"])
def test_evaluate_all_tasks_matches_jax(lms, tasks):
    jlm, tlm = lms
    want = j_zs.evaluate(jlm, [j_zs.get_task(t, docs=task_docs(t)) for t in tasks], encode)
    got = t_zs.evaluate(tlm, [t_zs.get_task(t, docs=task_docs(t)) for t in tasks], encode,
                        limit=None)
    _compare_results(got, want)
    for fmt in ("markdown", "latex"):
        assert t_zs.make_table(want, fmt) == j_zs.make_table(want, fmt)
    limited = t_zs.evaluate(tlm, [t_zs.get_task(t, docs=task_docs(t)) for t in tasks[:2]],
                            encode, limit=2)
    _compare_results(limited, j_zs.evaluate(
        jlm, [j_zs.get_task(t, docs=task_docs(t)) for t in tasks[:2]], encode, limit=2))


def test_make_table_of_empty_and_stderr_free_results():
    res = {"b": {"acc": 0.5}, "a": {"f1": 0.25, "f1_stderr": 0.125, "acc": 1.0}}
    for fmt in ("markdown", "latex"):
        assert t_zs.make_table(res, fmt) == j_zs.make_table(res, fmt)
        assert t_zs.make_table({}, fmt) == j_zs.make_table({}, fmt)


def test_docs_load_through_datasets_lazily(monkeypatch):
    """Without injected docs a task reads its dataset through ``_load``
    (which imports ``datasets`` only when called), as in JAX."""
    from iron_weight_only_quant_tpu_torch.evals.zeroshot import tasks as T

    seen = []
    monkeypatch.setattr(T, "_load", lambda *a: seen.append(a) or task_docs("piqa", 2))
    assert list(T.get_task("piqa").docs()) == task_docs("piqa", 2)
    assert seen == [("piqa", None, "validation")]
    assert [d["entities"] for d in T.get_task("record", docs=task_docs("record", 1)).docs()] \
        == [sorted(set(task_docs("record", 1)[0]["entities"]))]
