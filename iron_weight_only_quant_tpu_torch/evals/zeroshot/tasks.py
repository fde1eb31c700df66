"""Zero-shot task implementations (port of ``evals/zeroshot/tasks.py``).

Covers the reference's full 13-task registry
(gptq/zeroShot/tasks/__init__.py:18-32: lambada, piqa, arc_easy,
arc_challenge, boolq, cb, copa, wic, multirc, rte, record, wsc, storycloze)
with standard zero-shot prompt formats.

Datasets load through ``datasets`` (imported only when a task's docs are
read without injected ones); every task also accepts pre-loaded ``docs``
for offline use and testing, which needs no extra package.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from .. import metrics as M
from .base import MultipleChoiceTask, Request, Task


def _load(path, name, split):
    from datasets import load_dataset

    return load_dataset(path, name, split=split)


class _DocTask:
    dataset = ("", None, "validation")

    def __init__(self, docs: Optional[List[dict]] = None):
        self._docs = docs

    def docs(self) -> Iterable[dict]:
        if self._docs is not None:
            return self._docs
        path, name, split = self.dataset
        return _load(path, name, split)


class PIQA(_DocTask, MultipleChoiceTask):
    name = "piqa"
    dataset = ("piqa", None, "validation")

    def context(self, doc):
        return f"Question: {doc['goal']}\nAnswer:"

    def choices(self, doc):
        return [" " + doc["sol1"], " " + doc["sol2"]]

    def gold(self, doc):
        return int(doc["label"])


class _ARC(_DocTask, MultipleChoiceTask):
    # Some answerKeys are numeric strings '1'-'5'; the reference maps them
    # back to letters before indexing (gptq/zeroShot/tasks/arc.py:54-64).
    _NUM_TO_LETTER = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}

    def context(self, doc):
        return f"Question: {doc['question']}\nAnswer:"

    def choices(self, doc):
        return [" " + t for t in doc["choices"]["text"]]

    def gold(self, doc):
        key = self._NUM_TO_LETTER.get(doc["answerKey"], doc["answerKey"])
        return ["A", "B", "C", "D", "E"].index(key)


class ARCEasy(_ARC):
    name = "arc_easy"
    dataset = ("ai2_arc", "ARC-Easy", "test")


class ARCChallenge(_ARC):
    name = "arc_challenge"
    dataset = ("ai2_arc", "ARC-Challenge", "test")


class BoolQ(_DocTask, MultipleChoiceTask):
    name = "boolq"
    dataset = ("super_glue", "boolq", "validation")

    def context(self, doc):
        return f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:"

    def choices(self, doc):
        return [" no", " yes"]

    def gold(self, doc):
        return int(doc["label"])


class CB(_DocTask, MultipleChoiceTask):
    """CommitmentBank: acc + the reference's headline 3-class averaged F1
    (gptq/zeroShot/tasks/superglue.py:141-166)."""

    name = "cb"
    dataset = ("super_glue", "cb", "validation")

    def context(self, doc):
        return f"{doc['premise']}\nQuestion: {doc['hypothesis']}. True, False or Neither?\nAnswer:"

    def choices(self, doc):
        return [" True", " False", " Neither"]

    def gold(self, doc):
        return int(doc["label"])

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        pred = max(range(len(lls)), key=lls.__getitem__)
        gold = self.gold(doc)
        return {"acc": float(pred == gold), "f1": (pred, gold)}

    def aggregate(self, per_doc):
        accs = [d["acc"] for d in per_doc]
        return {
            "acc": M.mean(accs),
            "acc_stderr": M.mean_stderr(accs),
            "f1": M.cb_multi_f1([d["f1"] for d in per_doc]),
        }


class COPA(_DocTask, MultipleChoiceTask):
    name = "copa"
    dataset = ("super_glue", "copa", "validation")

    def context(self, doc):
        conn = "because" if doc["question"] == "cause" else "therefore"
        return doc["premise"].strip().rstrip(".") + f" {conn}"

    def choices(self, doc):
        def lower_first(s):
            return s[0].lower() + s[1:] if s else s

        return [" " + lower_first(doc["choice1"]), " " + lower_first(doc["choice2"])]

    def gold(self, doc):
        return int(doc["label"])


class RTE(_DocTask, MultipleChoiceTask):
    name = "rte"
    dataset = ("super_glue", "rte", "validation")

    def context(self, doc):
        return f"{doc['premise']}\nQuestion: {doc['hypothesis']} True or False?\nAnswer:"

    def choices(self, doc):
        return [" True", " False"]

    def gold(self, doc):
        return int(doc["label"])  # 0 = entailment = True


class WiC(_DocTask, MultipleChoiceTask):
    name = "wic"
    dataset = ("super_glue", "wic", "validation")

    def context(self, doc):
        return (
            f"Sentence 1: {doc['sentence1']}\nSentence 2: {doc['sentence2']}\n"
            f"Question: Is the word '{doc['word']}' used in the same way in the"
            " two sentences above?\nAnswer:"
        )

    def choices(self, doc):
        return [" no", " yes"]

    def gold(self, doc):
        return int(doc["label"])


class WSC(_DocTask, MultipleChoiceTask):
    name = "wsc"
    dataset = ("super_glue", "wsc.fixed", "validation")

    def context(self, doc):
        return (
            f"Passage: {doc['text']}\nQuestion: In the passage above, does the"
            f" pronoun \"{doc['span2_text']}\" refer to \"{doc['span1_text']}\"?"
            "\nAnswer:"
        )

    def choices(self, doc):
        return [" no", " yes"]

    def gold(self, doc):
        return int(doc["label"])


class StoryCloze(_DocTask, MultipleChoiceTask):
    name = "storycloze"
    dataset = ("story_cloze", "2016", "validation")

    def context(self, doc):
        return " ".join(
            doc[k] for k in ("input_sentence_1", "input_sentence_2",
                             "input_sentence_3", "input_sentence_4")
        )

    def choices(self, doc):
        return [" " + doc["sentence_quiz1"], " " + doc["sentence_quiz2"]]

    def gold(self, doc):
        return int(doc["answer_right_ending"]) - 1


class MultiRC(_DocTask, Task):
    """Binary correctness judgment per (question, answer) candidate.

    Mirrors the reference task exactly (gptq/zeroShot/tasks/superglue.py:
    231-282): two continuations per candidate ("{answer}\\nIs the answer
    correct? yes|no"), aggregated with ``acc_all`` — a question counts only
    if every one of its answer candidates is judged correctly.
    """

    name = "multirc"
    dataset = ("super_glue", "multirc", "validation")

    def context(self, doc):
        return f"{doc['paragraph']}\nQuestion: {doc['question']}\nAnswer:"

    @staticmethod
    def format_answer(answer, label):
        # superglue.py:259-262
        label_str = "yes" if label else "no"
        return f"{answer}\nIs the answer correct? {label_str}"

    def requests(self, doc):
        ctx = self.context(doc)
        return [
            Request(ctx, " " + self.format_answer(doc["answer"], True)),
            Request(ctx, " " + self.format_answer(doc["answer"], False)),
        ]

    def process_results(self, doc, results):
        ll_true, ll_false = results[0][0], results[1][0]
        return {"acc": (int(ll_true > ll_false), doc)}

    def aggregate(self, per_doc):
        items = [d["acc"] for d in per_doc]
        return {"acc": M.acc_all(items), "acc_stderr": M.acc_all_stderr(items)}


class ReCoRD(_DocTask, Task):
    """Cloze over entity candidates (gptq/zeroShot/tasks/superglue.py:
    285-369): passage formatted with @highlight bullets, entities/answers
    dedup+sorted, and per-example SQuAD token F1 + exact match on the
    max-likelihood entity."""

    name = "record"
    dataset = ("super_glue", "record", "validation")

    @classmethod
    def _process_doc(cls, doc):
        # superglue.py:313-320
        return {
            "passage": doc["passage"],
            "query": doc["query"],
            "entities": sorted(set(doc["entities"])),
            "answers": sorted(set(doc["answers"])),
        }

    def docs(self):
        return [self._process_doc(d) for d in super().docs()]

    def context(self, doc):
        # superglue.py:322-327
        initial_text, *highlights = doc["passage"].strip().split("\n@highlight\n")
        text = initial_text + "\n\n"
        for highlight in highlights:
            text += f"  - {highlight}.\n"
        return text

    @staticmethod
    def format_answer(query, entity):
        # superglue.py:329-331
        return f"  - {query}".replace("@placeholder", entity)

    def requests(self, doc):
        ctx = self.context(doc)
        return [
            Request(ctx, self.format_answer(doc["query"], ent))
            for ent in doc["entities"]
        ]

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        best = max(range(len(lls)), key=lls.__getitem__)
        prediction = doc["entities"][best]
        golds = doc["answers"]
        return {
            "f1": M.metric_max_over_ground_truths(M.squad_f1, prediction, golds),
            "em": M.metric_max_over_ground_truths(M.squad_em, prediction, golds),
        }


class Lambada(_DocTask, Task):
    """Last-word prediction: greedy accuracy + token perplexity."""

    name = "lambada"
    dataset = ("EleutherAI/lambada_openai", "default", "test")

    def requests(self, doc):
        text = doc["text"]
        ctx, _, last = text.rpartition(" ")
        return [Request(ctx, " " + last)]

    def process_results(self, doc, results):
        ll, greedy = results[0]
        return {"acc": float(greedy), "nll": -ll}

    def aggregate(self, per_doc):
        import numpy as np

        from .. import metrics as M

        accs = [d["acc"] for d in per_doc]
        nlls = [d["nll"] for d in per_doc]
        return {
            "acc": M.mean(accs),
            "acc_stderr": M.bootstrap_stderr(accs),
            "ppl": float(np.exp(np.mean(nlls))),
        }


TASK_REGISTRY = {
    t.name: t
    for t in (PIQA, ARCEasy, ARCChallenge, BoolQ, CB, COPA, RTE, WiC, WSC,
              StoryCloze, Lambada, MultiRC, ReCoRD)
}


def get_task(name: str, docs: Optional[List[dict]] = None):
    if name not in TASK_REGISTRY:
        raise ValueError(
            f"unknown task {name!r}; available: {sorted(TASK_REGISTRY)}"
        )
    return TASK_REGISTRY[name](docs=docs)
