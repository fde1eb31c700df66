"""Task framework: request building, evaluation loop, aggregation (port
of ``evals/zeroshot/base.py``).

Mirrors the flow of reference gptq/zeroShot/evaluator.py:76-212 -- build all
(context, continuation) requests up front, score them in one batched pass
through the LM, then feed per-doc results to the task's ``process_results``
and aggregate with bootstrap stderr.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

from .. import metrics as M
from ..lm import EvalLM

Encode = Callable[[str], List[int]]


@dataclass
class Request:
    context: str
    continuation: str


class Task:
    """One zero-shot task: docs -> requests -> metrics."""

    name: str = "task"

    def docs(self) -> Iterable[dict]:
        raise NotImplementedError

    def requests(self, doc: dict) -> List[Request]:
        raise NotImplementedError

    def process_results(self, doc: dict, results: List[Tuple[float, bool]]) -> Dict[str, float]:
        raise NotImplementedError

    def aggregate(self, per_doc: List[Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if not per_doc:
            return out
        for key in per_doc[0]:
            vals = [d[key] for d in per_doc]
            out[key] = M.mean(vals)
            out[key + "_stderr"] = M.bootstrap_stderr(vals)
        return out


class MultipleChoiceTask(Task):
    """Choose the highest-loglikelihood continuation; acc + acc_norm."""

    def context(self, doc: dict) -> str:
        raise NotImplementedError

    def choices(self, doc: dict) -> List[str]:
        raise NotImplementedError

    def gold(self, doc: dict) -> int:
        raise NotImplementedError

    def requests(self, doc: dict) -> List[Request]:
        ctx = self.context(doc)
        return [Request(ctx, ch) for ch in self.choices(doc)]

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        gold = self.gold(doc)
        # acc_norm normalizes by the RAW choice byte length, excluding the
        # prompt's leading separator space (reference tasks_utils.py:386:
        # completion_len = len(choice) where the request adds " " + choice)
        lengths = [
            max(1, len(c[1:] if c.startswith(" ") else c))
            for c in self.choices(doc)
        ]
        normed = [ll / ln for ll, ln in zip(lls, lengths)]
        return {
            "acc": float(max(range(len(lls)), key=lls.__getitem__) == gold),
            "acc_norm": float(max(range(len(normed)), key=normed.__getitem__) == gold),
        }


def evaluate(
    lm: EvalLM,
    tasks: Sequence[Task],
    encode: Encode,
    limit: int | None = None,
) -> Dict[str, Dict[str, float]]:
    """Run tasks; returns {task_name: {metric: value, metric_stderr: ...}}."""
    all_pairs: List[Tuple[List[int], List[int]]] = []
    doc_index: List[Tuple[int, int, int]] = []  # (task_idx, doc_idx, n_requests)
    docs_per_task: List[List[dict]] = []

    for ti, task in enumerate(tasks):
        docs = list(task.docs())
        if limit:
            docs = docs[:limit]
        docs_per_task.append(docs)
        for di, doc in enumerate(docs):
            reqs = task.requests(doc)
            for r in reqs:
                all_pairs.append((encode(r.context), encode(r.continuation)))
            doc_index.append((ti, di, len(reqs)))

    scored = lm.loglikelihood(all_pairs)

    per_task_results: List[List[Dict[str, float]]] = [[] for _ in tasks]
    cursor = 0
    for ti, di, n in doc_index:
        chunk = scored[cursor : cursor + n]
        cursor += n
        doc = docs_per_task[ti][di]
        per_task_results[ti].append(tasks[ti].process_results(doc, chunk))

    return {
        task.name: task.aggregate(per_task_results[ti])
        for ti, task in enumerate(tasks)
    }


def make_table(results: Dict[str, Dict[str, float]], fmt: str = "markdown") -> str:
    """Render a results table (reference evaluator.py:215-241 make_table,
    without the pytablewriter dependency).  ``fmt``: "markdown" | "latex"."""
    rows: List[List[str]] = []
    for task, dic in sorted(results.items()):
        name = task
        for m, v in dic.items():
            if m.endswith("_stderr"):
                continue
            se = dic.get(m + "_stderr")
            rows.append([name, m, f"{v:.4f}",
                         "±" if se is not None else "",
                         f"{se:.4f}" if se is not None else ""])
            name = ""
    headers = ["Task", "Metric", "Value", "", "Stderr"]
    if fmt == "latex":
        lines = [r"\begin{tabular}{lllll}", r"\hline",
                 " & ".join(headers) + r" \\", r"\hline"]
        for r in rows:
            lines.append(" & ".join(c.replace("_", r"\_").replace("±", r"$\pm$")
                                    for c in r) + r" \\")
        lines += [r"\hline", r"\end{tabular}"]
        return "\n".join(lines)
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "|" + "|".join(c.ljust(w) for c, w in zip(cells, widths)) + "|"
    out = [line(headers), "|" + "|".join("-" * w for w in widths) + "|"]
    out += [line(r) for r in rows]
    return "\n".join(out)
