"""Deterministic synthetic documents for EVERY registered task.

Purpose: exercise each task's REAL prompt format, request construction and
metric pipeline offline (zero egress — HF datasets are unreachable in the
build environment, SURVEY.md §6). The docs are nonsense text in the exact
field schema each task's loader produces, so `--synthetic_docs` runs the
full 21-task evaluator end to end; accuracy numbers are chance-level by
construction and only the plumbing is meaningful. On a real-data mount,
drop the flag and the same command evaluates the real sets
(cli/accept.py).
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, List

_WORDS = ("river stone cloud market lantern copper orchard signal harbor "
          "meadow circuit velvet anchor thimble quarry ribbon sparrow "
          "timber canyon ledger").split()


def _rng(task: str, seed: int) -> random.Random:
    return random.Random(f"{task}-{seed}")


def _sent(r: random.Random, n: int = 6) -> str:
    s = " ".join(r.choice(_WORDS) for _ in range(n))
    return s[0].upper() + s[1:] + "."


def synthetic_docs(task: str, n: int = 8, seed: int = 0) -> Dict[str, list]:
    """{split: [docs]} in the schema `TASK_REGISTRY[task]` consumes."""
    r = _rng(task, seed)

    def many(fn) -> List[dict]:
        return [fn(i) for i in range(n)]

    if task in ("piqa", "synthetic"):
        return {"train": many(lambda i: {
                    "goal": f"pick {i}", "sol1": _sent(r, 3),
                    "sol2": _sent(r, 3), "label": r.randint(0, 1)}),
                "validation": many(lambda i: {
                    "goal": f"pick {i}", "sol1": _sent(r, 3),
                    "sol2": _sent(r, 3), "label": r.randint(0, 1)})}
    if task in ("arc_easy", "arc_challenge"):
        def arc(i):
            k = r.randint(3, 4)
            return {"id": f"q{i}",
                    "question": _sent(r, 5)[:-1] + "?",
                    "choices": {"text": [_sent(r, 2) for _ in range(k)],
                                "label": list("ABCDE")[:k]},
                    "answerKey": list("ABCDE")[r.randrange(k)]}
        # ARC has_test_docs() is True: the evaluator reads the test split
        return {"train": many(arc), "validation": many(arc),
                "test": many(arc)}
    if task == "lambada":
        return {"test": many(lambda i: {"text": _sent(r, 12)[:-1]})}
    if task == "storycloze":
        def sc(i):
            return {"input_sentence_1": _sent(r), "input_sentence_2": _sent(r),
                    "input_sentence_3": _sent(r), "input_sentence_4": _sent(r),
                    "sentence_quiz1": _sent(r, 4),
                    "sentence_quiz2": _sent(r, 4),
                    "answer_right_ending": r.randint(1, 2)}
        return {"validation": many(sc)}
    if task == "boolq":
        def bq(i):
            return {"passage": _sent(r, 10),
                    "question": _sent(r, 4)[:-1], "label": r.randint(0, 1)}
        return {"train": many(bq), "validation": many(bq)}
    if task == "cb":
        def cb(i):
            return {"premise": _sent(r, 8), "hypothesis": _sent(r, 4),
                    "label": r.randint(0, 2)}
        return {"train": many(cb), "validation": many(cb)}
    if task == "copa":
        def cp(i):
            return {"premise": _sent(r, 5),
                    "choice1": _sent(r, 3)[:-1], "choice2": _sent(r, 3)[:-1],
                    "question": r.choice(["cause", "effect"]),
                    "label": r.randint(0, 1)}
        return {"train": many(cp), "validation": many(cp)}
    if task == "wic":
        def wc(i):
            s1 = _sent(r, 5)
            first = s1.split()[0]
            return {"sentence1": s1, "sentence2": _sent(r, 5),
                    "start1": 0, "end1": len(first),
                    "label": r.randint(0, 1)}
        return {"train": many(wc), "validation": many(wc)}
    if task == "multirc":
        def mr(i):
            return {"paragraph": _sent(r, 12),
                    "question": _sent(r, 4)[:-1] + "?",
                    "answer": _sent(r, 2)[:-1],
                    "label": r.randint(0, 1),
                    "idx": {"paragraph": i // 3, "question": i // 2,
                            "answer": i}}
        return {"train": many(mr), "validation": many(mr)}
    if task == "record":
        def rc(i):
            ents = sorted({r.choice(_WORDS).capitalize() for _ in range(3)})
            passage = (_sent(r, 8) + "\n@highlight\n" + _sent(r, 5)[:-1]
                       + "\n@highlight\n" + _sent(r, 5)[:-1])
            return {"passage": passage,
                    "query": _sent(r, 4)[:-1] + " @placeholder.",
                    "entities": ents, "answers": [ents[0]]}
        return {"train": many(rc), "validation": many(rc)}
    if task == "wsc":
        def ws(i):
            noun = r.choice(_WORDS).capitalize()
            text = f"{noun} saw the {r.choice(_WORDS)} and it fell."
            return {"text": text, "span1_text": noun, "span2_text": "it",
                    "span1_index": 0,
                    "span2_index": len(text.split()) - 2,
                    "label": r.randint(0, 1)}
        return {"train": many(ws), "validation": many(ws)}
    if task in ("rte", "wnli"):
        def nli(i):
            return {"sentence1": _sent(r, 6), "sentence2": _sent(r, 4),
                    "label": r.randint(0, 1)}
        return {"train": many(nli), "validation": many(nli)}
    if task == "cola":
        return {"train": many(lambda i: {"sentence": _sent(r, 5),
                                         "label": r.randint(0, 1)}),
                "validation": many(lambda i: {"sentence": _sent(r, 5),
                                              "label": r.randint(0, 1)})}
    if task == "sst":
        return {"train": many(lambda i: {"sentence": _sent(r, 5),
                                         "label": r.randint(0, 1)}),
                "validation": many(lambda i: {"sentence": _sent(r, 5),
                                              "label": r.randint(0, 1)})}
    if task in ("mnli", "mnli_mismatched"):
        split = ("validation_matched" if task == "mnli"
                 else "validation_mismatched")
        def mn(i):
            return {"premise": _sent(r, 6), "hypothesis": _sent(r, 4),
                    "label": r.randint(0, 2)}
        return {"train": many(mn), split: many(mn)}
    if task == "qnli":
        def qn(i):
            return {"question": _sent(r, 4)[:-1] + "?",
                    "sentence": _sent(r, 6), "label": r.randint(0, 1)}
        return {"train": many(qn), "validation": many(qn)}
    if task == "mrpc":
        def mp(i):
            return {"sentence1": _sent(r, 5), "sentence2": _sent(r, 5),
                    "label": r.randint(0, 1)}
        return {"train": many(mp), "validation": many(mp)}
    if task == "qqp":
        def qp(i):
            return {"question1": _sent(r, 5)[:-1] + "?",
                    "question2": _sent(r, 5)[:-1] + "?",
                    "label": r.randint(0, 1)}
        return {"train": many(qp), "validation": many(qp)}
    raise KeyError(f"no synthetic docs for task {task!r}")


def synthetic_datasets(task_names: Iterable[str], n: int = 8,
                       seed: int = 0) -> Dict[str, dict]:
    """{task: docs} for get_task_dict(..., datasets=...)."""
    return {t: synthetic_docs(t, n, seed) for t in task_names}
