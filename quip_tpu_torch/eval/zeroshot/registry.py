"""Task registry (parity with the reference's zeroShot/tasks/__init__.py:17-66)."""
from __future__ import annotations

from typing import Dict, List, Optional

from quip_tpu_torch.eval.zeroshot import tasks as T

TASK_REGISTRY = {
    "lambada": T.LAMBADA,
    "piqa": T.PiQA,
    "arc_easy": T.ARCEasy,
    "arc_challenge": T.ARCChallenge,
    "boolq": T.BoolQ,
    "cb": T.CommitmentBank,
    "copa": T.Copa,
    "wic": T.WordsInContext,
    "multirc": T.MultiRC,
    "rte": T.RTE,
    "record": T.ReCoRD,
    "wsc": T.WinogradSchemaChallenge,
    "storycloze": T.StoryCloze,
    # offline smoke task (ours, no reference counterpart): lets the CLI run
    # end-to-end with zero network egress
    "synthetic": T.Synthetic,
    # GLUE extras: defined but never registered by the reference
    # (zeroShot/tasks/glue.py:56-494 vs tasks/__init__.py:17-31); ported
    # for completeness. STSB is omitted — it is a NotImplementedError stub
    # in the reference.
    "cola": T.CoLA,
    "sst": T.SST,
    "mnli": T.MNLI,
    "mnli_mismatched": T.MNLIMismatched,
    "qnli": T.QNLI,
    "wnli": T.WNLI,
    "mrpc": T.MRPC,
    "qqp": T.QQP,
}

ALL_TASKS = sorted(TASK_REGISTRY)

# the paper's headline suite (reference README.md:53)
PAPER_SUITE = ["arc_easy", "lambada", "piqa", "storycloze"]


def get_task(task_name: str):
    try:
        return TASK_REGISTRY[task_name]
    except KeyError:
        raise KeyError(f"missing task {task_name}; known: {ALL_TASKS}")


def get_task_dict(task_name_list: List[str],
                  datasets: Optional[Dict[str, dict]] = None,
                  data_dir: Optional[str] = None):
    """Instantiate tasks. `datasets` optionally maps task name to pre-built
    docs; `data_dir` points tasks with vendored/local loaders (lambada
    jsonl, storycloze CSVs — reference zeroShot/tasks/local_datasets/) at
    their files. Both enable zero-egress operation."""
    out = {}
    for name in task_name_list:
        cls = get_task(name)
        ds = (datasets or {}).get(name)
        if ds is not None:
            out[name] = cls(dataset=ds)
        elif data_dir is not None:
            out[name] = cls(data_dir=data_dir)
        else:
            out[name] = cls()
    return out
