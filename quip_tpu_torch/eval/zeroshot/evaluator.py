"""Zero-shot evaluator.

Capability parity with the reference's zeroShot/evaluator.py:17-240:
seed everything, build requests per doc, group by request type, batch through
the LM, route results back to task.process_results, aggregate with bootstrap
stderr, render a table.
"""
from __future__ import annotations

import collections
import itertools
import random
from typing import Dict, Optional

import numpy as np

from quip_tpu_torch.eval.zeroshot import metrics as metrics_mod
from quip_tpu_torch.eval.zeroshot.base import Task


def simple_evaluate(
    lm,
    tasks: Dict[str, Task],
    num_fewshot: int = 0,
    limit: Optional[int] = None,
    bootstrap_iters: int = 1000,
    description_dict: Optional[dict] = None,
    seed: int = 1234,
):
    """Run the full evaluation (evaluator.py:17-72). `lm` is a TorchLM."""
    random.seed(seed)
    np.random.seed(seed)
    results = evaluate(lm, tasks, num_fewshot=num_fewshot, limit=limit,
                       bootstrap_iters=bootstrap_iters,
                       description_dict=description_dict)
    results["config"] = {
        "num_fewshot": num_fewshot,
        "limit": limit,
        "bootstrap_iters": bootstrap_iters,
    }
    return results


def evaluate(lm, task_dict, num_fewshot=0, limit=None, bootstrap_iters=1000,
             description_dict=None):
    """evaluator.py:76-211 semantics."""
    task_dict_items = [(name, task) for name, task in task_dict.items()
                       if (task.has_validation_docs()
                           or task.has_test_docs())]

    results = collections.defaultdict(dict)
    versions = collections.defaultdict(dict)
    requests = collections.defaultdict(list)
    requests_origin = collections.defaultdict(list)
    docs = {}

    for task_name, task in task_dict_items:
        versions[task_name] = task.VERSION
        if task.has_test_docs():
            task_doc_func = task.test_docs
        elif task.has_validation_docs():
            task_doc_func = task.validation_docs
        else:
            raise RuntimeError("Task has neither test_docs nor validation_docs")

        task_docs = list(task_doc_func())
        rnd = random.Random()
        rnd.seed(42)
        rnd.shuffle(task_docs)

        description = (description_dict.get(task_name, "")
                       if description_dict else "")

        for doc_id, doc in enumerate(itertools.islice(task_docs, 0, limit)):
            docs[(task_name, doc_id)] = doc
            ctx = task.fewshot_context(doc=doc, num_fewshot=num_fewshot,
                                       rnd=rnd, description=description)
            reqs = task.construct_requests(doc, ctx)
            if not isinstance(reqs, (list, tuple)):
                reqs = [reqs]
            for i, req in enumerate(reqs):
                requests[req.request_type].append(req)
                requests_origin[req.request_type].append(
                    (i, task_name, doc, doc_id))

    process_res_queue = collections.defaultdict(list)
    for reqtype, reqs in requests.items():
        resps = getattr(lm, reqtype)([req.args for req in reqs])
        resps = [x if req.index is None else x[req.index]
                 for x, req in zip(resps, reqs)]
        for resp, (i, task_name, doc, doc_id) in zip(
                resps, requests_origin[reqtype]):
            process_res_queue[(task_name, doc_id)].append((i, resp))

    vals = collections.defaultdict(list)
    for (task_name, doc_id), requests_ in process_res_queue.items():
        requests_.sort(key=lambda x: x[0])
        requests_ = [x[1] for x in requests_]
        task = task_dict[task_name]
        doc = docs[(task_name, doc_id)]
        metrics_out = task.process_results(doc, requests_)
        for metric, value in metrics_out.items():
            vals[(task_name, metric)].append(value)

    for (task_name, metric), items in vals.items():
        task = task_dict[task_name]
        results[task_name][metric] = task.aggregation()[metric](items)
        stderr = metrics_mod.stderr_for_metric(
            metric=task.aggregation()[metric],
            bootstrap_iters=(min(bootstrap_iters, 1000)
                             if metric in ("bleu", "chrf", "ter")
                             else bootstrap_iters))
        if stderr is not None:
            results[task_name][metric + "_stderr"] = stderr(items)

    return {"results": dict(results), "versions": dict(versions)}


def make_table(result_dict) -> str:
    """Markdown results table (evaluator.py:214-240)."""
    rows = []
    header = "|Task|Version|Metric|Value| |Stderr|"
    sep = "|---|---:|---|---:|---|---:|"
    for k, dic in result_dict["results"].items():
        version = result_dict["versions"].get(k, "")
        for m, v in dic.items():
            if m.endswith("_stderr"):
                continue
            if m + "_stderr" in dic:
                se = dic[m + "_stderr"]
                rows.append(f"|{k}|{version}|{m}|{v:.4f}|±|{se:.4f}|")
            else:
                rows.append(f"|{k}|{version}|{m}|{v:.4f}| | |")
            k = ""
            version = ""
    return "\n".join([header, sep] + rows)
