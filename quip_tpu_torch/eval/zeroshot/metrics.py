"""Evaluation metrics + bootstrap stderr.

Capability parity with the reference's zeroShot/metrics.py:10-254, without
the sklearn/sacrebleu dependencies (f1 and matthews implemented directly).
"""
from __future__ import annotations

import math
import random
from typing import Callable, Sequence

import numpy as np


def mean(arr: Sequence[float]) -> float:
    return sum(arr) / len(arr)


def pop_stddev(arr):
    mu = mean(arr)
    return math.sqrt(sum((x - mu) ** 2 for x in arr) / len(arr))


def sample_stddev(arr):
    mu = mean(arr)
    return math.sqrt(sum((x - mu) ** 2 for x in arr) / (len(arr) - 1))


def mean_stderr(arr):
    return sample_stddev(arr) / math.sqrt(len(arr))


def median(arr):
    return sorted(arr)[len(arr) // 2]


def perplexity(items: Sequence[float]) -> float:
    """exp(-mean loglikelihood) (metrics.py:29-30)."""
    return math.exp(-mean(items))


def weighted_mean(items):
    a, b = zip(*items)
    return sum(a) / sum(b)


def weighted_perplexity(items) -> float:
    """items: (loglikelihood, weight) pairs (metrics.py:37-38)."""
    return math.exp(-weighted_mean(items))


def bits_per_byte(items) -> float:
    return -weighted_mean(items) / math.log(2)


def f1_score(items) -> float:
    """Binary F1 over (pred, gold) pairs (metrics.py uses sklearn.f1_score)."""
    preds, golds = zip(*items)
    preds = np.asarray(preds)
    golds = np.asarray(golds)
    tp = float(np.sum((preds == 1) & (golds == 1)))
    fp = float(np.sum((preds == 1) & (golds == 0)))
    fn = float(np.sum((preds == 0) & (golds == 1)))
    if tp == 0:
        return 0.0
    prec = tp / (tp + fp)
    rec = tp / (tp + fn)
    return 2 * prec * rec / (prec + rec)


def f1_multiclass(items, average="macro") -> float:
    preds, golds = zip(*items)
    preds = np.asarray(preds)
    golds = np.asarray(golds)
    scores = []
    for c in np.unique(golds):
        tp = float(np.sum((preds == c) & (golds == c)))
        fp = float(np.sum((preds == c) & (golds != c)))
        fn = float(np.sum((preds != c) & (golds == c)))
        if tp == 0:
            scores.append(0.0)
            continue
        prec = tp / (tp + fp)
        rec = tp / (tp + fn)
        scores.append(2 * prec * rec / (prec + rec))
    return float(np.mean(scores))


def matthews_corrcoef(items) -> float:
    """Binary MCC over (pred, gold) pairs (metrics.py:90-93)."""
    preds, golds = zip(*items)
    preds = np.asarray(preds)
    golds = np.asarray(golds)
    tp = float(np.sum((preds == 1) & (golds == 1)))
    tn = float(np.sum((preds == 0) & (golds == 0)))
    fp = float(np.sum((preds == 1) & (golds == 0)))
    fn = float(np.sum((preds == 0) & (golds == 1)))
    denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    if denom == 0:
        return 0.0
    return (tp * tn - fp * fn) / denom


def acc_all(items) -> float:
    """MultiRC question-level accuracy: all answers within a question must
    be correct (metrics.py:96-109)."""
    question_scoring_dict = {}
    for pred, doc in items:
        qid = (doc["idx"]["paragraph"], doc["idx"]["question"])
        question_scoring_dict.setdefault(qid, []).append(
            pred == bool(doc["label"]))
    return mean([int(all(x)) for x in question_scoring_dict.values()])


def metric_max_over_ground_truths(metric_fn, prediction,
                                  ground_truths) -> float:
    return max(metric_fn(prediction, gt) for gt in ground_truths)


# --- SQuAD-style token F1 / EM for ReCoRD ---------------------------------


def _normalize_text(s: str) -> str:
    import re, string
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def squad_em(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def squad_f1(prediction: str, ground_truth: str) -> float:
    pred_toks = _normalize_text(prediction).split()
    gold_toks = _normalize_text(ground_truth).split()
    common = {}
    for t in pred_toks:
        common[t] = common.get(t, 0)
    overlap = 0
    gold_counts = {}
    for t in gold_toks:
        gold_counts[t] = gold_counts.get(t, 0) + 1
    pred_counts = {}
    for t in pred_toks:
        pred_counts[t] = pred_counts.get(t, 0) + 1
    for t, c in pred_counts.items():
        overlap += min(c, gold_counts.get(t, 0))
    if len(pred_toks) == 0 or len(gold_toks) == 0:
        return float(pred_toks == gold_toks)
    if overlap == 0:
        return 0.0
    prec = overlap / len(pred_toks)
    rec = overlap / len(gold_toks)
    return 2 * prec * rec / (prec + rec)


# --- bootstrap stderr (metrics.py:209-254) --------------------------------


def bootstrap_stderr(f: Callable, xs: Sequence, iters: int = 1000) -> float:
    """Bootstrap the stderr of metric f over xs. The reference spins a
    multiprocessing pool (metrics.py:210-212); sequential numpy is plenty
    here and deterministic."""
    rnd = random.Random(42)
    res = []
    n = len(xs)
    for _ in range(min(iters, 100000)):
        res.append(f(rnd.choices(xs, k=n)))
    return sample_stddev(res)


def stderr_for_metric(metric: Callable, bootstrap_iters: int = 1000):
    """Return a stderr estimator for a given aggregation metric
    (metrics.py:238-254)."""
    if bootstrap_iters <= 0:
        return None
    bootstrappable = {mean, median, matthews_corrcoef, f1_score,
                      perplexity, bits_per_byte, weighted_perplexity}
    if metric in bootstrappable:
        return lambda xs: bootstrap_stderr(metric, xs, bootstrap_iters)
    stderr = {mean: mean_stderr}
    return stderr.get(metric, None)
