"""Zero-shot task framework.

Capability parity with the vendored lm-evaluation-harness subset
(the reference's zeroShot/tasks/tasks_utils.py:101-540): Task /
MultipleChoiceTask / PerplexityTask ABCs, the Request factory, and fewshot
context assembly. Torch-free; datasets load through HF `datasets` when
available (this framework also accepts pre-built docs for offline use).
"""
from __future__ import annotations

import abc
import random
import re
from typing import Dict, Iterable, Optional

import numpy as np

from quip_tpu_torch.eval.zeroshot.metrics import mean, weighted_perplexity, bits_per_byte


REQUEST_RETURN_LENGTHS = {
    "loglikelihood": 2,
    "greedy_until": None,
    "loglikelihood_rolling": None,
}


class Request:
    """A single LM request (tasks_utils.py:491-527)."""

    def __init__(self, request_type: str, args, index: Optional[int] = None):
        if request_type not in REQUEST_RETURN_LENGTHS:
            raise NotImplementedError(
                f"The request type {request_type!r} is not implemented!")
        self.request_type = request_type
        self.args = args
        self.index = index

    def __iter__(self):
        if REQUEST_RETURN_LENGTHS[self.request_type] is None:
            raise IndexError("This request type does not return multiple arguments!")
        for i in range(REQUEST_RETURN_LENGTHS[self.request_type]):
            yield Request(self.request_type, self.args, i)

    def __getitem__(self, i):
        if REQUEST_RETURN_LENGTHS[self.request_type] is None:
            raise IndexError("This request type does not return multiple arguments!")
        return Request(self.request_type, self.args, i)

    def __repr__(self):
        return f"Req_{self.request_type}{self.args}[{self.index}]\n"


class RequestFactory:
    def __getattr__(self, attr):
        def fn(*args):
            return Request(attr, args)
        return fn


rf = RequestFactory()


class Task(abc.ABC):
    """One evaluation task (tasks_utils.py:101-365)."""

    VERSION = 0
    DATASET_PATH: Optional[str] = None
    DATASET_NAME: Optional[str] = None

    def __init__(self, data_dir=None, cache_dir=None, download_mode=None,
                 dataset: Optional[Dict[str, Iterable[dict]]] = None):
        # `dataset` override: pre-built {'train'|'validation'|'test': docs}
        # for offline/e2e-test use (the reference always downloads;
        # zero-egress environments can't)
        self.download(data_dir, cache_dir, download_mode, dataset)
        self._training_docs = None
        self._fewshot_docs = None

    def download(self, data_dir=None, cache_dir=None, download_mode=None,
                 dataset=None):
        if dataset is not None:
            self.dataset = dataset
            return
        import datasets
        self.dataset = datasets.load_dataset(
            path=self.DATASET_PATH, name=self.DATASET_NAME,
            data_dir=data_dir, cache_dir=cache_dir,
            download_mode=download_mode)

    @abc.abstractmethod
    def has_training_docs(self):
        ...

    @abc.abstractmethod
    def has_validation_docs(self):
        ...

    @abc.abstractmethod
    def has_test_docs(self):
        ...

    def training_docs(self) -> Iterable[dict]:
        return []

    def validation_docs(self) -> Iterable[dict]:
        return []

    def test_docs(self) -> Iterable[dict]:
        return []

    def _fewshot_examples(self, k, rnd):
        if self._fewshot_docs is None:
            self._fewshot_docs = list(
                self.training_docs() if self.has_training_docs()
                else self.validation_docs())
        return rnd.sample(self._fewshot_docs, k)

    @abc.abstractmethod
    def doc_to_text(self, doc) -> str:
        ...

    @abc.abstractmethod
    def doc_to_target(self, doc) -> str:
        ...

    @abc.abstractmethod
    def construct_requests(self, doc, ctx):
        ...

    @abc.abstractmethod
    def process_results(self, doc, results) -> dict:
        ...

    @abc.abstractmethod
    def aggregation(self) -> dict:
        ...

    @abc.abstractmethod
    def higher_is_better(self) -> dict:
        ...

    def fewshot_context(self, doc, num_fewshot, rnd=None,
                        description=None) -> str:
        """tasks_utils.py:330-365 semantics."""
        assert rnd is not None, "must pass rnd (a random.Random)"
        description = description + "\n\n" if description else ""
        if num_fewshot == 0:
            labeled_examples = ""
        else:
            if self.has_training_docs():
                fewshotex = self._fewshot_examples(num_fewshot, rnd)
            else:
                if self._fewshot_docs is None:
                    self._fewshot_docs = list(
                        self.validation_docs() if self.has_validation_docs()
                        else self.test_docs())
                fewshotex = rnd.sample(self._fewshot_docs, num_fewshot + 1)
                fewshotex = [x for x in fewshotex if x != doc][:num_fewshot]
            labeled_examples = "\n\n".join(
                self.doc_to_text(d) + self.doc_to_target(d)
                for d in fewshotex) + "\n\n"
        return description + labeled_examples + self.doc_to_text(doc)


class MultipleChoiceTask(Task):
    """Per-choice loglikelihood; acc + length-normalized acc_norm
    (tasks_utils.py:368-403)."""

    def doc_to_target(self, doc):
        return " " + doc["choices"][doc["gold"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " {}".format(choice))[0]
                for choice in doc["choices"]]

    def process_results(self, doc, results):
        gold = doc["gold"]
        acc = 1.0 if np.argmax(results) == gold else 0.0
        completion_len = np.array([float(len(i)) for i in doc["choices"]])
        acc_norm = 1.0 if np.argmax(results / completion_len) == gold else 0.0
        return {"acc": acc, "acc_norm": acc_norm}

    def higher_is_better(self):
        return {"acc": True, "acc_norm": True}

    def aggregation(self):
        return {"acc": mean, "acc_norm": mean}


class PerplexityTask(Task, abc.ABC):
    """Rolling-loglikelihood perplexity tasks (tasks_utils.py:406-488)."""

    def has_training_docs(self):
        return False

    def fewshot_context(self, doc, num_fewshot, rnd=None, description=None):
        assert num_fewshot == 0, \
            "The number of fewshot examples must be 0 for perplexity tasks."
        return ""

    def higher_is_better(self):
        return {"word_perplexity": False, "byte_perplexity": False,
                "bits_per_byte": False}

    def doc_to_text(self, doc):
        return ""

    def doc_to_target(self, doc):
        return doc

    def construct_requests(self, doc, ctx):
        assert not ctx
        return rf.loglikelihood_rolling(self.doc_to_target(doc))

    def process_results(self, doc, results):
        (loglikelihood,) = results
        words = self.count_words(doc)
        bytes_ = self.count_bytes(doc)
        return {
            "word_perplexity": (loglikelihood, words),
            "byte_perplexity": (loglikelihood, bytes_),
            "bits_per_byte": (loglikelihood, bytes_),
        }

    def aggregation(self):
        return {"word_perplexity": weighted_perplexity,
                "byte_perplexity": weighted_perplexity,
                "bits_per_byte": bits_per_byte}

    @classmethod
    def count_bytes(cls, doc):
        return len(doc.encode("utf-8"))

    @classmethod
    def count_words(cls, doc):
        return len(re.split(r"\s+", doc))


def general_detokenize(s: str) -> str:
    s = s.replace(" n't", "n't")
    s = s.replace(" )", ")")
    s = s.replace("( ", "(")
    s = s.replace('" ', '"')
    s = s.replace(' "', '"')
    s = re.sub(r" (['.,])", r"\1", s)
    return s


def yesno(x) -> str:
    return "yes" if x else "no"
