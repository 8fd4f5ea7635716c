"""The 13 evaluation tasks from the reference registry
(zeroShot/tasks/__init__.py:17-31): lambada, piqa, arc_easy,
arc_challenge, boolq, cb, copa, wic, multirc, rte, record, wsc, storycloze.

Prompt formats are ported faithfully (citations per class). The paper's
headline suite is {arc_easy, lambada, piqa, storycloze} (README.md:53).
"""
from __future__ import annotations

import numpy as np

from quip_tpu_torch.eval.zeroshot.base import (MultipleChoiceTask, Task,
                                         general_detokenize, rf, yesno)
from quip_tpu_torch.eval.zeroshot import metrics
from quip_tpu_torch.eval.zeroshot.metrics import (acc_all, mean,
                                            metric_max_over_ground_truths,
                                            perplexity, squad_em, squad_f1)


class PiQA(MultipleChoiceTask):
    """zeroShot/tasks/piqa.py:28-66."""

    VERSION = 0
    DATASET_PATH = "piqa"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc,
                                           self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def _process_doc(self, doc):
        return {"goal": doc["goal"],
                "choices": [doc["sol1"], doc["sol2"]],
                "gold": doc["label"]}

    def doc_to_text(self, doc):
        return "Question: " + doc["goal"] + "\nAnswer:"


class Synthetic(MultipleChoiceTask):
    """Offline smoke task (no reference counterpart, no network): PiQA-shaped
    multiple-choice docs generated deterministically. Lets the zeroshot CLI
    run end-to-end in zero-egress environments."""

    VERSION = 0
    DATASET_PATH = None

    def download(self, data_dir=None, cache_dir=None, download_mode=None,
                 dataset=None):
        import numpy as np

        if dataset is not None:
            self.dataset = dataset
            return
        rng = np.random.default_rng(0)
        def mk(tag, n):
            docs = []
            for i in range(n):
                a, b = rng.integers(0, 1000, 2)
                docs.append({"goal": f"{tag} question {i}: pick {a}",
                             "sol1": f"option {a}", "sol2": f"option {b}",
                             "label": 0})
            return docs
        self.dataset = {"train": mk("train", 16),
                        "validation": mk("val", 16)}

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc,
                                           self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def _process_doc(self, doc):
        return {"goal": doc["goal"],
                "choices": [doc["sol1"], doc["sol2"]],
                "gold": doc["label"]}

    def doc_to_text(self, doc):
        return "Question: " + doc["goal"] + "\nAnswer:"


class ARCEasy(MultipleChoiceTask):
    """zeroShot/tasks/arc.py:28-80."""

    VERSION = 0
    DATASET_PATH = "ai2_arc"
    DATASET_NAME = "ARC-Easy"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc,
                                           self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        num_to_letter = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}
        answer_key = num_to_letter.get(doc["answerKey"], doc["answerKey"])
        return {
            "id": doc["id"],
            "query": "Question: " + doc["question"] + "\nAnswer:",
            "choices": doc["choices"]["text"],
            "gold": ["A", "B", "C", "D", "E"].index(answer_key),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class ARCChallenge(ARCEasy):
    DATASET_PATH = "ai2_arc"
    DATASET_NAME = "ARC-Challenge"


class LAMBADA(Task):
    """zeroShot/tasks/lambada.py:40-89: predict the final word; report
    perplexity of the target word + exact-greedy accuracy."""

    VERSION = 0
    DATASET_PATH = "lambada"

    def download(self, data_dir=None, cache_dir=None, download_mode=None,
                 dataset=None):
        if dataset is not None:
            self.dataset = dataset
            return
        if data_dir is not None:
            self.dataset = self._load_jsonl_dir(data_dir)
            return
        super().download(data_dir, cache_dir, download_mode, dataset)

    @staticmethod
    def _load_jsonl_dir(data_dir):
        """Offline loader: a directory (or file path) holding the OpenAI
        LAMBADA jsonl ({"text": ...} per line — the exact file the
        reference's vendored loading script fetches,
        zeroShot/tasks/local_datasets/lambada/lambada.py:56-62). Zero
        egress: nothing is downloaded."""
        import glob
        import json
        import os

        if os.path.isfile(data_dir):
            paths = [data_dir]
        else:
            paths = (sorted(glob.glob(os.path.join(data_dir, "*.jsonl")))
                     or sorted(glob.glob(
                         os.path.join(data_dir, "lambada*.json"))))
        if not paths:
            raise FileNotFoundError(
                f"no lambada .jsonl under {data_dir!r} (expected e.g. "
                "lambada_test.jsonl)")
        docs = []
        for path in paths:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        docs.append({"text": json.loads(line)["text"]})
        return {"test": docs}

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.dataset["test"]

    @staticmethod
    def preprocess(text):
        text = text.replace("“", '"').replace("”", '"')
        text = text.replace("’", "'").replace("‘", "'")
        return text

    def doc_to_text(self, doc):
        return self.preprocess(doc["text"].strip()).rsplit(" ", 1)[0]

    def doc_to_target(self, doc):
        return " " + doc["text"].rsplit(" ", 1)[1]

    def construct_requests(self, doc, ctx):
        ll, is_greedy = rf.loglikelihood(ctx, self.doc_to_target(doc))
        return ll, is_greedy

    def process_results(self, doc, results):
        ll, is_greedy = results
        return {"ppl": ll, "acc": int(is_greedy)}

    def aggregation(self):
        return {"ppl": perplexity, "acc": mean}

    def higher_is_better(self):
        return {"ppl": False, "acc": True}


class StoryCloze(Task):
    """zeroShot/tasks/storycloze.py:33-142 (local CSV, 2018 set).

    StoryCloze is not publicly downloadable; pass ``data_dir`` pointing at a
    folder containing the ROCStories 2018 validation/test CSVs (the
    reference vendors them under tasks/local_datasets/storyCloze2018)."""

    VERSION = 0
    DATASET_PATH = "story_cloze"
    DATASET_NAME = "2018"

    _CSV_COLUMNS = ["input_sentence_1", "input_sentence_2",
                    "input_sentence_3", "input_sentence_4",
                    "sentence_quiz1", "sentence_quiz2",
                    "answer_right_ending"]

    def download(self, data_dir=None, cache_dir=None, download_mode=None,
                 dataset=None):
        if dataset is not None:
            self.dataset = dataset
            return
        if data_dir is not None:
            self.dataset = self._load_csv_dir(data_dir)
            return
        super().download(data_dir, cache_dir, download_mode, dataset)

    @classmethod
    def _load_csv_dir(cls, data_dir):
        """Load ROCStories CSVs: columns InputSentence1..4, RandomFifthSentenceQuiz1/2, AnswerRightEnding."""
        import csv
        import glob
        import os

        out = {"validation": [], "test": []}
        for path in glob.glob(os.path.join(data_dir, "*.csv")):
            split = "test" if "test" in os.path.basename(path).lower() \
                else "validation"
            with open(path, newline="", encoding="utf-8") as f:
                for row in csv.DictReader(f):
                    def g(*names):
                        for n in names:
                            if n in row:
                                return row[n]
                        raise KeyError(names)
                    out[split].append({
                        "input_sentence_1": g("InputSentence1"),
                        "input_sentence_2": g("InputSentence2"),
                        "input_sentence_3": g("InputSentence3"),
                        "input_sentence_4": g("InputSentence4"),
                        "sentence_quiz1": g("RandomFifthSentenceQuiz1"),
                        "sentence_quiz2": g("RandomFifthSentenceQuiz2"),
                        "answer_right_ending": int(g("AnswerRightEnding")),
                    })
        return out

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return " ".join([doc["input_sentence_1"], doc["input_sentence_2"],
                         doc["input_sentence_3"], doc["input_sentence_4"]])

    def doc_to_target(self, doc):
        clozes = [doc["sentence_quiz1"], doc["sentence_quiz2"]]
        return " " + clozes[doc["answer_right_ending"] - 1]

    def construct_requests(self, doc, ctx):
        clozes = [doc["sentence_quiz1"], doc["sentence_quiz2"]]
        return [rf.loglikelihood(ctx, " {}".format(c))[0] for c in clozes]

    def process_results(self, doc, results):
        gold = doc["answer_right_ending"] - 1
        return {"acc": 1.0 if np.argmax(results) == gold else 0.0}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class BoolQ(Task):
    """zeroShot/tasks/superglue.py:45-98."""

    VERSION = 1
    DATASET_PATH = "super_glue"
    DATASET_NAME = "boolq"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return (f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:")

    def doc_to_target(self, doc):
        return " " + yesno(doc["label"])

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": 1.0 if (ll_yes > ll_no) == doc["label"] else 0.0}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class CommitmentBank(Task):
    """zeroShot/tasks/superglue.py:101-175."""

    VERSION = 1
    DATASET_PATH = "super_glue"
    DATASET_NAME = "cb"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return "{}\nQuestion: {}. True, False or Neither?\nAnswer:".format(
            doc["premise"], doc["hypothesis"])

    def doc_to_target(self, doc):
        return " {}".format({0: "True", 1: "False", 2: "Neither"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_true, _ = rf.loglikelihood(ctx, " True")
        ll_false, _ = rf.loglikelihood(ctx, " False")
        ll_neither, _ = rf.loglikelihood(ctx, " Neither")
        return ll_true, ll_false, ll_neither

    def process_results(self, doc, results):
        gold = doc["label"]
        pred = np.argmax(results)
        return {"acc": 1.0 if pred == gold else 0.0, "f1": (pred, gold)}

    def higher_is_better(self):
        return {"acc": True, "f1": True}

    def aggregation(self):
        return {"acc": mean, "f1": metrics.f1_multiclass}


class Copa(Task):
    """zeroShot/tasks/superglue.py:178-239."""

    VERSION = 0
    DATASET_PATH = "super_glue"
    DATASET_NAME = "copa"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        connector = {"cause": "because", "effect": "therefore"}[doc["question"]]
        return doc["premise"].strip()[:-1] + f" {connector}"

    def doc_to_target(self, doc):
        correct = doc["choice1"] if doc["label"] == 0 else doc["choice2"]
        return " " + self.convert_choice(correct)

    @staticmethod
    def convert_choice(choice):
        return choice[0].lower() + choice[1:]

    def construct_requests(self, doc, ctx):
        choice1 = " " + self.convert_choice(doc["choice1"])
        choice2 = " " + self.convert_choice(doc["choice2"])
        ll1, _ = rf.loglikelihood(ctx, choice1)
        ll2, _ = rf.loglikelihood(ctx, choice2)
        return ll1, ll2

    def process_results(self, doc, results):
        return {"acc": 1.0 if np.argmax(results) == doc["label"] else 0.0}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class MultiRC(Task):
    """zeroShot/tasks/superglue.py:242-288."""

    VERSION = 1
    DATASET_PATH = "super_glue"
    DATASET_NAME = "multirc"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return f"{doc['paragraph']}\nQuestion: {doc['question']}\nAnswer:"

    def doc_to_target(self, doc):
        return " " + self.format_answer(doc["answer"], doc["label"])

    @staticmethod
    def format_answer(answer, label):
        label_str = "yes" if label else "no"
        return f"{answer}\nIs the answer correct? {label_str}"

    def construct_requests(self, doc, ctx):
        true_choice = self.format_answer(doc["answer"], True)
        false_choice = self.format_answer(doc["answer"], False)
        ll_t, _ = rf.loglikelihood(ctx, f" {true_choice}")
        ll_f, _ = rf.loglikelihood(ctx, f" {false_choice}")
        return ll_t, ll_f

    def process_results(self, doc, results):
        ll_t, ll_f = results
        return {"acc": (ll_t > ll_f, doc)}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": acc_all}


class ReCoRD(Task):
    """zeroShot/tasks/superglue.py:291-380."""

    VERSION = 0
    DATASET_PATH = "super_glue"
    DATASET_NAME = "record"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [self._process_doc(d)
                                   for d in self.dataset["train"]]
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    @classmethod
    def _process_doc(cls, doc):
        return {
            "passage": doc["passage"],
            "query": doc["query"],
            "entities": sorted(set(doc["entities"])),
            "answers": sorted(set(doc["answers"])),
        }

    def doc_to_text(self, doc):
        initial_text, *highlights = doc["passage"].strip().split(
            "\n@highlight\n")
        text = initial_text + "\n\n"
        for h in highlights:
            text += f"  - {h}.\n"
        return text

    @classmethod
    def format_answer(cls, query, entity):
        return f"  - {query}".replace("@placeholder", entity)

    def doc_to_target(self, doc):
        return self.format_answer(doc["query"], doc["answers"][0])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, self.format_answer(doc["query"], e))
                for e in doc["entities"]]

    def process_results(self, doc, results):
        max_idx = int(np.argmax(np.array([r[0] for r in results])))
        prediction = doc["entities"][max_idx]
        gold_set = doc["answers"]
        f1 = metric_max_over_ground_truths(squad_f1, prediction, gold_set)
        em = metric_max_over_ground_truths(squad_em, prediction, gold_set)
        return {"f1": f1, "em": em}

    def higher_is_better(self):
        return {"f1": True, "em": True}

    def aggregation(self):
        return {"f1": mean, "em": mean}


class WordsInContext(Task):
    """zeroShot/tasks/superglue.py:383-437."""

    VERSION = 0
    DATASET_PATH = "super_glue"
    DATASET_NAME = "wic"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Is the word '{}' "
                "used in the same way in the two sentences above?\nAnswer:"
                .format(doc["sentence1"], doc["sentence2"],
                        doc["sentence1"][doc["start1"]:doc["end1"]]))

    def doc_to_target(self, doc):
        return " {}".format({0: "no", 1: "yes"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": 1.0 if (ll_yes > ll_no) == doc["label"] else 0.0}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class WinogradSchemaChallenge(Task):
    """SuperGLUE binary WSC (zeroShot/tasks/superglue.py:440-504)."""

    VERSION = 0
    DATASET_PATH = "super_glue"
    DATASET_NAME = "wsc"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [d for d in self.dataset["train"]
                                   if d["label"]]
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        raw_passage = doc["text"]
        pre = " ".join(raw_passage.split()[: doc["span2_index"]])
        post = raw_passage[len(pre) + len(doc["span2_text"]) + 1:]
        passage = general_detokenize(
            pre + " *{}*".format(doc["span2_text"]) + post)
        noun = doc["span1_text"]
        pronoun = doc["span2_text"]
        return (f"Passage: {passage}\n"
                f'Question: In the passage above, does the pronoun '
                f'"*{pronoun}*" refer to "*{noun}*"?\n' + "Answer:")

    def doc_to_target(self, doc):
        return " " + yesno(doc["label"])

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": 1.0 if (ll_yes > ll_no) == doc["label"] else 0.0}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class RTE(Task):
    """GLUE RTE (zeroShot/tasks/glue.py:337-380)."""

    VERSION = 0
    DATASET_PATH = "glue"
    DATASET_NAME = "rte"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return "{}\nQuestion: {} True or False?\nAnswer:".format(
            doc["sentence1"], doc["sentence2"])

    def doc_to_target(self, doc):
        # 0 = entailment, 1 = not_entailment
        return " {}".format({0: "True", 1: "False"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_true, _ = rf.loglikelihood(ctx, " True")
        ll_false, _ = rf.loglikelihood(ctx, " False")
        return ll_true, ll_false

    def process_results(self, doc, results):
        pred = int(np.argmax(results))
        return {"acc": 1.0 if pred == doc["label"] else 0.0}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


# ---------------------------------------------------------------------------
# GLUE extras (reference zeroShot/tasks/glue.py:56-494).
#
# The reference DEFINES these classes but never registers them
# (zeroShot/tasks/__init__.py:17-31 lists only the 13-task suite); they are
# ported for completeness and registered under their lm-eval names. STSB
# (glue.py:495-572) is NOT ported: every method of it raises
# NotImplementedError in the reference — dead code with no behavior to match.
# Metric pairs follow this repo's (pred, gold) convention
# (metrics.f1_score / matthews_corrcoef are swap-invariant, so results
# match the reference's (gold, pred) ordering exactly).
# ---------------------------------------------------------------------------


class _GlueTask(Task):
    """Shared GLUE boilerplate (train+validation, no test)."""

    DATASET_PATH = "glue"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]


class CoLA(_GlueTask):
    """GLUE CoLA (zeroShot/tasks/glue.py:56-106)."""

    VERSION = 0
    DATASET_NAME = "cola"

    def doc_to_text(self, doc):
        return ("{}\nQuestion: Does this sentence make sense?\nAnswer:"
                .format(doc["sentence"]))

    def doc_to_target(self, doc):
        return " {}".format({1: "yes", 0: "no"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_true, _ = rf.loglikelihood(ctx, " yes")
        ll_false, _ = rf.loglikelihood(ctx, " no")
        return ll_true, ll_false

    def process_results(self, doc, results):
        ll_true, ll_false = results
        pred = int(ll_true > ll_false)
        return {"mcc": (pred, doc["label"])}

    def higher_is_better(self):
        return {"mcc": True}

    def aggregation(self):
        return {"mcc": metrics.matthews_corrcoef}


class SST(_GlueTask):
    """GLUE SST-2 (zeroShot/tasks/glue.py:109-156)."""

    VERSION = 0
    DATASET_NAME = "sst2"

    def doc_to_text(self, doc):
        return ("{}\nQuestion: Is this sentence positive or negative?"
                "\nAnswer:".format(general_detokenize(doc["sentence"])))

    def doc_to_target(self, doc):
        return " {}".format({1: "positive", 0: "negative"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_positive, _ = rf.loglikelihood(ctx, " positive")
        ll_negative, _ = rf.loglikelihood(ctx, " negative")
        return ll_positive, ll_negative

    def process_results(self, doc, results):
        ll_positive, ll_negative = results
        pred = ll_positive > ll_negative
        return {"acc": pred == doc["label"]}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class MNLI(_GlueTask):
    """GLUE MNLI matched (zeroShot/tasks/glue.py:159-218)."""

    VERSION = 0
    DATASET_NAME = "mnli"

    def validation_docs(self):
        return self.dataset["validation_matched"]

    def doc_to_text(self, doc):
        return "{}\nQuestion: {} True, False or Neither?\nAnswer:".format(
            doc["premise"],
            doc["hypothesis"].strip() +
            ("" if doc["hypothesis"].strip().endswith(".") else "."),
        )

    def doc_to_target(self, doc):
        # True = entailment, Neither = neutral, False = contradiction
        return " {}".format({0: "True", 1: "Neither", 2: "False"}
                            [doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_true, _ = rf.loglikelihood(ctx, " True")
        ll_neither, _ = rf.loglikelihood(ctx, " Neither")
        ll_false, _ = rf.loglikelihood(ctx, " False")
        return ll_true, ll_neither, ll_false

    def process_results(self, doc, results):
        return {"acc": int(np.argmax(results)) == doc["label"]}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class MNLIMismatched(MNLI):
    """GLUE MNLI mismatched (zeroShot/tasks/glue.py:221-230)."""

    VERSION = 0

    def validation_docs(self):
        return self.dataset["validation_mismatched"]


class QNLI(_GlueTask):
    """GLUE QNLI (zeroShot/tasks/glue.py:233-283)."""

    VERSION = 0
    DATASET_NAME = "qnli"

    def doc_to_text(self, doc):
        return ("{}\n{}\nQuestion: Does this response answer the question?"
                "\nAnswer:".format(doc["question"], doc["sentence"]))

    def doc_to_target(self, doc):
        # 0 = entailment, 1 = not entailment
        return " {}".format({0: "yes", 1: "no"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        pred = ll_no > ll_yes
        return {"acc": pred == doc["label"]}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class WNLI(_GlueTask):
    """GLUE WNLI (zeroShot/tasks/glue.py:286-334)."""

    VERSION = 1
    DATASET_NAME = "wnli"

    def doc_to_text(self, doc):
        return "{}\nQuestion: {} True or False?\nAnswer:".format(
            doc["sentence1"], doc["sentence2"])

    def doc_to_target(self, doc):
        # 1 = entailment -> True (note the inverted map vs RTE,
        # glue.py:307-310)
        return " {}".format({0: "False", 1: "True"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        ll_true, _ = rf.loglikelihood(ctx, " True")
        ll_false, _ = rf.loglikelihood(ctx, " False")
        return ll_true, ll_false

    def process_results(self, doc, results):
        ll_true, ll_false = results
        pred = ll_true > ll_false
        return {"acc": pred == doc["label"]}

    def higher_is_better(self):
        return {"acc": True}

    def aggregation(self):
        return {"acc": mean}


class MRPC(_GlueTask):
    """GLUE MRPC (zeroShot/tasks/glue.py:391-440)."""

    VERSION = 0
    DATASET_NAME = "mrpc"

    def doc_to_text(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Do both "
                "sentences mean the same thing?\nAnswer:".format(
                    general_detokenize(doc["sentence1"]),
                    general_detokenize(doc["sentence2"])))

    def doc_to_target(self, doc):
        return " {}".format(yesno(doc["label"]))

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        pred = int(ll_yes > ll_no)
        return {"acc": pred == doc["label"], "f1": (pred, doc["label"])}

    def higher_is_better(self):
        return {"acc": True, "f1": True}

    def aggregation(self):
        return {"acc": mean, "f1": metrics.f1_score}


class QQP(_GlueTask):
    """GLUE QQP (zeroShot/tasks/glue.py:443-492)."""

    VERSION = 0
    DATASET_NAME = "qqp"

    def doc_to_text(self, doc):
        return ("Question 1: {}\nQuestion 2: {}\nQuestion: Do both "
                "questions ask the same thing?\nAnswer:".format(
                    doc["question1"], doc["question2"]))

    def doc_to_target(self, doc):
        return " {}".format(yesno(doc["label"]))

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        pred = int(ll_yes > ll_no)
        return {"acc": pred == doc["label"], "f1": (pred, doc["label"])}

    def higher_is_better(self):
        return {"acc": True, "f1": True}

    def aggregation(self):
        return {"acc": mean, "f1": metrics.f1_score}
