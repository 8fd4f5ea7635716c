"""The zero-shot harness against quip_tpu's (llama-tiny, CPU, f32).

The copied numpy modules (registry, synthetic docs, task prompts and
requests, metrics) must match quip_tpu's exactly. ``TorchLM`` scores the
same requests as ``JaxLM`` on the same packed 2-bit model (random codes,
real RHT rotations, carried across by a quip_tpu checkpoint): |Δll| ≤
1e-4 nats a request (f32 forwards that round in another order; a request
sums at most 128 token log-probs) and the same greedy flags;
``simple_evaluate`` gives the same accuracies and, within 1e-4 relative,
the same perplexities; ``greedy_until`` generates the same strings. The
CLIs run offline: ``cli/zeroshot`` on the checkpoint prints quip_tpu's
results, ``cli/accept`` runs its matrix and its baseline gate.
"""
import json
import math
import random

import numpy as np
import pytest
import torch

from quip_tpu.cli import zeroshot as jzcli
from quip_tpu.eval.zeroshot import base as JB
from quip_tpu.eval.zeroshot import evaluator as JEV
from quip_tpu.eval.zeroshot import lm as JLM
from quip_tpu.eval.zeroshot import metrics as JMET
from quip_tpu.eval.zeroshot import registry as JREG
from quip_tpu.eval.zeroshot import synthetic_docs as JSD
from quip_tpu.eval.zeroshot import tasks as JT
from quip_tpu.models import get_config as jget_config
from quip_tpu.pack import model as JPM
from quip_tpu_torch.cli import accept as acli
from quip_tpu_torch.cli import zeroshot as zcli
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.eval import zeroshot as TZ
from quip_tpu_torch.eval.zeroshot import base as TB
from quip_tpu_torch.eval.zeroshot import evaluator as TEV
from quip_tpu_torch.eval.zeroshot import lm as TLM
from quip_tpu_torch.eval.zeroshot import metrics as TMET
from quip_tpu_torch.eval.zeroshot import registry as TREG
from quip_tpu_torch.eval.zeroshot import synthetic_docs as TSD
from quip_tpu_torch.eval.zeroshot import tasks as TT
from quip_tpu_torch.models import get_config
from quip_tpu_torch.pack import model as TPM
from tests.test_torch_model import _jax_packed_llama

LL_ATOL = 1e-4
PPL_RTOL = 1e-4


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """One JaxLM and one TorchLM over the same packed llama-tiny, and the
    checkpoint directory the port read it from."""
    jcfg = jget_config("llama-tiny")
    jp = _jax_packed_llama(jcfg, seed=5)
    path = str(tmp_path_factory.mktemp("zs_ckpt"))
    JPM.save_checkpoint(path, jp, {"model": "llama-tiny", "wbits": 2})
    tcfg = get_config("llama-tiny")
    tp = params_from_numpy(TPM.load_checkpoint(path)[0], tcfg, device="cpu")
    jlm = JLM.JaxLM(jp, jcfg, JLM.ByteTokenizer(jcfg.vocab_size))
    tlm = TLM.TorchLM(tp, tcfg, TLM.ByteTokenizer(tcfg.vocab_size))
    return jlm, tlm, path


@pytest.fixture(autouse=True)
def _hf_offline(monkeypatch):
    """quip_tpu's tokenizer loader probes the hub's DNS name after a local
    miss unless told not to."""
    monkeypatch.setenv("QUIP_TPU_HF_ONLINE", "0")


# ---------------------------------------------------------------------------
# the copied modules: equal
# ---------------------------------------------------------------------------


def test_registry_matches():
    assert TREG.ALL_TASKS == JREG.ALL_TASKS
    assert TREG.PAPER_SUITE == JREG.PAPER_SUITE
    assert ({k: v.__name__ for k, v in TREG.TASK_REGISTRY.items()}
            == {k: v.__name__ for k, v in JREG.TASK_REGISTRY.items()})
    assert TZ.TASK_REGISTRY is TREG.TASK_REGISTRY
    assert TREG.get_task("piqa") is TT.PiQA
    with pytest.raises(KeyError, match="missing task"):
        TREG.get_task("nope")
    assert zcli.pattern_match(["arc_*", "pi*", "x"], TREG.ALL_TASKS) == \
        jzcli.pattern_match(["arc_*", "pi*", "x"], JREG.ALL_TASKS) == \
        ["arc_challenge", "arc_easy", "piqa"]


@pytest.mark.parametrize("task", JREG.ALL_TASKS)
def test_synthetic_docs_match(task):
    assert TSD.synthetic_docs(task, 6, seed=3) == \
        JSD.synthetic_docs(task, 6, seed=3)


def _requests(reg, sd, task):
    """Every doc's context and requests (type, args, index) for ``task``
    over its synthetic docs, as the evaluator builds them."""
    t = reg.get_task_dict([task], datasets=sd.synthetic_datasets([task], 5))[
        task]
    docs = list(t.test_docs() if t.has_test_docs() else t.validation_docs())
    rnd = random.Random(42)
    out = []
    for doc in docs:
        ctx = t.fewshot_context(doc, num_fewshot=0, rnd=rnd)
        reqs = t.construct_requests(doc, ctx)
        if not isinstance(reqs, (list, tuple)):
            reqs = [reqs]
        out.append((ctx, t.doc_to_target(doc),
                    [(r.request_type, r.args, r.index) for r in reqs]))
    return out


@pytest.mark.parametrize("task", JREG.ALL_TASKS)
def test_construct_requests_match(task):
    assert _requests(TREG, TSD, task) == _requests(JREG, JSD, task)


def test_base_helpers_match():
    s = 'He said " hello ( world ) " and did n\'t , stop .'
    assert TB.general_detokenize(s) == JB.general_detokenize(s)
    assert [TB.yesno(x) for x in (0, 1)] == [JB.yesno(x) for x in (0, 1)]
    req = TB.rf.loglikelihood("a", "b")
    assert [(r.request_type, r.args, r.index) for r in req] == \
        [(r.request_type, r.args, r.index)
         for r in JB.rf.loglikelihood("a", "b")]
    with pytest.raises(NotImplementedError):
        TB.Request("nope", ())


def test_metrics_match():
    rng = np.random.default_rng(0)
    xs = rng.random(9).tolist()
    pairs = [(float(a), float(b)) for a, b in zip(-rng.random(7) * 5,
                                                  rng.integers(1, 9, 7))]
    pg = list(zip(rng.integers(0, 2, 12).tolist(),
                  rng.integers(0, 2, 12).tolist()))
    pg3 = list(zip(rng.integers(0, 3, 12).tolist(),
                   rng.integers(0, 3, 12).tolist()))
    docs = [(bool(p), {"idx": {"paragraph": i // 4, "question": i // 2},
                       "label": g}) for i, (p, g) in enumerate(pg)]
    for name, arg in [("mean", xs), ("pop_stddev", xs),
                      ("sample_stddev", xs), ("mean_stderr", xs),
                      ("median", xs), ("perplexity", xs),
                      ("weighted_mean", pairs),
                      ("weighted_perplexity", pairs),
                      ("bits_per_byte", pairs), ("f1_score", pg),
                      ("f1_multiclass", pg3), ("matthews_corrcoef", pg),
                      ("acc_all", docs)]:
        assert getattr(TMET, name)(arg) == getattr(JMET, name)(arg), name
    for a, b in [("The cat sat.", "the cat  sat"), ("a b c", "b c d"),
                 ("", "x")]:
        assert TMET.squad_em(a, b) == JMET.squad_em(a, b)
        assert TMET.squad_f1(a, b) == JMET.squad_f1(a, b)
    assert TMET.metric_max_over_ground_truths(TMET.squad_f1, "a b",
                                              ["b", "a b"]) == 1.0
    assert TMET.bootstrap_stderr(TMET.mean, xs, 200) == \
        JMET.bootstrap_stderr(JMET.mean, xs, 200)
    for t, j in [(TMET.mean, JMET.mean), (TMET.f1_score, JMET.f1_score),
                 (TMET.acc_all, JMET.acc_all)]:
        ts, js = (TMET.stderr_for_metric(t, 50),
                  JMET.stderr_for_metric(j, 50))
        assert (ts is None) == (js is None)
        arg = docs if t is TMET.acc_all else pg if t is TMET.f1_score else xs
        if ts is not None:
            assert ts(arg) == js(arg)
    assert TMET.stderr_for_metric(TMET.mean, 0) is None


def _write_lambada(tmp_path):
    docs = ["The river ran past the old mill and into the sea",
            "She opened the “door” and ‘smiled’ at the quiet garden",
            "Numbers like 42 end this line"]
    path = tmp_path / "lambada_test.jsonl"
    path.write_text("".join(json.dumps({"text": d}) + "\n\n" for d in docs))
    return docs, path


def test_lambada_jsonl_loader(tmp_path):
    docs, path = _write_lambada(tmp_path)
    for arg in (str(tmp_path), str(path)):
        t, j = TT.LAMBADA(data_dir=arg), JT.LAMBADA(data_dir=arg)
        assert t.dataset == j.dataset == {"test": [{"text": d}
                                                   for d in docs]}
        got = [(t.doc_to_text(d), t.doc_to_target(d))
               for d in t.validation_docs()]
        assert got == [(j.doc_to_text(d), j.doc_to_target(d))
                       for d in j.validation_docs()]
        assert got[1][0].startswith('She opened the "door"')
    with pytest.raises(FileNotFoundError):
        TT.LAMBADA(data_dir=str(tmp_path / "none"))


def test_storycloze_csv_loader(tmp_path):
    head = ("InputStoryid,InputSentence1,InputSentence2,InputSentence3,"
            "InputSentence4,RandomFifthSentenceQuiz1,"
            "RandomFifthSentenceQuiz2,AnswerRightEnding\n")
    rows = ["s1,A went out.,It rained.,A got wet.,A went home.,A was dry.,"
            "A was cold.,2\n",
            "s2,B sang.,People came.,They clapped.,B bowed.,B smiled.,"
            "B cried.,1\n"]
    (tmp_path / "cloze_val.csv").write_text(head + rows[0])
    (tmp_path / "cloze_test.csv").write_text(head + rows[1])
    t, j = TT.StoryCloze(data_dir=str(tmp_path)), JT.StoryCloze(
        data_dir=str(tmp_path))
    assert t.dataset == j.dataset
    assert t.dataset["validation"][0]["answer_right_ending"] == 2
    doc = t.validation_docs()[0]
    assert t.doc_to_target(doc) == " A was cold."
    assert [r.args for r in t.construct_requests(doc, "c")] == \
        [r.args for r in j.construct_requests(doc, "c")]


def test_rolling_windows_and_buckets_match():
    toks = list(range(1, 40))
    for ml, cl in [(8, 1), (8, 3), (39, 1), (50, 1)]:
        want = list(JLM.get_rolling_token_windows(toks, 0, ml, cl))
        assert list(TLM.get_rolling_token_windows(toks, 0, ml, cl)) == want
        assert [TLM.make_disjoint_window(p) for p in want] == \
            [JLM.make_disjoint_window(p) for p in want]
    assert [TLM._bucket_len(n) for n in (1, 32, 33, 100, 129)] == \
        [JLM._bucket_len(n) for n in (1, 32, 33, 100, 129)] == \
        [32, 32, 64, 128, 256]
    tok = TLM.ByteTokenizer(512)
    assert tok.encode("hé!") == JLM.ByteTokenizer(512).encode("hé!")
    assert tok.decode(tok.encode("hé!")) == "hé!"
    r = TLM.Reorderer([3, 1, 2], lambda x: -x)
    assert r.get_reordered() == [3, 2, 1]
    assert r.get_original(["c", "b", "a"]) == ["c", "a", "b"]


def test_hf_tokenizer_stays_local():
    """No tokenizer for this name in the local cache: the loader raises
    (it never goes to the network), and the CLI's fallback is the byte
    tokenizer."""
    with pytest.raises(Exception):
        TLM.load_hf_tokenizer("llama-tiny")


# ---------------------------------------------------------------------------
# TorchLM against JaxLM
# ---------------------------------------------------------------------------


def _greedy_tokens(tlm, ctx, n):
    """n tokens the port's model picks greedily after ``ctx``."""
    toks = list(ctx)
    for _ in range(n):
        with torch.no_grad():
            lg = tlm.params(torch.tensor([toks]))
        toks.append(int(lg[0, -1].argmax()))
    return toks[len(ctx):]


def test_loglikelihood_tokens_match(lms):
    """Token-level requests across the 32/64/128 buckets, one left-truncated
    past max_length + 1, and two greedy continuations."""
    jlm, tlm, _ = lms
    rng = np.random.default_rng(7)
    seq = lambda n: rng.integers(1, 512, n).tolist()  # noqa: E731
    ctx = seq(20)
    ctx2 = seq(70)
    reqs = [(None, ctx, _greedy_tokens(tlm, ctx, 3)),
            (None, ctx2, _greedy_tokens(tlm, ctx2, 1)),
            (None, [0], seq(5)), (None, seq(3), seq(1)),
            (None, seq(40), seq(9)), (None, seq(100), seq(20)),
            (None, seq(200), seq(30)), (None, seq(12), seq(116))]
    want = jlm._loglikelihood_tokens(reqs)
    got = tlm._loglikelihood_tokens(reqs)
    assert [g for _, g in got] == [g for _, g in want]
    assert [g for _, g in got][:2] == [True, True]
    assert not any(g for _, g in got[2:])
    np.testing.assert_allclose([ll for ll, _ in got],
                               [ll for ll, _ in want], rtol=0, atol=LL_ATOL)
    assert all(isinstance(ll, float) and isinstance(g, bool)
               for ll, g in got)


def test_loglikelihood_and_rolling_match(lms):
    jlm, tlm, _ = lms
    reqs = [("", "hello"), ("The quick brown fox", " jumps"),
            ("Question: what is two and two?\nAnswer:", " four"),
            ("x" * 150, " over the lazy dog")]
    want, got = jlm.loglikelihood(reqs), tlm.loglikelihood(reqs)
    assert [g for _, g in got] == [g for _, g in want]
    np.testing.assert_allclose([ll for ll, _ in got],
                               [ll for ll, _ in want], rtol=0, atol=LL_ATOL)
    docs = [("A short document.",),
            ("a longer one " * 25,)]            # three rolling windows
    want = jlm.loglikelihood_rolling(docs)
    got = tlm.loglikelihood_rolling(docs)
    np.testing.assert_allclose(got, want, rtol=0, atol=3 * LL_ATOL)


def test_simple_evaluate_matches(lms):
    jlm, tlm, _ = lms
    names = ["synthetic", "piqa", "lambada"]
    want = JEV.simple_evaluate(
        jlm, JREG.get_task_dict(names, datasets=JSD.synthetic_datasets(
            names, 4)), limit=4, bootstrap_iters=100)
    got = TEV.simple_evaluate(
        tlm, TREG.get_task_dict(names, datasets=TSD.synthetic_datasets(
            names, 4)), limit=4, bootstrap_iters=100)
    assert got["config"] == want["config"]
    assert got["versions"] == want["versions"]
    assert set(got["results"]) == set(names)
    for task, res in want["results"].items():
        assert set(got["results"][task]) == set(res), task
        for metric, v in res.items():
            g = got["results"][task][metric]
            if task == "lambada" and metric.startswith("ppl"):
                assert math.isclose(g, v, rel_tol=PPL_RTOL), (metric, g, v)
            else:
                assert g == v, (task, metric, g, v)


def test_greedy_until_matches(lms):
    jlm, tlm, _ = lms
    reqs = [("Once upon a time", ["\n"]), ("abc", "zz"),
            ("The capital of", ["."])]
    want = jlm.greedy_until(reqs, max_gen_toks=8)
    got = tlm.greedy_until(reqs, max_gen_toks=8)
    assert got == want
    eng = tlm._gen_engine_cached
    assert tlm._gen_engine(16) is eng            # a smaller bucket reuses it
    assert tlm._gen_engine(eng.max_seq * 2) is not eng


# ---------------------------------------------------------------------------
# the CLIs, offline
# ---------------------------------------------------------------------------


def test_zeroshot_cli_matches_quip_tpu(lms, tmp_path, capsys):
    _, _, path = lms
    args = ["llama-tiny", "--load", path, "--tasks", "synth*,piqa",
            "--synthetic_docs", "--limit", "4"]
    jzcli.main(args + ["--no_compile_cache"])
    jout = capsys.readouterr().out
    out_path = tmp_path / "zs.json"
    got = zcli.main(args + ["--device", "cpu", "--output_path",
                            str(out_path), "--table_results"])
    out = capsys.readouterr().out
    assert "WARNING: HF tokenizer unavailable; using byte fallback" in out
    assert "Selected Tasks: ['piqa', 'synthetic']" in out
    assert json.loads(out_path.read_text()) == got
    assert TEV.make_table(got) in out
    want, _ = json.JSONDecoder().raw_decode(jout, jout.index("\n{\n") + 1)
    assert got == want


def test_zeroshot_cli_quantizes_in_place(capsys):
    got = zcli.main(["llama-tiny", "synthetic", "--wbits", "2", "--quant",
                     "ldlq", "--incoh_processing", "--nsamples", "4",
                     "--seqlen", "32", "--tasks", "synthetic",
                     "--synthetic_docs", "--limit", "2", "--device", "cpu"])
    assert "quantizing in place: ldlq w2" in capsys.readouterr().out
    assert 0 <= got["results"]["synthetic"]["acc"] <= 1


ARGS_TINY = ["llama-tiny", "synthetic", "--nsamples", "8", "--seqlen", "64",
             "--device", "cpu"]


def test_accept_smoke(tmp_path):
    """The whole matrix (16-bit and 2-bit, ppl and zero-shot) offline, with
    a pass/fail report of recorded values (tests/test_cli.py's smoke)."""
    out_path = str(tmp_path / "report.json")
    with pytest.raises(SystemExit) as e:
        acli.main(ARGS_TINY + [
            "--bits", "16,2", "--tasks", "synthetic", "--limit", "4",
            "--bootstrap_iters", "0", "--output", out_path,
            "--baseline", "BASELINE.json"])
    assert e.value.code == 0
    with open(out_path) as f:
        report = json.load(f)
    assert report["pass"] is True
    assert np.isfinite(report["results"]["ppl"]["16"])
    assert np.isfinite(report["results"]["ppl"]["2"])
    assert "synthetic" in report["results"]["zeroshot"]["2"]
    statuses = {c["status"] for c in report["checks"]}
    assert "no_baseline" in statuses and report["n_baseline_checks"] == 0


def test_accept_baseline_gate(tmp_path):
    """With published numbers the ppl-delta gate gates: an impossible
    baseline (delta 0 allowed) fails the run."""
    baseline = {"published": {"llama-tiny": {
        "ppl": {"synthetic": {"16": 1.0, "2": 1.0}}}}}
    bpath = str(tmp_path / "baseline.json")
    with open(bpath, "w") as f:
        json.dump(baseline, f)
    out_path = str(tmp_path / "report.json")
    with pytest.raises(SystemExit) as e:
        acli.main(ARGS_TINY + [
            "--bits", "16,2", "--tasks", "", "--baseline", bpath,
            "--tol_ppl", "0.0", "--output", out_path])
    assert e.value.code == 1
    with open(out_path) as f:
        checks = {c["check"]: c for c in json.load(f)["checks"]}
    assert checks["ppl_delta_w2"]["status"] == "vs_baseline"
    assert checks["ppl_delta_w2"]["pass"] is False
    # --host_offload quantizes with the model in host memory: the same
    # failing gate
    with pytest.raises(SystemExit) as e:
        acli.main(ARGS_TINY + [
            "--bits", "16,2", "--tasks", "", "--baseline", bpath,
            "--tol_ppl", "0.0", "--host_offload"])
    assert e.value.code == 1
