"""Turnkey acceptance harness: the whole BASELINE quality matrix, one command
(port of ``quip_tpu/cli/accept.py``: the same checks, statuses, report and
exit code).

    python -m quip_tpu_torch.cli.accept <model> <dataset> --weights DIR \
        --data_dir DIR --bits 16,4,2 --tasks arc_easy,lambada,piqa,storycloze

Per bit-width it runs LDLQ + incoherence quantization (the reference's
`--wbits {2,4} --quant ldlq --incoh_processing` recipe, opt.py:592-597),
perplexity eval (opt.py:648-656 semantics via eval/ppl.py) and the paper's
zero-shot suite (zeroShot/evaluator.py:76-211), then diffs the
quantized-vs-fp16 deltas against `BASELINE.json` tolerances and emits ONE
pass/fail JSON report.

Everything is wired against synthetic data (`synthetic --tasks synthetic
--weights random` runs the full matrix with zero egress, smoke-tested in
tests/test_torch_zeroshot.py); once real weights and datasets are in the
repository the same command produces the parity report (``--weights``
takes a local Hugging Face directory). ``--host_offload`` keeps the model
in host memory while it is quantized (one block at a time on the device).

Baseline schema (BASELINE.json "published" — empty until the reference
numbers are regenerated, BASELINE.md):

    "published": {
      "<model>": {
        "ppl":      {"<dataset>": {"16": 27.65, "4": 27.8, "2": 30.9}},
        "zeroshot": {"arc_easy":  {"16": 0.65, "2": 0.58}, ...}
      }
    }

Checks (per quantized width b, fp16 always measured in-run):
  * ppl finite and > 0 (always);
  * with a published entry: measured ppl delta vs fp16 must not exceed the
    published delta by more than --tol_ppl (relative, default 10%);
  * zero-shot acc >= published acc - --tol_acc (absolute, default 0.02);
  * without a published entry the value is recorded with status
    "no_baseline" (informative, does not fail the run).
"""
from __future__ import annotations

import argparse
import copy
import json
import math

import torch

from quip_tpu_torch.cli import common


def _eval_ppl(params, cfg, test_stream, seqlen, batch):
    from quip_tpu_torch.eval.ppl import perplexity
    return float(perplexity(params, cfg, test_stream, seqlen, batch=batch))


def _eval_zeroshot(params, cfg, args, task_names):
    from quip_tpu_torch.eval.zeroshot import simple_evaluate
    from quip_tpu_torch.eval.zeroshot.lm import (ByteTokenizer, TorchLM,
                                                 load_hf_tokenizer)
    from quip_tpu_torch.eval.zeroshot.registry import get_task_dict

    try:
        tokenizer = load_hf_tokenizer(args.model)
    except Exception:
        tokenizer = ByteTokenizer(cfg.vocab_size)
    lm = TorchLM(params, cfg, tokenizer, batch_size=args.batch_size)
    datasets = None
    if getattr(args, "synthetic_docs", False):
        # offline drill: every task's REAL prompt/request/metric pipeline
        # over schema-faithful synthetic docs (zero egress)
        from quip_tpu_torch.eval.zeroshot.synthetic_docs import \
            synthetic_datasets
        datasets = synthetic_datasets(task_names,
                                      n=args.limit or 8, seed=0)
    tasks = get_task_dict(task_names, datasets=datasets,
                          data_dir=args.data_dir)
    out = simple_evaluate(lm, tasks, limit=args.limit,
                          bootstrap_iters=args.bootstrap_iters)
    acc = {}
    for name, res in out["results"].items():
        # prefer acc; fall back to acc_norm or any scalar metric
        for k in ("acc", "acc_norm"):
            if k in res:
                acc[name] = float(res[k])
                break
        else:
            scalars = {k: v for k, v in res.items()
                       if isinstance(v, (int, float))}
            if scalars:
                acc[name] = float(next(iter(scalars.values())))
    return acc


def run_matrix(args) -> dict:
    """Execute the acceptance matrix; returns the report dict."""
    from quip_tpu_torch.quantize.config import QuantConfig
    from quip_tpu_torch.quantize.driver import quantize_model

    offload = bool(getattr(args, "host_offload", False))
    bits_list = [int(b) for b in str(args.bits).split(",") if b]
    task_names = [t for t in args.tasks.split(",") if t]

    with open(args.baseline) as f:
        published = json.load(f).get("published", {}) or {}
    pub = published.get(args.model, {})

    # --host_offload: the model lives in host memory; the quantizer moves
    # one block at a time to --device, and each evaluation gets a copy there
    params0, cfg = common.load_model(args, on_host=offload)
    (calib, test_stream), seqlen = common.get_data(args, cfg)

    results: dict = {"model": args.model, "dataset": args.dataset,
                     "seqlen": seqlen, "ppl": {}, "zeroshot": {}}
    for b in bits_list:
        if b >= 16:
            params = params0
        else:
            qcfg = QuantConfig.incoherence(b, method=args.quant,
                                           npasses=args.npasses)
            print(f"# quantizing w{b}: {qcfg.method} + incoherence",
                  flush=True)
            params, _ = quantize_model(
                params0, cfg, torch.from_numpy(calib), qcfg, seed=args.seed,
                progress=True, host_offload=offload,
                quant_head=args.quant_head, device=args.device)
        if offload:
            params = copy.deepcopy(params).to(args.device)
        key = str(b)
        results["ppl"][key] = _eval_ppl(params, cfg, test_stream, seqlen,
                                        args.batch)
        print(f"# w{b} ppl[{args.dataset}] = {results['ppl'][key]:.4f}",
              flush=True)
        if task_names:
            results["zeroshot"][key] = _eval_zeroshot(params, cfg, args,
                                                      task_names)
            print(f"# w{b} zeroshot = {results['zeroshot'][key]}",
                  flush=True)
        del params

    # ---- checks ------------------------------------------------------
    checks = []

    def check(name, ok, status, **info):
        checks.append({"check": name, "pass": bool(ok), "status": status,
                       **info})

    fp16_ppl = results["ppl"].get("16")
    pub_ppl = (pub.get("ppl", {}) or {}).get(args.dataset, {})
    for b in bits_list:
        key = str(b)
        v = results["ppl"][key]
        check(f"ppl_w{b}_finite", math.isfinite(v) and v > 0, "measured",
              value=v)
        if b >= 16 or fp16_ppl is None:
            continue
        delta = v - fp16_ppl
        if key in pub_ppl and "16" in pub_ppl:
            allowed = ((pub_ppl[key] - pub_ppl["16"])
                       * (1.0 + args.tol_ppl) + 1e-9)
            check(f"ppl_delta_w{b}", delta <= allowed, "vs_baseline",
                  delta=delta, allowed=allowed)
        else:
            check(f"ppl_delta_w{b}", True, "no_baseline", delta=delta)
    pub_zs = pub.get("zeroshot", {}) or {}
    for b in bits_list:
        for task, acc in results["zeroshot"].get(str(b), {}).items():
            base = (pub_zs.get(task, {}) or {}).get(str(b))
            if base is not None:
                check(f"zeroshot_{task}_w{b}", acc >= base - args.tol_acc,
                      "vs_baseline", acc=acc, baseline=base)
            else:
                check(f"zeroshot_{task}_w{b}", True, "no_baseline", acc=acc)

    return {"pass": all(c["pass"] for c in checks),
            "n_baseline_checks": sum(c["status"] == "vs_baseline"
                                     for c in checks),
            "checks": checks, "results": results}


def main(argv=None):
    p = argparse.ArgumentParser("quip_tpu_torch.accept")
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--bits", type=str, default="16,4,2",
                   help="comma list; 16 = fp baseline (always measure it "
                        "for the deltas)")
    p.add_argument("--quant", type=str, default="ldlq")
    p.add_argument("--npasses", type=int, default=0)
    p.add_argument("--quant_head", action="store_true")
    p.add_argument("--host_offload", action="store_true",
                   help="keep the model in host memory while quantizing")
    p.add_argument("--tasks", type=str,
                   default="arc_easy,lambada,piqa,storycloze",
                   help="zero-shot suite ('' skips zero-shot)")
    p.add_argument("--synthetic_docs", action="store_true",
                   help="run every task over schema-faithful synthetic "
                        "docs (offline drill of the real prompt/metric "
                        "pipelines; chance-level accuracies)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="local dataset dir (lambada jsonl, storycloze CSVs)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--bootstrap_iters", type=int, default=1000)
    p.add_argument("--baseline", type=str, default="BASELINE.json")
    p.add_argument("--tol_ppl", type=float, default=0.10,
                   help="relative slack on the published ppl delta")
    p.add_argument("--tol_acc", type=float, default=0.02,
                   help="absolute slack on published zero-shot accuracy")
    p.add_argument("--output", type=str, default=None)
    args = p.parse_args(argv)

    report = run_matrix(args)
    dumped = json.dumps(report, indent=2)
    print(dumped)
    if args.output:
        with open(args.output, "w") as f:
            f.write(dumped)
    raise SystemExit(0 if report["pass"] else 1)


if __name__ == "__main__":
    main()
