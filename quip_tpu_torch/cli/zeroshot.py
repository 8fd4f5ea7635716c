"""Zero-shot eval CLI (port of ``quip_tpu/cli/zeroshot.py``; reference
``python zeroShot/main.py ...``, zeroShot/main.py:9-42, utils.py:53-99).

Example (a checkpoint on the card, offline synthetic docs):
  python -m quip_tpu_torch.cli.zeroshot llama-2-7b --load DIR \\
      --tasks synthetic,piqa,arc_easy --synthetic_docs --limit 8

Without a tokenizer in the local Hugging Face cache it falls back to the
byte tokenizer, with quip_tpu's warning.
"""
from __future__ import annotations

import argparse
import fnmatch
import json

import torch

from quip_tpu_torch.cli import common


def pattern_match(patterns, source_list):
    """zeroShot/main.py task-name globbing."""
    names = set()
    for pattern in patterns:
        for matching in fnmatch.filter(source_list, pattern):
            names.add(matching)
    return sorted(names)


def build_parser() -> argparse.ArgumentParser:
    from quip_tpu_torch.eval.zeroshot.registry import ALL_TASKS

    p = argparse.ArgumentParser("quip_tpu_torch.zeroshot")
    common.add_model_args(p)
    common.add_data_args(p)
    common.add_quant_args(p)
    p.add_argument("--tasks", type=str, default="arc_easy",
                   help="comma list / globs over: " + ",".join(ALL_TASKS))
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--num_fewshot", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--table_results", action="store_true")
    p.add_argument("--data_dir", type=str, default=None,
                   help="local dataset dir for offline tasks (lambada "
                        "jsonl, storycloze CSVs)")
    p.add_argument("--kv_quant", action="store_true",
                   help="int8 KV caches in the generation engine; "
                        "loglikelihood tasks are cache-free and unaffected")
    p.add_argument("--synthetic_docs", action="store_true",
                   help="schema-faithful synthetic docs for every task "
                        "(offline pipeline drill; chance accuracies)")
    return p


def make_lm(params, cfg, args):
    """A TorchLM with the model's Hugging Face tokenizer from the local
    cache, else the byte tokenizer."""
    from quip_tpu_torch.eval.zeroshot.lm import (ByteTokenizer, TorchLM,
                                                 load_hf_tokenizer)
    try:
        tokenizer = load_hf_tokenizer(args.model)
    except Exception:
        print("WARNING: HF tokenizer unavailable; using byte fallback")
        tokenizer = ByteTokenizer(cfg.vocab_size)
    return TorchLM(params, cfg, tokenizer, batch_size=args.batch_size,
                   kv_quant=args.kv_quant)


def main(argv=None) -> dict:
    from quip_tpu_torch.eval.zeroshot import (get_task_dict, make_table,
                                              simple_evaluate)
    from quip_tpu_torch.eval.zeroshot.registry import ALL_TASKS

    args = build_parser().parse_args(argv)
    task_names = pattern_match(args.tasks.split(","), ALL_TASKS)
    print(f"Selected Tasks: {task_names}")

    if args.load:
        params, cfg, meta = common.load_checkpoint_model(args)
        print(f"loaded {meta}")
    else:
        params, cfg = common.load_model(args)
        if args.wbits < 16:
            # quantize in place before eval (zeroShot/evaluator.py:42-53)
            from quip_tpu_torch.quantize.driver import quantize_model
            (calib, _), _ = common.get_data(args, cfg)
            qcfg = common.quant_config_from_args(args)
            print(f"quantizing in place: {qcfg.method} w{qcfg.wbits}")
            params, _ = quantize_model(params, cfg, torch.from_numpy(calib),
                                       qcfg, seed=args.seed, progress=True,
                                       quant_head=args.quant_head)

    lm = make_lm(params, cfg, args)
    datasets = None
    if args.synthetic_docs:
        from quip_tpu_torch.eval.zeroshot.synthetic_docs import \
            synthetic_datasets
        datasets = synthetic_datasets(task_names, n=args.limit or 8)
    tasks = get_task_dict(task_names, datasets=datasets,
                          data_dir=args.data_dir)
    results = simple_evaluate(lm, tasks, num_fewshot=args.num_fewshot,
                              limit=args.limit)
    dumped = json.dumps(results, indent=2)
    print(dumped)
    if args.output_path:
        with open(args.output_path, "w") as f:
            f.write(dumped)
    if args.table_results:
        print(make_table(results))
    return results


if __name__ == "__main__":
    main()
