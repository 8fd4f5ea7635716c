"""Perplexity-eval CLI (port of ``quip_tpu/cli/eval.py``; reference
opt_eval / llama_eval invocation, opt.py:648-656).

Example (the checkpoint the quantize CLI wrote, on the card):
  python -m quip_tpu_torch.cli.eval llama-2-7b synthetic --load DIR

Without ``--load`` it scores the random model of ``--weights random
--seed``. Prints ``{"dataset": ..., "ppl": ...}``.
"""
from __future__ import annotations

import argparse
import json

from quip_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("quip_tpu_torch.eval")
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--load", type=str, default=None,
                   help="checkpoint dir saved by either package's quantize "
                        "CLI")
    p.add_argument("--batch", type=int, default=1)
    return p


def load(args):
    """(Model, cfg): the ``--load`` checkpoint, else the random model."""
    if args.load:
        params, cfg, meta = common.load_checkpoint_model(args)
        print(f"loaded {meta}")
        return params, cfg
    return common.load_model(args)


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    params, cfg = load(args)
    (_, test_stream), seqlen = common.get_data(args, cfg)

    from quip_tpu_torch.eval.ppl import perplexity
    ppl = perplexity(params, cfg, test_stream, seqlen, batch=args.batch)
    print(json.dumps({"dataset": args.dataset, "ppl": ppl}))
    return ppl


if __name__ == "__main__":
    main()
