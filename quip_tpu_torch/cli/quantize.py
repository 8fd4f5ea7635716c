"""Quantize CLI (port of ``quip_tpu/cli/quantize.py``; reference
``python opt.py <model> <dataset> ...``, opt.py:485-656).

Example (a full-width random Llama-2-7B on the card):
  python -m quip_tpu_torch.cli.quantize llama-2-7b synthetic \\
      --weights random --wbits 2 --quant ldlq --incoh_processing --fuse \\
      --quant_head --packed --save DIR

The checkpoint is quip_tpu's format (pack/model.py); either package reads
it. ``--eval`` scores the dense quantized model's perplexity on the test
stream afterwards. ``--dp``, ``--trace``, ``--host_offload`` and
``--resume_dir`` are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from quip_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("quip_tpu_torch.quantize")
    common.add_model_args(p)
    common.add_data_args(p)
    common.add_quant_args(p)
    p.add_argument("--save", type=str, default=None,
                   help="checkpoint dir to write")
    p.add_argument("--packed", action="store_true",
                   help="save packed int codes instead of dequantized dense")
    p.add_argument("--eval", action="store_true",
                   help="run perplexity after quantizing (opt.py:648-656)")
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--proxy_only", action="store_true",
                   help="report proxy losses only, skip final eval")
    p.add_argument("--fuse", action="store_true",
                   help="fuse qkv (and gate+up) before quantizing: one "
                        "rotation + one packed matmul per group")
    p.add_argument("--host_offload", action="store_true",
                   help="(not ported yet)")
    p.add_argument("--dp", type=int, default=1, help="(not ported yet)")
    p.add_argument("--trace", type=str, default=None,
                   help="(not ported yet)")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="(not ported yet)")
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    """Refuse flag combinations without a packed form, and the flags
    whose code is not ported yet."""
    if args.packed and args.groupsize > 0:
        p.error("--packed requires per-row grids; --groupsize produces "
                "per-group scales with no packed representation. Drop one "
                "of the two flags.")
    waiting = {"--dp": args.dp > 1, "--trace": args.trace,
               "--host_offload": args.host_offload,
               "--resume_dir": args.resume_dir}
    asked = [flag for flag, on in waiting.items() if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported yet (ROADMAP queue 1 item 8 "
            f"for --host_offload/--resume_dir, item 9 for --dp and "
            f"--trace)")


def main(argv=None):
    """Quantize as the flags say; returns (the dense quantized Model, the
    driver's artifacts)."""
    p = build_parser()
    args = p.parse_args(argv)
    check_args(p, args)

    params, cfg = common.load_model(args)
    if args.fuse:
        from quip_tpu_torch.models import model as M
        params = M.fuse_params(params, cfg)
    (calib, test_stream), seqlen = common.get_data(args, cfg)
    qcfg = common.quant_config_from_args(args)

    from quip_tpu_torch.quantize.driver import quantize_model
    t0 = time.time()
    newp, art = quantize_model(params, cfg, torch.from_numpy(calib), qcfg,
                               seed=args.seed, chunk=args.chunk,
                               progress=True, quant_head=args.quant_head)
    print(f"Total quant time: {time.time() - t0:.2f}s")
    print(f"Total proxy error: {art.total_error:.4f}")

    if args.save:
        from quip_tpu_torch.pack.model import (pack_quantized_model,
                                               save_checkpoint)
        to_save = newp
        if args.packed and args.wbits < 16:
            to_save = pack_quantized_model(newp, cfg, art, args.wbits)
        save_checkpoint(args.save, to_save, {
            "model": args.model, "wbits": args.wbits, "quant": args.quant,
            "packed": bool(args.packed), "seqlen": seqlen,
        })
        print(f"saved checkpoint to {args.save}")

    if args.eval and not args.proxy_only:
        from quip_tpu_torch.eval.ppl import perplexity
        ppl = perplexity(newp, cfg, test_stream, seqlen)
        print(json.dumps({"dataset": args.dataset, "ppl": ppl}))
    return newp, art


if __name__ == "__main__":
    main()
