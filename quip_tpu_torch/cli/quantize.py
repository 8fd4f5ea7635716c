"""Quantize CLI (port of ``quip_tpu/cli/quantize.py``; reference
``python opt.py <model> <dataset> ...``, opt.py:485-656).

Example (a full-width random Llama-2-7B on the card):
  python -m quip_tpu_torch.cli.quantize llama-2-7b synthetic \\
      --weights random --wbits 2 --quant ldlq --incoh_processing --fuse \\
      --quant_head --packed --save DIR

The checkpoint is quip_tpu's format (pack/model.py); either package reads
it. ``--eval`` scores the dense quantized model's perplexity on the test
stream afterwards. ``--resume_dir`` resumes per layer (quip_tpu's
``layer_{i}.npz`` files), ``--host_offload`` builds the model in host
memory and moves one block at a time to ``--device``, ``--trace DIR``
writes a torch.profiler trace of the quantization.

``--dp N`` calibrates data-parallel on N ranks (quip_tpu's checks:
``--nsamples`` divisible by N and ``--chunk`` equal to ``--nsamples``):
each rank runs the calibration forward on its contiguous share of the
windows, the Hessian sums are all-reduced (quantize/driver.py), every
rank solves from the same seed, and rank 0 alone prints and saves. The
command starts the N ranks itself (this process is rank 0), or joins the
group when launched by ``python -m torch.distributed.run
--nproc_per_node N``. Ranks sharing one card, or on the CPU, talk over
gloo (parallel/mesh.py).
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
                   help="keep the blocks in host memory, one block on the "
                        "device at a time (the reference's CPU<->GPU block "
                        "streaming, opt.py:94-181)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel calibration over this many ranks")
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler trace of the quantization "
                        "run to this directory (utils/profiling.trace)")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="per-layer resume directory")
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    """Refuse flag combinations without a packed form, and quip_tpu's two
    ``--dp`` checks (before any model load)."""
    if args.packed and args.groupsize > 0:
        p.error("--packed requires per-row grids; --groupsize produces "
                "per-group scales with no packed representation. Drop one "
                "of the two flags.")
    if args.dp > 1:
        if args.nsamples % args.dp:
            p.error(f"--nsamples {args.nsamples} must be divisible by "
                    f"--dp {args.dp}")
        if args.chunk != args.nsamples:
            p.error("--dp requires --chunk == --nsamples: the driver "
                    "accumulates one chunk window at a time and batch "
                    "shards are contiguous, so only a window spanning the "
                    "whole batch actually runs data-parallel")


def main(argv=None):
    """Quantize as the flags say; returns (the dense quantized Model, the
    driver's artifacts)."""
    p = build_parser()
    args = p.parse_args(argv)
    check_args(p, args)
    dp = None
    if args.dp > 1:
        if common.needs_ranks(args.dp):
            return common.start_ranks("quip_tpu_torch.cli.quantize", argv,
                                      args.dp, args.device)
        common.join_ranks(args)
        from quip_tpu_torch.parallel.mesh import make_mesh
        dp = make_mesh(dp=args.dp, tp=1).axis("dp")

    # --host_offload: the model is built in host memory; the driver moves
    # one block at a time to --device
    params, cfg = common.load_model(args, on_host=args.host_offload)
    if args.fuse:
        from quip_tpu_torch.models import model as M
        params = M.fuse_params(params, cfg)
    (calib, test_stream), seqlen = common.get_data(args, cfg)
    qcfg = common.quant_config_from_args(args)

    from quip_tpu_torch.quantize.driver import quantize_model
    from quip_tpu_torch.utils.profiling import trace
    t0 = time.time()
    with trace(args.trace):
        newp, art = quantize_model(
            params, cfg, torch.from_numpy(calib), qcfg, seed=args.seed,
            chunk=args.chunk, progress=True, resume_dir=args.resume_dir,
            host_offload=args.host_offload, quant_head=args.quant_head,
            device=args.device, dp=dp)
    print(f"Total quant time: {time.time() - t0:.2f}s")
    print(f"Total proxy error: {art.total_error:.4f}")

    if args.save and (dp is None or dp.index == 0):
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

    if args.eval and not args.proxy_only and (dp is None or dp.index == 0):
        from quip_tpu_torch.eval.ppl import perplexity
        ppl = perplexity(newp, cfg, test_stream, seqlen)
        print(json.dumps({"dataset": args.dataset, "ppl": ppl}))
    return newp, art


if __name__ == "__main__":
    main()
