"""Serving CLI (port of ``quip_tpu/cli/serve.py``): continuous-batching
generation from a packed checkpoint, batch prompts or an HTTP API.

Examples (on the card; ``--device cpu`` runs the plain path):
  python -m quip_tpu_torch.cli.serve llama-2-7b --load DIR --prompt "Hi"
  python -m quip_tpu_torch.cli.serve llama-2-7b --load DIR --self_draft 4 \\
      --warmup --prompt "Hi"
  python -m quip_tpu_torch.cli.serve llama-2-7b --load DIR --http 8000

quip_tpu's flags plus ``--device``. The cache is bf16 on the card and f32
on the CPU; paged unless ``--no_paged`` asks for the flat slot arena (a
draft or a system prompt keeps it paged, as in quip_tpu). The tokenizer
is the model's Hugging Face tokenizer from the local cache, else the byte
tokenizer.

``--tp T --dp D`` serve sharded on T·D ranks (``Engine(mesh=)``,
parallel/mesh.py; ``--no_paged`` is refused, as in quip_tpu): the command
starts the ranks itself (this process is rank 0; it alone prints), or
joins the group under ``python -m torch.distributed.run --nproc_per_node
T·D``. Batch prompts run on every rank alike; with ``--http`` rank 0
serves and the other ranks follow it (``Engine.follow``). E.g. on the CPU:
  python -m quip_tpu_torch.cli.serve llama-tiny --tp 2 --dp 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from quip_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("quip_tpu_torch.serve")
    common.add_model_args(p)
    p.add_argument("--load", type=str, default=None,
                   help="checkpoint dir saved by either package")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_seq", type=int, default=512)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0,
                   help="sample from the k most probable tokens (0 = all)")
    p.add_argument("--top_p", type=float, default=1.0,
                   help="nucleus mass (1.0 = no filter)")
    p.add_argument("--self_draft", type=int, default=0,
                   help="speculative decoding with the target's first N "
                        "blocks as the draft (no extra weights)")
    p.add_argument("--spec_draft", type=str, default=None,
                   help="speculative decoding with the draft checkpoint in "
                        "this dir (its config from the checkpoint's meta)")
    p.add_argument("--spec_k", type=int, default=4,
                   help="tokens drafted a speculative step")
    p.add_argument("--stop_token", type=int, action="append", default=None,
                   help="stop at this token id (repeatable; included in "
                        "the output)")
    p.add_argument("--stop_eos", action="store_true",
                   help="stop at the tokenizer's EOS token")
    p.add_argument("--system_prompt", type=str, default=None,
                   help="shared prefix: this text's KV is computed once "
                        "and attended by every request (HTTP requests opt "
                        "out with use_prefix=false)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve the HTTP JSON API (GET /health, /metrics, "
                        "POST /generate) instead of batch prompts")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--prompt", type=str, action="append", default=None,
                   help="prompt(s); '-' reads one prompt a stdin line")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (ranks a model replica spans)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ways (replicas, each its slots)")
    p.add_argument("--kv_quant", action="store_true",
                   help="int8 KV cache")
    p.add_argument("--no_paged", action="store_true",
                   help="the flat slot arena instead of the paged cache")
    p.add_argument("--hot", type=int, default=32,
                   help="hot-ring rows (the flush period)")
    p.add_argument("--page", type=int, default=64,
                   help="frozen-arena read-page rows")
    p.add_argument("--warmup", action="store_true",
                   help="build the serving graphs before the batch (HTTP "
                        "mode always warms; Engine.warmup)")
    p.add_argument("--no_chunked", action="store_true",
                   help="decode a token a step instead of chunks")
    p.add_argument("--no_overlap", action="store_true",
                   help="the serial chunk loop instead of the overlapped "
                        "pump (the same tokens under greedy)")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="chunks the pump keeps in flight")
    p.add_argument("--max_chunk", type=int, default=None,
                   help="tokens a dispatch (default 16; a spec engine runs "
                        "S = min(8, hot // (2K)) iterations)")
    p.add_argument("--admit_limit", type=int, default=None,
                   help="prefills a scheduling boundary while decoding "
                        "(unset: admit into every free slot)")
    p.add_argument("--seed", type=int, default=0)
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    if (args.tp > 1 or args.dp > 1) and args.no_paged:
        p.error("--no_paged is incompatible with --tp/--dp: mesh "
                "serving runs the paged production step")
    if args.self_draft and args.spec_draft:
        p.error("--self_draft and --spec_draft are mutually exclusive")


def load_target(args):
    """(Model, cfg): the ``--load`` checkpoint, else the random model."""
    if args.load:
        params, cfg, meta = common.load_checkpoint_model(args)
        print(f"loaded {meta}", file=sys.stderr)
        return params, cfg
    return common.load_model(args)


def load_draft(args, params, cfg):
    """(draft, draft cfg) for ``--self_draft`` / ``--spec_draft``, or None."""
    if args.self_draft:
        from quip_tpu_torch.serve.speculative import make_self_draft
        return make_self_draft(params, cfg, args.self_draft)
    if args.spec_draft:
        from quip_tpu_torch.convert import params_from_numpy
        from quip_tpu_torch.models import get_config
        from quip_tpu_torch.pack.model import load_checkpoint
        tree, meta = load_checkpoint(args.spec_draft)
        dcfg = dataclasses.replace(get_config(meta["model"]), dtype=cfg.dtype)
        return params_from_numpy(tree, dcfg, device=args.device), dcfg
    return None


def load_tokenizer(name: str, vocab_size: int):
    from quip_tpu_torch.eval.zeroshot.lm import (ByteTokenizer,
                                                 load_hf_tokenizer)
    try:
        return load_hf_tokenizer(name)
    except (ImportError, OSError, ValueError):
        return ByteTokenizer(vocab_size)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    check_args(p, args)
    mesh = None
    if args.tp * args.dp > 1:
        if common.needs_ranks(args.tp * args.dp):
            return common.start_ranks("quip_tpu_torch.cli.serve", argv,
                                      args.tp * args.dp, args.device)
        common.join_ranks(args)
        from quip_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp, tp=args.tp)
    params, cfg = load_target(args)
    draft = load_draft(args, params, cfg)
    tokenizer = load_tokenizer(args.model, cfg.vocab_size)
    prompts = args.prompt or ["Hello"]
    if prompts == ["-"]:
        prompts = [ln.rstrip("\n") for ln in sys.stdin if ln.strip()]

    from quip_tpu_torch.serve.engine import Engine
    dev = torch.device(args.device)
    cache_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    prefix = (tokenizer.encode(args.system_prompt)
              if args.system_prompt else None)
    max_seq = args.max_seq
    if cfg.positions == "learned":
        # OPT's learned table bounds a sequence, the prefix's rows included
        # (the engine raises past it): cap the engine at the table
        room = params.embed.positions.shape[0] - 2 - len(prefix or ())
        if max_seq > room:
            print(f"--max_seq {max_seq} capped at {room}: the learned "
                  f"position table's rows", file=sys.stderr)
            max_seq = room
    eng = Engine(params, cfg, max_batch=args.max_batch, max_seq=max_seq,
                 kv_quant=args.kv_quant, cache_dtype=cache_dtype,
                 paged=not args.no_paged, hot=args.hot, page=args.page,
                 seed=args.seed, draft=draft, spec_k=args.spec_k,
                 shared_prefix=prefix,
                 admit_limit=args.admit_limit,
                 pipeline_depth=args.pipeline_depth, device=dev, mesh=mesh)
    chunked = not args.no_chunked
    if args.http is not None:
        from quip_tpu_torch.serve.server import serve_http
        print("warming serving graphs...", file=sys.stderr)
        eng.warmup(chunked=chunked)
        if not eng.leader:
            eng.follow()              # until rank 0's server shuts down
            return None
        httpd, loop = serve_http(eng, host=args.host, port=args.http,
                                 tokenizer=tokenizer, chunked=chunked,
                                 overlap=not args.no_overlap,
                                 max_chunk=args.max_chunk)
        print(f"serving on http://{args.host}:{args.http} "
              f"(POST /generate, GET /health, GET /metrics)",
              file=sys.stderr)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            loop.shutdown()
        return None

    if args.warmup:
        print("warming serving graphs...", file=sys.stderr)
        eng.warmup(chunked=chunked)
    stop = list(args.stop_token or [])
    if args.stop_eos:
        # the tokenizers name it eot_token_id (quip_tpu reads
        # eos_token_id, which neither has: ROADMAP queue 3)
        stop.append(int(tokenizer.eot_token_id))
    t0 = time.time()
    reqs = eng.run([dict(prompt=tokenizer.encode(s),
                         max_new_tokens=args.max_new_tokens,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p, stop=stop or None)
                    for s in prompts],
                   chunked=chunked, overlap=not args.no_overlap,
                   max_chunk=args.max_chunk)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total = sum(len(r.generated) for r in reqs)
    for s, r in zip(prompts, reqs):
        print(json.dumps({"prompt": s,
                          "completion": tokenizer.decode(r.generated)}))
    print(f"[{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s]",
          file=sys.stderr)
    return reqs


if __name__ == "__main__":
    main()
