"""Token-by-token decode benchmark CLI (port of ``quip_tpu/cli/bench.py``).

    python -m quip_tpu_torch.cli.bench llama-2-7b --load DIR --batch 4
    python -m quip_tpu_torch.cli.bench llama-2-7b --load DIR --paged --check

quip_tpu's flags, checks and JSON keys, plus ``--device``: the median
per-token latency over a replay (``median_s_per_token_synced``, a host
sync after every step, the reference ``benchmark()``'s semantics), the
throughput of ``--tokens`` steps chained with one sync at the end
(``tokens_per_sec``, ``s_per_token_chained``) at ``--batch`` slots, and
under ``--check`` the mean nll of the greedy continuation of slot 0
(``continuation_nll``). The KV cache is bf16 (int8 with ``--kv_quant``),
pre-positioned at ``--prefix`` rows of zeros.

A step is what quip_tpu jits: by default one decode token on the slot
arena (``serve/arena.py::slot_attention_step`` with every slot at the same
length, which equals ``models/model.py::decode_step`` on a contiguous
cache), with ``--paged`` one ``paged_decode_step`` on the two-level cache,
its hot ring flushed every ``--hot`` steps outside the step. On the card
each step is one CUDA graph replay (one graph for the arena, one for each
page bucket the run reaches on the paged cache, all built before the
timed chain); on the CPU it runs eagerly.

``--dp D --tp T`` time the step sharded on D·T ranks, as quip_tpu's
mesh: weights column-parallel over tp, the cache's slots over dp and kv
heads over tp (parallel/mesh.py; ``--batch`` divisible by D). The command
starts the ranks itself (this process is rank 0; it alone prints) or
joins the group under ``python -m torch.distributed.run``. On a gloo
group (ranks sharing a card, or the CPU) the steps run eagerly: a CUDA
graph cannot hold gloo's collectives.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from quip_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("quip_tpu_torch.bench")
    common.add_model_args(p)
    p.add_argument("--load", type=str, default=None,
                   help="checkpoint dir saved by either package")
    p.add_argument("--tokens", type=int, default=128,
                   help="number of decode steps to time")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--max_seq", type=int, default=256)
    p.add_argument("--kv_quant", action="store_true",
                   help="int8-quantized KV cache")
    p.add_argument("--paged", action="store_true",
                   help="paged two-level KV cache (models/paged.py): decode "
                        "cost scales with used context, not --max_seq")
    p.add_argument("--hot", type=int, default=32,
                   help="paged mode: hot-ring size (flush period)")
    p.add_argument("--page", type=int, default=256,
                   help="paged mode: frozen-arena read-page size")
    p.add_argument("--prefix", type=int, default=0,
                   help="pre-position the cache at this length before "
                        "timing (steady-state decode at a given context; "
                        "content is zeros, cost-identical)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh ways (the batch's slots)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh ways (weights and kv heads)")
    p.add_argument("--check", action="store_true",
                   help="also report nll of the benchmarked continuation")
    p.add_argument("--seed", type=int, default=0)
    return p


class _Stepper:
    """The benchmark's decode state on ``dev`` and its step: the frontier
    token (B, 1), the cache and its cursors, all in fixed tensors that the
    step updates in place, so a CUDA graph replays it."""

    def __init__(self, params, cfg, args, dev: torch.device, mesh=None):
        from quip_tpu_torch.models import paged as PG
        from quip_tpu_torch.serve import arena as AR
        from quip_tpu_torch.serve.graphs import ChunkGraphs
        self.PG, self.AR = PG, AR
        self.params, self.cfg, self.args = params, cfg, args
        B = args.batch
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        at = torch.full((B,), args.prefix, dtype=torch.int32, device=dev)
        kw = dict(dtype=torch.bfloat16, quantized=args.kv_quant,
                  hot=args.hot, page=args.page, device=dev)
        if args.paged and mesh is not None:
            from quip_tpu_torch.parallel.mesh import init_paged_shard
            self.caches = init_paged_shard(B, args.max_seq, cfg, mesh,
                                           **kw)._replace(
                base=at, hot_len=torch.zeros_like(at))
        elif args.paged:
            self.caches = PG.init_paged(B, args.max_seq, cfg, **kw)._replace(
                base=at, hot_len=torch.zeros_like(at))
        else:
            if mesh is not None:
                from quip_tpu_torch.parallel.mesh import init_arena_shard
                self.kv = init_arena_shard(B, args.max_seq, cfg, mesh,
                                           torch.bfloat16,
                                           quantize=args.kv_quant,
                                           device=dev)
            else:
                self.kv = AR.init_arena(cfg, B, args.max_seq, torch.bfloat16,
                                        quantize=args.kv_quant, device=dev)
            self.lens = at
        self.base, self.hot = args.prefix, 0     # host mirrors (paged)
        self.graphs = ChunkGraphs(dev, torch.Generator(device=dev), eager=(
            mesh is not None and mesh.backend == "gloo"))

    def _key(self, base: int):
        if not self.args.paged:
            return "arena"
        return self.PG.page_bucket(base, self.args.page,
                                   self.caches.capacity)

    def _fn(self, key):
        """One decode step at graph key ``key``: returns the nll (B,) of
        the argmax token, which becomes the frontier."""
        def fn():
            if self.args.paged:
                logits, hot = self.PG.paged_decode_step(
                    self.params, self.tok, self.caches, self.cfg,
                    page=self.args.page, n_pages=key)
                self.caches.hot_len.copy_(hot.length)
            else:
                logits = self.AR.slot_attention_step(
                    self.params, self.cfg, self.tok, self.lens, self.kv)
                self.lens.add_(1)
            nxt = torch.argmax(logits, dim=-1)[:, None]
            lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            self.tok.copy_(nxt)
            return -lp.gather(1, nxt)[:, 0]
        return fn

    def step(self) -> torch.Tensor:
        key = self._key(self.base)
        nll = self.graphs.run(key, self._fn(key))
        if self.args.paged:
            self.hot += 1
            if self.hot >= self.args.hot:     # deterministic flush schedule
                self.flush()
        return nll

    def flush(self) -> None:
        """The hot ring into the frozen pages, outside the step."""
        self.PG.flush_hot_dev(self.caches)
        self.base += self.hot
        self.hot = 0

    def build_ahead(self, n_steps: int) -> None:
        """Build the graph of every page bucket the next ``n_steps`` steps
        reach, so none is built inside a timed run. A build runs one real
        step at that bucket's base: the frontier and the cursors are put
        back after it, and the ring row it wrote is the one the next real
        step writes first."""
        if not (self.args.paged and self.tok.is_cuda) or self.graphs.eager:
            return
        bases = {self.base + j * self.args.hot
                 for j in range((self.hot + n_steps) // self.args.hot + 1)}
        for key in sorted({self._key(b) for b in bases}):
            if key in self.graphs:
                continue
            saved = [t.clone() for t in (self.tok, self.caches.base,
                                         self.caches.hot_len)]
            self.caches.base.fill_(
                min(b for b in bases if self._key(b) == key))
            self.graphs.run(key, self._fn(key))
            for t, s in zip((self.tok, self.caches.base,
                             self.caches.hot_len), saved):
                t.copy_(s)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    n_lat = min(args.tokens, 16)
    if args.prefix + 4 + args.tokens + n_lat > args.max_seq - 1:
        p.error(f"--prefix {args.prefix} + --tokens {args.tokens} (+4 "
                f"warmup, +{n_lat} latency probes) exceeds the KV cache "
                f"(--max_seq {args.max_seq}); raise --max_seq")
    mesh = None
    if args.dp * args.tp > 1:
        if args.batch % args.dp:
            p.error(f"--batch {args.batch} must be divisible by --dp")
        if common.needs_ranks(args.dp * args.tp):
            return common.start_ranks("quip_tpu_torch.cli.bench", argv,
                                      args.dp * args.tp, args.device)
        common.join_ranks(args)
        from quip_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp, tp=args.tp)
    if args.load:
        params, cfg, meta = common.load_checkpoint_model(args)
        print(f"loaded {meta}")
    else:
        params, cfg = common.load_model(args)
    dev = torch.device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if mesh is not None:
        from quip_tpu_torch.parallel.mesh import check_replicas, shard_params
        params = params.to(dev)
        check_replicas(params, mesh)
        params = shard_params(params, cfg, mesh)
    st = _Stepper(params, cfg, args, dev, mesh)
    with torch.no_grad():
        for _ in range(4):                # warmup (and the first graph)
            st.step()
        if args.paged:
            st.flush()                    # outside the timed chain
        st.build_ahead(args.tokens + n_lat)
        int(st.tok[0, 0])

        # throughput: chain all steps, sync once
        t0 = time.perf_counter()
        nlls = [st.step().clone() for _ in range(args.tokens)]
        int(st.tok[0, 0])
        dt_chain = (time.perf_counter() - t0) / args.tokens

        # median latency with a host sync after every step, continuing
        # from the chain's state
        lat = []
        for _ in range(n_lat):
            t0 = time.perf_counter()
            st.step()
            int(st.tok[0, 0])
            lat.append(time.perf_counter() - t0)
        sync()

    out = {
        "tokens_per_sec": args.batch / dt_chain,
        "s_per_token_chained": dt_chain,
        "median_s_per_token_synced": (float(np.median(lat)) if lat
                                      else None),
        "batch": args.batch,
        "mesh": {"dp": args.dp, "tp": args.tp},
        "kv_quant": bool(args.kv_quant),
        "paged": bool(args.paged),
        "prefix": args.prefix,
    }
    if args.check:
        out["continuation_nll"] = float(np.mean(
            [float(x[0]) for x in nlls]))
    print(json.dumps(out))
    sys.stdout.flush()
    return out


if __name__ == "__main__":
    main()
