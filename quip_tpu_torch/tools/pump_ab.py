"""A/B timing of the plain pump's decode at full width, one card.

    python -m quip_tpu_torch.tools.pump_ab parent=_checkout/parent \\
        change=. change=. parent=_checkout/parent [--out DIR]

Each argument ``label=DIR`` is one run, in the order given (so ``A B B A``
shows the card's drift): a fresh process that imports ``quip_tpu_torch``
from the checkout ``DIR``, builds its kernels there, builds a random
32-layer 2-bit Llama-2-7B (seed 0, packed lm_head) and times decode
through the overlapped pump (``Engine.run(..., chunked=True)``), un-fused
RHT, bf16 KV, hot ring 32, at b1 and b4, the way ``chip_smoke.py``'s
phase 8 does: 37-token prompts, a first run that builds the chunk graphs,
then ``--reps`` windows, each from just after a fresh batch's admission
and first chunk to its end (48 steps, which cross one flush of the ring);
the median ms a step is kept. It uses only what ``Engine`` has had since
the pump was ported (``run``, ``submit``, ``pump``, ``_pending_q``), so
older checkouts run too; it asks for the paged cache where ``Engine``
takes ``paged`` (the arena became its default), and older ones are paged
only.
Prints the card's name and power limit, one JSON line a run, and a
summary line (the median over each label's runs).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


def worker(tree: str, batches, n_new: int, reps: int) -> dict:
    """One run (in its own process): times the pump from ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    os.environ["QUIP_FUSED_RHT"] = "0"
    import numpy as np
    import torch
    import quip_tpu_torch
    from quip_tpu_torch.kernels import _build
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.serve.engine import Engine

    where = os.path.dirname(os.path.abspath(quip_tpu_torch.__file__))
    assert where == os.path.join(os.path.abspath(tree), "quip_tpu_torch"), (
        where, tree)
    t = time.time()
    _build.build_all(["dequant_matmul_decode", "dequant_matmul_tile",
                      "flash_attn", "rht"])
    build_s = time.time() - t
    cfg = get_config("llama-2-7b")
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    rng = np.random.default_rng(8)
    out = dict(build_s=build_s)
    paged = ({"paged": True} if "paged" in inspect.signature(
        Engine).parameters else {})
    for B in batches:
        e = Engine(model, cfg, max_batch=B, max_seq=1024, hot=32, page=64,
                   cache_dtype=torch.bfloat16, device="cuda", **paged)
        prompts = [rng.integers(0, cfg.vocab_size, 37).tolist()
                   for _ in range(B)]
        t = time.time()
        e.run([dict(prompt=p, max_new_tokens=n_new) for p in prompts],
              chunked=True)
        first_s = time.time() - t
        ms = []
        for _ in range(reps):
            for p in prompts:
                e.submit(p, max_new_tokens=n_new)
            e.pump()                 # admission and the first chunk
            torch.cuda.synchronize()
            n = n_new - sum(p["T"] for p in e._pending_q)
            t = time.perf_counter()
            while e.pump():
                pass
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3 / n)
        out[f"b{B}"] = dict(ms_per_step=statistics.median(ms), ms_reps=ms,
                            first_run_s=first_s)
        del e
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="*", help="label=DIR, one per run")
    ap.add_argument("--batches", default="1,4")
    ap.add_argument("--n_new", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="directory for pump_ab.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    if args.worker:
        print(json.dumps(worker(args.worker, batches, args.n_new,
                                args.reps)))
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs = []
    for run in args.runs:
        label, tree = run.split("=", 1)
        t = time.time()
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(tree),
             "--batches", args.batches, "--n_new", str(args.n_new),
             "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.abspath(tree))
        if p.returncode != 0:
            sys.stderr.write(p.stderr[-4000:])
            raise SystemExit(f"run {label}={tree} failed ({p.returncode})")
        r = dict(json.loads(p.stdout.strip().splitlines()[-1]), label=label,
                 tree=tree, wall_s=time.time() - t)
        runs.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for label in dict.fromkeys(r["label"] for r in runs):
        summary[label] = {f"b{B}": statistics.median(
            r[f"b{B}"]["ms_per_step"] for r in runs if r["label"] == label)
            for B in batches}
    print(json.dumps(dict(card=smi, median_ms_per_step=summary)))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "pump_ab.json"), "w") as f:
            json.dump(dict(card=smi, runs=runs, summary=summary), f, indent=1)
    return summary


if __name__ == "__main__":
    main()
