"""Find a serving cell's knee: the cell's mix at a ladder of fixed rates,
one model and engine for all of them, each rate's window after the last
one's requests have drained.

    python -m benchmark.sweep --workload opt-6.7b.chat-b8 --seed 5 \\
        --seconds 25 --rates 2,2.5,3,3.5,4

prints one JSON line a rate: requests completed a second, served tokens a
second, the backlog left at the close, and the first-token and
per-token tails. The knee is the highest rate whose backlog does not grow
(completions keep up with arrivals). For defining cells, not for checks.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from benchmark import run as R
    from benchmark import serve, spec
    cell = spec.cell(args.workload)
    import os
    for k, v in cell["config"].get("env", {}).items():
        os.environ[k] = str(v)
    from quip_tpu_torch.kernels import _build
    _build.build_all(["dequant_matmul_decode", "dequant_matmul_tile",
                      "flash_attn", "rht"])
    ctx = R.Ctx(cell, args.seed, args.seconds, False, "cuda")
    _, eng = serve.setup(ctx)
    ctx.mark_setup()
    print(json.dumps({"setup_s": ctx.setup_s}), flush=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        ctx.mix = copy.deepcopy(cell["mix"])
        ctx.mix.update(rate_per_s=rate, drain="none")
        ctx.seed = args.seed + k
        out = serve.Outcome(ctx.shape)
        reqs = serve.window(ctx, eng, out)
        backlog = sum(1 for r in reqs if not r.generated)
        f = out.facts
        line = dict(rate=rate, done_per_s=f["requests_done_in_window"]
                    / f["window_s"], backlog_at_close=backlog,
                    queued=len(eng._queue), **{k: v for k, v in
                                               out.e2e.items()})
        ttft = [(r.t_first - r.t_submit) * 1e3 for r in reqs if r.generated]
        line["ttft_p50_ms_of_started"] = float(np.median(ttft))
        print(json.dumps(line), flush=True)
        serve._drain(eng)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
