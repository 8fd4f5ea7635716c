"""The perplexity driver: windows of ``seqlen`` tokens scored ``batch`` at
a time by ``quip_tpu_torch.eval.ppl.window_nll`` (one forward through
K1-tile and K2, the loss in float32), in turn from a pool drawn from the
seed, for ``seconds``.

``scored_tokens_per_s`` is the tokens of every window scored in the window
over its seconds, which end at a ``synchronize()`` after the last. The
host runs at most two windows ahead of the card. Once the window has
closed and the program's state is freed, the reference scores a sample
of the windows drawn from the seed and compares its loss with the
program's (``reference/judge.py::nll_gap``).
"""
from __future__ import annotations

import gc
from contextlib import nullcontext
import time

import torch

from benchmark import gen
from benchmark import roofline as RF
from benchmark import weights as WT
from benchmark.outcome import Outcome
from benchmark.reference import judge
from benchmark.trace import Tracer, capture_start


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> Outcome:
    from quip_tpu_torch.eval.ppl import window_nll
    out = Outcome(ctx.shape)
    mix, dev, shape = ctx.mix, ctx.device, ctx.shape
    B, S = mix["batch"], mix["seqlen"]
    raw = WT.draw(shape, ctx.seed, dev)
    ctx.phase("weights")
    model = WT.build(raw, shape, ctx.cfg)
    del raw
    ctx.phase("model")
    pool = torch.from_numpy(gen.windows(mix, ctx.seed, shape["vocab"])
                            ).to(dev)
    warm = torch.from_numpy(gen.windows(mix, ctx.seed, shape["vocab"],
                                        warm=True)).to(dev)
    with torch.inference_mode():
        for j in range(2):
            window_nll(model, warm[j * B:(j + 1) * B], ctx.cfg)
    _sync(dev)
    tr = (Tracer(capture_start(mix, ctx.seconds), dev.type == "cuda")
          if ctx.trace else None)
    if tr is not None:
        tr.prepare()
    ctx.mark_setup()
    nwin = pool.shape[0] // B
    results, evs = [], []
    ev = dev.type == "cuda"
    i = 0

    def snapshot():
        return dict(t=time.perf_counter(), windows=i)

    with torch.inference_mode():
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            if tr is not None:
                tr.tick(el, snapshot)
            if el >= ctx.seconds:
                break
            j = i % nwin
            with tr.span("bench.window_nll") if tr else nullcontext():
                results.append((j, window_nll(
                    model, pool[j * B:(j + 1) * B], ctx.cfg)))
            if ev:
                e = torch.cuda.Event()
                e.record()
                evs.append(e)
                if len(evs) > 2:
                    with tr.span("bench.wait") if tr else nullcontext():
                        evs.pop(0).synchronize()
            i += 1
        last = snapshot()
        if tr is not None:
            tr.close(last)
        _sync(dev)
        t1 = time.perf_counter()
    win = t1 - t0
    out.attempted = i
    out.e2e["scored_tokens_per_s"] = i * B * S / win
    # the per-layer counters: over the window, or in a traced run over
    # its part before the capture (windows issued; the host runs at most
    # two ahead of the card)
    c = tr.snaps["dev0"] if tr and "dev0" in tr.snaps else last
    span = c["t"] - t0
    out.facts.update(
        window_s=win, windows=i, counted_s=span,
        windows_per_s=c["windows"] / span if span > 0 else None,
        useful_flops=c["windows"] * B * RF.span_flops(shape, 0, S,
                                                      heads=S - 1),
        bounds=RF.window_bounds(shape, B, S))
    if tr is not None and "dev1" in tr.snaps:
        d0, d1 = tr.snaps["dev0"], tr.snaps["dev1"]
        if d1["t"] > d0["t"]:
            out.facts.update(traced_s=d1["t"] - d0["t"],
                             traced_windows_per_s=(d1["windows"]
                                                   - d0["windows"])
                             / (d1["t"] - d0["t"]))
    if tr is not None:
        tr.cap.load()
        out.capture = tr.cap
    if dev.type == "cuda":
        out.memory_peak = torch.cuda.max_memory_allocated(dev)
    k = min(mix["check_windows"], len(results))
    pick = sorted(gen.rng(ctx.seed).choice(len(results), size=k,
                                           replace=False))
    got = [(results[p][0], [float(v) for v in results[p][1].cpu()])
           for p in pick]
    tokens = pool.cpu()
    del model, results, pool, warm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.after_window()
    wins, prog = [], []
    for j, vals in got:
        for b, v in enumerate(vals):
            wins.append(tokens[j * B + b].to(dev))
            prog.append(v)
    out.judged = (wins, prog)
    with torch.no_grad():
        raw = WT.draw(shape, ctx.seed, dev)
        ref = judge.window_nll(raw, shape, wins)
    out.checks.append(("nll_gap", judge.nll_gap(ref, prog, S),
                       ctx.limits["nll_gap"]["limit"]))
    return out
