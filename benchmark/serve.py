"""The serving driver: an open loop of requests into ``Engine.submit`` and
an ``Engine.pump()`` loop on the paged cache, the chunks replayed as CUDA
graphs (``quip_tpu_torch.serve``).

Set-up builds the kernels (once a checkout), draws the weights, builds the
model and the engine, builds the chunk graph of every key the mix can
reach (greedy, each chunk length at each page bucket up to the longest
prompt plus the longest output), then runs one block of the mix's lengths
under a seed of its own through the pump until a pass builds no graph.

The run: requests fall due as the mix's Poisson stream (``gen.schedule``)
from ``lead_in_s`` before the window; the window is ``seconds`` long;
submission stops when it closes. The window's numbers:

* ``output_tokens_per_s``: served tokens (``len(req.generated)`` summed
  over every request) at the window's close less at its opening, over its
  seconds;
* ``ttft_p90_ms``: the 90th percentile over the requests due in the
  window of first-token time less due time. With ``"drain":
  "first_tokens"`` (below the knee) the loop runs on after the close until
  each has one, and one that has none a minute later is failed; above the
  knee (``"drain": "none"``) the backlog at the close is counted, not
  failed, and the metric is not reported;
* ``tpot_p90_ms``: the 90th percentile over the requests done in the
  window of (done - first token) / (tokens - 1).

The per-layer counters (tokens served, decode steps, the engine's pump
phases, graph builds) are read over the window, or in a traced run over
its part before the capture (``trace.py``).

Once the window has closed and the peak memory is read, the program's
state is freed and the reference judges a sample of finished requests,
drawn from the seed with the longest among them (``reference/judge.py``).
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import gen
from benchmark import roofline as RF
from benchmark import weights as WT
from benchmark.outcome import Outcome
from benchmark.reference import judge
from benchmark.trace import Tracer, capture_start


def _warm_graphs(eng, max_base: int) -> None:
    """Build every greedy chunk graph at every page bucket up to
    ``max_base`` rows (what ``Engine.warmup`` builds, less the sampled
    graphs and the buckets this mix never reaches)."""
    from quip_tpu_torch.models import paged as PG
    buckets = sorted({PG.page_bucket(b, eng.page, eng.pkv.capacity)
                      for b in range(1, max_base + 1)})
    idle = np.zeros(eng.max_batch, np.float32)
    for nb in buckets:
        for key, fn in eng._warm_graphs(nb, True, False):
            for _ in range(1 if key in eng._graphs else 2):
                eng._push_cursors(idle, idle + 1.0)
                eng._graphs.run(key, fn)
    eng._cursors_dirty = True
    eng._front_live = False


def _submit(eng, r: gen.Req):
    eng.submit(r.prompt, max_new_tokens=r.max_new_tokens)
    return eng._queue[-1]


def _drain(eng) -> None:
    while eng.pump():
        pass


def _p90(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90))


def setup(ctx):
    """(raw, engine): the weights, the model and the warmed engine."""
    from quip_tpu_torch.serve.engine import Engine
    shape, conf, mix, dev = ctx.shape, ctx.conf, ctx.mix, ctx.device
    raw = WT.draw(shape, ctx.seed, dev)
    ctx.phase("weights")
    model = WT.build(raw, shape, ctx.cfg)
    eng = Engine(model, ctx.cfg, device=dev, cache_dtype=torch.bfloat16,
                 seed=ctx.seed % (2 ** 63), **conf["engine"])
    ctx.phase("engine")
    _warm_graphs(eng, mix["prompt"]["max"] + mix["output"]["max"] + 1)
    ctx.phase("graphs")
    for _ in range(3):
        built = len(eng._graphs)
        for r in gen.warm_requests(mix, ctx.seed, shape["vocab"]):
            _submit(eng, r)
        _drain(eng)
        if len(eng._graphs) == built:
            break
    return raw, eng


def _served(sub, a: dict, b: dict, shape: dict) -> dict:
    """What the requests were served between snapshots a and b: decode
    tokens (the k-th served token, k >= 1, is decoded at position plen +
    k - 1 and attends plen + k keys), the keys they attended, and the
    dense-equivalent FLOPs of those tokens and of the prompts whose
    prefill gave their first token in between."""
    ntok, keys, pre = 0, 0, 0.0
    for r, _ in sub:
        g0, g1 = max(1, a["gen"].get(r.uid, 0)), b["gen"].get(r.uid, 0)
        p = len(r.prompt)
        if g1 > g0:
            ntok += g1 - g0
            keys += sum(p + k for k in range(g0, g1))
        if r.generated and a["t"] <= r.t_first < b["t"]:
            pre += RF.span_flops(shape, 0, p, heads=1)
    dec = RF.step_flops(shape, ntok, keys / ntok) if ntok else 0.0
    return dict(tokens=ntok, keys=keys, flops=dec + pre)


def window(ctx, eng, out: Outcome) -> List:
    """The timed open loop; returns every submitted request with its due
    time (wall clock)."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    mix, seconds = ctx.mix, ctx.seconds
    sched = gen.schedule(mix, ctx.seed, seconds, ctx.shape["vocab"])
    tr = (Tracer(capture_start(mix, seconds), ctx.device.type == "cuda")
          if ctx.trace else None)
    if tr is not None:
        tr.prepare()
    lead = mix["lead_in_s"]
    sub: List = []

    def snapshot():
        st = eng.stats()
        ph = st.get("pump_phase_ms_per_chunk", {})
        n = st.get("pump_chunks", 0)
        return dict(t=time.time(),
                    tokens=sum(len(r.generated) for r, _ in sub),
                    gen={r.uid: len(r.generated) for r, _ in sub},
                    chunks=n,
                    phases={k: v * n for k, v in ph.items() if k != "steps"},
                    capture_s=eng._graphs.capture_s,
                    k1_decode=DM.launches_decode)

    t0 = time.time()
    w0, w1 = t0 + lead, t0 + lead + seconds
    snaps: Dict[str, dict] = {}
    i = 0
    while True:
        now = time.time()
        while i < len(sched) and t0 + sched[i].due_s <= now:
            sub.append((_submit(eng, sched[i]), t0 + sched[i].due_s))
            i += 1
        if "w0" not in snaps and now >= w0:
            snaps["w0"] = snapshot()
        if tr is not None and now >= w0:
            tr.tick(now - w0, snapshot)
        if now >= w1:
            snaps["w1"] = snapshot()
            break
        with tr.span("bench.pump") if tr else contextlib.nullcontext():
            busy = eng.pump()
        if not busy:
            nxt = t0 + sched[i].due_s if i < len(sched) else w1
            with tr.span("bench.no_request") if tr else \
                    contextlib.nullcontext():
                time.sleep(max(0.0, min(nxt, w1) - time.time()))
    if tr is not None:
        tr.close(snaps["w1"])
    due_in = [(r, d) for r, d in sub if w0 <= d < w1]
    if mix.get("drain") == "first_tokens":
        end = time.time() + 60.0
        while (any(not r.generated for r, _ in due_in)
               and time.time() < end):
            if not eng.pump():
                break
    a, b = snaps["w0"], snaps["w1"]
    win = b["t"] - a["t"]
    ttft = [(r.t_first - d) * 1e3 for r, d in due_in if r.generated]
    out.attempted = len(due_in)
    if mix.get("drain") == "first_tokens":
        # one still without a first token a minute past the close never
        # came; above the knee ("drain": "none") the backlog at the close
        # is late, not failed
        out.failed = len(due_in) - len(ttft)
    done = [r for r, _ in sub if r.done and a["t"] <= r.t_done < b["t"]
            and len(r.generated) > 1]
    tpot = [(r.t_done - r.t_first) * 1e3 / (len(r.generated) - 1)
            for r in done]
    out.e2e["output_tokens_per_s"] = (b["tokens"] - a["tokens"]) / win
    if ttft and not out.failed:
        out.e2e["ttft_p90_ms"] = _p90(ttft)
    if tpot:
        out.e2e["tpot_p90_ms"] = _p90(tpot)
    out.facts.update(
        window_s=win, requests_submitted=len(sub),
        requests_done_in_window=len(done), ttft_samples=len(ttft),
        backlog_at_close=len(due_in) - len(ttft),
        lateness_s=max(0.0, max((r.t_submit - d for r, d in sub),
                                default=0.0)),
        bounds=RF.decode_step_bounds(ctx.shape,
                                     ctx.conf["engine"]["max_batch"]))
    # the per-layer counters: over the window, or in a traced run over
    # its part before the capture
    c = snaps["w1"] if "dev0" not in (tr.snaps if tr else {}) \
        else tr.snaps["dev0"]
    span = c["t"] - a["t"]
    got = _served(sub, a, c, ctx.shape)
    B, L = ctx.conf["engine"]["max_batch"], ctx.shape["n_layers"]
    per_step = len(RF.linears(ctx.shape)) * L
    steps = (c["k1_decode"] - a["k1_decode"]) / per_step
    ctx_mean = got["keys"] / got["tokens"] if got["tokens"] else 0.0
    dchunks = c["chunks"] - a["chunks"]
    out.facts.update(
        counted_s=span, decode_steps=steps, decode_tokens=got["tokens"],
        useful_flops=got["flops"],
        step_flops=steps * RF.step_flops(ctx.shape, B, ctx_mean),
        tokens_per_s=got["tokens"] / span if span > 0 else None,
        steps_per_s=steps / span if span > 0 else None,
        pump_phase_ms_per_chunk={k: (v - a["phases"].get(k, 0.0)) / dchunks
                                 for k, v in c["phases"].items()}
        if dchunks else None,
        graph_capture_s_in_window=b["capture_s"] - a["capture_s"])
    if tr is not None and "dev1" in tr.snaps:
        d0, d1 = tr.snaps["dev0"], tr.snaps["dev1"]
        dspan = max(d1["t"] - d0["t"], 1e-9)
        out.facts.update(
            traced_s=dspan,
            traced_tokens_per_s=_served(sub, d0, d1, ctx.shape)["tokens"]
            / dspan,
            traced_steps_per_s=(d1["k1_decode"] - d0["k1_decode"])
            / per_step / dspan)
    if tr is not None:
        tr.cap.load()
        out.capture = tr.cap
    return [r for r, _ in sub]


def sample(ctx, reqs) -> List:
    """The finished requests that the reference judges: the longest and
    ``check_requests - 1`` more drawn from the seed."""
    fin = [r for r in reqs if r.done]
    if not fin:
        return []
    fin.sort(key=lambda r: r.uid)
    longest = max(fin, key=lambda r: len(r.prompt) + len(r.generated))
    rest = [r for r in fin if r is not longest]
    k = min(len(rest), ctx.mix["check_requests"] - 1)
    pick = gen.rng(ctx.seed).choice(len(rest), size=k, replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def run(ctx) -> Outcome:
    out = Outcome(ctx.shape)
    raw, eng = setup(ctx)
    del raw
    ctx.mark_setup()
    reqs = window(ctx, eng, out)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        out.memory_peak = torch.cuda.max_memory_allocated(ctx.device)
    picked = [(r.prompt.tolist(), list(r.generated)) for r in
              sample(ctx, reqs)]
    del eng, reqs
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.after_window()
    out.judged = picked
    if not picked:
        out.checks.append(("served_gap", float("inf"),
                           ctx.limits["served_gap"]["limit"]))
        return out
    with torch.no_grad():
        raw = WT.draw(ctx.shape, ctx.seed, ctx.device)
        gap, n = judge.served_gap(raw, ctx.shape, picked)
    out.facts["tokens_judged"] = n
    out.checks.append(("served_gap", gap, ctx.limits["served_gap"]["limit"]))
    return out
