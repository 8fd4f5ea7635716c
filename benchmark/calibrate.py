"""Readings for the limits of ``correct``: the numbers a cell compares,
from the program on many seeds and from the control on the same inputs,
in one process on the chip.

    python -m benchmark.calibrate --workload <cell> --seeds 11,12,... \\
        --seconds 10 [--fault token]

The model and the engine are built once; each seed's weights are drawn
from that seed and written into the same tensors (the derived state of
the fused RHT refreshed in place, as after ``load_state_dict``), its
traffic runs the cell's timed path for ``--seconds``, and the reference
judges the sample a run judges. For a serving cell each line gives the
program's ``served_gap`` and the control's (the reference in float8,
``reference/model.py``), for a perplexity cell ``nll_gap`` of both.
``--fault token`` alters one served token of each judged request where
the pump commits it, to read what that fault gives.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch


def _reload(live: dict, fresh: dict) -> None:
    for k, v in fresh.items():
        if isinstance(v, dict):
            _reload(live[k], v)
        elif isinstance(v, torch.Tensor):
            live[k].copy_(v)
    from quip_tpu_torch.kernels import rht
    rht.refresh()


def readings(cell: dict, seeds, seconds: float, device="cuda",
             fault=None, sink=None):
    """One line of readings a seed (module note); yields them."""
    from benchmark import gen, serve
    from benchmark import run as R
    from benchmark import weights as WT
    from benchmark.outcome import Outcome
    from benchmark.reference import judge
    ctx = R.Ctx(cell, seeds[0], seconds, False, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell["mix"]["driver"]
    if drv == "serve":
        live, eng = serve.setup(ctx)
        if fault == "token":
            _plant_token_fault()
    else:
        from quip_tpu_torch.eval.ppl import window_nll
        live = WT.draw(ctx.shape, seeds[0], ctx.device)
        model = WT.build(live, ctx.shape, ctx.cfg)
    for seed in seeds:
        t = time.time()
        ctx.seed = seed
        with torch.no_grad():
            fresh = WT.draw(ctx.shape, seed, ctx.device)
            _reload(live, fresh)
        line = dict(workload=cell["workload"]["name"], seed=seed,
                    fault=fault)
        if drv == "serve":
            out = Outcome(ctx.shape)
            reqs = serve.window(ctx, eng, out)
            picked = [(r.prompt.tolist(), list(r.generated))
                      for r in serve.sample(ctx, reqs)]
            serve._drain(eng)
            with torch.no_grad():
                line["served_gap"], line["tokens"] = judge.served_gap(
                    fresh, ctx.shape, picked)
                line["control_gap"], _ = judge.control_gap(
                    fresh, ctx.shape, picked)
            line.update(out.e2e)
        else:
            mix = ctx.mix
            B, S = mix["batch"], mix["seqlen"]
            pool = torch.from_numpy(gen.windows(mix, seed,
                                                ctx.shape["vocab"])
                                    ).to(ctx.device)
            wins, prog = [], []
            with torch.inference_mode():
                for j in range(mix["check_windows"]):
                    v = window_nll(model, pool[j * B:(j + 1) * B], ctx.cfg)
                    for b in range(B):
                        wins.append(pool[j * B + b].clone())
                        prog.append(float(v[b]))
            with torch.no_grad():
                ref = judge.window_nll(fresh, ctx.shape, wins)
                low = judge.window_nll(fresh, ctx.shape, wins, "fp8")
            line["nll_gap"] = judge.nll_gap(ref, prog, S)
            line["control_gap"] = judge.nll_gap(ref, low, S)
            line["nll_per_token"] = [r / (S - 1) for r in ref]
        del fresh
        line["s"] = time.time() - t
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        yield line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=("token",), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import spec
    cell = spec.cell(args.workload)
    for k, v in cell["config"].get("env", {}).items():
        os.environ[k] = str(v)
    from quip_tpu_torch.kernels import _build
    _build.build_all(["dequant_matmul_decode", "dequant_matmul_tile",
                      "flash_attn", "rht"])
    sink = open(args.out, "a") if args.out else None
    for line in readings(cell, [int(s) for s in args.seeds.split(",")],
                         args.seconds, fault=args.fault, sink=sink):
        print(json.dumps(line), flush=True)


def _plant_token_fault() -> None:
    """Alter the last token of each chunk row where the pump commits it
    (the fault "a token altered where it is produced")."""
    from quip_tpu_torch.serve import engine as E
    orig = E.Engine._take_tokens

    def take(self, req, toks):
        if toks:
            toks[-1] = (toks[-1] + 1) % self.cfg.vocab_size
        return orig(self, req, toks)
    E.Engine._take_tokens = take


if __name__ == "__main__":
    main()
