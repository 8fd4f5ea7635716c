"""Sharded serving with a card a rank (NCCL), held to the unsharded model.

    python -m quip_tpu_torch.tools.mesh_check --tp 4 [--dp 1] [--layers 32]
    python -m quip_tpu_torch.tools.mesh_check --model llama-tiny --tp 2 \
        --dp 2 --device cpu          # a rehearsal: gloo ranks, the CPU

Builds the kernels once, then starts dp·tp ranks, one card each, so
``parallel/mesh.py::init_distributed`` picks NCCL. Every rank builds the
same random 2-bit Llama-2-7B (packed head, ``--layers`` of 32 blocks at
the published widths) and serves ``chip_smoke.py`` phase 7's four
requests (prompts 600 / 128 / 37 / 5) through ``Engine(mesh=).run``, then
through the pump (``run(chunked=True)``: its chunk graphs capture the
collectives on NCCL) on a fresh engine, then times b4 decode through the
pump (4 requests of 5 prompt tokens, 64 new tokens against 16, over the
48 steps between). Afterwards
this process holds rank 0's serial tokens to the unsharded model's
teacher-forced forward on card 0 (each token the argmax of its row, or
within 5e-2 of the row's max over its max |logit|, ``chip_smoke.py``'s
SPEC_TOL for bf16 KV) and every rank's pump tokens to its serial ones.
Prints one JSON line (with the card's name and power limit); ``--out``
writes it to a file too. Needs dp·tp cards (``--device cpu`` runs the
same on gloo ranks, f32, for a rehearsal).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from quip_tpu_torch.tools.teacher_forced import exactness, serving_prompts

TOL = 5e-2


def _model(a: dict, dev):
    import dataclasses
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    cfg = get_config(a["model"])
    cfg = dataclasses.replace(cfg, n_layers=a["layers"] or cfg.n_layers)
    dtype = torch.bfloat16 if torch.device(dev).type == "cuda" \
        else torch.float32
    return packed_model(cfg, bits=2, seed=0, dtype=dtype, head_bits=2,
                        device=dev), cfg


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _requests(cfg, new: int):
    """chip_smoke.py phase 7's prompts (each cut to half a small model's
    max_seq, for the rehearsal)."""
    prompts = serving_prompts(cfg.vocab_size)
    return [dict(prompt=prompts[n][:cfg.max_seq // 2], max_new_tokens=new)
            for n in (600, 128, 37, 5)]


def _rank(a: dict) -> dict:
    """One rank: the serial run, the pump run, b4 pump timing."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.parallel import comm
    from quip_tpu_torch.parallel.mesh import make_mesh
    from quip_tpu_torch.serve.engine import Engine
    mesh = make_mesh(dp=a["dp"], tp=a["tp"])
    dev = mesh.device
    model, cfg = _model(a, dev)
    kw = dict(max_batch=4, max_seq=min(1024, cfg.max_seq), hot=32, page=64,
              cache_dtype=model.embed.tokens.dtype, device=dev, mesh=mesh)
    reqs = _requests(cfg, a["new"])
    out = dict(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device))
    for name, chunked in (("serial", False), ("pump", True)):
        eng = Engine(model, cfg, **kw)
        DM.launches = DM.launches_decode = DM.launches_tile = 0
        comm.reset()
        _sync(dev)
        t = time.perf_counter()
        got = eng.run([dict(r) for r in reqs], chunked=chunked)
        _sync(dev)
        out[name] = dict(
            tokens=[r.generated for r in got],
            s=time.perf_counter() - t, k1_decode=DM.launches_decode,
            k1_tile=DM.launches_tile, graphs=len(eng._graphs),
            stats=eng.stats().get("mesh"),
            comm={k: v for k, v in comm.counts().items() if v["count"]})
        del eng
    # b4 decode through the pump: a run of 16 and one of 64 new tokens a
    # slot (after one that builds the graphs); their difference over 48
    # steps leaves the admissions out
    eng = Engine(model, cfg, **kw)

    def b4(new):
        _sync(dev)
        t = time.perf_counter()
        eng.run([dict(prompt=[1, 2, 3, 4, 5], max_new_tokens=new)] * 4,
                chunked=True)
        _sync(dev)
        return time.perf_counter() - t

    b4(64)
    short, long_ = b4(16), b4(64)
    out["b4_pump_ms_a_step"] = (long_ - short) * 1e3 / 48
    out["graphs"] = len(eng._graphs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("quip_tpu_torch.tools.mesh_check")
    ap.add_argument("--model", default="llama-2-7b")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="blocks of the model (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--new", type=int, default=16,
                    help="new tokens a request")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args(argv)
    world = a.tp * a.dp
    smi = None
    if a.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < world:
            raise SystemExit(f"mesh_check needs {world} cards")
        from quip_tpu_torch.cli.common import SERVING_KERNELS
        from quip_tpu_torch.kernels import _build
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        _build.build_all(SERVING_KERNELS)
    from quip_tpu_torch.parallel.mesh import run_ranks
    t = time.time()
    ranks = run_ranks(_rank, world, (vars(a),), device=a.device,
                      timeout_s=1500, collective_timeout_s=300)
    ranks_s = time.time() - t
    model, cfg = _model(vars(a), a.device)
    reqs = _requests(cfg, a.new)
    share, gap = exactness(model, cfg, reqs, ranks[0]["serial"]["tokens"])
    ok = (gap <= TOL
          and all(r["serial"]["tokens"] == ranks[0]["serial"]["tokens"]
                  for r in ranks)
          and all(r["pump"]["tokens"] == r["serial"]["tokens"]
                  for r in ranks))
    out = dict(ok=ok, cards=smi, dp=a.dp, tp=a.tp, layers=a.layers,
               ranks_s=ranks_s, exact_share=share, worst_gap=gap, tol=TOL,
               ranks=[{k: v for k, v in r.items() if k != "tokens"}
                      for r in ranks])
    for r in out["ranks"]:
        for name in ("serial", "pump"):
            r[name] = {k: v for k, v in r[name].items() if k != "tokens"}
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not ok:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
