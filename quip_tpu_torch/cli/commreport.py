"""Communication-volume report for parallel configurations (port of
``quip_tpu/cli/commreport.py``).

    python -m quip_tpu_torch.cli.commreport --tp 4 [--dp 2] [--model llama-2-7b]

quip_tpu compiles the tensor-parallel packed decode step on a virtual CPU
mesh and reads GSPMD's collectives out of the HLO. The port has no HLO: it
starts tp·dp ranks (gloo on the CPU by default, ``--device cuda`` on the
card), builds ``models/build.py::packed_model(head_bits=bits)`` at the
preset's full widths (random codes, the same seed on every rank), shards
it (parallel/mesh.py) and runs one decode step of the serving engine's
paged step, counting every collective the port calls (parallel/comm.py).
The step runs at 2 and then 4 layers; the per-layer volume is the slope,
and the whole model's is extrapolated from it, as quip_tpu does. The
scaling estimate is quip_tpu's roofline with the H100 data sheet's rates
(``--hbm_gbps``, ``--ici_gbps``), and the pipeline section is the
analytic GPipe model (parallel/pipeline.pipeline_comm_bytes).

By the design (ops/qlinear.py, models/model.py) a layer of a packed model
makes 5 all-gathers over tp: the fused qkv projection's output, the
attention output, and the outputs of wo, the fused gate-up and wd; a step
adds one all-gather of the last hidden states over dp (dp > 1) and none
for the replicated head. The counters see calls and bytes; they cannot see
latency, overlap or the link's topology (``not_modeled``). Rank 0 alone
prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from quip_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("quip_tpu_torch.commreport")
    ap.add_argument("--model", default="llama-2-7b")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1,
                    help="decode slots a dp rank holds")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--prefill_seq", type=int, default=2048)
    ap.add_argument("--hbm_gbps", type=float, default=None,
                    help="memory rate (default: the H100 data sheet's)")
    ap.add_argument("--ici_gbps", type=float, default=None,
                    help="link rate each way (default: the H100 data "
                         "sheet's NVLink)")
    ap.add_argument("--device", default="cpu",
                    help="torch device of the ranks (cpu: gloo; cuda: NCCL "
                         "with a card a rank, else gloo)")
    return ap


def _step_report(base, a, n_layers: int, mesh) -> dict:
    """The counters of one decode step of an n-layer sharded model."""
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.parallel import comm
    from quip_tpu_torch.parallel.mesh import init_paged_shard, shard_params
    dev = mesh.device
    cfg = dataclasses.replace(base, n_layers=n_layers, dtype="bfloat16")
    model = shard_params(packed_model(cfg, bits=a.bits, seed=0,
                                      head_bits=a.bits, device=dev),
                         cfg, mesh)
    B = a.batch * a.dp
    caches = init_paged_shard(B, 256, cfg, mesh, dtype=torch.bfloat16,
                              hot=32, page=64, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    with torch.no_grad():
        rep = comm.comm_report(
            lambda: PG.paged_decode_step(model, tok, caches, cfg, page=64))
    rep.pop("result")
    return rep


def main(argv=None):
    a = build_parser().parse_args(argv)
    world = a.tp * a.dp
    if common.needs_ranks(world):
        return common.start_ranks("quip_tpu_torch.cli.commreport", argv,
                                  world, a.device)
    common.join_ranks(a)
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.parallel import comm
    from quip_tpu_torch.parallel.mesh import make_mesh
    from quip_tpu_torch.parallel.pipeline import pipeline_comm_bytes

    base = get_config(a.model)
    mesh = make_mesh(dp=a.dp, tp=a.tp, device=a.device)
    r2 = _step_report(base, a, 2, mesh)
    r4 = _step_report(base, a, 4, mesh)
    per_layer = {
        "wire_bytes": (r4["total_wire_bytes"] - r2["total_wire_bytes"]) / 2,
        "collectives": (r4["n_collectives"] - r2["n_collectives"]) / 2,
    }
    L = base.n_layers
    total_wire = (r2["total_wire_bytes"]
                  + per_layer["wire_bytes"] * (L - 2))
    n_coll = r2["n_collectives"] + per_layer["collectives"] * (L - 2)

    # per-chip memory bytes a decode step: packed weights / tp + the head
    D, F, V = base.d_model, base.d_ff, base.vocab_size
    weight_bits = (D * (base.n_heads + 2 * base.kv_heads) * base.hd
                   + D * base.n_heads * base.hd + 2 * D * F + D * F) \
        * a.bits * L
    head_bits_n = D * V * a.bits
    hbm_bytes = (weight_bits + head_bits_n) / 8 / a.tp
    rates = {k: v for k, v in (("hbm_gbps", a.hbm_gbps),
                               ("ici_gbps", a.ici_gbps)) if v is not None}
    est = comm.scaling_estimate({"total_wire_bytes": total_wire},
                                compute_bytes_per_chip=int(hbm_bytes),
                                **rates)

    out = {
        "config": {"model": a.model, "dp": a.dp, "tp": a.tp,
                   "bits": a.bits, "batch": a.batch * a.dp,
                   "backend": mesh.backend},
        "tp_decode": {
            "collectives_per_step": n_coll,
            "wire_bytes_per_step": total_wire,
            "per_layer": per_layer,
            "per_kind_2layer": r2["per_kind"],
            "largest": sorted(r2["collectives"],
                              key=lambda c: -c["bytes"])[:4],
            "scaling_estimate": est,
        },
        "pp_prefill_gpipe": pipeline_comm_bytes(
            base, batch=max(a.batch, a.microbatches), seq=a.prefill_seq,
            microbatches=a.microbatches, pp=a.pp),
        "not_modeled": "collective latency and setup on real links; "
                       "overlap; host staging time on gloo (its bytes are "
                       "per_kind host_staged); cross-host hops (see "
                       "make_hybrid_mesh for topology)",
    }
    if mesh.rank == 0:
        print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
