"""What binds K1′ (the slab-dot kernel), and which plan is fastest (run on
the H100):

    python -m quip_tpu_torch.tools.tune_slabdot
        [--part ablation|plans] [--against OLD.cu]

Part 1, ablation: ``csrc/slabdot_matmul.cu`` (with the device code it
shares with K1-decode in ``csrc/decode_common.cuh``) is compiled as it is
and in copies with one part taken out or changed (the results of the first
three are wrong, only their times mean something): the unpack (the
shifted words as operands, no mask), the products (the operands XOR-ed
together instead of wgmma), both (copies only: the TMA ring, its barriers,
x's staging and the epilogue); and, computing the same function: no
programmatic dependent launch (each call's prologue then waits for the
call before to end: the timings replay a chain of calls in one graph);
one register set (each batch's products waited for before the next batch
is unpacked: no overlap of the unpack with the tensor cores); a ring of 2
and of 6 slots of 16 word rows instead of 4, and of 8 slots of 8 rows;
one accumulator set a plane instead of two; three blocks an SM instead of
two (registers capped to fit, the plan's splits filling three); batches
of 4 fields instead of 2; the field's shift as a multiply-high on the FMA
pipe; and the splits' partials read from the block's own shared memory
only (wrong when splits > 1: what the cluster reduction costs). Each is
timed at the microbenchmark's five 2-bit Llama-2-7B shapes, B = 1, at the
smallest legal ``tile_m`` and at the best one of the genuine kernel,
through the wrapper (CUDA-graph replay, plane copies cycling past the
L2), and ptxas's registers, spills and serialised wgmma (C7513 / C7515)
are printed.

Part 2, plans: the rule's fan-in splits against 1 to 8 at each shape's
legal ``tile_m``, B = 1, and the rule's blocks an SM (the grid the
splits fill) at 2, 3 and 4; every plan is held against the plain version
first.

With ``--against OLD.cu`` (the mma.sync K1′ of an earlier commit, e.g.
``git show b73987d:quip_tpu_torch/kernels/csrc/slabdot_matmul.cu`` into
``_checkout/``), both are held against the plain version and timed in
turns (this, other, other, this) at the five shapes, B = 1, every legal
``tile_m``, and nothing else runs unless a part is named. The old source
takes the same arguments; its calls go through ``_mma_sync_plan``, the
plan rule that shipped with it.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path

import torch

from quip_tpu_torch.kernels import slabdot as SD
from quip_tpu_torch.kernels.dequant_matmul import decode_groups
from quip_tpu_torch.tools.bench_kernel import SHAPES, legal_tiles, make_case
from quip_tpu_torch.tools.variants import build, card, rep, source, swapped
from quip_tpu_torch.utils.timing import time_ms


def variants(src: str) -> dict:
    no_unpack = lambda s: rep(  # noqa: E731
        s, '"lop3.b32 %0, %1, %2, %3, 0xEA;\\n"', '"mov.b32 %0, %1;\\n"')
    # keep the operands alive without the tensor cores: XOR them in
    no_mma = lambda s: rep(  # noqa: E731
        s, '      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, dd, p, 1, 1, 0;\\n}\\n"',
        '      "{ .reg .b32 v; xor.b32 v, %4, %5; xor.b32 v, v, %6; "\n'
        '      "xor.b32 v, v, %7; mov.b32 %0, v; }\\n}\\n"')
    stages = lambda n, s=src: rep(  # noqa: E731
        s, "constexpr int STAGES = 4;", f"constexpr int STAGES = {n};")
    return {
        "as it is": src,
        "no unpack": no_unpack(src),
        "no products": no_mma(src),
        "copies only": no_mma(no_unpack(src)),
        "no PDL": rep(src, "cfg.numAttrs = 2;", "cfg.numAttrs = 1;"),
        "batches waited": rep(src, "constexpr int NSETS = 2;",
                              "constexpr int NSETS = 1;"),
        "2 slots": stages(2),
        "6 slots": stages(6),
        "8 slots of 8 rows": rep(stages(8), "constexpr int GPS = 2;",
                                 "constexpr int GPS = 1;"),
        "one accumulator set": rep(src, "constexpr int ASETS = 2;",
                                   "constexpr int ASETS = 1;"),
        "3 blocks an SM": rep(src, "constexpr int MIN_BLOCKS = 2;",
                              "constexpr int MIN_BLOCKS = 3;"),
        "batches of 4 fields": rep(src, "constexpr int FPB_MAX = 2;",
                                   "constexpr int FPB_MAX = 4;"),
        # the field's shift on the FMA pipe (multiply-high), the mask on
        # the ALU pipe: the same values
        "shifts as multiply-high": rep(
            src, "wr[gi][hh][2 * mt + h] >> (FB * FG * (k / FG))",
            "(k / FG ? __umulhi(wr[gi][hh][2 * mt + h], 1u << (32 - FB * FG "
            "* (k / FG))) : wr[gi][hh][2 * mt + h])"),
        "own partials only": rep(
            src, "split_sum4(cluster, red, b * chunk_cols + cc, splits)",
            "split_sum4(cluster, red, b * chunk_cols + cc, 1)"),
    }


def _time(x, copies, scale, tile_m):
    return time_ms([lambda c=c: SD.slabdot_matmul(x, c, scale, bits=2,
                                                  tile_m=tile_m)
                    for c in copies], 20)


def _check(x, planes, scale, tile_m, what):
    want = SD.slabdot_matmul_ref(x.float(), planes, scale, bits=2)
    got = SD.slabdot_matmul(x.float(), planes, scale, bits=2, tile_m=tile_m)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-3, (what, rel)


def ablate(gen):
    SD._entry()
    fns = build(variants(source("slabdot_matmul.cu", headers=True)),
                "quip_slabdot_matmul", SD._fn.argtypes, ptxas=True)
    genuine = SD._fn
    sums = {(name, which): 0.0 for name in fns
            for which in ("smallest", "best")}
    for m, d in SHAPES:
        x, copies, scale = make_case(m, d, 2, 1, gen)
        tiles = legal_tiles(m)
        by_tile = {t: _time(x, copies, scale, t) for t in tiles}
        best = min(by_tile, key=by_tile.get)
        row = []
        for name, f in fns.items():
            with swapped(SD, _fn=f, BLOCKS_PER_SM=3 if "3 blocks" in name
                         else SD.BLOCKS_PER_SM):
                for which, t in (("smallest", tiles[0]), ("best", best)):
                    us = _time(x, copies, scale, t) * 1e3
                    sums[name, which] += us
                    row.append(f"{name} [{t}] {us:.1f}")
        print(f"ablation {m}x{d} B=1, us: " + " | ".join(row), flush=True)
        del copies
        torch.cuda.empty_cache()
    assert SD._fn is genuine
    for which in ("smallest", "best"):
        print(f"ablation sum of the five shapes, B=1, {which} tile_m, "
              "us: " + " | ".join(f"{name} {sums[name, which]:.1f}"
                                  for name in fns), flush=True)


def plans(gen):
    rule = SD._plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, d in SHAPES:
        x, copies, scale = make_case(m, d, 2, 1, gen)
        for tile_m in legal_tiles(m):
            chosen = rule(m, tile_m, 1, d, [2], sms)
            row = []
            for splits in [chosen[0]] + [s for s in range(1, 9)
                                         if s != chosen[0]]:
                with swapped(SD, _plan=lambda *a, p=(splits, chosen[1]): p):
                    _check(x, copies[0], scale, tile_m, (m, d, tile_m,
                                                         splits))
                    us = _time(x, copies, scale, tile_m) * 1e3
                row.append(f"{splits} {us:.1f}")
            print(f"plans {m}x{d} tile_m={tile_m} B=1, splits: us, the "
                  "rule's first: " + " | ".join(row), flush=True)
        del copies
        torch.cuda.empty_cache()
    for per_sm in (2, 3, 4):
        total = 0.0
        with swapped(SD, BLOCKS_PER_SM=per_sm):
            for m, d in SHAPES:
                x, copies, scale = make_case(m, d, 2, 1, gen)
                total += min(_time(x, copies, scale, t)
                             for t in legal_tiles(m)) * 1e3
                del copies
        print(f"plans BLOCKS_PER_SM={per_sm}: sum of the five shapes at "
              f"their best tile_m, B=1, {total:.1f} us", flush=True)


def _mma_sync_plan(m, tile_m, B, d, fbs, sms):
    """(splits, chunk_cols) as the mma.sync K1′ chose them: its
    ring of 3 stages of 32 word rows by 136 words, x staged as rows of
    words padded to 4 mod 32; four blocks an SM."""
    rows = min(8, B)
    chunk_cols = 128 * max(1, min(tile_m // 128, 32768 // (rows * 512)))
    most = min(8, min(decode_groups(d, fb) for fb in fbs))
    col_blocks = (m // tile_m) * -(-B // 8)
    want = max(1, min(most, math.ceil(4 * sms / col_blocks)))
    splits = 1 << (want.bit_length() - 1)

    def smem(s):
        out = 128 + 4 * 3 * 32 * 136 + 4 * rows * chunk_cols
        for fb in fbs:
            w = -(-decode_groups(d, fb) // s) * (16 // fb) * 8
            out += 4 * rows * (w + (4 - w % 32) % 32)
        return out

    while smem(splits) > 220 * 1024:
        splits *= 2
    return splits, chunk_cols


def against(other: str, gen):
    """This source against ``other`` at the five shapes, in turns."""
    SD._entry()
    fns = {"this": (SD._fn, SD._plan),
           "other": (build({"other": Path(other).read_text()},
                           "quip_slabdot_matmul", SD._fn.argtypes)["other"],
                     _mma_sync_plan)}
    sums = {k: [0.0, 0.0] for k in fns}
    for m, d in SHAPES:
        x, copies, scale = make_case(m, d, 2, 1, gen)
        best = {}
        for tile_m in legal_tiles(m):
            ms = {k: [] for k in fns}
            for name in ("this", "other", "other", "this"):
                f, plan = fns[name]
                with swapped(SD, _fn=f, _plan=plan):
                    if not ms[name]:
                        _check(x, copies[0], scale, tile_m, (name, m, d))
                    ms[name].append(_time(x, copies, scale, tile_m))
            for k, v in ms.items():
                best[k] = [min(a, b) for a, b in zip(best.get(k, v), v)]
            print(f"against {m}x{d} tile_m={tile_m} B=1, ms: " + " | ".join(
                f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in ms.items()),
                flush=True)
        for k in fns:
            sums[k][0] += best[k][0]
            sums[k][1] += best[k][1]
        del copies
        torch.cuda.empty_cache()
    print("against sum of the five shapes at each one's best tile_m, B=1, "
          "ms: " + " | ".join(f"{k} {v[0]:.4f} {v[1]:.4f}"
                              for k, v in sums.items()), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("ablation", "plans"),
                    action="append")
    ap.add_argument("--against", help="the mma.sync K1′ source")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_slabdot: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    print(card())
    if args.against:
        against(args.against, gen)
    parts = args.part or ([] if args.against else ["ablation", "plans"])
    if "ablation" in parts:
        ablate(gen)
    if "plans" in parts:
        plans(gen)


if __name__ == "__main__":
    main()
