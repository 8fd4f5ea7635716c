"""What binds K1′ (the slab-dot kernel), and which plan is fastest (run on
the H100):

    python -m quip_tpu_torch.tools.tune_slabdot

Part 1, ablation: ``csrc/slabdot_matmul.cu`` is compiled as it is and in
copies with one part taken out or changed (the results of the first four
are wrong, only their times mean something): the unpack (raw words as
operands), the products (the operands XOR-ed together instead), both
(copies only: the TMA ring and the consumers' shared-memory reads, nothing
done with the words but an XOR), the other splits' partials (each block
adds its own partials where it would read its cluster's); and, computing
the same function, a ring of 6 stages instead of 3, stages of 16 word
rows instead of 32, and the field shifts as multiply-high on the FMA
pipe. Each
is timed at the microbenchmark's five 2-bit Llama-2-7B shapes, B = 1, at
the smallest legal ``tile_m`` and at the best one of the genuine kernel,
through the wrapper (CUDA-graph replay, plane copies cycling past the
L2), and at wo and wd with one split (8 blocks, one an SM, each walking
512 columns through the whole fan-in): a block's steady rate.

Part 2, plans: the rule's fan-in splits against 1, 2, 4 and 8 at each
shape's legal ``tile_m``, B = 1; every plan is held against the plain
version first.
"""
from __future__ import annotations

import torch

from quip_tpu_torch.kernels import slabdot as SD
from quip_tpu_torch.tools.bench_kernel import SHAPES, legal_tiles, make_case
from quip_tpu_torch.tools.variants import build, card, rep, source
from quip_tpu_torch.utils.timing import time_ms


def variants(src: str) -> dict:
    no_unpack = lambda s: rep(  # noqa: E731
        s, "return ((w >> (FB * k)) & MASK) | 0x43004300u;",
        "return w;")
    # keep the operands alive without the tensor cores: XOR them in
    no_mma = lambda s: rep(  # noqa: E731
        s, '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"',
        '      "{ .reg .b32 v; xor.b32 v, %4, %5; xor.b32 v, v, %6; "\n'
        '      "xor.b32 v, v, %7; xor.b32 v, v, %8; xor.b32 v, v, %9; "\n'
        '      "mov.b32 %0, v; }\\n"')
    stages = lambda n: rep(  # noqa: E731
        src, "constexpr int STAGES = 3;", f"constexpr int STAGES = {n};")
    return {
        "as it is": src,
        "no unpack": no_unpack(src),
        "no products": no_mma(src),
        "copies only": no_mma(no_unpack(src)),
        "own partials only": rep(
            src, "split_sum4(cluster, red, b * chunk_cols + cc, splits)",
            "split_sum4(cluster, red, b * chunk_cols + cc, 1)"),
        "6 stages": stages(6),
        "16-row stages": rep(src, "constexpr int GPS = 4;",
                             "constexpr int GPS = 2;"),
        # the shift on the FMA pipe (multiply-high), the mask on the ALU
        "shifts as multiply-high": rep(
            src, "return ((w >> (FB * k)) & MASK) | 0x43004300u;",
            "return ((k ? __umulhi(w, 1u << (32 - FB * k)) : w) & MASK) | "
            "0x43004300u;"),
    }


def _time(x, copies, scale, tile_m):
    return time_ms([lambda c=c: SD.slabdot_matmul(x, c, scale, bits=2,
                                                  tile_m=tile_m)
                    for c in copies], 20)


def ablate(gen):
    src = source("slabdot_matmul.cu")
    SD._entry()
    genuine, argtypes = SD._fn, SD._fn.argtypes
    fns = build(variants(src), "quip_slabdot_matmul", argtypes)
    sums = {(name, which): 0.0 for name in fns
            for which in ("smallest", "best")}
    try:
        for m, d in SHAPES:
            x, copies, scale = make_case(m, d, 2, 1, gen)
            SD._fn = genuine
            tiles = legal_tiles(m)
            by_tile = {t: _time(x, copies, scale, t) for t in tiles}
            best = min(by_tile, key=by_tile.get)
            row = []
            for name, f in fns.items():
                SD._fn = f
                for which, t in (("smallest", tiles[0]), ("best", best)):
                    us = _time(x, copies, scale, t) * 1e3
                    sums[name, which] += us
                    row.append(f"{name} [{t}] {us:.1f}")
            print(f"ablation {m}x{d} B=1, us: " + " | ".join(row),
                  flush=True)
            del copies
            torch.cuda.empty_cache()
    finally:
        SD._fn = genuine
    for which in ("smallest", "best"):
        print(f"ablation sum of the five shapes, B=1, {which} tile_m, "
              "us: " + " | ".join(f"{name} {sums[name, which]:.1f}"
                                  for name in fns), flush=True)
    # one block an SM, a long walk: 8 blocks of 512 columns, no splits
    rule = SD._plan
    try:
        for m, d in ((4096, 4096), (4096, 11008)):
            x, copies, scale = make_case(m, d, 2, 1, gen)
            SD._plan = lambda *a: (1, 512)
            row = []
            for name, f in fns.items():
                SD._fn = f
                row.append(f"{name} {_time(x, copies, scale, 512) * 1e3:.1f}")
            print(f"ablation {m}x{d} B=1, tile_m=512, one split (8 "
                  "blocks), us: " + " | ".join(row), flush=True)
            del copies
    finally:
        SD._fn, SD._plan = genuine, rule


def plans(gen):
    rule = SD._plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for m, d in SHAPES:
            x, copies, scale = make_case(m, d, 2, 1, gen)
            want = SD.slabdot_matmul_ref(x.float(), copies[0], scale, bits=2)
            for tile_m in legal_tiles(m):
                chosen = rule(m, tile_m, 1, d, [2], sms)
                row = []
                for splits in [chosen[0]] + [s for s in (1, 2, 4, 8)
                                             if s != chosen[0]]:
                    SD._plan = lambda *a, p=(splits, chosen[1]): p
                    got = SD.slabdot_matmul(x.float(), copies[0], scale,
                                            bits=2, tile_m=tile_m)
                    rel = ((got - want).abs().max()
                           / want.abs().max()).item()
                    assert rel <= 1e-3, (m, d, tile_m, splits, rel)
                    us = _time(x, copies, scale, tile_m) * 1e3
                    row.append(f"{splits} {us:.1f}")
                print(f"plans {m}x{d} tile_m={tile_m} B=1, splits: us, the "
                      "rule's first: " + " | ".join(row), flush=True)
            del copies
            torch.cuda.empty_cache()
    finally:
        SD._plan = rule


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_slabdot: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    print(card())
    ablate(gen)
    plans(gen)


if __name__ == "__main__":
    main()
