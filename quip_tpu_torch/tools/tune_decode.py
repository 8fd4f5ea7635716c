"""What binds K1-decode, and which fan-in split is fastest (run on the H100):

    python -m quip_tpu_torch.tools.tune_decode

Part 1, ablation: ``csrc/dequant_matmul_decode.cu`` is compiled as it is and
in copies with one part taken out or changed (the results of the first four
are wrong, only their times mean something): the unpack (raw words as
operands), the products, both (copies only: the plane words are loaded and
nothing is done with them but an XOR), the last block's reduction, and the
words in flight per warp (2 and 8 groups instead of 4) and one chain of
products per m-tile instead of two, which compute the same
function. Each is timed at the five
2-bit Llama-2-7B shapes, 1 and 8 rows, through the wrapper (CUDA-graph
replay, plane copies cycling past the L2).

Part 2, plans: ``_decode_plan``'s choice (warps per block, fan-in splits)
against 4 and 8 warps at fixed numbers of splits, at the five shapes, B = 1,
4 and 8. Every plan's result is held against the plain version first.
"""
from __future__ import annotations

import math

import torch

from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.tools.variants import build, card, rep, source
from quip_tpu_torch.utils.timing import time_ms

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22528, 4096),
          "wd": (4096, 11008), "lm_head": (32000, 4096)}
SPLITS = (1, 2, 3, 4, 5, 6, 8)
ROWS = (1, 8)


def variants(src: str) -> dict:
    no_unpack = rep(
        src, "return (w_run & (MP << (FB * r))) | 0x43004300u;",
        "return w_run;")
    # keep the loaded words alive without the tensor cores: XOR them in
    no_mma = lambda s: rep(  # noqa: E731
        s, '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"',
        '      "{ .reg .b32 v; xor.b32 v, %4, %5; xor.b32 v, v, %6; "\n'
        '      "xor.b32 v, v, %7; xor.b32 v, v, %8; xor.b32 v, v, %9; "\n'
        '      "mov.b32 %0, v; }\\n"')

    def no_cluster(s):                  # every block finishes its own part
        for old, new in (
                ("if (splits > 1) cluster.sync(); else __syncthreads();",
                 "__syncthreads();"),
                ("splits > 1 ? *cluster.map_shared_rank(sums + tid, y) : "
                 "sums[tid]", "sums[tid]"),
                ("(splits > 1 ? cluster.map_shared_rank(red, y0 + u) : red)",
                 "red"),
                ("if (splits > 1) cluster.sync();      // nobody", "// nobody")):
            s = rep(s, old, new)
        return s

    return {
        "as it is": src,
        "no unpack": no_unpack,
        "no products": no_mma(src),
        "copies only": no_mma(no_unpack),
        "no reduction": no_cluster(src),
        "2 groups in flight": rep(src, "constexpr int DEPTH = 4;",
                                  "constexpr int DEPTH = 2;"),
        "8 groups in flight": rep(src, "constexpr int DEPTH = 4;",
                                  "constexpr int DEPTH = 8;"),
        "one chain of products": rep(src, "(k & 1) ? odd[q] : acc[q]",
                                     "acc[q]"),
    }


def _planes(m, d, gen, dev):
    n = max(1, math.ceil(120e6 / (d * 2 * m // 8)))
    return [(torch.randint(-2 ** 31, 2 ** 31, (d * 2 // 32, m),
                           dtype=torch.int32, generator=gen, device=dev),)
            for _ in range(n)]


def _time(x, copies, scale):
    return time_ms([lambda c=c: DM.dequant_matmul(x, c, scale, None, bits=2,
                                                  path="decode")
                    for c in copies], 20)


def ablate(gen, dev, scale):
    src = source("dequant_matmul_decode.cu")
    DM._entry_decode()
    genuine, argtypes = DM._fn_decode, DM._fn_decode.argtypes
    fns = build(variants(src), "quip_dequant_matmul_decode", argtypes)
    sums = {(name, B): 0.0 for name in fns for B in ROWS}
    try:
        for sname, (m, d) in SHAPES.items():
            copies = _planes(m, d, gen, dev)
            for B in ROWS:
                x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
                row = []
                for name, f in fns.items():
                    DM._fn_decode = f
                    us = _time(x, copies, scale) * 1e3
                    sums[name, B] += us
                    row.append(f"{name} {us:.1f}")
                print(f"ablation {sname} B={B}, us: " + " | ".join(row),
                      flush=True)
            del copies
            torch.cuda.empty_cache()
    finally:
        DM._fn_decode = genuine
    for B in ROWS:
        print(f"ablation sum of the five shapes B={B}, us: " + " | ".join(
            f"{name} {sums[name, B]:.1f}" for name in fns), flush=True)


def plans(gen, dev, scale):
    rule = DM._decode_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for sname, (m, d) in SHAPES.items():
            copies = _planes(m, d, gen, dev)
            for B in (1, 4, 8):
                x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
                want = DM.dequant_matmul_ref(x.float(), copies[0], scale,
                                             None, bits=2)
                chosen = rule(B, d, m, 2, sms)
                row = []
                for plan in [chosen] + [(w, s) for w in (4, 8) for s in SPLITS
                                        if (w, s) != chosen]:
                    if B * DM._row_words(-(-DM._decode_groups(d, 2)
                                           // plan[1]), 8) * 4 > 64 * 1024:
                        continue            # x's staged rows do not fit
                    DM._decode_plan = lambda *a, plan=plan: plan
                    got = DM.dequant_matmul(x.float(), copies[0], scale, None,
                                            bits=2, path="decode")
                    rel = ((got - want).abs().max() / want.abs().max()).item()
                    assert rel <= 1e-3, (sname, B, plan, rel)
                    row.append(f"{plan} {_time(x, copies, scale) * 1e3:.1f}")
                print(f"plans {sname} B={B}, us, the rule's first: "
                      + " | ".join(row), flush=True)
            del copies
            torch.cuda.empty_cache()
    finally:
        DM._decode_plan = rule


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_decode: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.02, device=dev)
    print(card())
    ablate(gen, dev, scale)
    plans(gen, dev, scale)


if __name__ == "__main__":
    main()
