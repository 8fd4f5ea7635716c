"""What binds K1-tile, and which plan is fastest (run on the H100):

    python -m quip_tpu_torch.tools.tune_tile [--part ablation|plans|stages]

Part 1, ablation: ``csrc/dequant_matmul_tile.cu`` is compiled as it is and
in copies with parts taken out (their results are wrong, only their times
mean something): the products (every ``wgmma.mma_async`` commented out of
its PTX), the unpack (raw words as the A operand), the exact bf16
subtraction alone, both products and unpack (copies only: dm_prep, the TMA
ring and the epilogue), the copies (the producer completes each stage's
barrier with no bytes: products alone), and all three (what is left: the
launches, dm_prep, the barriers and the epilogue). Each is timed at three
of the 2-bit Llama-2-7B shapes at 32, 600 and 2048 rows through the
wrapper (CUDA-graph replay, plane copies cycling past the L2).

Part 2, plans: ``_tile_plan``'s choice (tokens a block N, fan-in splits)
against its neighbours (N one step either way, 64 and 128; splits 1, half
and twice the rule's) at the five shapes, B = 16, 32, 128, 600, 2048.
Every plan's result is held against the plain version first.

Part 3, stages: the ring's depth, compiled with a shared-memory budget of
100, 150 (the source's) and 200 KB, at the rule's plans, B = 32, 600 and
2048 over the five shapes.
"""
from __future__ import annotations

import argparse
import math

import torch

from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.tools.variants import build, card, rep, source, swapped
from quip_tpu_torch.utils.timing import time_ms

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22528, 4096),
          "wd": (4096, 11008), "lm_head": (32000, 4096)}
BUDGET = "constexpr int kSmemBudget = 150 * 1024;"


def variants(src: str) -> dict:
    no_mma = lambda s: rep(  # noqa: E731
        s, '"wgmma.mma_async.sync.aligned.m64n',
        '"// wgmma.mma_async.sync.aligned.m64n')
    pair = "  uint32_t v = ((w >> sh) & MP) | 0x43004300u;\n"
    no_unpack = lambda s: rep(s, pair, "  return w;\n" + pair)  # noqa: E731

    def no_copies(s):
        s = rep(s, "mbar_expect_tx(&full[slot], bytes);",
                "mbar_expect_tx(&full[slot], 0);")
        s = rep(s, "for (int j = 0; j < 2; ++j)\n",
                "for (int j = 0; j < 0; ++j)\n")
        return rep(s, "tma_load(base + x_bytes(N), wmap,",
                   "if (0) tma_load(base + x_bytes(N), wmap,")
    return {
        "as it is": src,
        "no products": no_mma(src),
        "no unpack": no_unpack(src),
        "no subtraction": rep(src, "  const uint32_t magic = 0x43004300u;\n",
                              "  return v;\n"
                              "  const uint32_t magic = 0x43004300u;\n"),
        "copies only": no_mma(no_unpack(src)),
        "no copies": no_copies(src),
        "none of the three": no_copies(no_mma(no_unpack(src))),
    }


def _build(texts: dict) -> dict:
    """Each source text compiled; name -> C entry."""
    DM._entry_tile()
    return build(texts, "quip_dequant_matmul_tile", DM._fn_tile.argtypes)


def _planes(m, d, gen, dev):
    n = max(1, math.ceil(120e6 / (d * 2 * m // 8)))
    return [(torch.randint(-2 ** 31, 2 ** 31, (d * 2 // 32, m),
                           dtype=torch.int32, generator=gen, device=dev),)
            for _ in range(n)]


def _time(x, copies, scale):
    return time_ms([lambda c=c: DM.dequant_matmul(x, c, scale, None, bits=2)
                    for c in copies], 10)


def ablate(gen, dev, scale):
    fns = _build(variants(source("dequant_matmul_tile.cu")))
    for sname in ("wqkv", "wo", "wd"):
        m, d = SHAPES[sname]
        copies = _planes(m, d, gen, dev)
        for B in (32, 600, 2048):
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            row = []
            for name, f in fns.items():
                with swapped(DM, _fn_tile=f):
                    row.append(f"{name} {_time(x, copies, scale) * 1e3:.1f}")
            print(f"ablation {sname} B={B} plan "
                  f"{DM._tile_plan(B, d, m, 2, 132)}, us: " + " | ".join(row),
                  flush=True)
        del copies
        torch.cuda.empty_cache()


def _neighbours(plan, B, d):
    n, s = plan
    top = -(-B // 16) * 16
    depth = DM._tile_stages(d, 2) // 4
    ns = {n, n - 16, n + 16, 64, 128}
    ss = {s, 1, max(1, s // 2), s * 2}
    return [plan] + sorted((a, b) for a in ns for b in ss
                           if 16 <= a <= min(128, top) and 1 <= b <= depth
                           and (a, b) != plan)


def plans(gen, dev, scale):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for sname, (m, d) in SHAPES.items():
        copies = _planes(m, d, gen, dev)
        for B in (16, 32, 128, 600, 2048):
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            want = DM.dequant_matmul_ref(x.float(), copies[0], scale, None,
                                         bits=2)
            row = []
            for plan in _neighbours(DM._tile_plan(B, d, m, 2, sms), B, d):
                with swapped(DM, _tile_plan=lambda *a, p=plan: p):
                    got = DM.dequant_matmul(x.float(), copies[0], scale,
                                            None, bits=2)
                    rel = ((got - want).abs().max()
                           / want.abs().max()).item()
                    assert rel <= 1e-3, (sname, B, plan, rel)
                    row.append(f"{plan} {_time(x, copies, scale) * 1e3:.1f}")
            print(f"plans {sname} B={B}, us, the rule's first: "
                  + " | ".join(row), flush=True)
        del copies
        torch.cuda.empty_cache()


def stages(gen, dev, scale):
    src = source("dequant_matmul_tile.cu")
    fns = _build({
        f"{kb} KB": rep(src, BUDGET,
                        f"constexpr int kSmemBudget = {kb} * 1024;")
        for kb in (100, 150, 200)})
    sums = {(k, B): 0.0 for k in fns for B in (32, 600, 2048)}
    for sname, (m, d) in SHAPES.items():
        copies = _planes(m, d, gen, dev)
        for B in (32, 600, 2048):
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            for k, f in fns.items():
                with swapped(DM, _fn_tile=f):
                    sums[k, B] += _time(x, copies, scale)
        del copies
        torch.cuda.empty_cache()
    for B in (32, 600, 2048):
        print(f"stages, five shapes B={B}, ms: " + " | ".join(
            f"{k} {sums[k, B]:.4f}" for k in fns), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("ablation", "plans", "stages"),
                    action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_tile: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.02, device=dev)
    print(card())
    parts = args.part or ["ablation", "plans", "stages"]
    for part, fn in (("ablation", ablate), ("plans", plans),
                     ("stages", stages)):
        if part in parts:
            fn(gen, dev, scale)


if __name__ == "__main__":
    main()
