"""What binds K1-decode, and which plan is fastest (run on the H100):

    python -m quip_tpu_torch.tools.tune_decode
        [--part ablation|plans|stages] [--against OLD.cu]

Part 1, ablation: ``csrc/dequant_matmul_decode.cu`` is compiled as it is and
in copies with one part taken out or changed (the results of the first
three are wrong, only their times mean something): the unpack (raw words
as operands), the products (the operands XOR-ed together instead of
wgmma), both (copies only: the ring, its barriers, x's staging and the
epilogue), and, computing the same function: no programmatic dependent
launch; the ring 2 and 6 slots of 16 word rows deep instead of 4, and 8
and 12 slots of 8 rows; boxes of 128 columns (rows unpadded: 4-way bank
conflicts on the consumers' reads); one register set (each batch's
products waited for before the next batch is unpacked: no overlap of the
unpack with the tensor cores); 4 register sets (3 batches in flight);
batches of 4 fields; the runs' shifts as multiply-high on the FMA pipe;
and the splits' partials read from the block's own shared memory only
(wrong when splits > 1: what the cluster reduction costs). Each is timed
at the five 2-bit Llama-2-7B shapes, 1 and 8 rows, through the wrapper
(CUDA-graph replay, plane copies cycling past the L2), and ptxas's
registers, spills and serialised wgmma (C7513 / C7515) are printed.

Part 2, plans: ``_decode_plan``'s choice of fan-in splits against 1 to 8
splits, at the five shapes, B = 1, 4 and 8. Every plan's result is held
against the plain version first.

Part 3, stages (not run by default): a copy of the source as it is and of
its copies-only ablation, each with clock64 stamps at a block's entry,
after griddepcontrol.wait, after x's staging, after the walk and at the
end, and the clocks its consumers spent waiting on full slots and on
wgmma; the block means over a graph replay of every plane copy (and each
block's first stamp and last on the global timer: their spread) at the
five shapes, B = 1 and 8.

With ``--against OLD.cu`` (an earlier K1-decode source of the mma.sync
design, e.g. ``git show ed5595d:quip_tpu_torch/kernels/csrc/
dequant_matmul_decode.cu`` into ``_checkout/``), both are held against the
plain version and timed in turns (this, other, other, this) at the five
shapes, B = 1, 4 and 8, and nothing else runs unless a part is named. The
old source takes (warps a block, splits) where this one takes (ragged,
splits); its calls go through ``_mma_sync_plan``, the plan rule that
shipped with it.
"""
from __future__ import annotations

import argparse
import ctypes
import math
from pathlib import Path

import torch

from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.pack.format import PLANE_SPLITS
from quip_tpu_torch.tools.variants import build, card, rep, source, swapped
from quip_tpu_torch.utils.timing import time_ms

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22528, 4096),
          "wd": (4096, 11008), "lm_head": (32000, 4096)}
SPLITS = (1, 2, 3, 4, 5, 6, 7, 8)
ROWS = (1, 8)
SMEM = 220 * 1024           # dynamic shared memory the kernel asks for


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
    rows8 = lambda n: rep(  # noqa: E731
        stages(n), "constexpr int GPS = 2;", "constexpr int GPS = 1;")
    return {
        "as it is": src,
        "no unpack": no_unpack(src),
        "no products": no_mma(src),
        "copies only": no_mma(no_unpack(src)),
        "no PDL": rep(src, "cfg.numAttrs = 2;", "cfg.numAttrs = 1;"),
        "2 slots": stages(2),
        "6 slots": stages(6),
        "8 slots of 8 rows": rows8(8),
        "12 slots of 8 rows": rows8(12),
        "unpadded rows": rep(src, "constexpr int SROW = 136;",
                             "constexpr int SROW = 128;"),
        # the run's shift on the FMA pipe (multiply-high), beside the masks
        # on the ALU pipe
        "shifts as multiply-high": rep(
            src, "wr[gi][hh][2 * mt + h] >> (FB * FG * (k / FG))",
            "(k / FG ? __umulhi(wr[gi][hh][2 * mt + h], 1u << (32 - FB * FG "
            "* (k / FG))) : wr[gi][hh][2 * mt + h])"),
        "batches waited": rep(src, "constexpr int NSETS = 2;",
                              "constexpr int NSETS = 1;"),
        "4 register sets": rep(src, "constexpr int NSETS = 2;",
                               "constexpr int NSETS = 4;"),
        "batches of 4 fields": rep(src, "constexpr int FPB_MAX = 2;",
                                   "constexpr int FPB_MAX = 4;"),
        "own partials only": rep(
            src, "split_sum4(cluster, red, b * BN + cc, splits)",
            "split_sum4(cluster, red, b * BN + cc, 1)"),
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


def _check(x, planes, scale, what):
    want = DM.dequant_matmul_ref(x.float(), planes, scale, None, bits=2)
    got = DM.dequant_matmul(x.float(), planes, scale, None, bits=2,
                            path="decode")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-3, (what, rel)


def _build(texts: dict) -> dict:
    DM._entry_decode()
    return build(texts, "quip_dequant_matmul_decode", DM._fn_decode.argtypes,
                 ptxas=True)


def ablate(gen, dev, scale):
    fns = _build(variants(source("dequant_matmul_decode.cu", headers=True)))
    sums = {(name, B): 0.0 for name in fns for B in ROWS}
    for sname, (m, d) in SHAPES.items():
        copies = _planes(m, d, gen, dev)
        for B in ROWS:
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            row = []
            for name, f in fns.items():
                with swapped(DM, _fn_decode=f):
                    us = _time(x, copies, scale) * 1e3
                sums[name, B] += us
                row.append(f"{name} {us:.1f}")
            print(f"ablation {sname} B={B}, us: " + " | ".join(row),
                  flush=True)
        del copies
        torch.cuda.empty_cache()
    for B in ROWS:
        print(f"ablation sum of the five shapes B={B}, us: " + " | ".join(
            f"{name} {sums[name, B]:.1f}" for name in fns), flush=True)


def plans(gen, dev, scale):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for sname, (m, d) in SHAPES.items():
        copies = _planes(m, d, gen, dev)
        for B in (1, 4, 8):
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            chosen = DM._decode_plan(B, d, m, 2, sms)
            row = []
            for plan in [chosen] + [s for s in SPLITS if s != chosen]:
                if DM._decode_smem(B, d, 2, plan) > SMEM:
                    continue            # x's staged rows do not fit
                with swapped(DM, _decode_plan=lambda *a, plan=plan: plan):
                    _check(x, copies[0], scale, (sname, B, plan))
                    row.append(f"{plan} {_time(x, copies, scale) * 1e3:.1f}")
            print(f"plans {sname} B={B}, us, the rule's first: "
                  + " | ".join(row), flush=True)
        del copies
        torch.cuda.empty_cache()


def _stamped(src: str) -> str:
    """``src`` with the stage stamps of part 3 and a C entry
    ``decode_stamps`` that copies them out (12 per block: clocks at entry,
    wait, staged, walked, end; full-slot and wgmma waits; global timer at
    entry and end)."""
    s = ("__device__ unsigned long long g_st[8192][12];\n"
            "__device__ __forceinline__ unsigned long long clk() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t));\n"
            "  return t;\n}\n"
            "__device__ __forceinline__ unsigned long long gtime() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n") + src
    waits = "unsigned long long& wf, unsigned long long& ww"
    s = rep(s, "    uint32_t cm16, uint32_t fstep, int lane, uint32_t e128) {",
            "    uint32_t cm16, uint32_t fstep, int lane, uint32_t e128, "
            + waits + ") {")
    s = rep(s, "    mbar_wait(&full[slot], (it / STAGES) & 1);",
            "    { const auto t0 = clk();\n"
            "      mbar_wait(&full[slot], (it / STAGES) & 1);\n"
            "      wf += clk() - t0; }")
    s = rep(s, "        wgmma_wait<NSETS - 1>();",
            "        { const auto t0 = clk(); wgmma_wait<NSETS - 1>();\n"
            "          ww += clk() - t0; }")
    s = rep(s, "    uint64_t* empty, float pw0, float pw1, int lane, "
            "uint32_t e128) {",
            "    uint64_t* empty, float pw0, float pw1, int lane, "
            "uint32_t e128, " + waits + ") {")
    s = s.replace("lane, e128);", "lane, e128, wf, ww);")
    s = rep(s, "  const int cb = blockIdx.x, split = blockIdx.y;\n",
            "  const int cb = blockIdx.x, split = blockIdx.y;\n"
            "  unsigned long long T[12] = {0}, wf = 0, ww = 0;\n"
            "  T[0] = clk();\n  T[10] = gtime();\n")
    s = rep(s, "    grid_dep_wait();                     // x and out belong",
            "    grid_dep_wait();\n    T[1] = clk();  // x and out belong")
    s = rep(s, "    fence_proxy_async();                 // wgmma reads",
            "    T[2] = clk();\n    fence_proxy_async();  // wgmma reads")
    s = rep(s, "lane, e128, wf, ww);\n    grid_dep_launch();",
            "lane, e128, wf, ww);\n    T[3] = clk();\n    grid_dep_launch();")
    s = rep(s, "  if (splits > 1) cluster.sync();      // nobody leaves while "
            "it is still read\n}",
            "  if (splits > 1) cluster.sync();\n"
            "  T[4] = clk();\n  T[11] = gtime();\n  T[5] = wf;\n  T[6] = ww;\n"
            "  const int bid = blockIdx.x + gridDim.x * blockIdx.y;\n"
            "  if (tid == 0 && bid < 8192)\n"
            "    for (int i = 0; i < 12; ++i) g_st[bid][i] = T[i];\n}")
    return s + ("\nextern \"C\" int decode_stamps(void* dst) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_st, sizeof(g_st));"
                "\n}\n")


def stages(gen, dev, scale):
    texts = {name: _stamped(text) for name, text in
             variants(source("dequant_matmul_decode.cu", headers=True)).items()
             if name in ("as it is", "copies only")}
    fns = _build(texts)
    buf = torch.zeros(8192 * 12, dtype=torch.int64)
    for sname, (m, d) in SHAPES.items():
        copies = _planes(m, d, gen, dev)
        for B in ROWS:
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            for name, f in fns.items():
                with swapped(DM, _fn_decode=f):
                    _time(x, copies, scale)
                    f.lib.decode_stamps(ctypes.c_void_p(buf.data_ptr()))
                n = -(-m // DM.DECODE_BN) * DM._decode_plan(B, d, m, 2, 132)
                t = buf.view(8192, 12)[:n].double()
                mean = lambda a, b: (t[:, b] - t[:, a]).mean().item()  # noqa
                t0 = t[:, 10].min()
                print(f"stages {sname} B={B} {name}: {n} blocks; clocks: "
                      f"entry to wait {mean(0, 1):.0f}, x staged "
                      f"{mean(1, 2):.0f}, sums and walk {mean(2, 3):.0f}, "
                      f"epilogue {mean(3, 4):.0f}, all {mean(0, 4):.0f}; "
                      f"waiting on slots {t[:, 5].mean().item():.0f}, on "
                      f"wgmma {t[:, 6].mean().item():.0f}; first stamps "
                      f"within {(t[:, 10].max() - t0).item() / 1e3:.2f} us, "
                      f"last {(t[:, 11].min() - t0).item() / 1e3:.2f} .. "
                      f"{(t[:, 11].max() - t0).item() / 1e3:.2f} us",
                      flush=True)
        del copies
        torch.cuda.empty_cache()


def _mma_sync_plan(B, d, m_p, bits, sms):
    """(warps a block, splits) as the mma.sync K1-decode (PR 4-16) chose
    them: 4 warps of 32 columns (8 from 4 rows on); about 12 warps an SM
    by the splits, an even divisor of the groups of 8 word rows within a
    factor 1.5 preferred; x's staged rows (padded to 4 mod 32 words) within
    48 KB."""
    nwarps = 8 if B >= 4 else 4
    groups = [DM.decode_groups(d, fb) for fb, _ in PLANE_SPLITS[bits]]
    most = min(8, min(groups))
    want = 12 * sms / nwarps / -(-m_p // (32 * nwarps))
    s = max(1, min(most, round(want)))
    even = [c for c in range(1, most + 1)
            if all(g % c == 0 for g in groups) and want / 1.5 <= c <= want * 1.5]
    if even:
        s = min(even, key=lambda c: abs(math.log(c / want)))

    def smem(s):
        out = 0
        for g, (fb, _) in zip(groups, PLANE_SPLITS[bits]):
            w = -(-g // s) * (16 // fb) * 8
            out = max(out, B * (w + (4 - w % 32) % 32) * 4)
        return out

    while smem(s) > 48 * 1024 and s < most:
        s += 1
    return nwarps, s


def _mma_sync_entry(path: str):
    """The old source's C entry behind this source's argument list."""
    old = build({"other": Path(path).read_text()},
                "quip_dequant_matmul_decode",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p])["other"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(x, is_bf16, B, d, p0, fb0, p1, fb1, nplanes, pw0, pw1, m_p,
             ragged, splits, qfn_b, maxq, sc, ze, out, stream):
        bits = {(2, 0): 2, (2, 1): 3, (4, 0): 4, (4, 4): 8}[fb0, fb1]
        nwarps, s = _mma_sync_plan(B, d, m_p, bits, sms)
        return old(x, is_bf16, B, d, p0, fb0, p1, fb1, nplanes, pw0, pw1,
                   m_p, nwarps, s, qfn_b, maxq, sc, ze, out, stream)
    return call


def against(other: str, gen, dev, scale):
    """This source against ``other`` at the five shapes, in turns."""
    DM._entry_decode()
    fns = {"this": DM._fn_decode, "other": _mma_sync_entry(other)}
    sums = {(k, B): [0.0, 0.0] for k in fns for B in (1, 4, 8)}
    for sname, (m, d) in SHAPES.items():
        copies = _planes(m, d, gen, dev)
        for B in (1, 4, 8):
            x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
            ms = {k: [] for k in fns}
            for name in ("this", "other", "other", "this"):
                with swapped(DM, _fn_decode=fns[name]):
                    if not ms[name]:
                        _check(x, copies[0], scale, (name, sname, B))
                    ms[name].append(_time(x, copies, scale))
            for k, v in ms.items():
                sums[k, B][0] += v[0]
                sums[k, B][1] += v[1]
            print(f"against {sname} B={B}, ms: " + " | ".join(
                f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in ms.items()),
                flush=True)
        del copies
        torch.cuda.empty_cache()
    for B in (1, 4, 8):
        print(f"against sum of the five shapes B={B}, ms: " + " | ".join(
            f"{k} {sums[k, B][0]:.4f} {sums[k, B][1]:.4f}" for k in fns),
            flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("ablation", "plans", "stages"),
                    action="append")
    ap.add_argument("--against", help="the mma.sync K1-decode source")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_decode: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.02, device=dev)
    print(card())
    if args.against:
        against(args.against, gen, dev, scale)
    parts = args.part or ([] if args.against else ["ablation", "plans"])
    if "ablation" in parts:
        ablate(gen, dev, scale)
    if "plans" in parts:
        plans(gen, dev, scale)
    if "stages" in parts:
        stages(gen, dev, scale)


if __name__ == "__main__":
    main()
