"""What binds K2, and which key tile and ring depth are fastest (run on
the H100):

    python -m quip_tpu_torch.tools.tune_flash [--part ablation|orders|tiles]
        [--against OTHER.cu]

Part 1, ablation: ``csrc/flash_attn.cu`` is compiled as it is and in
copies with parts taken out (their results are wrong, only their times
mean something): the softmax (scores never scaled, masked or
exponentiated; P stays what it was), the P.V products, the Q.K^T
products, both products and the softmax (copies only: the TMA ring, the
barriers and the epilogue), the K/V copies (the producer completes each
barrier with no bytes), and all of these (what is left: the launch, the
Q copy, the barriers and the epilogue).

Part 2, orders: the consumers' turns as in the source (named barriers:
one warpgroup's softmax under the other's products, and inside a
warpgroup the softmax of the scores under its own P.V), the turns with
both products waited for before the softmax, and no turns (both
warpgroups issue their products as soon as their data is there).

Part 3, tiles: the key tile TK (64, 128, 176 keys) and the ring's depth
(the stages that fit in shared memory beside the 32 KB Q tile: 2 to 4
at 64 keys, 2 and 3 at 128, 2 at 176). Every copy is held against the plain
version first.

Each part times B=2 H=32 S=600 (plen 600, 431), B=1 H=32 S=2048 and B=1
H=32 S=4096 through the wrapper (CUDA-graph replay), and prints each
copy's registers, spills and serialised wgmma (C7513 / C7515) from ptxas.

With ``--against OTHER.cu`` (another source of the same C entry, e.g. an
earlier commit's ``flash_attn.cu`` from ``git show``), both are checked
against the plain version and timed in turns (this, other, other, this)
at chip_smoke.py's phase-3 shapes, and nothing else runs unless a part
is named.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path

import torch

from quip_tpu_torch.kernels import flash_attn as FA
from quip_tpu_torch.tools.variants import build, card, rep, source, swapped
from quip_tpu_torch.utils.timing import time_ms

SHAPES = ((2, 32, 32, 600, (600, 431)), (1, 32, 32, 2048, (2048,)),
          (1, 32, 32, 4096, (4096,)))
# chip_smoke.py's phase-3 shapes (B, H, KV, S, plen)
PHASE3 = ((2, 32, 32, 600, (600, 431)), (2, 64, 8, 600, (600, 431)),
          (1, 32, 32, 1000, (1000,)), (2, 32, 8, 600, (600, 431)),
          (2, 32, 32, 513, (513, 1)), (1, 32, 32, 2048, (2048,)),
          (1, 32, 32, 4096, (4096,)), (1, 64, 8, 2048, (2048,)))
SMEM = 232448                    # shared memory a block can use (bytes)


def _no_softmax(s):
    s = rep(s, "    if (kt + TK > me.q0 + 1 || kt + TK > me.pl)\n"
            "      softmax_scores<true>",
            "    if (true) {\n    } else if (kt + TK > me.q0 + 1 || "
            "kt + TK > me.pl)\n      softmax_scores<true>")
    return rep(s, "    softmax_finish(sc, al, o, p);\n", "")


def _no_pv(s):
    return rep(s, "      wgmma_pv(o, p[kk]", "      if (0) wgmma_pv(o, p[kk]")


def _no_qk(s):
    return rep(s, "      wgmma_ss<TK>(sc,", "      if (0) wgmma_ss<TK>(sc,")


def _no_copies(s):
    for x in ("k", "v"):
        s = rep(s, f"mbar_expect_tx(&full_{x}[s], KV_BYTES);",
                f"mbar_expect_tx(&full_{x}[s], 0);")
    # the K and the V loop (the Q copy's is indented less)
    return rep(s, "      for (int j = 0; j < 2; ++j)\n        tma_load_4d(kt",
               "      for (int j = 0; j < 0; ++j)\n        tma_load_4d(kt")


def variants(src: str) -> dict:
    return {
        "as it is": src,
        "no softmax": _no_softmax(src),
        "no P.V": _no_pv(src),
        "no Q.K^T": _no_qk(src),
        "copies only": _no_softmax(_no_pv(_no_qk(src))),
        "no K/V copies": _no_copies(src),
        "none of these": _no_softmax(_no_pv(_no_qk(_no_copies(src)))),
    }


def orders(src: str) -> dict:
    waited = rep(src, "    wgmma_wait<1>();\n", "    wgmma_wait<0>();\n")
    free = rep(src, "  bar_sync(kTurn + me.c, 256);\n", "")
    free = rep(free, "  if (me.c == 0 || QK) bar_arrive(kTurn + 1 - me.c, "
               "256);\n", "")
    free = rep(free, "    if (c == 1) bar_arrive(kTurn, 256);", "")
    return {"turns, P.V under the softmax": src,
            "turns, both products waited": waited,
            "no turns": free}


def _wgmma_ss(n: int) -> str:
    """The source's wgmma_ss<128> written out for a key tile of n."""
    r = n // 2
    outs = ", ".join(f"%{i}" for i in range(r))
    regs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"template <>\n__device__ __forceinline__ void wgmma_ss<{n}>("
            f"float (&d)[{r}], uint64_t da, uint64_t db, int acc) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, '
            f'0;\\nwgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 '
            f'{{{outs}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {regs}\n      : "l"(da), "l"(db), "r"(acc));\n}}\n')


SPEC = "template <>\n__device__ __forceinline__ void wgmma_ss<128>"


def tiles(src: str) -> dict:
    out = {}
    for tk in (64, 128, 176):
        for stages in (2, 3, 4):
            smem = 128 * 128 * 2 + stages * 2 * tk * 128 * 2 + 1024 + 256
            if smem > SMEM:
                continue
            s = rep(src, "constexpr int TK = 128;", f"constexpr int TK = {tk};")
            if tk != 128:
                s = rep(s, SPEC, _wgmma_ss(tk) + SPEC)
            s = rep(s, "constexpr int STAGES = 2;",
                    f"constexpr int STAGES = {stages};")
            out[f"TK={tk} stages={stages}"] = s
    return out


def _build(texts: dict) -> dict:
    """Each source text compiled; name -> C entry."""
    FA._entry()
    return build(texts, "quip_flash_prefill", FA._fn.argtypes, ptxas=True)


def _inputs(gen, dev, shapes=SHAPES):
    for B, H, KV, S, plen in shapes:
        q = torch.randn(B, S, H, 128, device=dev, generator=gen).bfloat16()
        k = torch.randn(B, S, KV, 128, device=dev, generator=gen).bfloat16()
        v = torch.randn(B, S, KV, 128, device=dev, generator=gen).bfloat16()
        pl = torch.tensor(plen, dtype=torch.int32, device=dev)
        yield f"B={B} H={H} KV={KV} S={S}", (q, k, v, pl)


def _time(args) -> float:
    q, k, v, pl = args
    return time_ms([lambda: FA.flash_prefill_bshd(
        q, k, v, pl, scale=1 / math.sqrt(128))], 20)


def _check(args, what: str) -> float:
    q, k, v, pl = args
    scale = 1 / math.sqrt(128)
    got = FA.flash_prefill_bshd(q, k, v, pl, scale=scale)
    want = FA.flash_prefill_ref(q.float(), k.float(), v.float(), pl,
                                scale=scale)
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 and torch.isfinite(got.float()).all(), (what, err)
    return err


def _table(title, fns, gen, dev, check=False):
    for shape, args in _inputs(gen, dev):
        row = []
        for name, f in fns.items():
            with swapped(FA, _fn=f):
                if check:
                    _check(args, name)
                row.append(f"{name} {_time(args) * 1e3:.1f}")
        print(f"{title} {shape}, us: " + " | ".join(row), flush=True)
        torch.cuda.empty_cache()


def against(other: str, gen, dev):
    """This source against ``other`` at the phase-3 shapes, in turns."""
    fns = _build({"this": source("flash_attn.cu"),
                  "other": Path(other).read_text()})
    for shape, args in _inputs(gen, dev, PHASE3):
        ms = {k: [] for k in fns}
        for name in ("this", "other", "other", "this"):
            with swapped(FA, _fn=fns[name]):
                if not ms[name]:
                    _check(args, name)
                ms[name].append(_time(args))
        print(f"against {shape}, ms: " + " | ".join(
            f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in ms.items()), flush=True)
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("ablation", "orders", "tiles"),
                    action="append")
    ap.add_argument("--against", help="another K2 source to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    print(card())
    if args.against:
        against(args.against, gen, dev)
    parts = args.part or ([] if args.against else
                          ["ablation", "orders", "tiles"])
    src = source("flash_attn.cu")
    if "ablation" in parts:
        _table("ablation", _build(variants(src)), gen, dev)
    if "orders" in parts:
        _table("orders", _build(orders(src)), gen, dev, check=True)
    if "tiles" in parts:
        _table("tiles", _build(tiles(src)), gen, dev, check=True)


if __name__ == "__main__":
    main()
