"""What binds K3's bf16 kernel (run on the H100):

    python -m quip_tpu_torch.tools.tune_rht
        [--part ablation|stages|chain] [--against OLD.cu]

Part 1, ablation: ``csrc/rht.cu`` is compiled as it is and in copies with
one part taken out or changed: no programmatic dependent launch; both
products replaced by XORs of their register operands (wrong results: what
the copies, barriers and stores cost alone).
Each copy's ptxas registers, spills and serialised wgmma are printed, and
each is timed at the six (n, direction) pairs of a Llama-2-7B decode step
and OPT-6.7B's five, B = 1 and 32, every call alone in a CUDA graph and,
the way a decode step meets it, K3 -> K1-decode -> K3 for each of a
Llama-2-7B layer's four linears in one graph (part 3's chain).

Part 2, stages: a copy of the source with clock64 stamps taken by thread 0
of every block (``RHT_STAMP``): at entry, after griddepcontrol.wait, once
the operands are in, once the first 64 rows of x are in, after Z's
products, after Z is stored, after Y's products and after the stores; the
block means at each of the six pairs, B = 1, over the last replay of a
graph of one call (nothing before it) and of 20 calls back to back (each
call's wait then holds the call before it), and the spread of the blocks'
first and last global-timer stamps.

Part 3, chain: a Llama-2-7B layer's four packed linears (random codes,
'rht' rotations) through ``qlinear_apply`` with QUIP_FUSED_RHT=1 at B = 1
and 4, one graph a chain: as it is, without PDL, in turns, beside the
un-fused chain.

With ``--against OLD.cu`` (the mma.sync K3 of an earlier commit, e.g. ``git
show 1c44fc5:quip_tpu_torch/kernels/csrc/rht.cu > _checkout/old_rht.cu``),
both are held against the plain version and timed in turns (this, other,
other, this) at the six pairs, B = 1, 2, 8 and 32, OPT-6.7B's five at B =
1, and in part 3's chain; the old source takes f32 factors and its own
plan rule (``_mma_sync_plan``); nothing else runs unless a part is named.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
from pathlib import Path

import torch

from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.kernels import rht as K3
from quip_tpu_torch.tools.variants import build, card, rep, source, swapped
from quip_tpu_torch.utils.timing import time_ms

SPLITS = {4096: (64, 64), 11008: (128, 86), 12288: (128, 96),
          16384: (128, 128), 22016: (128, 172), 32000: (128, 250)}
LLAMA = ((4096, False), (4096, True), (11008, False), (12288, True),
         (22016, True), (32000, True))
OPT = ((4096, False), (4096, True), (12288, True), (16384, False),
       (16384, True))
P, I = ctypes.c_void_p, ctypes.c_int
ARGS = [P, I, I, I, P, P, P, I, P, P]


def variants(src: str) -> dict:
    rs = ('"wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16\n'
          '      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\\n}\\n"')
    ss = ('"wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16\n'
          '      ", %16, %17, p, 1, 1, 0, 0;\\n}\\n"')
    no_mma = rep(rep(src, rs, '"{ .reg .b32 v; xor.b32 v, %16, %17; '
                     'xor.b32 v, v, %18; xor.b32 v, v, %19; mov.b32 %0, v; '
                     '}\\n}\\n"'), ss, '"mov.b32 %0, %18;\\n}\\n"')
    return {
        "as it is": src,
        "no PDL": no_pdl(src),
        "no products": no_mma,
    }


def no_pdl(src: str) -> str:
    """``src`` launching its bf16 kernel without programmatic dependent
    launch (``griddepcontrol`` then returns at once)."""
    return rep(src, "cfg.numAttrs = 1;", "cfg.numAttrs = 0;")


def _factors(n, gen, dev):
    t = inc.gen_rht(gen, n, device=dev)
    assert (t.a, t.b) == SPLITS[n], (n, t.a, t.b)
    return t


def _time_pairs(pairs, B, tr_cache, gen, dev, apply=None):
    """ms of each pair alone in a graph, bf16 x of B rows, and their sum."""
    apply = apply or K3.rht_apply_fused
    out = {}
    for n, tr in pairs:
        t = tr_cache[n]
        x = torch.randn(B, n, device=dev, generator=gen).bfloat16()
        out[n, tr] = time_ms([lambda: apply(x, t.signs, t.left, t.right,
                                            transpose=tr)], 100)
    return out, sum(out.values())


def _layer(dev):
    from quip_tpu_torch.models.build import random_packed
    words = torch.Generator(device=dev).manual_seed(18)
    rots = torch.Generator().manual_seed(18)
    return [random_packed(m, d, 2, words=words, rots=rots, device=dev)
            for m, d in ((12288, 4096), (4096, 4096), (22016, 4096),
                         (4096, 11008))]


@contextlib.contextmanager
def _fused(on: bool):
    old = os.environ.get("QUIP_FUSED_RHT")
    os.environ["QUIP_FUSED_RHT"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["QUIP_FUSED_RHT"]
        else:
            os.environ["QUIP_FUSED_RHT"] = old


def _chain_ms(layers, B, gen, dev, fused=True):
    from quip_tpu_torch.ops.qlinear import qlinear_apply
    xs = {d: torch.randn(B, d, device=dev, generator=gen).bfloat16()
          for d in (4096, 11008)}
    with _fused(fused):
        return time_ms([lambda: [qlinear_apply(q, xs[q.in_features])
                                 for q in layers]], 200)


def ablate(gen, dev, rht):
    K3._entry()
    fns = build(variants(source("rht.cu")), "quip_rht_apply_bf16", ARGS,
                ptxas=True)
    layers = _layer(dev)
    for name, f in fns.items():
        with swapped(K3, _fn_bf16=f):
            row = []
            for label, pairs in (("Llama", LLAMA), ("OPT", OPT)):
                for B in (1, 32):
                    each, tot = _time_pairs(pairs, B, rht, gen, dev)
                    row.append(f"{label} B={B} {tot * 1e3:.1f}")
                    if label == "Llama" and B == 1:
                        row.append("(" + ", ".join(
                            f"{n}{'T' if tr else 'F'} {v * 1e3:.2f}"
                            for (n, tr), v in each.items()) + ")")
            for B in (1, 4):
                row.append(f"chain B={B} "
                           f"{_chain_ms(layers, B, gen, dev) * 1e3:.1f}")
        print(f"ablation {name}, us: " + " | ".join(row), flush=True)


def _stamped(src: str) -> str:
    """``src`` with thread 0's stamps (10 a block: clocks at the eight
    RHT_STAMP points, global timer at entry and at the end) and a C entry
    ``rht_stamps`` that copies them out."""
    head = ("__device__ unsigned long long g_st[4096][10];\n"
            "__device__ __forceinline__ unsigned long long clk_() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t));\n"
            "  return t;\n}\n"
            "__device__ __forceinline__ unsigned long long gt_() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n"
            "#define RHT_STAMP(k) do { if (threadIdx.x == 0) {"
            " const int b_ = blockIdx.x + gridDim.x * blockIdx.y;"
            " if (b_ < 4096) { g_st[b_][k] = clk_();"
            " if (k == 0) g_st[b_][8] = gt_();"
            " if (k == 7) g_st[b_][9] = gt_(); } } } while (0)\n")
    s = rep(src, "#include \"hopper.cuh\"\n", "#include \"hopper.cuh\"\n"
            + head)
    return s + ("\nextern \"C\" int rht_stamps(void* dst) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_st, sizeof(g_st));"
                "\n}\n")


def stages(gen, dev, rht):
    K3._entry()
    fn = build({"stamped": _stamped(source("rht.cu"))},
               "quip_rht_apply_bf16", ARGS)["stamped"]
    buf = torch.zeros(4096 * 10, dtype=torch.int64)
    names = ("the wait", "operands in", "x's first rows in", "Z's products",
             "Z stored", "Y's products", "stores")
    for n, tr in LLAMA:
        t = rht[n]
        x = torch.randn(1, n, device=dev, generator=gen).bfloat16()
        nq, _ = K3.block_plan(*SPLITS[n])
        for calls in (1, 20):
            with swapped(K3, _fn_bf16=fn):
                time_ms([lambda: K3.rht_apply_fused(
                    x, t.signs, t.left, t.right, transpose=tr)] * calls, 5)
                fn.lib.rht_stamps(ctypes.c_void_p(buf.data_ptr()))
            s = buf.view(4096, 10)[:nq].double()
            steps = ", ".join(
                f"{nm} +{(s[:, k + 1] - s[:, k]).mean().item():.0f}"
                for k, nm in enumerate(names))
            g0 = s[:, 8].min()
            print(f"stages n={n} {'T' if tr else 'F'} ({nq} blocks, {calls} "
                  f"a graph), clocks from entry: {steps}; all "
                  f"{(s[:, 7] - s[:, 0]).mean():.0f}; entries within "
                  f"{(s[:, 8].max() - g0).item() / 1e3:.2f} us, ends "
                  f"{(s[:, 9].min() - g0).item() / 1e3:.2f} .. "
                  f"{(s[:, 9].max() - g0).item() / 1e3:.2f} us", flush=True)


def chain(gen, dev):
    K3._entry()
    nopdl = build({"no PDL": no_pdl(source("rht.cu"))},
                  "quip_rht_apply_bf16", ARGS)["no PDL"]
    layers = _layer(dev)
    for B in (1, 4):
        ms = {"PDL": [], "no PDL": []}
        for how in ("PDL", "no PDL", "no PDL", "PDL"):
            f = K3._fn_bf16 if how == "PDL" else nopdl
            with swapped(K3, _fn_bf16=f):
                ms[how].append(_chain_ms(layers, B, gen, dev))
        print(f"chain B={B}, ms: " + " | ".join(
            f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in ms.items())
            + f" | un-fused {_chain_ms(layers, B, gen, dev, False):.4f}",
            flush=True)


def _mma_sync_plan(B, b, sms):
    """(columns a block, rows a block) as the mma.sync K3 chose them: 16
    columns, 64 from half a wave of 64-column blocks on, several rows a
    block beyond two blocks an SM."""
    cols = 64 if B * -(-b // 64) >= sms // 2 else 16
    return cols, max(1, -(-B * -(-b // cols) // (2 * sms)))


def _old_apply(path: str):
    """rht_apply_fused through the old source (f32 factors, its plan)."""
    old = build({"other": Path(path).read_text()}, "quip_rht_apply",
                [P, I, I, I, I, P, P, P, I, I, I, P, P])["other"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def apply(x, vec, left, right, transpose=False):
        a, b = left.shape[0], x.shape[1] // left.shape[0]
        cols, rpb = _mma_sync_plan(x.shape[0], b, sms)
        y = torch.empty_like(x)
        err = old(x.data_ptr(), 1, x.shape[0], a, b, vec.data_ptr(),
                  left.data_ptr(),
                  right.data_ptr() if right is not None else None,
                  int(transpose), cols, rpb, y.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return y
    return apply


def against(other: str, gen, dev, rht):
    from quip_tpu_torch.ops import qlinear as TQ
    apply = {"this": K3.rht_apply_fused, "other": _old_apply(other)}
    for n, tr in LLAMA + OPT:
        t = rht[n]
        x = torch.randn(5, n, device=dev, generator=gen).bfloat16()
        want = K3.rht_apply_fused_ref(x, t.signs, t.left, t.right,
                                      transpose=tr).float()
        for k, f in apply.items():
            got = f(x, t.signs, t.left, t.right, transpose=tr).float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            assert rel <= 2e-2, (k, n, tr, rel)
    for label, pairs, rows in (("Llama", LLAMA, (1, 2, 8, 32)),
                               ("OPT", OPT, (1,))):
        for B in rows:
            ms = {k: [] for k in apply}
            for k in ("this", "other", "other", "this"):
                ms[k].append(_time_pairs(pairs, B, rht, gen, dev,
                                         apply[k])[1])
            print(f"against {label} B={B}, ms, sums of the pairs: "
                  + " | ".join(f"{k} {v[0]:.4f} {v[1]:.4f}"
                               for k, v in ms.items()), flush=True)
    layers = _layer(dev)
    for B in (1, 4):
        ms = {k: [] for k in apply}
        for k in ("this", "other", "other", "this"):
            with swapped(TQ, rht_apply_fused=apply[k]):
                ms[k].append(_chain_ms(layers, B, gen, dev))
        print(f"against chain B={B}, ms: " + " | ".join(
            f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in ms.items()),
            flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("ablation", "stages", "chain"),
                    action="append")
    ap.add_argument("--against", help="the mma.sync K3 source")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_rht: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rots = torch.Generator().manual_seed(3)
    rht = {n: _factors(n, rots, dev) for n in SPLITS}
    print(card())
    if args.against:
        against(args.against, gen, dev, rht)
    parts = args.part or ([] if args.against
                          else ["ablation", "stages", "chain"])
    if "ablation" in parts:
        ablate(gen, dev, rht)
    if "stages" in parts:
        stages(gen, dev, rht)
    if "chain" in parts:
        chain(gen, dev)


if __name__ == "__main__":
    main()
