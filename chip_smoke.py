"""On-card smoke test of the PyTorch/CUDA port (quip_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, sm_90a) and nvcc. It builds the
port's kernels from ``quip_tpu_torch/kernels/csrc`` and runs, in order:

  1. the card's name and power limit, and the kernel build (all five nvcc
     runs started together);
  2. K1 (dequant_matmul: the decode kernel K1-decode up to B = 8, the
     tile kernel K1-tile above, both on the tensor cores) against its plain
     version at the five 2-bit Llama-2-7B projection shapes (B = 1..4, 7, 8,
     9, 16, 17, 32, 128, 600, 1000) and at small 3/4/8-bit, qfn-a and code_bits=3
     shapes, two of them ragged and one that only K1-decode takes, f32 and
     bf16 x, each kernel forced past its threshold too, with kernel, plain,
     bound and library (torch.matmul of the dequantised bf16 weight) times,
     and both kernels' times at B = 1, 2, 4, 8, 16 (the crossover);
  3. K2 (flash_prefill) against its plain version (B=2, H=32, S=600,
     plen=[600, 431]; GQA H=64, KV=8 and H=32, KV=8; S = 513 with a row of
     plen 1; S = 1000 and 2048), with SDPA as the library yardstick;
  4. K3 (rht_apply_fused) against its plain version at the five
     Llama-2-7B (a, b) splits, B in (1, 5, 32, 70), both directions, bf16
     and f32, with a scaleWH fold, and a right-factor-free case; the round
     trip; times at B = 1, 2, 8, 32 beside the un-fused apply_rht and
     beside an empty kernel's (the launch floor);
  5. K1' (slabdot_matmul) against its plain version and against K1 for
     bits 2/3/4, B = 1, 5, 8, 13 and every legal tile_m at two small shapes
     (one ragged), one device kernel per call (profiler), then through the
     microbenchmark's own functions (tools/bench_kernel.py) at its five
     shapes and every legal tile_m, the best kept, beside K1-decode in the
     same call; under a watchdog (a barrier that never completes hangs);
  6. a 2-layer full-width packed Llama-2-7B: 600-token prefill + 4
     teacher-forced decode steps on the card vs the plain path on the CPU
     in f32 on the same weights, un-fused with bf16 KV and then with
     QUIP_FUSED_RHT=1 and an int8 cache;
  7. full-depth 2-bit Llama-2-7B with a packed lm_head served through
     ``Engine.run`` (4 greedy requests, prompts 600/128/37/5, 40 new tokens
     each), first un-fused with bf16 KV, then with QUIP_FUSED_RHT=1, int8
     KV and a 200-token shared prefix; the kernels' launch counters are
     zeroed just before each run and read just after; then prefill and
     b4 decode timings, and b1 decode with and without QUIP_FUSED_RHT=1.

Every phase asserts; any failure exits nonzero. The line before the last
is the kernels' JSON record, the last line ``{"ok": true, "device": ...}``.
``--out DIR`` also writes every measurement to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RESULTS: dict = {}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, name: str):
    from quip_tpu_torch.utils.timing import card_peaks
    bw, fl = card_peaks(name)
    tb, to = nbytes / bw, ops / fl
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        sys.exit(1)
    import quip_tpu_torch  # noqa: F401  (fails outside the repo)
    from quip_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    t = time.time()
    logs = _build.build_all(["dequant_matmul_decode", "dequant_matmul_tile",
                             "flash_attn", "rht", "slabdot_matmul"])
    build_s = time.time() - t
    log(f"card: {smi}")
    log(f"kernel build (parallel nvcc, sm_90a): {build_s:.1f} s")
    for src, text in logs.items():
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in text.splitlines()
                     if "spill stores" in line)
        log(f"  ptxas {src}: {len(regs)} kernels, max {max(regs or [0])} "
            f"registers, {spills} bytes of spill stores")
    RESULTS["card"] = smi
    RESULTS["build_s"] = build_s
    return name, smi


# earlier slices' times on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md
# section 6), printed beside this run's
BEFORE = dict(k1_sum_b600_ms=20.56, k1_sum_b32_ms=1.219, k2_ms=0.3495,
              k2_gqa_ms=0.623, prefill_ms=437.4,
              # B -> (the CUDA-core K1, K1-tile), sums of the five shapes
              k1_sums_ms={1: (0.1327, 0.1059), 8: (0.3652, 0.1090)},
              k3_sum_ms=0.1271,
              # K1' before its redesign: five shapes, B = 1, best tile_m
              k1p_sum_ms=0.1178)


def phase_k1(name: str):
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.pack.format import PLANE_SPLITS
    from quip_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def planes_for(m, d, bits):
        return tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                   dtype=torch.int32, generator=g,
                                   device=dev)
                     for fb, _ in PLANE_SPLITS[bits])

    worst = {"decode": 0.0, "tile": 0.0}
    worst_rel = {"decode": 0.0, "tile": 0.0}

    def check(x, pl, scale, zero, what, path=None, **kw):
        """Kernel against plain: f32 x holding bf16 values, so both see the
        same x and differ only in the summation order (1e-3 of max |y|),
        then bf16 in and out (1e-2: the output's rounding). The counters
        must say that the kernel the rule (or ``path``) names was the one
        launched. Returns the path taken and both errors."""
        B, d = x.shape
        want_path = path or DM.route(B, d, pl[0].shape[-1], kw["bits"])
        t0, d0 = DM.launches_tile, DM.launches_decode
        xf = x.float()
        got = DM.dequant_matmul(xf, pl, scale, zero, path=path, **kw)
        took = (DM.launches_tile - t0, DM.launches_decode - d0)
        assert took == ((1, 0) if want_path == "tile" else
                        (0, -(-B // DM.DECODE_MAX_B))), (what, want_path, took)
        want = DM.dequant_matmul_ref(xf, pl, scale, zero, **kw)
        got16 = DM.dequant_matmul(x, pl, scale, zero, path=path, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        assert rel <= 1e-3, (what, want_path, rel)
        _, rel16 = rel_err(got16, want)
        assert rel16 <= 1e-2, (what, want_path, "bf16 out", rel16)
        worst[want_path] = max(worst[want_path], err)
        worst_rel[want_path] = max(worst_rel[want_path], rel)
        return want_path, rel, rel16

    # small widths, every format; d = 1408 leaves the 1-bit plane of 3-bit
    # a ragged group of word rows, m = 328 a ragged warp of columns; m = 330
    # (no multiple of 4) and d = 96 are shapes K1-tile does not take: they go
    # to K1-decode at any B, 8 rows at a time
    for bits, qfn, code_bits in [(2, "b", None), (3, "b", None),
                                 (4, "b", None), (8, "b", None),
                                 (4, "b", 3), (2, "a", None),
                                 (4, "a", None)]:
        for m, d in ((640, 1024), (328, 1408), (330, 96)):
            pl = planes_for(m, d, bits)
            if code_bits:       # 3-bit codes in 4-bit fields: clear bit 3s
                pl = tuple(p & 0x77777777 for p in pl)
            scale = torch.tensor(0.02, device=dev)
            zero = None
            if qfn == "a":
                scale = torch.rand(m, device=dev, generator=g) * 0.05 + 0.01
                zero = torch.rand(m, device=dev, generator=g) * 2 ** bits
            kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
            for B in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 32, 33, 128, 600,
                      1000):
                if d == 96 and B > 33:
                    continue
                x = torch.randn(B, d, device=dev, generator=g).bfloat16()
                check(x, pl, scale, zero, (bits, qfn, code_bits, m, d, B),
                      **kw)
            if DM.tile_takes(d, m, bits):
                # each kernel on the other's side of the threshold, forced
                for B, path in ((3, "tile"), (8, "tile"), (9, "decode"),
                                (20, "decode")):
                    x = torch.randn(B, d, device=dev, generator=g).bfloat16()
                    check(x, pl, scale, zero, (bits, qfn, m, d, B, path),
                          path=path, **kw)
    log(f"K1 small formats (2/3/4/8-bit, qfn a/b, code_bits=3; 640x1024, "
        f"328x1408 and 330x96; B = 1..8 and 9..1000, f32 and bf16 x): max rel "
        f"err K1-decode {worst_rel['decode']:.2e}, K1-tile "
        f"{worst_rel['tile']:.2e} <= 1e-3")

    shapes = {"wqkv": (12288, 4096), "wo": (4096, 4096),
              "wgu": (22528, 4096), "wd": (4096, 11008),
              "lm_head": (32000, 4096)}
    timed = (1, 2, 4, 8, 16, 32, 128, 600)
    crossed = (1, 2, 4, 8, 16)
    rows = []
    zero_sums = lambda: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,  # noqa: E731
                             library_ms=0.0)
    sums = {B: zero_sums() for B in timed}
    cross = {B: dict(decode=0.0, tile=0.0) for B in crossed}
    bound_by = {B: set() for B in timed}
    scale = torch.tensor(0.02, device=dev)
    for sname, (m, d) in shapes.items():
        pbytes = d * 2 * m // 8
        ncopy = max(1, math.ceil(120e6 / pbytes))
        copies = [planes_for(m, d, 2) for _ in range(ncopy)]
        W = DM.dequant_weight(copies[0], scale, None, bits=2,
                              d=d).to(torch.bfloat16)
        for B in (1, 2, 3, 4, 7, 8, 9, 16, 17, 32, 128, 600, 1000):
            x = torch.randn(B, d, device=dev, generator=g).bfloat16()
            path, rel, rel16 = check(x, copies[0], scale, None, (sname, B),
                                     bits=2)
            if B not in timed:
                continue

            def run(path=None, it=20 if B <= 128 else 5):
                return time_ms([lambda c=c: DM.dequant_matmul(
                    x, c, scale, None, bits=2, path=path) for c in copies],
                    it)

            ms = run()
            plain = time_ms([lambda: DM.dequant_matmul_ref(
                x, copies[0], scale, None, bits=2)], 2)
            lib = time_ms([lambda: torch.matmul(x, W.t())], 20)
            bms, by = bound_ms(B * d * 2 + pbytes + B * m * 2,
                               2 * B * d * m, name)
            row = dict(shape=sname, m=m, d=d, B=B, path=path, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by, rel_err=rel, rel_err_bf16=rel16)
            extra = ""
            if B in cross:      # the other kernel at the same shape
                other = "tile" if path == "decode" else "decode"
                row[f"ms_{path}"] = ms
                row[f"ms_{other}"] = run(other)
                for k in cross[B]:
                    cross[B][k] += row[f"ms_{k}"]
                extra = f", forced {other} {row[f'ms_{other}']:.4f} ms"
            rows.append(row)
            log(f"K1 {sname:8s} {m}x{d} B={B:4d} [{path}]: {ms:.4f} ms "
                f"(bound {bms:.4f} {by}, {bms / ms:.0%}){extra}, plain "
                f"{plain:.3f} ms, torch.matmul bf16 {lib:.4f} ms, "
                f"rel err {rel:.1e} / bf16 out {rel16:.1e}")
            bound_by[B].add(by)
            for k, v in (("ms", ms), ("plain_ms", plain),
                         ("bound_ms", bms), ("library_ms", lib)):
                sums[B][k] += v
        del copies, W
        torch.cuda.empty_cache()
    for B in timed:
        t = sums[B]
        log(f"K1 sum of the five shapes, B={B:4d}: {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ({t['bound_ms'] / t['ms']:.0%}), "
            f"torch.matmul bf16 {t['library_ms']:.4f}")
    for B, c in cross.items():
        b = BEFORE["k1_sums_ms"].get(B)
        log(f"K1 crossover, B={B:2d}, sum of the five shapes: K1-decode "
            f"{c['decode']:.4f} ms"
            + (" (8 rows at a time)" if B > DM.DECODE_MAX_B else "")
            + f", K1-tile {c['tile']:.4f} ms"
            + (f"; the previous slice's CUDA-core kernel {b[0]} ms, its "
               f"K1-tile {b[1]} ms" if b else "")
            + f" (rule: K1-decode up to B = {DM.DECODE_MAX_B})")
    # K1-decode beats the library call at decode sizes and, at B = 1, both of
    # the previous slice's kernels
    # (asserted where the margin is far above the run-to-run spread; the
    # B = 8 margin over K1-tile is a few percent and is only printed)
    for B in (1, 2, 4, 8):
        assert sums[B]["ms"] < sums[B]["library_ms"], (B, sums[B])
    assert cross[1]["decode"] < cross[1]["tile"], cross[1]
    assert sums[1]["ms"] < min(BEFORE["k1_sums_ms"][1]), sums[1]
    log(f"K1-tile sum at B=600: {sums[600]['ms']:.3f} ms (first slice "
        f"{BEFORE['k1_sum_b600_ms']}); at B=32: {sums[32]['ms']:.4f} ms "
        f"(first slice {BEFORE['k1_sum_b32_ms']})")
    RESULTS["k1"] = rows
    RESULTS["k1_sums"] = {str(B): t for B, t in sums.items()}
    RESULTS["k1_crossover"] = {str(B): c for B, c in cross.items()}
    for B in (1, 600):          # one word for each summed row
        assert len(bound_by[B]) == 1, (B, bound_by[B])
    k1 = dict(sums[1], max_rel_err=worst_rel["decode"],
              max_abs_err=worst["decode"], bound_by=bound_by[1].pop(),
              ms_b8=sums[8]["ms"], bound_ms_b8=sums[8]["bound_ms"],
              library_ms_b8=sums[8]["library_ms"])
    k1t = dict(sums[600], max_rel_err=worst_rel["tile"],
               max_abs_err=worst["tile"], bound_by=bound_by[600].pop())
    return k1, k1t


def phase_k2(name: str):
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    rec = None
    for B, H, KV, S, plen in [(2, 32, 32, 600, [600, 431]),
                              (2, 64, 8, 600, [600, 431]),
                              (1, 32, 32, 1000, [1000]),
                              (2, 32, 8, 600, [600, 431]),
                              (2, 32, 32, 513, [513, 1]),
                              (1, 32, 32, 2048, [2048])]:
        hd = 128
        q = torch.randn(B, S, H, hd, device=dev, generator=g).bfloat16()
        k = torch.randn(B, S, KV, hd, device=dev, generator=g).bfloat16()
        v = torch.randn(B, S, KV, hd, device=dev, generator=g).bfloat16()
        pl = torch.tensor(plen, dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(hd)
        got = FA.flash_prefill_bshd(q, k, v, pl, scale=scale)
        want = FA.flash_prefill_ref(q.float(), k.float(), v.float(), pl,
                                    scale=scale)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        err, _ = rel_err(got, want)
        assert err <= 2e-2, (B, H, KV, S, err)
        worst = max(worst, err)
        ms = time_ms([lambda: FA.flash_prefill_bshd(q, k, v, pl,
                                                    scale=scale)], 20)
        plain = time_ms([lambda: FA.flash_prefill_ref(q, k, v, pl,
                                                      scale=scale)], 3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & (i[None, None, :] < pl[:, None, None]))[:, None]
        lib = time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=KV != H)], 20)
        pairs = sum(min(r + 1, p) for p in plen for r in range(S))
        ops = 4 * pairs * H * hd
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        bms, by = bound_ms(nbytes, ops, name)
        log(f"K2 B={B} H={H} KV={KV} S={S} plen={plen}: {ms:.4f} ms "
            f"(bound {bms:.4f} {by}), plain {plain:.3f} ms, SDPA "
            f"{lib:.4f} ms, max abs err {err:.2e} <= 2e-2")
        r = dict(B=B, H=H, KV=KV, S=S, plen=plen, ms=ms, plain_ms=plain,
                 library_ms=lib, bound_ms=bms, bound_by=by, max_abs_err=err)
        RESULTS.setdefault("k2", []).append(r)
        if rec is None:
            rec = r
        del want, mask
        torch.cuda.empty_cache()
    k2 = RESULTS["k2"]
    log(f"K2 B=2 H=32 S=600: {k2[0]['ms']:.4f} ms (was {BEFORE['k2_ms']}); "
        f"GQA H=64 KV=8: {k2[1]['ms']:.4f} ms (was {BEFORE['k2_gqa_ms']})")
    return worst, rec


def phase_k3(name: str):
    from quip_tpu_torch.core import incoherence as inc
    from quip_tpu_torch.kernels import rht as K3
    from quip_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rots = torch.Generator().manual_seed(4)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    worst_abs = 0.0

    def check(x, vec, t, tr):
        nonlocal worst_abs
        got = K3.rht_apply_fused(x, vec, t.left, t.right, transpose=tr)
        want = K3.rht_apply_fused_ref(x, vec, t.left, t.right, transpose=tr)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        err, rel = rel_err(got, want)
        assert rel <= tol[x.dtype], (t.a, t.b, x.shape, x.dtype, tr, rel)
        worst[x.dtype] = max(worst[x.dtype], rel)
        worst_abs = max(worst_abs, err)

    # right-factor-free (n == a) at a small n
    t8 = inc.RHT(torch.ones(64, device=dev), inc._hadamard(6, device=dev),
                 None, 64)
    v8 = (torch.rand(64, device=dev, generator=g) + 0.5) * (
        torch.randint(0, 2, (64,), device=dev, generator=g) * 2 - 1)
    for dt in tol:
        for tr in (False, True):
            check(torch.randn(5, 64, device=dev, generator=g).to(dt), v8, t8,
                  tr)

    # the (n, direction) pairs of one b1 decode step: V side forward, U
    # side transpose
    on_path = {(4096, False), (4096, True), (11008, False), (12288, True),
               (22016, True), (32000, True)}
    splits = {4096: (64, 64), 11008: (128, 86), 12288: (128, 96),
              22016: (128, 172), 32000: (128, 250)}
    rows = []
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    by_B = {B: dict(ms=0.0, library_ms=0.0) for B in (1, 2, 8, 32)}
    bound_by = set()
    # the launch floor: a kernel that does nothing, replayed the same way
    # (alone in its graph, as each K3 time is, and ten to a graph)
    empty_ms = time_ms([K3.launch_empty], 200)
    empty10_ms = time_ms([K3.launch_empty] * 10, 100)
    for n, ab in splits.items():
        t = inc.gen_rht(rots, n, device=dev)
        assert (t.a, t.b) == ab, (n, t.a, t.b)
        swh = torch.rand(n, device=dev, generator=g) + 0.5
        vec = t.signs / swh                  # the scaleWH fold
        for dt in tol:
            for B in (1, 5, 32, 70):   # 70 rows: blocks of 64 columns
                x = torch.randn(B, n, device=dev, generator=g).to(dt)
                for tr in (False, True):
                    check(x, vec, t, tr)
        # forward then transpose gives x back (f32, signs only)
        x = torch.randn(5, n, device=dev, generator=g)
        y = K3.rht_apply_fused(x, t.signs, t.left, t.right)
        back = K3.rht_apply_fused(y, t.signs, t.left, t.right,
                                  transpose=True)
        rt = (back - x).abs().max().item()
        assert rt <= 1e-5, (n, rt)
        # times, bf16 (the serving dtype). The operands (at most 380 KB)
        # sit in L2 here; their bytes are far below the kernel's time
        tv = inc.RHT(vec, t.left, t.right, n)
        for B in (1, 2, 8, 32):
            x = torch.randn(B, n, device=dev, generator=g).bfloat16()
            for tr in (False, True):
                ms = time_ms([lambda: K3.rht_apply_fused(
                    x, vec, t.left, t.right, transpose=tr)], 50)
                plain = time_ms([lambda: K3.rht_apply_fused_ref(
                    x, vec, t.left, t.right, transpose=tr)], 10)
                lib = time_ms([lambda: inc.apply_rht(
                    tv, x, axis=-1, transpose=tr)], 50)
                a, b = ab
                bms, by = bound_ms(2 * B * n * 2 + 4 * (n + a * a + b * b),
                                   2 * B * a * b * (a + b), name)
                rows.append(dict(n=n, a=a, b=b, B=B, transpose=tr, ms=ms,
                                 plain_ms=plain, library_ms=lib,
                                 bound_ms=bms, bound_by=by))
                if (n, tr) in on_path:
                    by_B[B]["ms"] += ms
                    by_B[B]["library_ms"] += lib
                log(f"K3 n={n:5d} ({a}x{b}) B={B:2d} "
                    f"{'transpose' if tr else 'forward  '}: {ms:.4f} ms "
                    f"(bound {bms:.5f} {by}), plain {plain:.4f} ms, "
                    f"apply_rht (2 matmuls + multiply) {lib:.4f} ms")
                if B == 1 and (n, tr) in on_path:
                    bound_by.add(by)
                    for k, v in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", bms), ("library_ms", lib)):
                        sums[k] += v
    assert len(bound_by) == 1, bound_by    # one word for the summed row
    sums["bound_by"] = bound_by.pop()
    for B, t in by_B.items():
        log(f"K3 sum of the six (n, direction) pairs of a decode step, bf16, "
            f"B={B:2d}: {t['ms']:.4f} ms, un-fused apply_rht "
            f"{t['library_ms']:.4f} ms")
    log(f"K3 at B=1: {sums['ms']:.4f} ms (second slice "
        f"{BEFORE['k3_sum_ms']}); bound {sums['bound_ms']:.5f} ms; launch "
        f"floor: an empty kernel replayed alone {empty_ms * 1e3:.2f} us a "
        f"launch ({6 * empty_ms:.4f} ms for six), ten to a graph "
        f"{empty10_ms * 1e3:.2f} us")
    # fused beats un-fused in this call (the margin is 1.9x at B = 1)
    assert sums["ms"] < sums["library_ms"], sums
    sums.update(empty_ms=empty_ms, empty_in_graph_ms=empty10_ms,
                by_B={str(B): t for B, t in by_B.items()})
    log(f"K3 vs plain, 5 Llama-2-7B splits + right=None, B in (1, 5, 32, 70), "
        f"both directions, scaleWH fold: max rel err bf16 "
        f"{worst[torch.bfloat16]:.2e} <= 2e-2, f32 "
        f"{worst[torch.float32]:.2e} <= 2e-5; round trip <= 1e-5")
    RESULTS["k3"] = rows
    sums["max_rel_err_bf16"] = worst[torch.bfloat16]
    sums["max_rel_err_f32"] = worst[torch.float32]
    return worst_abs, sums


def _kernels_per_call(fn) -> int:
    """Device kernels torch.profiler (CUPTI) sees in one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Exit the process (nonzero) if the block has not ended in ``seconds``:
    a kernel that waits on a barrier phase that never completes hangs
    instead of failing."""
    import threading

    def fire():
        log(f"chip_smoke: {what} did not finish in {seconds:.0f} s")
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def phase_k1p(name: str):
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import slabdot as SD
    from quip_tpu_torch.pack.format import PLANE_SPLITS
    from quip_tpu_torch.tools import bench_kernel as BK
    from quip_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    worst = worst_rel = worst_k1 = 0.0
    n_checked = 0

    def check(x, planes, scale, bits, tile_m):
        """K1' vs its plain version (1e-3: same arithmetic, other
        summation order) and vs K1 (2e-2: the 128*sum(x) fix-up in f32);
        one launch per call."""
        nonlocal worst, worst_rel, worst_k1, n_checked
        before = SD.launches
        got = SD.slabdot_matmul(x, planes, scale, bits=bits, tile_m=tile_m)
        torch.cuda.synchronize()
        assert SD.launches == before + 1
        want = SD.slabdot_matmul_ref(x, planes, scale, bits=bits)
        k1 = DM.dequant_matmul(x, planes, scale, None, bits=bits)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        assert rel <= 1e-3, (x.shape, bits, tile_m, rel)
        _, relk = rel_err(got, k1)
        assert relk <= 2e-2, (x.shape, bits, tile_m, "vs K1", relk)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        worst_k1 = max(worst_k1, relk)
        n_checked += 1

    scale = torch.tensor(0.02, device=dev)
    # every format, B = 1, 5, 8, 13 (two tiles of rows), every legal tile_m;
    # d = 1408 splits its groups of word rows unevenly and leaves the 1-bit
    # plane a ragged last group
    for bits in (2, 3, 4):
        for m, d in ((640, 1024), (384, 1408)):
            planes = tuple(torch.randint(-2 ** 31, 2 ** 31,
                                         (d * fb // 32, m), dtype=torch.int32,
                                         generator=g, device=dev)
                           for fb, _ in PLANE_SPLITS[bits])
            for B in (1, 5, 8, 13):
                x = torch.randn(B, d, device=dev,
                                generator=g).bfloat16().float()
                for tile_m in range(128, m + 1, 128):
                    if m % tile_m == 0:
                        check(x, planes, scale, bits, tile_m)
            # bf16 in and out (1e-2: the output's rounding)
            x = torch.randn(5, d, device=dev, generator=g).bfloat16()
            got = SD.slabdot_matmul(x, planes, scale, bits=bits, tile_m=128)
            _, rel16 = rel_err(got, SD.slabdot_matmul_ref(x.float(), planes,
                                                          scale, bits=bits))
            assert got.dtype == torch.bfloat16 and rel16 <= 1e-2, rel16
    # one launch a call, both planes of a 3-bit model included
    per_call = {}
    for bits in (2, 3):
        m, d = 4096, 4096
        planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                     dtype=torch.int32, generator=g,
                                     device=dev)
                       for fb, _ in PLANE_SPLITS[bits])
        x = torch.randn(1, d, device=dev, generator=g).bfloat16()
        per_call[bits] = _kernels_per_call(lambda: SD.slabdot_matmul(
            x, planes, scale, bits=bits, tile_m=512))
        assert per_call[bits] == 1, (bits, per_call[bits])

    # the microbenchmark's own path: its shapes, B = 1, 2-bit, every legal
    # tile_m (checked against the plain version and K1 too), the best kept
    rows = []
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                k1_ms=0.0, k1_again_ms=0.0, smallest_tile_ms=0.0)
    best_tile = {}
    n_launch = 0
    for m, d in BK.SHAPES:
        tiles = BK.legal_tiles(m)
        SD.launches = 0
        bench, (x, copies, scale) = BK.bench_shape(m, d, tiles=tiles)
        n_launch += SD.launches
        by_name = {r["name"]: r for r in bench}
        k1_row, k1_again = by_name["concat/dflt"], by_name["concat/dflt#2"]
        by_tile = {t: by_name[f"slabdot/{t}"]["ms"] for t in tiles}
        tile_m = min(by_tile, key=by_tile.get)
        best_tile[f"{m}x{d}"] = tile_m
        for t in tiles:
            check(x.float(), copies[0], scale, 2, t)
        plain = time_ms([lambda: SD.slabdot_matmul_ref(
            x, copies[0], scale, bits=2)], 2)
        W = DM.dequant_weight(copies[0], scale, None, bits=2,
                              d=d).to(torch.bfloat16)
        lib = time_ms([lambda: torch.matmul(x, W.t())], 20)
        bms, by = bound_ms(d * 2 + d * 2 * m // 8 + m * 2, 2 * d * m, name)
        ms = by_tile[tile_m]
        rows.append(dict(m=m, d=d, tile_m=tile_m, ms=ms, ms_by_tile_m=by_tile,
                         k1_ms=k1_row["ms"], k1_again_ms=k1_again["ms"],
                         plain_ms=plain, library_ms=lib, bound_ms=bms,
                         bound_by=by,
                         err_vs_k1=by_name[f"slabdot/{tile_m}"]["err"]))
        log(f"K1' {m}x{d} B=1: best tile_m={tile_m} {ms:.4f} ms (bound "
            f"{bms:.4f} {by}, {bms / ms:.0%}); by tile_m "
            + ", ".join(f"{t}: {v:.4f}" for t, v in by_tile.items())
            + f"; K1-decode {k1_row['ms']:.4f} / again "
            f"{k1_again['ms']:.4f} ms, plain {plain:.3f} ms, torch.matmul "
            f"bf16 {lib:.4f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bms),
                     ("library_ms", lib), ("k1_ms", k1_row["ms"]),
                     ("k1_again_ms", k1_again["ms"]),
                     ("smallest_tile_ms", by_tile[tiles[0]])):
            sums[k] += v
        del copies, W
        torch.cuda.empty_cache()
    log(f"K1' sum of the five shapes at B=1, best tile_m each: "
        f"{sums['ms']:.4f} ms (before this design "
        f"{BEFORE['k1p_sum_ms']}; smallest tile_m {sums['smallest_tile_ms']:.4f});"
        f" bound {sums['bound_ms']:.4f} ({sums['bound_ms'] / sums['ms']:.0%}); "
        f"K1-decode in the same call {sums['k1_ms']:.4f} / again "
        f"{sums['k1_again_ms']:.4f}; torch.matmul bf16 {sums['library_ms']:.4f}")
    log(f"K1' vs plain (f32-held bf16 x): max rel err {worst_rel:.2e} <= "
        f"1e-3; vs K1: {worst_k1:.2e} <= 2e-2 ({n_checked} checks: bits "
        f"2/3/4, B = 1/5/8/13, every legal tile_m); device kernels per call "
        f"(profiler) 2-bit {per_call[2]}, 3-bit {per_call[3]}; {n_launch} "
        f"launches in the microbenchmark's path")
    assert n_launch > 0
    RESULTS["k1p"] = rows
    sums.update(max_rel_err=worst_rel, max_rel_err_vs_k1=worst_k1,
                launches=n_launch, best_tile_m=best_tile,
                kernels_per_call=per_call[2], kernels_per_call_3bit=per_call[3])
    return worst, sums


def _to_cpu_f32(model):
    cpu = copy.deepcopy(model).to("cpu")
    for mod in cpu.modules():
        for n, b in list(mod.named_buffers(recurse=False)):
            if b is not None and b.is_floating_point():
                setattr(mod, n, b.float())
    return cpu


@contextlib.contextmanager
def fused_rht(on: bool):
    """QUIP_FUSED_RHT=1 inside the block (ops/qlinear.py reads it at call
    time), the caller's value restored after it."""
    old = os.environ.get("QUIP_FUSED_RHT")
    os.environ["QUIP_FUSED_RHT"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["QUIP_FUSED_RHT"]
        else:
            os.environ["QUIP_FUSED_RHT"] = old


def phase_slice(combos=((False, False), (True, True))):
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.models.build import packed_llama
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.kernels import rht as K3

    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_llama(cfg, bits=2, seed=3, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    ref = _to_cpu_f32(model)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 600)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4,)))

    def drive(params, dev, dtype, quantized):
        kv = PG.init_paged(1, 1024 + 32, cfg, dtype=dtype, hot=32, page=64,
                           quantized=quantized, device=dev)
        lg, kv = PG.paged_prefill_slot(params, prompt.to(dev), 600, kv, 0,
                                       cfg)
        out = [lg.float().cpu()]
        k3_step = []
        for t in steps:
            k3 = K3.launches
            lg, hot = PG.paged_decode_step(params, t.view(1, 1).to(dev), kv,
                                           cfg, page=64)
            kv = PG.advance(kv, hot)
            k3_step.append(K3.launches - k3)
            out.append(lg[0].float().cpu())
        return torch.stack(out), k3_step

    # the un-fused bf16-KV path, then this slice's configuration: fused RHT
    # and an int8 cache, each against the CPU f32 plain path on the same
    # weights in the same configuration. Limit 3e-2 of max |logit| with a
    # bf16 cache (bf16 activations against f32). With an int8 cache both
    # sides quantise their own rows, and a row rounded to bf16 first lands
    # on another int8 code than its f32 original about as often as not: one
    # step is 1/127 of the row's absmax, the size of bf16's own rounding.
    # That is a second, independent error of the same size on every K and V
    # row, so the limit grows by sqrt(2): 4e-2.
    for fused, quantized in combos:
        k1, k2 = DM.launches, FA.launches
        with fused_rht(fused):
            got, k3_step = drive(model, "cuda", torch.bfloat16, quantized)
            torch.cuda.synchronize()
            assert FA.launches - k2 == cfg.n_layers, "prefill did not run K2"
            assert DM.launches > k1
            # V and U side of 4 projections per layer and of the lm_head
            want_k3 = 2 * (4 * cfg.n_layers + 1) if fused else 0
            assert k3_step == [want_k3] * len(steps), (k3_step, want_k3)
            want, _ = drive(ref, "cpu", torch.float32, quantized)
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item() / want.abs().max().item()
        what = (f"{'QUIP_FUSED_RHT=1' if fused else 'un-fused RHT'}, "
                f"{'int8' if quantized else 'bf16'} KV")
        limit = 4e-2 if quantized else 3e-2
        log(f"slice check, {what} (2 layers, full width, 600-token prefill "
            f"+ 4 decode steps, card bf16 vs CPU f32 plain): normalised max "
            f"err {err:.2e} <= {limit:.0e}; K3 launches per decode step "
            f"{k3_step[0]}")
        assert err <= limit, (what, err)
        RESULTS[f"slice_err_fused{int(fused)}_int8{int(quantized)}"] = err
    del model, ref
    torch.cuda.empty_cache()


def _run_engine(eng, reqs, cfg):
    """``eng.run(reqs)`` with every kernel's count set to 0 just before and
    read just after; checks finite logits, token ranges and lengths.
    Returns the counts, the decode steps and each step's K1/K3 launches."""
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.kernels import rht as K3

    finite = torch.ones((), dtype=torch.bool, device="cuda")
    orig = (PG.paged_decode_step, PG.paged_prefill_slot,
            PG.paged_append_step)
    per_step = []

    def checked(fn, decode=False):
        def run(*a, **kw):
            before = (DM.launches, K3.launches)
            out = fn(*a, **kw)
            finite.logical_and_(torch.isfinite(out[0]).all())
            if decode:
                per_step.append((DM.launches - before[0],
                                 K3.launches - before[1]))
            return out
        return run

    PG.paged_prefill_slot = checked(orig[1])
    PG.paged_append_step = checked(orig[2])
    # paged_decode_step calls the module's paged_append_step: wrap it last
    # and count per step there
    PG.paged_decode_step = checked(orig[0], decode=True)
    try:
        DM.launches = DM.launches_tile = DM.launches_decode = 0
        FA.launches = K3.launches = 0
        t = time.time()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.time() - t
        k1, k2, k3 = DM.launches, FA.launches, K3.launches
        k1_tile, k1_decode = DM.launches_tile, DM.launches_decode
    finally:
        (PG.paged_decode_step, PG.paged_prefill_slot,
         PG.paged_append_step) = orig
    for r, q in zip(out, reqs):
        assert len(r.generated) == q["max_new_tokens"] + 1, (r.uid,
                                                             len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert bool(finite), "NaN/inf logits"
    return dict(run_s=run_s, decode_steps=len(per_step), k1=k1,
                k1_tile=k1_tile, k1_decode=k1_decode, k2=k2, k3=k3,
                k1_per_step=min(s[0] for s in per_step),
                k3_per_step=min(s[1] for s in per_step))


def _kernel_table(prof, n: int, n_top: int = 6):
    """From a torch.profiler (CUPTI) run of ``n`` steps: kernels' device ms,
    kernel launches and aten ops per step, and the ``n_top`` kernels by
    device time as (name, ms per step, launches per step)."""
    from torch.autograd import DeviceType

    dev_t = lambda x: getattr(x, "self_device_time_total",  # noqa: E731
                              getattr(x, "self_cuda_time_total", 0))
    avgs = prof.key_averages()
    kern = [x for x in avgs if x.device_type == DeviceType.CUDA]
    top = sorted(kern, key=dev_t, reverse=True)[:n_top]
    return (sum(dev_t(x) for x in kern) / 1e3 / n,
            sum(x.count for x in kern) / n,
            sum(x.count for x in avgs if x.key.startswith("aten::")) / n,
            [(x.key, dev_t(x) / n / 1e3, x.count / n) for x in top])


def _b1_decode(model, cfg, rng, n_steps=48, n_prof=8):
    """b1 decode on the engine settings of phase 5: host ms per step over
    ``n_steps`` (crosses a hot-ring flush), then ``n_prof`` steps under
    torch.profiler (CUPTI): kernels' device ms, kernel launches and aten
    ops per step; busy share = device ms over the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile
    from quip_tpu_torch.serve.engine import Engine

    e = Engine(model, cfg, max_batch=1, max_seq=1024, hot=32, page=64,
               cache_dtype=torch.bfloat16, device="cuda")
    e.submit(rng.integers(0, cfg.vocab_size, 37).tolist(),
             max_new_tokens=n_steps + 8)
    e.step()                     # admission + first decode
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_steps):
        e.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / n_steps
    # profile a fresh engine's first steps (one 64-row page in use)
    e = Engine(model, cfg, max_batch=1, max_seq=1024, hot=32, page=64,
               cache_dtype=torch.bfloat16, device="cuda")
    e.submit(rng.integers(0, cfg.vocab_size, 37).tolist(),
             max_new_tokens=n_prof + 8)
    e.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            e.step()
        torch.cuda.synchronize()
    dev_ms, launches, aten, top = _kernel_table(prof, n_prof)
    return dict(ms_per_step=ms, tok_s=1e3 / ms, device_ms=dev_ms,
                kernel_launches=launches, aten_ops=aten,
                busy=dev_ms / ms if dev_ms else None, top=top)


def phase_serve(name: str, smi: str):
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.models.build import packed_llama
    from quip_tpu_torch.serve.engine import Engine

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama-2-7b")
    t = time.time()
    model = packed_llama(cfg, bits=2, seed=0, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    torch.cuda.synchronize()
    log(f"built 32-layer 2-bit Llama-2-7B (packed lm_head) in "
        f"{time.time() - t:.1f} s")
    rng = np.random.default_rng(0)
    prompts = {n: rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (600, 128, 37, 5, 200)}
    cache_bytes = lambda e: sum(  # noqa: E731
        t.numel() * t.element_size() for t in e.pkv
        if isinstance(t, torch.Tensor) and t.is_cuda)

    # --- the first slice's path: un-fused RHT, bf16 KV, no prefix ---------
    eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                 cache_dtype=torch.bfloat16, device="cuda")
    reqs = [dict(prompt=prompts[n], max_new_tokens=40)
            for n in (600, 128, 37, 5)]
    with fused_rht(False):
        base = _run_engine(eng, reqs, cfg)
    base.update(cache_gib=cache_bytes(eng) / 2 ** 30,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"Engine.run (bf16 KV, un-fused RHT): 4 requests in "
        f"{base['run_s']:.2f} s, {base['decode_steps']} decode steps, K1 "
        f"launches {base['k1']} ({base['k1_decode']} K1-decode, "
        f"{base['k1_tile']} K1-tile), K2 "
        f"{base['k2']}, K3 {base['k3']}; KV cache "
        f"{base['cache_gib']:.3f} GiB, peak {base['peak_gib']:.2f} GiB")
    assert base["k1_per_step"] >= 129, base
    assert base["k2"] >= 32 and base["k3"] == 0, base
    # the 600-token prompt alone: 128 packed linears at 600 rows
    assert base["k1_tile"] >= 128, base
    # every K1 launch is one of the two kernels; decode steps take K1-decode
    assert base["k1_decode"] + base["k1_tile"] == base["k1"], base
    assert base["k1_decode"] >= 129 * base["decode_steps"], base
    RESULTS["serve"] = base

    # prefill of the 600-token prompt; K1 launches in it
    from quip_tpu_torch.kernels import dequant_matmul as DM
    p600 = torch.tensor(prompts[600], device="cuda")[None]
    kv = eng._sync_pkv()
    pre_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        k1, k1t = DM.launches, DM.launches_tile
        t = time.perf_counter()
        PG.paged_prefill_slot(eng.params, p600, 600, kv, 0, cfg)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t) * 1e3)
        k1_prefill = DM.launches - k1
        k1_tile_prefill = DM.launches_tile - k1t
    prefill_ms = min(pre_ms)
    assert k1_tile_prefill >= 128, k1_tile_prefill
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        PG.paged_prefill_slot(eng.params, p600, 600, kv, 0, cfg)
        torch.cuda.synchronize()
    pre_dev_ms, pre_launches, pre_aten, pre_top = _kernel_table(prof, 1, 8)
    del eng, kv
    torch.cuda.empty_cache()

    # --- this slice's configuration: fused RHT, int8 KV, shared prefix ----
    torch.cuda.reset_peak_memory_stats()
    with fused_rht(True):
        eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                     cache_dtype=torch.bfloat16, kv_quant=True,
                     shared_prefix=prompts[200], device="cuda")
        reqs = [dict(prompt=prompts[n], max_new_tokens=40) for n in
                (128, 37, 5)] + [dict(prompt=prompts[600], max_new_tokens=40,
                                      use_prefix=False)]
        conf = _run_engine(eng, reqs, cfg)
    conf.update(cache_gib=cache_bytes(eng) / 2 ** 30,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"Engine.run (QUIP_FUSED_RHT=1, int8 KV, 200-token shared prefix; "
        f"prompts 128/37/5 with it, 600 without): 4 requests in "
        f"{conf['run_s']:.2f} s, {conf['decode_steps']} decode steps, K1 "
        f"launches {conf['k1']} ({conf['k1_decode']} K1-decode, "
        f"{conf['k1_tile']} K1-tile), K2 "
        f"{conf['k2']}, K3 {conf['k3']} (per "
        f"decode step at least K1 {conf['k1_per_step']}, K3 "
        f"{conf['k3_per_step']}); KV cache {conf['cache_gib']:.3f} GiB, "
        f"peak {conf['peak_gib']:.2f} GiB")
    assert conf["k3_per_step"] >= 258 and conf["k1_per_step"] >= 129, conf
    assert conf["k2"] == 32 and conf["k1_tile"] >= 128, conf
    assert conf["k1_decode"] >= 129 * conf["decode_steps"], conf
    RESULTS["serve_fused_int8_prefix"] = conf
    del eng
    torch.cuda.empty_cache()

    # --- timings ------------------------------------------------------------
    e = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
               cache_dtype=torch.bfloat16, device="cuda")
    for _ in range(4):
        e.submit(rng.integers(0, cfg.vocab_size, 37).tolist(),
                 max_new_tokens=100)
    e.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(24):
        e.step()
    torch.cuda.synchronize()
    b4_ms = (time.perf_counter() - t) * 1e3 / 24
    del e
    b1 = {}
    for fused in (False, True):
        with fused_rht(fused):
            b1[fused] = _b1_decode(model, cfg, rng)
    log(f"prefill 600 tokens: {prefill_ms:.1f} ms "
        f"({600 / prefill_ms * 1e3:.0f} tok/s; was {BEFORE['prefill_ms']} "
        f"ms), {k1_prefill} K1 launches, {k1_tile_prefill} of them K1-tile; "
        f"profiled: {pre_dev_ms:.2f} ms of kernels, {pre_launches:.0f} "
        f"kernel launches, {pre_aten:.0f} aten ops; device busy share "
        + (f"{pre_dev_ms / prefill_ms:.1%}" if pre_dev_ms else "not measured"))
    for key, ms, cnt in pre_top:
        log(f"  {key[:60]:60s} {ms:.3f} ms, {cnt:.0f} launches")
    log(f"decode b4 (un-fused, 24 steps): {b4_ms:.2f} ms/step, "
        f"{4e3 / b4_ms:.1f} tok/s")
    for fused, d in b1.items():
        log(f"decode b1, QUIP_FUSED_RHT={int(fused)}: "
            f"{d['ms_per_step']:.2f} ms/step ({d['tok_s']:.2f} tok/s); "
            f"profiled: {d['device_ms']:.2f} ms of kernels per step, "
            f"{d['kernel_launches']:.0f} kernel launches, "
            f"{d['aten_ops']:.0f} aten ops; device busy share "
            + (f"{d['busy']:.1%}" if d["busy"] else "not measured"))
        for key, ms, cnt in d["top"]:
            log(f"  {key[:60]:60s} {ms:.3f} ms/step, {cnt:.0f} "
                f"launches/step")
    log(f"card: {smi}")
    RESULTS["serve"].update(prefill_ms=prefill_ms, k1_prefill=k1_prefill,
                            k1_tile_prefill=k1_tile_prefill,
                            prefill_device_ms=pre_dev_ms,
                            prefill_kernel_launches=pre_launches,
                            prefill_aten_ops=pre_aten, prefill_top=pre_top,
                            b4_ms_per_step=b4_ms, b1_unfused=b1[False],
                            b1_fused=b1[True])
    return base, conf


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()
    t0 = time.time()
    name, smi = phase_device()
    k1, k1t = phase_k1(name)
    k2_err, k2 = phase_k2(name)
    k3_err, k3 = phase_k3(name)
    with watchdog(600, "the K1' phase"):
        k1p_err, k1p = phase_k1p(name)
    phase_slice()
    base, conf = phase_serve(name, smi)
    # launches: K1-decode, K1-tile and K2 from the first slice's Engine.run, K3
    # from the fused / int8 / prefix Engine.run, K1' from the
    # microbenchmark's path
    kernels = [
        dict(name="dequant_matmul_decode", route="cuda",
             source="quip_tpu_torch/kernels/csrc/dequant_matmul_decode.cu",
             replaces="quip_tpu/kernels/dequant_matmul.py:183",
             launches=base["k1_decode"],
             launches_fused_int8_prefix=conf["k1_decode"],
             max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"],
             max_rel_err=k1["max_rel_err"], ms_b8=k1["ms_b8"],
             bound_ms_b8=k1["bound_ms_b8"], library_ms_b8=k1["library_ms_b8"],
             shape="sum over wqkv, wo, wgu, wd, lm_head at B=1 (and B=8)"),
        dict(name="dequant_matmul_tile", route="cuda",
             source="quip_tpu_torch/kernels/csrc/dequant_matmul_tile.cu",
             replaces="quip_tpu/kernels/dequant_matmul.py:183",
             launches=base["k1_tile"],
             launches_fused_int8_prefix=conf["k1_tile"],
             max_abs_err=k1t["max_abs_err"],
             ms=k1t["ms"], plain_ms=k1t["plain_ms"],
             bound_ms=k1t["bound_ms"], bound_by=k1t["bound_by"],
             library_ms=k1t["library_ms"], max_rel_err=k1t["max_rel_err"],
             shape="sum over wqkv, wo, wgu, wd, lm_head at B=600"),
        dict(name="flash_prefill", route="cuda",
             source="quip_tpu_torch/kernels/csrc/flash_attn.cu",
             replaces="quip_tpu/kernels/flash_attn.py:87",
             launches=base["k2"], launches_fused_int8_prefix=conf["k2"],
             max_abs_err=k2_err,
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2["library_ms"],
             shape="B=2 H=32 S=600 plen=[600,431]"),
        dict(name="rht_apply_fused", route="cuda",
             source="quip_tpu_torch/kernels/csrc/rht.cu",
             replaces="quip_tpu/kernels/rht.py:87",
             launches=conf["k3"], max_abs_err=k3_err,
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             max_rel_err_bf16=k3["max_rel_err_bf16"],
             max_rel_err_f32=k3["max_rel_err_f32"],
             empty_kernel_ms=k3["empty_ms"],
             empty_kernel_in_graph_ms=k3["empty_in_graph_ms"],
             shape="sum over the six (n, direction) pairs of a b1 decode "
                   "step: 4096 fwd/T, 11008 fwd, 12288 T, 22016 T, 32000 T; "
                   "bf16"),
        dict(name="slabdot_matmul", route="cuda",
             source="quip_tpu_torch/kernels/csrc/slabdot_matmul.cu",
             replaces="scripts/bench_kernel.py:69",
             launches=k1p["launches"], max_abs_err=k1p_err,
             ms=k1p["ms"], plain_ms=k1p["plain_ms"],
             bound_ms=k1p["bound_ms"], bound_by="bytes",
             library_ms=k1p["library_ms"], k1_ms=k1p["k1_ms"],
             max_rel_err=k1p["max_rel_err"],
             max_rel_err_vs_k1=k1p["max_rel_err_vs_k1"],
             best_tile_m=k1p["best_tile_m"],
             kernels_per_call=k1p["kernels_per_call"],
             smallest_tile_ms=k1p["smallest_tile_ms"],
             shape="sum over the microbenchmark's five shapes at B=1, each "
                   "at its best tile_m"),
    ]
    RESULTS["kernels"] = kernels
    RESULTS["total_s"] = time.time() - t0
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(RESULTS, f, indent=1)
    log(f"total {RESULTS['total_s']:.0f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
