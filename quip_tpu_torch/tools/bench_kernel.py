"""Packed-matmul kernel microbenchmark: K1's kernels against the slab-dot
variant.

    python -m quip_tpu_torch.tools.bench_kernel

The port's counterpart of ``scripts/bench_kernel.py``. For the five 2-bit
Llama-2-7B decode shapes at B = 1 it runs K1 as dispatched
(``dequant_matmul``, row "concat/dflt": K1-decode at this size), K1-tile
forced below its threshold (row "k1-tile") where it takes the shape, and K1′
(``slabdot_matmul``, one launch a call) at every legal ``tile_m`` of
``TILE_CANDIDATES``: first the agreement check (every variant within 2e-2
of max |y| of K1), then device times, with the first variant measured
again at the end (A/B/A) to expose drift. The last lines sum K1 and K1′
at its best ``tile_m`` over the five shapes. A time is a CUDA-graph replay
cycling through enough plane copies to pass the 50 MB L2
(``utils/timing.time_ms``); the GB/s column is the packed planes' bytes
over it, flagged when it exceeds the card's published memory rate. Needs
one CUDA card.
"""
from __future__ import annotations

import functools
import math
import subprocess
import sys
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from quip_tpu_torch.kernels.dequant_matmul import dequant_matmul, tile_takes
from quip_tpu_torch.kernels.slabdot import slabdot_matmul
from quip_tpu_torch.pack.format import PLANE_SPLITS
from quip_tpu_torch.utils.timing import card_peaks, time_ms

# 7B decode shapes (m, d): wo, qkv-fused, gate-up-fused, down, lm_head
SHAPES = [(4096, 4096), (12288, 4096), (22016, 4096), (4096, 11008),
          (32000, 4096)]
TILE_CANDIDATES = (512, 640, 1024, 1280, 2048, 3200, 5504)
AGREE = 2e-2          # of max |y|: the slab-dot route pays the 128·Σx fix-up

Planes = Tuple[torch.Tensor, ...]
Variant = Callable[[Planes], torch.Tensor]


def legal_tiles(m: int, tiles: Sequence[int] = TILE_CANDIDATES) -> List[int]:
    return [t for t in tiles if m % t == 0 and t % 128 == 0]


def make_case(m: int, d: int, bits: int, B: int, gen: torch.Generator,
              l2_bytes: float = 120e6):
    """(x bf16 (B, d), plane copies, scale): random plane words (uniform
    codes) on ``gen``'s device, in enough copies to exceed ``l2_bytes``."""
    dev = gen.device
    pbytes = d * bits * m // 8
    copies = [tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                  dtype=torch.int32, generator=gen,
                                  device=dev)
                    for fb, _ in PLANE_SPLITS[bits])
              for _ in range(max(1, math.ceil(l2_bytes / pbytes)))]
    x = torch.randn(B, d, generator=gen, device=dev).bfloat16()
    return x, copies, torch.tensor(0.02, device=dev)


def variants(x: torch.Tensor, scale, bits: int, m: int,
             tiles: Sequence[int] = TILE_CANDIDATES) -> Dict[str, Variant]:
    """name -> f(planes): K1 as dispatched first, K1-tile forced where it
    takes the shape, then K1′ per legal tile_m."""
    out: Dict[str, Variant] = {
        "concat/dflt": lambda planes: dequant_matmul(
            x, planes, scale, None, bits=bits, qfn="b")}
    if tile_takes(x.shape[1], m, bits):
        out["k1-tile"] = lambda planes: dequant_matmul(
            x, planes, scale, None, bits=bits, qfn="b", path="tile")
    for tm in legal_tiles(m, tiles):
        out[f"slabdot/{tm}"] = lambda planes, tm=tm: slabdot_matmul(
            x, planes, scale, bits=bits, tile_m=tm)
    return out


def check_agreement(vs: Dict[str, Variant], planes: Planes
                    ) -> Dict[str, float]:
    """max |y - y_K1| / max |y_K1| per variant; raises above AGREE."""
    yref = vs["concat/dflt"](planes).float()
    errs = {}
    for name, fn in vs.items():
        y = fn(planes).float()
        errs[name] = ((y - yref).abs().max()
                      / (yref.abs().max() + 1e-9)).item()
        if not errs[name] < AGREE:
            raise RuntimeError(f"{name}: disagrees with K1 by {errs[name]:.3e}"
                               f" of max |y| (limit {AGREE})")
    return errs


def time_variants(vs: Dict[str, Variant], copies: Sequence[Planes],
                  iters: int = 20) -> List[Tuple[str, float]]:
    """[(name, device ms)] in order, the first variant again at the end."""
    order = list(vs.items())
    order.append((order[0][0] + "#2", order[0][1]))
    return [(name, time_ms([functools.partial(fn, c) for c in copies], iters))
            for name, fn in order]


def bench_shape(m: int, d: int, *, bits: int = 2, B: int = 1,
                tiles: Sequence[int] = TILE_CANDIDATES, seed: int = 0,
                iters: int = 20):
    """Agreement, then times, for one shape. Returns (rows, case): rows of
    dict(name, ms, gbs, err, suspect), case = (x, copies, scale)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, copies, scale = make_case(m, d, bits, B, gen)
    vs = variants(x, scale, bits, m, tiles)
    errs = check_agreement(vs, copies[0])
    pbytes = d * bits * m // 8
    peak_bw = card_peaks(torch.cuda.get_device_name(0))[0]
    rows = []
    for name, ms in time_variants(vs, copies, iters):
        bw = pbytes / (ms * 1e-3)
        rows.append(dict(name=name, ms=ms, gbs=bw / 1e9,
                         err=errs[name.split("#")[0]], suspect=bw > peak_bw))
    return rows, (x, copies, scale)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_kernel: no CUDA device", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; 2-bit, B = 1; memory rate "
          f"{card_peaks(name)[0] / 1e9:.0f} GB/s", flush=True)
    k1_us = best_us = 0.0
    for m, d in SHAPES:
        rows, case = bench_shape(m, d)
        for r in rows:
            flag = "  SUSPECT(>roofline)" if r["suspect"] else ""
            print(f"(m={m:5d}, d={d:5d}) {r['name']:14s} "
                  f"{r['ms'] * 1e3:7.1f} us  {r['gbs']:6.1f} GB/s  "
                  f"err {r['err']:.1e}{flag}", flush=True)
        k1_us += rows[0]["ms"] * 1e3
        best = min((r for r in rows if r["name"].startswith("slabdot/")),
                   key=lambda r: r["ms"])
        best_us += best["ms"] * 1e3
        print(f"(m={m:5d}, d={d:5d}) best K1′ tile_m: "
              f"{best['name'].split('/')[1]}", flush=True)
        del case
        torch.cuda.empty_cache()
    print(f"sum of the five shapes: K1 {k1_us:.1f} us, K1′ at its best "
          f"tile_m {best_us:.1f} us; card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
