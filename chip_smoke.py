"""On-card smoke test of the PyTorch/CUDA port (quip_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, sm_90a) and nvcc. It builds the
port's kernels from ``quip_tpu_torch/kernels/csrc`` and runs, in order:

  1. the card's name and power limit, and the kernel build (all five nvcc
     runs started together), with each K1-tile, K1-decode, K2, K3 and K1'
     kernel's registers, shared memory and spills from the ``-Xptxas -v``
     log (no wgmma serialised; K1-decode, K2, K3 and K1' spill nothing);
  2. K1 (dequant_matmul: the decode kernel K1-decode up to B = 8, the
     tile kernel K1-tile above, both on the tensor cores) against its plain
     version at the five 2-bit Llama-2-7B projection shapes (B = 1..4, 7, 8,
     9, 12, 16, 17, 24, 32, 128, 600, 1000, 2048: the last one perplexity
     window's rows) and at small 3/4/8-bit, qfn-a and code_bits=3 shapes
     (B up to 2048), three of them ragged and one that only K1-decode
     takes (m = 330: no tensor map, K1-decode's cp.async ring, counted),
     f32 and bf16 x, each kernel forced past its threshold too, with
     kernel, plain, bound and library (torch.matmul of the dequantised bf16
     weight) times, and both kernels' times at B = 1, 2, 4, 8, 9, 12, 16,
     24, 32 (the crossover); then OPT-6.7B's four shapes (fc2 at d = 16384)
     at B = 1, 2, 4, 8, 9, 16, 32, 37, 128, 600 and 2048, timed at all but
     37 and 128; K1-decode's and K1-tile's sums beside their bounds,
     torch.matmul and the mma.sync kernels' earlier times; then 3-bit codes
     at the five Llama-2-7B shapes as two planes and widened to 4-bit
     fields (code_bits=3, by ``widen_3bit``), each against its plain
     version and against the other at B = 1 (K1-decode) and 600
     (K1-tile), the widened layout also at B = 2, 4, 8, timed beside their
     bounds;
  3. K2 (flash_prefill) against its plain version, by the largest error
     and by each output row's largest error over that row's rms (B=2,
     H=32, S=600, plen=[600, 431]; GQA H=64, KV=8 and H=32, KV=8; S = 513
     with a row of plen 1; S = 1000, 2048 and 4096; GQA H=64, KV=8 at
     S = 2048), timed
     beside its bound, SDPA with the mask (the library yardstick) and,
     where plen is S, SDPA with is_causal; K2's ms in phase 7's profiled
     prefill and phase 10's profiled windows go to the kernels line too;
  4. K3 (rht_apply_fused) against its plain version at the five
     Llama-2-7B (a, b) splits and OPT-6.7B's n = 16384 (128 x 128), B in
     (1, 5, 32, 70), both directions, bf16 and f32, with a scaleWH fold,
     and a right-factor-free case; the round trip; times at B = 1, 2, 8,
     32 beside the un-fused apply_rht and beside an empty kernel's (the
     launch floor), summed over each model's pairs of a decode step; a
     Llama-2-7B layer's four fused linears (K3 -> K1-decode -> K3 each) in
     one graph at B = 1 and 4, its outputs against the eager chain's, timed
     with K3 as it is and without programmatic dependent launch (a copy
     built in phase 1), in turns, and un-fused;
  5. K1' (slabdot_matmul) against its plain version and against K1 for
     bits 2/3/4, B = 1, 5, 8, 13 and every legal tile_m at two small shapes
     (one ragged), one device kernel per call (profiler), then through the
     microbenchmark's own functions (tools/bench_kernel.py) at its five
     shapes and every legal tile_m, the best kept, beside K1-decode and
     torch.matmul in the same call, the mma.sync K1''s earlier sum and the
     bound; under a watchdog (a barrier that never completes hangs);
  6. a 2-layer full-width packed Llama-2-7B: 600-token prefill + 4
     teacher-forced decode steps on the card vs the plain path on the CPU
     in f32 on the same weights, un-fused with bf16 KV and then with
     QUIP_FUSED_RHT=1 and an int8 cache;
  7. full-depth 2-bit Llama-2-7B with a packed lm_head served through
     ``Engine.run`` (4 greedy requests, prompts 600/128/37/5, 40 new tokens
     each), first un-fused with bf16 KV, then with QUIP_FUSED_RHT=1, int8
     KV and a 200-token shared prefix; the kernels' launch counters are
     zeroed just before each run and read just after; then a timed and a
     profiled 600-token prefill (its dm_tile and dm_prep kernels each as
     many as the K1-tile launches counted, K2's 32 flash_fwd kernels and
     their ms; a profile is taken again only when CUPTI recorded nothing,
     or when the trace holds a launch call without its kernel record for
     every kernel short);
  8. the same model through the overlapped pump (``Engine.warmup`` then
     ``run(chunked=True)``: each decode chunk a CUDA graph replay), in both
     configurations of phase 7 on its requests, the greedy tokens held
     equal to phase 7's request by request, the counters zeroed just before
     each run and read just after (a replay adds the launches its graph
     holds); warmup's seconds, graphs and pool bytes; then b1 and b4 decode
     through the serial step and through the pump, un-fused and with
     QUIP_FUSED_RHT=1: ms a step on the host clock (the pump's the median
     of 3 windows of 48 tokens a slot; the serial step over 16 / 12 steps
     at b1 / b4), kernel ms and launches a step by the profiler, K1-decode's
     and K3's ms a step among them (K3's also as the time it alone
     covers), the device's busy share (the union of its kernels' spans:
     kernels that overlap under programmatic dependent launch count once)
     and its idle ms a step (the unprofiled step's ms less the busy ms);
 11. (run right after phase 8, on the first SPEC_LAYERS of phase 7's
     blocks, a depth cut for the script's limit) speculative serving:
     phase 7's 4 greedy requests through ``warmup()`` and
     ``run(chunked=True)`` of a spec engine (K = 4) with a 4-layer
     self-draft and with a perfect draft (the target itself), un-fused with
     bf16 KV, then with QUIP_FUSED_RHT=1, int8 KV and the 200-token prefix;
     each greedy token the teacher-forced argmax of the target or within a
     stated tolerance of it, and two planted faults (every draft token
     emitted unverified; a stream one row early) outside it; acceptance,
     launches by kernel, one sampled request; b1 and b4 decode of the
     self-draft through the spec pump (ms a token, launches an iteration
     by the profiler; the perfect draft's timing windows are cut);
     ``serve_http`` with 4 concurrent requests and a streamed one, their
     tokens the engine's; and ``cli/serve.main --self_draft 4 --warmup``
     on the model saved as a checkpoint, its tokens an Engine's;
 12. (run after phase 11) the OPT and BLOOM families: 2-layer full-width
     OPT-6.7B and BLOOM-7b1 (nonzero biases, dense tied head) held against
     the CPU f32 plain path as in phase 6; 2-bit OPT-6.7B at OPT_LAYERS
     of its 32 layers (a cut that pays for phase 17) serving phase 7's
     requests through the serial ``Engine.run`` and the
     pump, whose chunk graphs are built at first use, not warmed (greedy
     tokens equal, launches counted exactly), b1 pump decode (the b4
     window cut for phases 13-15) beside phase 8's Llama-2-7B; BLOOM-7b1 at 4 layers (ALiBi,
     int8 KV, QUIP_FUSED_RHT=1, a 200-token prefix) serial against the
     pump, K2 never launched; a 2-layer full-width OPT-6.7B quantized (32
     synthetic windows, LDLQ), LDLQ / nearest below 1 on every linear, a
     bit-exact checkpoint and its prefill against the f32 W_hat forward;
  9. (QUANT_LAYERS of 32 layers, a depth cut for the script's limit,
     which phases 10 and 15 read back) QuIP's quantization path on a
     full-width random Llama-2-7B through
     the quantize CLI's calls (synthetic calibration, 32 windows of 2048
     tokens, cut from the reference's 128 for the script's time limit;
     LDLQ with incoherence processing, the lm_head too): layer 0's
     tap Hessians with K2 against dense attention, seconds a layer by part,
     K2's calibration launches, peak memory, LDLQ / nearest proxy-loss
     ratios on the first and last layers and the head, K1 on the packed layers
     against the quantizer's f32 W_hat, a bit-exact checkpoint round trip,
     and the loaded checkpoint served by ``Engine.run`` (4 greedy requests)
     with its first 600-token prefill held against the f32 W_hat forward;
 10. QuIP's evaluation stage on phase 9's checkpoint: perplexity of the
     synthetic test stream (8 windows of 2048 tokens) through
     ``cli/eval.main`` for the dense bf16 source and the packed 2-bit
     checkpoint, seconds, tokens/s and launches a window (K1-tile at 2048
     rows, K2 at S = 2048), one window of each profiled; the packed window
     against the checkpoint unpacked to f32 and the dense one with K2
     against dense attention; ``cli/zeroshot.main`` (synthetic, piqa,
     arc_easy over synthetic docs), a few requests against the unpacked
     model, and ``TorchLM.greedy_until`` through the Engine (K1-decode).
 13. (run right after phase 8, on phase 7's model) the slot arena,
     ``Engine(paged=False)``: phase 7's 4 requests through the serial
     ``run()`` (un-fused, bf16 arena; each greedy token held to phase 11's
     teacher-forced check), ``warmup()`` (seconds, graphs), the same
     requests through ``run(chunked=True)`` (chunk graphs) with the serial
     run's tokens, launches by kernel (K2 and K1' read 0), ms a step with
     1 and 4 of the 4 slots busy beside phase 8's pump; then
     QUIP_FUSED_RHT=1 with an int8 arena, serial, K3's launches read;
 14. (after phase 12) a full-width 3-bit Llama-2-7B of W3_LAYERS layers
     through the arena Engine, widened at load (seconds a layer) and with QUIP_NO_WIDEN3=1, both held to the
     teacher-forced check against the two-plane model;
 15. (after phase 10, on phase 9's checkpoint) the decode-benchmark CLI,
     ``cli/bench.main`` at --batch 1 and 4, arena and --paged, --check;
     its JSON lines printed, every slot's greedy stream held to phase
     11's teacher-forced check.
 16. (after phase 15) the quantizer's options on Llama-2-7B at its
     published widths, BF_LAYERS layers: ``cli/quantize.main`` with
     --pre_proj and no --proj_mode ('noblock' butterflies), ldlqRG, the head, --resume_dir
     and --trace on BF_NSAMPLES windows of 2048 tokens, then the same
     command resumed (blocks and the head's planes bit for bit); the
     butterfly checkpoint served by ``Engine.run`` (arena, then paged),
     each token held to the teacher-forced check, a planted fault (U's
     butterfly un-transposed) above it; 8-bit ActQuant wrappers around
     it, calibrated and served; random-code 'rht', 'noblock' and 'block'
     models: rotation bytes a layer, b1 / b4 pump decode; ``cli/tools``
     save-hessians, hsummary and proxy on layer 0's wo and wd for every
     rounder against nearest (each ratio below 1); host offload against
     the same quantization on the card (codes equal, lower peak memory).
 17. (after phase 16) parallelism, ranks sharing the card over gloo
     (``parallel/mesh.py::run_ranks``; the collectives gloo lacks for CUDA
     tensors staged through the host by parallel/comm.py): 17a K1-decode
     (B = 1, 2, 4, 8) and K1-tile (B = 600) on the column shards of Llama-2-7B's
     four stacked linears at tp = 2 and 4, joined against the unsharded
     call, times beside bounds; 17b tp = 2 at full depth, phase 7's four
     requests (16 new tokens) through the serial ``Engine(mesh=).run``,
     each token held to the unsharded teacher-forced forward, launches
     by rank, a decode step's collectives (5 all-gathers a layer) and ms;
     17c dp = 2 x tp = 2 on PAR_LAYERS layers, int8 KV, the 200-token
     prefix, likewise; 17d pp = 2, ``pipelined_forward`` at B = 4, S =
     512, M = 2 and 4 against the unsharded forward, K2 launches, the
     host-staged bytes against ``pipeline_comm_bytes``; 17e
     ``cli/quantize.main --dp 2`` (2 layers, 8 windows of 2048 tokens)
     against ``--dp 1``: Hessians, codes, seconds a layer.
 18. (after phase 15, on phase 9's checkpoint; HOST_BUDGET_S) the host
     packer and the tools CLI's transcode and counter: 18a one full-width
     Llama-2-7B layer's four fused linears and its 32000-row head as 2-bit
     codes, then the four at 3 bits, packed on the host by the host packer
     (``pack/native.py``, g++) and by the plain torch ops, planes equal bit
     for bit, unpacked both ways, the 3-bit planes widened to 4-bit
     fields, seconds and threads; 18b ``cli/tools.main(["transcode",
     ...])`` on the card (seconds, bytes written, the linears float32 and
     every other leaf as stored), the dense checkpoint as an f32 model
     against the packed one (K1, K2) on phase 7's four prompts within
     TRANSCODE_TOL of max |logit|, the output deleted; 18c
     ``cli/tools.main(["counter"])`` at its default sizes on the card
     against the port's float64 CPU rows within COUNTER_TOL.

Every phase asserts; any failure exits nonzero. The script logs its
seconds by phase. The line before the last is the kernels' JSON record,
the last line ``{"ok": true, "device": ...}``.
``--out DIR`` also writes every measurement to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
    # phase 4's K3 without programmatic dependent launch (a tools/variants.py
    # copy, kept in kernels/_build by its hash), compiled beside the sources
    import threading
    nopdl = threading.Thread(target=_build_k3_nopdl)
    nopdl.start()
    logs = _build.build_all(["dequant_matmul_decode", "dequant_matmul_tile",
                             "flash_attn", "rht", "slabdot_matmul"])
    nopdl.join()
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
    RESULTS["ptxas_tile"] = _ptxas_kernels(logs["dequant_matmul_tile"])
    for k in RESULTS["ptxas_tile"]:
        log(f"  ptxas dequant_matmul_tile {k['kernel']}: {k['registers']} "
            f"registers, {k['smem']} bytes static smem, {k['spill']} bytes "
            f"spilled")
    from quip_tpu_torch.tools.variants import serialised
    serial = serialised(logs["dequant_matmul_tile"])
    log(f"  ptxas dequant_matmul_tile: {serial} kernels with wgmma "
        f"serialised (C7513 / C7515)")
    assert serial == 0, "ptxas serialised K1-tile's wgmma"
    RESULTS["ptxas_decode"] = _ptxas_kernels(logs["dequant_matmul_decode"])
    for k in RESULTS["ptxas_decode"]:
        log(f"  ptxas dequant_matmul_decode {k['kernel']}: {k['registers']} "
            f"registers, {k['smem']} bytes static smem, {k['spill']} bytes "
            f"spilled")
    serial = serialised(logs["dequant_matmul_decode"])
    log(f"  ptxas dequant_matmul_decode: {serial} kernels with wgmma "
        f"serialised (C7513 / C7515)")
    assert serial == 0, "ptxas serialised K1-decode's wgmma"
    assert RESULTS["ptxas_decode"] and not any(
        k["spill"] for k in RESULTS["ptxas_decode"]), RESULTS["ptxas_decode"]
    RESULTS["ptxas_flash"] = _ptxas_kernels(logs["flash_attn"])
    for k in RESULTS["ptxas_flash"]:
        log(f"  ptxas flash_attn {k['kernel']}: {k['registers']} registers, "
            f"{k['smem']} bytes static smem, {k['spill']} bytes spilled")
    serial = serialised(logs["flash_attn"])
    log(f"  ptxas flash_attn: {serial} kernels with wgmma serialised "
        f"(C7513 / C7515)")
    assert serial == 0, "ptxas serialised K2's wgmma"
    assert RESULTS["ptxas_flash"] and not any(
        k["spill"] for k in RESULTS["ptxas_flash"]), RESULTS["ptxas_flash"]
    RESULTS["ptxas_rht"] = [k for k in _ptxas_kernels(logs["rht"])
                            if k["kernel"].startswith("rht_mma")]
    for k in RESULTS["ptxas_rht"]:
        log(f"  ptxas rht {k['kernel']}: {k['registers']} registers, "
            f"{k['smem']} bytes static smem, {k['spill']} bytes spilled")
    serial = serialised(logs["rht"])
    log(f"  ptxas rht: {serial} kernels with wgmma serialised (C7513 / "
        f"C7515)")
    assert serial == 0, "ptxas serialised K3's wgmma"
    assert RESULTS["ptxas_rht"] and not any(
        k["spill"] for k in RESULTS["ptxas_rht"]), RESULTS["ptxas_rht"]
    RESULTS["ptxas_slabdot"] = [
        k for k in _ptxas_kernels(logs["slabdot_matmul"])
        if k["kernel"].startswith("sd_kernel")]
    for k in RESULTS["ptxas_slabdot"]:
        log(f"  ptxas slabdot_matmul {k['kernel']}: {k['registers']} "
            f"registers, {k['smem']} bytes static smem, {k['spill']} bytes "
            f"spilled")
    serial = serialised(logs["slabdot_matmul"])
    log(f"  ptxas slabdot_matmul: {serial} kernels with wgmma serialised "
        f"(C7513 / C7515)")
    assert serial == 0, "ptxas serialised K1's wgmma"
    assert len(RESULTS["ptxas_slabdot"]) == 4 and not any(
        k["spill"] for k in RESULTS["ptxas_slabdot"]), RESULTS["ptxas_slabdot"]
    assert "entry" in K3_NOPDL, K3_NOPDL.get("error")
    return name, smi


# phase 4's copy of rht.cu without programmatic dependent launch (the
# bf16 entry), built by phase 1
K3_NOPDL: dict = {}


def _build_k3_nopdl():
    from quip_tpu_torch.tools.tune_rht import ARGS, no_pdl
    from quip_tpu_torch.tools.variants import build, source
    try:
        K3_NOPDL["entry"] = build({"no PDL": no_pdl(source("rht.cu"))},
                                  "quip_rht_apply_bf16", ARGS,
                                  cached=True)["no PDL"]
    except Exception as e:          # reported by phase 1's assertion
        K3_NOPDL["error"] = repr(e)[-2000:]


def _ptxas_kernels(text: str) -> list:
    """Each kernel's registers, static shared memory and spilled bytes from
    an ``nvcc -Xptxas -v`` log (kernel names demangled to their templates:
    ``dm_tile<128>``, ``dm_decode<1, false>``, ``sd_kernel<2, 1>``,
    ``flash_fwd``)."""
    import re
    out, kernel, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw, spill = m.group(1), 0
            t = re.search(r"\d+((?:dm|rht|sd)_[a-z_]+)I((?:L[ib]\d+E)+)E",
                          raw)
            u = re.search(r"(\d+)(dm_\w+?)I(\w+?)EE", raw)
            kernel = (t.group(1) + "<" + ", ".join(
                v if k == "i" else ("true" if v == "1" else "false")
                for k, v in re.findall(r"L([ib])(\d+)E", t.group(2))) + ">"
                      if t else
                      f"{u.group(2)}<{re.sub(r'^\d+(?=\D)', '', u.group(3))}>"
                      if u else
                      re.sub(r"^.*?\d+((?:dm|flash)_\w+?)E.*$", r"\1", raw))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and kernel:
            out.append(dict(kernel=kernel, registers=int(m.group(1)),
                            smem=int(m.group(2) or 0), spill=spill))
            kernel = None
    return out


# earlier slices' times on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md
# section 6), printed beside this run's
BEFORE = dict(k1_sum_b600_ms=20.56, k1_sum_b32_ms=1.219, prefill_ms=437.4,
              # K2 on mma.sync, before its wgmma redesign, by (B, H, KV,
              # S); S = 4096 and H = 64 KV = 8 S = 2048 timed by
              # tools/tune_flash.py --against the mma.sync source
              k2_ms={(2, 32, 32, 600): 0.0557, (2, 64, 8, 600): 0.0989,
                     (1, 32, 32, 1000): 0.0773, (2, 32, 8, 600): 0.0558,
                     (2, 32, 32, 513): 0.0341, (1, 32, 32, 2048): 0.2346,
                     (1, 32, 32, 4096): 0.7963, (1, 64, 8, 2048): 0.4246},
              # B -> (the CUDA-core K1, K1-tile), sums of the five shapes
              k1_sums_ms={1: (0.1327, 0.1059), 8: (0.3652, 0.1090)},
              # K1-decode on mma.sync before its wgmma redesign (PR 4-16):
              # B -> ms, sums of the five Llama-2-7B (four OPT-6.7B) shapes
              k1d_ms={1: 0.0865, 2: 0.0894, 4: 0.0958, 8: 0.1053},
              k1d_opt_ms={1: 0.0646, 4: 0.0732, 8: 0.0806},
              k3_sum_ms=0.1271,
              # K3 on mma.sync, before its wgmma redesign: B -> ms, the
              # six pairs of a Llama-2-7B decode step; OPT-6.7B's five at
              # B = 1
              k3_mma_sync_ms={1: 0.0482, 2: 0.0471, 8: 0.0494, 32: 0.0644},
              k3_opt_mma_sync_ms=0.0332,
              # K1' on CUDA cores, and on mma.sync before its wgmma
              # redesign: five shapes, B = 1, best tile_m
              k1p_sum_ms=0.1178, k1p_mma_sync_sum_ms=0.1050,
              # K1-tile on mma.sync before its wgmma redesign (PR 3-14):
              # (model, B) -> ms, sums of the five (four OPT) shapes
              k1t_ms={("Llam", 16): 0.1172, ("Llam", 32): 0.1520,
                      ("Llam", 600): 1.4740, ("Llam", 2048): 4.1809,
                      ("OPT-", 600): 0.9591, ("OPT-", 2048): 2.5617})


# phase 3's shapes (B, H, KV, S, plen): the first is the kernels line's
K2_SHAPES = [(2, 32, 32, 600, [600, 431]), (2, 64, 8, 600, [600, 431]),
             (1, 32, 32, 1000, [1000]), (2, 32, 8, 600, [600, 431]),
             (2, 32, 32, 513, [513, 1]), (1, 32, 32, 2048, [2048]),
             (1, 32, 32, 4096, [4096]), (1, 64, 8, 2048, [2048])]


# K2's limit on each output row's largest error over that row's rms: a
# long row's values are small (std about sqrt(e / n) at n keys), so the
# 2e-2 absolute limit alone would pass a key tile dropped from the last
# rows at S = 4096. The kernel's arithmetic in plain PyTorch
# (flash_prefill_tiled_ref) reads 1.5-1.7e-2 against the plain version on
# the CPU (bf16 weights and output), the same walk with one key tile of
# the last query tile's rows dropped 1.05 at S = 4096
K2_ROW_TOL = 4e-2


def _row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| of an output row (query, head) over the rms of
    that row of ``want``, the worst row."""
    d = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().pow(2).mean(-1).sqrt()
    return (d / rms.clamp_min(1e-6)).max().item()


def _names_of(prof) -> dict:
    """Device kernels of a torch.profiler (CUPTI) run as {name: count}, a
    kernel of this repo's sources named by its function (``dm_tile``)."""
    import re
    from torch.autograd import DeviceType
    names = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            m = re.search(r"\b(dm_\w+?|[a-z]\w*_kernel)\b(?=[<(])", e.key)
            k = m.group(1) if m else e.key
            names[k] = names.get(k, 0) + e.count
    return names


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
    ragged = {"decode": 0, "tile": 0}

    def check(x, pl, scale, zero, what, path=None, **kw):
        """Kernel against plain: f32 x holding bf16 values, so both see the
        same x and differ only in the summation order (1e-3 of max |y|),
        then bf16 in and out (1e-2: the output's rounding). The counters
        must say that the kernel the rule (or ``path``) names was the one
        launched. Returns the path taken and both errors."""
        B, d = x.shape
        want_path = path or DM.route(B, d, pl[0].shape[-1], kw["bits"])
        t0, d0 = DM.launches_tile, DM.launches_decode
        r0 = DM.launches_decode_ragged
        xf = x.float()
        got = DM.dequant_matmul(xf, pl, scale, zero, path=path, **kw)
        took = (DM.launches_tile - t0, DM.launches_decode - d0)
        assert took == ((1, 0) if want_path == "tile" else
                        (0, -(-B // DM.DECODE_MAX_B))), (what, want_path, took)
        # planes with no tensor map take K1-decode's cp.async ring, by shape
        ragged[want_path] += DM.launches_decode_ragged - r0
        assert DM.launches_decode_ragged - r0 == (
            took[1] if DM.decode_ragged(pl) else 0), (what, took)
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
    # a ragged group of word rows, m = 328 and 72 ragged blocks of 256
    # columns (72: one block of the cluster's two has no columns at all);
    # m = 330 (no multiple of 4) and d = 96 are shapes K1-tile does not
    # take: they go to K1-decode at any B, 8 rows at a time
    for bits, qfn, code_bits in [(2, "b", None), (3, "b", None),
                                 (4, "b", None), (8, "b", None),
                                 (4, "b", 3), (2, "a", None),
                                 (4, "a", None)]:
        for m, d in ((640, 1024), (328, 1408), (72, 1408), (330, 96)):
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
                      1000, 2048):
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
        f"328x1408, 72x1408 and 330x96; B = 1..8 and 9..2048, f32 and bf16 "
        f"x): max rel err K1-decode {worst_rel['decode']:.2e}, K1-tile "
        f"{worst_rel['tile']:.2e} <= 1e-3; K1-decode's cp.async ring (m = "
        f"330, no tensor map) {ragged['decode']} launches")
    assert ragged["decode"] > 0 and ragged["tile"] == 0, ragged
    # 2048: the rows of one 2048-token perplexity window (phase 10)
    timed = (1, 2, 4, 8, 9, 12, 16, 24, 32, 128, 600, 2048)
    crossed = (1, 2, 4, 8, 9, 12, 16, 24, 32)
    scale = torch.tensor(0.02, device=dev)

    def sweep(model, shapes, checked, timed, crossed=()):
        """Each 2-bit projection shape against its plain version at every
        B of ``checked``; kernel, plain, bound and torch.matmul times at
        ``timed`` (each kernel forced at ``crossed`` too). Returns (rows,
        sums by B, crossover sums by B, bound words by B)."""
        rows = []
        sums = {B: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
                for B in timed}
        cross = {B: dict(decode=0.0, tile=0.0) for B in crossed}
        bound_by = {B: set() for B in timed}
        for sname, (m, d) in shapes.items():
            pbytes = d * 2 * m // 8
            ncopy = max(1, math.ceil(120e6 / pbytes))
            copies = [planes_for(m, d, 2) for _ in range(ncopy)]
            W = DM.dequant_weight(copies[0], scale, None, bits=2,
                                  d=d).to(torch.bfloat16)
            for B in checked:
                x = torch.randn(B, d, device=dev, generator=g).bfloat16()
                path, rel, rel16 = check(x, copies[0], scale, None,
                                         (sname, B), bits=2)
                if B not in sums:
                    continue

                def run(path=None, it=20 if B <= 128 else 5):
                    return time_ms([lambda c=c: DM.dequant_matmul(
                        x, c, scale, None, bits=2, path=path)
                        for c in copies], it)

                ms = run()
                # the plain version is timed at the rows the records keep
                plain = (time_ms([lambda: DM.dequant_matmul_ref(
                    x, copies[0], scale, None, bits=2)], 2)
                    if B not in (9, 12, 24) else float("nan"))
                lib = time_ms([lambda: torch.matmul(x, W.t())], 20)
                bms, by = bound_ms(B * d * 2 + pbytes + B * m * 2,
                                   2 * B * d * m, name)
                row = dict(model=model, shape=sname, m=m, d=d, B=B,
                           path=path, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by, rel_err=rel,
                           rel_err_bf16=rel16)
                extra = ""
                if B in cross:      # the other kernel at the same shape
                    other = "tile" if path == "decode" else "decode"
                    row[f"ms_{path}"] = ms
                    row[f"ms_{other}"] = run(other)
                    for k in cross[B]:
                        cross[B][k] += row[f"ms_{k}"]
                    extra = f", forced {other} {row[f'ms_{other}']:.4f} ms"
                rows.append(row)
                log(f"K1 {model} {sname:8s} {m}x{d} B={B:4d} [{path}]: "
                    f"{ms:.4f} ms (bound {bms:.4f} {by}, {bms / ms:.0%})"
                    f"{extra}, plain {plain:.3f} ms, torch.matmul bf16 "
                    f"{lib:.4f} ms, rel err {rel:.1e} / bf16 out "
                    f"{rel16:.1e}")
                bound_by[B].add(by)
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms), ("library_ms", lib)):
                    sums[B][k] += v
            del copies, W
            torch.cuda.empty_cache()
        return rows, sums, cross, bound_by

    rows, sums, cross, bound_by = sweep(
        "llama-2-7b",
        {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22528, 4096),
         "wd": (4096, 11008), "lm_head": (32000, 4096)},
        (1, 2, 3, 4, 7, 8, 9, 12, 16, 17, 24, 32, 128, 600, 1000, 2048),
        timed, crossed)
    # OPT-6.7B's (and BLOOM-7b1's) four projections, phase 12's path: fc2
    # reads d = 16384, the widest fan-in yet; the tied head is dense. Also
    # checked at the other row counts phase 12 gives K1-tile: the 37- and
    # 128-token prompts and the 32-row admission windows
    opt_timed = (1, 2, 4, 8, 9, 16, 32, 600, 2048)
    opt_rows, opt_sums, _, opt_by = sweep(
        "opt-6.7b", {"wqkv": (12288, 4096), "wo": (4096, 4096),
                     "fc1": (16384, 4096), "fc2": (4096, 16384)},
        (1, 2, 4, 8, 9, 16, 32, 37, 128, 600, 2048), opt_timed)
    w3 = _k1_widened(name, dev, g, scale, planes_for, check)
    for B in opt_timed:
        t = opt_sums[B]
        log(f"K1 sum of OPT-6.7B's four shapes, B={B:4d}: {t['ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ({t['bound_ms'] / t['ms']:.0%}), "
            f"plain {t['plain_ms']:.3f}, torch.matmul bf16 "
            f"{t['library_ms']:.4f}")
    for B in (1, 2, 4, 8):
        assert opt_sums[B]["ms"] < opt_sums[B]["library_ms"], (B, opt_sums)
    for B in timed:
        t = sums[B]
        log(f"K1 sum of the five shapes, B={B:4d}: {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ({t['bound_ms'] / t['ms']:.0%}), "
            f"torch.matmul bf16 {t['library_ms']:.4f}")
    for B in (1, 2, 4, 8):
        log(f"K1-decode on wgmma, B={B}: five Llama-2-7B shapes "
            f"{sums[B]['ms']:.4f} ms (mma.sync, PR 4-16: "
            f"{BEFORE['k1d_ms'][B]}), OPT-6.7B's four "
            f"{opt_sums[B]['ms']:.4f} ms (mma.sync: "
            f"{BEFORE['k1d_opt_ms'].get(B, '-')})")
    for B, c in cross.items():
        b = BEFORE["k1_sums_ms"].get(B)
        log(f"K1 crossover, B={B:2d}, sum of the five shapes: K1-decode "
            f"{c['decode']:.4f} ms"
            + (" (8 rows at a time)" if B > DM.DECODE_MAX_B else "")
            + f", K1-tile {c['tile']:.4f} ms"
            + (f"; the previous slice's CUDA-core kernel {b[0]} ms, its "
               f"K1-tile {b[1]} ms" if b else "")
            + f" (rule: K1-tile from B = {DM.TILE_MIN_B}; "
            + ("faster: " + min(c, key=c.get)) + ")")
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
    RESULTS["k1"] = rows + opt_rows
    RESULTS["k1_sums"] = {str(B): t for B, t in sums.items()}
    RESULTS["k1_sums_opt"] = {str(B): t for B, t in opt_sums.items()}
    RESULTS["k1_crossover"] = {str(B): c for B, c in cross.items()}
    for B in (1, 600, 2048):    # one word for each summed row
        assert len(bound_by[B]) == 1, (B, bound_by[B])
    for B in (1, 600, 2048):
        assert len(opt_by[B]) == 1, (B, opt_by[B])
    k1 = dict(sums[1], max_rel_err=worst_rel["decode"],
              max_abs_err=worst["decode"], bound_by=bound_by[1].pop(),
              launches_ragged_checks=ragged["decode"],
              **{f"{k}_b{B}": v for B in (2, 4, 8)
                 for k, v in sums[B].items()},
              **{f"{k}_opt_b{B}": v for B in (1, 2, 4, 8)
                 for k, v in opt_sums[B].items()},
              bound_by_opt_b1=opt_by[1].pop(),
              **{k: v for B in (1, 2, 4, 8) for k, v in w3[B].items()})
    for B in (16, 32, 600, 2048):
        for model, t in (("Llama-2-7B five", sums[B]),
                         ("OPT-6.7B four", opt_sums[B])):
            log(f"K1-tile {model} shapes, B={B:4d}: {t['ms']:.4f} ms "
                f"(earlier {BEFORE['k1t_ms'].get((model[:4], B), '-')}), "
                f"bound {t['bound_ms']:.4f}, torch.matmul "
                f"{t['library_ms']:.4f}")
    k1t = dict(sums[600], max_rel_err=worst_rel["tile"],
               max_abs_err=worst["tile"], bound_by=bound_by[600].pop(),
               **{f"{k}_b{B}": v for B in (16, 32)
                  for k, v in sums[B].items()},
               **{f"{k}_opt_b{B}": v for B in (16, 32)
                  for k, v in opt_sums[B].items()},
               **{f"{k}_b2048": v for k, v in sums[2048].items()},
               bound_by_b2048=bound_by[2048].pop(),
               **{f"{k}_opt_b600": v for k, v in opt_sums[600].items()},
               **{f"{k}_opt_b2048": v for k, v in opt_sums[2048].items()},
               bound_by_opt_b600=opt_by[600].pop(), **w3[600])
    return k1, k1t


LLAMA_SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096),
                "wgu": (22528, 4096), "wd": (4096, 11008),
                "lm_head": (32000, 4096)}


def _k1_widened(name: str, dev, g, scale, planes_for, check) -> dict:
    """Phase 2's 3-bit layouts: random 3-bit codes at the five Llama-2-7B
    shapes as quip_tpu's two planes (2 + 1 bits) and widened to one plane
    of 4-bit fields (``code_bits=3``, Engine's default at load), each
    through ``check`` (its plain version, at B = 1 for K1-decode and 600
    for K1-tile; the widened layout, Engine's, at B = 2, 4 and 8 too) and
    the widened output against the two planes' (the same codes: 1e-3 of
    max |y|, the summation order). Kernel, plain, bound and torch.matmul
    times. Returns, by B, the sums as the ``kernels`` line's
    ``*_w3_b{B}`` (widened) and ``*_3bit_b{B}`` (two planes) keys."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.pack import format as PF
    from quip_tpu_torch.utils.timing import time_ms

    lays = {"3bit": dict(bits=3), "w3": dict(bits=4, code_bits=3)}
    both = (1, 600)

    def lays_at(B):
        return lays if B in both else {"w3": lays["w3"]}

    sums = {B: {f"{k}_{lay}_b{B}": 0.0 for lay in lays_at(B)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for B in (1, 2, 4, 8, 600)}
    rows, worst = [], 0.0
    for sname, (m, d) in LLAMA_SHAPES.items():
        pbytes = {"3bit": d * 3 * m // 8, "w3": d * 4 * m // 8}
        ncopy = max(1, math.ceil(120e6 / pbytes["3bit"]))
        copies = {"3bit": [planes_for(m, d, 3) for _ in range(ncopy)]}
        copies["w3"] = [PF.widen_3bit(PF.PackedLinear(
            c, scale_b=scale, bits=3, qfn="b", proj_mode="rht",
            out_features=m, in_features=d)).planes for c in copies["3bit"]]
        W = DM.dequant_weight(copies["3bit"][0], scale, None, bits=3,
                              d=d).to(torch.bfloat16)
        for B in sums:
            x = torch.randn(B, d, device=dev, generator=g).bfloat16()
            for lay, kw in lays_at(B).items():
                check(x, copies[lay][0], scale, None, (lay, sname, B), **kw)
            row = dict(shape=sname, m=m, d=d, B=B)
            if B in both:
                ys = [DM.dequant_matmul(x.float(), copies[lay][0], scale,
                                        None, **kw)
                      for lay, kw in lays.items()]
                _, rel = rel_err(ys[1], ys[0])
                assert rel <= 1e-3, (sname, B, rel)
                worst = max(worst, rel)
                row["widened_vs_two_planes"] = rel
            lib = time_ms([lambda: torch.matmul(x, W.t())], 20)
            row["library_ms"] = lib
            for lay, kw in lays_at(B).items():
                ms = time_ms([lambda c=c: DM.dequant_matmul(
                    x, c, scale, None, **kw) for c in copies[lay]],
                    5 if B == 600 else 20)
                plain = time_ms([lambda: DM.dequant_matmul_ref(
                    x, copies[lay][0], scale, None, **kw)], 2)
                bms, by = bound_ms(B * d * 2 + pbytes[lay] + B * m * 2,
                                   2 * B * d * m, name)
                row.update({f"ms_{lay}": ms, f"plain_ms_{lay}": plain,
                            f"bound_ms_{lay}": bms, f"bound_by_{lay}": by})
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms), ("library_ms", lib)):
                    sums[B][f"{k}_{lay}_b{B}"] += v
            rows.append(row)
            log(f"K1 3-bit {sname:8s} {m}x{d} B={B:4d}: "
                + (f"two planes {row['ms_3bit']:.4f} ms (bound "
                   f"{row['bound_ms_3bit']:.4f} {row['bound_by_3bit']}), "
                   if B in both else "")
                + f"widened {row['ms_w3']:.4f} ms (bound "
                f"{row['bound_ms_w3']:.4f} {row['bound_by_w3']}); "
                f"torch.matmul bf16 {lib:.4f} ms"
                + (f"; widened vs two planes {row['widened_vs_two_planes']:.1e}"
                   if B in both else ""))
        del copies, W
        torch.cuda.empty_cache()
    for B, t in sums.items():
        log(f"K1 3-bit sum of the five shapes, B={B:4d}: "
            + (f"two planes {t[f'ms_3bit_b{B}']:.4f} ms (bound "
               f"{t[f'bound_ms_3bit_b{B}']:.4f}), " if B in both else "")
            + f"widened {t[f'ms_w3_b{B}']:.4f} ms (bound "
            f"{t[f'bound_ms_w3_b{B}']:.4f}); plain "
            + (f"{t[f'plain_ms_3bit_b{B}']:.3f} / " if B in both else "")
            + f"{t[f'plain_ms_w3_b{B}']:.3f} ms, torch.matmul bf16 "
            f"{t[f'library_ms_w3_b{B}']:.4f} ms")
    RESULTS["k1_3bit"] = dict(rows=rows, sums={str(B): t for B, t in
                                               sums.items()},
                              widened_vs_two_planes=worst)
    return sums


def phase_k2(name: str):
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = worst_row = 0.0
    rec = None
    for B, H, KV, S, plen in K2_SHAPES:
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
        row = _row_err(got, want)
        assert row <= K2_ROW_TOL, (B, H, KV, S, row)
        worst = max(worst, err)
        worst_row = max(worst_row, row)
        ms = time_ms([lambda: FA.flash_prefill_bshd(q, k, v, pl,
                                                    scale=scale)], 20)
        plain = time_ms([lambda: FA.flash_prefill_ref(q, k, v, pl,
                                                      scale=scale)], 3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & (i[None, None, :] < pl[:, None, None]))[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = time_ms([lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale,
                                    enable_gqa=KV != H)], 20)
        # the stronger yardstick where every row's plen is S
        causal = (time_ms([lambda: sdpa(qt, kt, vt, is_causal=True,
                                        scale=scale, enable_gqa=KV != H)],
                          20) if all(p == S for p in plen) else None)
        pairs = sum(min(r + 1, p) for p in plen for r in range(S))
        ops = 4 * pairs * H * hd
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        bms, by = bound_ms(nbytes, ops, name)
        was = BEFORE["k2_ms"][B, H, KV, S]
        log(f"K2 B={B} H={H} KV={KV} S={S} plen={plen}: {ms:.4f} ms "
            f"(bound {bms:.4f} {by}, {bms / ms:.0%} of it; the "
            f"mma.sync kernel {was}), plain {plain:.3f} ms, SDPA masked "
            f"{lib:.4f} ms ({lib / ms:.2f}x K2's)"
            + (f", causal {causal:.4f} ms ({causal / ms:.2f}x)"
               if causal is not None else "")
            + f", max abs err {err:.2e} <= 2e-2, worst row {row:.2e} <= "
            f"{K2_ROW_TOL:.0e} of its rms")
        r = dict(B=B, H=H, KV=KV, S=S, plen=plen, ms=ms, plain_ms=plain,
                 library_ms=lib, causal_ms=causal, bound_ms=bms, bound_by=by,
                 max_abs_err=err, max_row_rel_err=row, was_ms=was)
        RESULTS.setdefault("k2", []).append(r)
        if rec is None:
            rec = r
        del want, mask
        torch.cuda.empty_cache()
    rec = dict(rec, max_row_rel_err=worst_row)
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
    # side transpose; Llama-2-7B's, then OPT-6.7B's (and BLOOM-7b1's):
    # fc1's U side and fc2's V side at n = 16384
    on_path = {(4096, False), (4096, True), (11008, False), (12288, True),
               (22016, True), (32000, True)}
    opt_on_path = {(4096, False), (4096, True), (12288, True),
                   (16384, False), (16384, True)}
    splits = {4096: (64, 64), 11008: (128, 86), 12288: (128, 96),
              16384: (128, 128), 22016: (128, 172), 32000: (128, 250)}
    rows = []
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    opt_sums = dict(sums)
    n16k = dict(sums)                  # n = 16384, both directions, B = 1
    opt_bound_by = set()
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
                if B != 1:
                    continue
                kv = (("ms", ms), ("plain_ms", plain), ("bound_ms", bms),
                      ("library_ms", lib))
                for pairs, acc, words in ((on_path, sums, bound_by),
                                          (opt_on_path, opt_sums,
                                           opt_bound_by)):
                    if (n, tr) in pairs:
                        words.add(by)
                        for k, v in kv:
                            acc[k] += v
                if n == 16384:
                    for k, v in kv:
                        n16k[k] += v
    # one word for each summed row
    assert len(bound_by) == 1 and len(opt_bound_by) == 1, (bound_by,
                                                           opt_bound_by)
    sums["bound_by"] = bound_by.pop()
    for B, t in by_B.items():
        log(f"K3 sum of the six (n, direction) pairs of a decode step, bf16, "
            f"B={B:2d}: {t['ms']:.4f} ms (mma.sync: "
            f"{BEFORE['k3_mma_sync_ms'][B]}), un-fused apply_rht "
            f"{t['library_ms']:.4f} ms")
    log(f"K3 at B=1: {sums['ms']:.4f} ms (mma.sync: "
        f"{BEFORE['k3_mma_sync_ms'][1]}; second slice "
        f"{BEFORE['k3_sum_ms']}); bound {sums['bound_ms']:.5f} ms; launch "
        f"floor: an empty kernel replayed alone {empty_ms * 1e3:.2f} us a "
        f"launch ({6 * empty_ms:.4f} ms for six), ten to a graph "
        f"{empty10_ms * 1e3:.2f} us")
    opt_sums["bound_by"] = opt_bound_by.pop()
    log(f"K3 at B=1, OPT-6.7B's five (n, direction) pairs: "
        f"{opt_sums['ms']:.4f} ms (mma.sync: "
        f"{BEFORE['k3_opt_mma_sync_ms']}), bound {opt_sums['bound_ms']:.5f} ms "
        f"{opt_sums['bound_by']}, plain {opt_sums['plain_ms']:.4f}, "
        f"un-fused apply_rht {opt_sums['library_ms']:.4f}; n = 16384 "
        f"forward + transpose {n16k['ms']:.4f} ms (apply_rht "
        f"{n16k['library_ms']:.4f})")
    # fused beats un-fused in this call (the margin is 1.9x at B = 1)
    assert sums["ms"] < sums["library_ms"], sums
    sums.update(empty_ms=empty_ms, empty_in_graph_ms=empty10_ms,
                by_B={str(B): t for B, t in by_B.items()},
                **{f"{k}_opt_b1": v for k, v in opt_sums.items()},
                **{f"{k}_n16384_b1": v for k, v in n16k.items()})
    log(f"K3 vs plain, 5 Llama-2-7B splits, OPT-6.7B's 16384 and "
        f"right=None, B in (1, 5, 32, 70), "
        f"both directions, scaleWH fold: max rel err bf16 "
        f"{worst[torch.bfloat16]:.2e} <= 2e-2, f32 "
        f"{worst[torch.float32]:.2e} <= 2e-5; round trip <= 1e-5")
    RESULTS["k3"] = rows
    sums["max_rel_err_bf16"] = worst[torch.bfloat16]
    sums["max_rel_err_f32"] = worst[torch.float32]
    sums["chain"] = _k3_chain()
    return worst_abs, sums


def _k3_chain() -> dict:
    """Phase 4's layer chain: the four packed linears of a Llama-2-7B
    layer (wqkv, wo, wgu, wd; random codes, 'rht' rotations) through
    ``qlinear_apply`` at B = 1 and 4, one CUDA graph a chain, replayed:
    fused (K3(V) -> K1-decode -> K3(U) a linear, 12 launches; the graph's
    outputs equal to the eager chain's) with K3 as it is and with its copy
    without programmatic dependent launch (phase 1's), in turns, and
    un-fused (apply_rht's multiply and matmuls around K1-decode)."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import rht as K3
    from quip_tpu_torch.models.build import random_packed
    from quip_tpu_torch.ops.qlinear import qlinear_apply
    from quip_tpu_torch.tools.variants import swapped
    from quip_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    words = torch.Generator(device=dev).manual_seed(18)
    rots = torch.Generator().manual_seed(18)
    layers = [random_packed(m, d, 2, words=words, rots=rots, device=dev)
              for m, d in ((12288, 4096), (4096, 4096), (22016, 4096),
                           (4096, 11008))]
    out = {}
    for B in (1, 4):
        xs = {d: torch.randn(B, d, device=dev, generator=words).bfloat16()
              for d in (4096, 11008)}

        def chain():
            return [qlinear_apply(q, xs[q.in_features]) for q in layers]

        with fused_rht(True):
            k3, k1 = K3.launches, DM.launches_decode
            eager = chain()
            assert (K3.launches - k3, DM.launches_decode - k1) == (8, 4)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                chain()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = chain()
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(got, eager))
            del graph
            ms = dict(pdl=[], nopdl=[])
            for how in ("pdl", "nopdl", "nopdl", "pdl"):
                fn = K3._fn_bf16 if how == "pdl" else K3_NOPDL["entry"]
                with swapped(K3, _fn_bf16=fn):
                    ms[how].append(time_ms([chain], 200))
        with fused_rht(False):
            unfused = time_ms([chain], 200)
        out[f"b{B}"] = dict(ms_pdl=ms["pdl"], ms_nopdl=ms["nopdl"],
                            ms_unfused=unfused)
        log(f"K3 layer chain B={B} (wqkv, wo, wgu, wd: K3 -> K1-decode -> "
            f"K3 each, one graph; its outputs equal the eager chain's): "
            f"PDL {ms['pdl'][0]:.4f} / {ms['pdl'][1]:.4f} ms, without PDL "
            f"{ms['nopdl'][0]:.4f} / {ms['nopdl'][1]:.4f} ms (in turns); "
            f"un-fused {unfused:.4f} ms")
    return out


def _kernels_per_call(fn, sessions: int = 3) -> int:
    """Device kernels torch.profiler (CUPTI) sees in one call of ``fn``. A
    session that records no device kernel at all is run again, up to
    ``sessions`` times: on the card one such session once recorded nothing
    (torch 2.11), while the same call in a fresh process showed its one
    kernel. A call that launches nothing still reads 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return 0


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
        f"{sums['ms']:.4f} ms (earlier figures, not measured here: "
        f"mma.sync {BEFORE['k1p_mma_sync_sum_ms']}, CUDA cores "
        f"{BEFORE['k1p_sum_ms']}); at the smallest legal tile_m "
        f"{sums['smallest_tile_ms']:.4f}; bound {sums['bound_ms']:.4f} "
        f"({sums['bound_ms'] / sums['ms']:.0%} of it reached); K1-decode in "
        f"the same call {sums['k1_ms']:.4f} / again "
        f"{sums['k1_again_ms']:.4f}; torch.matmul bf16 "
        f"{sums['library_ms']:.4f}; card {RESULTS.get('card', name)}")
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
def _env(name: str, value: str):
    """``name=value`` in the environment inside the block (the port reads
    its switches at call time), the caller's value restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def fused_rht(on: bool):
    """QUIP_FUSED_RHT=1 (or 0) inside the block."""
    return _env("QUIP_FUSED_RHT", "1" if on else "0")


def phase_slice(combos=((False, False), (True, True))):
    """Phase 6: the 2-layer full-width Llama-2-7B slice check."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model

    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_model(cfg, bits=2, seed=3, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    _slice_check(model, cfg, combos, "slice check", RESULTS, "slice_err")


def _slice_check(model, cfg, combos, label, out: dict, key: str,
                 dense_ref: bool = False) -> dict:
    """A 600-token prefill and 4 teacher-forced decode steps of ``model``
    on the card in bf16 against the plain path on the CPU in f32 on the
    same weights, in each (fused RHT, int8 KV) configuration of
    ``combos``; the prefill runs K2 once a layer unless ALiBi bars it.
    ``dense_ref``: the CPU side runs the model unpacked to its dense f32
    W_hat (``unpack_model``, dequantised once on the card), the function
    the plain packed path computes; that path dequantises every weight at
    every call (about 0.7 s a call at these widths on the host).
    Records each normalised error in ``out`` under ``key``; returns the
    kernels' launches in the last configuration's card run."""
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.kernels import rht as K3
    from quip_tpu_torch.pack.model import unpack_model

    ref = (unpack_model(model, torch.float32).to("cpu") if dense_ref
           else _to_cpu_f32(model))
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
    # packed linears: 4 a layer (K1-tile at the prompt's 600 rows), and a
    # packed lm_head (K1-decode: the prefill unembeds its last row only; a
    # tied family's head is the dense token table)
    n_proj = 4 * cfg.n_layers
    head = 0 if cfg.tie_word_embeddings else 1
    n_lin = n_proj + head
    k2_want = 0 if cfg.positions == "alibi" else cfg.n_layers
    for fused, quantized in combos:
        _zero_counts()
        with fused_rht(fused):
            got, k3_step = drive(model, "cuda", torch.bfloat16, quantized)
            torch.cuda.synchronize()
            counts = _read_counts()
            assert counts["k2"] == k2_want, (counts, k2_want)
            assert counts["k1_tile"] == n_proj and counts["k1_decode"] == (
                n_lin * len(steps) + head), (counts, n_lin)
            # V and U side of every packed linear
            want_k3 = 2 * n_lin if fused else 0
            assert k3_step == [want_k3] * len(steps), (k3_step, want_k3)
            want, _ = drive(ref, "cpu", torch.float32, quantized)
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item() / want.abs().max().item()
        what = (f"{'QUIP_FUSED_RHT=1' if fused else 'un-fused RHT'}, "
                f"{'int8' if quantized else 'bf16'} KV")
        limit = 4e-2 if quantized else 3e-2
        log(f"{label}, {what} ({cfg.n_layers} layers, full width, 600-token "
            f"prefill + 4 decode steps, card bf16 vs CPU f32 plain): "
            f"normalised max err {err:.2e} <= {limit:.0e}; launches "
            f"K1-tile {counts['k1_tile']}, K1-decode {counts['k1_decode']}, "
            f"K2 {counts['k2']}, K3 a decode step {k3_step[0]}")
        assert err <= limit, (label, what, err)
        out[f"{key}_fused{int(fused)}_int8{int(quantized)}"] = err
    del ref
    torch.cuda.empty_cache()
    return counts


def _zero_counts():
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.kernels import rht as K3
    from quip_tpu_torch.kernels import slabdot as SD
    DM.launches = DM.launches_tile = DM.launches_decode = 0
    DM.launches_decode_ragged = 0
    FA.launches = K3.launches = SD.launches = 0


def _read_counts() -> dict:
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.kernels import rht as K3
    from quip_tpu_torch.kernels import slabdot as SD
    return dict(k1_tile=DM.launches_tile, k1_decode=DM.launches_decode,
                k2=FA.launches, k3=K3.launches, k1p=SD.launches)


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
        _zero_counts()
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
    return dict(tokens=[r.generated for r in out], run_s=run_s,
                decode_steps=len(per_step), k1=k1,
                k1_tile=k1_tile, k1_decode=k1_decode, k2=k2, k3=k3,
                k1_per_step=min(s[0] for s in per_step),
                k3_per_step=min(s[1] for s in per_step))


def _averages(prof):
    """``prof.key_averages()``, computed once a profile (it walks every
    event the profile recorded)."""
    if not hasattr(prof, "_averages"):
        prof._averages = prof.key_averages()
    return prof._averages


def _device_ms(prof, *names):
    """Device ms and launches of the kernels whose names hold any of
    ``names`` in a torch.profiler (CUPTI) run."""
    from torch.autograd import DeviceType
    kern = [x for x in _averages(prof) if x.device_type == DeviceType.CUDA
            and any(n in x.key for n in names)]
    return (sum(getattr(x, "self_device_time_total",
                        getattr(x, "self_cuda_time_total", 0))
                for x in kern) / 1e3, sum(x.count for x in kern))


def _launch_seq(prof) -> list:
    """The kernel launch calls of a torch.profiler (CUPTI) run in the order
    they were made (its Chrome trace's ``cuda_runtime`` / ``cuda_driver``
    events named like ``cudaLaunchKernel`` or ``cuLaunchKernelEx``, by
    correlation id), each as the kernel record that carries its
    correlation id (this repo's kernels by function: ``dm_tile``,
    ``flash_fwd``), None where CUPTI holds the call but not the kernel."""
    import re
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ran = {}
    for e in events:
        if e.get("cat") == "kernel" and "args" in e:
            m = re.search(r"\b(dm_\w+?|flash_fwd)\b(?=[<(])", e["name"])
            ran[e["args"].get("correlation")] = m.group(1) if m else e["name"]
    return [ran.get(c) for c in sorted(
        e["args"].get("correlation") for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
        and re.search(r"Launch\w*Kernel", e.get("name", "")))]


def _spans(prof) -> list:
    """(start, end) µs and name of every device activity (kernels, copies)
    in a torch.profiler (CUPTI) run, in order of start."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def _union_ms(spans) -> float:
    """ms covered by at least one of ``spans`` (sorted by start): kernels
    that overlap, as a kernel launched with programmatic dependent launch
    does the one before it, count once."""
    total, end = 0.0, -math.inf
    for a, b, _ in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _busy(prof, n: int, step_ms: float) -> dict:
    """Per step of a profiled run of ``n`` steps: ``busy_ms``, the device
    time covered by at least one kernel; ``idle_ms``, ``step_ms`` (the
    same steps' host ms unprofiled: the profiler's own work widens the
    gaps of the run it records) less ``busy_ms``; ``k3_own_ms``, the time
    only K3 (``rht_mma``) covers, which its summed spans (``k3_ms``)
    overcount by what they overlap under programmatic dependent launch."""
    spans = _spans(prof)
    if not spans:
        return dict(busy_ms=None, idle_ms=None, k3_own_ms=None)
    busy = _union_ms(spans)
    rest = _union_ms([x for x in spans if "rht_mma" not in x[2]])
    return dict(busy_ms=busy / n, idle_ms=step_ms - busy / n,
                k3_own_ms=(busy - rest) / n)


def _kernel_table(prof, n: int, n_top: int = 6):
    """From a torch.profiler (CUPTI) run of ``n`` steps: kernels' device ms,
    kernel launches and aten ops per step, and the ``n_top`` kernels by
    device time as (name, ms per step, launches per step)."""
    from torch.autograd import DeviceType

    dev_t = lambda x: getattr(x, "self_device_time_total",  # noqa: E731
                              getattr(x, "self_cuda_time_total", 0))
    avgs = _averages(prof)
    kern = [x for x in avgs if x.device_type == DeviceType.CUDA]
    top = sorted(kern, key=dev_t, reverse=True)[:n_top]
    return (sum(dev_t(x) for x in kern) / 1e3 / n,
            sum(x.count for x in kern) / n,
            sum(x.count for x in avgs if x.key.startswith("aten::")) / n,
            [(x.key, dev_t(x) / n / 1e3, x.count / n) for x in top])


def _serial_decode(model, cfg, rng, B=1, n_steps=48, n_prof=4):
    """Decode through the serial ``Engine.step`` on phase 7's engine
    settings at ``B`` slots (37-token prompts): host ms per step over
    ``n_steps`` (crosses a hot-ring flush), then ``n_prof`` steps of a fresh
    engine under torch.profiler (CUPTI): kernels' device ms, kernel
    launches and aten ops per step; busy share = the device's busy ms (the
    union of its kernels' spans, ``_busy``) over the unprofiled step
    time."""
    from torch.profiler import ProfilerActivity, profile
    from quip_tpu_torch.serve.engine import Engine

    def engine(n_new):
        e = Engine(model, cfg, max_batch=B, max_seq=1024, hot=32, page=64,
                   cache_dtype=torch.bfloat16, paged=True, device="cuda")
        for _ in range(B):
            e.submit(rng.integers(0, cfg.vocab_size, 37).tolist(),
                     max_new_tokens=n_new)
        e.step()                 # admission + first decode
        torch.cuda.synchronize()
        return e

    e = engine(n_steps + 8)
    t = time.perf_counter()
    for _ in range(n_steps):
        e.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / n_steps
    e = engine(n_prof + 8)       # one 64-row page in use
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            e.step()
        torch.cuda.synchronize()
    dev_ms, launches, aten, top = _kernel_table(prof, n_prof)
    busy = _busy(prof, n_prof, ms)
    return dict(ms_per_step=ms, tok_s=B * 1e3 / ms, device_ms=dev_ms,
                kernel_launches=launches, aten_ops=aten,
                busy=busy["busy_ms"] / ms if busy["busy_ms"] else None,
                top=top, per_step=_kernels_named(prof, n_prof),
                k1_decode_ms=_device_ms(prof, "dm_decode")[0] / n_prof,
                k3_ms=_device_ms(prof, "rht_mma")[0] / n_prof, **busy)


def _kernels_named(prof, n: int, names=("dm_decode", "rht_mma")):
    """Launches per step of K1-decode (``dm_decode``) and K3 (``rht_mma``),
    or of the kernels ``names``, in a profiled run of ``n`` steps."""
    from torch.autograd import DeviceType
    kern = [x for x in _averages(prof) if x.device_type == DeviceType.CUDA]
    return {k: sum(x.count for x in kern if k in x.key) / n for k in names}


def _pump_decode(model, cfg, rng, B=1, n_new=64, reps=3):
    """Decode through the pump at ``B`` slots on the serial settings
    (37-token prompts, ``n_new`` new tokens a slot): a first run builds the
    chunk graphs (T = 16 at one and two pages); then ``reps`` windows, each
    from just after the admission and first chunk of a fresh batch to its
    end, host ms per step (one token a slot), the median kept; then
    windows of one chunk (16 steps at one page: the profiler's own work
    grows with the events it records), ``reps`` timed and one under
    torch.profiler (CUPTI sees the kernels of a replayed graph): kernels'
    device ms, kernel launches and aten ops per step; busy share = the
    device's busy ms (the union of its kernels' spans, ``_busy``) over the
    median step time of the same window unprofiled."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from quip_tpu_torch.serve.engine import Engine

    e = Engine(model, cfg, max_batch=B, max_seq=1024, hot=32, page=64,
               cache_dtype=torch.bfloat16, paged=True, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, 37).tolist()
               for _ in range(B)]
    t = time.time()
    e.run([dict(prompt=p, max_new_tokens=n_new) for p in prompts],
          chunked=True)
    build_s = time.time() - t

    def window(n_new, ctx=contextlib.nullcontext):
        for p in prompts:
            e.submit(p, max_new_tokens=n_new)
        e.pump()                 # admission and the first chunk
        torch.cuda.synchronize()
        n = n_new - sum(p["T"] for p in e._pending_q)
        with ctx() as prof:
            t = time.perf_counter()
            while e.pump():
                pass
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        return ms / n, n, prof

    ms = [window(n_new)[0] for _ in range(reps)]
    n_win = n_new - 16
    short = statistics.median(window(32)[0] for _ in range(reps))
    _, n, prof = window(32, lambda: profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    dev_ms, launches, aten, top = _kernel_table(prof, n)
    busy = _busy(prof, n, short)
    med = statistics.median(ms)
    return dict(ms_per_step=med, ms_reps=ms, tok_s=B * 1e3 / med,
                steps_per_window=n_win, steps_profiled=n,
                ms_per_step_profiled_window=short, device_ms=dev_ms,
                kernel_launches=launches, aten_ops=aten,
                busy=busy["busy_ms"] / short if busy["busy_ms"] else None,
                top=top, per_step=_kernels_named(prof, n),
                graphs=len(e._graphs), first_run_s=build_s,
                k1_decode_ms=_device_ms(prof, "dm_decode")[0] / n,
                k3_ms=_device_ms(prof, "rht_mma")[0] / n, **busy)


def phase_serve(name: str, smi: str):
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.serve.engine import Engine
    from quip_tpu_torch.tools.teacher_forced import serving_prompts

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama-2-7b")
    t = time.time()
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    torch.cuda.synchronize()
    log(f"built 32-layer 2-bit Llama-2-7B (packed lm_head) in "
        f"{time.time() - t:.1f} s")
    prompts = serving_prompts(cfg.vocab_size)
    cache_bytes = lambda e: sum(  # noqa: E731
        t.numel() * t.element_size() for t in e.pkv
        if isinstance(t, torch.Tensor) and t.is_cuda)

    # --- the first slice's path: un-fused RHT, bf16 KV, no prefix ---------
    eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                 cache_dtype=torch.bfloat16, paged=True, device="cuda")
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
    # the prefill's K1-tile calls are the dm_tile kernels the card ran, one
    # dm_prep each and no split finish at 600 rows, and K2 one flash_fwd a
    # layer. The profile is taken again, up to twice, only when CUPTI
    # recorded no kernel at all, or when it holds a launch call without its
    # kernel record for each kernel short; a profile that was retaken must
    # then show its lost records where the sound profile's launch sequence
    # (the same prefill, the same calls in the same order) has exactly the
    # kernels it lacked. Any other mismatch fails. Each profile is kept.
    want = dict(dm_tile=k1_tile_prefill, dm_prep=k1_tile_prefill,
                flash_fwd=cfg.n_layers)
    profiles, lost = [], []
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            PG.paged_prefill_slot(eng.params, p600, 600, kv, 0, cfg)
            torch.cuda.synchronize()
        names = _names_of(prof)
        k2_prefill_ms, k2_prefill = _device_ms(prof, "flash_fwd")
        got = {k: names.get(k, 0) for k in ("dm_tile", "dm_prep",
                                            "dm_tile_finish")}
        got["flash_fwd"] = k2_prefill
        seq = _launch_seq(prof)
        profiles.append(dict(got, launch_calls=len(seq),
                             without_record=seq.count(None)))
        log(f"prefill 600 tokens, profile {attempt}: {got}; of {len(seq)} "
            f"kernel launch calls, {seq.count(None)} without a kernel record")
        if got == dict(want, dm_tile_finish=0):
            break
        short = sum(want[k] - got[k] for k in want)
        assert not names or (all(got[k] <= want[k] for k in want)
                             and got["dm_tile_finish"] == 0
                             and short <= seq.count(None)), (profiles, want)
        assert attempt < 3, (profiles, want)
        if names:
            lost.append((seq, got))
    for seq0, got0 in lost:
        assert len(seq0) == len(seq) and all(
            a is None or a == b for a, b in zip(seq0, seq)), profiles
        at = [b for a, b in zip(seq0, seq) if a is None]
        assert all(want[k] - got0[k] == at.count(k) for k in want), (at, got0)
    pre_dev_ms, pre_launches, pre_aten, pre_top = _kernel_table(prof, 1, 8)
    log(f"prefill 600 tokens, profiled (profile {attempt} of 3): "
        f"{got} (K1-tile launches counted: {k1_tile_prefill}); K2 "
        f"{k2_prefill_ms:.3f} ms in {k2_prefill} launches")
    del eng, kv
    torch.cuda.empty_cache()

    # --- this slice's configuration: fused RHT, int8 KV, shared prefix ----
    torch.cuda.reset_peak_memory_stats()
    with fused_rht(True):
        eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                     cache_dtype=torch.bfloat16, kv_quant=True,
                     shared_prefix=prompts[200], paged=True, device="cuda")
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

    log(f"prefill 600 tokens: {prefill_ms:.1f} ms "
        f"({600 / prefill_ms * 1e3:.0f} tok/s; was {BEFORE['prefill_ms']} "
        f"ms), {k1_prefill} K1 launches, {k1_tile_prefill} of them K1-tile; "
        f"profiled: {pre_dev_ms:.2f} ms of kernels, {pre_launches:.0f} "
        f"kernel launches, {pre_aten:.0f} aten ops; device busy share "
        + (f"{pre_dev_ms / prefill_ms:.1%}" if pre_dev_ms else "not measured"))
    for key, ms, cnt in pre_top:
        log(f"  {key[:60]:60s} {ms:.3f} ms, {cnt:.0f} launches")
    RESULTS["serve"].update(prefill_ms=prefill_ms, k1_prefill=k1_prefill,
                            k1_tile_prefill=k1_tile_prefill,
                            prefill_device_ms=pre_dev_ms,
                            prefill_kernel_launches=pre_launches,
                            prefill_aten_ops=pre_aten, prefill_top=pre_top,
                            k2_prefill_ms=k2_prefill_ms,
                            prefill_profiles=profiles)
    return model, cfg, prompts, base, conf


def _run_pump(eng, reqs, cfg, want):
    """``eng.run(reqs, chunked=True)`` with every kernel's count set to 0
    just before and read just after (a graph replay adds the launches it
    holds); the greedy tokens must equal ``want`` request by request."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.kernels import rht as K3

    _zero_counts()
    chunks = eng._t_pump["chunks"]
    t = time.time()
    out = eng.run(reqs, chunked=True)
    torch.cuda.synchronize()
    run_s = time.time() - t
    got = [r.generated for r in out]
    for r, q in zip(out, reqs):
        assert len(r.generated) == q["max_new_tokens"] + 1, (r.uid,
                                                             len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert got == want, [sum(a != b for a, b in zip(g, w))
                         for g, w in zip(got, want)]
    return dict(run_s=run_s, chunks=eng._t_pump["chunks"] - chunks,
                serial_steps=eng._t_pump["steps"], k1=DM.launches,
                k1_tile=DM.launches_tile, k1_decode=DM.launches_decode,
                k2=FA.launches, k3=K3.launches, stats=eng.stats())


def phase_pump(name: str, smi: str, model, cfg, prompts, base, conf):
    """Phase 8: phase 7's traffic through the pump, then decode timings."""
    from quip_tpu_torch.serve.engine import Engine

    def warm(eng):
        """warmup at the page bucket phase 7's traffic reaches (the 600-token
        prompt puts every chunk at 16 pages; the dummy requests build the
        first bucket's); every bucket the engine can reach would be
        [1, 2, 4, 8, 16], 2.5 times the graphs and the time."""
        t = time.time()
        eng.warmup(page_buckets=[16])
        torch.cuda.synchronize()
        g = eng._graphs
        return dict(warmup_s=time.time() - t, graphs=len(g),
                    capture_s=g.capture_s, capture_parts_s=dict(g.parts_s),
                    pool_mib=g.pool_bytes / 2 ** 20, buckets=[16])

    res = {}
    steps = 40        # decode steps of phase 7's requests
    with fused_rht(False):
        eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                     cache_dtype=torch.bfloat16, paged=True, device="cuda")
        w = warm(eng)
        reqs = [dict(prompt=prompts[n], max_new_tokens=40)
                for n in (600, 128, 37, 5)]
        r = _run_pump(eng, reqs, cfg, base["tokens"])
    assert r["k1_decode"] >= 129 * steps and r["k1_tile"] >= 128, r
    assert r["k2"] == 32 and r["k3"] == 0, r
    res["unfused"] = dict(r, **w)
    del eng
    torch.cuda.empty_cache()
    with fused_rht(True):
        eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                     cache_dtype=torch.bfloat16, kv_quant=True,
                     shared_prefix=prompts[200], paged=True, device="cuda")
        w = warm(eng)
        reqs = [dict(prompt=prompts[n], max_new_tokens=40) for n in
                (128, 37, 5)] + [dict(prompt=prompts[600], max_new_tokens=40,
                                      use_prefix=False)]
        r = _run_pump(eng, reqs, cfg, conf["tokens"])
    assert r["k3"] >= 258 * steps and r["k1_decode"] >= 129 * steps, r
    assert r["k2"] == 32 and r["k1_tile"] >= 128, r
    res["fused_int8_prefix"] = dict(r, **w)
    del eng
    torch.cuda.empty_cache()
    for what, d in res.items():
        log(f"pump, {what}: warmup {d['warmup_s']:.1f} s ({d['graphs']} "
            f"graphs at page buckets {d['buckets']}, {d['capture_s']:.1f} s "
            f"building them ("
            + ", ".join(f"{k} {v:.1f}" for k, v in
                        d["capture_parts_s"].items())
            + f"), pool {d['pool_mib']:.1f} MiB); phase 7's 4 "
            f"requests in {d['run_s']:.2f} s, {d['chunks']} chunks, "
            f"greedy tokens equal to Engine.run's; launches K1-decode "
            f"{d['k1_decode']}, K1-tile {d['k1_tile']}, K2 {d['k2']}, K3 "
            f"{d['k3']}; host ms a chunk by phase "
            f"{d['stats'].get('pump_phase_ms_per_chunk')}")

    rng = np.random.default_rng(8)
    dec = {}
    for fused in (False, True):
        with fused_rht(fused):
            for B, n_steps in ((1, 16), (4, 12)):
                dec[(fused, B)] = dict(
                    serial=_serial_decode(model, cfg, rng, B, n_steps),
                    pump=_pump_decode(model, cfg, rng, B))
    for (fused, B), d in dec.items():
        for how in ("serial", "pump"):
            x = d[how]
            log(f"decode b{B}, QUIP_FUSED_RHT={int(fused)}, {how:6s}: "
                f"{x['ms_per_step']:.2f} ms/step ({x['tok_s']:.1f} tok/s)"
                + (f" [windows {', '.join(f'{v:.2f}' for v in x['ms_reps'])};"
                   f" {x['steps_per_window']} steps each; "
                   f"{x['steps_profiled']}-step windows "
                   f"{x['ms_per_step_profiled_window']:.2f} ms/step, one of "
                   f"them profiled; {x['graphs']} "
                   f"graphs built in a first run of {x['first_run_s']:.1f} s]"
                   if how == "pump" else "")
                + f"; profiled: {x['device_ms']:.2f} ms of kernels a step, "
                f"{x['kernel_launches']:.0f} kernel launches (K1-decode "
                f"{x['per_step']['dm_decode']:.0f} in "
                f"{x['k1_decode_ms']:.3f} ms, K3 "
                f"{x['per_step']['rht_mma']:.0f} in {x['k3_ms']:.3f} ms of "
                f"spans"
                + (f", {x['k3_own_ms']:.3f} ms covered by K3 alone"
                   if x["k3_own_ms"] is not None else "")
                + f"), {x['aten_ops']:.0f} aten ops; device busy share "
                + (f"{x['busy']:.1%} ({x['busy_ms']:.3f} ms a step covered "
                   f"by a kernel), idle {x['idle_ms']:.3f} ms a step (the "
                   f"unprofiled step less that)"
                   if x["busy"] else "not measured"))
            for key, ms, cnt in x["top"]:
                log(f"    {key[:60]:60s} {ms:.3f} ms/step, {cnt:.0f} "
                    f"launches/step")
    log(f"card: {smi}")
    RESULTS["pump"] = res
    RESULTS["decode"] = {f"b{B}_fused{int(f)}": d for (f, B), d in dec.items()}
    return res, dec


def _run_arena(eng, reqs, cfg, chunked: bool = False):
    """``eng.run(reqs, chunked=...)`` on an arena engine with every kernel's
    count set to 0 just before and read just after; checks finite logits
    (every arena step and prefill), token ranges and lengths. The serial
    run also counts each decode step's K1 and K3 launches."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import rht as K3
    from quip_tpu_torch.serve import arena as AR

    finite = torch.ones((), dtype=torch.bool, device="cuda")
    orig = (AR.slot_attention_step, AR.arena_prefill)
    per_step = []

    def checked(fn, step=False):
        def run(*a, **kw):
            before = (DM.launches, K3.launches)
            out = fn(*a, **kw)
            finite.logical_and_(torch.isfinite(out).all())
            if step and not chunked:
                per_step.append((DM.launches - before[0],
                                 K3.launches - before[1]))
            return out
        return run

    AR.slot_attention_step = checked(orig[0], step=True)
    AR.arena_prefill = checked(orig[1])
    try:
        _zero_counts()
        t = time.time()
        out = eng.run([dict(r) for r in reqs], chunked=chunked)
        torch.cuda.synchronize()
        run_s = time.time() - t
        counts = _read_counts()
    finally:
        AR.slot_attention_step, AR.arena_prefill = orig
    for r, q in zip(out, reqs):
        assert len(r.generated) == q["max_new_tokens"] + 1, (r.uid,
                                                             len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert bool(finite), "NaN/inf logits"
    res = dict(counts, tokens=[r.generated for r in out], run_s=run_s)
    if per_step:
        res.update(decode_steps=len(per_step),
                   k1_per_step=min(x[0] for x in per_step),
                   k3_per_step=min(x[1] for x in per_step))
    return res


def _arena_decode(eng, rng, cfg, n_active: int, n_new: int = 64,
                  reps: int = 3):
    """Decode on a warmed arena engine with ``n_active`` of its slots busy
    (37-token prompts, ``n_new`` new tokens a slot): ``reps`` windows, each
    from just after the admission and first chunk of a fresh batch to its
    end (chunk graph replays), host ms a step (one token a slot), the
    median kept; then one more window under torch.profiler (CUPTI sees a
    replayed graph's kernels): kernels' device ms, launches and aten ops a
    step, busy share = device ms over the median step."""
    import statistics
    from torch.profiler import ProfilerActivity, profile

    def window(ctx=contextlib.nullcontext):
        for _ in range(n_active):
            eng.submit(rng.integers(0, cfg.vocab_size, 37).tolist(),
                       max_new_tokens=n_new)
        eng.step_chunk()              # admission and the first chunk
        torch.cuda.synchronize()
        with ctx() as prof:
            t, n = time.perf_counter(), 0
            while any(s is not None for s in eng._slots):
                n += eng.step_chunk()
            torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n, n, prof

    ms = [window()[0] for _ in range(reps)]
    med = statistics.median(ms)
    _, n, prof = window(lambda: profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    dev_ms, launches, aten, top = _kernel_table(prof, n)
    return dict(ms_per_step=med, ms_reps=ms, steps_per_window=n,
                tok_s=n_active * 1e3 / med, device_ms=dev_ms,
                kernel_launches=launches, aten_ops=aten,
                busy=dev_ms / med if dev_ms else None, top=top,
                per_step=_kernels_named(prof, n))


def phase_arena(name: str, smi: str, model, cfg, prompts, dec):
    """Phase 13 (after phase 8, on phase 7's model): the slot arena,
    ``Engine(paged=False)``, quip_tpu's default cache. Phase 7's four
    requests through the serial ``run()``, un-fused with a bf16 arena,
    each greedy token held to phase 11's teacher-forced check; ``warmup()``
    (seconds, graphs); the same requests through ``run(chunked=True)``
    (each chunk a graph replay), the greedy tokens equal to the serial
    run's; launches by kernel (K2 and K1' must read 0: the arena prefill is
    dense, as in quip_tpu); ms a step with 1 and with 4 of the 4 slots
    busy beside phase 8's paged pump (``dec``); then QUIP_FUSED_RHT=1 with
    an int8 arena, the serial run, K3's launches read, and the same run
    with two planted faults (``_arena_faults``)."""
    from quip_tpu_torch.serve.engine import Engine

    t_phase = time.time()
    reqs = [dict(prompt=prompts[n], max_new_tokens=40)
            for n in (600, 128, 37, 5)]
    steps = 40
    kw = dict(max_batch=4, max_seq=1024, cache_dtype=torch.bfloat16,
              device="cuda")
    res = {}
    with fused_rht(False):
        eng = Engine(model, cfg, **kw)
        assert not eng.paged
        serial = _run_arena(eng, reqs, cfg)
        serial["exact"], serial["worst_gap"] = _spec_exactness(
            model, cfg, reqs, serial["tokens"], None, tol=SPEC_TOL[False])
        t = time.time()
        eng.warmup()
        torch.cuda.synchronize()
        g = eng._graphs
        warm = dict(warmup_s=time.time() - t, graphs=len(g),
                    capture_s=g.capture_s, pool_mib=g.pool_bytes / 2 ** 20)
        chunked = _run_arena(eng, reqs, cfg, chunked=True)
        assert chunked["tokens"] == serial["tokens"], [
            sum(a != b for a, b in zip(x, y))
            for x, y in zip(chunked["tokens"], serial["tokens"])]
        rng = np.random.default_rng(13)
        timing = {B: _arena_decode(eng, rng, cfg, B) for B in (1, 4)}
        del eng
        torch.cuda.empty_cache()
    for r in (serial, chunked):
        assert r["k2"] == 0 and r["k1p"] == 0 and r["k3"] == 0, r
        assert r["k1_tile"] == 128 * 3, r      # the three prompts of >= 9
        assert r["k1_decode"] >= 129 * steps, r
    assert serial["k1_per_step"] == 129 and serial["decode_steps"] == steps
    with fused_rht(True):
        eng = Engine(model, cfg, kv_quant=True, **kw)
        fused = _run_arena(eng, reqs, cfg)
        del eng
        torch.cuda.empty_cache()
    fused["exact"], fused["worst_gap"] = _spec_exactness(
        model, cfg, reqs, fused["tokens"], None, tol=SPEC_TOL[True])
    with fused_rht(True):
        fused["faults"] = _arena_faults(model, cfg, reqs,
                                        dict(kw, kv_quant=True))
    assert fused["k3_per_step"] == 258 and fused["k1_per_step"] == 129, fused
    assert fused["k3"] >= 258 * steps and fused["k2"] == 0, fused
    assert fused["k1p"] == 0, fused
    res = dict(serial=serial, chunked=chunked, fused_int8=fused,
               decode={f"b{B}": x for B, x in timing.items()}, **warm)
    log(f"arena (Engine(paged=False), bf16, un-fused): phase 7's 4 requests "
        f"through run() in {serial['run_s']:.2f} s, {serial['decode_steps']}"
        f" decode steps; exactness {serial['exact']:.1%} argmax, worst gap "
        f"{serial['worst_gap']:.2e} <= {SPEC_TOL[False]:.0e}; launches "
        f"K1-decode {serial['k1_decode']} ({serial['k1_per_step']} a step), "
        f"K1-tile {serial['k1_tile']}, K2 {serial['k2']}, K3 {serial['k3']},"
        f" K1' {serial['k1p']}")
    log(f"arena warmup {warm['warmup_s']:.1f} s ({warm['graphs']} graphs, "
        f"{warm['capture_s']:.1f} s building them, pool "
        f"{warm['pool_mib']:.1f} MiB); run(chunked=True): the same greedy "
        f"tokens in {chunked['run_s']:.2f} s; launches K1-decode "
        f"{chunked['k1_decode']}, K1-tile {chunked['k1_tile']}, K2 "
        f"{chunked['k2']}, K1' {chunked['k1p']}")
    log(f"arena, QUIP_FUSED_RHT=1, int8: run() in {fused['run_s']:.2f} s; "
        f"exactness {fused['exact']:.1%}, worst gap {fused['worst_gap']:.2e}"
        f" <= {SPEC_TOL[True]:.0e} (planted faults: lengths unpushed "
        f"{fused['faults']['unpushed']:.3f}, K/V rows one early "
        f"{fused['faults']['row_early']:.2e}); launches K1-decode "
        f"{fused['k1_decode']},"
        f" K1-tile {fused['k1_tile']}, K2 {fused['k2']}, K3 {fused['k3']} "
        f"({fused['k3_per_step']} a step)")
    for B, x in timing.items():
        paged = dec[(False, B)]["pump"]["ms_per_step"]
        log(f"decode, {B} of 4 slots busy, un-fused, bf16: arena chunks "
            f"{x['ms_per_step']:.2f} ms/step ({x['tok_s']:.1f} tok/s) "
            f"[windows {', '.join(f'{v:.2f}' for v in x['ms_reps'])}; "
            f"{x['steps_per_window']} steps each]; profiled: "
            f"{x['device_ms']:.2f} ms of kernels a step, "
            f"{x['kernel_launches']:.0f} launches (K1-decode "
            f"{x['per_step']['dm_decode']:.0f}), {x['aten_ops']:.0f} aten "
            f"ops, busy " + (f"{x['busy']:.1%}" if x["busy"] else
                             "not measured")
            + f"; the paged pump at b{B} (phase 8, this call) {paged:.2f} "
            f"ms/step")
        for key, kms, cnt in x["top"]:
            log(f"    {key[:60]:60s} {kms:.3f} ms/step, {cnt:.0f} "
                f"launches/step")
    res["phase_s"] = time.time() - t_phase
    log(f"phase 13: {res['phase_s']:.1f} s; card: {smi}")
    RESULTS["arena"] = res
    return res


def _arena_faults(model, cfg, reqs, kw):
    """Controls of the exactness check on the arena: the serial ``run()`` of
    a fresh arena engine (``kw``) with a planted fault, read by
    ``_spec_exactness``. "unpushed": every decode step reads the lengths
    buffer as the engine made it (zeros), as if the host never pushed its
    cursors. "row early": each slot's K/V row written one row before its
    length (the previous token's row overwritten, its own left empty).
    Each worst gap must exceed the arena's limit; returns both."""
    from quip_tpu_torch.serve import arena as AR
    from quip_tpu_torch.serve.engine import Engine

    step, attn = AR.slot_attention_step, AR.attn_steps

    def unpushed(params, cfg, tokens, lengths, kv):
        return step(params, cfg, tokens, torch.zeros_like(lengths), kv)

    def row_early(p, x, cfg, positions, mask, kv, layer, rows, rope_cs=None):
        return attn(p, x, cfg, positions, mask, kv, layer,
                    (rows[0], (rows[1] - 1).clamp(min=0)), rope_cs)

    gaps = {}
    for label, name, fault in (("unpushed", "slot_attention_step", unpushed),
                               ("row_early", "attn_steps", row_early)):
        setattr(AR, name, fault)
        try:
            eng = Engine(model, cfg, **kw)
            out = eng.run([dict(r) for r in reqs])
        finally:
            AR.slot_attention_step, AR.attn_steps = step, attn
        del eng
        torch.cuda.empty_cache()
        _, gaps[label] = _spec_exactness(model, cfg, reqs,
                                         [r.generated for r in out], None)
    tol = SPEC_TOL[bool(kw.get("kv_quant"))]
    assert min(gaps.values()) > tol, (gaps, tol)
    return gaps


# Phase 14's depth: a full-width 3-bit Llama-2-7B cut to 8 of its 32
# layers (two engines' serial runs and their teacher-forced forwards stay
# within the script's time limit; every layer has the full-depth model's
# shapes).
W3_LAYERS = 8


def phase_3bit(name: str, smi: str):
    """Phase 14: a full-width 3-bit Llama-2-7B (packed lm_head, W3_LAYERS
    layers) through the arena Engine with the 3-in-4 widening at load (the
    default; its seconds a layer on the card)
    and with QUIP_NO_WIDEN3=1 (two planes), phase 7's requests, serial;
    each stream held to the teacher-forced check against the two-plane
    model's forward (bf16 KV: SPEC_TOL), and the two streams compared."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.pack import format as PF
    from quip_tpu_torch.serve.engine import Engine

    t_phase = time.time()
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=W3_LAYERS)
    model = packed_model(cfg, bits=3, seed=2, dtype=torch.bfloat16,
                         head_bits=3, device="cuda")
    rng = np.random.default_rng(14)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=40) for n in (600, 128, 37, 5)]
    t = time.time()
    wide = PF.widen_3bit_tree(model)
    torch.cuda.synchronize()
    widen_s = time.time() - t
    n_lin = 4 * cfg.n_layers + 1
    assert sum(isinstance(q, PF.PackedLinear) and q.bits == 4
               and q.code_bits == 3 for b in wide.blocks
               for q in (b.attn.wqkv, b.attn.wo, b.mlp.wgu, b.mlp.wd)
               ) + (wide.lm_head.bits == 4) == n_lin
    del wide
    res = dict(widen_s=widen_s, widen_s_per_layer=widen_s / cfg.n_layers,
               layers=cfg.n_layers)
    kw = dict(max_batch=4, max_seq=1024, cache_dtype=torch.bfloat16,
              device="cuda")
    for label, env in (("widened", "0"), ("two_planes", "1")):
        with fused_rht(False), _env("QUIP_NO_WIDEN3", env):
            eng = Engine(model, cfg, **kw)
            bits = {q.bits for b in eng.params.blocks
                    for q in (b.attn.wqkv, b.mlp.wd)}
            assert bits == ({4} if env == "0" else {3}), bits
            r = _run_arena(eng, reqs, cfg)
            del eng
            torch.cuda.empty_cache()
        r["exact"], r["worst_gap"] = _spec_exactness(
            model, cfg, reqs, r["tokens"], None, tol=SPEC_TOL[False])
        assert r["k1_per_step"] == n_lin and r["k2"] == 0, r
        res[label] = r
    same = sum(a == b for x, y in zip(res["widened"]["tokens"],
                                      res["two_planes"]["tokens"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in res["widened"]["tokens"])
    res["tokens_equal"] = same / total
    log(f"3-bit Llama-2-7B ({cfg.n_layers} of 32 layers, full width): "
        f"widened at load in {widen_s:.2f} s ({widen_s / cfg.n_layers:.3f} "
        f"s a layer and the head's share); serial run "
        f"widened {res['widened']['run_s']:.2f} s, two planes "
        f"{res['two_planes']['run_s']:.2f} s; exactness against the "
        f"two-plane forward: widened {res['widened']['exact']:.1%} "
        f"(worst {res['widened']['worst_gap']:.2e}), two planes "
        f"{res['two_planes']['exact']:.1%} (worst "
        f"{res['two_planes']['worst_gap']:.2e}), <= {SPEC_TOL[False]:.0e};"
        f" {res['tokens_equal']:.1%} of the tokens equal; K1-decode a step "
        f"{res['widened']['k1_per_step']} / "
        f"{res['two_planes']['k1_per_step']}")
    del model
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(f"phase 14: {res['phase_s']:.1f} s; card: {smi}")
    RESULTS["w3"] = res
    return res


def _bench_run(bench, argv):
    """``bench.main(argv)`` with each real step's frontier (the greedy
    token of every slot) kept: one (B,) copy a step on the card, inside
    the timed chain. Returns the JSON dict, the streams (B lists, one
    token a step; the first step's input is token 0 at position 0) and
    the stepper's model and config."""
    sound = bench._Stepper.step
    toks, seen = [], {}

    def step(st):
        nll = sound(st)
        toks.append(st.tok[:, 0].clone())
        seen.update(params=st.params, cfg=st.cfg)
        return nll

    bench._Stepper.step = step
    try:
        out = bench.main(argv)
    finally:
        bench._Stepper.step = sound
    return out, torch.stack(toks, 1).tolist(), seen["params"], seen["cfg"]


def _tie_gap(model, cfg, a, b):
    """Where two greedy streams from token 0 first differ: (the step, the
    gap between their two tokens' teacher-forced logits over the row's max
    |logit|), or None where they agree."""
    from quip_tpu_torch.models import model as M
    k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if k is None:
        return None
    dev = model.embed.tokens.device
    with torch.inference_mode():
        lg = M.forward(model, torch.tensor([0] + a[:k], device=dev)[None],
                       cfg)[0, -1].float()
    return k, ((lg[a[k]] - lg[b[k]]).abs() / lg.abs().max()).item()


def phase_bench(name: str, smi: str, ckpt: str):
    """Phase 15 (on phase 9's checkpoint): the decode-benchmark CLI
    (``cli/bench.main``) at --batch 1 and 4, on the arena (its default)
    and with --paged, with --check; each run's JSON line is printed. Every
    slot's greedy stream (one CUDA graph replay a step, the paged flushes
    and page-bucket graph builds between) is held to phase 11's
    teacher-forced check against a full-depth forward (bf16 KV:
    SPEC_TOL); where the b1 and b4 streams of a cache differ, the gap of
    their first differing tokens is read (a near tie is far below the
    limit)."""
    from quip_tpu_torch.cli import bench

    t_phase = time.time()
    res, streams = {}, {}
    for paged in (False, True):
        for B in (1, 4):
            key = f"{'paged' if paged else 'arena'}_b{B}"
            argv = ["llama-2-7b", "--load", ckpt, "--batch", str(B),
                    "--check"] + (["--paged"] if paged else [])
            _zero_counts()
            t = time.time()
            out, gens, model, cfg = _bench_run(bench, argv)
            counts = _read_counts()
            out.update(counts, run_s=time.time() - t)
            assert math.isfinite(out["continuation_nll"]), out
            assert counts["k2"] == 0 and counts["k1p"] == 0, counts
            assert counts["k1_decode"] >= (4 * cfg.n_layers + 1) * (
                128 + 16), counts
            assert all(len(g) == 4 + 128 + 16 for g in gens), len(gens[0])
            out["exact"], out["worst_gap"] = _spec_exactness(
                model, cfg, [dict(prompt=[0])] * B, gens, None,
                tol=SPEC_TOL[False])
            streams[key] = gens[0]
            res[key] = out
        key = "paged" if paged else "arena"
        res[f"{key}_b1_vs_b4"] = _tie_gap(model, cfg, streams[f"{key}_b1"],
                                          streams[f"{key}_b4"])
        del model
        torch.cuda.empty_cache()
    for key, out in res.items():
        if key.endswith("_vs_b4"):
            log(f"bench CLI {key}: " + ("the same greedy stream" if out is
                None else f"first differ at step {out[0]}, their tokens' "
                f"teacher-forced logits {out[1]:.2e} of max |logit| apart"))
            continue
        log(f"bench CLI {key}: {out['s_per_token_chained'] * 1e3:.2f} ms a "
            f"step chained ({out['tokens_per_sec']:.1f} tok/s), median "
            f"{out['median_s_per_token_synced'] * 1e3:.2f} ms synced, "
            f"continuation nll {out['continuation_nll']:.4f}; exactness "
            f"{out['exact']:.1%}, worst gap {out['worst_gap']:.2e} <= "
            f"{SPEC_TOL[False]:.0e}; K1-decode launches {out['k1_decode']}; "
            f"{out['run_s']:.1f} s")
    res["phase_s"] = time.time() - t_phase
    log(f"phase 15: {res['phase_s']:.1f} s; card: {smi}")
    RESULTS["bench_cli"] = res
    return res


# Phase 18: the host packer, transcode and counter. Its stated budget:
HOST_BUDGET_S = 60.0
# 18b: the dense f32 checkpoint against the packed bf16 model through K1,
# over each prompt's max |logit| (phase 11's bf16 limit, SPEC_TOL[False])
TRANSCODE_TOL = 5e-2
# 18c: the card's float32 rows against the port's float64 CPU rows
COUNTER_TOL = 1e-4


def _plain_pack(codes: torch.Tensor, bits: int):
    """pack_codes as the torch ops compute it (its path for CUDA codes, and
    for CPU codes before the host packer): int64 codes, one
    ``_pack_plane`` a PLANE_SPLITS entry."""
    from quip_tpu_torch.pack.format import PLANE_SPLITS, _pack_plane
    codes, shift, planes = codes.to(torch.int64), 0, []
    for fb, _ in PLANE_SPLITS[bits]:
        planes.append(_pack_plane((codes >> shift) & (2 ** fb - 1), fb))
        shift += fb
    return tuple(planes)


def _plain_unpack(planes, bits: int, d: int) -> torch.Tensor:
    from quip_tpu_torch.pack.format import PLANE_SPLITS, _unpack_plane
    out, shift = None, 0
    for p, (fb, _) in zip(planes, PLANE_SPLITS[bits]):
        part = _unpack_plane(p, fb, d) << shift
        out = part if out is None else out | part
        shift += fb
    return out


def _host_pack(name: str) -> dict:
    """18a: one full-width Llama-2-7B layer's four fused linears and the
    32000-row head (out-features padded as pack_layer_result pads them),
    2-bit codes from a seeded CPU generator, packed by the host packer
    (``pack_codes`` of CPU int32 codes, the host-offload path) and by the
    plain torch ops, planes equal word for word, unpacked both ways; then
    the four linears at 3 bits, packed both ways and widened to 4-bit
    fields (``widen_3bit``, host packer) against the plain repack."""
    from quip_tpu_torch.pack import native
    from quip_tpu_torch.pack.format import (PackedLinear, pack_codes,
                                            unpack_codes, widen_3bit)

    g = torch.Generator().manual_seed(18)
    out = dict(threads=native.threads(), cpu_count=os.cpu_count(),
               torch_threads=torch.get_num_threads())

    def timed(fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        return r, time.perf_counter() - t

    def both(codes, bits):
        d = codes.shape[1]
        planes, ts = timed(pack_codes, codes, bits)
        plain, tp = timed(_plain_pack, codes, bits)
        assert len(planes) == len(plain)
        assert all(torch.equal(a, b) for a, b in zip(planes, plain)), bits
        back, tu = timed(unpack_codes, planes, bits, d)
        pback, tpu = timed(_plain_unpack, plain, bits, d)
        assert torch.equal(back, codes) and torch.equal(
            pback.to(torch.int32), codes), bits
        return planes, dict(native_s=ts, plain_s=tp, unpack_native_s=tu,
                            unpack_plain_s=tpu)

    pack_codes(torch.zeros((64, 64), dtype=torch.int32), 2)  # the g++ build
    for bits, names in ((2, ("wqkv", "wo", "wgu", "wd", "lm_head")),
                        (3, ("wqkv", "wo", "wgu", "wd"))):
        tot = dict(native_s=0.0, plain_s=0.0, unpack_native_s=0.0,
                   unpack_plain_s=0.0, widen_native_s=0.0,
                   widen_plain_s=0.0, codes=0)
        for nm in names:
            m, d = LLAMA_SHAPES[nm]
            codes = torch.randint(0, 2 ** bits, (m, d), generator=g,
                                  dtype=torch.int32)
            planes, t = both(codes, bits)
            for k, v in t.items():
                tot[k] += v
            tot["codes"] += m * d
            if bits == 3:
                q = PackedLinear(planes, scale_b=torch.tensor(0.02), bits=3,
                                 qfn="b", proj_mode="rht", out_features=m,
                                 in_features=d)
                w, tw = timed(widen_3bit, q)
                want, twp = timed(lambda: _plain_pack(
                    _plain_unpack(q.planes, 3, d), 4))
                assert w.code_bits == 3 and len(w.planes) == 1
                assert torch.equal(w.planes[0], want[0]), nm
                tot["widen_native_s"] += tw
                tot["widen_plain_s"] += twp
            del codes, planes
        key = "layer_and_head_2bit" if bits == 2 else "layer_3bit"
        out[key] = tot
        log(f"18a host packing, {key} ({tot['codes'] / 1e6:.0f} M codes, "
            f"{out['threads']} packer threads of {out['cpu_count']} CPUs): "
            f"host packer {tot['native_s']:.4f} s, plain torch ops "
            f"{tot['plain_s']:.4f} s ({tot['plain_s'] / tot['native_s']:.1f}"
            f"x); unpack {tot['unpack_native_s']:.4f} / "
            f"{tot['unpack_plain_s']:.4f} s; planes equal bit for bit"
            + (f"; widening to 4-bit fields {tot['widen_native_s']:.4f} / "
               f"{tot['widen_plain_s']:.4f} s" if bits == 3 else ""))
    return out


def _transcode(name: str, ckpt: str) -> dict:
    """18b: ``cli/tools.main(["transcode", ...])`` on phase 9's checkpoint,
    dequantized on the card; leaf dtypes (the linears float32, every other
    leaf as stored); the dense checkpoint loaded as a dense f32 model on
    the card against the packed checkpoint's model (bf16, K1 and K2) on
    phase 7's four prompts, teacher-forced; the output deleted."""
    from quip_tpu_torch.cli import tools as TT
    from quip_tpu_torch.convert import params_from_numpy
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import model as M
    from quip_tpu_torch.pack.model import PackedLeaf, load_checkpoint
    from quip_tpu_torch.tools.teacher_forced import serving_prompts

    dst = tempfile.mkdtemp(prefix="quip_dense_")
    try:
        t = time.time()
        (dense, meta), _ = _quiet_call(TT.main, ["transcode", "--load", ckpt,
                                                 "--save", dst])
        transcode_s = time.time() - t
        nbytes = sum(os.path.getsize(os.path.join(dst, f))
                     for f in os.listdir(dst))
        packed_tree, _ = load_checkpoint(ckpt)
        back, bmeta = load_checkpoint(dst)
        assert bmeta == meta and meta["packed"] is False, meta
        n_lin = n_other = 0

        def walk(p, dn, bk, path):
            nonlocal n_lin, n_other
            if isinstance(p, PackedLeaf):
                lead = p.planes[0].shape[:-2]
                want = (*lead, p.in_features, p.out_features)
                assert dn.dtype == bk.dtype == torch.float32, path
                assert tuple(bk.shape) == want, (path, bk.shape, want)
                n_lin += 1
            elif isinstance(p, dict):
                assert sorted(p) == sorted(dn) == sorted(bk), path
                for k in p:
                    walk(p[k], dn[k], bk[k], f"{path}/{k}")
            elif p is not None:
                assert bk.dtype == p.dtype and torch.equal(bk, p), path
                n_other += 1
        walk(packed_tree, dense, back, "")
        assert n_lin == 5, n_lin
        del dense
        cfg = dataclasses.replace(get_config("llama-2-7b"),
                                  n_layers=QUANT_LAYERS)
        packed = params_from_numpy(packed_tree, cfg, device="cuda")
        ref = params_from_numpy(back, cfg, device="cuda",
                                dtype=torch.float32)
        del packed_tree, back
        prompts = serving_prompts(cfg.vocab_size)
        gaps = {}
        _zero_counts()
        with torch.inference_mode():
            lg_packed = {n: M.forward(packed, torch.tensor(
                prompts[n], device="cuda")[None], cfg)[0].float()
                for n in (600, 128, 37, 5)}
            torch.cuda.synchronize()
            counts = _read_counts()
            with _env("QUIP_FLASH_PREFILL", "0"):
                for n, lp in lg_packed.items():
                    lr = M.forward(ref, torch.tensor(
                        prompts[n], device="cuda")[None], cfg)[0]
                    assert torch.isfinite(lp).all() and lp.shape == lr.shape
                    gaps[n] = ((lp - lr).abs().max()
                               / lr.abs().max()).item()
        L = cfg.n_layers
        # 4L + 1 packed linears a forward: the 600/128/37-token prompts on
        # K1-tile, the 5-token one on K1-decode; K2 for the 600 prompt
        assert counts == dict(k1_tile=3 * (4 * L + 1), k1_decode=4 * L + 1,
                              k2=L, k3=0, k1p=0), counts
        worst = max(gaps.values())
        assert worst <= TRANSCODE_TOL, gaps
        del packed, ref, lg_packed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(dst, ignore_errors=True)
    res = dict(transcode_s=transcode_s, bytes_written=nbytes,
               linears=n_lin, other_leaves=n_other, gaps=gaps,
               worst_gap=worst, counts=counts)
    log(f"18b transcode of phase 9's {QUANT_LAYERS}-layer checkpoint on "
        f"the card: {transcode_s:.2f} s, {nbytes / 1e9:.3f} GB written "
        f"({n_lin} linears float32, {n_other} other leaves as stored); "
        f"dense f32 against packed logits on prompts 600/128/37/5: worst "
        f"{worst:.2e} of max |logit| <= {TRANSCODE_TOL:.0e} "
        + " ".join(f"{n}:{v:.2e}" for n, v in gaps.items())
        + f"; packed forward launches K1-tile {counts['k1_tile']}, "
        f"K1-decode {counts['k1_decode']}, K2 {counts['k2']}")
    return res


def _counter(name: str) -> dict:
    """18c: ``cli/tools.main(["counter"])`` at its default sizes on the card
    (float32), each row held to the port's float64 CPU run of the same
    function."""
    from quip_tpu_torch import analysis
    from quip_tpu_torch.cli import tools as TT

    t = time.time()
    rows, _ = _quiet_call(TT.main, ["counter"])
    card_s = time.time() - t
    t = time.time()
    worst = 0.0
    for r in rows:
        ref = analysis.counter_rows(r["n"], torch.float64, "cpu")
        for k, v in ref.items():
            rel = abs(r[k] / v - 1)
            worst = max(worst, rel)
            assert rel <= COUNTER_TOL, (r["n"], k, r[k], v)
        assert r["ldlq"] < r["nearest"] / 2, r
    cpu_s = time.time() - t
    for r in rows:
        log("18c counter " + json.dumps(r))
    log(f"18c counter on the card: {card_s:.2f} s for n = "
        f"{','.join(str(r['n']) for r in rows)}; each row within "
        f"{worst:.1e} of the float64 CPU run (<= {COUNTER_TOL:.0e}, "
        f"{cpu_s:.2f} s)")
    return dict(rows=rows, card_s=card_s, cpu_f64_s=cpu_s, worst_rel=worst)


def phase_host(name: str, smi: str, ckpt: str) -> dict:
    """Phase 18 (after phase 15, on phase 9's checkpoint): the host packer
    against the plain torch ops at full width (18a), ``tools transcode``
    on the card and the dense model against the packed one (18b),
    ``tools counter`` on the card against float64 on the CPU (18c)."""
    t_phase = time.time()
    res = dict(pack=_host_pack(name), transcode=_transcode(name, ckpt),
               counter=_counter(name))
    res["phase_s"] = time.time() - t_phase
    log(f"phase 18: {res['phase_s']:.1f} s (budget {HOST_BUDGET_S:.0f} s"
        + (", OVER" if res["phase_s"] > HOST_BUDGET_S else "")
        + f"); card: {smi}")
    RESULTS["host"] = res
    return res


# Phase 11: speculative serving. K tokens drafted an iteration.
SPEC_K = 4
# phase 11's target depth: the first SPEC_LAYERS of phase 7's 32 blocks (a
# cut for the script's limit)
SPEC_LAYERS = 8           # cut from 16 to pay for phase 17
# Greedy exactness at full width. The draft's steps run K1-decode at B rows,
# the verify K1-tile at B*K rows (K1-decode up to 8), the teacher-forced
# forward K1-tile and K2 over the whole sequence: three bf16 paths whose sums
# round differently, so a near-tie in the target's logits can flip. So each
# emitted greedy token must be the argmax of the teacher-forced logits for its
# emitted prefix, or within SPEC_TOL of that row's max, relative to the row's
# max |logit|. K1's own error against its plain version is about 5e-6
# relative (phase 2): far below the activations' bf16 rounding, which sets
# the limit. Phase 9 holds the served bf16 logits of a full-depth model
# within 5e-2 of the f32 forward (PERF.md: measured 4.28e-2): 5e-2 with a
# bf16 cache. An int8 cache adds, on every K and V row, a second
# error of the same size (phase 6's argument): sqrt(2) times, 7e-2.
# Readings on an H100 (PERF.md, PR 9): sound runs at most 3.27e-2 (bf16)
# and 4.40e-2 (int8), the planted faults of _spec_faults at least 0.706:
# the limits sit 1.5 times above the one and 14 times below the other.
# The slot arena (phase 13, PR 11) read 2.65e-2 (bf16) and 5.56e-2 (int8,
# fused): 1.26 times below its limit; its planted faults (_arena_faults)
# 0.585 and 1.59, 8 times above it. The bench CLI's graph-replayed streams
# (phase 15's check on a random-code 2-bit checkpoint, bf16) read 2.94e-2
# to 4.35e-2.
SPEC_TOL = {False: 5e-2, True: 7e-2}          # by int8 KV
SPEC_MODEL = "llama-2-7b"                     # the CLI's model argument
# The hot ring by draft. The perfect draft's engines take a 16-row ring:
# their default chunk is then 2 iterations (Engine._default_max_chunk), so
# a graph holds at most 10 forwards of 32 layers to run eagerly and
# capture instead of 20 (each graph costs about 1.5 s of host time a
# forward to build: 54-67 s a warmup at 32 rows), and their rings flush
# while chunks are in flight every other chunk. The self-draft keeps
# phase 7's 32.
SPEC_HOT = {"self4": 32, "perfect": 16}


def _spec_exactness(model, cfg, reqs, gens, prefix, tol=None):
    """tools/teacher_forced.py's check: (share of tokens that are their
    row's argmax, worst gap over max |logit|), the gap held to ``tol``."""
    from quip_tpu_torch.tools.teacher_forced import exactness
    return exactness(model, cfg, reqs, gens, prefix, tol)


def _accept_all_step(draft, target, tokens, dcaches, tcaches, cfg_d, cfg_t,
                     K, *, page=64, d_prefix=None, t_prefix=None,
                     prefix_on=None, n_pages=None):
    """A planted fault: ``spec_decode_step`` with the target's verify run
    and ignored, every draft token emitted (n_emit = K)."""
    from quip_tpu_torch.serve import speculative as SP
    drafts, _ = SP._draft_steps(
        draft, tokens, dcaches, cfg_d, K,
        lambda lg: (torch.argmax(lg, dim=-1), None),
        **SP._step_kw(page, n_pages, d_prefix, prefix_on))
    SP._verify(target, tokens, drafts, tcaches, cfg_t, K,
               **SP._step_kw(page, n_pages, t_prefix, prefix_on))
    n_emit = torch.full((drafts.shape[0],), K, dtype=torch.int32,
                        device=drafts.device)
    return (drafts, n_emit, SP._advanced(dcaches, n_emit),
            SP._advanced(tcaches, n_emit))


def _spec_faults(model, cfg, draft, prompts, reqs, gens, fused):
    """Controls of the exactness check: two planted faults, each read by
    ``_spec_exactness``, whose worst gap must exceed SPEC_TOL. "accept
    all": a fresh b1 engine with the 4-layer self-draft on the serial spec
    step (eager), its step swapped for ``_accept_all_step``, one 24-token
    request of phase 7's 37-token prompt. "one row early": the sound run's
    streams with their first token dropped, so every later token stands
    one row before its own (a cursor off by one)."""
    from quip_tpu_torch.serve import speculative as SP
    from quip_tpu_torch.serve.engine import Engine
    prefix = prompts[200] if fused else None
    q = dict(prompt=prompts[37], max_new_tokens=24)
    eng = Engine(model, cfg, max_batch=1, max_seq=320, hot=32, page=64,
                 cache_dtype=torch.bfloat16, kv_quant=fused, draft=draft,
                 spec_k=SPEC_K, shared_prefix=prefix, paged=True,
                 device="cuda")
    sound = SP.spec_decode_step
    SP.spec_decode_step = _accept_all_step
    try:
        [r] = eng.run([dict(q)])
    finally:
        SP.spec_decode_step = sound
    del eng
    torch.cuda.empty_cache()
    assert len(r.generated) == 25 and all(
        0 <= x < cfg.vocab_size for x in r.generated), r.generated
    _, all_gap = _spec_exactness(model, cfg, [q], [r.generated], prefix)
    _, early_gap = _spec_exactness(model, cfg, reqs, [g[1:] for g in gens],
                                   prefix)
    tol = SPEC_TOL[fused]
    assert min(all_gap, early_gap) > tol, (all_gap, early_gap, tol)
    return dict(accept_all=all_gap, one_row_early=early_gap)


def _run_spec(eng, reqs, cfg):
    """``eng.run(reqs, chunked=True)`` (the spec pump) with every kernel's
    count set to 0 just before and read just after."""
    chunks, steps = eng._t_pump["chunks"], eng._t_pump["steps"]
    n_hist = len(eng.accept_hist)
    _zero_counts()
    t = time.time()
    out = eng.run([dict(r) for r in reqs], chunked=True)
    torch.cuda.synchronize()
    run_s = time.time() - t
    counts = _read_counts()
    for r, q in zip(out, reqs):
        assert len(r.generated) == q["max_new_tokens"] + 1, (r.uid,
                                                             len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    hist = eng.accept_hist[n_hist:]
    return dict(counts, tokens=[r.generated for r in out], run_s=run_s,
                chunks=eng._t_pump["chunks"] - chunks,
                serial_steps=eng._t_pump["steps"] - steps,
                accept=float(np.mean(hist)), iterations=len(hist),
                graphs=len(eng._graphs), stats=eng.stats())


def _spec_decode(eng, rng, cfg, n_new=48, reps=3):
    """Speculative decode timing on ``eng`` (the pump, its default chunk):
    each window submits one 13-token prompt a slot, pumps once
    (admission and the first chunk) and drains, then times the pump to the
    end (the base stays in one 64-row page, as the plain pump's first chunk
    did); ms a token a slot, the median of ``reps`` windows; then one
    window under torch.profiler (CUPTI sees a replayed graph's kernels):
    kernel ms, launches by kernel and aten ops an iteration, device busy
    share over the same window's time unprofiled. Every window starts from
    an empty acceptance history, so every window of a length runs the same
    chunks, and a first window of each length builds their graphs. The
    profiled window is shorter (about 4 tokens a slot past its first
    chunk): the profiler's own work grows with the events it records, some
    7,500 kernels an iteration with the self-draft and 24,000 with the
    perfect one."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    B = eng.max_batch
    prompts = [rng.integers(0, cfg.vocab_size, 13).tolist() for _ in range(B)]
    iters = [0]
    launch = eng._launch_spec

    def counting(active, S):
        iters[0] += S
        return launch(active, S)

    eng._launch_spec = counting

    def window(ctx=contextlib.nullcontext, n_new=n_new):
        eng.accept_hist.clear()        # the same chunks in every window
        uids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        reqs = [r for r in eng._queue if r.uid in uids]
        eng.pump()
        eng._drain_pipeline()
        torch.cuda.synchronize()
        tok0 = sum(len(r.generated) for r in reqs)
        it0, st0, h0 = iters[0], eng._t_pump["steps"], len(eng.accept_hist)
        with ctx() as prof:
            t = time.perf_counter()
            while eng.pump():
                pass
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        per_slot = (sum(len(r.generated) for r in reqs) - tok0) / B
        n_it = iters[0] - it0 + eng._t_pump["steps"] - st0
        return (ms / per_slot, n_it, prof,
                float(np.mean(eng.accept_hist[h0:])), ms)

    t = time.time()
    acc = window()[3]
    n_prof = round(SPEC_K * acc) + 4
    window(n_new=n_prof)
    first_s = time.time() - t
    t = time.time()
    runs = [window() for _ in range(reps)]
    timed_s = time.time() - t
    ms_tok = statistics.median(r[0] for r in runs)
    t = time.time()
    _, n_it, prof, _, _ = window(lambda: profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
        n_new=n_prof)
    eng._launch_spec = launch
    dev_ms, launches, aten, top = _kernel_table(prof, n_it)
    named = _kernels_named(prof, n_it, ("dm_decode", "dm_tile", "rht_mma"))
    prof_s = time.time() - t
    ms_it = statistics.median(r[4] / r[1] for r in runs)
    return dict(ms_per_token=ms_tok, ms_reps=[r[0] for r in runs],
                tok_s=B * 1e3 / ms_tok,
                accept=statistics.median(r[3] for r in runs),
                ms_per_iteration=ms_it, iterations_profiled=n_it,
                device_ms=dev_ms, kernel_launches=launches, aten_ops=aten,
                busy=dev_ms / ms_it if dev_ms else None, top=top,
                per_iteration=named, first_window_s=first_s,
                timed_windows_s=timed_s, profiled_window_s=prof_s,
                graphs=len(eng._graphs))


def _http_check(eng, reqs, want, single, want_single):
    """serve_http on a loopback port: ``reqs`` posted at once from threads
    (held in the loop's inbox until all are in, so the engine admits them
    together in order, as ``run`` does) must get ``want``; then ``single``
    streamed must yield ``want_single``. The pump sizes chunks by the
    running acceptance mean, so each run starts from an empty history, as
    the reference runs did."""
    import threading
    import urllib.request
    from quip_tpu_torch.serve.server import serve_http

    def post(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return [json.loads(ln) for ln in r.read().splitlines()]

    eng.accept_hist.clear()
    httpd, loop = serve_http(eng, port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        got = {}
        threads = []
        t = time.time()
        with loop._lock:
            for i, q in enumerate(reqs):
                th = threading.Thread(target=lambda i=i, q=q: got.update(
                    {i: post(q)[-1]}))
                th.start()
                threads.append(th)
                while loop._inbox.qsize() < i + 1:
                    time.sleep(0.001)
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        http_s = time.time() - t
        assert [got[i]["tokens"] for i in range(len(reqs))] == want
        with loop._lock:
            eng.accept_hist.clear()
        lines = post(dict(single, stream=True))
        *toks, final = lines
        assert [x["token"] for x in toks] == final["tokens"] == want_single
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        loop.shutdown()
        server.join(timeout=60)
    return dict(http_s=http_s, streamed=len(toks), metrics=metrics)


def _cli_check(model, cfg, ckpt):
    """``cli/serve.main`` on phase 7's model saved as a checkpoint, with a
    4-layer self-draft and --warmup: its tokens must equal an Engine of the
    same settings on the same weights (a fresh one: both start from an
    empty acceptance history)."""
    from quip_tpu_torch.cli import serve as cli
    from quip_tpu_torch.eval.zeroshot.lm import ByteTokenizer
    from quip_tpu_torch.serve.engine import Engine
    from quip_tpu_torch.serve.speculative import make_self_draft
    import io
    texts = ["Hello world", "Speculative decoding on the H100, 2-bit"]
    out = io.StringIO()          # its JSON lines stay off this script's own
    t = time.time()
    with contextlib.redirect_stdout(out):
        reqs = cli.main([SPEC_MODEL, "--load", ckpt, "--self_draft", "4",
                         "--spec_k", str(SPEC_K), "--warmup", "--max_batch",
                         "2", "--max_seq", "64", "--max_new_tokens", "16",
                         "--prompt", texts[0], "--prompt", texts[1]])
    torch.cuda.synchronize()
    cli_s = time.time() - t
    tok = ByteTokenizer(cfg.vocab_size)
    printed = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [x["prompt"] for x in printed] == texts, printed
    assert [x["completion"] for x in printed] == [
        tok.decode(r.generated) for r in reqs]
    ref = Engine(model, cfg, max_batch=2, max_seq=64, hot=32, page=64,
                 cache_dtype=torch.bfloat16, draft=make_self_draft(
                     model, cfg, 4), spec_k=SPEC_K, paged=True, device="cuda")
    want = [r.generated for r in ref.run(
        [dict(prompt=tok.encode(s), max_new_tokens=16) for s in texts],
        chunked=True)]
    assert [r.generated for r in reqs] == want, (
        [r.generated for r in reqs], want)
    return dict(cli_s=cli_s, tokens=want)


def phase_spec(name: str, smi: str, model, cfg, prompts):
    """Phase 11: speculative serving of phase 7's model (module docstring)."""
    from quip_tpu_torch.pack.model import save_checkpoint
    from quip_tpu_torch.serve.engine import Engine
    from quip_tpu_torch.serve.speculative import make_self_draft

    t_phase = time.time()
    drafts = {"self4": make_self_draft(model, cfg, 4),
              "perfect": (model, cfg)}
    res, keep = {}, {}
    for fused in (False, True):
        reqs = [dict(prompt=prompts[n], max_new_tokens=40)
                for n in (600, 128, 37, 5)]
        if fused:
            reqs = reqs[1:] + [dict(reqs[0], use_prefix=False)]
        for dname, draft in drafts.items():
            with fused_rht(fused):
                eng = Engine(model, cfg, max_batch=4, max_seq=1024,
                             hot=SPEC_HOT[dname], page=64,
                             cache_dtype=torch.bfloat16,
                             kv_quant=fused, draft=draft, spec_k=SPEC_K,
                             shared_prefix=prompts[200] if fused else None,
                             paged=True, device="cuda")
                t = time.time()
                eng.warmup(page_buckets=[16])
                torch.cuda.synchronize()
                warm_s, graphs = time.time() - t, len(eng._graphs)
                r = _run_spec(eng, reqs, cfg)
                t = time.time()
                exact, worst = _spec_exactness(
                    model, cfg, reqs, r["tokens"],
                    prompts[200] if fused else None, SPEC_TOL[fused])
                check_s = time.time() - t
                if dname == "self4":
                    r["faults"] = _spec_faults(model, cfg, draft, prompts,
                                               reqs, r["tokens"], fused)
                if fused and dname == "self4":
                    [smp] = eng.run([dict(prompt=prompts[37],
                                          max_new_tokens=40, temperature=0.8,
                                          top_p=0.9)], chunked=True)
                    assert len(smp.generated) == 41 and all(
                        0 <= x < cfg.vocab_size for x in smp.generated)
                    r["sampled"] = smp.generated
            what = f"{'fused_int8_prefix' if fused else 'unfused'}_{dname}"
            res[what] = dict(r, warmup_s=warm_s, warm_graphs=graphs,
                             exact_share=exact, worst_gap=worst,
                             check_s=check_s)
            if dname == "perfect":
                assert r["accept"] > 3.0, r["accept"]
            assert r["k1_decode"] > 0 and r["k1_tile"] > 0, r
            assert r["k1p"] == 0, r        # K1' is a microbenchmark only
            if fused:
                assert r["k3"] > 0, r
            else:
                assert r["k3"] == 0 and r["k2"] == cfg.n_layers + drafts[
                    dname][1].n_layers, r
            log(f"spec, {what}: warmup {warm_s:.1f} s ({graphs} graphs); "
                f"phase 7's 4 requests in {r['run_s']:.2f} s, {r['chunks']} "
                f"chunks, {r['serial_steps']} serial steps, "
                f"{r['iterations']} slot-iterations, accept "
                f"{r['accept']:.2f} tokens an iteration; launches K1-decode "
                f"{r['k1_decode']}, K1-tile {r['k1_tile']}, K2 {r['k2']}, K3 "
                f"{r['k3']}; greedy tokens the teacher-forced argmax "
                f"{exact:.1%}, worst gap {worst:.2e} <= "
                f"{SPEC_TOL[fused]:.0e} of max |logit| (checked in "
                f"{check_s:.1f} s)" + (
                    "; planted faults read worst gaps " + ", ".join(
                        f"{k} {v:.2e}" for k, v in r["faults"].items())
                    if "faults" in r else ""))
            if fused or dname != "self4":
                del eng
            else:
                keep[dname] = eng
            torch.cuda.empty_cache()

    # decode timing of the self-draft: b4 on the un-fused engine above
    # (warm), b1 on a new one. The perfect draft's timing windows are cut
    # (the script's 1200 s limit); its exactness runs above stay.
    rng = np.random.default_rng(11)
    dec = {}
    for dname in ("self4",):
        draft = drafts[dname]
        b1 = Engine(model, cfg, max_batch=1, max_seq=1024,
                    hot=SPEC_HOT[dname], page=64, cache_dtype=torch.bfloat16,
                    draft=draft, spec_k=SPEC_K, paged=True, device="cuda")
        with fused_rht(False):
            dec[(dname, 1)] = _spec_decode(b1, rng, cfg)
            dec[(dname, 4)] = _spec_decode(keep[dname], rng, cfg)
        del b1
        torch.cuda.empty_cache()
    for (dname, B), x in dec.items():
        log(f"spec decode b{B}, {dname} draft, K={SPEC_K}: "
            f"{x['ms_per_token']:.2f} ms a token a slot ({x['tok_s']:.1f} "
            f"tok/s) [windows {', '.join(f'{v:.2f}' for v in x['ms_reps'])}],"
            f" accept {x['accept']:.2f} a slot-iteration, "
            f"{x['ms_per_iteration']:.2f} ms an iteration; profiled: "
            f"{x['device_ms']:.2f} ms of kernels an iteration, "
            f"{x['kernel_launches']:.0f} launches (K1-decode "
            f"{x['per_iteration']['dm_decode']:.0f}, K1-tile "
            f"{x['per_iteration']['dm_tile']:.0f}), {x['aten_ops']:.0f} aten "
            f"ops; busy " + (f"{x['busy']:.1%}" if x["busy"] else
                             "not measured")
            + f"; {x['graphs']} graphs; seconds: first window "
              f"{x['first_window_s']:.1f}, timed {x['timed_windows_s']:.1f}, "
              f"profiled {x['profiled_window_s']:.1f}")
        for key, ms, cnt in x["top"]:
            log(f"    {key[:60]:60s} {ms:.3f} ms/iteration, {cnt:.0f} "
                f"launches/iteration")
        # graph replays: an eager iteration runs about an aten op a kernel
        # launch, a replayed one only the pump's few host ops a chunk
        assert x["per_iteration"]["dm_decode"] > 0, x
        assert x["aten_ops"] < 0.05 * x["kernel_launches"], x

    # the HTTP front end on the un-fused self-draft engine, then the CLI
    eng = keep["self4"]
    reqs = [dict(prompt=prompts[n], max_new_tokens=40)
            for n in (600, 128, 37, 5)]
    eng.accept_hist.clear()
    [single] = eng.run([dict(prompt=prompts[37], max_new_tokens=40)],
                       chunked=True)
    http = _http_check(eng, reqs, res["unfused_self4"]["tokens"],
                       dict(prompt=prompts[37], max_new_tokens=40),
                       single.generated)
    log(f"serve_http: 4 concurrent requests in {http['http_s']:.2f} s with "
        f"Engine.run's tokens; a streamed request's {http['streamed']} "
        f"tokens equal its run's")
    keep.clear()
    del eng
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="quip_spec_ckpt_")
    try:
        t = time.time()
        save_checkpoint(ckpt, model, {"model": SPEC_MODEL, "wbits": 2})
        save_s = time.time() - t
        with _cut_depth(cfg.n_layers):
            cli = _cli_check(model, cfg, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"cli/serve.main --self_draft 4 --warmup: {cli['cli_s']:.1f} s "
        f"(checkpoint saved in {save_s:.1f} s), its tokens equal an "
        f"Engine's on the same settings")
    phase_s = time.time() - t_phase
    log(f"phase 11: {phase_s:.1f} s; card: {smi}")
    RESULTS["spec"] = dict(runs=res, decode={f"b{B}_{d}": x for (d, B), x
                                             in dec.items()},
                           http=http, cli=cli, phase_s=phase_s)
    return res, dec


# Phase 12: the OPT and BLOOM families at their published widths.
FAMILY_PRESETS = ("opt-6.7b", "bloom-7b1")
BLOOM_LAYERS = 4          # phase 12c's BLOOM-7b1 depth (of 30): a cut
OPT_LAYERS = 8            # phase 12b's OPT-6.7B depth (of 32): a cut
FAMILY_QUANT_LAYERS = 2   # phase 12d's OPT-6.7B depth (of 32): a cut
FAMILY_QUANT_NSAMPLES = 32


def _random_biases(model, seed: int):
    """Redraw every bias of ``model``'s blocks (normal, 0.02) in place:
    init_params draws them zero, which would hide a dropped add."""
    from quip_tpu_torch.models import model as TM
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for b in model.blocks:
        for mod, names in ((b.attn, TM.Attention.NAMES),
                           (b.mlp, TM.MLP.NAMES)):
            for n in names:
                t = getattr(mod, n)
                if n.startswith("b") and t is not None:
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device="cuda") * 0.02)


def phase_families(name: str, smi: str, llama_dec=None):
    """Phase 12: the OPT and BLOOM families (module docstring).
    ``llama_dec``: phase 8's decode timings, printed beside OPT-6.7B's."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.serve.engine import Engine

    t_phase = time.time()
    res = {}
    # a. two full-width layers of each, against the CPU f32 plain path
    for preset in FAMILY_PRESETS:
        t = time.time()
        cfg = dataclasses.replace(get_config(preset), n_layers=2)
        model = packed_model(cfg, bits=2, seed=5, dtype=torch.bfloat16,
                             device="cuda")
        res[f"slice_{preset}"] = dict(
            counts=_slice_check(model, cfg, ((False, False), (True, True)),
                                f"{preset} 2-layer check", res, preset,
                                dense_ref=True),
            s=time.time() - t)
        log(f"{preset} 2-layer checks: {time.time() - t:.1f} s")
        del model
        torch.cuda.empty_cache()

    # b. OPT-6.7B at OPT_LAYERS of 32 layers: phase 7's requests, serial
    # and through the pump
    cfg = dataclasses.replace(get_config("opt-6.7b"), dtype="bfloat16",
                              n_layers=OPT_LAYERS)
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.bfloat16,
                         device="cuda")
    rng = np.random.default_rng(12)
    lens = (600, 128, 37, 5)
    prompts = {n: rng.integers(0, cfg.vocab_size, n).tolist()
               for n in lens + (200,)}
    reqs = [dict(prompt=prompts[n], max_new_tokens=40) for n in lens]
    n_lin = 4 * cfg.n_layers            # the tied head is dense
    tiled = sum(n >= 9 for n in lens)
    kw = dict(max_batch=4, max_seq=1024, hot=32, page=64,
              cache_dtype=torch.bfloat16, device="cuda")
    t_b = time.time()
    with fused_rht(False):
        eng = Engine(model, cfg, paged=True, **kw)
        serial = _run_engine(eng, reqs, cfg)
        del eng
        # K1-decode: every decode step and the 5-token prompt
        assert serial["k1_tile"] == n_lin * tiled, serial
        assert serial["k1_decode"] == n_lin * (
            serial["decode_steps"] + len(lens) - tiled), serial
        assert serial["k1_per_step"] == n_lin, serial
        assert serial["k2"] == cfg.n_layers and serial["k3"] == 0, serial
        # no warmup: the pump builds each chunk graph at its first use
        # (phase 8 times warmup; a build runs the chunk eagerly once, so
        # the tokens and counts stay exact)
        eng = Engine(model, cfg, paged=True, **kw)
        pump = _run_pump(eng, reqs, cfg, serial["tokens"])
        pump.update(graphs=len(eng._graphs), capture_s=eng._graphs.capture_s)
        del eng
        assert pump["k1_tile"] == n_lin * tiled, pump
        assert pump["k2"] == cfg.n_layers, pump
        assert pump["k1_decode"] >= n_lin * 40, pump
        assert pump["k1_decode"] % n_lin == 0 and pump["k3"] == 0, pump
        # b1 only: the b4 window was cut to pay for phases 13-15's time
        t = time.time()
        dec = {B: _pump_decode(model, cfg, rng, B) for B in (1,)}
        dec_s = time.time() - t
    torch.cuda.empty_cache()
    log(f"OPT-6.7B ({cfg.n_layers} layers, 2-bit, dense tied head): "
        f"Engine.run 4 "
        f"requests in {serial['run_s']:.2f} s, {serial['decode_steps']} "
        f"decode steps; launches K1-decode {serial['k1_decode']} "
        f"({serial['k1_per_step']} a step), K1-tile {serial['k1_tile']}, K2 "
        f"{serial['k2']}; pump: the same tokens in {pump['run_s']:.2f} s "
        f"({pump['graphs']} graphs built in it, {pump['capture_s']:.1f} s), "
        f"{pump['chunks']} chunks, launches "
        f"K1-decode {pump['k1_decode']}, K1-tile {pump['k1_tile']}, K2 "
        f"{pump['k2']}; decode timing {dec_s:.1f} s (first runs "
        + ", ".join(f"{x['first_run_s']:.1f}" for x in dec.values())
        + f" s); 12b {time.time() - t_b:.1f} s")
    busy = lambda x: (f"{x['busy']:.1%}" if x["busy"]  # noqa: E731
                      else "not measured")
    for B, x in dec.items():
        log(f"decode b{B} through the pump, un-fused: OPT-6.7B "
            f"{x['ms_per_step']:.2f} ms/step [windows "
            f"{', '.join(f'{v:.2f}' for v in x['ms_reps'])}], "
            f"{x['device_ms']:.2f} ms of kernels a step, "
            f"{x['kernel_launches']:.0f} launches (K1-decode "
            f"{x['per_step']['dm_decode']:.0f}), busy {busy(x)}"
            + ("" if llama_dec is None else
               f"; Llama-2-7B (phase 8, this call) "
               f"{llama_dec[(False, B)]['pump']['ms_per_step']:.2f} ms/step, "
               f"{llama_dec[(False, B)]['pump']['device_ms']:.2f} ms of "
               f"kernels, busy {busy(llama_dec[(False, B)]['pump'])}"))
        for key, ms, cnt in x["top"]:
            log(f"    {key[:60]:60s} {ms:.3f} ms/step, {cnt:.0f} "
                f"launches/step")
        assert round(x["per_step"]["dm_decode"]) == n_lin, x["per_step"]
    res["opt"] = dict(serial=serial, pump=pump,
                      decode={f"b{B}": x for B, x in dec.items()})
    del model
    torch.cuda.empty_cache()

    # c. BLOOM-7b1 at reduced depth: ALiBi through the paged cache, int8
    # KV, QUIP_FUSED_RHT=1, a shared prefix; serial against the pump
    t_c = time.time()
    cfg = dataclasses.replace(get_config("bloom-7b1"), n_layers=BLOOM_LAYERS,
                              dtype="bfloat16")
    model = packed_model(cfg, bits=2, seed=1, dtype=torch.bfloat16,
                         device="cuda")
    rng = np.random.default_rng(13)
    bp = {n: rng.integers(0, cfg.vocab_size, n).tolist()
          for n in lens + (200,)}
    breqs = [dict(prompt=bp[n], max_new_tokens=40) for n in lens[1:]] + [
        dict(prompt=bp[600], max_new_tokens=40, use_prefix=False)]
    bkw = dict(kw, kv_quant=True, shared_prefix=bp[200])
    with fused_rht(True):
        eng = Engine(model, cfg, paged=True, **bkw)
        bserial = _run_engine(eng, breqs, cfg)
        del eng
        eng = Engine(model, cfg, paged=True, **bkw)
        bpump = _run_pump(eng, breqs, cfg, bserial["tokens"])
        bpump.update(graphs=len(eng._graphs),
                     capture_s=eng._graphs.capture_s)
        del eng
    for r in (bserial, bpump):
        assert r["k2"] == 0 and r["k1_decode"] > 0 and r["k1_tile"] > 0, r
    assert bserial["k3_per_step"] == 8 * cfg.n_layers, bserial
    assert bserial["k1_per_step"] == 4 * cfg.n_layers, bserial
    log(f"BLOOM-7b1 ({cfg.n_layers} of 30 layers, 2-bit, ALiBi, int8 KV, "
        f"QUIP_FUSED_RHT=1, 200-token prefix for 128/37/5, 600 without): "
        f"Engine.run in {bserial['run_s']:.2f} s, launches K1-decode "
        f"{bserial['k1_decode']}, K1-tile {bserial['k1_tile']}, K2 "
        f"{bserial['k2']}, K3 {bserial['k3']} ({bserial['k3_per_step']} a "
        f"step); the pump the same greedy tokens in {bpump['run_s']:.2f} s "
        f"({bpump['graphs']} graphs built in it), K2 {bpump['k2']}; 12c "
        f"{time.time() - t_c:.1f} s")
    res["bloom"] = dict(serial=bserial, pump=bpump, s=time.time() - t_c)
    del model
    torch.cuda.empty_cache()

    # d. quantizing full-width OPT-6.7B at reduced depth
    res["quantize"] = _quantize_family(smi)
    phase_s = time.time() - t_phase
    log(f"phase 12: {phase_s:.1f} s; card: {smi}")
    res["phase_s"] = phase_s
    RESULTS["families"] = res
    return res


def _quantize_family(smi: str) -> dict:
    """Phase 12d: a dense random OPT-6.7B (nonzero biases) of
    FAMILY_QUANT_LAYERS layers quantized as the CLI does it (fused,
    synthetic calibration, LDLQ with incoherence; a tied head stays
    dense); LDLQ / nearest on every linear, a bit-exact checkpoint round
    trip, and the checkpoint's 600-token prefill through K1-tile against
    the f32 W_hat forward."""
    from quip_tpu_torch.convert import params_from_numpy
    from quip_tpu_torch.data.calib import get_loaders
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import model as TM
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.pack.model import (load_checkpoint,
                                           pack_quantized_model,
                                           save_checkpoint, unpack_model)
    from quip_tpu_torch.quantize.config import QuantConfig
    from quip_tpu_torch.quantize.driver import quantize_model
    from quip_tpu_torch.quantize.pipeline import quantize_layer

    t0 = time.time()
    cfg = dataclasses.replace(get_config("opt-6.7b"),
                              n_layers=FAMILY_QUANT_LAYERS, dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = TM.fuse_params(TM.init_params(gen, cfg, device="cuda"), cfg)
    _random_biases(params, 1)
    calib, _ = get_loaders("synthetic", nsamples=FAMILY_QUANT_NSAMPLES,
                           seed=0, seqlen=2048, vocab_size=cfg.vocab_size)
    calib = torch.from_numpy(calib).cuda()
    specs = TM.linear_specs(cfg, fused=True)
    names = [f"layers.{li}.{sp.name}" for li in range(cfg.n_layers)
             for sp in specs]
    t = time.time()
    newp, art = quantize_model(params, cfg, calib,
                               QuantConfig.incoherence(2, "ldlq"), seed=0,
                               chunk=4, keep_hessians=names, progress=True)
    torch.cuda.synchronize()
    quant_s = time.time() - t
    ratios = {}
    for nm in names:
        res = art.results[nm]
        li, sp = int(nm.split(".")[1]), {s.name: s for s in specs}[
            nm.split(".", 2)[2]]
        W = getattr(getattr(params.blocks[li], sp.path[0]), sp.path[1])
        near = quantize_layer(W.t(), art.hessians[nm],
                              QuantConfig.incoherence(2, "nearest"),
                              rot=(res.preproc.U, res.preproc.V))
        ratios[nm] = art.errors[nm] / float(near.error)
    log(f"OPT-6.7B quantize ({cfg.n_layers} of 32 layers, full width, "
        f"{FAMILY_QUANT_NSAMPLES} x 2048 synthetic windows): "
        f"quantize_model {quant_s:.1f} s; LDLQ / nearest proxy loss "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    assert all(v < 1 for v in ratios.values()), ratios
    assert set(art.results) == set(names), sorted(art.results)
    packed = pack_quantized_model(newp, cfg, art, 2)
    del params, newp, art
    ckpt = tempfile.mkdtemp(prefix="quip_opt_ckpt_")
    try:
        save_checkpoint(ckpt, packed, {"model": "opt-6.7b", "wbits": 2})
        tree, _ = load_checkpoint(ckpt)
        loaded = params_from_numpy(tree, cfg, device="cuda")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want_sd, got_sd = packed.state_dict(), loaded.state_dict()
    assert list(want_sd) == list(got_sd), set(want_sd) ^ set(got_sd)
    for k, v in want_sd.items():
        assert v.dtype == got_sd[k].dtype and torch.equal(v, got_sd[k]), k
    del packed, want_sd, got_sd, tree
    prompt = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (1, 600))).cuda()
    kv = PG.init_paged(1, 640 + 32, cfg, dtype=torch.bfloat16, hot=32,
                       page=64, device="cuda")
    _zero_counts()
    got, _ = PG.paged_prefill_slot(loaded, prompt, 600, kv, 0, cfg)
    torch.cuda.synchronize()
    counts = _read_counts()
    assert counts["k1_tile"] == 4 * cfg.n_layers, counts
    assert counts["k2"] == cfg.n_layers, counts
    dense = unpack_model(loaded, torch.float32)
    del loaded, kv
    with _env("QUIP_FLASH_PREFILL", "0"), torch.no_grad():
        ref = TM.forward(dense, prompt, cfg)[0, -1]
    del dense
    torch.cuda.empty_cache()
    err = _fro(got.float(), ref)
    log(f"OPT-6.7B checkpoint: bit-exact round trip; its 600-token prefill "
        f"through K1-tile ({counts['k1_tile']} launches, K2 "
        f"{counts['k2']}) against the f32 W_hat forward: relative "
        f"Frobenius {err:.2e} <= 5e-2; phase 12d {time.time() - t0:.1f} s")
    assert err <= 5e-2, err
    return dict(quant_s=quant_s, ratios=ratios, logit_err=err,
                counts=counts, s=time.time() - t0)


# Phase 9's calibration: the reference's defaults are 128 windows of 2048
# tokens, chunks of 4, at full depth and width. Its budget is 300 s; past
# it the samples are cut first (to 32), then the depth, never the width.
# Cut to 32 since phase 12 joined the script: the 1200 s limit.
QUANT_NSAMPLES = 32
# phase 9's depth (of 32), which phases 10 and 15 read back: cut from 32
# to 16 (with phase 11's SPEC_LAYERS) to pay for phase 16, and to 4 for
# phase 17, within the script's limit
QUANT_LAYERS = 4
QUANT_BUDGET_S = 300.0


def _fro(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative Frobenius error of got against want (f32)."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _tap_hessians(model, cfg, tokens, flash: bool):
    """Layer 0's four tap Hessians over one chunk of calibration windows
    through the driver's own accumulate, with QUIP_FLASH_PREFILL on (K2)
    or off (dense attention); returns (H by tap, K2 launches)."""
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.quantize import driver as QD
    with _env("QUIP_FLASH_PREFILL", "1" if flash else "0"):
        n, S = tokens.shape
        accumulate, _ = QD._make_block_fns(cfg, S, n, tokens.device)
        H = {}
        k2 = FA.launches
        accumulate(model.blocks[0], QD._block_inputs(model, cfg, tokens, n),
                   H)
        torch.cuda.synchronize()
        return H, FA.launches - k2


def phase_quantize(name: str, smi: str, ckpt: str):
    """Phase 9: QuIP's quantization path on a full-width random Llama-2-7B
    through the quantize CLI's calls (load_model with --weights random,
    fuse_params, get_data 'synthetic', quantize_model with
    QuantConfig.incoherence(2, 'ldlq') and quant_head, pack_quantized_model,
    save_checkpoint into ``ckpt``, which phase 10 reads); then the loaded
    checkpoint served by Engine.run."""
    from quip_tpu_torch.cli import common
    from quip_tpu_torch.cli import quantize as CLI
    from quip_tpu_torch.convert import params_from_numpy
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.models import model as TM
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.ops.qlinear import qlinear_apply
    from quip_tpu_torch.pack.format import pack_layer_result
    from quip_tpu_torch.pack.model import (load_checkpoint,
                                           pack_quantized_model,
                                           save_checkpoint, unpack_model)
    from quip_tpu_torch.quantize.config import QuantConfig
    from quip_tpu_torch.quantize.driver import quantize_model
    from quip_tpu_torch.quantize.pipeline import (dequantize_result,
                                                  quantize_layer)
    from quip_tpu_torch.serve.engine import Engine

    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    parser = CLI.build_parser()
    args = parser.parse_args([
        "llama-2-7b", "synthetic", "--weights", "random", "--wbits", "2",
        "--quant", "ldlq", "--incoh_processing", "--fuse", "--quant_head",
        "--packed", "--nsamples", str(QUANT_NSAMPLES), "--seed", "0",
        "--chunk", "4", "--device", "cuda"])
    CLI.check_args(parser, args)
    params, cfg = common.load_model(args)
    params = TM.fuse_params(params, cfg)
    (calib, _), seqlen = common.get_data(args, cfg)
    qcfg = common.quant_config_from_args(args)
    assert qcfg == QuantConfig.incoherence(2, "ldlq"), qcfg
    calib = torch.from_numpy(calib).cuda()
    torch.cuda.synchronize()
    setup_s = time.time() - t_phase
    log(f"quantize: {args.model} (d={cfg.d_model}, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_layers} layers, {cfg.dtype}), fused, "
        f"synthetic calibration {tuple(calib.shape)}, chunk {args.chunk}; "
        f"built in {setup_s:.1f} s; "
        + ("no cut" if QUANT_NSAMPLES == 128 else
           f"CUT to {QUANT_NSAMPLES} samples (the reference's 128)"))

    # the o_in tap on the flash path: layer 0's tap Hessians over one chunk
    # with K2 against dense attention (bf16 activations: 1e-2)
    H_fl, k2_fl = _tap_hessians(params, cfg, calib[:4], flash=True)
    H_de, k2_de = _tap_hessians(params, cfg, calib[:4], flash=False)
    assert sorted(H_fl) == ["attn_in", "down_in", "mlp_in", "o_in"], H_fl
    assert k2_fl == 1 and k2_de == 0, (k2_fl, k2_de)
    tap_err = {k: _fro(H_fl[k], H_de[k]) for k in H_fl}
    log(f"tap Hessians of layer 0, K2 against dense attention "
        f"(4 windows): relative Frobenius "
        + ", ".join(f"{k} {v:.2e}" for k, v in tap_err.items())
        + " <= 1e-2")
    assert max(tap_err.values()) <= 1e-2, tap_err
    del H_fl, H_de

    sampled = [f"layers.{li}.{sp.name}"
               for li in sorted({0, cfg.n_layers - 1})
               for sp in TM.linear_specs(cfg, fused=True)] + ["lm_head"]
    _zero_counts()
    t = time.time()
    newp, art = quantize_model(params, cfg, calib, qcfg, seed=args.seed,
                               chunk=args.chunk, keep_hessians=sampled,
                               progress=True, quant_head=args.quant_head)
    torch.cuda.synchronize()
    quant_s = time.time() - t
    k2_calib, k1_calib = FA.launches, DM.launches
    assert k2_calib > 0, "the calibration forward did not run K2"
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ph = np.array([art.phase_times[f"layers.{i}"]
                   for i in range(cfg.n_layers)])
    per_layer = ph.sum(1)
    lin = art.linear_times
    log(f"quantize_model: {quant_s:.1f} s for {cfg.n_layers} layers + "
        f"lm_head ({art.times['lm_head']:.1f} s); a layer median "
        f"{np.median(per_layer):.2f} s, max {per_layer.max():.2f} s "
        f"(Hessian pass median {np.median(ph[:, 0]):.2f} s, solves "
        f"{np.median(ph[:, 1]):.2f} s, replay {np.median(ph[:, 2]):.2f} s); "
        f"solve s a linear (layer 0): "
        + ", ".join(f"{k.split('.', 2)[2]} {v:.2f}" for k, v in lin.items()
                    if k.startswith("layers.0."))
        + f"; K2 launches in calibration {k2_calib} (K1 {k1_calib}); peak "
        f"{peak_gib:.1f} GiB; total proxy error {art.total_error:.4f}")

    # the paper's claim on the same Wp, Hp and rotation: LDLQ < nearest
    ratios = {}
    for nm in sampled:
        res = art.results[nm]
        if nm == "lm_head":
            W = params.lm_head
        else:
            li, spec = int(nm.split(".")[1]), nm.split(".", 2)[2]
            sp = {s.name: s for s in TM.linear_specs(cfg, fused=True)}[spec]
            W = getattr(getattr(params.blocks[li], sp.path[0]), sp.path[1])
        near = quantize_layer(W.t(), art.hessians[nm],
                              QuantConfig.incoherence(2, "nearest"),
                              rot=(res.preproc.U, res.preproc.V))
        ratios[nm] = art.errors[nm] / float(near.error)
    log("LDLQ / nearest proxy loss: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ratios.items()))
    assert all(v < 1 for v in ratios.values()), ratios

    # K1 against the quantizer's own output (f32 W_hat of its postproc)
    gen = torch.Generator(device="cuda").manual_seed(9)
    k1_err = {}
    for nm in sampled:
        if not (nm.startswith("layers.0.") or nm == "lm_head"):
            continue
        res = art.results[nm]
        packed = pack_layer_result(res, 2)
        W32 = dequantize_result(res, 2, torch.float32)
        for B in (1, 600):
            x = torch.randn(B, W32.shape[1], generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            before = (DM.launches_decode, DM.launches_tile)
            y = qlinear_apply(packed, x)
            path = ("decode" if DM.launches_decode > before[0] else
                    "tile" if DM.launches_tile > before[1] else None)
            assert path == ("decode" if B <= 8 else "tile"), (nm, B, path)
            k1_err[f"{nm} B={B}"] = _fro(y, x.float() @ W32.t())
        del packed, W32
    log("K1 on the packed layers against x @ W_hat_f32^T, relative "
        "Frobenius: " + ", ".join(f"{k} {v:.2e}" for k, v in k1_err.items())
        + " <= 2e-2")
    assert max(k1_err.values()) <= 2e-2, k1_err

    # pack, save, load: bit for bit
    packed_model = pack_quantized_model(newp, cfg, art, 2)
    errors = dict(art.errors)
    del params, newp, art
    torch.cuda.empty_cache()
    t = time.time()
    save_checkpoint(ckpt, packed_model, {"model": args.model, "wbits": 2,
                                         "quant": "ldlq", "packed": True,
                                         "seqlen": seqlen})
    save_s = time.time() - t
    ckpt_mib = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt)) / 2 ** 20
    t = time.time()
    tree, meta = load_checkpoint(ckpt)
    assert meta["model"] == args.model and meta["packed"], meta
    loaded = params_from_numpy(tree, cfg, device="cuda")
    load_s = time.time() - t
    want_sd, got_sd = packed_model.state_dict(), loaded.state_dict()
    assert list(want_sd) == list(got_sd), set(want_sd) ^ set(got_sd)
    for k, v in want_sd.items():
        assert v.dtype == got_sd[k].dtype and torch.equal(v, got_sd[k]), k
    n_planes = sum(1 for k in want_sd if ".plane" in k)
    log(f"checkpoint: {ckpt_mib:.0f} MiB, saved in {save_s:.1f} s, loaded "
        f"in {load_s:.1f} s; {len(want_sd)} buffers equal bit for bit "
        f"({n_planes} planes)")
    del packed_model, want_sd, got_sd, tree
    torch.cuda.empty_cache()

    # serve the loaded checkpoint; the first 600-token prefill's logits
    # against the same forward with every packed linear as its f32 W_hat
    rng = np.random.default_rng(9)
    prompts = {n: rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (600, 128, 37, 5)}
    first = {}
    orig = PG.paged_prefill_slot

    def capture(*a, **kw):
        out = orig(*a, **kw)
        if int(a[2]) == 600 and "logits" not in first:
            first["logits"] = out[0].float().clone()
        return out

    PG.paged_prefill_slot = capture
    try:
        eng = Engine(loaded, cfg, max_batch=4, max_seq=1024, hot=32,
                     page=64, cache_dtype=torch.bfloat16, paged=True,
                     device="cuda")
        reqs = [dict(prompt=prompts[n], max_new_tokens=16)
                for n in (600, 128, 37, 5)]
        with fused_rht(False):
            served = _run_engine(eng, reqs, cfg)
    finally:
        PG.paged_prefill_slot = orig
    assert served["k1_decode"] > 0 and served["k1_tile"] > 0, served
    assert served["k2"] == cfg.n_layers, served
    del eng
    torch.cuda.empty_cache()
    dense = unpack_model(loaded, torch.float32)
    del loaded
    # K2 takes bf16 only
    with _env("QUIP_FLASH_PREFILL", "0"), torch.no_grad():
        ref = TM.forward(dense, torch.tensor([prompts[600]], device="cuda"),
                         cfg)[0, -1]
    del dense
    torch.cuda.empty_cache()
    logit_err = _fro(first["logits"], ref)
    log(f"served the loaded checkpoint: Engine.run, 4 greedy requests "
        f"(prompts 600/128/37/5, 16 new tokens) in {served['run_s']:.2f} s; "
        f"launches K1-decode {served['k1_decode']}, K1-tile "
        f"{served['k1_tile']}, K2 {served['k2']}; tokens "
        f"{served['tokens']}; first 600-token prefill's last logits against "
        f"the f32 W_hat forward: relative Frobenius {logit_err:.2e} <= 5e-2")
    assert logit_err <= 5e-2, logit_err
    phase_s = time.time() - t_phase
    log(f"phase 9: {phase_s:.1f} s (budget {QUANT_BUDGET_S:.0f} s"
        + (", OVER" if phase_s > QUANT_BUDGET_S else "") + f"); card: {smi}")
    RESULTS["quantize"] = dict(
        nsamples=QUANT_NSAMPLES, setup_s=setup_s, quant_s=quant_s, phase_s=phase_s,
        layer_s=per_layer.tolist(), hessian_s=ph[:, 0].tolist(),
        solve_s=ph[:, 1].tolist(), replay_s=ph[:, 2].tolist(),
        linear_s=lin, lm_head_s=lin["lm_head"], k2_calibration=k2_calib,
        peak_gib=peak_gib, total_error=sum(errors.values()), errors=errors,
        ratios=ratios, tap_err=tap_err, k1_err=k1_err, ckpt_mib=ckpt_mib,
        save_s=save_s, load_s=load_s, logit_err=logit_err, serve=served)
    return RESULTS["quantize"]


# Phase 10's tolerances, stated before its first run on the card. Mean nll
# is in nats a predicted token. The packed window (bf16 activations through
# K1-tile and K2) against the same checkpoint unpacked to f32 with dense
# attention: 2e-2 (phase 9 holds served logits to 5e-2 of the f32 W_hat
# forward, relative Frobenius; a window's mean averages 2047 such rows).
# The dense bf16 model with K2 against dense attention: 1e-2 (the same
# bf16 weights on both sides, only attention differs). A zero-shot request
# through the kernels against the unpacked model, |diff ll| over its
# continuation tokens: 1e-1. A request averages 5-30 tokens of one context,
# whose errors move together, so it does not average like a window: a
# token's log-prob moves with its logits, which phase 9 holds within 5e-2
# (relative) of the f32 forward, and this model's logits have an RMS of
# about 1.3 (unit-norm rows times an lm_head drawn at 0.02 over 4096
# inputs): about 6.5e-2 a token, 1e-1 with room. (A first limit of 2e-2,
# set as for the window, failed at 5.1e-2 on phase 9's checkpoint.)
EVAL_NLL_TOL = 2e-2
EVAL_FLASH_TOL = 1e-2
EVAL_LL_TOL = 1e-1
EVAL_TASKS = "synthetic,piqa,arc_easy"


def _eval_cli(argv, fuse: bool = False) -> dict:
    """``cli/eval.main(argv)``: its model kept (fused first when ``fuse``),
    the kernels' counts set to 0 just before its ``perplexity`` call and
    read just after, and that call's seconds."""
    from quip_tpu_torch.cli import eval as ECLI
    from quip_tpu_torch.eval import ppl as PPL
    from quip_tpu_torch.models import model as TM

    got = {}
    load, perplexity = ECLI.load, PPL.perplexity

    def loading(args):
        params, cfg = load(args)
        if fuse:
            params = TM.fuse_params(params, cfg)
        got.update(model=params, cfg=cfg)
        return params, cfg

    def scoring(params, cfg, stream, seqlen, batch=1):
        torch.cuda.synchronize()
        _zero_counts()
        t = time.time()
        out = perplexity(params, cfg, stream, seqlen, batch=batch)
        torch.cuda.synchronize()
        got.update(s=time.time() - t, counts=_read_counts(), stream=stream,
                   seqlen=seqlen)
        return out

    ECLI.load, PPL.perplexity = loading, scoring
    try:
        got["ppl"] = ECLI.main(argv)
    finally:
        ECLI.load, PPL.perplexity = load, perplexity
    return got


def _window(model, cfg, tk) -> dict:
    """One window's summed nll through ``window_nll``: host ms (the better
    of two timed calls), then a profiled call's kernel ms, launches and the
    device ms of K1-tile (``dm_prep`` + ``dm_tile``) and K2 (``flash_fwd``);
    busy share = kernel ms over host ms."""
    from torch.profiler import ProfilerActivity, profile
    from quip_tpu_torch.eval.ppl import window_nll

    host = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            nll = float(window_nll(model, tk, cfg)[0])
            host.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window_nll(model, tk, cfg)
            torch.cuda.synchronize()
    dev_ms, launches, aten, top = _kernel_table(prof, 1, 6)
    host_ms = min(host)
    return dict(nll=nll, host_ms=host_ms, device_ms=dev_ms,
                kernel_launches=launches, aten_ops=aten, top=top,
                k1_tile_ms=_device_ms(prof, "dm_tile", "dm_prep")[0],
                k2_ms=_device_ms(prof, "flash_fwd")[0],
                busy=dev_ms / host_ms if dev_ms else None)


def _log_ppl_row(label: str, r: dict, nwin: int, seqlen: int):
    w = r["window"]
    share = (lambda ms: f"{ms / w['device_ms']:.1%}" if w["device_ms"]
             else "not measured")
    log(f"ppl {label}: {r['ppl']:.4f} over {nwin} windows of {seqlen} "
        f"tokens in {r['s']:.2f} s ({r['tok_s']:.0f} tok/s); launches a "
        f"window K1-tile {r['counts']['k1_tile'] / nwin:g}, K1-decode "
        f"{r['counts']['k1_decode'] / nwin:g}, K2 {r['counts']['k2'] / nwin:g}"
        f"; one window: {w['host_ms']:.1f} ms, {w['device_ms']:.2f} ms of "
        f"kernels in {w['kernel_launches']:.0f} launches (K1-tile "
        f"{w['k1_tile_ms']:.2f} ms = {share(w['k1_tile_ms'])}, K2 "
        f"{w['k2_ms']:.2f} ms = {share(w['k2_ms'])}), busy "
        + (f"{w['busy']:.1%}" if w["busy"] else "not measured"))
    for key, ms, cnt in w["top"]:
        log(f"  {key[:60]:60s} {ms:.3f} ms, {cnt:.0f} launches")


def phase_eval(name: str, smi: str, ckpt: str):
    """Phase 10: QuIP's evaluation stage at full width. Perplexity of the
    synthetic test stream (8 windows of 2048 tokens) through cli/eval.main
    for the dense bf16 source of phase 9's checkpoint (load_model with
    --weights random --seed 0, fused) and for the packed 2-bit checkpoint
    (--load); one window of each profiled; the packed window against the
    checkpoint unpacked to f32 with dense attention, the dense window with
    K2 against dense attention; then cli/zeroshot.main on the checkpoint
    (synthetic, piqa, arc_easy over synthetic docs, the byte tokenizer), a
    few of its requests against the unpacked model, and greedy_until on 4
    prompts through the Engine (K1-decode)."""
    from quip_tpu_torch.cli import zeroshot as ZCLI
    from quip_tpu_torch.eval.ppl import window_nll
    from quip_tpu_torch.eval.zeroshot.lm import ByteTokenizer, TorchLM
    from quip_tpu_torch.pack.model import unpack_model

    t_phase = time.time()
    base = ["llama-2-7b", "synthetic", "--nsamples", str(QUANT_NSAMPLES),
            "--seed", "0", "--device", "cuda"]
    rows = {}

    # --- perplexity: the dense bf16 source, then the packed checkpoint ----
    dense = _eval_cli(base + ["--weights", "random"], fuse=True)
    model, cfg = dense.pop("model"), dense.pop("cfg")
    stream, seqlen = dense.pop("stream"), dense.pop("seqlen")
    nwin = len(stream) // seqlen
    assert (nwin, seqlen) == (8, 2048), (nwin, seqlen)
    tk = torch.from_numpy(stream[:seqlen].astype(np.int64))[None].cuda()
    dense["window"] = _window(model, cfg, tk)
    with _env("QUIP_FLASH_PREFILL", "0"), torch.inference_mode():
        nll_dense_attn = float(window_nll(model, tk, cfg)[0])
    flash_d = abs(dense["window"]["nll"] - nll_dense_attn) / (seqlen - 1)
    del model
    torch.cuda.empty_cache()
    L = cfg.n_layers
    assert dense["counts"] == dict(k1_tile=0, k1_decode=0, k2=L * nwin,
                                   k3=0, k1p=0), dense["counts"]

    packed = _eval_cli(base + ["--load", ckpt])
    model = packed.pop("model")
    for k in ("cfg", "stream", "seqlen"):
        packed.pop(k)
    packed["window"] = _window(model, cfg, tk)
    assert packed["counts"] == dict(k1_tile=(4 * L + 1) * nwin, k1_decode=0,
                                    k2=L * nwin, k3=0, k1p=0), (
        packed["counts"])
    ref = unpack_model(model, torch.float32)
    del model
    torch.cuda.empty_cache()
    with _env("QUIP_FLASH_PREFILL", "0"), torch.inference_mode():
        nll_ref = float(window_nll(ref, tk, cfg)[0])
    packed_d = abs(packed["window"]["nll"] - nll_ref) / (seqlen - 1)
    for label, r in (("16-bit (dense bf16)", dense),
                     ("2-bit packed", packed)):
        r["tok_s"] = nwin * seqlen / r["s"]
        assert math.isfinite(r["ppl"]) and r["ppl"] > 1, (label, r["ppl"])
        _log_ppl_row(label, r, nwin, seqlen)
        rows[label] = r
    log(f"ppl window 0, mean nll a token: packed through the kernels "
        f"{packed['window']['nll'] / (seqlen - 1):.5f}, unpacked f32 with "
        f"dense attention {nll_ref / (seqlen - 1):.5f}: |diff| "
        f"{packed_d:.2e} <= {EVAL_NLL_TOL:.0e}; dense bf16 with K2 against "
        f"dense attention: |diff| {flash_d:.2e} <= {EVAL_FLASH_TOL:.0e}")
    assert packed_d <= EVAL_NLL_TOL, packed_d
    assert flash_d <= EVAL_FLASH_TOL, flash_d

    # --- zero-shot through cli/zeroshot.main -------------------------------
    box = {"reqs": [], "s": 0.0}
    make_lm = ZCLI.make_lm

    def making(params, cfg_, args):
        lm = make_lm(params, cfg_, args)
        score = lm.loglikelihood

        def counted(reqs):
            t = time.time()
            out = score(reqs)
            box["s"] += time.time() - t
            box["reqs"] += reqs
            return out

        lm.loglikelihood = counted
        box.update(lm=lm, score=score)
        return lm

    ZCLI.make_lm = making
    _zero_counts()
    t = time.time()
    try:
        res = ZCLI.main(["llama-2-7b", "--load", ckpt, "--tasks", EVAL_TASKS,
                         "--synthetic_docs", "--limit", "8", "--batch_size",
                         "4", "--device", "cuda"])
    finally:
        ZCLI.make_lm = make_lm
    torch.cuda.synchronize()
    zs = dict(s=time.time() - t, score_s=box["s"], counts=_read_counts(),
              requests=len(box["reqs"]), results=res["results"])
    zs["req_s"] = zs["requests"] / zs["score_s"]
    lm = box["lm"]
    assert isinstance(lm.tokenizer, ByteTokenizer), lm.tokenizer
    assert sorted(res["results"]) == sorted(EVAL_TASKS.split(",")), res
    assert zs["counts"]["k1_tile"] > 0, zs["counts"]
    # a few requests against the unpacked model (per continuation token)
    few = box["reqs"][:8]
    got = box["score"](few)
    want = TorchLM(ref, cfg, lm.tokenizer, batch_size=4).loglikelihood(few)
    per_tok = [abs(g[0] - w[0]) / len(lm.tok_encode(c))
               for g, w, (_, c) in zip(got, want, few)]
    zs["ll_err_per_token"] = per_tok
    del ref
    torch.cuda.empty_cache()

    prompts = ["The river ran past the mill", "Question: what is two and "
               "two?\nAnswer:", "Once upon a time", "abc def ghi"]
    _zero_counts()
    t = time.time()
    gen = lm.greedy_until([(p, ["\n\n"]) for p in prompts], max_gen_toks=16)
    torch.cuda.synchronize()
    zs.update(greedy_s=time.time() - t, greedy_counts=_read_counts(),
              greedy=gen)
    assert len(gen) == 4 and all(isinstance(g, str) for g in gen), gen
    assert zs["greedy_counts"]["k1_decode"] >= (4 * L + 1) * 15, zs[
        "greedy_counts"]
    log(f"zero-shot (cli/zeroshot, {EVAL_TASKS}, synthetic docs, limit 8, "
        f"batch 4, byte tokenizer): {zs['requests']} loglikelihood requests "
        f"scored in {zs['score_s']:.2f} s ({zs['req_s']:.1f} requests/s; "
        f"main {zs['s']:.1f} s with the checkpoint's load); launches K1-tile "
        f"{zs['counts']['k1_tile']}, K1-decode {zs['counts']['k1_decode']}, "
        f"K2 {zs['counts']['k2']}; results "
        + json.dumps({k: {m: round(v, 4) for m, v in r.items()}
                      for k, r in zs["results"].items()}))
    log(f"zero-shot requests against the unpacked f32 model: |diff ll| a "
        f"continuation token max {max(per_tok):.2e} <= {EVAL_LL_TOL:.0e} "
        f"({len(few)} requests)")
    assert max(per_tok) <= EVAL_LL_TOL, per_tok
    log(f"greedy_until, 4 prompts, 16 new tokens, through the Engine: "
        f"{zs['greedy_s']:.2f} s, launches K1-decode "
        f"{zs['greedy_counts']['k1_decode']}, K1-tile "
        f"{zs['greedy_counts']['k1_tile']}; {json.dumps(gen)}")
    phase_s = time.time() - t_phase
    log(f"phase 10: {phase_s:.1f} s; card: {smi}")
    launches = {k: rows["2-bit packed"]["counts"][k]
                + rows["16-bit (dense bf16)"]["counts"][k]
                + zs["counts"][k] + zs["greedy_counts"][k]
                for k in ("k1_tile", "k1_decode", "k2")}
    RESULTS["eval"] = dict(ppl=rows, nll_packed_vs_unpacked=packed_d,
                           nll_flash_vs_dense=flash_d, zeroshot=zs,
                           launches=launches, phase_s=phase_s)
    del lm, box
    torch.cuda.empty_cache()
    return RESULTS["eval"]


# Phase 16: the quantizer's options at full width. Llama-2-7B's published
# widths, cut to BF_LAYERS of 32 layers and BF_NSAMPLES calibration windows
# of 2048 tokens (the reference's 128) for the script's time limit.
BF_LAYERS = 2
BF_NSAMPLES = 8
BF_BUDGET_S = 200.0
# 16d's proxy methods: (name, CLI flags, its nearest baseline's flags)
BF_INCOH = ["--pre_gptqH", "--pre_rescale", "--pre_proj", "--qfn", "b"]
BF_METHODS = (
    ("ldlq", ["--quant", "ldlq"] + BF_INCOH),
    ("ldlqRG", ["--quant", "ldlqRG"] + BF_INCOH),
    ("allbal", ["--quant", "allbal", "--npasses", "1"] + BF_INCOH),
    ("ldlbal_admm", ["--quant", "ldlbal_admm"] + BF_INCOH),
    ("gptq_g128", ["--quant", "gptq", "--groupsize", "128", "--qfn", "a",
                   "--pre_gptqH", "--pre_rescale", "--pre_proj"]),
    ("trueobs", ["--quant", "trueobs"] + BF_INCOH),
)


@contextlib.contextmanager
def _cut_depth(n_layers: int):
    """The CLIs' presets cut to ``n_layers`` inside the block (the widths
    stay the published ones)."""
    from quip_tpu_torch.cli import common
    orig = common.get_config
    common.get_config = lambda name: dataclasses.replace(orig(name),
                                                         n_layers=n_layers)
    try:
        yield
    finally:
        common.get_config = orig


def _quiet_call(fn, *a, **kw):
    """fn(*a, **kw) with its stdout kept (and echoed): (result, text)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    text = buf.getvalue()
    return out, text


def _rot_bytes(block) -> int:
    """Bytes of a block's rotation buffers (RHT signs / factors / vin,
    butterfly blocks and permutations with their derived inverses)."""
    keys = ("_signs", "_left", "_right", "vin", "_block", "_perm_", "_inv_")
    return sum(b.numel() * b.element_size()
               for n, b in block.named_buffers()
               if any(k in n.rsplit(".", 1)[-1] for k in keys)
               and not n.endswith("scaleWH"))


def phase_butterfly(name: str, smi: str):
    """Phase 16: the quantizer's options on Llama-2-7B at its published
    widths (BF_LAYERS layers, bf16, random dense weights, fused).
    16a: cli/quantize.main with --pre_proj and no --proj_mode ('noblock'
    butterflies, as quip_tpu's CLI), ldlqRG, the head, --packed,
    --resume_dir and --trace, BF_NSAMPLES windows of 2048 tokens (K2 in
    the Hessian pass); the same command again resumes every layer and
    gives the same model. 16b: the checkpoint served by Engine.run
    (arena, then paged) on 4 greedy requests, each token held to a
    teacher-forced forward; a planted fault (U's butterfly un-transposed)
    reads above the limit. 16c: random-code models in 'rht', 'noblock'
    and 'block': rotation bytes a layer, b1 / b4 pump decode (ms, kernel
    ms, launches a step), the engine's tokens held as in 16b. 16d:
    cli/tools save-hessians, hsummary and proxy on layer 0's wo and wd
    for every rounder, each proxy loss below nearest's. 16e:
    quantize_model with host_offload against the same run on the card
    (codes equal, lower peak memory); 8-bit ActQuant wrappers around 16b's
    packed model, calibrated, through Engine.run, tokens held to the
    wrapped model's forward."""
    from quip_tpu_torch import analysis
    from quip_tpu_torch.cli import quantize as QCLI
    from quip_tpu_torch.cli import tools as TCLI
    from quip_tpu_torch.convert import params_from_numpy
    from quip_tpu_torch.core import incoherence as INC
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import model as TM
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.ops import actquant as AQ
    from quip_tpu_torch.ops import qlinear as QL
    from quip_tpu_torch.pack.model import load_checkpoint
    from quip_tpu_torch.quantize.config import QuantConfig
    from quip_tpu_torch.quantize.driver import quantize_model
    from quip_tpu_torch.serve.engine import Engine

    t_phase = time.time()
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=BF_LAYERS,
                              max_seq=2048, dtype="bfloat16")
    res: dict = dict(layers=BF_LAYERS, nsamples=BF_NSAMPLES)
    tmp = tempfile.mkdtemp(prefix="quip_bf_")
    D, R, T = (os.path.join(tmp, k) for k in ("ckpt", "resume", "trace"))
    try:
        # ---- 16a: quantize through the CLI, then resume ----------------
        argv = ["llama-2-7b", "synthetic", "--weights", "random", "--wbits",
                "2", "--quant", "ldlqRG", "--pre_gptqH", "--pre_rescale",
                "--pre_proj", "--qfn", "b", "--fuse", "--quant_head",
                "--packed", "--resume_dir", R, "--nsamples",
                str(BF_NSAMPLES), "--seqlen", "2048", "--chunk", "4",
                "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t = time.time()
        with _cut_depth(BF_LAYERS):
            (newp, art), _ = _quiet_call(
                QCLI.main, argv + ["--save", D, "--trace", T])
        torch.cuda.synchronize()
        quant_s = time.time() - t
        k2_calib = FA.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        traces = [f for f in os.listdir(T) if f.endswith(".json")]
        trace_mib = sum(os.path.getsize(os.path.join(T, f))
                        for f in traces) / 2 ** 20
        assert traces, "no trace file written"
        assert k2_calib > 0, "the Hessian pass did not run K2"
        st = art.results["layers.0.self_attn.qkv_proj"].preproc
        assert st.proj_mode == "noblock" and isinstance(st.U, INC.Butterfly)
        layer_s = [art.times[f"layers.{i}"] for i in range(BF_LAYERS)]
        t = time.time()
        with _cut_depth(BF_LAYERS):
            (again, art2), text2 = _quiet_call(
                QCLI.main, argv + ["--save", D + "2"])
        resume_s = time.time() - t
        assert text2.count("(resumed)") == BF_LAYERS, text2
        for a, b in zip(newp.blocks, again.blocks):
            sa, sb = a.state_dict(), b.state_dict()
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
        # quip_tpu's resume keeps no codes: the resumed layers are saved
        # dense, the head (quantized again) packed; its planes bit for bit
        t1, _ = load_checkpoint(D)
        t2, _ = load_checkpoint(D + "2")
        assert all(torch.equal(a, b) for a, b in zip(t1["lm_head"].planes,
                                                      t2["lm_head"].planes))
        del again, art2, newp, art, t1, t2
        shutil.rmtree(D + "2", ignore_errors=True)
        torch.cuda.empty_cache()
        res.update(quant_s=quant_s, layer_s=layer_s, resume_s=resume_s,
                   peak_gib=peak_gib, k2_calibration=k2_calib,
                   trace_files=len(traces), trace_mib=trace_mib)
        log(f"16a quantize (cli/quantize, --pre_proj -> noblock, ldlqRG, "
            f"{BF_LAYERS} of 32 layers, {BF_NSAMPLES} x 2048 windows): "
            f"{quant_s:.1f} s traced, a layer "
            + ", ".join(f"{s:.2f}" for s in layer_s)
            + f" s, peak {peak_gib:.1f} GiB, K2 {k2_calib} in calibration; "
            f"trace {len(traces)} file(s), {trace_mib:.0f} MiB; the same "
            f"command again: {resume_s:.1f} s, every layer resumed, blocks "
            f"and the head's planes equal bit for bit")
        tree, _ = load_checkpoint(D)
        packed = params_from_numpy(tree, cfg, device="cuda")
        del tree
        assert packed.blocks[0].mlp.wd.butterfly
        ratio = {}

        # ---- 16b: serve the butterfly checkpoint ----------------------
        rng = np.random.default_rng(16)
        reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                     max_new_tokens=16) for n in (600, 128, 37, 5)]
        kw = dict(max_batch=4, max_seq=1024, cache_dtype=torch.bfloat16,
                  device="cuda")
        with fused_rht(False):
            ar = _run_arena(Engine(packed, cfg, **kw), reqs, cfg)
            pg = _run_engine(Engine(packed, cfg, hot=32, page=64,
                                    paged=True, **kw), reqs, cfg)
        ex_ar = _spec_exactness(packed, cfg, reqs, ar["tokens"], None,
                                tol=SPEC_TOL[False])
        ex_pg = _spec_exactness(packed, cfg, reqs, pg["tokens"], None,
                                tol=SPEC_TOL[False])
        assert ar["k1_decode"] > 0 and ar["k1_tile"] > 0, ar
        assert pg["k1_decode"] > 0 and pg["k1_tile"] > 0 and pg["k2"] > 0
        orig = INC.apply_butterfly
        INC.apply_butterfly = lambda bf, x, axis=0, transpose=False: orig(
            bf, x, axis, False)               # U's side un-transposed
        try:
            with fused_rht(False):
                bad = _run_arena(Engine(packed, cfg, **kw), reqs, cfg)
        finally:
            INC.apply_butterfly = orig
        _, bad_gap = _spec_exactness(packed, cfg, reqs, bad["tokens"], None)
        assert bad_gap > SPEC_TOL[False], bad_gap
        res["serve"] = dict(arena=ar, paged=pg, exact_arena=ex_ar,
                            exact_paged=ex_pg, fault_gap=bad_gap)
        log(f"16b served the butterfly checkpoint: arena K1-decode "
            f"{ar['k1_decode']}, K1-tile {ar['k1_tile']}, K2 {ar['k2']}; "
            f"paged K1-decode {pg['k1_decode']}, K1-tile {pg['k1_tile']}, "
            f"K2 {pg['k2']}; teacher-forced: arena {ex_ar[0]:.1%} exact "
            f"(worst {ex_ar[1]:.2e}), paged {ex_pg[0]:.1%} (worst "
            f"{ex_pg[1]:.2e}) <= {SPEC_TOL[False]:.0e}; planted fault (U "
            f"un-transposed) reads {bad_gap:.2e}")

        # ---- 16e (ActQuant on 16b's model) ---------------------------
        calib_tok = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 256))).cuda()
        wrapped = AQ.calibrate_actquant(AQ.add_actquant(packed, cfg, 8), cfg,
                                        calib_tok)
        assert all(isinstance(b.mlp.wd, AQ.ActQuant)
                   and bool((b.mlp.wd.scale != 0).all())
                   for b in wrapped.blocks)
        with fused_rht(False):
            aq = _run_arena(Engine(wrapped, cfg, **kw), reqs, cfg)
        ex_aq = _spec_exactness(wrapped, cfg, reqs, aq["tokens"], None,
                                tol=SPEC_TOL[False])
        same = sum(a == b for x, y in zip(aq["tokens"], ar["tokens"])
                   for a, b in zip(x, y)) / sum(len(x) for x in ar["tokens"])
        res["actquant"] = dict(run=aq, exact=ex_aq, tokens_equal=same)
        log(f"16e ActQuant (8-bit, calibrated on 2 x 256 tokens) around "
            f"every packed linear: Engine.run {aq['run_s']:.2f} s, K1-decode "
            f"{aq['k1_decode']}, K1-tile {aq['k1_tile']}; teacher-forced "
            f"against the wrapped forward {ex_aq[0]:.1%} exact (worst "
            f"{ex_aq[1]:.2e}); {same:.1%} of the tokens as unwrapped")
        del wrapped, packed
        torch.cuda.empty_cache()

        # ---- 16c: rht / noblock / block at decode --------------------
        modes = {}
        for mode in ("rht", "noblock", "block"):
            model = packed_model(cfg, bits=2, seed=16, dtype=torch.bfloat16,
                                 head_bits=2, device="cuda", proj=mode)
            rb = _rot_bytes(model.blocks[0])
            with fused_rht(False):
                run = _run_arena(Engine(model, cfg, **kw), reqs, cfg)
                ex = _spec_exactness(model, cfg, reqs, run["tokens"], None,
                                     tol=SPEC_TOL[False])
                dec = {B: _pump_decode(model, cfg, rng, B=B, n_new=32,
                                       reps=1) for B in (1, 4)}
            modes[mode] = dict(rot_bytes_layer=rb, exact=ex, run=run,
                               decode={B: {k: d[k] for k in (
                                   "ms_per_step", "device_ms",
                                   "kernel_launches", "busy", "per_step")}
                                   for B, d in dec.items()})
            log(f"16c {mode}: rotation {rb / 1e6:.1f} MB a layer; b1 "
                f"{dec[1]['ms_per_step']:.2f} ms a step ({dec[1]['device_ms']:.2f}"
                f" ms kernels, {dec[1]['kernel_launches']:.0f} launches), b4 "
                f"{dec[4]['ms_per_step']:.2f} ms ({dec[4]['device_ms']:.2f} ms, "
                f"{dec[4]['kernel_launches']:.0f}); K1-decode a step "
                f"{dec[1]['per_step']['dm_decode']:.0f}; tokens "
                f"{ex[0]:.1%} exact (worst {ex[1]:.2e})")
            del model
            torch.cuda.empty_cache()
        res["modes"] = modes

        # ---- 16d: the tools and every rounder on layer 0 --------------
        Hp = os.path.join(tmp, "H.npz")
        t = time.time()
        with _cut_depth(BF_LAYERS):
            Hs, _ = _quiet_call(TCLI.main, [
                "save-hessians", "llama-2-7b", "synthetic", "--weights",
                "random", "--nsamples", str(BF_NSAMPLES), "--seqlen", "2048",
                "--chunk", "4", "--out", Hp, "--device", "cuda"])
        save_s = time.time() - t
        assert len(Hs) == 7 * BF_LAYERS
        H0 = os.path.join(tmp, "H0.npz")
        lin = ("layers.0.self_attn.o_proj", "layers.0.mlp.down_proj")
        analysis.save_hessians_npz(H0, {k: Hs[k] for k in lin})
        del Hs
        t = time.time()
        rows, _ = _quiet_call(TCLI.main, ["hsummary", "--hessians", H0,
                                          "--device", "cuda"])
        hsum_s = time.time() - t
        proxy = {}
        base = ["proxy", "llama-2-7b", "--weights", "random", "--hessians",
                H0, "--wbits", "2", "--layers", "0", "--device", "cuda"]
        with _cut_depth(BF_LAYERS):
            for label, flags in (("nearest", ["--quant", "nearest"]
                                  + BF_INCOH),
                                 ("nearest_a", ["--quant", "nearest",
                                                "--qfn", "a", "--pre_gptqH",
                                                "--pre_rescale",
                                                "--pre_proj"])) + BF_METHODS:
                names = ("self_attn.o_proj" if label == "ldlbal_admm" else
                         "self_attn.o_proj,mlp.down_proj")
                t = time.time()
                with watchdog(120, f"proxy {label}"):
                    out, _ = _quiet_call(TCLI.main, base + flags +
                                         ["--names", names])
                proxy[label] = dict(per_layer=out["per_layer"],
                                    s=time.time() - t)
        for label, _ in BF_METHODS:
            near = proxy["nearest_a" if label == "gptq_g128" else "nearest"]
            ratio[label] = {k: v / near["per_layer"][k]
                            for k, v in proxy[label]["per_layer"].items()}
        log("16d tools: save-hessians " + f"{save_s:.1f} s, hsummary "
            f"{hsum_s:.1f} s (" + "; ".join(
                f"{r[0].split('.', 2)[2]} tr(D)/tr(H) {r[1]:.3f} mu "
                f"{r[4]:.1f}" for r in rows) + "); proxy / nearest on layer "
            "0: " + "; ".join(
                f"{m} " + ", ".join(f"{k.split('.')[-1]} {v:.3f}"
                                    for k, v in r.items())
                + f" ({proxy[m]['s']:.1f} s)" for m, r in ratio.items()))
        assert all(v < 1 for r in ratio.values() for v in r.values()), ratio
        res.update(tools=dict(save_s=save_s, hsummary_s=hsum_s,
                              hsummary=rows, proxy=proxy, ratio=ratio))

        # ---- 16e: host offload ---------------------------------------
        gen = torch.Generator(device="cuda").manual_seed(5)
        host = TM.fuse_params(TM.init_params(gen, cfg, device="cuda"),
                              cfg).to("cpu")
        calib = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2048)))
        qc = QuantConfig.incoherence(2, "ldlq", proj_mode="noblock")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t = time.time()
        _, art_off = quantize_model(host, cfg, calib, qc, seed=3,
                                    host_offload=True, device="cuda",
                                    quant_head=True)
        off_s = time.time() - t
        peak_off = torch.cuda.max_memory_allocated() - base_mem
        ondev = copy.deepcopy(host).to("cuda")
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        _, art_on = quantize_model(ondev, cfg, calib.cuda(), qc, seed=3,
                                   quant_head=True)
        on_s = time.time() - t
        peak_on = torch.cuda.max_memory_allocated() - base_mem
        for k, r in art_on.results.items():
            assert torch.equal(r.codes.cpu(), art_off.results[k].codes), k
            assert art_off.results[k].codes.device.type == "cpu"
        assert peak_off < peak_on, (peak_off, peak_on)
        res["offload"] = dict(peak_gib_offload=peak_off / 2 ** 30,
                              peak_gib_on_card=peak_on / 2 ** 30,
                              s_offload=off_s, s_on_card=on_s)
        log(f"16e host offload: codes of {len(art_on.results)} linears equal "
            f"bit for bit; peak device memory {peak_off / 2 ** 30:.2f} GiB "
            f"offloaded vs {peak_on / 2 ** 30:.2f} GiB on the card; "
            f"{off_s:.1f} s vs {on_s:.1f} s")
        del host, ondev, art_on, art_off
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(f"phase 16: {res['phase_s']:.1f} s (budget {BF_BUDGET_S:.0f} s"
        + (", OVER" if res["phase_s"] > BF_BUDGET_S else "") + f"); card: "
        f"{smi}")
    RESULTS["butterfly"] = res
    return res


# ---------------------------------------------------------------------------
# Phase 17: parallelism (parallel/mesh.py, comm.py, pipeline.py,
# Engine(mesh=), cli/quantize --dp), ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# 17c / 17d depth: the first PAR_LAYERS of the full-width model's 32 blocks
# (a cut for the script's limit; the widths are the model's)
PAR_LAYERS = 8
PAR_NEW = 16                 # new tokens a request in 17b / 17c
PAR_BUDGET_S = 180.0
# 17a: K1 on a column shard against the unsharded call, f32 x: the same
# kernel sums the same fan-in for a column, but its plan (warps, fan-in
# splits) follows m_p, so the f32 sums may run in another order; the K1
# phase's kernel-against-plain limit, 1e-3 of max |y|, bounds that
SHARD_TOL = 1e-3
# 17d: GPipe logits against the unsharded forward on the same weights.
# Each micro-batch runs K1-tile on B/M x S rows, whose plan differs from
# the whole batch's: bf16 activations that round differently through 8
# layers. The limit is phase 11's full-depth bf16 one (5e-2 of max |logit|)
PP_TOL = 5e-2
# 17e: the --dp 2 Hessians, relative Frobenius. Layer 0's attention input
# is the normed embedding, the same rows in both runs: against --dp 1 only
# the f32 sum order differs (16384 rows summed in 2 shards, then
# all-reduced): 1e-5. Its other taps pass through bf16 matmuls at 4
# against 8 windows a call: 2e-2, the bf16 activations' rounding (a lost
# or doubled all-reduce reads 0.5 or 1). Layer 1 sees layer 0's quantized
# outputs, and LDLQ's error feedback lets a sum-order change in H flip
# codes, so --dp 1's layer 1 differs by more (read, not held); each of
# its Hessians is held instead, at 2e-2, to one
# calibration pass over all 8 windows through the --dp 2 run's own
# quantized layer 0 and the original layer 1 (driver.save_hessians)
DP_H_TOL = {"exact": 1e-5, "bf16": 2e-2}


def _llama_full(dev):
    """Phase 7's model: full-depth 2-bit Llama-2-7B, packed lm_head, seed 0
    (every rank builds the same one)."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    cfg = get_config("llama-2-7b")
    return packed_model(cfg, bits=2, seed=0, dtype=torch.bfloat16,
                        head_bits=2, device=dev), cfg


def _cut_model(model, cfg, n: int):
    """The first ``n`` blocks of ``model`` (its embedding and head)."""
    from quip_tpu_torch.models.model import Model
    c = dataclasses.replace(cfg, n_layers=n)
    return Model(c, model.embed, list(model.blocks)[:n], model.final_ln,
                 model.lm_head), c


def _mesh_run(eng, reqs) -> dict:
    """``eng.run(reqs)`` on a sharded engine, every kernel counter and
    collective counter set to 0 just before and read just after; each
    decode step synchronized and timed, with its collectives by kind."""
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.parallel import comm
    orig = PG.paged_decode_step
    steps = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        before = comm.counts()
        t = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = comm.counts()
        steps.append(dict(ms=ms, comm={
            k: {f: after[k][f] - before[k][f] for f in after[k]}
            for k in after if after[k]["count"] > before[k]["count"]}))
        return out

    PG.paged_decode_step = timed
    try:
        _zero_counts()
        comm.reset()
        t = time.time()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.time() - t
        counts, totals = _read_counts(), comm.counts()
    finally:
        PG.paged_decode_step = orig
    for r, q in zip(out, reqs):
        assert len(r.generated) == q["max_new_tokens"] + 1, r.uid
    return dict(tokens=[r.generated for r in out], run_s=run_s,
                counts=counts, comm={k: v for k, v in totals.items()
                                     if v["count"]},
                decode_steps=len(steps),
                ms_per_step=float(np.median([s["ms"] for s in steps])),
                comm_per_step=steps[len(steps) // 2]["comm"],
                mesh=eng.stats()["mesh"])


def _p17_pair(prompts):
    """Two ranks: 17b (tp = 2, full depth, serial Engine.run) and 17d
    (pp = 2 on PAR_LAYERS layers, pipelined_forward at M = 2 and 4).
    Rank 0 teacher-forces 17b's tokens through its unsharded model last
    (``tp2_exactness``)."""
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.models import model as M
    from quip_tpu_torch.parallel import comm
    from quip_tpu_torch.parallel import mesh as PM
    from quip_tpu_torch.parallel.pipeline import (pipeline_comm_bytes,
                                                  pipelined_forward)
    from quip_tpu_torch.serve.engine import Engine
    dev = torch.device("cuda", torch.cuda.current_device())
    t = time.time()
    model, cfg = _llama_full(dev)
    out = dict(build_s=time.time() - t)
    mesh = PM.make_mesh(dp=1, tp=2)
    reqs = [dict(prompt=prompts[n], max_new_tokens=PAR_NEW)
            for n in (600, 128, 37, 5)]
    with fused_rht(False):
        t = time.time()
        eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                     cache_dtype=torch.bfloat16, mesh=mesh)
        out["engine_s"] = time.time() - t
        out["tp2"] = _mesh_run(eng, reqs)
    del eng
    torch.cuda.empty_cache()
    m8, c8 = _cut_model(model, cfg, PAR_LAYERS)
    pmesh = PM.make_pp_mesh(2)
    stage = PM.shard_params_pp(m8, c8, pmesh)
    tokens = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (4, 512))).to(dev)
    with torch.inference_mode():
        want = M.forward(m8, tokens, c8).float()
    for mb in (2, 4):
        with torch.inference_mode():
            _zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rep = comm.comm_report(pipelined_forward,
                                   (stage, tokens, c8, pmesh, mb))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        got = rep.pop("result").float()
        err, rel = rel_err(got, want)
        model_bytes = pipeline_comm_bytes(c8, 4, 512, mb, 2)
        out[f"pp2_m{mb}"] = dict(
            ms=ms, max_abs_err=err, rel_err=rel,
            argmax_share=float((got.argmax(-1) == want.argmax(-1))
                               .float().mean()),
            k2=FA.launches, counts=_read_counts(),
            per_kind=rep["per_kind"],
            host_staged=sum(v["host_staged"]
                            for v in rep["per_kind"].values()),
            model=model_bytes, stage=pmesh.axis("pp").index)
    if mesh.rank == 0:
        with fused_rht(False):
            out["tp2_exactness"] = _spec_exactness(
                model, cfg, reqs, out["tp2"]["tokens"], None)
    return out


def _p17_quad(prompts):
    """Four ranks: 17c, dp = 2 x tp = 2 on a PAR_LAYERS-layer 2-bit
    Llama-2-7B (seed 0), int8 KV and the 200-token shared prefix, the
    serial Engine.run; rank 0 then teacher-forces the tokens through its
    unsharded model (``exactness``)."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.parallel import mesh as PM
    from quip_tpu_torch.serve.engine import Engine
    dev = torch.device("cuda", torch.cuda.current_device())
    c8 = dataclasses.replace(get_config("llama-2-7b"), n_layers=PAR_LAYERS)
    m8 = packed_model(c8, bits=2, seed=0, dtype=torch.bfloat16, head_bits=2,
                      device=dev)
    mesh = PM.make_mesh(dp=2, tp=2)
    reqs = _p17_prefix_reqs(prompts)
    with fused_rht(False):
        eng = Engine(m8, c8, max_batch=4, max_seq=1024, hot=32, page=64,
                     cache_dtype=torch.bfloat16, kv_quant=True,
                     shared_prefix=prompts[200], mesh=mesh)
        out = _mesh_run(eng, reqs)
        del eng
        if mesh.rank == 0:
            out["exactness"] = _spec_exactness(m8, c8, reqs, out["tokens"],
                                               prompts[200])
    return out


def _p17_prefix_reqs(prompts):
    return [dict(prompt=prompts[n], max_new_tokens=PAR_NEW)
            for n in (128, 37, 5)] + [dict(prompt=prompts[600],
                                           max_new_tokens=PAR_NEW,
                                           use_prefix=False)]


def _p17_quant(argv):
    """A rank of 17e: cli/quantize.main(argv) on PAR_QUANT_LAYERS layers;
    rank 0 keeps every Hessian."""
    import functools
    import torch.distributed as dist
    from quip_tpu_torch.cli import quantize as QCLI
    from quip_tpu_torch.quantize import driver as DRV
    orig = DRV.quantize_model
    DRV.quantize_model = functools.partial(orig, keep_hessians=True)
    try:
        with _cut_depth(PAR_QUANT_LAYERS):
            out = _quiet_call(QCLI.main, argv)
    finally:
        DRV.quantize_model = orig
    return out if not dist.is_initialized() or dist.get_rank() == 0 else None


PAR_QUANT_LAYERS = 2
PAR_QUANT_NSAMPLES = 8


def _p17_replay_hessians(argv, quant) -> dict:
    """Every layer's Hessians as ``quantize_model`` forms them, from one
    calibration pass over all the windows: layer l's inputs through
    ``quant``'s (quantized) layers < l, its taps through the original
    layer l (the CLI's random model, rebuilt from its seed). Keyed by the
    fused linears' names."""
    from quip_tpu_torch.cli import common
    from quip_tpu_torch.cli import quantize as QCLI
    from quip_tpu_torch.models import model as M
    from quip_tpu_torch.quantize.driver import save_hessians
    args = QCLI.build_parser().parse_args(argv)
    with _cut_depth(PAR_QUANT_LAYERS):
        dense, cfg = common.load_model(args)
        dense = M.fuse_params(dense, cfg)
        (calib, _), _ = common.get_data(args, cfg)
    tokens = torch.from_numpy(calib).to(args.device)
    out = {}
    by_tap = {s.tap: s.name for s in M.linear_specs(cfg)}
    for li in range(cfg.n_layers):
        hybrid = M.Model(cfg, dense.embed,
                         list(quant.blocks)[:li] + [dense.blocks[li]],
                         dense.final_ln, dense.lm_head)
        hybrid_cfg = dataclasses.replace(cfg, n_layers=li + 1)
        H = save_hessians(hybrid, hybrid_cfg, tokens, chunk=len(tokens))
        for spec in M.linear_specs(cfg, fused=True):
            out[f"layers.{li}.{spec.name}"] = H[
                f"layers.{li}.{by_tap[spec.tap]}"]
    return out


def _p17_shards(name: str) -> dict:
    """17a: K1 on the column shards of Llama-2-7B's four stacked linears
    (the rule of parallel/mesh.py::shard_packed) at tp = 2 and 4: the
    shards' outputs joined against the unsharded call, f32 x; each shard's
    ms (rank 0's shard, bf16 x) beside its bound and beside the whole
    call's, and at B = 1 and 600 beside torch.matmul of the dequantised
    bf16 shard (the library yardstick; 64 MB or more of copies cycled past
    the 50 MB L2)."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.pack.format import unpack_codes
    from quip_tpu_torch.parallel.comm import Axis
    from quip_tpu_torch.parallel.mesh import _part
    from quip_tpu_torch.utils.timing import time_ms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    scale = torch.tensor(0.02, device=dev)
    shapes = {k: LLAMA_SHAPES[k] for k in ("wqkv", "wo", "wgu", "wd")}
    sums: dict = {}
    worst = dict(decode=0.0, tile=0.0)
    worst_abs = dict(decode=0.0, tile=0.0)
    for sname, (m, d) in shapes.items():
        words = (d * 2 // 32, m)
        ncopy = max(1, math.ceil(120e6 / (words[0] * m * 4)))
        copies = [torch.randint(-2 ** 31, 2 ** 31, words, dtype=torch.int32,
                                generator=g, device=dev)
                  for _ in range(ncopy)]
        xs = {B: torch.randn(B, d, device=dev, generator=g).bfloat16()
              for B in (1, 2, 4, 8, 600)}
        whole, whole_ms = {}, {}
        for B, x in xs.items():
            whole[B] = DM.dequant_matmul(x.float(), (copies[0],), scale, None,
                                         bits=2)
            whole_ms[B] = time_ms([lambda c=c: DM.dequant_matmul(
                x, (c,), scale, None, bits=2) for c in copies],
                20 if B <= 128 else 5)
        for tp in (2, 4):
            axes = [Axis("tp", tp, r, tuple(range(tp))) for r in range(tp)]
            parts = [_part(copies[0], -1, a, sname) for a in axes]
            mp = m // tp
            shard_copies = [torch.randint(
                -2 ** 31, 2 ** 31, (words[0], mp), dtype=torch.int32,
                generator=g, device=dev) for _ in range(max(
                    1, math.ceil(120e6 / (words[0] * mp * 4))))]
            codes = unpack_codes((shard_copies[0],), 2, d).float()
            w = (((codes / 3) * 2 - 1) * scale).bfloat16()
            del codes
            dense = [w] + [w.clone() for _ in range(
                max(1, math.ceil(64e6 / w.numel() / 2) - 1))]
            for B, x in xs.items():
                path = DM.route(B, d, m, 2)
                assert DM.route(B, d, mp, 2) == path, (sname, tp, B)
                t0, d0 = DM.launches_tile, DM.launches_decode
                got = torch.cat([DM.dequant_matmul(x.float(), (p,), scale,
                                                   None, bits=2)
                                 for p in parts], dim=-1)
                took = (DM.launches_tile - t0, DM.launches_decode - d0)
                assert took == ((tp, 0) if path == "tile" else (0, tp)), took
                torch.cuda.synchronize()
                err, rel = rel_err(got, whole[B])
                assert rel <= SHARD_TOL, (sname, tp, B, rel)
                worst[path] = max(worst[path], rel)
                worst_abs[path] = max(worst_abs[path], err)
                ms = time_ms([lambda c=c: DM.dequant_matmul(
                    x, (c,), scale, None, bits=2) for c in shard_copies],
                    20 if B <= 128 else 5)
                bms, by = bound_ms(B * d * 2 + words[0] * mp * 4
                                   + B * mp * 2, 2 * B * d * mp, name)
                s = sums.setdefault((tp, B), dict(
                    ms=0.0, bound_ms=0.0, whole_ms=0.0, library_ms=0.0,
                    by=set(), path=path))
                s["ms"] += ms
                s["bound_ms"] += bms
                s["whole_ms"] += whole_ms[B]
                s["by"].add(by)
                lib = ""
                if B in (1, 600):
                    lms = time_ms([lambda v=v: torch.matmul(x, v.t())
                                   for v in dense], 20 if B <= 128 else 5)
                    s["library_ms"] += lms
                    lib = f"; torch.matmul of the bf16 shard {lms:.4f} ms"
                log(f"17a K1 {sname:5s} tp={tp} shard {mp}x{d} B={B:3d} "
                    f"[{path}]: {ms:.4f} ms (bound {bms:.4f} {by}, "
                    f"{bms / ms:.0%}); whole {m}x{d} {whole_ms[B]:.4f} ms; "
                    f"joined shards vs whole rel err {rel:.1e}{lib}")
            del shard_copies, dense, w
        del copies
        torch.cuda.empty_cache()
    out = {}
    for (tp, B), s in sorted(sums.items()):
        assert len(s["by"]) == 1, s
        kern = "k1_decode" if s["path"] == "decode" else "k1_tile"
        tag = f"tp{tp}_b{B}"
        out.setdefault(kern, {}).update({
            f"ms_{tag}": s["ms"], f"bound_ms_{tag}": s["bound_ms"],
            f"bound_by_{tag}": s["by"].pop(),
            f"whole_ms_{tag}": s["whole_ms"]})
        if B in (1, 600):
            out[kern][f"library_ms_{tag}"] = s["library_ms"]
        log(f"17a K1 sum of the four shards, tp={tp} B={B:3d} "
            f"[{s['path']}]: {s['ms']:.4f} ms a rank (bound "
            f"{s['bound_ms']:.4f}, {s['bound_ms'] / s['ms']:.0%}); the "
            f"whole calls {s['whole_ms']:.4f} ms"
            + (f"; torch.matmul of the dequantised bf16 shards "
               f"{s['library_ms']:.4f} ms" if B in (1, 600) else ""))
    out["k1_decode"]["max_rel_err_shards"] = worst["decode"]
    out["k1_tile"]["max_rel_err_shards"] = worst["tile"]
    out["k1_decode"]["max_abs_err_shards"] = worst_abs["decode"]
    out["k1_tile"]["max_abs_err_shards"] = worst_abs["tile"]
    return out


def phase_parallel(name: str, smi: str) -> dict:
    """Phase 17 (parallelism): 17a K1 on column shards; 17b tp = 2 at full
    depth, two ranks on the card over gloo, phase 7's four requests
    through the serial Engine(mesh=).run, each token held to the unsharded
    model's teacher-forced forward; 17c dp = 2 x tp = 2 on PAR_LAYERS
    layers with int8 KV and the 200-token prefix, held likewise; 17d pp =
    2, pipelined_forward at B = 4, S = 512, M = 2 and 4 against the
    unsharded forward, K2's launches, the host-staged bytes against
    pipeline_comm_bytes; 17e cli/quantize.main --dp 2 on PAR_QUANT_LAYERS
    layers and PAR_QUANT_NSAMPLES windows of 2048 tokens against --dp 1."""
    from quip_tpu_torch.parallel.mesh import run_ranks
    t_phase = time.time()
    res: dict = {"shards": _p17_shards(name)}
    res["shards_s"] = time.time() - t_phase

    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.tools.teacher_forced import serving_prompts
    cfg = get_config("llama-2-7b")
    prompts = serving_prompts(cfg.vocab_size)          # phase 7's
    ranks = dict(device="cuda", timeout_s=600, collective_timeout_s=300)

    # ---- 17b + 17d: two ranks ---------------------------------------------
    t = time.time()
    pair = run_ranks(_p17_pair, 2, (prompts,), **ranks)
    res["pair_s"] = time.time() - t
    tp2 = [p["tp2"] for p in pair]
    assert tp2[0]["tokens"] == tp2[1]["tokens"], "ranks disagree"
    share, gap = pair[0]["tp2_exactness"]
    assert gap <= SPEC_TOL[False], (gap, SPEC_TOL[False])
    per_step = tp2[0]["comm_per_step"]
    ag = per_step.get("all-gather", {})
    for r in tp2:
        c = r["counts"]
        assert c["k1_decode"] >= 129 * r["decode_steps"], c
        assert c["k1_tile"] >= 128 and c["k2"] >= 32, c
    # the design: 5 all-gathers over tp a layer, none for the head
    assert ag.get("count") == 5 * cfg.n_layers, per_step
    res["tp2"] = dict(exact_share=share, worst_gap=gap, ranks=tp2,
                      build_s=pair[0]["build_s"],
                      engine_s=pair[0]["engine_s"])
    log(f"17b tp=2, full depth (2 ranks, {tp2[0]['mesh']}): "
        f"{tp2[0]['decode_steps']} decode steps, {tp2[0]['ms_per_step']:.1f} "
        f"ms a step (rank 0), run {tp2[0]['run_s']:.1f} s; argmax of the "
        f"teacher-forced forward {share:.1%}, worst gap {gap:.2e} <= "
        f"{SPEC_TOL[False]}; launches by rank "
        + "; ".join(f"K1-decode {r['counts']['k1_decode']} K1-tile "
                    f"{r['counts']['k1_tile']} K2 {r['counts']['k2']}"
                    for r in tp2)
        + f"; a decode step's collectives {per_step}")

    for mb in (2, 4):
        rows = [p[f"pp2_m{mb}"] for p in pair]
        r0 = next(r for r in rows if r["stage"] == 0)
        r1 = next(r for r in rows if r["stage"] == 1)
        for r in rows:
            assert r["rel_err"] <= PP_TOL, (mb, r["rel_err"])
            assert r["k2"] == PAR_LAYERS // 2 * mb, (mb, r["k2"])
        hop = r0["model"]["hop_bytes"]
        # stage 0 copies each of its M sends to the host, stage 1 each of
        # its M receives back to the card: M hops of the model's M + pp - 1
        assert r0["host_staged"] == mb * hop, (r0["host_staged"], hop)
        assert r1["per_kind"]["recv"]["host_staged"] == mb * hop, r1
        res[f"pp2_m{mb}"] = rows
        log(f"17d pp=2 M={mb} ({PAR_LAYERS} layers, B=4 S=512): "
            f"{r0['ms']:.1f} ms; logits vs unsharded rel err "
            f"{r0['rel_err']:.2e} <= {PP_TOL}, argmax {r0['argmax_share']:.1%}"
            f"; K2 {r0['k2']} a rank; host-staged {r0['host_staged']} bytes "
            f"(stage 0) = {mb} hops of {hop:.0f}; the GPipe model's "
            f"{r0['model']['total_wire_bytes']:.0f} over "
            f"{r0['model']['ticks']} ticks")

    # ---- 17c: four ranks --------------------------------------------------
    t = time.time()
    quad = run_ranks(_p17_quad, 4, (prompts,), **ranks)
    res["quad_s"] = time.time() - t
    assert all(q["tokens"] == quad[0]["tokens"] for q in quad)
    share_c, gap_c = quad[0]["exactness"]
    assert gap_c <= SPEC_TOL[True], (gap_c, SPEC_TOL[True])
    per_c = quad[0]["comm_per_step"]
    # 5 all-gathers over tp a layer, and one of the hidden states over dp
    assert per_c["all-gather"]["count"] == 5 * PAR_LAYERS + 1, per_c
    res["dp2tp2"] = dict(exact_share=share_c, worst_gap=gap_c, ranks=quad)
    log(f"17c dp=2 x tp=2 ({PAR_LAYERS} layers, int8 KV, 200-token "
        f"prefix; 4 ranks): {quad[0]['decode_steps']} decode steps, "
        f"{quad[0]['ms_per_step']:.1f} ms a step (rank 0); argmax "
        f"{share_c:.1%}, worst gap {gap_c:.2e} <= {SPEC_TOL[True]}; "
        f"launches by rank "
        + "; ".join(f"K1-decode {q['counts']['k1_decode']} K1-tile "
                    f"{q['counts']['k1_tile']} K2 {q['counts']['k2']}"
                    for q in quad)
        + f"; a decode step's collectives {per_c}")

    # ---- 17e: cli/quantize --dp 2 against --dp 1 --------------------------
    argv = ["llama-2-7b", "synthetic", "--weights", "random", "--wbits",
            "2", "--quant", "ldlq", "--incoh_processing", "--fuse",
            "--nsamples", str(PAR_QUANT_NSAMPLES), "--seqlen", "2048",
            "--chunk", str(PAR_QUANT_NSAMPLES), "--device", "cuda"]
    t = time.time()
    (quant2, art2), _ = run_ranks(_p17_quant, 2, (argv + ["--dp", "2"],),
                                  rank0_here=True, **ranks)[0]
    dp2_s = time.time() - t
    t = time.time()
    (_, art1), _ = _p17_quant(argv)
    dp1_s = time.time() - t
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    # layer 0 against --dp 1; every layer against one pass through the
    # --dp 2 model's quantized earlier layers
    hres = {k: rel(art2.hessians[k], h1) for k, h1 in art1.hessians.items()}
    replay = _p17_replay_hessians(argv, quant2)
    hres_replay = {k: rel(art2.hessians[k], h) for k, h in replay.items()}
    worst_h = {
        "exact": max(v for k, v in hres.items()
                     if k.startswith("layers.0.self_attn.")),
        "bf16": max(v for k, v in hres.items() if k.startswith("layers.0.")
                    and not k.startswith("layers.0.self_attn.")),
        "replay": max(hres_replay.values()),
        "dp1_later": max(v for k, v in hres.items()
                         if not k.startswith("layers.0."))}
    agree = {k: float((art2.results[k].codes == r.codes).float().mean())
             for k, r in art1.results.items()}
    res["quant_dp2"] = dict(
        dp2_s=dp2_s, dp1_s=dp1_s, hessian_rel=hres,
        hessian_rel_replay=hres_replay, worst=worst_h, codes_agree=agree,
        s_a_layer_dp2=[art2.times[f"layers.{i}"]
                       for i in range(PAR_QUANT_LAYERS)],
        s_a_layer_dp1=[art1.times[f"layers.{i}"]
                       for i in range(PAR_QUANT_LAYERS)])
    log(f"17e cli/quantize --dp 2 ({PAR_QUANT_LAYERS} layers, "
        f"{PAR_QUANT_NSAMPLES} windows of 2048): {dp2_s:.1f} s (a layer "
        + ", ".join(f"{s:.2f}" for s in res["quant_dp2"]["s_a_layer_dp2"])
        + f" s) against --dp 1 {dp1_s:.1f} s (a layer "
        + ", ".join(f"{s:.2f}" for s in res["quant_dp2"]["s_a_layer_dp1"])
        + f" s); Hessians rel Frobenius against --dp 1: layer 0's "
        f"attention input {worst_h['exact']:.1e} <= {DP_H_TOL['exact']}, "
        f"its other taps {worst_h['bf16']:.1e} <= {DP_H_TOL['bf16']}, layer "
        f"1 {worst_h['dp1_later']:.1e} (read); every layer against one "
        f"pass through the --dp 2 model {worst_h['replay']:.1e} <= "
        f"{DP_H_TOL['bf16']}; codes agree with --dp 1 "
        f"{min(agree.values()):.2%}..{max(agree.values()):.2%}")
    assert worst_h["exact"] <= DP_H_TOL["exact"], hres
    assert worst_h["bf16"] <= DP_H_TOL["bf16"], hres
    assert worst_h["replay"] <= DP_H_TOL["bf16"], hres_replay
    del art1, art2, quant2
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(f"phase 17: {res['phase_s']:.1f} s (budget {PAR_BUDGET_S:.0f} s"
        + (", OVER" if res["phase_s"] > PAR_BUDGET_S else "")
        + f"); card: {smi}")
    RESULTS["parallel"] = res
    return res


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()
    t0 = time.time()
    clock, last = {}, [t0]

    def mark(phase):
        """Seconds since the last mark, by phase (RESULTS['phase_clock_s'])."""
        now = time.time()
        clock[phase] = now - last[0]
        last[0] = now

    name, smi = phase_device()
    mark("1 build")
    k1, k1t = phase_k1(name)
    mark("2 K1")
    k2_err, k2 = phase_k2(name)
    mark("3 K2")
    k3_err, k3 = phase_k3(name)
    mark("4 K3")
    with watchdog(600, "the K1' phase"):
        k1p_err, k1p = phase_k1p(name)
    mark("5 K1'")
    phase_slice()
    mark("6 slice")
    model, cfg, prompts, base, conf = phase_serve(name, smi)
    mark("7 serve")
    with watchdog(800, "the pump phase"):
        pump, dec = phase_pump(name, smi, model, cfg, prompts, base, conf)
    mark("8 pump")
    with watchdog(600, "the arena phase"):
        arena = phase_arena(name, smi, model, cfg, prompts, dec)
    mark("13 arena")
    # phase 11 serves the first SPEC_LAYERS of phase 7's blocks (a depth
    # cut for the script's limit; the widths are the model's)
    spec_cfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    from quip_tpu_torch.models.model import Model
    spec_model = Model(spec_cfg, model.embed, list(model.blocks)[
        :SPEC_LAYERS], model.final_ln, model.lm_head)
    with watchdog(900, "the speculative phase"):
        spec, _ = phase_spec(name, smi, spec_model, spec_cfg, prompts)
    mark("11 spec")
    del spec_model
    del model
    torch.cuda.empty_cache()
    with watchdog(600, "the families phase"):
        fam = phase_families(name, smi, dec)
    mark("12 families")
    with watchdog(400, "the 3-bit phase"):
        phase_3bit(name, smi)
    mark("14 3-bit")
    ckpt = tempfile.mkdtemp(prefix="quip_ckpt_")
    try:
        # phases 9, 10, 15 and 18 on QUANT_LAYERS of Llama-2-7B's 32 layers
        with _cut_depth(QUANT_LAYERS):
            quant = phase_quantize(name, smi, ckpt)
            mark("9 quantize")
            with watchdog(600, "the evaluation phase"):
                ev = phase_eval(name, smi, ckpt)
            mark("10 eval")
            with watchdog(400, "the bench CLI phase"):
                phase_bench(name, smi, ckpt)
            mark("15 bench")
            with watchdog(HOST_BUDGET_S + 240, "the host phase"):
                host = phase_host(name, smi, ckpt)
            mark("18 host")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    with watchdog(BF_BUDGET_S + 100, "the butterfly phase"):
        bf = phase_butterfly(name, smi)
    mark("16 butterfly")
    with watchdog(PAR_BUDGET_S + 240, "the parallel phase"):
        par = phase_parallel(name, smi)
    mark("17 parallel")
    # launches_tp2 / _dp2tp2 / _pp2: phase 17's ranks, each rank's count
    # from its sharded run (17b, 17c; 17d's pipelined_forward at M = 4)
    by_rank = lambda runs, k: [r["counts"][k] for r in runs]  # noqa: E731
    p_tp2, p_dp2 = par["tp2"]["ranks"], par["dp2tp2"]["ranks"]
    # launches_butterfly: phase 16b's Engine.run of the butterfly
    # checkpoint, arena then paged (K2 from the paged run's prefill and
    # 16a's calibration: the arena never runs K2)
    bf_ar, bf_pg = bf["serve"]["arena"], bf["serve"]["paged"]
    # launches: K1-decode, K1-tile and K2 from the first slice's Engine.run, K3
    # from the fused / int8 / prefix Engine.run, K1' from the
    # microbenchmark's path; launches_eval from phase 10's runs (both
    # perplexity passes, cli/zeroshot and greedy_until); launches_spec from
    # phase 11's spec pump with the 4-layer self-draft (un-fused, bf16 KV;
    # K3's fused, int8 KV, prefix), and K1′'s there (read, not assumed:
    # the path must not run it); launches_opt from phase 12's full-depth
    # OPT-6.7B Engine.run (un-fused: K3's is 0), K3's
    # launches_opt_slice_fused from its fused 2-layer check,
    # launches_bloom from its BLOOM-7b1 Engine.run (fused, int8, prefix);
    # launches_arena from phase 13's serial run on the slot arena
    # (un-fused, bf16; K3's fused, int8), read, K2's 0 included; K1's
    # *_w3_* / *_3bit_* from phase 2's 3-bit layouts (widened, two planes)
    # launches_transcode_check: phase 18b's packed forward of phase 7's
    # four prompts on phase 9's checkpoint (K1 and K2 of this slice's path)
    tc = host["transcode"]["counts"]
    spec_u, spec_f = spec["unfused_self4"], spec["fused_int8_prefix_self4"]
    ar_u, ar_f = arena["serial"], arena["fused_int8"]
    opt, bloom = fam["opt"]["serial"], fam["bloom"]["serial"]
    kernels = [
        dict(name="dequant_matmul_decode", route="cuda",
             source="quip_tpu_torch/kernels/csrc/dequant_matmul_decode.cu",
             replaces="quip_tpu/kernels/dequant_matmul.py:183",
             launches=base["k1_decode"],
             launches_fused_int8_prefix=conf["k1_decode"],
             launches_quantized_serve=quant["serve"]["k1_decode"],
             launches_pump=pump["unfused"]["k1_decode"],
             launches_per_token_pump=dec[(False, 1)]["pump"]["per_step"][
                 "dm_decode"],
             launches_eval=ev["launches"]["k1_decode"],
             launches_spec=spec_u["k1_decode"],
             launches_opt=opt["k1_decode"],
             launches_bloom=bloom["k1_decode"],
             launches_arena=ar_u["k1_decode"],
             launches_butterfly=bf_ar["k1_decode"] + bf_pg["k1_decode"],
             launches_tp2=by_rank(p_tp2, "k1_decode"),
             launches_dp2tp2=by_rank(p_dp2, "k1_decode"),
             launches_transcode_check=tc["k1_decode"],
             **par["shards"]["k1_decode"],
             max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"],
             max_rel_err=k1["max_rel_err"],
             launches_ragged_checks=k1["launches_ragged_checks"],
             **{k: v for k, v in k1.items()
                if k.endswith(("_b2", "_b4", "_b8", "_opt_b1"))
                or "_w3_" in k or "_3bit_" in k},
             ms_per_step_pump_b1=dec[(False, 1)]["pump"]["k1_decode_ms"],
             ms_per_step_pump_b4=dec[(False, 4)]["pump"]["k1_decode_ms"],
             ms_per_step_serial_b1=dec[(False, 1)]["serial"]["k1_decode_ms"],
             shape="sum over wqkv, wo, wgu, wd, lm_head at B=1 (_bB: B "
                   "rows); _opt: OPT-6.7B's wqkv, wo, fc1, fc2; _w3: 3-bit "
                   "codes widened to 4-bit fields, _3bit: as two planes; "
                   "_tpN_bB: phase 17a, the sum over wqkv, wo, wgu, wd of "
                   "one column shard at tp = N, B rows (whole_ms: the "
                   "unsharded calls; library_ms: torch.matmul of the "
                   "dequantised bf16 shards, B = 1 and 600); "
                   "ms_per_step_*: the device ms of its "
                   "launches in a profiled un-fused decode step (phase 8); "
                   "launches_ragged_checks: phase 2's launches of the "
                   "cp.async ring (m = 330)"),
        dict(name="dequant_matmul_tile", route="cuda",
             source="quip_tpu_torch/kernels/csrc/dequant_matmul_tile.cu",
             replaces="quip_tpu/kernels/dequant_matmul.py:183",
             launches=base["k1_tile"],
             launches_fused_int8_prefix=conf["k1_tile"],
             launches_quantized_serve=quant["serve"]["k1_tile"],
             launches_eval=ev["launches"]["k1_tile"],
             launches_spec=spec_u["k1_tile"],
             launches_opt=opt["k1_tile"], launches_bloom=bloom["k1_tile"],
             launches_arena=ar_u["k1_tile"],
             launches_butterfly=bf_ar["k1_tile"] + bf_pg["k1_tile"],
             launches_tp2=by_rank(p_tp2, "k1_tile"),
             launches_dp2tp2=by_rank(p_dp2, "k1_tile"),
             launches_pp2=by_rank(par["pp2_m4"], "k1_tile"),
             launches_transcode_check=tc["k1_tile"],
             **par["shards"]["k1_tile"],
             max_abs_err=k1t["max_abs_err"],
             ms=k1t["ms"], plain_ms=k1t["plain_ms"],
             bound_ms=k1t["bound_ms"], bound_by=k1t["bound_by"],
             library_ms=k1t["library_ms"], max_rel_err=k1t["max_rel_err"],
             ms_b2048=k1t["ms_b2048"], plain_ms_b2048=k1t["plain_ms_b2048"],
             bound_ms_b2048=k1t["bound_ms_b2048"],
             bound_by_b2048=k1t["bound_by_b2048"],
             library_ms_b2048=k1t["library_ms_b2048"],
             **{f"{k}_opt_b{B}": k1t[f"{k}_opt_b{B}"] for B in (600, 2048)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             **{k: v for k, v in k1t.items() if k.endswith(("_b16", "_b32"))},
             **{k: v for k, v in k1t.items()
                if "_w3_" in k or "_3bit_" in k},
             shape="sum over wqkv, wo, wgu, wd, lm_head at B=600 (and "
                   "B=2048, a perplexity window's rows; B=16 and 32 too); "
                   "_opt: OPT-6.7B's "
                   "wqkv, wo, fc1, fc2; _w3 / _3bit: phase 2's 3-bit "
                   "layouts at B=600; _tpN_b600: phase 17a's column "
                   "shards, as K1-decode's"),
        dict(name="flash_prefill", route="cuda",
             source="quip_tpu_torch/kernels/csrc/flash_attn.cu",
             replaces="quip_tpu/kernels/flash_attn.py:87",
             launches=base["k2"], launches_fused_int8_prefix=conf["k2"],
             launches_calibration=quant["k2_calibration"],
             launches_quantized_serve=quant["serve"]["k2"],
             launches_eval=ev["launches"]["k2"],
             launches_spec=spec_u["k2"],
             launches_opt=opt["k2"], launches_arena=ar_u["k2"],
             launches_butterfly=bf_pg["k2"],
             launches_butterfly_calibration=bf["k2_calibration"],
             launches_tp2=by_rank(p_tp2, "k2"),
             launches_dp2tp2=by_rank(p_dp2, "k2"),
             launches_pp2=[r["k2"] for r in par["pp2_m4"]],
             launches_transcode_check=tc["k2"],
             max_abs_err=k2_err, max_row_rel_err=k2["max_row_rel_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2["library_ms"],
             **{f"{key}_b{r['B']}_h{r['H']}_kv{r['KV']}_s{r['S']}": r[key]
                for r in RESULTS["k2"][1:]
                for key in ("ms", "bound_ms", "library_ms", "causal_ms")},
             ms_prefill600=RESULTS["serve"]["k2_prefill_ms"],
             ms_eval_window=ev["ppl"]["2-bit packed"]["window"]["k2_ms"],
             ms_eval_window_dense=ev["ppl"]["16-bit (dense bf16)"][
                 "window"]["k2_ms"],
             shape="B=2 H=32 S=600 plen=[600,431] (the others by "
                   "_bB_hH_kvKV_sS; library_ms: SDPA with the mask, "
                   "causal_ms: SDPA is_causal where plen is S; "
                   "ms_prefill600: the 32 launches of phase 7's profiled "
                   "prefill; ms_eval_window: phase 10's profiled window, "
                   "L launches)"),
        dict(name="rht_apply_fused", route="cuda",
             source="quip_tpu_torch/kernels/csrc/rht.cu",
             replaces="quip_tpu/kernels/rht.py:87",
             launches=conf["k3"], max_abs_err=k3_err,
             launches_spec=spec_f["k3"],
             launches_opt=opt["k3"],
             launches_opt_slice_fused=fam["slice_opt-6.7b"]["counts"]["k3"],
             launches_bloom=bloom["k3"], launches_arena=ar_f["k3"],
             launches_pump=pump["fused_int8_prefix"]["k3"],
             launches_per_token_pump=dec[(True, 1)]["pump"]["per_step"][
                 "rht_mma"],
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             max_rel_err_bf16=k3["max_rel_err_bf16"],
             max_rel_err_f32=k3["max_rel_err_f32"],
             empty_kernel_ms=k3["empty_ms"],
             empty_kernel_in_graph_ms=k3["empty_in_graph_ms"],
             **{k: v for k, v in k3.items() if k == "by_B"},
             chain=k3["chain"],
             ms_per_step_pump_b1=dec[(True, 1)]["pump"]["k3_ms"],
             ms_per_step_pump_b4=dec[(True, 4)]["pump"]["k3_ms"],
             ms_per_step_serial_b1=dec[(True, 1)]["serial"]["k3_ms"],
             idle_ms_per_step_pump_b1=dec[(True, 1)]["pump"]["idle_ms"],
             idle_ms_per_step_pump_b4=dec[(True, 4)]["pump"]["idle_ms"],
             own_ms_per_step_pump_b1=dec[(True, 1)]["pump"]["k3_own_ms"],
             own_ms_per_step_pump_b4=dec[(True, 4)]["pump"]["k3_own_ms"],
             **{f"{k}_{w}_b1": k3[f"{k}_{w}_b1"] for w in ("opt", "n16384")
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by_opt_b1=k3["bound_by_opt_b1"],
             shape="sum over the six (n, direction) pairs of a b1 decode "
                   "step: 4096 fwd/T, 11008 fwd, 12288 T, 22016 T, 32000 T; "
                   "_opt: OPT-6.7B's five, 4096 fwd/T, 12288 T, 16384 "
                   "fwd/T; _n16384: 16384 fwd + T; bf16; by_B: the six "
                   "at B = 1, 2, 8, 32; chain: a Llama-2-7B layer's four "
                   "fused linears in one graph, with and without PDL, "
                   "and un-fused; ms_per_step_*: its launches' summed "
                   "device spans in a profiled fused decode step (phase "
                   "8), own_ms_*: the time K3 alone covers there, "
                   "idle_ms_*: the step's ms less the time some kernel "
                   "covers"),
        dict(name="slabdot_matmul", route="cuda",
             source="quip_tpu_torch/kernels/csrc/slabdot_matmul.cu",
             replaces="scripts/bench_kernel.py:69",
             launches=k1p["launches"], max_abs_err=k1p_err,
             launches_spec=spec_u["k1p"], launches_arena=ar_u["k1p"],
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
    RESULTS["phase_clock_s"] = clock
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in clock.items()))
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
