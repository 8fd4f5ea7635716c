"""On-card smoke test of the PyTorch/CUDA port (quip_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, sm_90a) and nvcc. It builds the
port's kernels from ``quip_tpu_torch/kernels/csrc`` and runs, in order:

  1. the card's name and power limit, and the kernel build (both nvcc runs
     started together);
  2. K1 (dequant_matmul) against its plain version at the five 2-bit
     Llama-2-7B projection shapes (B = 1, 8, 32, 600) and at small 3/4/8-bit,
     qfn-a and code_bits=3 shapes, with kernel, plain, bound and library
     (torch.matmul of the dequantised bf16 weight) times;
  3. K2 (flash_prefill) against its plain version (B=2, H=32, S=600,
     plen=[600, 431]; GQA H=64, KV=8), with SDPA as the library yardstick;
  4. a 2-layer full-width packed Llama-2-7B: 600-token prefill + 4
     teacher-forced decode steps on the card vs the plain path on the CPU
     in f32 on the same weights;
  5. full-depth 2-bit Llama-2-7B with a packed lm_head served through
     ``Engine.run`` (4 greedy requests, prompts 600/128/37/5, 40 new tokens
     each); the kernels' launch counters are zeroed just before and read
     just after; then prefill and decode timings at b1 and b4.

Every phase asserts; any failure exits nonzero. The line before the last
is the kernels' JSON record, the last line ``{"ok": true, "device": ...}``.
``--out DIR`` also writes every measurement to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

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

# device memory rate (B/s) and dense bf16 tensor rate (FLOP/s) by card
# (NVIDIA data sheets; SXM unless the name says PCIe)
_PEAKS = {"pcie": (2.0e12, 756e12), "sxm": (3.35e12, 989e12)}

RESULTS: dict = {}


def log(*a):
    print(*a, flush=True)


def peaks(name: str):
    return _PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def bound_ms(nbytes: float, ops: float, name: str):
    bw, fl = peaks(name)
    tb, to = nbytes / bw, ops / fl
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(fns, iters: int) -> float:
    """Device ms per call: one CUDA graph holds one call of each of ``fns``
    (cycling through copies keeps the working set past the 50 MB L2 where
    the real caller finds it cold) and is replayed ``iters`` times between
    two events. The graph takes the host's launch cost out: a wrapper's
    Python and ctypes work outlasts a decode-size kernel on this host."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (iters * len(fns))
    del graph
    return ms


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
    logs = _build.build_all(["dequant_matmul", "flash_attn"])
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


def phase_k1(name: str):
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.pack.format import PLANE_SPLITS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def planes_for(m, d, bits):
        return tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                   dtype=torch.int32, generator=g,
                                   device=dev)
                     for fb, _ in PLANE_SPLITS[bits])

    worst = worst_rel = 0.0
    # correctness, small widths / other formats: f32 input holding bf16
    # values, so kernel and plain see the same x and differ only in the
    # summation order (tolerance 1e-3 of max |y|)
    for bits, qfn, code_bits in [(2, "b", None), (3, "b", None),
                                 (4, "b", None), (8, "b", None),
                                 (4, "b", 3), (2, "a", None),
                                 (4, "a", None)]:
        m, d = 640, 1024
        pl = planes_for(m, d, bits)
        if code_bits:       # 3-bit codes in 4-bit fields: clear bit 3s
            pl = tuple(p & 0x77777777 for p in pl)
        scale = torch.tensor(0.02, device=dev)
        zero = None
        if qfn == "a":
            scale = torch.rand(m, device=dev, generator=g) * 0.05 + 0.01
            zero = torch.rand(m, device=dev, generator=g) * 2 ** bits
        for B in (1, 5, 33):
            x = torch.randn(B, d, device=dev, generator=g).bfloat16().float()
            got = DM.dequant_matmul(x, pl, scale, zero, bits=bits, qfn=qfn,
                                    code_bits=code_bits)
            want = DM.dequant_matmul_ref(x, pl, scale, zero, bits=bits,
                                         qfn=qfn, code_bits=code_bits)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            assert rel <= 1e-3, (bits, qfn, code_bits, B, rel)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
    log(f"K1 small formats (2/3/4/8-bit, qfn a/b, code_bits=3): "
        f"max rel err {worst_rel:.2e} <= 1e-3")

    shapes = {"wqkv": (12288, 4096), "wo": (4096, 4096),
              "wgu": (22528, 4096), "wd": (4096, 11008),
              "lm_head": (32000, 4096)}
    rows = []
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    scale = torch.tensor(0.02, device=dev)
    for sname, (m, d) in shapes.items():
        pbytes = d * 2 * m // 8
        ncopy = max(1, math.ceil(120e6 / pbytes))
        copies = [planes_for(m, d, 2) for _ in range(ncopy)]
        W = DM.dequant_weight(copies[0], scale, None, bits=2,
                              d=d).to(torch.bfloat16)
        for B in (1, 8, 32, 600):
            x = torch.randn(B, d, device=dev, generator=g).bfloat16()
            # check: f32 x with bf16 values (1e-3), then the bf16 path
            xf = x.float()
            got = DM.dequant_matmul(xf, copies[0], scale, None, bits=2)
            want = DM.dequant_matmul_ref(xf, copies[0], scale, None, bits=2)
            err, rel = rel_err(got, want)
            assert rel <= 1e-3, (sname, B, rel)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            got16 = DM.dequant_matmul(x, copies[0], scale, None, bits=2)
            _, rel16 = rel_err(got16, want)
            assert rel16 <= 1e-2, (sname, B, "bf16 out", rel16)
            it = 20 if B <= 32 else 3
            ms = time_ms([lambda c=c: DM.dequant_matmul(x, c, scale, None,
                                                        bits=2)
                          for c in copies], it)
            plain = time_ms([lambda: DM.dequant_matmul_ref(
                x, copies[0], scale, None, bits=2)], 2)
            lib = time_ms([lambda: torch.matmul(x, W.t())], 20)
            bms, by = bound_ms(B * d * 2 + pbytes + B * m * 2,
                               2 * B * d * m, name)
            rows.append(dict(shape=sname, m=m, d=d, B=B, ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=bms,
                             bound_by=by, rel_err=rel, rel_err_bf16=rel16))
            log(f"K1 {sname:8s} {m}x{d} B={B:4d}: {ms:.4f} ms "
                f"(bound {bms:.4f} {by}, {bms / ms:.0%}), plain "
                f"{plain:.3f} ms, torch.matmul bf16 {lib:.4f} ms, "
                f"rel err {rel:.1e} / bf16 out {rel16:.1e}")
            if B == 1:
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms), ("library_ms", lib)):
                    sums[k] += v
        del copies, W
        torch.cuda.empty_cache()
    RESULTS["k1"] = rows
    sums["max_rel_err"] = worst_rel
    return worst, sums


def phase_k2(name: str):
    from quip_tpu_torch.kernels import flash_attn as FA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    rec = None
    for B, H, KV, S, plen in [(2, 32, 32, 600, [600, 431]),
                              (2, 64, 8, 600, [600, 431]),
                              (1, 32, 32, 1000, [1000])]:
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
    return worst, rec


def _to_cpu_f32(model):
    cpu = copy.deepcopy(model).to("cpu")
    for mod in cpu.modules():
        for n, b in list(mod.named_buffers(recurse=False)):
            if b is not None and b.is_floating_point():
                setattr(mod, n, b.float())
    return cpu


def phase_slice():
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.models.build import packed_llama
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA

    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_llama(cfg, bits=2, seed=3, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    ref = _to_cpu_f32(model)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 600)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4,)))

    def drive(params, dev, dtype):
        kv = PG.init_paged(1, 1024 + 32, cfg, dtype=dtype, hot=32, page=64,
                           device=dev)
        lg, kv = PG.paged_prefill_slot(params, prompt.to(dev), 600, kv, 0,
                                       cfg)
        out = [lg.float().cpu()]
        for t in steps:
            lg, hot = PG.paged_decode_step(params, t.view(1, 1).to(dev), kv,
                                           cfg, page=64)
            kv = PG.advance(kv, hot)
            out.append(lg[0].float().cpu())
        return torch.stack(out)

    k1, k2 = DM.launches, FA.launches
    got = drive(model, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    assert FA.launches - k2 == cfg.n_layers, "prefill did not run K2"
    assert DM.launches > k1
    want = drive(ref, "cpu", torch.float32)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / want.abs().max().item()
    log(f"slice check (2 layers, full width, 600-token prefill + 4 decode "
        f"steps, card bf16 vs CPU f32 plain): normalised max err "
        f"{err:.2e} <= 3e-2")
    assert err <= 3e-2, err
    RESULTS["slice_err"] = err
    del model, ref
    torch.cuda.empty_cache()


def phase_serve(name: str, smi: str):
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models import paged as PG
    from quip_tpu_torch.models.build import packed_llama
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.kernels import flash_attn as FA
    from quip_tpu_torch.serve.engine import Engine

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama-2-7b")
    t = time.time()
    model = packed_llama(cfg, bits=2, seed=0, dtype=torch.bfloat16,
                         head_bits=2, device="cuda")
    torch.cuda.synchronize()
    log(f"built 32-layer 2-bit Llama-2-7B (packed lm_head) in "
        f"{time.time() - t:.1f} s")
    eng = Engine(model, cfg, max_batch=4, max_seq=1024, hot=32, page=64,
                 cache_dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=40) for n in (600, 128, 37, 5)]

    finite = torch.ones((), dtype=torch.bool, device="cuda")
    orig_dec, orig_pre = PG.paged_decode_step, PG.paged_prefill_slot
    steps = [0]

    def dec(*a, **kw):
        lg, hot = orig_dec(*a, **kw)
        finite.logical_and_(torch.isfinite(lg).all())
        steps[0] += 1
        return lg, hot

    def pre(*a, **kw):
        lg, kv = orig_pre(*a, **kw)
        finite.logical_and_(torch.isfinite(lg).all())
        return lg, kv

    PG.paged_decode_step, PG.paged_prefill_slot = dec, pre
    DM.launches = 0
    FA.launches = 0
    t = time.time()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.time() - t
    k1, k2 = DM.launches, FA.launches
    PG.paged_decode_step, PG.paged_prefill_slot = orig_dec, orig_pre
    n_dec = steps[0]
    log(f"Engine.run: 4 requests in {run_s:.2f} s, {n_dec} decode steps, "
        f"K1 launches {k1}, K2 launches {k2}")
    for r in out:
        assert len(r.generated) == 41, (r.uid, len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert bool(finite), "NaN/inf logits"
    assert k1 >= 129 * n_dec, (k1, n_dec)
    assert k2 >= 32, k2
    RESULTS["serve"] = dict(run_s=run_s, decode_steps=n_dec, k1=k1, k2=k2)

    # prefill of the 600-token prompt
    p600 = torch.tensor(reqs[0]["prompt"], device="cuda")[None]
    kv = eng._sync_pkv()
    pre_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        PG.paged_prefill_slot(eng.params, p600, 600, kv, 0, cfg)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t) * 1e3)
    prefill_ms = min(pre_ms)

    decode = {}
    for b in (1, 4):
        e = Engine(model, cfg, max_batch=b, max_seq=1024, hot=32, page=64,
                   cache_dtype=torch.bfloat16, device="cuda")
        for _ in range(b):
            e.submit(rng.integers(0, cfg.vocab_size, 37).tolist(),
                     max_new_tokens=100)
        e.step()                     # admissions + first decode
        n = 48                       # crosses a hot-ring flush
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            e.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / n
        decode[b] = dict(ms_per_step=ms, tok_s=b * 1e3 / ms)
        del e
    # device time of b1 decode steps, by kernel (torch.profiler, CUPTI);
    # busy share = device ms per step over the unprofiled step time above
    e = Engine(model, cfg, max_batch=1, max_seq=1024, hot=32, page=64,
               cache_dtype=torch.bfloat16, device="cuda")
    e.submit(rng.integers(0, cfg.vocab_size, 37).tolist(), max_new_tokens=60)
    e.step()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    n_prof = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            e.step()
        torch.cuda.synchronize()
    dev_t = lambda x: getattr(x, "self_device_time_total",  # noqa: E731
                              getattr(x, "self_cuda_time_total", 0))
    kern = [x for x in prof.key_averages() if x.device_type == DeviceType.CUDA]
    dev_ms = sum(dev_t(x) for x in kern) / 1e3 / n_prof
    launches = sum(x.count for x in kern) / n_prof
    aten = sum(x.count for x in prof.key_averages()
               if x.key.startswith("aten::")) / n_prof
    busy = dev_ms / decode[1]["ms_per_step"] if dev_ms else None
    top = sorted(kern, key=dev_t, reverse=True)[:6]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"prefill 600 tokens: {prefill_ms:.1f} ms "
        f"({600 / prefill_ms * 1e3:.0f} tok/s)")
    for b, d in decode.items():
        log(f"decode b{b}: {d['ms_per_step']:.2f} ms/step, "
            f"{d['tok_s']:.1f} tok/s")
    log(f"b1 decode, profiled: {dev_ms:.2f} ms of kernels per step "
        f"({launches:.0f} kernel launches, {aten:.0f} aten ops); device "
        f"busy share " + (f"{busy:.1%}" if busy else "not measured"))
    for x in top:
        log(f"  {x.key[:60]:60s} {dev_t(x) / n_prof / 1e3:.3f} ms/step, "
            f"{x.count / n_prof:.0f} launches/step")
    log(f"peak device memory: {peak:.2f} GiB; card: {smi}")
    RESULTS["serve"].update(prefill_ms=prefill_ms, decode=decode,
                            b1_device_ms=dev_ms, b1_kernel_launches=launches,
                            b1_aten_ops=aten, b1_busy=busy, peak_gib=peak,
                            b1_top=[(x.key, dev_t(x) / n_prof / 1e3,
                                     x.count / n_prof) for x in top])
    return k1, k2, n_dec


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()
    t0 = time.time()
    name, smi = phase_device()
    k1_err, k1 = phase_k1(name)
    k2_err, k2 = phase_k2(name)
    phase_slice()
    l1, l2, n_dec = phase_serve(name, smi)
    kernels = [
        dict(name="dequant_matmul", route="cuda",
             source="quip_tpu_torch/kernels/csrc/dequant_matmul.cu",
             replaces="quip_tpu/kernels/dequant_matmul.py:183",
             launches=l1, max_abs_err=k1_err,
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by="bytes", library_ms=k1["library_ms"],
             max_rel_err=k1["max_rel_err"],
             shape="sum over wqkv, wo, wgu, wd, lm_head at B=1"),
        dict(name="flash_prefill", route="cuda",
             source="quip_tpu_torch/kernels/csrc/flash_attn.cu",
             replaces="quip_tpu/kernels/flash_attn.py:87",
             launches=l2, max_abs_err=k2_err,
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2["library_ms"],
             shape="B=2 H=32 S=600 plen=[600,431]"),
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
