"""What binds K1-tile, and which block plan is fastest (run on the H100):

    python -m quip_tpu_torch.tools.tune_tile

Part 1, ablation: ``csrc/dequant_matmul_tile.cu`` is compiled as it is and
in copies with one part taken out (their results are wrong, only their
times mean something): the exact bf16 subtraction, the whole unpack (raw
words as operands), the x copies after a block's first stage, both, and
the products themselves. Each is timed at three of the 2-bit Llama-2-7B
shapes, 600 and 32 rows, through the wrapper (CUDA-graph replay, plane
copies cycling past the L2).

Part 2, plans: ``_tile_plan``'s choice (rows per block, warps, fan-in
splits) against its neighbours at the five shapes, B = 600, 128, 32, 16.
Every plan's result is held against the plain version first.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import tempfile
from pathlib import Path

import torch

from quip_tpu_torch.kernels import _build
from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.utils.timing import time_ms

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22528, 4096),
          "wd": (4096, 11008), "lm_head": (32000, 4096)}
PLANS = {600: [(64, 8, 1), (64, 4, 1), (64, 8, 2)],
         128: [(64, 8, 1), (64, 4, 1), (64, 4, 2), (64, 8, 2), (64, 4, 4)],
         32: [(32, 4, 2), (32, 4, 4), (32, 4, 8), (32, 8, 1), (32, 8, 2)],
         16: [(16, 4, 2), (16, 4, 4), (16, 4, 8), (16, 8, 2)]}


def _rep(src: str, old: str, new: str) -> str:
    assert old in src, old
    return src.replace(old, new)


def variants(src: str) -> dict:
    no_unpack = _rep(_rep(src, "bf[q][0] = code_pair<MP>(w[r][0][q], sh);",
                          "bf[q][0] = w[r][0][q];"),
                     "bf[q][1] = code_pair<MP>(w[r][1][q], sh);",
                     "bf[q][1] = w[r][1][q];")
    first_x = lambda s: _rep(  # noqa: E731
        s, "    for (int e = tid; e < BM * 16; e += NT) {",
        "    if (s == s_begin) for (int e = tid; e < BM * 16; e += NT) {")
    return {
        "as it is": src,
        "no subtraction": _rep(src, "  const uint32_t magic = 0x43004300u;\n",
                               "  return v;\n"
                               "  const uint32_t magic = 0x43004300u;\n"),
        "no unpack": no_unpack,
        "x copied in the first stage only": first_x(src),
        "no unpack, x in the first stage only": first_x(no_unpack),
        "no products": _rep(
            src, '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
            '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"',
            '"// %0 %1 %2 %3 %4 %5 %6 %7 %8 %9\\n"'),
    }


def _planes(m, d, gen, dev):
    n = max(1, math.ceil(120e6 / (d * 2 * m // 8)))
    return [(torch.randint(-2 ** 31, 2 ** 31, (d * 2 // 32, m),
                           dtype=torch.int32, generator=gen, device=dev),)
            for _ in range(n)]


def _time(x, copies, scale):
    return time_ms([lambda c=c: DM.dequant_matmul(x, c, scale, None, bits=2)
                    for c in copies], 10)


def ablate(gen, dev, scale):
    src = (Path(_build.__file__).parent / "csrc"
           / "dequant_matmul_tile.cu").read_text()
    DM._entry_tile()
    genuine, argtypes = DM._fn_tile, DM._fn_tile.argtypes
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for i, (name, text) in enumerate(variants(src).items()):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build.nvcc(), *_build._FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
        fns = {}
        for name, (so, proc) in jobs.items():
            assert proc.wait() == 0, name
            f = ctypes.CDLL(str(so)).quip_dequant_matmul_tile
            f.argtypes, f.restype = argtypes, ctypes.c_int
            fns[name] = f
        try:
            for sname in ("wqkv", "wo", "wd"):
                m, d = SHAPES[sname]
                copies = _planes(m, d, gen, dev)
                for B in (600, 32):
                    x = torch.randn(B, d, device=dev,
                                    generator=gen).bfloat16()
                    row = []
                    for name, f in fns.items():
                        DM._fn_tile = f
                        row.append(f"{name} {_time(x, copies, scale) * 1e3:.1f}")
                    print(f"ablation {sname} B={B}, us: " + " | ".join(row),
                          flush=True)
        finally:
            DM._fn_tile = genuine


def plans(gen, dev, scale):
    rule = DM._tile_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for sname, (m, d) in SHAPES.items():
            copies = _planes(m, d, gen, dev)
            for B, cands in PLANS.items():
                x = torch.randn(B, d, device=dev, generator=gen).bfloat16()
                want = DM.dequant_matmul_ref(x.float(), copies[0], scale,
                                             None, bits=2)
                chosen = rule(B, d, m, 2, sms)
                row = []
                for plan in [chosen] + [p for p in cands if p != chosen]:
                    DM._tile_plan = lambda *a, plan=plan: plan
                    got = DM.dequant_matmul(x.float(), copies[0], scale, None,
                                            bits=2)
                    rel = ((got - want).abs().max() / want.abs().max()).item()
                    assert rel <= 1e-3, (sname, B, plan, rel)
                    row.append(f"{plan} {_time(x, copies, scale) * 1e3:.1f}")
                print(f"plans {sname} B={B}, us, the rule's first: "
                      + " | ".join(row), flush=True)
            del copies
            torch.cuda.empty_cache()
    finally:
        DM._tile_plan = rule


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_tile: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.02, device=dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    ablate(gen, dev, scale)
    plans(gen, dev, scale)


if __name__ == "__main__":
    main()
