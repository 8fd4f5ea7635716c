"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the same numbers are the last lines of standard error. With no
card, fewer cards than the cell asks for, the program missing from the
checkout, or ``jax``, ``jaxlib``, ``flax`` or ``quip_tpu`` loaded once the
window has closed, it exits with another code than 0 and prints no
result.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import spec  # noqa: E402

BARRED = ("jax", "jaxlib", "flax", "quip_tpu")


def barred_modules() -> list:
    """Loaded modules whose top-level name is a barred one, compared whole
    (``quip_tpu_torch`` is not ``quip_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in BARRED})


def _fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


class Ctx:
    """What a driver reads: the cell's configuration, shape, mix and
    limits, the run's arguments, the program's model config and device."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float = None):
        import torch
        from quip_tpu_torch.models.config import get_config
        from benchmark import weights as WT
        self.conf, self.mix = cell["config"], cell["mix"]
        self.limits = cell["limits"]
        self.shape = WT.shape_of(self.conf)
        self.cfg = get_config(self.conf["preset"])
        WT.check_preset(self.shape, self.cfg)
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t_start = _T_START if t_start is None else t_start
        self.setup_s = None
        self.phases: dict = {}        # set-up's steps: seconds since start

    def phase(self, name: str) -> None:
        """Mark the end of a step of set-up (printed among the facts)."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self.phases[name] = time.perf_counter() - self.t_start

    def mark_setup(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - self.t_start

    def after_window(self) -> None:
        found = barred_modules()
        if found:
            _fail(3, "modules of jax or quip_tpu are loaded: "
                  + ", ".join(found[:20]))


def drive(cell: dict, ctx: Ctx):
    """Run the cell's driver (its mix's ``driver``: ``serve`` or ``ppl``)
    and read its per-layer metrics; returns (outcome, metrics)."""
    import importlib
    drv = importlib.import_module(f"benchmark.{cell['mix']['driver']}")
    out = drv.run(ctx)
    metrics = {}
    if ctx.trace:
        for m in cell["per_layer"]:
            v = spec.reader(m["name"]).read(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
        for m in cell["end_to_end"]:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    return out, metrics


def result_line(cell, ctx, out, metrics, device_kind: str, count: int
                ) -> dict:
    missing = [] if ctx.trace else [
        m["name"] for m in cell["end_to_end"] if m["name"] not in metrics]
    ok = out.correct and not missing and not out.failed
    dev = {"platform": "gpu", "kind": device_kind, "count": count,
           "memory_peak_bytes": int(out.memory_peak)}
    line = {"correct": ok, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if ctx.trace and out.capture is not None:
        dev["busy_s"] = out.capture.busy_s()
        dev["window_s"] = out.capture.window_s
        line["breakdown"] = out.capture.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    if missing:
        line["checks"]["missing_metrics"] = {"value": len(missing),
                                             "limit": 0}
    return line


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(args.workload)
    # the program's caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(spec.ROOT / ".bench_cache" / sub)
    for k, v in cell["config"].get("env", {}).items():
        os.environ[k] = str(v)

    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available():
        _fail(2, "no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < chips:
        _fail(2, f"{torch.cuda.device_count()} CUDA devices, the cell "
              f"asks for {chips}")
    try:
        import quip_tpu_torch
        from quip_tpu_torch.kernels import _build
    except ImportError as e:
        _fail(2, f"the program is not in this checkout ({e})")
    if spec.ROOT not in Path(quip_tpu_torch.__file__).resolve().parents:
        _fail(2, f"quip_tpu_torch was imported from "
              f"{quip_tpu_torch.__file__}, not from this checkout")
    t_import = time.perf_counter() - _T_START
    card = _card()
    print(f"benchmark: card {card}; peaks 989 TFLOP/s bf16, 3.35 TB/s",
          file=sys.stderr, flush=True)
    t_card = time.perf_counter() - _T_START
    _build.build_all(["dequant_matmul_decode", "dequant_matmul_tile",
                      "flash_attn", "rht"])
    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    ctx.phases.update(imports=t_import, card=t_card)
    ctx.phase("kernels")
    torch.cuda.reset_peak_memory_stats()
    out, metrics = drive(cell, ctx)
    line = result_line(cell, ctx, out, metrics,
                       torch.cuda.get_device_name(0), chips)
    facts = {k: v for k, v in out.facts.items() if k != "bounds"}
    print(f"benchmark: facts {json.dumps(facts)}", file=sys.stderr)
    print(f"benchmark: set-up steps (s since start) "
          f"{json.dumps(ctx.phases)}", file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
