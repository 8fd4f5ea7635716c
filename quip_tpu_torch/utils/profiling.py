"""Tracing / profiling / determinism utilities (port of
``quip_tpu/utils/profiling.py``):

  * PhaseTimer — per-phase wall-clock accounting with a summary table.
  * trace(log_dir) — a ``torch.profiler`` trace (host ops, and the card's
    kernels where there is one) written into ``log_dir``; a no-op without
    a directory. A profiler that fails to start or stop is reported on
    stderr and the traced work runs on untraced, as quip_tpu's ``trace``
    swallows a failing ``start_trace``: the quantize CLI's ``--trace`` is
    its only caller.
  * seed_everything — seeds python, numpy and torch; returns a
    ``torch.Generator`` where quip_tpu returns a PRNG key.
"""
from __future__ import annotations

import contextlib
import random
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class PhaseTimer:
    """Accumulate wall-clock per named phase; print a summary."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = [f"{'phase':24s} {'total_s':>9s} {'calls':>6s} {'avg_ms':>8s}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            rows.append(f"{name:24s} {tot:9.2f} {n:6d} "
                        f"{tot / n * 1e3:8.1f}")
        return "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the block into ``log_dir`` (a
    ``*.pt.trace.json`` file, Chrome-trace format); no-op without one."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(log_dir))
        prof.__enter__()
    except Exception as e:  # the run goes on untraced, as in quip_tpu
        print(f"trace: the profiler did not start ({e!r}); running "
              f"untraced", file=sys.stderr)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except Exception as e:
                print(f"trace: writing the trace failed ({e!r})",
                      file=sys.stderr)


def seed_everything(seed: int) -> torch.Generator:
    """Seed python/numpy/torch RNGs and return a CPU torch.Generator
    seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
