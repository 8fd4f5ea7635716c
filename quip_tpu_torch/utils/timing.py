"""Device timing for the port's kernels (CUDA only)."""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def time_ms(fns: Sequence[Callable[[], object]], iters: int) -> float:
    """Device ms per call: one CUDA graph holds one call of each of ``fns``
    (cycling through copies keeps the working set past the 50 MB L2 where
    the real caller finds it cold) and is replayed ``iters`` times between
    two events. The graph takes the host's launch cost out: a wrapper's
    Python and ctypes work outlasts a decode-size kernel."""
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


# device-memory rate (B/s) and dense bf16 tensor rate (FLOP/s) by card
# (NVIDIA data sheets; SXM unless the name says PCIe)
_PEAKS = {"pcie": (2.0e12, 756e12), "sxm": (3.35e12, 989e12)}


def card_peaks(name: str):
    """(bytes/s, bf16 FLOP/s) published for the card called ``name``."""
    return _PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
