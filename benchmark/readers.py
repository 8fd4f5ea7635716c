"""What the per-layer readers (``metrics/<metric>.py``) share. A reader
is ``read(run) -> float or None``: ``run`` is the driver's ``Outcome``
(``facts`` the program's counters and the window's counts, ``capture``
the trace, ``shape``). None means nothing to read, and the metric is
left out of the line; a share of a roofline or a peak is never 0."""
from __future__ import annotations

from typing import Optional

from benchmark import roofline as RF
from benchmark.trace import kernel_time


def kernel_roofline(run, key: str) -> Optional[float]:
    """Σ bound of the traced launches of kernel ``key`` over their device
    time, in %. Each launch's bound is the mean over the launches of one
    step or window (``facts["bounds"][key]``, in launch order), so a
    capture that cuts a step misses at most one step's mix of shapes."""
    if run.capture is None:
        return None
    main, extra = RF.KERNELS[key]
    n, t = kernel_time(run.capture, (main, *extra))
    bounds = run.facts.get("bounds", {}).get(key)
    if n == 0 or t <= 0 or not bounds:
        return None
    return 100.0 * n * (sum(bounds) / len(bounds)) / t


def idle_share(run) -> Optional[float]:
    cap = run.capture
    if cap is None or cap.window_s <= 0 or not cap.device():
        return None
    return 100.0 * (1.0 - cap.busy_s() / cap.window_s)


def share_of_peak(run, key: str) -> Optional[float]:
    """``facts[key]`` FLOPs over the counted seconds times the peak, in %."""
    f, s = run.facts.get(key), run.facts.get("counted_s")
    if not f or not s:
        return None
    return 100.0 * f / (s * RF.PEAK_FLOPS)


def fact(run, key: str) -> Optional[float]:
    v = run.facts.get(key)
    return None if v is None else float(v)
