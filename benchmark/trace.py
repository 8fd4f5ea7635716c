"""The profiler's trace of the end of a run's window, kept in memory, and
what the per-layer readers and the result line take from it.

A traced run counts the program's counters and the host clock over the
window up to its last ``trace_s`` seconds (``capture_start``), and records CUDA
activity alone over those (CUPTI, through ``torch.profiler``'s kineto back
end): kernels, copies, and the CUDA runtime calls the host made. Host ops
are not recorded: recording every one slows a host that issues many small
ops several-fold, and ending such a capture takes seconds of the host's
time. The device's idle gaps are named by the benchmark's own spans
(``bench.*``, taken by the driver with the host clock while the capture
runs) and the innermost CUDA runtime call under way. The capture's events
are read after the window, without the profiler's Python event tree.
Device activity is clipped to the capture's span. Busy time is the union
of the device intervals, so kernels that overlap (under programmatic
dependent launch) count once.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class Event(NamedTuple):
    name: str
    device: bool
    t0: int                  # ns, wall clock
    t1: int


def _profiler(cuda: bool):
    from torch.autograd import profiler as ap
    # no card (the CPU tests): host ops stand in for the device's
    acts = {ap.ProfilerActivity.CUDA if cuda else ap.ProfilerActivity.CPU}
    cfg = ap.ProfilerConfig(ap.ProfilerState.KINETO, False, False, False,
                            False, False, ap._ExperimentalConfig())
    return ap, cfg, acts


def capture_start(mix: dict, seconds: float) -> float:
    """Where a traced run's capture starts, in seconds after the window
    opens: the window's last ``trace_s`` (the mix's; at most half of
    it). Counters are read over the part before."""
    return seconds - min(mix.get("trace_s", 5.0), seconds / 2)


class Capture:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events: List[Event] = []
        self.spans: List[Event] = []     # the benchmark's own, host clock
        self.t0 = self.t1 = 0
        self._res = None

    def prepare(self) -> None:
        """Load the profiler's back end ahead of the window (the first
        start pays for it)."""
        ap, cfg, acts = _profiler(self.cuda)
        ap._prepare_profiler(cfg, acts)

    def start(self) -> None:
        ap, cfg, acts = _profiler(self.cuda)
        ap._enable_profiler(cfg, acts)
        self.t0 = time.time_ns()

    def stop(self) -> None:
        """End the capture; device work that ran past this moment is cut
        off at it. Its events are read by ``load``."""
        self.t1 = time.time_ns()
        from torch.autograd import profiler as ap
        self._res = ap._disable_profiler()

    def load(self) -> None:
        res, self._res = self._res, None
        if res is None:
            return
        out = []
        for e in res.events():
            if e.is_user_annotation() and not str(
                    e.device_type()).endswith("CPU"):
                continue          # a host span's mirror on the device
            dev = self.cuda and str(e.device_type()).endswith("CUDA")
            t0, t1 = e.start_ns(), e.end_ns()
            if dev:
                t0, t1 = max(t0, self.t0), min(t1, self.t1)
                if t1 <= t0:
                    continue
            out.append(Event(e.name(), dev, t0, t1))
        self.events = out

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own while the capture runs."""
        if not self.t0 or self.t1:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append(Event(name, False, t0, time.time_ns()))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device(self) -> List[Event]:
        return [e for e in self.events if e.device]

    def intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity, as sorted disjoint intervals."""
        iv = sorted((e.t0, e.t1) for e in self.device())
        out: List[List[int]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e9

    def by_name(self) -> Dict[str, float]:
        acc: Dict[str, float] = {}
        for e in self.device():
            acc[e.name] = acc.get(e.name, 0.0) + (e.t1 - e.t0) / 1e9
        return acc

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle stretches of the device inside the capture."""
        out, prev = [], self.t0
        for a, b in self.intervals():
            if a > prev:
                out.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            out.append((prev, self.t1))
        return out

    def host_at(self, t: int, host: List[Event]) -> str:
        """What the host was doing at t: the benchmark's span around it
        and the innermost recorded host event (a CUDA runtime call) in
        it."""
        inner: Optional[Event] = None
        outer: Optional[Event] = None
        for e in self.spans:
            if e.t0 <= t < e.t1:
                outer = e
        for e in host:
            if e.t0 <= t < e.t1 and (
                    inner is None or e.t1 - e.t0 < inner.t1 - inner.t0):
                inner = e
        parts = [p.name for p in (outer, inner) if p is not None]
        return " > ".join(parts) if parts else "host: no span"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time of the
        300 longest gaps summed by what the host was doing in each."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle: Dict[str, float] = {}
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:300]
        host = [e for e in self.events if not e.device]
        for a, b in longest:
            k = self.host_at((a + b) // 2, host)
            idle[k] = idle.get(k, 0.0) + (b - a) / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


class Tracer:
    """A traced run's capture, driven by the window's clock: the driver
    calls ``tick`` with the seconds since the window opened and a function
    that snapshots its counters, and ``close`` with the snapshot taken as
    the window closes; ``snaps`` holds those at the capture's start
    (``dev0``) and end (``dev1``)."""

    def __init__(self, start: float, cuda: bool):
        self.start = start
        self.cap = Capture(cuda)
        self.snaps: Dict[str, dict] = {}

    def prepare(self) -> None:
        self.cap.prepare()

    def span(self, name: str):
        return self.cap.span(name)

    def tick(self, el: float, snapshot) -> None:
        if not self.cap.t0 and el >= self.start:
            self.snaps["dev0"] = snapshot()
            self.cap.start()

    def close(self, last: dict) -> None:
        if self.cap.t0 and not self.cap.t1:
            self.snaps["dev1"] = last
            self.cap.stop()


def kernel_time(cap: Capture, patterns) -> Tuple[int, float]:
    """(launches of the first pattern's kernel, device seconds of the
    kernels every pattern matches)."""
    from benchmark.roofline import matches
    main, *extra = patterns
    n, t = 0, 0.0
    for e in cap.device():
        if matches(main, e.name):
            n += 1
            t += (e.t1 - e.t0) / 1e9
        elif any(matches(p, e.name) for p in extra):
            t += (e.t1 - e.t0) / 1e9
    return n, t
