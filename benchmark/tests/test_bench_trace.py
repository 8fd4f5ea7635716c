"""The traced run's capture: where it lies in the window, the union of
device spans, the idle gaps named by the benchmark's spans, and a tiny
traced run through the harness on the CPU."""
import pytest

from benchmark import run as R
from benchmark.trace import Capture, Event, capture_start
from benchmark.tests import tiny


def test_capture_at_the_window_end():
    assert capture_start({"trace_s": 5.0}, 45) == 40.0
    assert capture_start({"trace_s": 5.0}, 4.0) == 2.0


def test_busy_is_the_union_of_device_spans():
    c = Capture(cuda=False)
    c.t0, c.t1 = 0, 100
    c.events = [Event("a", True, 10, 30), Event("b", True, 20, 40),
                Event("c", True, 60, 70),
                Event("cudaStreamSynchronize", False, 41, 59)]
    c.spans = [Event("bench.pump", False, 0, 80),
               Event("bench.no_request", False, 80, 100)]
    assert c.busy_s() == pytest.approx(40e-9)
    assert c.gaps() == [(0, 10), (40, 60), (70, 100)]
    assert c.by_name() == {"a": 20e-9, "b": 20e-9, "c": 10e-9}
    b = c.breakdown()
    assert b["device_ops"][0][0] in ("a", "b")
    assert dict(b["idle_gaps"]) == pytest.approx({
        "bench.no_request": 30e-9,
        "bench.pump > cudaStreamSynchronize": 20e-9,
        "bench.pump": 10e-9})


@pytest.mark.parametrize("mix", [tiny.SERVE, tiny.PPL], ids=["serve", "ppl"])
def test_traced_run_counts_before_its_capture(mix):
    mix = dict(mix, trace_s=1.5)
    if mix["driver"] == "serve":
        mix.update(rate_per_s=4.0, lead_in_s=1.0)
    cell = tiny.cell(tiny.OPT, mix)
    ctx = R.Ctx(cell, 2 ** 31 + 21, 5.0, True, "cpu")
    out, _ = R.drive(cell, ctx)
    f = out.facts
    # the capture starts at the first step past its offset (a pump call
    # apart on the CPU)
    assert 0 < f["counted_s"] and 0 < f["traced_s"]
    assert f["counted_s"] + f["traced_s"] <= f["window_s"] + 1e-6
    assert out.capture.t1 > out.capture.t0 and out.capture.spans
    key = "traced_tokens_per_s" if mix["driver"] == "serve" else \
        "traced_windows_per_s"
    assert f[key] >= 0
    line = R.result_line(cell, ctx, out, {}, "cpu", 1)
    assert line["correct"], line
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
