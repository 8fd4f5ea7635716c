"""The operation and byte counts against the bounds of PERF.md's kernel
table (max(bytes / 3.35 TB/s, flops / 989 TFLOP/s))."""
import pytest

from benchmark import roofline as RF
from benchmark import spec
from benchmark.weights import shape_of

OPT = shape_of(spec.config("opt-6.7b.w2"))


def ms(x):
    return x * 1e3


def test_k1_decode_opt_b1():
    b = RF.decode_step_bounds(OPT, 1)["k1_decode"]
    assert ms(sum(b)) == pytest.approx(0.0151, abs=5e-5)


def test_k1_tile_opt():
    assert ms(sum(RF.window_bounds(OPT, 1, 2048)["k1_tile"])) == \
        pytest.approx(0.8338, abs=5e-4)
    assert ms(sum(RF.bound_s(*RF.dequant_matmul(600, m, d, 2))
                  for m, d in RF.linears(OPT))) == pytest.approx(0.2443,
                                                                 abs=5e-4)


def test_k2_s2048():
    assert ms(RF.window_bounds(OPT, 1, 2048)["k2"][0]) == pytest.approx(
        0.0348, abs=5e-5)
    # B = 1, S = 1000: bytes-bound, 0.0098 ms in the table
    assert ms(RF.bound_s(*RF.flash(1, 32, 1000, 128))) == pytest.approx(
        0.0098, abs=5e-5)


def test_k3_opt_five():
    # the five (n, direction) pairs of an OPT step at B = 1
    pairs = [4096, 12288, 4096, 16384, 16384]
    s = sum(RF.bound_s(*RF.rht(1, n, *RF._split(n))) for n in pairs)
    assert ms(s) == pytest.approx(0.00026, abs=1e-5)


def test_step_flops():
    D, L, V = 4096, 32, 50272
    layer = 3 * D * D + D * D + 2 * D * 16384
    assert RF.step_flops(OPT, 8, 100) == pytest.approx(
        8 * (2 * L * layer + 2 * D * V + 4 * L * D * 100))
    # a span equals its tokens one at a time
    one = sum(RF.span_flops(OPT, p, p + 1, heads=1) for p in range(5, 9))
    assert RF.span_flops(OPT, 5, 9, heads=4) == pytest.approx(one)
