"""The generator: the same seed gives the same traffic; every seed offers
the same lengths and the same gaps between arrivals, block by block, in
another order."""
import numpy as np
import pytest

from benchmark import gen, spec
from benchmark.tests import tiny


def _key(reqs):
    return [(r.due_s, r.prompt.tobytes(), r.max_new_tokens) for r in reqs]


def test_same_seed_same_traffic():
    mix = spec.mix("chat-b8")
    a = gen.schedule(mix, 2 ** 31 + 5, 30, 50272)
    b = gen.schedule(mix, 2 ** 31 + 5, 30, 50272)
    assert _key(a) == _key(b)
    end = mix["lead_in_s"] + 30
    assert a[0].due_s == 0 and a[-1].due_s < end
    assert abs(len(a) - end * mix["rate_per_s"]) <= mix["block"]


def test_gaps_are_exponential_quantiles():
    g = gen.gaps(2.0, 16)
    assert sum(g) == pytest.approx(8.0)
    assert g == sorted(g) and g[-1] > 6 * g[0]
    # the exponential's coefficient of variation is 1; midpoint quantiles
    # of 16 come close
    m = np.mean(g)
    assert 0.8 < np.std(g) / m < 1.0


def test_seeds_share_lengths_and_gaps():
    mix = spec.mix("chat-b8")
    k = mix["block"]
    a = gen.schedule(mix, 11, 60, 50272)
    b = gen.schedule(mix, 12, 60, 50272)
    assert [r.due_s for r in a] != [r.due_s for r in b]
    assert _key(a) != _key(b)
    n = min(len(a), len(b)) // k * k
    assert n >= 2 * k
    for i in range(0, n, k):
        for get in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
            assert sorted(map(get, a[i:i + k])) == sorted(map(get, b[i:i + k]))
        # each block starts at the same time in every seed
        assert a[i].due_s == pytest.approx(b[i].due_s)
        assert a[i].due_s == pytest.approx(i / mix["rate_per_s"])


def test_lengths_in_range_and_warm_traffic_apart():
    mix = spec.mix("chat-b8")
    reqs = gen.schedule(mix, 7, 10, 50272)
    assert min(len(r.prompt) for r in reqs) >= mix["prompt"]["min"]
    assert max(len(r.prompt) for r in reqs) <= mix["prompt"]["max"]
    assert all(mix["output"]["min"] <= r.max_new_tokens
               <= mix["output"]["max"] for r in reqs)
    warm = gen.warm_requests(mix, 7, 50272)
    assert len(warm) == mix["block"]
    assert sorted(len(r.prompt) for r in warm) == sorted(
        gen.quantiles(mix["prompt"], mix["block"]))
    assert _key(warm) != _key(reqs[:len(warm)])


def test_windows_by_seed():
    mix = tiny.PPL
    a = gen.windows(mix, 99, 512)
    assert a.shape == (mix["pool"], mix["seqlen"])
    assert np.array_equal(a, gen.windows(mix, 99, 512))
    assert not np.array_equal(a, gen.windows(mix, 100, 512))
    assert not np.array_equal(a, gen.windows(mix, 99, 512, warm=True))
