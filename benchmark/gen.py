"""The one traffic generator: every mix under ``traffic/`` is a JSON file
of parameters that this module reads.

Serving mixes (``"driver": "serve"``) are an open loop of Poisson
arrivals at ``rate_per_s``, from ``lead_in_s`` before the measured window
opens until it closes. Requests come in blocks of ``block``; every block
holds the same gaps between arrivals, the ``block`` quantiles of the
exponential distribution of mean 1 / rate (scaled so that a block lasts
exactly block / rate seconds), and the same lengths, the ``block``
quantiles of each length distribution. The seed only orders them within
a block, gaps, prompts and outputs each permuted apart. So every seed
offers the same work over the same time, in another order: the bursts
and lulls of a Poisson stream, without a seed that offers more. Prompt
tokens are drawn uniformly from the vocabulary. ``prompt`` and
``output`` give ``dist`` ("loguniform" or "uniform"), ``min`` and
``max``, inclusive.

Perplexity mixes (``"driver": "ppl"``) are ``pool`` windows of ``seqlen``
tokens drawn uniformly from the vocabulary, scored ``batch`` at a time in
turn.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np

# seeds up to a little over 2^31 and beyond: numpy takes any size
_WARM = 0x5EED_0000


class Req(NamedTuple):
    due_s: float             # seconds after the schedule starts
    prompt: np.ndarray       # (plen,) int32
    max_new_tokens: int


def quantiles(spec: dict, n: int) -> List[int]:
    """The n midpoint quantiles of a length distribution, rounded."""
    lo, hi = spec["min"], spec["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "loguniform":
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        elif spec["dist"] == "uniform":
            v = lo + u * (hi - lo)
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(v)))))
    return out


def gaps(rate: float, n: int) -> List[float]:
    """The n midpoint quantiles of the exponential gap of mean 1 / rate,
    scaled so that they sum to n / rate."""
    g = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    return [v * n / (sum(g) * rate) for v in g]


def rng(seed: int, warm: bool = False) -> np.random.Generator:
    return np.random.default_rng([int(seed), _WARM if warm else 0])


def schedule(mix: dict, seed: int, seconds: float, vocab: int,
             warm: bool = False) -> List[Req]:
    """Every request of a serving run: due from 0 up to lead_in_s +
    seconds, the first at 0."""
    r = rng(seed, warm)
    k = mix["block"]
    pq, oq = quantiles(mix["prompt"], k), quantiles(mix["output"], k)
    gq = np.asarray(gaps(mix["rate_per_s"], k))
    end = mix["lead_in_s"] + seconds
    out, t = [], 0.0
    while t < end:
        ps, os_, gs = r.permutation(pq), r.permutation(oq), r.permutation(gq)
        for p, o, g in zip(ps, os_, gs):
            if t >= end:
                break
            toks = r.integers(0, vocab, int(p), dtype=np.int64)
            out.append(Req(t, toks.astype(np.int32), int(o)))
            t += float(g)
    return out


def warm_requests(mix: dict, seed: int, vocab: int) -> List[Req]:
    """One block of the mix's lengths (every length it offers) under a
    seed of their own, all due at once: the warm-up's traffic."""
    r = rng(seed, warm=True)
    k = mix["block"]
    pq, oq = quantiles(mix["prompt"], k), quantiles(mix["output"], k)
    return [Req(0.0, r.integers(0, vocab, p, dtype=np.int64)
                .astype(np.int32), o)
            for p, o in zip(r.permutation(pq), r.permutation(oq))]


def windows(mix: dict, seed: int, vocab: int, warm: bool = False
            ) -> np.ndarray:
    """(pool, seqlen) int64 perplexity windows."""
    r = rng(seed, warm)
    return r.integers(0, vocab, (mix["pool"], mix["seqlen"]),
                      dtype=np.int64)
