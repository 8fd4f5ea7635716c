"""Calibration / evaluation data (port of ``quip_tpu/data/calib.py``).

Only the offline ``synthetic`` stream is ported: the wikitext2 / ptb / c4
loaders (reference datautils.py:10-190) need dataset files and a tokenizer
that are not in the repository (ROADMAP queue 1 item 8). Token arrays are
numpy int32, as in quip_tpu; callers move them to the device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_FILE_DATASETS = ("wikitext2", "ptb", "c4")


def get_synthetic(nsamples, seed, seqlen, vocab_size: int = 512,
                  test_tokens: int = 16384):
    """Deterministic offline stream, token for token quip_tpu's: each token
    follows its predecessor by t -> 7t + 3 (mod vocab) with probability
    0.7, else it is drawn uniformly. Returns (calib (nsamples, seqlen),
    test stream of ``test_tokens``)."""
    rng = np.random.default_rng(seed)
    n = nsamples * seqlen + test_tokens
    toks = np.empty(n, np.int32)
    toks[0] = rng.integers(vocab_size)
    jumps = rng.random(n)
    rnd_toks = rng.integers(0, vocab_size, n)
    for i in range(1, n):
        if jumps[i] < 0.7:
            toks[i] = (toks[i - 1] * 7 + 3) % vocab_size
        else:
            toks[i] = rnd_toks[i]
    train = toks[: nsamples * seqlen].reshape(nsamples, seqlen)
    return train, toks[nsamples * seqlen:]


def get_loaders(name: str, nsamples: int = 128, seed: int = 0,
                seqlen: int = 2048, model: str = "",
                vocab_size: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatcher (datautils.py:180-190). Returns (calib (nsamples, seqlen)
    int32, test token stream 1-D int32)."""
    if "synthetic" in name:
        return get_synthetic(nsamples, seed, seqlen, vocab_size)
    if any(d in name for d in _FILE_DATASETS):
        raise NotImplementedError(
            f"dataset {name!r}: its files and tokenizer are not in the "
            f"repository; use 'synthetic' (ROADMAP queue 1 item 8)")
    raise ValueError(f"unknown dataset {name!r}")
