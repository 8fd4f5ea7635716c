"""Serving's request set and its teacher-forced exactness check, shared by
``chip_smoke.py`` and ``tools/mesh_check.py``.

``serving_prompts`` are the smoke test's serving prompts (600, 128, 37, 5
and 200 tokens, drawn in that order from one seeded generator).
``exactness`` teacher-forces each emitted stream through one forward of
the unsharded model and reads how far each token is from its row's
argmax.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PROMPT_LENS = (600, 128, 37, 5, 200)


def serving_prompts(vocab_size: int, seed: int = 0) -> Dict[int, List[int]]:
    """{length: prompt} for each of ``PROMPT_LENS``, drawn in that order."""
    rng = np.random.default_rng(seed)
    return {n: rng.integers(0, vocab_size, n).tolist() for n in PROMPT_LENS}


def exactness(model, cfg, reqs: Sequence[dict], gens: Sequence[List[int]],
              prefix: Optional[Sequence[int]] = None,
              tol: Optional[float] = None) -> Tuple[float, float]:
    """Teacher-force each request's emitted stream through one forward of
    ``model`` (its shared ``prefix`` first where the request opted in):
    the share of tokens that are the argmax of their row, and the largest
    gap to the row's max over its max |logit|, which must be <= ``tol``
    (None: only read)."""
    from quip_tpu_torch.models import model as M
    exact = total = 0
    worst = 0.0
    dev = model.embed.tokens.device
    for q, g in zip(reqs, gens):
        pre = (list(prefix) if prefix is not None and q.get("use_prefix", True)
               else [])
        seq = pre + list(q["prompt"]) + list(g[:-1])
        with torch.inference_mode():
            lg = M.forward(model, torch.tensor(seq, device=dev)[None],
                           cfg)[0, len(pre) + len(q["prompt"]) - 1:].float()
        if not torch.isfinite(lg).all():
            raise AssertionError("NaN/inf logits")
        gen = torch.tensor(g, device=dev)
        gap = ((lg.max(-1).values - lg.gather(1, gen[:, None])[:, 0])
               / lg.abs().max(-1).values)
        exact += int((gap == 0).sum())
        total += len(g)
        worst = max(worst, gap.max().item())
    if tol is not None and worst > tol:
        raise AssertionError(f"worst gap {worst} > {tol}")
    return exact / total, worst
