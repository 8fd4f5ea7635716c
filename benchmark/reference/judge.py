"""The numbers that decide ``correct``, each worked out by the reference
from the inputs and the program's outputs alone.

* ``served_gap``: a served model's greedy tokens. The reference runs once
  over each prompt with its served tokens (teacher-forced) and reads, at
  each served position, how far the served token's logit lies below the
  reference's best there; the number is the widest such gap.
* ``control_gap``: the same gap for the token that the reference in
  float8 (``model.fp8_rows``) puts first at the same positions.
* ``nll_gap``: perplexity windows. The reference's summed next-token loss
  of each window against the program's, as a gap per predicted token; the
  number is the widest over the windows compared.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import model as RM


def _seqs(reqs, device):
    seqs, starts = [], []
    for prompt, gen in reqs:
        toks = list(prompt) + list(gen[:-1])
        seqs.append(torch.tensor(toks, dtype=torch.int64, device=device))
        starts.append(len(prompt) - 1)
    return seqs, starts


def _gap(ref_rows: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    best = ref_rows.max(dim=-1).values
    return best - ref_rows.gather(1, toks[:, None])[:, 0]


def served_gap(raw: dict, shape: dict,
               reqs: Sequence[Tuple[Sequence[int], Sequence[int]]]
               ) -> Tuple[float, int]:
    """(widest gap, tokens judged) over the served requests (prompt,
    generated)."""
    dev = raw["tok"].device
    seqs, starts = _seqs(reqs, dev)
    rows = RM.rows_from(raw, shape, seqs, starts)
    worst, n = 0.0, 0
    for r, (_, gen) in zip(rows, reqs):
        g = _gap(r, torch.tensor(list(gen), dtype=torch.int64, device=dev))
        worst = max(worst, float(g.max()))
        n += len(gen)
    return worst, n


def control_gap(raw: dict, shape: dict,
                reqs: Sequence[Tuple[Sequence[int], Sequence[int]]]
                ) -> Tuple[float, int]:
    """The widest gap of the float8 reference's first choices at the
    positions that ``served_gap`` judges."""
    dev = raw["tok"].device
    seqs, starts = _seqs(reqs, dev)
    ref = RM.rows_from(raw, shape, seqs, starts)
    low = RM.rows_from(raw, shape, seqs, starts, precision="fp8")
    worst, n = 0.0, 0
    for r, lo in zip(ref, low):
        g = _gap(r, lo.argmax(dim=-1))
        worst = max(worst, float(g.max()))
        n += r.shape[0]
    return worst, n


def window_nll(raw: dict, shape: dict, windows: List[torch.Tensor],
               precision: str = "f32") -> List[float]:
    """Summed next-token loss of each window (S,), over its S - 1
    predicted positions."""
    out = []
    for w in windows:
        h = RM.hidden(raw, shape, [w], precision)[0]
        lg = RM.logits(raw, h[:-1], precision)
        out.append(float(F.cross_entropy(lg, w[1:], reduction="sum")))
    return out


def nll_gap(ref: Sequence[float], got: Sequence[float], seqlen: int
            ) -> float:
    """Widest |got - ref| over the windows, per predicted token."""
    return max(abs(g - r) for g, r in zip(got, ref)) / (seqlen - 1)
