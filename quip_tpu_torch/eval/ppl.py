"""Windowed perplexity evaluation (port of ``quip_tpu/eval/ppl.py``).

Capability parity with opt_eval / llama_eval (reference opt.py:193-299,
llama.py:174-253): split the test stream into seqlen-token windows,
forward, shifted cross-entropy, ppl = exp(Σ nll / (nwindows · seqlen)).

Each window batch is one ``models/model.py::forward`` on the model's device
under ``torch.inference_mode``: on the card a 2048-token window is one
2048-row pass through the packed dequant-matmul (K1-tile) and the flash
prefill (K2). The loss is taken by ``F.cross_entropy`` in f32 over the
(S - 1) predicted rows, so no f32 log-softmax of the whole (B, S, V)
logits is kept, and the nll sum stays on the device until the end.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig


def window_nll(params: M.Model, tokens: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Total shifted-CE nll over one (B, S) window batch, f32 (B,): the sum
    over the (S - 1) predicted positions of each row (opt.py:287-295)."""
    logits = M.forward(params, tokens, cfg)
    B, S, V = logits.shape
    nll = F.cross_entropy(logits[:, :-1].reshape(-1, V).float(),
                          tokens[:, 1:].reshape(-1), reduction="none")
    return nll.view(B, S - 1).sum(-1)


def perplexity(
    params: M.Model,
    cfg: ModelConfig,
    token_stream: np.ndarray,            # 1-D token ids
    seqlen: int,
    batch: int = 1,
) -> float:
    """Reference-semantics perplexity: non-overlapping seqlen windows, loss
    normalised by nwindows · seqlen (opt.py:287-297), although only
    seqlen - 1 tokens of a window are predicted, as quip_tpu does. A short
    last batch is padded with zero rows, which are dropped."""
    token_stream = np.asarray(token_stream).reshape(-1)
    nwin = len(token_stream) // seqlen
    assert nwin > 0, "test stream shorter than one window"
    windows = torch.from_numpy(
        token_stream[: nwin * seqlen].reshape(nwin, seqlen).astype(np.int64))
    dev = params.embed.tokens.device
    total = torch.zeros((), dtype=torch.float64, device=dev)
    with torch.inference_mode():
        for i in range(0, nwin, batch):
            b = min(batch, nwin - i)
            tk = torch.zeros((batch, seqlen), dtype=torch.int64)
            tk[:b] = windows[i:i + b]
            nlls = window_nll(params, tk.to(dev), cfg)
            total += nlls[:b].sum().double()
    return float(np.exp(total.item() / (nwin * seqlen)))
