"""Adaptive rounding solvers: LDLQ (with greedy passes) and its OPTQ-order
twin, plus round-to-nearest.

Port of the LDLQ half of ``quip_tpu/core/ldlq.py`` (reference
vector_balance.py). The sequential column recurrence
(vector_balance.py:179-180) keeps quip_tpu's blocked form (the reference's
"lazy batch", vector_balance.py:218-291): cross-block error feedback is one
(m, d') x (d', B) matmul per block of B columns; only the short in-block
loop is serial, over the (m, B) local block. In eager PyTorch that loop is
a host loop of a few launches a column.

All solvers work in grid coordinates (W mapped into [0, maxq], see
core/grid.py). W is (m, d) with d the fan-in and H the (d, d) proxy
Hessian. Randomness (unbiased rounding) comes from an explicit
``torch.Generator``. ``round_allbal*``, ``round_ldlqRG`` and the LDL-ADMM
solvers are not ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cholesky(H: torch.Tensor, what: str) -> torch.Tensor:
    """Lower Cholesky factor of H; raises where jnp.linalg.cholesky would
    return NaNs (H not positive definite)."""
    C, info = torch.linalg.cholesky_ex(H)
    bad = int(info)
    if bad:
        raise torch.linalg.LinAlgError(
            f"{what}: the matrix is not positive definite (Cholesky failed "
            f"at column {bad - 1} of {H.shape[0]})")
    return C


def ldl_factor(H: torch.Tensor) -> torch.Tensor:
    """The strictly-lower LDL "feedback" factor
    L = chol(H) @ diag(1/diag(chol(H))) - I   (vector_balance.py:171-173)."""
    C = _cholesky(H, "ldl_factor")
    L = C * (1.0 / torch.diagonal(C))[None, :]
    return L - torch.eye(H.shape[0], dtype=H.dtype, device=H.device)


def _pad_wh(Wg, H, blocksize):
    """Pad d up to a multiple of blocksize. H is padded block-diagonally
    with max(diag(H)) * I, so the Cholesky factor decouples the pad columns
    and greedy passes that normalize by max(diag(H)) are unaffected."""
    m, d = Wg.shape
    dp = _cdiv(d, blocksize) * blocksize
    if dp == d:
        return Wg, H, d
    Hp = torch.zeros((dp, dp), dtype=H.dtype, device=H.device)
    Hp[:d, :d] = H
    Hp.diagonal()[d:] = torch.diagonal(H).max()
    Wp = torch.nn.functional.pad(Wg, (0, dp - d))
    return Wp, Hp, d


# ---------------------------------------------------------------------------
# The LDLQ initial pass (vector_balance.py:155-181 / blocked 218-258)
# ---------------------------------------------------------------------------


def _ldl_initial_pass(Wg, L, eta, maxq, blocksize):
    """Blocked LDLQ rounding sweep, columns processed d-1 -> 0.

    Recurrence (vector_balance.py:179-180):
        w_hat[:, i] = clamp(floor(w[:, i] + (w[:, i:] - w_hat[:, i:]) @ L[i:, i]
                                  + eta[:, i]), 0, maxq)

    The error E = W - What of the processed columns feeds each block once,
    T = E[:, after] @ L[after, block]; the column loop then touches only
    the block's own errors, kept transposed (B, m) so each column is one
    contiguous row."""
    m, d = Wg.shape
    B = blocksize
    What = torch.empty_like(Wg)
    E = torch.zeros_like(Wg)
    for s in range(d - B, -1, -B):
        e = s + B
        T = E[:, e:] @ L[e:, s:e]                    # (m, B) tail feedback
        Lblk = L[s:e, s:e]
        Wt = Wg[:, s:e].t().contiguous()             # (B, m)
        Tt = T.t().contiguous()
        Et = eta[:, s:e].t().contiguous()
        Eblk = torch.zeros_like(Wt)                  # local errors (B, m)
        Wh = torch.empty_like(Wt)
        for i in range(B - 1, -1, -1):
            c = Lblk[i + 1:, i] @ Eblk[i + 1:] + Tt[i]
            w_hat = torch.clamp(torch.floor(Wt[i] + c + Et[i]), 0, maxq)
            torch.sub(Wt[i], w_hat, out=Eblk[i])
            Wh[i] = w_hat
        What[:, s:e] = Wh.t()
        E[:, s:e] = Eblk.t()
    return What


# ---------------------------------------------------------------------------
# Greedy coordinate-descent passes (vector_balance.py:186-196)
# ---------------------------------------------------------------------------


def _greedy_sweep(wr, s, Hn, maxq, blocksize, reverse):
    """One full coordinate-descent pass over all columns.

    Per column i: Hs = s @ Hn[:, i];
        eps = wr[:, i] - round(wr[:, i] - Hs / Hn[i, i]);
        wr[:, i] -= eps; s[:, i] -= eps.
    Blocked: contributions from outside the current block are one matmul
    (the reference's S0/S2 term, vector_balance.py:117). The unbiased
    variant (floor(. + U[0,1))) belongs to round_allbal, not ported yet."""
    m, d = wr.shape
    B = blocksize
    wr, s = wr.clone(), s.clone()
    starts = range(0, d, B)
    for st in (reversed(starts) if reverse else starts):
        blk = slice(st, st + B)
        Hblk = Hn[blk, blk]
        W1, S1 = wr[:, blk].clone(), s[:, blk].clone()
        s_masked = s.clone()
        s_masked[:, blk] = 0
        T = s_masked @ Hn[:, blk]                    # (m, B)
        for i in (range(B - 1, -1, -1) if reverse else range(B)):
            Hs = S1 @ Hblk[:, i] + T[:, i]
            target = W1[:, i] - Hs / Hblk[i, i]
            eps = W1[:, i] - torch.round(target)
            W1[:, i] = W1[:, i] - eps
            S1[:, i] = S1[:, i] - eps
        wr[:, blk] = W1
        s[:, blk] = S1
    return wr, s


def _greedy_passes(wr0, s0, Hn, maxq, npasses, blocksize, reverse, w_hat0):
    """npasses greedy sweeps with fixed-point early exit. As in the
    reference, the clamp applies to wr after each pass but s is not
    re-synchronized to the clamped wr (vector_balance.py:186-196)."""
    wr, s, w_hat = wr0, s0, w_hat0
    for _ in range(npasses):
        wr, s = _greedy_sweep(wr, s, Hn, maxq, blocksize, reverse)
        wr = torch.clamp(wr, 0, maxq)
        done = bool(torch.equal(w_hat, wr))
        w_hat = wr
        if done:
            break
    return wr


# ---------------------------------------------------------------------------
# Public solvers
# ---------------------------------------------------------------------------


def round_ldl(Wg: torch.Tensor, H: torch.Tensor, bits: int,
              n_greedy_passes: int = 9, unbiased: bool = False,
              gen: Optional[torch.Generator] = None,
              blocksize: int = 128) -> torch.Tensor:
    """LDLQ rounding (vector_balance.py:155-199 / blocked 218-291).
    Wg in grid coordinates (target range [0, 2**bits - 1]); H PD.
    ``unbiased`` draws the dither eta ~ U[0, 1) from ``gen``."""
    if unbiased and n_greedy_passes > 0:
        raise ValueError(
            "greedy passes are incompatible with unbiased LDL rounding")
    maxq = float(2 ** bits - 1)
    Wp, Hp, d0 = _pad_wh(Wg, H, blocksize)
    L = ldl_factor(Hp)
    if unbiased:
        if gen is None:
            raise ValueError("unbiased rounding requires a torch.Generator")
        eta = torch.rand(Wp.shape, generator=gen, dtype=Wp.dtype,
                         device=gen.device).to(Wp.device)
    else:
        eta = torch.full_like(Wp, 0.5)

    What = _ldl_initial_pass(Wp, L, eta, maxq, blocksize)

    if n_greedy_passes > 0:
        s = What - Wp
        Hn = Hp / torch.diagonal(Hp).max()
        What = _greedy_passes(What, s, Hn, maxq, n_greedy_passes, blocksize,
                              reverse=True, w_hat0=What)
    return What[:, :d0]


def round_ldl_gptqequiv(Wg: torch.Tensor, H: torch.Tensor, bits: int,
                        unbiased: bool = False,
                        gen: Optional[torch.Generator] = None,
                        blocksize: int = 128) -> torch.Tensor:
    """OPTQ-order LDLQ (vector_balance.py:381-422): round_ldl on
    column-reversed (W, H), flipped back."""
    out = round_ldl(Wg.flip(1), H.flip(0, 1), bits, n_greedy_passes=0,
                    unbiased=unbiased, gen=gen, blocksize=blocksize)
    return out.flip(1)


def round_nearest(Wg: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-to-nearest on the grid, the baseline (near.py:5-20)."""
    return torch.clamp(torch.round(Wg), 0, 2 ** bits - 1)


def hessian_loss(dW: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Proxy loss tr(ΔW H ΔWᵀ) (vector_balance.py:14-15,
    method.py:228-233), summed as Σ (ΔW H) ∘ ΔW: never the (m, m) product
    (32000² floats for a Llama lm_head)."""
    return torch.sum((dW @ H) * dW)


def weight_entropy(Wr, bits: int) -> float:
    """Average bits per weight of the empirical code distribution
    (vector_balance.py:18-24 `calc_entropy`)."""
    a = Wr.cpu().numpy() if isinstance(Wr, torch.Tensor) else np.asarray(Wr)
    _, counts = np.unique(a, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum() / np.log(2.0))


def check_nbits(Wr, bits: int) -> bool:
    """True iff the rounded weights use at most 2**bits values
    (vector_balance.py:8-11)."""
    a = Wr.cpu().numpy() if isinstance(Wr, torch.Tensor) else np.asarray(Wr)
    return len(np.unique(a)) <= 2 ** bits
