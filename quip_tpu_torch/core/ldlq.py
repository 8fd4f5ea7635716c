"""Adaptive rounding solvers: LDLQ (with greedy passes) and its OPTQ-order
twin, LDLQ-RG, greedy coordinate descent ("allbal"), LDL-ADMM, and
round-to-nearest.

Port of ``quip_tpu/core/ldlq.py`` (reference vector_balance.py). The sequential column recurrence
(vector_balance.py:179-180) keeps quip_tpu's blocked form (the reference's
"lazy batch", vector_balance.py:218-291): cross-block error feedback is one
(m, d') x (d', B) matmul per block of B columns; only the short in-block
loop is serial, over the (m, B) local block. In eager PyTorch that loop is
a host loop of a few launches a column.

All solvers work in grid coordinates (W mapped into [0, maxq], see
core/grid.py). W is (m, d) with d the fan-in and H the (d, d) proxy
Hessian. Randomness (unbiased rounding) comes from an explicit
``torch.Generator``. quip_tpu draws its uniforms with threefry, which the
port does not reproduce; so the solvers that dither also take the
uniforms as tensors (``eta``, or ``uniforms`` a pass for unbiased allbal),
and a test hands quip_tpu's in. The fixed-point, greedy and ADMM loops are
host loops (one device-to-host sync an iteration for the early exit).
"""
from __future__ import annotations

from typing import Callable, Optional

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


def _greedy_sweep(wr, s, Hn, maxq, blocksize, reverse, noise=None):
    """One full coordinate-descent pass over all columns.

    Per column i: Hs = s @ Hn[:, i];
        eps = wr[:, i] - round_fn(wr[:, i] - Hs / Hn[i, i]);
        wr[:, i] -= eps; s[:, i] -= eps.
    round_fn is round() (biased) or floor(. + U[0,1)) (unbiased allbal,
    vector_balance.py:28-33), with ``noise`` the pass's (d/B, B, m)
    uniforms (column i of block b reads noise[b, i]). Blocked:
    contributions from outside the current block are one matmul (the
    reference's S0/S2 term, vector_balance.py:117)."""
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
            if noise is None:
                z = torch.round(target)
            else:
                z = torch.floor(target + noise[st // B, i])
            eps = W1[:, i] - z
            W1[:, i] = W1[:, i] - eps
            S1[:, i] = S1[:, i] - eps
        wr[:, blk] = W1
        s[:, blk] = S1
    return wr, s


Uniforms = Callable[[int], torch.Tensor]


def _greedy_passes(wr0, s0, Hn, maxq, npasses, blocksize, reverse, w_hat0,
                   uniforms: Optional[Uniforms] = None):
    """npasses greedy sweeps with fixed-point early exit. As in the
    reference, the clamp applies to wr after each pass but s is not
    re-synchronized to the clamped wr (vector_balance.py:186-196).
    ``uniforms(pass)`` gives each pass's fresh (d/B, B, m) dither (quip_tpu
    folds the pass index into its key); None rounds to nearest."""
    wr, s, w_hat = wr0, s0, w_hat0
    for ip in range(npasses):
        noise = None if uniforms is None else uniforms(ip)
        wr, s = _greedy_sweep(wr, s, Hn, maxq, blocksize, reverse, noise)
        wr = torch.clamp(wr, 0, maxq)
        done = bool(torch.equal(w_hat, wr))
        w_hat = wr
        if done:
            break
    return wr


def _uniform(gen: Optional[torch.Generator], shape, like: torch.Tensor,
             what: str) -> torch.Tensor:
    """U[0, 1) of ``shape`` drawn from ``gen`` (on its device), moved to
    ``like``'s device in its dtype."""
    if gen is None:
        raise ValueError(f"{what} requires a torch.Generator")
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=gen.device).to(like.device)


# ---------------------------------------------------------------------------
# Public solvers
# ---------------------------------------------------------------------------


def round_ldl(Wg: torch.Tensor, H: torch.Tensor, bits: int,
              n_greedy_passes: int = 9, unbiased: bool = False,
              gen: Optional[torch.Generator] = None,
              blocksize: int = 128,
              eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LDLQ rounding (vector_balance.py:155-199 / blocked 218-291).
    Wg in grid coordinates (target range [0, 2**bits - 1]); H PD.
    ``unbiased`` dithers by eta ~ U[0, 1) of the padded shape, given or
    drawn from ``gen``."""
    if unbiased and n_greedy_passes > 0:
        raise ValueError(
            "greedy passes are incompatible with unbiased LDL rounding")
    maxq = float(2 ** bits - 1)
    Wp, Hp, d0 = _pad_wh(Wg, H, blocksize)
    L = ldl_factor(Hp)
    if not unbiased:
        eta = torch.full_like(Wp, 0.5)
    elif eta is None:
        eta = _uniform(gen, Wp.shape, Wp, "unbiased rounding")

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


def round_allbal(Wg: torch.Tensor, H: torch.Tensor, bits: int,
                 npasses: int, unbiased: bool = False,
                 gen: Optional[torch.Generator] = None,
                 blocksize: int = 128,
                 uniforms: Optional[Uniforms] = None) -> torch.Tensor:
    """Greedy coordinate descent from the unrounded weights
    (vector_balance.py:36-135): columns swept 0 -> d-1, ``npasses``
    passes, fixed-point early exit. ``unbiased`` dithers each pass by
    fresh uniforms: ``uniforms(pass)`` (d'/B, B, m), or drawn from
    ``gen``."""
    maxq = float(2 ** bits - 1)
    Wp, Hp, d0 = _pad_wh(Wg, H, blocksize)
    Hn = Hp / torch.diagonal(Hp).max()
    if unbiased and uniforms is None:
        shape = (Wp.shape[1] // blocksize, blocksize, Wp.shape[0])
        uniforms = lambda ip: _uniform(  # noqa: E731
            gen, shape, Wp, "unbiased allbal")
    # the reference starts w_hat at the continuous weights
    # (vector_balance.py:54), so pass 1 never takes the fixed-point exit
    What = _greedy_passes(Wp, torch.zeros_like(Wp), Hn, maxq, npasses,
                          blocksize, reverse=False, w_hat0=Wp,
                          uniforms=uniforms if unbiased else None)
    return What[:, :d0]


def _permute_wh(Wg, H, p):
    return Wg[:, p], H[p][:, p]


def _sorted(Wg, H, descending: bool, solve) -> torch.Tensor:
    """``solve`` on (W, H) with the columns sorted by diag(H) (stable, as
    jnp.argsort), then the columns put back."""
    diag = torch.diagonal(H)
    p = torch.argsort(-diag if descending else diag, stable=True)
    Wp, Hp = _permute_wh(Wg, H, p)
    return solve(Wp, Hp)[:, torch.argsort(p, stable=True)]


def round_ldlqRG(Wg: torch.Tensor, H: torch.Tensor, bits: int,
                 n_greedy_passes: int = 9, unbiased: bool = False,
                 gen: Optional[torch.Generator] = None,
                 blocksize: int = 128,
                 eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LDLQ with the columns sorted by ascending diag(H), plus greedy
    passes (vector_balance.py:139-152, 202-215). ``eta`` is the dither in
    the sorted (and padded) order."""
    return _sorted(Wg, H, False, lambda W, Hs: round_ldl(
        W, Hs, bits, n_greedy_passes, unbiased, gen, blocksize, eta))


def round_allbal_sorted(Wg: torch.Tensor, H: torch.Tensor, bits: int,
                        npasses: int, unbiased: bool = False,
                        gen: Optional[torch.Generator] = None,
                        blocksize: int = 128,
                        uniforms: Optional[Uniforms] = None
                        ) -> torch.Tensor:
    """'allbal' with the columns sorted by descending diag(H), as
    round_vecbal_Hsort dispatches it (vector_balance.py:476-496)."""
    return _sorted(Wg, H, True, lambda W, Hs: round_allbal(
        W, Hs, bits, npasses, unbiased, gen, blocksize, uniforms))


# ---------------------------------------------------------------------------
# LDL-ADMM variant (vector_balance.py:293-378)
# ---------------------------------------------------------------------------


def _strict_lower(n: int, like: torch.Tensor) -> torch.Tensor:
    """M[i, j] = 1 where j < i."""
    idx = torch.arange(n, device=like.device)
    return (idx[None, :] < idx[:, None]).to(like.dtype)


def ldlp_admm(H: torch.Tensor, rho: float = 0.1,
              niters: int = 100) -> torch.Tensor:
    """ADMM solve for a strictly-lower feedback matrix Z minimizing
    tr((Z+I) H (Z+I)ᵀ) under unit column-norm constraints
    (vector_balance.py:308-324): ``niters`` iterations of two d³
    products."""
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Linv = torch.linalg.inv(_cholesky(2 * H + rho * eye, "ldlp_admm"))
    LinvT = Linv.t()
    M = _strict_lower(n, H)
    MH = M * H
    X = Z = W = torch.zeros_like(H)
    for _ in range(niters):
        X = (((rho * Z - rho * W - 2 * MH) @ LinvT) * M) @ Linv
        Y = X + W
        colnorm = torch.sqrt(torch.diagonal(Y.t() @ Y))
        Z = Y * (1.0 / torch.clamp(colnorm, min=1.0))[None, :]
        W = W + X - Z
    return Z


def round_ldl_admm(Wg: torch.Tensor, H: torch.Tensor, bits: int,
                   n_greedy_passes: int = 9, unbiased: bool = False,
                   gen: Optional[torch.Generator] = None,
                   admm_iters: int = 100,
                   eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-point rounding with the ADMM feedback matrix, then
    triangle-greedy passes (vector_balance.py:326-378). The fixed-point
    and each inner triangle loop stop on convergence or after d
    iterations; the outer loop after ``n_greedy_passes`` or when an inner
    loop converges at once (vector_balance.py:373-375)."""
    maxq = float(2 ** bits - 1)
    d = Wg.shape[1]
    Hn = H / torch.diagonal(H).max()
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    L = torch.linalg.inv(ldlp_admm(Hn, niters=admm_iters) + eye)
    if not unbiased:
        eta = torch.full_like(Wg, 0.5)
    elif eta is None:
        eta = _uniform(gen, Wg.shape, Wg, "unbiased rounding")

    wr = torch.floor(Wg + eta)
    for _ in range(d):
        w_next = torch.clamp(torch.floor(wr - (wr - Wg) @ L + eta), 0, maxq)
        done = bool(torch.equal(w_next, wr))
        wr = w_next
        if done:
            break

    Hd = Hn * (1.0 / torch.diagonal(Hn))[None, :]
    M = _strict_lower(d, H)
    HnM = Hd * M
    HdMT = Hd * M.t()
    for _ in range(n_greedy_passes):
        target = Wg + (Wg - wr) @ HdMT
        n_inner = 0
        while n_inner < d:
            w_new = torch.clamp(torch.round(target + (Wg - wr) @ HnM), 0,
                                maxq)
            n_inner += 1
            done = bool(torch.equal(w_new, wr))
            wr = w_new
            if done:
                break
        if n_inner <= 1:
            break
    return wr


def round_ldl_admm_sorted(Wg, H, bits, n_greedy_passes=9, unbiased=False,
                          gen=None, eta=None):
    """Ascending diag(H) sort around round_ldl_admm
    (vector_balance.py:293-306); ``eta`` in the sorted order."""
    return _sorted(Wg, H, False, lambda W, Hs: round_ldl_admm(
        W, Hs, bits, n_greedy_passes, unbiased, gen, eta=eta))


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
