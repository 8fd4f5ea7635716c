"""OPTQ/GPTQ adaptive rounding, blocked.

Port of ``quip_tpu/core/gptq.py`` (reference gptq.py:17-116): per-column
quantize with error feedback through the upper Cholesky factor of H⁻¹,
128-column blocks with lazy tail updates (one matmul a block). LDLQ with
flipped order is the same algorithm (core/ldlq.round_ldl_gptqequiv).

Per-row grids only: the grouped variant (``groupsize != -1``) and
TrueOBS's full-precision outlier escape (``sparse_outlier > 0``) are not
ported yet (ROADMAP queue 1 item 8) and raise.
"""
from __future__ import annotations

import torch

from quip_tpu_torch.core.grid import GridParams, qfnb_scale
from quip_tpu_torch.core.ldlq import _cholesky


def cholesky_inv_upper(H: torch.Tensor) -> torch.Tensor:
    """U upper-triangular with H⁻¹ = Uᵀ U (gptq.py:51-54): H⁻¹ by a
    Cholesky solve, symmetrized, then U = chol(H⁻¹)ᵀ. Raises if either
    factorization fails."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    C = _cholesky(H, "cholesky_inv_upper (H)")
    Hinv = torch.cholesky_solve(eye, C)
    Hinv = (Hinv + Hinv.t()) / 2
    return _cholesky(Hinv, "cholesky_inv_upper (H^-1)").t()


def _quantize_col(w, grid: GridParams, qfn: str):
    """Quantize one column (m,) with per-row grid params: qfn 'a'
    round-then-clamp (quant.py:6-8), 'c' clamp-then-round (quant.py:17-21),
    'b' the symmetric RMS grid of the column itself (quant.py:148-151)."""
    scale = grid.scale[:, 0]
    zero = grid.zero[:, 0]
    maxq = grid.maxq
    if qfn == "a":
        q = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
        return scale * (q - zero)
    if qfn == "c":
        q = torch.round(torch.clamp(w / scale + zero, 0, maxq))
        return scale * (q - zero)
    if qfn == "b":
        s = qfnb_scale(w)
        q = torch.clamp(torch.round(((w / s + 1) / 2) * maxq), 0, maxq)
        return ((q / maxq) * 2 - 1) * s
    raise ValueError(f"unknown qfn {qfn!r}")


def gptq_round(W: torch.Tensor, H: torch.Tensor, grid: GridParams,
               qfn: str = "a", blocksize: int = 128, groupsize: int = -1,
               sparse_outlier: float = 0.0) -> torch.Tensor:
    """OPTQ rounding. W (m, d) in the original weight domain; returns the
    quantized (still dense) weights."""
    if groupsize != -1:
        raise NotImplementedError(
            "gptq_round: grouped grids (groupsize != -1) are not ported yet "
            "(ROADMAP queue 1 item 8)")
    if sparse_outlier > 0:
        raise NotImplementedError(
            "gptq_round: TrueOBS's outlier escape (sparse_outlier > 0) is "
            "not ported yet (ROADMAP queue 1 item 8)")
    m, d = W.shape
    B = blocksize
    dp = -(-d // B) * B
    if dp != d:
        # pad H with identity: the padded columns quantize to values that
        # are discarded and feed back zero error (their Hinv rows are e_i)
        Hp = torch.eye(dp, dtype=H.dtype, device=H.device)
        Hp[:d, :d] = H
        Wp = torch.nn.functional.pad(W, (0, dp - d))
    else:
        Hp, Wp = H, W
    U = cholesky_inv_upper(Hp)
    Wc = Wp.clone()
    for st in range(0, dp, B):
        en = st + B
        W1 = Wc[:, st:en].clone()
        Err1 = torch.zeros_like(W1)
        Ublk = U[st:en, st:en]
        for i in range(B):
            w = W1[:, i].clone()
            q = _quantize_col(w, grid, qfn)
            err = (w - q) / Ublk[i, i]
            W1[:, i:] -= err[:, None] * Ublk[i, i:][None, :]
            W1[:, i] = q
            Err1[:, i] = err
        # lazy tail update (gptq.py:90): W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]
        Wc[:, en:] -= Err1 @ U[st:en, en:]
        Wc[:, st:en] = W1
    return Wc[:, :d]
