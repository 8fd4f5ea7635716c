"""OPTQ/GPTQ adaptive rounding, blocked.

Port of ``quip_tpu/core/gptq.py`` (reference gptq.py:17-116): per-column
quantize with error feedback through the upper Cholesky factor of H⁻¹,
128-column blocks with lazy tail updates (one matmul a block). LDLQ with
flipped order is the same algorithm (core/ldlq.round_ldl_gptqequiv).

Also the grouped variant (``groupsize != -1``: the qfn-a grid re-derived
from the live, error-fed weights of each column's group, gptq.py:70-74)
and TrueOBS's full-precision outlier escape (``sparse_outlier > 0``,
zeroShot/models/fast_trueobs.py:108, 134-139).
"""
from __future__ import annotations

import torch

from quip_tpu_torch.core.grid import GridParams, find_params_qfna, qfnb_scale
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
    quantized (still dense) weights.

    ``groupsize != -1`` re-derives the grid from the current weights of
    each column's group (``_gptq_round_grouped``; as in quip_tpu, the
    outlier escape does not apply there). ``sparse_outlier > 0`` keeps at
    full precision the entries whose squared rounding error exceeds
    ``sparse_outlier * scale²`` (a mixed sparse + quantized layer; the
    reference uses 0.25)."""
    if groupsize != -1:
        return _gptq_round_grouped(W, H, grid, qfn, groupsize)
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
            if sparse_outlier > 0:
                # TrueOBS escape: keep fp weights with large rounding error
                keep = torch.square(w - q) > \
                    sparse_outlier * torch.square(grid.scale[:, 0])
                q = torch.where(keep, w, q)
            err = (w - q) / Ublk[i, i]
            W1[:, i:] -= err[:, None] * Ublk[i, i:][None, :]
            W1[:, i] = q
            Err1[:, i] = err
        # lazy tail update (gptq.py:90): W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]
        Wc[:, en:] -= Err1 @ U[st:en, en:]
        Wc[:, st:en] = W1
    return Wc[:, :d]


def _gptq_round_grouped(W, H, grid, qfn, groupsize):
    """Grouped OPTQ, column by column: before each column the qfn-a grid
    is found again over the live weights of its group (already quantized
    columns included, as quip_tpu's scan does; gptq.py:70-74)."""
    m, d = W.shape
    if d % groupsize:
        raise ValueError(f"groupsize {groupsize} must divide d={d}")
    U = cholesky_inv_upper(H)
    Wc = W.to(H.dtype).clone()
    for i in range(d):
        g0 = (i // groupsize) * groupsize
        g = find_params_qfna(Wc[:, g0:g0 + groupsize], grid.bits,
                             perchannel=True, sym=False)
        w = Wc[:, i].clone()
        q = _quantize_col(w, g, qfn)
        err = (w - q) / U[i, i]
        Wc[:, i + 1:] -= err[:, None] * U[i, i + 1:][None, :]
        Wc[:, i] = q
    return Wc
