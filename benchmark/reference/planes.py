"""Dense weights from the raw tensors: the packed planes' codes, the qfn-b
grid and the randomized Hadamard transforms, by a frozen copy of the
arithmetic (not by calling the program).

A plane is int32 (nwords, m): word (j, i) holds the code of weight row i
for fan-in column c = k * (2 * nwords) + 2 * j + h at bit 16 * h + bits * k
(h in {0, 1}, k < 16 / bits). A code c in [0, 2^bits) stands for
((c / maxq) * 2 - 1) * scale_b, maxq = 2^bits - 1.

An RHT of size n = a * b is T = (L ⊗ R) · diag(s): s random signs, L the
normalised Hadamard matrix of size a (a the power of two nearest sqrt(n),
no larger than n's power-of-two part), R the normalised Hadamard matrix of
size b when b is a power of two, else a random orthogonal matrix drawn with
the weights. The served weight is Ŵ = T_uᵀ · W₂ · T_v, W₂ the grid
values.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def unpack(plane: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(nwords, m) int32 words -> (m, d) int64 codes."""
    fph = 16 // bits
    w = plane.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << bits) - 1
    fields = [[(w >> (16 * h + bits * k)) & mask for h in range(2)]
              for k in range(fph)]
    c = torch.stack([torch.stack(f, dim=1) for f in fields], dim=0)
    return c.reshape(d, plane.shape[-1]).t()


def grid_values(codes: torch.Tensor, bits: int, scale_b: float
                ) -> torch.Tensor:
    maxq = float(2 ** bits - 1)
    return ((codes.to(torch.float32) / maxq) * 2 - 1) * scale_b


def split(n: int) -> Tuple[int, int]:
    """n = a * b, a = 2^ka with ka = min(k, max(1, round(log2(sqrt(n))))),
    k the exponent of n's power-of-two part."""
    k, m = 0, n
    while m % 2 == 0:
        m //= 2
        k += 1
    ka = min(k, max(1, round(math.log2(math.sqrt(n)))))
    return 2 ** ka, (2 ** (k - ka)) * m


def hadamard(n: int, device=None) -> torch.Tensor:
    """Normalised Sylvester Hadamard matrix of size n (a power of two)."""
    H = torch.ones((1, 1), dtype=torch.float32, device=device)
    while H.shape[0] < n:
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return H / math.sqrt(n)


def factors(n: int, right: Optional[torch.Tensor], device=None):
    """(L, R) of an RHT of size n: R is ``right`` (the raw orthogonal
    factor) when b is not a power of two, a Hadamard matrix when it is,
    None when b == 1."""
    a, b = split(n)
    L = hadamard(a, device)
    if b == 1:
        return L, None
    if b & (b - 1) == 0:
        return L, hadamard(b, device)
    assert right is not None and right.shape == (b, b), (n, b)
    return L, right.to(device=device, dtype=torch.float32)


def apply_t(W: torch.Tensor, signs: torch.Tensor, L, R, axis: int
            ) -> torch.Tensor:
    """Tᵀ applied along ``axis`` of W: reshape that axis to (a, b), Lᵀ on
    a, Rᵀ on b (as X -> Lᵀ X R), then the signs."""
    W = torch.movedim(W, axis, -1)
    lead, n = W.shape[:-1], W.shape[-1]
    a = L.shape[0]
    X = W.reshape(*lead, a, n // a)
    X = torch.matmul(L.t(), X)
    if R is not None:
        X = torch.matmul(X, R)
    W = X.reshape(*lead, n) * signs.to(torch.float32)
    return torch.movedim(W, -1, axis)


def dense_weight(lin: dict, bits: int, scale_b: float, m: int, d: int
                 ) -> torch.Tensor:
    """The served (m, d) float32 weight of one raw packed linear: ``lin``
    holds ``plane`` (nwords, m_p), ``u_signs`` (m,), ``v_signs`` (d,) and
    ``u_right`` / ``v_right`` (the raw orthogonal factors, or None)."""
    dev = lin["plane"].device
    W = grid_values(unpack(lin["plane"], bits, d)[:m], bits, scale_b)
    Lu, Ru = factors(m, lin.get("u_right"), dev)
    Lv, Rv = factors(d, lin.get("v_right"), dev)
    W = apply_t(W, lin["u_signs"], Lu, Ru, axis=0)      # T_uᵀ W
    # W T_v: each row r -> T_vᵀ r
    return apply_t(W, lin["v_signs"], Lv, Rv, axis=1)
