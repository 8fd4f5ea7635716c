"""Randomized Hadamard/Kronecker transform (RHT) for incoherence processing.

Port of the RHT half of ``quip_tpu.core.incoherence``:
T = (H_{2^k} ⊗ O_r) · diag(s), with H a normalized Hadamard, O_r a random
orthogonal for the odd part r of n = 2^k · r, and s random ±1 signs.
Application is one elementwise multiply plus two small dense matmuls on a
(a, b) reshape.

RNG decision: threefry is NOT ported. ``jax.random`` and ``torch.Generator``
give different numbers from the same seed, so models made by the JAX
package (and the parity tests) carry their materialised rotation arrays
(``PackedLinear.rot``: signs / left / right) across as they are, and the
port's own model constructor (models/build.py) draws fresh rotations
from an explicit
``torch.Generator``. A JAX ``proj_key`` cannot be regenerated here.

The butterfly modes (``apply_butterfly`` / ``gen_butterfly``) wait for a
later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class RHT(NamedTuple):
    """Randomized Hadamard/Kronecker transform of dimension n = a * b."""

    signs: Optional[torch.Tensor]   # (n,) ±1, or None (sign-folded modes)
    left: torch.Tensor              # (a, a) orthogonal (normalized Hadamard)
    right: Optional[torch.Tensor]   # (b, b) orthogonal, or None when b == 1
    n: int

    @property
    def a(self) -> int:
        return self.left.shape[0]

    @property
    def b(self) -> int:
        return self.n // self.left.shape[0]


def _hadamard(k: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized H_{2^k} (orthogonal)."""
    H = torch.ones((1, 1), dtype=dtype, device=device)
    base = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=dtype, device=device)
    for _ in range(k):
        H = torch.kron(base, H)
    return H / math.sqrt(2.0 ** k)


def _pow2_split(n: int) -> Tuple[int, int]:
    """n = a * b with a a power of two chosen near sqrt(n), so both
    Kronecker factors stay small (12288 -> 128 x 96, 11008 -> 128 x 86)."""
    k = 0
    m = n
    while m % 2 == 0:
        m //= 2
        k += 1
    ka = min(k, max(1, round(math.log2(math.sqrt(n)))))
    return 2 ** ka, (2 ** (k - ka)) * m


def random_orthogonal(gen: torch.Generator, p: int, size: int,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """(size, p, p) Haar-random special-orthogonal matrices.

    p == 2: rotation by U[0, 2π). General p: QR of a Gaussian with the
    R-diagonal sign correction (Haar on O(p)), then a last-column flip
    where det < 0 (SO(p)). Sampled in float32 on the generator's device and
    cast, so one generator state gives the same rotation at every dtype."""
    gdev = gen.device
    if p == 2:
        t = torch.rand((size,), generator=gen, device=gdev) * (2 * math.pi)
        c, s = torch.cos(t), torch.sin(t)
        out = torch.stack([torch.stack([c, s], -1),
                           torch.stack([-s, c], -1)], -2)
        return out.to(dtype=dtype, device=device)
    g = torch.randn((size, p, p), generator=gen, device=gdev)
    q, r = torch.linalg.qr(g)
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    q = q * sign[:, None, :]
    flip = torch.where(torch.linalg.det(q) < 0, -1.0, 1.0)
    q[:, :, -1] *= flip[:, None]
    return q.to(dtype=dtype, device=device)


def gen_rht(gen: torch.Generator, n: int, dtype=torch.float32,
            device=None) -> RHT:
    """Random RHT of dimension n drawn from ``gen`` (not the JAX keyed
    transform: see the module docstring)."""
    a, b = _pow2_split(n)
    bits = torch.randint(0, 2, (n,), generator=gen, device=gen.device)
    signs = (bits * 2 - 1).to(dtype=dtype, device=device)
    left = _hadamard(int(math.log2(a)), dtype, device)
    if b == 1:
        right = None
    elif b & (b - 1) == 0:
        right = _hadamard(int(math.log2(b)), dtype, device)
    else:
        right = random_orthogonal(gen, b, 1, dtype, device)[0]
    return RHT(signs, left, right, n)


def apply_rht(t: RHT, x: torch.Tensor, axis: int = 0,
              transpose: bool = False) -> torch.Tensor:
    """y = T x (or Tᵀ x) along ``axis``; Tᵀ is the exact inverse.

    ``t.signs is None`` skips the sign multiply (the pure-Kronecker map of
    the sign-folded modes)."""
    x = torch.movedim(x, axis, -1)
    lead = x.shape[:-1]
    assert x.shape[-1] == t.n, (x.shape, t.n)
    a, b = t.a, t.b
    L = t.left.to(x.dtype)
    R = t.right.to(x.dtype) if t.right is not None else None
    s = t.signs.to(x.dtype) if t.signs is not None else None

    if not transpose:
        if s is not None:
            x = x * s
        x = x.reshape(*lead, a, b)
        x = torch.matmul(L, x)                     # "pa,...ab->...pb"
        if R is not None:
            x = torch.matmul(x, R.t())             # "qb,...ab->...aq"
        x = x.reshape(*lead, t.n)
    else:
        x = x.reshape(*lead, a, b)
        x = torch.matmul(L.t(), x)                 # Lᵀ on the a axis
        if R is not None:
            x = torch.matmul(x, R)                 # Rᵀ on the b axis
        x = x.reshape(*lead, t.n)
        if s is not None:
            x = x * s
    return torch.movedim(x, -1, axis)
