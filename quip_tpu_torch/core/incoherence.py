"""Incoherence processing: random orthogonal butterflies and the
randomized Hadamard/Kronecker transform (RHT).

Port of ``quip_tpu.core.incoherence`` (reference method.py:16-78):

  * Butterflies (modes 'block', 'noblock', 'nopermute'; reference
    ``preproc_proj_extra`` 0/1/2): x -> P_out B_k ... B_0 P_in x, with n
    split into alternating prime factors and each stage a batched product
    of random SO(p) blocks on a reshape (per-block blocks, or one shared
    block a stage for 'noblock'); P_in / P_out random permutations (none
    for 'nopermute'). Never a dense n² product unless materialised.
  * RHT (modes 'rht', 'rht_sf', 'rht_uf'): T = (H_{2^k} ⊗ O_r) · diag(s),
    with H a normalized Hadamard, O_r a random orthogonal for the odd part
    r of n = 2^k · r, and s random ±1 signs. Application is one elementwise
    multiply plus two small dense matmuls on an (a, b) reshape.

RNG decision: threefry is NOT ported. ``jax.random`` and ``torch.Generator``
give different numbers from the same seed, so models made by the JAX
package (and the parity tests) carry their materialised rotation arrays
(``PackedLinear.rot``: signs / left / right) across as they are, and the
port's own model constructor (models/build.py) draws fresh rotations
from an explicit
``torch.Generator``. A JAX ``proj_key`` cannot be regenerated here. The
port's quantizer draws each linear's (U, V) from a generator seeded with
the run's seed and the linear's ``name_salt`` (quantize/driver.py), and
the drawn transforms travel with the result (core/hessian.PreprocState).
Butterflies follow the same rule: their SO(p) blocks and permutations are
drawn from the generator (``gen_butterfly``), or handed across as quip_tpu
materialised them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


# the proj_modes whose rotation pair is an RHT, and the butterfly ones
RHT_MODES = ("rht", "rht_sf", "rht_uf")
BUTTERFLY_MODES = ("block", "noblock", "nopermute")


def is_butterfly(mode: str) -> bool:
    """Whether ``mode`` rotates by butterflies (else by RHTs); ValueError
    for a proj_mode that is none of the six known."""
    if mode not in RHT_MODES + BUTTERFLY_MODES:
        raise ValueError(f"unknown proj_mode: {mode}")
    return mode in BUTTERFLY_MODES


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
    return q.to(dtype=dtype, device=device).contiguous()   # qr: col-major


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


def materialize_rht(t: RHT, dtype=torch.float32) -> torch.Tensor:
    """Dense n x n matrix of T (tests / small dims)."""
    eye = torch.eye(t.n, dtype=dtype, device=t.left.device)
    return apply_rht(t, eye, axis=0)


# ---------------------------------------------------------------------------
# Two-sided weight / Hessian rotations of incoherence preprocessing
# (reference method.py:175-176: w -> U w Vᵀ, H -> V H Vᵀ)
# ---------------------------------------------------------------------------


def rht_rotate_weight(u: RHT, v: RHT, w: torch.Tensor) -> torch.Tensor:
    """w -> U w Vᵀ."""
    w = apply_rht(u, w, axis=0)
    return apply_rht(v, w, axis=1)


def rht_rotate_hessian(v: RHT, H: torch.Tensor) -> torch.Tensor:
    """H -> V H Vᵀ."""
    H = apply_rht(v, H, axis=0)
    return apply_rht(v, H, axis=1)


def rht_unrotate_weight(u: RHT, v: RHT, w: torch.Tensor) -> torch.Tensor:
    """w -> Uᵀ w V (the exact inverse of rht_rotate_weight)."""
    w = apply_rht(u, w, axis=0, transpose=True)
    return apply_rht(v, w, axis=1, transpose=True)


def rht_unrotate_hessian(v: RHT, H: torch.Tensor) -> torch.Tensor:
    H = apply_rht(v, H, axis=0, transpose=True)
    return apply_rht(v, H, axis=1, transpose=True)


# ---------------------------------------------------------------------------
# Outer-sign RHT (proj_mode 'rht_sf', the sign-folded serving format):
# T = diag(s) · (L ⊗ R), signs in the rotated basis, so they fold into the
# packed qfn-b codes (c -> maxq - c negates exactly) and serving runs the
# pure Kronecker map. 'rht_uf' keeps the V side inner and moves only the
# U-side signs outer (they fold into the code rows).
# ---------------------------------------------------------------------------


def _nosign(t: RHT) -> RHT:
    return t._replace(signs=None)


def rht_rotate_weight_outer(u: RHT, v: RHT, w: torch.Tensor) -> torch.Tensor:
    """w -> U w Vᵀ with U = diag(s_u)·K_u, V = diag(s_v)·K_v."""
    w = apply_rht(_nosign(u), w, axis=0)
    w = apply_rht(_nosign(v), w, axis=1)
    return (w * u.signs.to(w.dtype)[:, None]) * v.signs.to(w.dtype)[None, :]


def rht_unrotate_weight_outer(u: RHT, v: RHT, w: torch.Tensor) -> torch.Tensor:
    w = (w * u.signs.to(w.dtype)[:, None]) * v.signs.to(w.dtype)[None, :]
    w = apply_rht(_nosign(u), w, axis=0, transpose=True)
    return apply_rht(_nosign(v), w, axis=1, transpose=True)


def rht_rotate_weight_uf(u: RHT, v: RHT, w: torch.Tensor) -> torch.Tensor:
    """Hybrid ('rht_uf'): U outer (diag(s_u)·K_u), V inner (K_v·diag(s_v))."""
    w = apply_rht(v, w, axis=1)
    w = apply_rht(_nosign(u), w, axis=0)
    return w * u.signs.to(w.dtype)[:, None]


def rht_unrotate_weight_uf(u: RHT, v: RHT, w: torch.Tensor) -> torch.Tensor:
    w = w * u.signs.to(w.dtype)[:, None]
    w = apply_rht(_nosign(u), w, axis=0, transpose=True)
    return apply_rht(v, w, axis=1, transpose=True)


def rht_rotate_hessian_outer(v: RHT, H: torch.Tensor) -> torch.Tensor:
    """H -> V H Vᵀ = diag(s_v) K_v H K_vᵀ diag(s_v)."""
    H = apply_rht(_nosign(v), H, axis=0)
    H = apply_rht(_nosign(v), H, axis=1)
    s = v.signs.to(H.dtype)
    return (H * s[:, None]) * s[None, :]


def rht_unrotate_hessian_outer(v: RHT, H: torch.Tensor) -> torch.Tensor:
    s = v.signs.to(H.dtype)
    H = (H * s[:, None]) * s[None, :]
    H = apply_rht(_nosign(v), H, axis=0, transpose=True)
    return apply_rht(_nosign(v), H, axis=1, transpose=True)


# ---------------------------------------------------------------------------
# Random orthogonal butterflies (reference method.py:16-78)
# ---------------------------------------------------------------------------


def prime_factors(n: int) -> list:
    """Prime factorization by trial division."""
    fs = []
    x = n
    p = 2
    while p * p <= x:
        while x % p == 0:
            fs.append(p)
            x //= p
        p += 1 if p == 2 else 2
    if x > 1:
        fs.append(x)
    return fs


def butterfly_factors(n: int) -> Tuple[int, int]:
    """Split n = p * q by alternating prime factors (method.py:16-18)."""
    pf = prime_factors(n)
    return math.prod(pf[0::2]), math.prod(pf[1::2])


class Butterfly(NamedTuple):
    """A random orthogonal butterfly of dimension n.

    blocks[i] is (n_blocks_i, p_i, p_i) with n_blocks_i 1 ('noblock': one
    block shared by the stage) or n // p_i. perm_in / perm_out are int
    index vectors of length n, or None ('nopermute'). inv_in / inv_out are
    their inverses (argsort), given where the caller keeps them (a packed
    layer derives them once at construction) so the transposed application
    runs no argsort; None derives them at the call."""

    blocks: Tuple[torch.Tensor, ...]
    perm_in: Optional[torch.Tensor]
    perm_out: Optional[torch.Tensor]
    n: int
    inv_in: Optional[torch.Tensor] = None
    inv_out: Optional[torch.Tensor] = None

    @property
    def factors(self) -> Tuple[int, ...]:
        return tuple(b.shape[-1] for b in self.blocks)


def gen_butterfly(gen: torch.Generator, n: int, mode: str = "noblock",
                  dtype=torch.float32, device=None) -> Butterfly:
    """A random butterfly of dimension n drawn from ``gen``
    (method.py:33-43): one SO(p) draw a factor (f32, then cast), then the
    two permutations (int32; torch.randperm) unless 'nopermute'."""
    if mode not in BUTTERFLY_MODES:
        raise ValueError(f"unknown butterfly mode: {mode}")
    facs = tuple(f for f in butterfly_factors(n) if f > 1) or (1,)
    blocks = tuple(
        random_orthogonal(gen, p, 1 if mode == "noblock" else n // p,
                          dtype, device) for p in facs)
    if mode == "nopermute":
        return Butterfly(blocks, None, None, n)
    perm = lambda: torch.randperm(  # noqa: E731
        n, generator=gen, device=gen.device).to(torch.int32).to(device)
    return Butterfly(blocks, perm(), perm(), n)


def inverse_perm(perm: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The index vector that undoes x -> x[perm], as a gather index."""
    return None if perm is None else torch.argsort(perm)


def _apply_factor(x: torch.Tensor, Bi: torch.Tensor, mpfx: int, p: int,
                  msfx: int, transpose: bool) -> torch.Tensor:
    """One butterfly stage on the leading axis of (n, q) x
    (method.py:57-63). The stage's blocks are cast to x's dtype here, as
    quip_tpu casts them per call (no second copy is kept)."""
    n, q = x.shape
    x = x.reshape(mpfx, p, msfx, q).transpose(1, 2).reshape(
        mpfx * msfx, p, q)
    B = Bi.to(x.dtype)
    if transpose:
        B = B.transpose(-1, -2)
    x = torch.matmul(B[0], x) if B.shape[0] == 1 else torch.bmm(B, x)
    return x.reshape(mpfx, msfx, p, q).transpose(1, 2).reshape(n, q)


def _inv_permute(x: torch.Tensor, perm: torch.Tensor,
                 inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse of x -> x[perm] as a gather by the inverse index."""
    return x.index_select(0, inverse_perm(perm) if inv is None else inv)


def apply_butterfly(bf: Butterfly, x: torch.Tensor, axis: int = 0,
                    transpose: bool = False) -> torch.Tensor:
    """y = B x along ``axis``, or Bᵀ x (the exact inverse) with
    ``transpose``: x -> P_out B_k ... B_0 P_in x (mul_ortho_butterfly,
    method.py:46-67)."""
    x = torch.movedim(x, axis, 0)
    lead = x.shape[0]
    if lead != bf.n:
        raise ValueError(f"butterfly dim {bf.n} != axis size {lead}")
    tail = x.shape[1:]
    x = x.reshape(lead, -1)
    facs = bf.factors
    sizes = [(math.prod(facs[:i]), facs[i], math.prod(facs[i + 1:]))
             for i in range(len(facs))]
    if not transpose:
        if bf.perm_in is not None:
            x = x.index_select(0, bf.perm_in)
        for Bi, (mpfx, p, msfx) in zip(bf.blocks, sizes):
            x = _apply_factor(x, Bi, mpfx, p, msfx, False)
        if bf.perm_out is not None:
            x = x.index_select(0, bf.perm_out)
    else:
        # (P_out B_k .. B_0 P_in)ᵀ = P_inᵀ B_0ᵀ .. B_kᵀ P_outᵀ
        if bf.perm_out is not None:
            x = _inv_permute(x, bf.perm_out, bf.inv_out)
        for Bi, (mpfx, p, msfx) in zip(reversed(bf.blocks),
                                       reversed(sizes)):
            x = _apply_factor(x, Bi, mpfx, p, msfx, True)
        if bf.perm_in is not None:
            x = _inv_permute(x, bf.perm_in, bf.inv_in)
    return torch.movedim(x.reshape((lead,) + tail), 0, axis)


def materialize(bf: Butterfly, dtype=torch.float32) -> torch.Tensor:
    """The dense n x n matrix (method.py:71-78), for tests / small dims."""
    eye = torch.eye(bf.n, dtype=dtype, device=bf.blocks[0].device)
    return apply_butterfly(bf, eye, axis=0)


def rotate_weight(u: Butterfly, v: Butterfly, w: torch.Tensor
                  ) -> torch.Tensor:
    """w -> U w Vᵀ (a butterfly along axis 1 computes w @ Bᵀ)."""
    return apply_butterfly(v, apply_butterfly(u, w, axis=0), axis=1)


def rotate_hessian(v: Butterfly, H: torch.Tensor) -> torch.Tensor:
    """H -> V H Vᵀ."""
    return apply_butterfly(v, apply_butterfly(v, H, axis=0), axis=1)


def unrotate_weight(u: Butterfly, v: Butterfly, w: torch.Tensor
                    ) -> torch.Tensor:
    """w -> Uᵀ w V (the exact inverse of rotate_weight; method.py:202)."""
    w = apply_butterfly(u, w, axis=0, transpose=True)
    return apply_butterfly(v, w, axis=1, transpose=True)


def unrotate_hessian(v: Butterfly, H: torch.Tensor) -> torch.Tensor:
    """H -> Vᵀ H V (method.py:203)."""
    H = apply_butterfly(v, H, axis=0, transpose=True)
    return apply_butterfly(v, H, axis=1, transpose=True)


def transform_to(t, device):
    """An RHT or a butterfly with every tensor moved to ``device``."""
    mv = lambda x: None if x is None else x.to(device)  # noqa: E731
    if isinstance(t, Butterfly):
        return Butterfly(tuple(mv(b) for b in t.blocks), mv(t.perm_in),
                         mv(t.perm_out), t.n, mv(t.inv_in), mv(t.inv_out))
    return RHT(mv(t.signs), mv(t.left), mv(t.right), t.n)


def gen_pair(gen: torch.Generator, m: int, d: int, mode: str = "rht",
             dtype=torch.float32, device=None):
    """A rotation pair (U over m, V over d) of ``mode`` drawn from
    ``gen``: RHTs, or butterflies for the butterfly modes."""
    if is_butterfly(mode):
        return (gen_butterfly(gen, m, mode, dtype, device),
                gen_butterfly(gen, d, mode, dtype, device))
    return gen_rht(gen, m, dtype, device), gen_rht(gen, d, dtype, device)
