"""Proxy-Hessian accumulation and the incoherence pre/post-processing.

Port of ``quip_tpu/core/hessian.py`` (reference method.py:80-233) as plain
functions over (W, H):

  * accumulation: H = E[x xᵀ] over calibration tokens in float32 (the
    reference uses float64, method.py:94, 119); ``HessianAccumulator`` adds
    Kahan compensation. Products run with TF32 off (utils.f32_matmuls).
  * preproc (method.py:125-193): (a) diagonal rescale, (b) random
    orthogonal rotation, (c) GPTQ damping.
  * postproc (method.py:195-214): the exact inverse, un-rotate then
    un-scale.

Where quip_tpu's inverse state holds a PRNG key that regenerates U and V,
the port's ``PreprocState`` holds the drawn transforms themselves (the RNG
decision in core/incoherence.py): an RHT pair for the 'rht*' modes, a
butterfly pair for 'block' / 'noblock' / 'nopermute'.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.utils import f32_matmuls


class HessianAccumulator(NamedTuple):
    """Kahan-compensated fp32 running sum of xᵀx plus the number of
    sequences added (method.py:98-123 semantics: sum over tokens, divide by
    sequences)."""

    H: torch.Tensor       # (d, d) running sum
    comp: torch.Tensor    # (d, d) Kahan compensation term
    nsamples: int

    @staticmethod
    def init(d: int, dtype=torch.float32, device=None) -> "HessianAccumulator":
        z = torch.zeros((d, d), dtype=dtype, device=device)
        return HessianAccumulator(z, z, 0)

    def add_batch(self, x: torch.Tensor) -> "HessianAccumulator":
        """x: (batch, seq, d) or (tokens, d); each leading batch element
        counts as one sample (method.py:104, 118)."""
        if x.dim() == 2:
            nseq, xt = 1, x
        else:
            nseq, xt = x.shape[0], x.reshape(-1, x.shape[-1])
        xt = xt.to(self.H.dtype)
        with f32_matmuls():
            update = xt.t() @ xt
        y = update - self.comp
        t = self.H + y
        comp = (t - self.H) - y
        return HessianAccumulator(t, comp, self.nsamples + nseq)

    def finalize(self, dtype=torch.float32) -> torch.Tensor:
        """H / nsamples (method.py:122-123)."""
        return (self.H / self.nsamples).to(dtype)


def accumulate_hessian(x: torch.Tensor,
                       H: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-shot H += xᵀ x (leading dims flattened), in true f32 for f32 x."""
    xt = x.reshape(-1, x.shape[-1])
    with f32_matmuls():
        up = xt.t() @ xt
    return up if H is None else H + up


# ---------------------------------------------------------------------------
# Preprocessing pipeline
# ---------------------------------------------------------------------------


Transform = Union[inc.RHT, inc.Butterfly]


class PreprocState(NamedTuple):
    """Everything needed to invert preprocessing: the diagonal rescale and
    the drawn rotation pair (U, V), or None for each step not taken."""

    scaleWH: Optional[torch.Tensor]   # (d,) diagonal rescale
    U: Optional[Transform]            # (rows) side transform
    V: Optional[Transform]            # (cols) side transform
    proj_mode: str
    rows: int
    cols: int


def preproc_rescale(W: torch.Tensor, H: torch.Tensor):
    """Diagonal rescale (method.py:139-156): H /= max|H|;
    scaleWH = (diag(H)/diag(WᵀW))^(1/4); W *= s, H -> S⁻¹HS⁻¹.
    Returns (W', H', scaleWH)."""
    W = W.to(torch.promote_types(W.dtype, torch.float32))
    H = H / H.abs().max()
    diagH = torch.clamp(torch.diagonal(H), min=1e-8)
    diagW2 = torch.clamp(torch.sum(W * W, dim=0), min=1e-8)
    scaleWH = torch.clamp(torch.sqrt(torch.sqrt(diagH / diagW2)), min=1e-8)
    W = W * scaleWH[None, :]
    H = H / scaleWH[None, :]
    H = H / scaleWH[:, None]
    return W, H, scaleWH


def preproc_proj(W: torch.Tensor, H: torch.Tensor, U: Transform,
                 V: Transform, mode: str = "rht"):
    """Random orthogonal rotation (method.py:157-180) by the given (U, V).

    H is trace-normalized and regularized first (method.py:173):
        H <- H * (d / (tr(H)+1e-8)) + 1e-2 I
    then W -> U W Vᵀ, H -> V H Vᵀ (butterflies and 'rht'), with the signs
    outer ('rht_sf') or outer on the U side only ('rht_uf')."""
    butterfly = inc.is_butterfly(mode)
    d = H.shape[0]
    H = H * (d / (torch.trace(H) + 1e-8)) \
        + 1e-2 * torch.eye(d, dtype=H.dtype, device=H.device)
    if butterfly:
        return inc.rotate_weight(U, V, W), inc.rotate_hessian(V, H)
    if mode == "rht_sf":
        return (inc.rht_rotate_weight_outer(U, V, W),
                inc.rht_rotate_hessian_outer(V, H))
    if mode == "rht_uf":
        return inc.rht_rotate_weight_uf(U, V, W), inc.rht_rotate_hessian(V, H)
    return inc.rht_rotate_weight(U, V, W), inc.rht_rotate_hessian(V, H)


def preproc_gptqH(W: torch.Tensor, H: torch.Tensor, percdamp: float = 0.01):
    """Dead-column zeroing + diagonal damping (method.py:182-192)."""
    diag = torch.diagonal(H)
    dead = diag == 0
    H = H.clone()
    H.diagonal().copy_(torch.where(dead, 1.0, diag))
    W = torch.where(dead[None, :], 0.0, W)
    damp = percdamp * torch.mean(torch.diagonal(H))
    H.diagonal().add_(damp)
    return W, H


def preproc(W: torch.Tensor, H: torch.Tensor, *, rescale: bool = False,
            proj: bool = False,
            rot: Optional[Tuple[Transform, Transform]] = None,
            proj_mode: str = "rht", gptqH: bool = False,
            percdamp: float = 0.01
            ) -> Tuple[torch.Tensor, torch.Tensor, PreprocState]:
    """Full preprocessing chain, reference order: rescale -> proj -> gptqH
    (method.py:125-193). ``rot`` is the drawn (U, V) pair that ``proj``
    applies."""
    rows, cols = W.shape
    scaleWH = None
    U = V = None
    if rescale:
        W, H, scaleWH = preproc_rescale(W, H)
    if proj:
        if rot is None:
            raise ValueError("preproc proj requires the rotation pair (U, V)")
        U, V = rot
        W, H = preproc_proj(W, H, U, V, proj_mode)
    if gptqH:
        W, H = preproc_gptqH(W, H, percdamp)
    return W, H, PreprocState(scaleWH, U, V, proj_mode, rows, cols)


def postproc(W: torch.Tensor, H: Optional[torch.Tensor],
             state: PreprocState):
    """Exact inverse of preproc: un-rotate then un-scale (method.py:195-214).
    The gptqH damping is not undone, as in the reference. ``H=None`` skips
    the Hessian's inverse (returned as None)."""
    if state.U is not None:
        U, V = state.U, state.V
        if inc.is_butterfly(state.proj_mode):
            W = inc.unrotate_weight(U, V, W)
            H = None if H is None else inc.unrotate_hessian(V, H)
        elif state.proj_mode == "rht_sf":
            W = inc.rht_unrotate_weight_outer(U, V, W)
            H = None if H is None else inc.rht_unrotate_hessian_outer(V, H)
        elif state.proj_mode == "rht_uf":
            W = inc.rht_unrotate_weight_uf(U, V, W)
            H = None if H is None else inc.rht_unrotate_hessian(V, H)
        else:
            W = inc.rht_unrotate_weight(U, V, W)
            H = None if H is None else inc.rht_unrotate_hessian(V, H)
    if state.scaleWH is not None:
        s = state.scaleWH.to(W.dtype)
        W = W / s[None, :]
        if H is not None:
            H = H * s[:, None]
            H = H * s[None, :]
    return W, H
