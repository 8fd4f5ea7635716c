"""Quantized-linear forward: the incoherence-aware inference op.

Port of ``quip_tpu/ops/qlinear.py``. y = x @ Ŵᵀ with
Ŵ = Uᵀ Ŵ₂ V · diag(1/s) folded into the activation path:

    y = ((x / s) @ Vᵀ) @ Ŵ₂ᵀ @ U

Steps: V-side RHT (with the un-scale and V signs folded into one vector,
``rot['vin']``) -> packed dequant-matmul (kernels/dequant_matmul.py: the
CUDA kernel for CUDA tensors, its plain version on the CPU) -> U-side RHT.
The dense rotated weight is never built.

Modes 'rht', 'rht_sf' and 'rht_uf'. Rotations must be materialised
(``PackedLinear.rot``): the port does not regenerate JAX keys (see
core/incoherence.py).
"""
from __future__ import annotations

import torch

from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.kernels.dequant_matmul import dequant_matmul
from quip_tpu_torch.pack.format import PackedLinear, rot_to_butterflies


def _packed_matmul(q: PackedLinear, x2: torch.Tensor) -> torch.Tensor:
    """x2 (B, d) @ Ŵ₂ᵀ, sliced from the padded planes to out_features."""
    if q.qfn == "b":
        scale, zero = q.scale_b, None
    else:
        scale, zero = q.scale, q.zero
    out = dequant_matmul(x2, q.planes, scale, zero, bits=q.bits, qfn=q.qfn,
                         code_bits=q.code_bits)
    if out.shape[-1] != q.out_features:
        out = out[:, : q.out_features]     # padded_m rows are dead
    return out


def qlinear_apply(q: PackedLinear, x: torch.Tensor) -> torch.Tensor:
    """Apply a packed quantized linear to x (..., in_features)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    if d != q.in_features:
        raise ValueError(f"qlinear: x has {d} features, layer takes "
                         f"{q.in_features}")
    x2 = x.reshape(-1, d)

    if not q.has_rot:
        if q.scaleWH is not None:
            x2 = x2 / q.scaleWH.to(x2.dtype)[None, :]
        y = _packed_matmul(q, x2)
    else:
        U, V = rot_to_butterflies(q)
        if q.has_vin:
            # folded fast path: vin = signs_V / scaleWH is ONE pass
            V = V._replace(signs=q.vin)
        elif q.scaleWH is not None:
            x2 = x2 / q.scaleWH.to(x2.dtype)[None, :]
        x2 = inc.apply_rht(V, x2, axis=-1)               # x @ Vᵀ
        t = _packed_matmul(q, x2)
        y = inc.apply_rht(U, t, axis=-1, transpose=True)  # @ U

    if q.bias is not None:
        y = y + q.bias.to(y.dtype)
    return y.reshape(*lead, q.out_features)


def linear_apply(w, x: torch.Tensor) -> torch.Tensor:
    """Dense-or-packed dispatch: a dense weight is stored (in, out) as in
    quip_tpu, so y = x @ w. ActQuant wrappers are a later slice."""
    if isinstance(w, PackedLinear):
        return qlinear_apply(w, x)
    if isinstance(w, torch.Tensor):
        return x @ w
    raise NotImplementedError(
        f"linear_apply: {type(w).__name__} leaves (ActQuant) are a later "
        f"slice of the port (ROADMAP queue 1)")
