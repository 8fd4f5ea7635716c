"""Quantized-linear forward: the incoherence-aware inference op.

Port of ``quip_tpu/ops/qlinear.py``. y = x @ Ŵᵀ with
Ŵ = Uᵀ Ŵ₂ V · diag(1/s) folded into the activation path:

    y = ((x / s) @ Vᵀ) @ Ŵ₂ᵀ @ U

Steps: V-side rotation -> packed dequant-matmul (kernels/dequant_matmul.py:
the CUDA kernel for CUDA tensors, its plain version on the CPU) -> U-side
rotation. The dense rotated weight is never built. RHT modes ('rht',
'rht_sf', 'rht_uf') fold the un-scale and the V signs into one vector
(``rot['vin']``); butterfly modes ('block', 'noblock', 'nopermute') divide
by scaleWH, then apply V's butterfly (gathers by the permutations and a
batched product a stage), and U's transposed after the kernel, gathering
by the inverse permutations the layer derived at construction: no host
sync and no argsort a call, so the branch is captured in the serving
graphs like the others.

Rotations must be materialised (``PackedLinear.rot``): the port does not
regenerate JAX keys (see core/incoherence.py).

``QUIP_FUSED_RHT=1`` (read at call time, default off, the same variable as
in quip_tpu) sends 'rht'-mode layers at decode-size batches (at most 32
rows) through the fused RHT kernel (kernels/rht.py): one launch per
rotation instead of the multiply, two matmuls and their casts.
"""
from __future__ import annotations

import os

import torch

from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.kernels.dequant_matmul import dequant_matmul
from quip_tpu_torch.kernels.rht import rht_apply_fused
from quip_tpu_torch.ops.actquant import ActQuant
from quip_tpu_torch.pack.format import PackedLinear, rot_to_butterflies


def _fused_rht_enabled() -> bool:
    return os.environ.get("QUIP_FUSED_RHT") == "1"


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

    if (q.proj_mode == "rht" and q.has_rot and x2.shape[0] <= 32
            and _fused_rht_enabled()):
        # fused path: one kernel per rotation (vec fold + both Kronecker
        # products); vec_v carries the scaleWH divide (stored as vin).
        # quip_tpu pads the rows to a multiple of 8 here for the TPU's
        # sublane tiling; rows are independent, so this kernel takes them
        # as they are.
        U, V = rot_to_butterflies(q)
        if q.has_vin:
            vec_v = q.vin
        else:
            vec_v = (V.signs if q.scaleWH is None
                     else V.signs / q.scaleWH)
        x2 = rht_apply_fused(x2, vec_v, V.left, V.right)
        t = _packed_matmul(q, x2)
        y = rht_apply_fused(t, U.signs, U.left, U.right, transpose=True)
    elif q.butterfly:
        if q.scaleWH is not None:
            x2 = x2 / q.scaleWH.to(x2.dtype)[None, :]
        U, V = rot_to_butterflies(q)
        x2 = inc.apply_butterfly(V, x2, axis=-1)         # x @ Vᵀ
        t = _packed_matmul(q, x2)
        y = inc.apply_butterfly(U, t, axis=-1, transpose=True)  # @ U
    elif not q.has_rot:
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
    quip_tpu, so y = x @ w. An ActQuant wrapper (ops/actquant.py)
    quantizes the activations first, then dispatches its inner linear."""
    if isinstance(w, ActQuant):
        return linear_apply(w.inner, w.quantize(x))
    if isinstance(w, PackedLinear):
        return qlinear_apply(w, x)
    if isinstance(w, torch.Tensor):
        return x @ w
    raise TypeError(f"linear_apply: no dispatch for a "
                    f"{type(w).__name__} leaf")
