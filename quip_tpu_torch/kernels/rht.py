"""K3: one fused randomized-Hadamard/Kronecker (RHT) application.

``rht_apply_fused`` applies T = (L ⊗ R) · diag(vec) (or its transpose)
along the last axis of x (B, n) in ONE launch: the elementwise fold and
both Kronecker factor products. It replaces the Pallas kernels of
``quip_tpu/kernels/rht.py`` (``rht_apply_fused`` -> ``_kernel3``, and
``_kernel2`` when there is no right factor) with the hand-written CUDA
kernel in ``csrc/rht.cu``; the un-fused form is
``core/incoherence.apply_rht`` (one multiply and two matmuls, each with
its casts). ``ops/qlinear.py`` routes decode-size batches through it when
``QUIP_FUSED_RHT=1``. Its bytes and operations are tiny for the card; the
few blocks of a small batch and their latency set its time (design note in
the source).

  forward:    y = L @ reshape_{a,b}(x * vec) @ Rᵀ    (vec = signs, or
              signs / scaleWH: the divide folds into the same vector)
  transpose:  y = (Lᵀ @ reshape_{a,b}(x) @ R) * vec

The roundings are part of the function (T = x's dtype): ``x * vec`` in T,
each product summed in f32 and rounded to T, the transpose's ``* vec`` last
and in T; vec, L and R arrive f32 and are rounded to T inside.

Dispatch goes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``rht_apply_fused_ref``, the plain version with the same
roundings.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from quip_tpu_torch.kernels import _build

launches = 0          # kernel launches, read by callers

_MAX_SMEM = 227 * 1024
_fns = None


def _entry():
    global _fns
    if _fns is None:
        lib = _build.load("rht")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.quip_rht_apply.argtypes = [P, I, I, I, I, P, P, P, I, P, P]
        lib.quip_rht_apply.restype = ctypes.c_int
        lib.quip_rht_smem_bytes.argtypes = [I, I, I]
        lib.quip_rht_smem_bytes.restype = ctypes.c_longlong
        _fns = (lib.quip_rht_apply, lib.quip_rht_smem_bytes)
    return _fns


def _split(x: torch.Tensor, vec: torch.Tensor, left: torch.Tensor,
           right: Optional[torch.Tensor]):
    if x.dim() != 2:
        raise ValueError(f"rht_apply_fused: x must be (B, n), got "
                         f"{tuple(x.shape)}")
    n = x.shape[1]
    a = left.shape[0]
    b = n // a
    if (a * b != n or tuple(left.shape) != (a, a) or vec.numel() != n
            or (right is None and b != 1)
            or (right is not None and tuple(right.shape) != (b, b))):
        raise ValueError(
            f"rht_apply_fused: n={n} does not split as left "
            f"{tuple(left.shape)} x right "
            f"{None if right is None else tuple(right.shape)} with vec "
            f"{tuple(vec.shape)}")
    return a, b


def rht_apply_fused_ref(x: torch.Tensor, vec: torch.Tensor,
                        left: torch.Tensor, right: Optional[torch.Tensor], *,
                        transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version with the kernel's roundings: every product of
    T-rounded operands summed in f32 and rounded to T."""
    a, b = _split(x, vec, left, right)
    B, dt = x.shape[0], x.dtype
    v = vec.to(dt).reshape(a, b)
    x3 = x.reshape(B, a, b)
    if not transpose:
        x3 = x3 * v
    if right is not None:
        R = right.to(dt).to(torch.float32)
        x3 = (x3.to(torch.float32) @ (R if transpose else R.t())).to(dt)
    L = left.to(dt).to(torch.float32)
    y = ((L.t() if transpose else L) @ x3.to(torch.float32)).to(dt)
    if transpose:
        y = y * v
    return y.reshape(B, a * b)


def rht_apply_fused(x: torch.Tensor, vec: torch.Tensor, left: torch.Tensor,
                    right: Optional[torch.Tensor], *,
                    transpose: bool = False) -> torch.Tensor:
    """One fused RHT application along the last axis of x (B, n), bf16 or
    f32. vec (n,): the elementwise fold, applied first (forward) or last
    (transpose); left (a, a); right (b, b), or None when n == a. vec, left
    and right are f32. Same semantics as core/incoherence.apply_rht."""
    if x.device.type == "cpu":
        return rht_apply_fused_ref(x, vec, left, right, transpose=transpose)
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"rht_apply_fused: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rht_apply_fused: x must be bf16 or f32, got "
                         f"{x.dtype}")
    a, b = _split(x, vec, left, right)
    for name, t in (("vec", vec), ("left", left), ("right", right)):
        if t is not None and (t.dtype != torch.float32
                              or t.device != x.device
                              or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"rht_apply_fused: {name} must be contiguous, "
                             f"16-byte aligned f32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    B = x.shape[0]
    if not 1 <= B <= 65535:
        raise ValueError(f"rht_apply_fused: B={B} must be in [1, 65535]")
    apply, smem_bytes = _entry()
    need = smem_bytes(a, b, int(right is not None))
    if need > _MAX_SMEM:
        raise ValueError(f"rht_apply_fused: a={a}, b={b} needs {need} bytes "
                         f"of shared memory, a block has {_MAX_SMEM}")
    x = x.contiguous()
    if x.data_ptr() % 16:          # a view into a larger buffer
        x = x.clone()
    out = torch.empty_like(x)
    err = apply(x.data_ptr(), int(x.dtype == torch.bfloat16), B, a, b,
                vec.data_ptr(), left.data_ptr(),
                right.data_ptr() if right is not None else None,
                int(transpose), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rht_apply_fused")
    launches += 1
    return out
