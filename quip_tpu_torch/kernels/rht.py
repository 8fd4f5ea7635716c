"""K3: one fused randomized-Hadamard/Kronecker (RHT) application.

``rht_apply_fused`` applies T = (L ⊗ R) · diag(vec) (or its transpose)
along the last axis of x (B, n) in ONE launch: the elementwise fold and
both Kronecker factor products. It replaces the Pallas kernels of
``quip_tpu/kernels/rht.py`` (``rht_apply_fused`` -> ``_kernel3``, and
``_kernel2`` when there is no right factor) with the hand-written CUDA
kernels in ``csrc/rht.cu``: ``rht_mma`` for bf16 (both products on the
tensor cores, 16 output columns a block; ``rht_walk_ref`` below walks its
tiles in plain PyTorch) and ``rht_kernel`` for f32 (FMA on the CUDA cores:
tensor-core products would change the f32 function). The un-fused form is
``core/incoherence.apply_rht`` (one multiply and two matmuls, each with
its casts). ``ops/qlinear.py`` routes decode-size batches through it when
``QUIP_FUSED_RHT=1``. Its bytes and operations are tiny for the card;
launch and load latency set its time (design note in the source).

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
        lib.quip_rht_apply.argtypes = [P, I, I, I, I, P, P, P, I, I, I, P, P]
        lib.quip_rht_apply.restype = ctypes.c_int
        lib.quip_rht_smem_bytes.argtypes = [I, I, I, I, I]
        lib.quip_rht_smem_bytes.restype = ctypes.c_longlong
        lib.quip_rht_empty.argtypes = [P]
        lib.quip_rht_empty.restype = ctypes.c_int
        _fns = (lib.quip_rht_apply, lib.quip_rht_smem_bytes,
                lib.quip_rht_empty)
    return _fns


def block_plan(B: int, b: int, sms: int):
    """(output columns a block owns, rows of x it takes in turn) for the
    bf16 kernel on a card of ``sms`` SMs. 16 columns give a row of x the most
    blocks (4 to 16), but every block of a row stages the whole X tile, so
    once 64-column blocks alone are half a wave (B·ceil(b / 64) >= sms / 2)
    they are taken; a block takes more than one row only beyond two blocks an
    SM, so that L and the R slice are staged once for them."""
    cols = 64 if B * -(-b // 64) >= sms // 2 else 16
    return cols, max(1, -(-B * -(-b // cols) // (2 * sms)))


def launch_empty() -> None:
    """One launch of a kernel that does nothing on the current stream: the
    launch floor that chip_smoke.py prints beside K3's bound. Not counted."""
    _build.check(_entry()[2](torch.cuda.current_stream().cuda_stream),
                 "empty kernel")


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


def rht_walk_ref(x: torch.Tensor, vec: torch.Tensor, left: torch.Tensor,
                 right: Optional[torch.Tensor], *, transpose: bool = False,
                 sms: int = 132) -> torch.Tensor:
    """For tests only: the tiles of the bf16 kernel (``rht_mma``) in plain
    PyTorch. Per block of ``block_plan``'s rows and output columns q0..:
    the bf16 X tile (a, b) zero-padded to multiples of 16 with the forward
    vec fold in bf16; the R slice as the kernel stages it (rows q0.. of R
    for Z = X·Rᵀ, columns q0.. for Z = X·R; zero outside b); L zero-padded,
    used as it lies or transposed; Z rounded to bf16 in a tile of the
    block's columns (column 0 alone when there is no right factor); Y
    rounded to bf16, the transpose's vec fold last and in bf16; only the
    (a, b) corner is written. x must be bf16."""
    a, b = _split(x, vec, left, right)
    assert x.dtype == torch.bfloat16
    B, bf = x.shape[0], torch.bfloat16
    up16 = lambda v: -(-v // 16) * 16  # noqa: E731
    ap, kb = up16(a), up16(b)
    v = vec.to(bf).reshape(a, b)
    Ls = torch.zeros((ap, ap), dtype=bf)
    Ls[:a, :a] = left.to(bf)
    Lop = (Ls.t() if transpose else Ls).to(torch.float32)
    out = torch.zeros((B, a, b), dtype=bf)
    cols, rpb = block_plan(B, b, sms)
    for row0 in range(0, B, rpb):
        for q0 in range(0, b, cols):
            qn = min(cols, b - q0)
            if right is not None:
                Rs = torch.zeros((cols, kb) if not transpose
                                 else (kb, cols), dtype=bf)
                if transpose:
                    Rs[:b, :qn] = right[:, q0:q0 + qn].to(bf)
                else:
                    Rs[:qn, :b] = right[q0:q0 + qn].to(bf)
                Rop = (Rs if transpose else Rs.t()).to(torch.float32)
            for row in range(row0, min(B, row0 + rpb)):
                xr = x[row].reshape(a, b)
                Zs = torch.zeros((ap, cols), dtype=bf)
                if right is None:
                    Zs[:a, 0] = (xr if transpose else xr * v)[:, 0]
                else:
                    Xs = torch.zeros((ap, kb), dtype=bf)
                    Xs[:a, :b] = xr if transpose else xr * v
                    Zs = (Xs.to(torch.float32) @ Rop).to(bf)
                Y = (Lop @ Zs.to(torch.float32)).to(bf)[:a, :qn]
                if transpose:
                    Y = Y * v[:, q0:q0 + qn]
                out[row, :, q0:q0 + qn] = Y
    return out.reshape(B, a * b)


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
    apply, smem_bytes, _ = _entry()
    bf16 = x.dtype == torch.bfloat16
    cols, rpb = block_plan(B, b, _build.sm_count(x.get_device()))
    need = smem_bytes(int(bf16), a, b, int(right is not None), cols)
    if need > _MAX_SMEM:
        raise ValueError(f"rht_apply_fused: a={a}, b={b} needs {need} bytes "
                         f"of shared memory, a block has {_MAX_SMEM}")
    x = x.contiguous()
    if x.data_ptr() % 16:          # a view into a larger buffer
        x = x.clone()
    out = torch.empty_like(x)
    err = apply(x.data_ptr(), int(bf16), B, a, b,
                vec.data_ptr(), left.data_ptr(),
                right.data_ptr() if right is not None else None,
                int(transpose), cols, rpb, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rht_apply_fused")
    launches += 1
    return out
