"""K1: fused unpack -> dequant -> matmul for packed planes.

``dequant_matmul`` computes y = bf16(x) · dequant(planes)ᵀ with f32
accumulation and never builds the dense W. It replaces the Pallas kernel
``quip_tpu/kernels/dequant_matmul.py`` (``_dequant_matmul_local`` ->
``_kernel`` / ``_plane_codes_dot``) with the hand-written CUDA kernel in
``csrc/dequant_matmul.cu``. At decode the kernel is bound by the bytes of
the packed planes (device-memory bandwidth); its design note (one thread
per output column for coalesced plane reads, word rows split over the
grid, x staged in shared memory, exact magic-exponent unpack) sits in the
source.

Dispatch goes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``dequant_matmul_ref``, the plain version with the
semantics of quip_tpu's ``dequant_matmul_ref``.

Algebra (shared with the TPU kernel):
    qfn-b:  y = s · (2/maxq · (x @ qᵀ) - Σ_d x)
    qfn-a:  y = scale_r · (x @ qᵀ) - scale_r zero_r · Σ_d x
with x @ qᵀ = Σ_p weight_p · (x @ q_pᵀ) over the planes of PLANE_SPLITS.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from quip_tpu_torch.kernels import _build
from quip_tpu_torch.pack.format import PLANE_SPLITS, unpack_codes

launches = 0          # kernel launches (one per CUDA call), read by callers

_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = _build.load("dequant_matmul").quip_dequant_matmul
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P, I, I, I, P, I, P, I, I, F, F, I, I, I, P, I, F,
                      P, P, P, P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _tile_b(B: int) -> int:
    t = 1
    while t < min(B, 8):
        t *= 2
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(B: int, d: int, m_p: int, nw_min: int, tb: int,
            device: int) -> int:
    """Word-row chunks: about four waves of blocks on the card, x chunk in
    at most 96 KB of shared memory, at least one word row per chunk."""
    sms = _sm_count(device)
    blocks = -(-m_p // 128) * -(-B // tb)
    s = max(1, -(-4 * sms // blocks), -(-tb * d * 4 // (96 * 1024)))
    return min(s, nw_min)


def dequant_weight(planes: Sequence[torch.Tensor], scale, zero, *, bits: int,
                   d: int, qfn: str = "b",
                   code_bits: Optional[int] = None) -> torch.Tensor:
    """The dense (m_p, d) f32 weight the planes encode (rotated basis)."""
    codes = unpack_codes(planes, bits, d).to(torch.float32)
    maxq = float(2 ** (code_bits or bits) - 1)
    if qfn == "b":
        return ((codes / maxq) * 2 - 1) * scale.to(torch.float32)
    return (scale.reshape(-1, 1).to(torch.float32)
            * (codes - zero.reshape(-1, 1).to(torch.float32)))


def dequant_matmul_ref(x: torch.Tensor, planes: Sequence[torch.Tensor],
                       scale, zero, *, bits: int, qfn: str = "b",
                       code_bits: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: x (B, d) @ dequant(planes)ᵀ in f32 (x is not
    rounded to bf16 here, as in quip_tpu's dequant_matmul_ref)."""
    W = dequant_weight(planes, scale, zero, bits=bits, d=x.shape[-1],
                       qfn=qfn, code_bits=code_bits)
    return (x.to(torch.float32) @ W.t()).to(x.dtype)


def dequant_matmul(x: torch.Tensor, planes: Sequence[torch.Tensor],
                   scale, zero, *, bits: int, qfn: str = "b",
                   code_bits: Optional[int] = None) -> torch.Tensor:
    """y (B, m_p) = x (B, d) @ dequant(planes)ᵀ, in x's dtype.

    planes: int32 (d*f/32, m_p) per PLANE_SPLITS[bits]; qfn-b: ``scale``
    is the scalar scale_b; qfn-a: ``scale``/``zero`` are (m_p,)."""
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, planes, scale, zero, bits=bits, qfn=qfn,
                                  code_bits=code_bits)
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    splits_bits = PLANE_SPLITS.get(bits)
    if splits_bits is None or len(planes) != len(splits_bits):
        raise ValueError(f"dequant_matmul: {len(planes)} planes for "
                         f"{bits}-bit")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_matmul: x must be 2-D bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, d = x.shape
    m_p = planes[0].shape[-1]
    for p, (fb, _) in zip(planes, splits_bits):
        if (p.dtype != torch.int32 or p.device != x.device
                or tuple(p.shape) != (d * fb // 32, m_p)
                or not p.is_contiguous()):
            raise ValueError(
                f"dequant_matmul: plane {tuple(p.shape)} {p.dtype} on "
                f"{p.device} does not match d={d}, {fb}-bit fields, "
                f"m={m_p} (contiguous int32 on x's device)")
    if d % 32:
        raise ValueError(f"dequant_matmul: d={d} must be a multiple of 32")
    x = x.contiguous()
    if qfn == "b":
        sc = torch.as_tensor(scale, dtype=torch.float32,
                             device=x.device).reshape(1)
        ze = sc
    elif qfn == "a":
        sc = scale.to(device=x.device, dtype=torch.float32).reshape(-1)
        ze = zero.to(device=x.device, dtype=torch.float32).reshape(-1)
        if sc.numel() != m_p or ze.numel() != m_p:
            raise ValueError("dequant_matmul: qfn-a scale/zero must be (m,)")
        sc, ze = sc.contiguous(), ze.contiguous()
    else:
        raise ValueError(f"dequant_matmul: unknown qfn {qfn!r}")
    tb = _tile_b(B)
    nw_min = min(p.shape[0] for p in planes)
    splits = _splits(B, d, m_p, nw_min, tb, x.get_device())
    nplanes = len(planes)
    work = torch.empty(nplanes * splits * B * m_p + splits * B,
                       dtype=torch.float32, device=x.device)
    out = torch.empty((B, m_p), dtype=x.dtype, device=x.device)
    p1 = planes[1] if nplanes > 1 else planes[0]
    fb1, pw1 = splits_bits[1] if nplanes > 1 else (0, 0)
    maxq = float(2 ** (code_bits or bits) - 1)
    err = _entry()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, d,
        planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
        nplanes, float(splits_bits[0][1]), float(pw1), m_p, splits, tb,
        work.data_ptr(), int(qfn == "b"), maxq, sc.data_ptr(),
        ze.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dequant_matmul")
    launches += 1
    return out

