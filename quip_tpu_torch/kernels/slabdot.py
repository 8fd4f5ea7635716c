"""K1′: the slab-dot variant of the packed dequant-matmul (qfn-b).

``slabdot_matmul`` computes what ``dequant_matmul`` computes for qfn-b,
by another route: each bit-field slab of a plane is turned into bf16
values ``128 + c`` by OR-ing ``0x43004300`` into the masked words, dotted
against its contiguous x chunk with f32 accumulation, and the offset
leaves once per plane as ``-128 · Σx``. It replaces the Pallas kernel of
``scripts/bench_kernel.py`` (``slabdot_matmul`` -> ``_slabdot_kernel``) with
the hand-written CUDA kernel in ``csrc/slabdot_matmul.cu``; its only caller
is the kernel microbenchmark ``tools/bench_kernel.py``, which sweeps
``tile_m`` (the width of output one block owns). Like K1 it is bound by the
packed planes' bytes; the design note is in the source.

Dispatch goes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``slabdot_matmul_ref``, which repeats the kernel's
arithmetic (bf16 ``128 + c`` operands, f32 sums, the ``-128 · Σx`` fix-up)
and is not ``dequant_matmul_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from quip_tpu_torch.kernels import _build
from quip_tpu_torch.pack.format import PLANE_SPLITS

launches = 0          # kernel launches, read by callers

_BF16_128 = 0x43004300
_fn = None


def _tile_b(B: int) -> int:
    """Rows of x a block takes: the power of two that holds B, up to 8."""
    t = 1
    while t < min(B, 8):
        t *= 2
    return t


def _splits(col_blocks: int, B: int, d: int, nw_min: int, tb: int,
            device: int) -> int:
    """Word-row chunks for a grid of ``col_blocks`` column blocks: about
    four waves of blocks on the card, x chunk in at most 96 KB of shared
    memory, at least one word row per chunk."""
    sms = _build.sm_count(device)
    blocks = col_blocks * -(-B // tb)
    s = max(1, -(-4 * sms // blocks), -(-tb * d * 4 // (96 * 1024)))
    return min(s, nw_min)


def _entry():
    global _fn
    if _fn is None:
        f = _build.load("slabdot_matmul").quip_slabdot_matmul
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P, I, I, I, P, I, P, I, I, F, F, I, I, I, I, P, F, P,
                      P, P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def slab_values(plane: torch.Tensor, fb: int, k: int) -> torch.Tensor:
    """Field ``k`` of an (nw, m) plane of ``fb``-bit fields as the (2nw, m)
    f32 slab of bf16 values 128 + c (row 2j + h = half-word h of word row
    j), made by the kernel's mask-and-OR."""
    w = plane.to(torch.int64) & 0xFFFFFFFF
    mask = ((1 << fb) - 1) * 0x00010001
    s = ((w >> (fb * k)) & mask) | _BF16_128
    halves = torch.stack([(s & 0xFFFF) << 16, s & 0xFFFF0000], dim=1)
    return halves.to(torch.int32).view(torch.float32).reshape(
        2 * plane.shape[0], plane.shape[1])


def slabdot_matmul_ref(x: torch.Tensor, planes: Sequence[torch.Tensor],
                       scale, *, bits: int) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic (no ``tile_m``:
    it only shapes the kernel's grid and changes no value)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    xsum = xb.sum(dim=1, keepdim=True)
    ycodes = None
    for plane, (fb, pw) in zip(planes, PLANE_SPLITS[bits]):
        nw = plane.shape[0]
        acc = None
        for k in range(16 // fb):
            part = xb[:, k * 2 * nw:(k + 1) * 2 * nw] @ slab_values(plane, fb,
                                                                    k)
            acc = part if acc is None else acc + part
        acc = pw * (acc - 128.0 * xsum)
        ycodes = acc if ycodes is None else ycodes + acc
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    maxq = float(2 ** bits - 1)
    return (s * ((2.0 / maxq) * ycodes - xsum)).to(x.dtype)


def slabdot_matmul(x: torch.Tensor, planes: Sequence[torch.Tensor], scale,
                   *, bits: int, tile_m: int) -> torch.Tensor:
    """y (B, m) = x (B, d) @ dequant_b(planes)ᵀ in x's dtype (bf16 or f32;
    x is rounded to bf16 inside). planes: int32 (d*f/32, m) per
    PLANE_SPLITS[bits]; ``scale`` the scalar scale_b; ``tile_m`` a multiple
    of 128 that divides m."""
    splits_bits = PLANE_SPLITS.get(bits)
    if splits_bits is None or len(planes) != len(splits_bits):
        raise ValueError(f"slabdot_matmul: {len(planes)} planes for "
                         f"{bits}-bit")
    m = planes[0].shape[-1]
    if tile_m < 128 or tile_m % 128 or m % tile_m:
        raise ValueError(f"slabdot_matmul: tile_m={tile_m} must be a "
                         f"multiple of 128 that divides m={m}")
    if x.device.type == "cpu":
        return slabdot_matmul_ref(x, planes, scale, bits=bits)
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"slabdot_matmul: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"slabdot_matmul: x must be 2-D bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, d = x.shape
    for p, (fb, _) in zip(planes, splits_bits):
        if (p.dtype != torch.int32 or p.device != x.device
                or tuple(p.shape) != (d * fb // 32, m)
                or not p.is_contiguous()):
            raise ValueError(
                f"slabdot_matmul: plane {tuple(p.shape)} {p.dtype} on "
                f"{p.device} does not match d={d}, {fb}-bit fields, m={m} "
                f"(contiguous int32 on x's device)")
    if d % 32:
        raise ValueError(f"slabdot_matmul: d={d} must be a multiple of 32")
    x = x.contiguous()
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=x.device).reshape(1)
    tb = _tile_b(B)
    nw_min = min(p.shape[0] for p in planes)
    splits = _splits(m // tile_m, B, d, nw_min, tb, x.get_device())
    nplanes = len(planes)
    work = torch.empty(nplanes * splits * B * m + splits * B,
                       dtype=torch.float32, device=x.device)
    out = torch.empty((B, m), dtype=x.dtype, device=x.device)
    p1 = planes[1] if nplanes > 1 else planes[0]
    fb1, pw1 = splits_bits[1] if nplanes > 1 else (0, 0)
    err = _entry()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, d,
        planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
        nplanes, float(splits_bits[0][1]), float(pw1), m, tile_m, splits, tb,
        work.data_ptr(), float(2 ** bits - 1), sc.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "slabdot_matmul")
    launches += 1
    return out
