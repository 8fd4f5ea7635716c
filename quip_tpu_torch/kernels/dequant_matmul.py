"""K1: fused unpack -> dequant -> matmul for packed planes.

``dequant_matmul`` computes y = bf16(x) · dequant(planes)ᵀ with f32
accumulation and never builds the dense W. It replaces the Pallas kernel
``quip_tpu/kernels/dequant_matmul.py`` (``_dequant_matmul_local`` ->
``_kernel`` / ``_plane_codes_dot``) with two hand-written CUDA kernels:

* K1, ``csrc/dequant_matmul.cu`` (``dm_partial``), for B <= 8 rows: the
  decode GEMV, bound by the bytes of the packed planes. One thread per
  output column for coalesced plane reads, word rows split over the grid,
  x staged in shared memory, exact magic-exponent unpack, f32 ``fmaf``.
* K1-tile, ``csrc/dequant_matmul_tile.cu`` (``dm_tile``), for B > 8 rows:
  prefill and admission windows, bound by the products. ``mma.sync`` on the
  tensor cores with the plane words as B fragments (a shift, an AND, an OR
  and one exact bf16 subtraction per operand register), x tiles and plane
  words staged by ``cp.async``. Its design note is in the source;
  ``tile_walk_ref`` below walks the planes the same way in plain PyTorch.

Dispatch goes by device, then by a stated rule: a CPU tensor takes
``dequant_matmul_ref``, the plain version with the semantics of
quip_tpu's ``dequant_matmul_ref``; a CUDA tensor launches a kernel (or
raises): K1-tile when B >= ``TILE_MIN_B`` and the shape is one it takes
(``tile_takes``), K1 otherwise.

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
launches_tile = 0     # those of them that went to K1-tile

# Rows from which the tensor-core path is taken. Measured on an NVIDIA H100
# 80GB HBM3, 700 W (chip_smoke.py, K1 phase, "crossover" lines): K1-tile is
# the faster kernel at every B tried, B = 1 and 8 included (sum of the five
# Llama-2-7B shapes 0.106 against 0.133 ms and 0.109 against 0.365 ms), so
# no crossover lies above 8. The threshold keeps B <= 8, the decode path,
# on K1 as it was; whether decode moves too is a separate decision.
TILE_MIN_B = 9

_fn = None
_fn_tile = None


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


def _entry_tile():
    global _fn_tile
    if _fn_tile is None:
        f = _build.load("dequant_matmul_tile").quip_dequant_matmul_tile
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P, I, I, I, P, I, P, I, I, F, F, I, I, I, I, P, P, I, F,
                      P, P, P, P]
        f.restype = ctypes.c_int
        _fn_tile = f
    return _fn_tile


def _tile_b(B: int) -> int:
    t = 1
    while t < min(B, 8):
        t *= 2
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(col_blocks: int, B: int, d: int, nw_min: int, tb: int,
            device: int) -> int:
    """Word-row chunks for a grid of ``col_blocks`` column blocks: about
    four waves of blocks on the card, x chunk in at most 96 KB of shared
    memory, at least one word row per chunk."""
    sms = _sm_count(device)
    blocks = col_blocks * -(-B // tb)
    s = max(1, -(-4 * sms // blocks), -(-tb * d * 4 // (96 * 1024)))
    return min(s, nw_min)


def tile_takes(d: int, m_p: int, bits: int) -> bool:
    """The shapes K1-tile takes: every copy it makes is 16 bytes, so each
    plane's word-row count is a multiple of 4 (d·f a multiple of 128) and
    m_p a multiple of 8. Other shapes go to K1."""
    return m_p % 8 == 0 and all((d * fb) % 128 == 0
                                for fb, _ in PLANE_SPLITS[bits])


def _tile_stages(d: int, fb: int) -> int:
    """Stages of 8 slices (128 fan-in columns) K1-tile walks for a plane."""
    nw = d * fb // 32
    return -(-(-(-nw // 8) * (16 // fb)) // 8)


def _tile_plan(B: int, d: int, m_p: int, bits: int, sms: int):
    """(rows per block, warps per block, fan-in splits) for K1-tile on a
    card of ``sms`` SMs: the smallest row tile that holds B (up to 64); 8
    warps (256 columns) where that still gives a block per SM, else 4; and
    the fan-in split to the nearest count that puts two waves of 64-row
    blocks, or three of the lighter ones, in flight, each split at least 4
    stages deep."""
    bm = 16 if B <= 16 else 32 if B <= 32 else 64
    rows = -(-B // bm)
    nwarps = 8 if -(-m_p // 256) * rows >= sms else 4
    blocks = -(-m_p // (32 * nwarps)) * rows
    depth = min(_tile_stages(d, fb) for fb, _ in PLANE_SPLITS[bits])
    want = (2 if bm == 64 else 3) * sms
    return bm, nwarps, max(1, min((want + blocks // 2) // blocks,
                                  depth // 4))


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


def tile_walk_ref(x: torch.Tensor, planes: Sequence[torch.Tensor],
                  scale, zero, *, bits: int, qfn: str = "b",
                  code_bits: Optional[int] = None) -> torch.Tensor:
    """For tests only: the index algebra of K1-tile in plain PyTorch, f32
    out. It walks each plane as ``dm_tile`` does: stages of 8 slices, slice
    L = (row group L // fph of 8 word rows, field L % fph), the A slice 16
    contiguous bf16 columns of x at k·2nw + 16·rg (zero past the field's
    span), rows padded to 16; the B fragment of lane (g, t) for n-tile q of
    a warp's 32 columns built from words (8rg + t, 4g + q) and
    (8rg + t + 4, 4g + q) as ((w >> f·k) & mask) | 0x43004300, two bf16
    values 128 + c, less 128 in bf16; C's column (n-tile q, index n) is
    column 4n + q. Planes run heavier first into one accumulator."""
    B, d = x.shape
    m_p = planes[0].shape[-1]
    Bp, mp32 = -(-B // 16) * 16, -(-m_p // 32) * 32
    xb = torch.zeros((Bp, d), dtype=torch.bfloat16)
    xb[:B] = x.to(torch.bfloat16)
    xsum = xb[:B].to(torch.float32).sum(dim=1, keepdim=True)
    # column of (warp, n-tile q, lane group g); C's index n plays g's part
    col = (32 * torch.arange(mp32 // 32)[:, None, None]
           + torch.arange(4)[None, :, None] + 4 * torch.arange(8))
    acc = torch.zeros((Bp, mp32), dtype=torch.float32)
    splits_bits = PLANE_SPLITS[bits]
    for p in reversed(range(len(planes))):
        fb, pw = splits_bits[p]
        fph, nw = 16 // fb, d * fb // 32
        stages = _tile_stages(d, fb)
        words = torch.zeros((8 * (-(-8 * stages // fph)), mp32),
                            dtype=torch.int64)     # rows >= nw read as zero
        words[:nw, :m_p] = planes[p].to(torch.int64) & 0xFFFFFFFF
        pair_mask = ((1 << fb) - 1) * 0x00010001
        for s in range(stages):
            for u in range(8):
                rg, k = divmod(8 * s + u, fph)
                a = torch.zeros((Bp, 16), dtype=torch.bfloat16)
                for piece in (0, 8):                # one 16-byte copy each
                    off = 16 * rg + piece
                    if off < 2 * nw:
                        c0 = k * 2 * nw + off
                        a[:, piece:piece + 8] = xb[:, c0:c0 + 8]
                frag = torch.zeros((16, mp32 // 32, 4, 8),
                                   dtype=torch.bfloat16)  # (k index, w, q, g)
                for t in range(4):
                    for reg_no in (0, 1):           # registers b0, b1
                        w = words[8 * rg + t + 4 * reg_no][col]
                        reg = ((w >> (fb * k)) & pair_mask) | 0x43004300
                        for h, half in enumerate((reg & 0xFFFF, reg >> 16)):
                            v = half.to(torch.int16).view(torch.bfloat16)
                            frag[2 * t + 8 * reg_no + h] = v - 128
                c = a.to(torch.float32) @ frag.reshape(16, -1).to(
                    torch.float32)                  # columns in (w, q, n)
                acc[:, col.reshape(-1)] += c
        acc *= pw / splits_bits[p - 1][1] if p else pw
    y, maxq = acc[:B, :m_p], float(2 ** (code_bits or bits) - 1)
    if qfn == "b":
        return (torch.as_tensor(scale, dtype=torch.float32)
                * ((2.0 / maxq) * y - xsum))
    sc = scale.reshape(-1).to(torch.float32)
    return sc * y - sc * zero.reshape(-1).to(torch.float32) * xsum


def dequant_matmul(x: torch.Tensor, planes: Sequence[torch.Tensor],
                   scale, zero, *, bits: int, qfn: str = "b",
                   code_bits: Optional[int] = None,
                   path: Optional[str] = None) -> torch.Tensor:
    """y (B, m_p) = x (B, d) @ dequant(planes)ᵀ, in x's dtype.

    planes: int32 (d*f/32, m_p) per PLANE_SPLITS[bits]; qfn-b: ``scale``
    is the scalar scale_b; qfn-a: ``scale``/``zero`` are (m_p,). ``path``
    ("partial" for K1, "tile" for K1-tile) overrides the dispatch rule on a
    CUDA tensor, for measuring one kernel against the other."""
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, planes, scale, zero, bits=bits, qfn=qfn,
                                  code_bits=code_bits)
    global launches, launches_tile
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
    maxq = float(2 ** (code_bits or bits) - 1)
    nplanes = len(planes)
    p1 = planes[1] if nplanes > 1 else planes[0]
    fb1, pw1 = splits_bits[1] if nplanes > 1 else (0, 0)
    out = torch.empty((B, m_p), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if path not in (None, "partial", "tile"):
        raise ValueError(f"dequant_matmul: unknown path {path!r}")
    tile = (B >= TILE_MIN_B) if path is None else path == "tile"
    if path == "tile" and not tile_takes(d, m_p, bits):
        raise ValueError(f"dequant_matmul: K1-tile does not take d={d}, "
                         f"m={m_p} at {bits} bits")
    if tile and tile_takes(d, m_p, bits):
        bm, nwarps, splits = _tile_plan(B, d, m_p, bits,
                                        _sm_count(x.get_device()))
        if x.data_ptr() % 16:
            x = x.clone()
        xb = (x if x.dtype == torch.bfloat16 else
              torch.empty((B, d), dtype=torch.bfloat16, device=x.device))
        work = torch.empty(-(-B // 4) * 4
                           + (splits * B * m_p if splits > 1 else 0),
                           dtype=torch.float32, device=x.device)
        err = _entry_tile()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), B, d,
            planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
            nplanes, float(splits_bits[0][1]), float(pw1), m_p, bm, nwarps,
            splits, xb.data_ptr(), work.data_ptr(), int(qfn == "b"), maxq,
            sc.data_ptr(), ze.data_ptr(), out.data_ptr(), stream)
        _build.check(err, "dequant_matmul (tile)")
        launches += 1
        launches_tile += 1
        return out
    tb = _tile_b(B)
    nw_min = min(p.shape[0] for p in planes)
    splits = _splits(-(-m_p // 128), B, d, nw_min, tb, x.get_device())
    work = torch.empty(nplanes * splits * B * m_p + splits * B,
                       dtype=torch.float32, device=x.device)
    err = _entry()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, d,
        planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
        nplanes, float(splits_bits[0][1]), float(pw1), m_p, splits, tb,
        work.data_ptr(), int(qfn == "b"), maxq, sc.data_ptr(),
        ze.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "dequant_matmul")
    launches += 1
    return out
