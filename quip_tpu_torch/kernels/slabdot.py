"""K1′: the slab-dot variant of the packed dequant-matmul (qfn-b).

``slabdot_matmul`` computes what ``dequant_matmul`` computes for qfn-b,
by another route: each bit-field slab of a plane is turned into bf16
values ``128 + c`` by OR-ing ``0x43004300`` into the masked words, dotted
against its contiguous x chunk with f32 accumulation, and the offset
leaves once per plane as ``-128 · Σx``. It replaces the Pallas kernel of
``scripts/bench_kernel.py`` (``slabdot_matmul`` -> ``_slabdot_kernel``) with
the hand-written CUDA kernel in ``csrc/slabdot_matmul.cu``: one launch a
call, the masked slabs as the register operand of ``wgmma`` and the rows
of x as its shared-memory operand, the plane words fed by TMA boxes
through a ring of shared-memory slots, the fan-in splits of a column
block added through a thread-block cluster, programmatic dependent launch.
Its only caller is the kernel microbenchmark ``tools/bench_kernel.py``,
which sweeps ``tile_m`` (the width of output one block, or one cluster,
owns). Like K1 it is bound by the packed planes' bytes; the design note is
in the source.

Dispatch goes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``slabdot_matmul_ref``, which repeats the kernel's
arithmetic (bf16 ``128 + c`` operands, f32 sums, the ``-128 · Σx`` fix-up)
and is not ``dequant_matmul_ref``. ``slabdot_walk_ref`` walks the kernel's
grid, ring, fragments and split-order sum in plain PyTorch for the tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from quip_tpu_torch.kernels import _build
from quip_tpu_torch.kernels.dequant_matmul import (_pad_rows, core_bytes,
                                                   decode_groups, x_bytes)
from quip_tpu_torch.pack.format import PLANE_SPLITS

launches = 0          # kernel launches, read by callers

_BF16_128 = 0x43004300
# the kernel's constants (csrc/slabdot_matmul.cu)
CG = 128              # columns of a column group: one consumer warpgroup
GPS = 2               # groups of 8 word rows a ring slot
STAGES = 4            # slots in the ring
SROW = CG + 8         # a slot's row stride in words
MAXB = 8              # rows of x a tile (wgmma's N)
MAX_SPLITS = 8        # blocks of one thread-block cluster (portable size)
RED_BYTES = 32 * 1024  # partials one barrier pair reduces, at most
SMEM_MAX = 220 * 1024  # dynamic shared memory the kernel asks for, at most
ASETS = 2             # accumulator sets a plane, taken batch by batch
BLOCKS_PER_SM = 2     # blocks an SM holds (``__launch_bounds__``)
_fn = None


def _smem_bytes(B: int, d: int, fbs: Sequence[int], splits: int,
                chunk_cols: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source):
    128 bytes to align the ring, the ring, the partials of min(B, 8) rows x
    ``chunk_cols``, x staged once a distinct field width for the widest
    split, and 128 bytes past it."""
    rows = min(MAXB, B)
    s = 128 + 4 * STAGES * 8 * GPS * SROW + 4 * rows * chunk_cols + 128
    for fb in dict.fromkeys(fbs):
        s += x_bytes(-(-decode_groups(d, fb) // splits), fb, _pad_rows(rows))
    return s


def _plan(m: int, tile_m: int, B: int, d: int, fbs: Sequence[int],
          sms: int) -> Tuple[int, int]:
    """(splits, chunk_cols) for a call: the partials of one chunk of column
    groups fit ``RED_BYTES``; splits are a power of two (in
    ``tools/tune_slabdot.py``'s plans other cluster sizes won only at 22016
    x 4096), the largest that keeps the grid within ``BLOCKS_PER_SM``
    blocks an SM, at most a cluster's 8 and the groups of 8 word rows of the
    shortest plane; they double until the block's shared memory fits."""
    rows = min(MAXB, B)
    chunk_cols = CG * max(1, min(tile_m // CG, RED_BYTES // (rows * CG * 4)))
    most = min(MAX_SPLITS, min(decode_groups(d, fb) for fb in fbs))
    col_blocks = (m // tile_m) * -(-B // MAXB)
    want = max(1, min(most, math.ceil(BLOCKS_PER_SM * sms / col_blocks)))
    splits = 1 << (want.bit_length() - 1)
    while _smem_bytes(B, d, fbs, splits, chunk_cols) > SMEM_MAX:
        if 2 * splits > most:
            raise ValueError(f"slabdot_matmul: d={d} with {B} rows does not "
                             f"fit the kernel's shared memory")
        splits *= 2
    return splits, chunk_cols


def _entry():
    global _fn
    if _fn is None:
        f = _build.load("slabdot_matmul").quip_slabdot_matmul
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P, I, I, I, P, I, P, I, I, F, F, I, I, I, I, F, P, P,
                      P]
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


def _staged(xb: torch.Tensor, d: int, fb: int, rg0: int, ng: int,
            bp: int) -> torch.Tensor:
    """The shared memory of x staged for a split's groups [rg0, rg0 + ng)
    of ``fb``-bit fields, as bf16 elements (``stage_issue`` / ``stage_x``):
    the core matrix (field k, piece j) of 8 fan-in columns k·2nw + 16·rg0 +
    8j + (0..7) at byte (k·2ng + j)·core_bytes(bp), row b 16 bytes on,
    zero past the field's span; 128 bytes of zeros past the end."""
    nw, fph = d * fb // 32, 16 // fb
    cm = core_bytes(bp) // 2                     # in bf16 elements
    buf = torch.zeros(x_bytes(ng, fb, bp) // 2 + 64, dtype=torch.bfloat16)
    j = torch.arange(2 * ng)
    e = torch.arange(8)
    for k in range(fph):
        off = (16 * rg0 + 8 * j)[:, None] + e                   # (j, e)
        ok = off < 2 * nw
        src = torch.where(ok, k * 2 * nw + off, 0)
        for b in range(xb.shape[0]):
            at = (k * 2 * ng + j)[:, None] * cm + 8 * b + e
            buf[at] = torch.where(ok, xb[b, src],
                                  torch.zeros((), dtype=xb.dtype))
    return buf


def slabdot_walk_ref(x: torch.Tensor, planes: Sequence[torch.Tensor], scale,
                     *, bits: int, tile_m: int) -> torch.Tensor:
    """For tests only: the kernel's grid walked in plain PyTorch, f32 out.

    Per tile of 8 rows of x (the grid's z) and cluster (``tile_m``
    columns), each split (block) owns groups [G·split / splits,
    G·(split + 1) / splits) of 8 word rows of each plane and stages bf16(x)
    for them (``_staged``: wgmma's K-major core matrices, zero past each
    field's span), summing plane 0's staged values a row. Its column groups
    of 128 run in order, in each the heavier plane first, slot by slot: the
    producer's box (16 word rows from the slot's first by SROW = 136
    columns from the group's first, zero past nw and m) fills ring slot
    it % STAGES. For group gi of a slot and field k, A of m-tile mt (64 x
    16) has at row R = 16w + g + 8h (column 32w + 4g + 2mt + h of the
    group) and k-index 2j + h' the half-word h' of word (8gi + j, column)
    shifted down by fb·k, masked and OR-ed with 0x43004300: the bf16 value
    128 + c. B (16 x 8) is read from the staged bytes through the
    descriptor: core matrix kk // 8 of the slice (group, field k) at
    (k·2ng + 2·group)·cm bytes and cm more, row n 16 bytes on (rows n >= B
    read what follows; their columns of D are never stored). Each plane
    has accumulators of its own, in ``ASETS`` sets that its batches of two
    fields take in turn (D_set += A·B in f32); the column group's partial
    is Σ_p pw_p·Σ_set D_p,set, written to the block's partials. Per chunk of
    column groups each block's share of the outputs adds the splits'
    partials in split order, takes 128·Σpw·Σx off (Σx over the splits in
    order) and applies the qfn-b map."""
    B, d = x.shape
    m = planes[0].shape[-1]
    sb = PLANE_SPLITS[bits]
    fbs = [fb for fb, _ in sb]
    splits, chunk_cols = _plan(m, tile_m, B, d, fbs, 132)   # an H100's SMs
    ncg, cpc = tile_m // CG, chunk_cols // CG
    nchunks = -(-ncg // cpc)
    pwsum = float(sum(pw for _, pw in sb))
    maxq = float(2 ** bits - 1)
    s0 = torch.as_tensor(scale, dtype=torch.float32)
    xb = x.to(torch.bfloat16)
    words = [p.to(torch.int64) & 0xFFFFFFFF for p in planes]
    R = torch.arange(64)
    # (mt, R) -> column of the group
    colmap = torch.stack([32 * (R // 16) + 4 * (R % 8) + 2 * mt + (R % 16) // 8
                          for mt in (0, 1)])
    as_bf16 = lambda v: v.to(torch.int16).view(torch.bfloat16)  # noqa: E731
    out = torch.zeros((B, m), dtype=torch.float32)

    def parts(split):
        out = []
        for fb in fbs:
            G = decode_groups(d, fb)
            rg0 = G * split // splits
            out.append((fb, rg0, G * (split + 1) // splits - rg0))
        return out

    def b_operand(buf, cm, ng, group, k):
        """(16, 8) bf16 through the descriptor of slice (group, field k)."""
        start = (k * 2 * ng + 2 * group) * cm
        kk, n = torch.arange(16)[:, None], torch.arange(8)[None, :]
        return buf[start + (kk // 8) * cm + 8 * n + kk % 8]

    for z in range(-(-B // MAXB)):
        b0 = MAXB * z
        Bz = min(MAXB, B - b0)
        bp = _pad_rows(Bz)
        cm = core_bytes(bp) // 2
        for cb in range(m // tile_m):
            col0 = cb * tile_m
            blocks = []
            for split in range(splits):
                pts = parts(split)
                bufs = {fb: _staged(xb[b0:b0 + Bz], d, fb, rg0, ng, bp)
                        for fb, rg0, ng in pts}
                fb, rg0, ng = pts[0]
                vals = bufs[fb][:-64].reshape(-1, 8).float()
                rows_of = (torch.arange(vals.shape[0]) % (cm // 8))
                sums = torch.stack([vals[rows_of == b].sum()
                                    for b in range(Bz)])
                blocks.append(dict(pts=pts, bufs=bufs, sums=sums, it=0,
                                   ring=torch.zeros((STAGES, 8 * GPS, SROW),
                                                    dtype=torch.int64)))
            xsum = torch.zeros(Bz)
            for blk in blocks:                      # split order
                xsum = xsum + blk["sums"]
            for c in range(nchunks):
                cg0, cg1 = c * cpc, min(ncg, (c + 1) * cpc)
                for blk in blocks:
                    blk["red"] = torch.zeros((Bz, chunk_cols))
                    for cgi in range(cg0, cg1):
                        cols = col0 + cgi * CG
                        y = torch.zeros((2, 64, 8))
                        for p in reversed(range(len(planes))):
                            fb, rg0, ng = blk["pts"][p]
                            buf = blk["bufs"][fb]
                            # (set, m-tile, R, n); batches of 2 fields
                            # take the sets in turn
                            D = torch.zeros((ASETS, 2, 64, 8))
                            mask = ((1 << fb) - 1) * 0x00010001
                            for r0 in range(0, ng, GPS):
                                slot = blk["it"] % STAGES
                                blk["it"] += 1
                                j0 = 8 * (rg0 + r0)
                                box = words[p][j0:j0 + 8 * GPS,
                                               cols:cols + SROW]
                                blk["ring"][slot] = 0
                                blk["ring"][slot, :box.shape[0],
                                            :box.shape[1]] = box
                                for gi in range(min(GPS, ng - r0)):
                                    w8 = blk["ring"][slot, 8 * gi:8 * gi + 8,
                                                     :CG]         # (j, col)
                                    for k in range(16 // fb):
                                        reg = ((w8 >> (fb * k)) & mask) \
                                            | _BF16_128
                                        A = torch.stack(
                                            (as_bf16(reg & 0xFFFF),
                                             as_bf16(reg >> 16)), -1)
                                        A = A.permute(1, 0, 2).reshape(CG, 16)
                                        Bm = b_operand(buf, cm, ng, r0 + gi,
                                                       k).float()
                                        bi = gi * (8 // fb) + k // 2
                                        D[bi % ASETS] += A[colmap].float() @ Bm
                            y += sb[p][1] * D.sum(0)
                        at = (cgi - cg0) * CG + colmap.reshape(-1)
                        blk["red"][:, at] = y.reshape(-1, 8)[:, :Bz].t()
                # each block's share of the chunk's outputs, in float4s
                q4 = (cg1 - cg0) * CG // 4
                done = torch.zeros(Bz * q4, dtype=torch.int32)
                for split in range(splits):
                    e = torch.arange(Bz * q4 * split // splits,
                                     Bz * q4 * (split + 1) // splits)
                    done[e] += 1
                    b, cc = e // q4, (e % q4) * 4
                    for jj in range(4):
                        v = torch.zeros(len(e))
                        for blk in blocks:              # split order
                            v = v + blk["red"][b, cc + jj]
                        v = s0 * ((2.0 / maxq) * (v - 128.0 * pwsum * xsum[b])
                                  - xsum[b])
                        out[b0 + b, col0 + cg0 * CG + cc + jj] = v
                assert bool((done == 1).all())
    return out


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
    if tile_m < CG or tile_m % CG or m % tile_m:
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
                or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(
                f"slabdot_matmul: plane {tuple(p.shape)} {p.dtype} on "
                f"{p.device} does not match d={d}, {fb}-bit fields, m={m} "
                f"(contiguous 16-byte aligned int32 on x's device)")
    if d % 32:
        raise ValueError(f"slabdot_matmul: d={d} must be a multiple of 32")
    x = x.contiguous()
    if x.data_ptr() % 32:
        x = x.clone()
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=x.device).reshape(1)
    splits, chunk_cols = _plan(m, tile_m, B, d,
                               [fb for fb, _ in splits_bits],
                               _build.sm_count(x.get_device()))
    nplanes = len(planes)
    out = torch.empty((B, m), dtype=x.dtype, device=x.device)
    p1 = planes[1] if nplanes > 1 else planes[0]
    fb1, pw1 = splits_bits[1] if nplanes > 1 else (0, 0)
    err = _entry()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, d,
        planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
        nplanes, float(splits_bits[0][1]), float(pw1), m, tile_m, splits,
        chunk_cols, float(2 ** bits - 1), sc.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "slabdot_matmul")
    launches += 1
    return out
