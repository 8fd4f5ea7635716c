"""K1′: the slab-dot variant of the packed dequant-matmul (qfn-b).

``slabdot_matmul`` computes what ``dequant_matmul`` computes for qfn-b,
by another route: each bit-field slab of a plane is turned into bf16
values ``128 + c`` by OR-ing ``0x43004300`` into the masked words, dotted
against its contiguous x chunk with f32 accumulation, and the offset
leaves once per plane as ``-128 · Σx``. It replaces the Pallas kernel of
``scripts/bench_kernel.py`` (``slabdot_matmul`` -> ``_slabdot_kernel``) with
the hand-written CUDA kernel in ``csrc/slabdot_matmul.cu``: one launch a
call, the codes as tensor-core operands, the plane words fed by TMA bulk
copies through a ring of shared-memory stages, the fan-in splits of a
column block added through a thread-block cluster. Its only caller is the
kernel microbenchmark ``tools/bench_kernel.py``, which sweeps ``tile_m``
(the width of output one block, or one cluster, owns). Like K1 it is bound
by the packed planes' bytes; the design note is in the source.

Dispatch goes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``slabdot_matmul_ref``, which repeats the kernel's
arithmetic (bf16 ``128 + c`` operands, f32 sums, the ``-128 · Σx`` fix-up)
and is not ``dequant_matmul_ref``. ``slabdot_walk_ref`` walks the kernel's
grid, ring and fragments in plain PyTorch for the tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from quip_tpu_torch.kernels import _build
from quip_tpu_torch.kernels.dequant_matmul import _decode_groups, _row_words
from quip_tpu_torch.pack.format import PLANE_SPLITS

launches = 0          # kernel launches, read by callers

_BF16_128 = 0x43004300
# the kernel's constants (csrc/slabdot_matmul.cu)
CG = 128              # columns of a column group: 4 consumer warps of 32
GPS = 4               # groups of 8 word rows a ring stage
RPS = 8 * GPS         # word rows of a ring stage
STAGES = 3            # stages in the ring
SROW = CG + 8         # a stage's row stride in words
MAX_SPLITS = 8        # blocks of one thread-block cluster (portable size)
RED_BYTES = 32 * 1024  # partials one barrier pair reduces, at most
SMEM_MAX = 220 * 1024  # dynamic shared memory the kernel asks for, at most
BLOCKS_PER_SM = 4     # the splits rule keeps to this many blocks an SM
_fn = None


def _smem_bytes(B: int, d: int, fbs: Sequence[int], splits: int,
                chunk_cols: int) -> int:
    """Dynamic shared memory of one block: 128 bytes to align the ring, the
    ring, the partials of min(B, 8) rows x ``chunk_cols``, and x's staged
    rows per plane for the widest split."""
    rows = min(8, B)
    s = 128 + 4 * STAGES * RPS * SROW + 4 * rows * chunk_cols
    for fb in fbs:
        s += 4 * rows * _row_words(-(-_decode_groups(d, fb) // splits),
                                   16 // fb)
    return s


def _plan(m: int, tile_m: int, B: int, d: int, fbs: Sequence[int],
          sms: int) -> Tuple[int, int]:
    """(splits, chunk_cols) for a call: the partials of one chunk of column
    groups fit ``RED_BYTES``; splits are a power of two (clusters of 5 to 7
    blocks ran slower than 4 and 8 in ``tools/tune_slabdot.py``), the
    largest that keeps the grid within ``BLOCKS_PER_SM`` blocks an SM (two
    waves of the two that fit one), at most a cluster's 8 and the groups
    of 8 word rows of the shortest plane; they double until the block's
    shared memory fits."""
    rows = min(8, B)
    chunk_cols = CG * max(1, min(tile_m // CG, RED_BYTES // (rows * CG * 4)))
    most = min(MAX_SPLITS, min(_decode_groups(d, fb) for fb in fbs))
    col_blocks = (m // tile_m) * -(-B // 8)
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


def slabdot_walk_ref(x: torch.Tensor, planes: Sequence[torch.Tensor], scale,
                     *, bits: int, tile_m: int) -> torch.Tensor:
    """For tests only: the kernel's grid walked in plain PyTorch, f32 out.

    Per tile of 8 rows of x and cluster (``tile_m`` columns), each split
    (block) stages bf16(x) for its groups of 8 word rows per plane (word
    (b, group, field k, pair u) = columns k·2nw + 16·group + 2u, +1, zero
    past the field's span) and sums plane 0's staged values. Its stages run
    in the kernel's order: column group, plane, stage of 16 word rows. The
    producer's box (16 word rows from the stage's first by SROW = 136
    columns from the group's first, zero past nw and m) fills ring slot
    L % STAGES; rows past the split's end belong to groups no warp reads,
    rows past nw unpack to 128 and meet x staged as zero. Each
    warp w's A operand for field k is built from the slot's words (row
    8grp + t + 4hh, column 32w + 4(r % 8) + 2q + r // 8 for m-tile q, row r)
    masked to 128 + c at k-index 2t + 8hh + h; B from the staged words t,
    t + 4 of row min(g, Bz - 1). Even fields add to one chain, odd ones to
    another, and a plane adds pw·(both chains) to the column group's total,
    which goes to the block's partials. Per chunk of column groups each block's share of
    the outputs adds the splits' partials in split order, takes 128·Σpw·Σx
    off (Σx over the splits in order) and applies the qfn-b map."""
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
    r16 = torch.arange(16)
    colmap = (32 * torch.arange(4)[:, None, None]
              + 2 * torch.arange(2)[None, :, None]
              + (4 * (r16 % 8) + r16 // 8)[None, None, :])    # (warp, q, r)
    as_bf16 = lambda v: v.to(torch.int16).view(torch.bfloat16)  # noqa: E731
    out = torch.zeros((B, m), dtype=torch.float32)

    def geometry(p, split):
        fb, pw = sb[p]
        nw, ng_all = d * fb // 32, _decode_groups(d, fb)
        rg0, rg1 = ng_all * split // splits, ng_all * (split + 1) // splits
        return dict(fb=fb, pw=pw, nw=nw, fph=16 // fb, rg0=rg0, rg1=rg1,
                    nst=-(-(rg1 - rg0) // GPS))

    def stage_x(gm, b0, Bz):
        ng, fph, nw = gm["rg1"] - gm["rg0"], gm["fph"], gm["nw"]
        per_row = ng * fph * 8
        r = torch.arange(per_row)
        u, k, rgl = r & 7, (r >> 3) % fph, (r >> 3) // fph
        off = 16 * (gm["rg0"] + rgl) + 2 * u
        ok = off < 2 * nw
        src = torch.where(ok, k * 2 * nw + off, 0)
        xs = torch.zeros((Bz, per_row, 2), dtype=torch.bfloat16)
        for h in (0, 1):
            xs[:, :, h] = torch.where(ok, xb[b0:b0 + Bz, src + h],
                                      torch.zeros((), dtype=xb.dtype))
        return xs

    for z in range(-(-B // 8)):
        b0 = 8 * z
        Bz = min(8, B - b0)
        for cb in range(m // tile_m):
            col0 = cb * tile_m
            blocks = []
            for split in range(splits):
                gms = [geometry(p, split) for p in range(len(planes))]
                xss = [stage_x(gm, b0, Bz) for gm in gms]
                blocks.append(dict(
                    gms=gms, xss=xss, L=0,
                    sums=xss[0].to(torch.float32).sum((1, 2)),
                    ring=torch.zeros((STAGES, RPS, SROW),
                                     dtype=torch.int64)))
            xsum = torch.zeros(Bz)
            for blk in blocks:                      # split order
                xsum = xsum + blk["sums"]
            for c in range(nchunks):
                cg0, cg1 = c * cpc, min(ncg, (c + 1) * cpc)
                for blk in blocks:
                    blk["red"] = torch.zeros((Bz, chunk_cols))
                    for cgi in range(cg0, cg1):
                        tot = torch.zeros((4, 2, 16, 8))
                        for p, (gm, xs) in enumerate(zip(blk["gms"],
                                                         blk["xss"])):
                            # (field parity, warp, q, row, n)
                            chains = torch.zeros((2, 4, 2, 16, 8))
                            fph, fb = gm["fph"], gm["fb"]
                            for st in range(gm["nst"]):
                                slot = blk["L"] % STAGES
                                blk["L"] += 1
                                j0 = 8 * (gm["rg0"] + GPS * st)
                                cols = col0 + cgi * CG
                                box = words[p][j0:j0 + RPS, cols:cols + SROW]
                                blk["ring"][slot] = 0
                                blk["ring"][slot, :box.shape[0],
                                            :box.shape[1]] = box
                                ngrp = min(GPS,
                                           gm["rg1"] - gm["rg0"] - GPS * st)
                                for grp in range(ngrp):
                                    rgl = GPS * st + grp
                                    # W[hh, t]: (warp, q, r) words of row
                                    # 8grp + t + 4hh
                                    W = torch.stack([torch.stack([
                                        blk["ring"][slot, 8 * grp + t + 4 * hh]
                                        [colmap] for t in range(4)])
                                        for hh in (0, 1)])
                                    kk = torch.arange(fph)
                                    mask = ((1 << fb) - 1) * 0x00010001
                                    sl = (((W[None] >> (fb * kk).view(
                                        -1, 1, 1, 1, 1, 1)) & mask)
                                        | _BF16_128)    # (k, hh, t, w, q, r)
                                    halves = torch.stack(
                                        [as_bf16(sl & 0xFFFF),
                                         as_bf16(sl >> 16)], -1)
                                    # -> (k, w, q, r, kk = 8hh + 2t + h)
                                    A = halves.permute(0, 3, 4, 5, 1, 2,
                                                       6).reshape(
                                        fph, 4, 2, 16, 16).to(torch.float32)
                                    word = ((rgl * fph + kk)[:, None, None] * 8
                                            + torch.arange(4)[None, None, :]
                                            + 4 * torch.arange(2)[None, :,
                                                                  None])
                                    # lanes g >= Bz read row Bz - 1 (their
                                    # columns of C are never stored)
                                    rows8 = torch.clamp(torch.arange(8),
                                                        max=Bz - 1)
                                    Bm = xs[rows8][:, word].permute(
                                        1, 2, 3, 4, 0).to(torch.float32)
                                    Bm = Bm.reshape(fph, 16, 8)
                                    prods = torch.einsum("kwqrj,kjn->kwqrn",
                                                         A, Bm)
                                    for k in range(fph):
                                        chains[k % 2] += prods[k]
                            tot += gm["pw"] * (chains[0] + chains[1])
                        at = (cgi - cg0) * CG + colmap.reshape(-1)
                        blk["red"][:, at] = tot.reshape(-1, 8)[:, :Bz].t()
                # each block's share of the chunk's outputs, in float4s
                ccols = (cg1 - cg0) * CG
                q4 = ccols // 4
                done = torch.zeros(Bz * q4, dtype=torch.int32)
                for split in range(splits):
                    e = torch.arange(Bz * q4 * split // splits,
                                     Bz * q4 * (split + 1) // splits)
                    done[e] += 1
                    b, cc = e // q4, (e % q4) * 4
                    for j in range(4):
                        v = torch.zeros(len(e))
                        for blk in blocks:              # split order
                            v = v + blk["red"][b, cc + j]
                        v = s0 * ((2.0 / maxq) * (v - 128.0 * pwsum * xsum[b])
                                  - xsum[b])
                        out[b0 + b, col0 + cg0 * CG + cc + j] = v
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
