"""K1: fused unpack -> dequant -> matmul for packed planes.

``dequant_matmul`` computes y = bf16(x) · dequant(planes)ᵀ with f32
accumulation and never builds the dense W. It replaces the Pallas kernel
``quip_tpu/kernels/dequant_matmul.py`` (``_dequant_matmul_local`` ->
``_kernel`` / ``_plane_codes_dot``) with two hand-written CUDA kernels:

* K1-decode, ``csrc/dequant_matmul_decode.cu`` (``dm_decode``), for B <= 8
  rows: the decode GEMV, bound by the bytes of the packed planes.
  ``wgmma.m64n8k16`` with the codes as the A operand from registers
  (masked in place, one logic instruction per operand register and one
  shift per run of fields; the 128 offset taken off once in the epilogue)
  and the rows of x as the 8-wide B operand in shared memory; one producer
  warp streams the plane words into an ``mbarrier`` ring by TMA while the
  consumer warpgroups unpack one batch of fields ahead of the products in
  flight; one launch, programmatic dependent launch, the fan-in splits added
  through a thread-block cluster's distributed shared memory in a fixed
  order. Planes with no tensor map (m_p % 4 != 0, or not 16-byte aligned)
  take the same kernel with its ring filled by ``cp.async`` copies
  (``decode_ragged``). Shapes K1-tile does not take go through it 8 rows
  at a time. Design note in the source; ``decode_walk_ref`` below walks
  the planes the same way in plain PyTorch.
* K1-tile, ``csrc/dequant_matmul_tile.cu`` (``dm_tile``), for B >= 9 rows:
  prefill, admission windows, the speculative verify and perplexity, bound
  by the products. ``wgmma`` with the unpacked plane words as the A operand
  from registers and N tokens of x as the B operand, fed to shared memory
  by TMA through an ``mbarrier`` ring that one producer warpgroup keeps
  full for two consumer warpgroups. Its design note is in the source;
  ``tile_walk_ref`` below walks the planes the same way in plain PyTorch.

Dispatch goes by device, then by a stated rule (``route``): a CPU tensor
takes ``dequant_matmul_ref``, the plain version with the semantics of
quip_tpu's ``dequant_matmul_ref``; a CUDA tensor launches a kernel (or
raises).

Algebra (shared with the TPU kernel):
    qfn-b:  y = s · (2/maxq · (x @ qᵀ) - Σ_d x)
    qfn-a:  y = scale_r · (x @ qᵀ) - scale_r zero_r · Σ_d x
with x @ qᵀ = Σ_p weight_p · (x @ q_pᵀ) over the planes of PLANE_SPLITS.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from quip_tpu_torch.kernels import _build
from quip_tpu_torch.pack.format import PLANE_SPLITS, unpack_codes

launches = 0          # kernel launches, read by callers
launches_tile = 0     # those of them that went to K1-tile
launches_decode = 0   # those of them that went to K1-decode
launches_decode_ragged = 0  # those of K1-decode's without a tensor map

# The dispatch rule (``route``) and its measurements, NVIDIA H100 80GB HBM3,
# 700 W, sum of the five 2-bit Llama-2-7B shapes (chip_smoke.py, K1 phase,
# "crossover" lines, with K1-tile on wgmma): K1-decode takes B <= 8, where
# it is the faster kernel (0.0861 against K1-tile's 0.1044 ms at B = 1,
# 0.0953 against 0.1059 at B = 4, 0.1050 against 0.1062 at B = 8); K1-tile
# takes B >= 9, where K1-decode must go 8 rows at a time (B = 9: 0.1066
# against 0.1893 ms; 12: 0.1075 / 0.1956; 16: 0.1090 / 0.2051; 24: 0.1162
# / 0.3053; 32: 0.1191 / 0.4051).
TILE_MIN_B = 9

DECODE_MAX_B = 8      # rows of x one wgmma n-tile holds
DECODE_MAX_SPLITS = 8  # blocks of one thread-block cluster (portable size)
# K1-decode's constants (csrc/dequant_matmul_decode.cu): 256 output columns
# a block (two consumer warpgroups); ring slots, each a TMA box of
# 8·DECODE_GPS word rows by DECODE_SROW words a warpgroup; the dynamic
# shared memory a block may take
DECODE_BN = 256
DECODE_STAGES = 4
DECODE_GPS = 2
DECODE_SROW = 136
DECODE_SMEM_MAX = 220 * 1024
# the most splits the plan takes: clusters of 8 blocks, one block an SM,
# did not all fit one wave on the H100 (tools/tune_decode.py's plans)
DECODE_RULE_SPLITS = 6

_fn_tile = None
_fn_decode = None


def _entry_tile():
    global _fn_tile
    if _fn_tile is None:
        f = _build.load("dequant_matmul_tile").quip_dequant_matmul_tile
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P, I, I, I, P, I, P, I, I, F, F, I, I, I, P, P, I, F,
                      P, P, P, P]
        f.restype = ctypes.c_int
        _fn_tile = f
    return _fn_tile


def _entry_decode():
    global _fn_decode
    if _fn_decode is None:
        f = _build.load("dequant_matmul_decode").quip_dequant_matmul_decode
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P, I, I, I, P, I, P, I, I, F, F, I, I, I, I, F,
                      P, P, P, P]
        f.restype = ctypes.c_int
        _fn_decode = f
    return _fn_decode


def tile_takes(d: int, m_p: int, bits: int) -> bool:
    """The shapes K1-tile takes: its tensor maps need 16-byte row strides,
    so each plane's word-row count is a multiple of 4 (d·f a multiple of
    128) and m_p a multiple of 8 (4 columns a lane's store). Other shapes go
    to K1-decode."""
    return m_p % 8 == 0 and all((d * fb) % 128 == 0
                                for fb, _ in PLANE_SPLITS[bits])


TILE_NS = (16, 32, 48, 64, 80, 96, 112, 128)   # tokens a block (wgmma's N)
TILE_BN = 256         # output columns a block (two warpgroups of 128)
# The plan's cost model, in SM clocks of one block: a stage (8 slices of 16
# fan-in columns) takes 16·N clocks of wgmma (four m64nNk16 a slice at the
# card's 2048 bf16 FMA a clock an SM) or its bytes (the x boxes, 256·N, and
# 8 or 16 word rows of 256 columns) at _TILE_SM_BYTES a clock, the larger;
# a work item adds _TILE_BLOCK_CLK of fill and epilogue, and the items run
# in waves of one an SM; a split adds its f32 partials' writes and reads at
# that rate over the card.
_TILE_SM_BYTES = 20.0
_TILE_BLOCK_CLK = 2000.0


def _tile_stages(d: int, fb: int) -> int:
    """Stages of 8 slices (16 fan-in columns each) K1-tile walks for a
    plane: (groups of 8 word rows) x (16 / fb fields) slices."""
    nw = d * fb // 32
    return -(-(-(-nw // 8) * (16 // fb)) // 8)


def _tile_cost(B: int, d: int, m_p: int, bits: int, sms: int, n: int,
               splits: int) -> float:
    """Modelled SM clocks of K1-tile with ``n`` tokens a block and
    ``splits`` fan-in splits (see _TILE_SM_BYTES)."""
    blocks = -(-B // n) * -(-m_p // TILE_BN) * splits
    clk = _TILE_BLOCK_CLK
    for fb, _ in PLANE_SPLITS[bits]:
        words = (16 if fb == 4 else 8) * TILE_BN * 4
        stage = max(16.0 * n, (words + 256 * n) / _TILE_SM_BYTES)
        clk += -(-_tile_stages(d, fb) // splits) * stage
    clk *= -(-blocks // sms)
    if splits > 1:
        clk += (2 * splits + 1) * B * m_p * 4 / (_TILE_SM_BYTES * sms)
    return clk


def _tile_plan(B: int, d: int, m_p: int, bits: int, sms: int):
    """(tokens a block N, fan-in splits) for K1-tile on a card of ``sms``
    SMs: the pair of least ``_tile_cost``, N from ``TILE_NS`` up to B
    rounded up to 16, splits up to 16 with each split at least 4 stages of
    every plane deep; the smaller N, then the fewer splits, on a tie."""
    depth = min(_tile_stages(d, fb) for fb, _ in PLANE_SPLITS[bits])
    top = -(-B // 16) * 16
    cands = [(n, s) for n in TILE_NS if n <= top
             for s in range(1, max(1, min(16, depth // 4)) + 1)]
    return min(cands, key=lambda c: (_tile_cost(B, d, m_p, bits, sms, *c),)
               + c)


def route(B: int, d: int, m_p: int, bits: int) -> str:
    """The kernel a CUDA call takes, "decode" or "tile": K1-decode up to
    ``DECODE_MAX_B`` rows; above that K1-tile where it takes the shape, else
    K1-decode over 8 rows at a time."""
    if B >= TILE_MIN_B and tile_takes(d, m_p, bits):
        return "tile"
    return "decode"


def decode_groups(d: int, fb: int) -> int:
    """Groups of 8 word rows in a plane of ``fb``-bit fields."""
    return -(-(d * fb // 32) // 8)


def _pad_rows(B: int) -> int:
    """Rows a core matrix of K1-decode's staged x holds: B rounded up to a
    power of two."""
    return 1 if B <= 1 else 2 if B <= 2 else 4 if B <= 4 else 8


def core_bytes(bp: int) -> int:
    """Bytes between neighbouring core matrices of x staged for ``bp`` rows
    (``core_bytes`` in ``csrc/decode_common.cuh``, K1-decode's and K1′'s):
    16 bytes a row, and 16 more from 2 rows on."""
    return 16 if bp == 1 else 16 * bp + 16


def x_bytes(ng: int, fb: int, bp: int) -> int:
    """Bytes of x staged for ``ng`` groups of 8 word rows of ``fb``-bit
    fields: a core matrix for every field and 8 fan-in columns."""
    return (16 // fb) * 2 * ng * core_bytes(bp)


def _decode_smem(B: int, d: int, bits: int, splits: int) -> int:
    """Dynamic shared memory of a K1-decode block (``smem_bytes`` in the
    source): alignment slack, the ring, the partials of 8 rows by the
    block's columns, and x staged once a distinct field width for the
    widest split (a core matrix of 8 fan-in columns by ``_pad_rows(B)``
    rows of 16 bytes, and 16 bytes more from 2 rows on, for every 8
    columns a field spans), with 128 bytes past it."""
    s = (128 + DECODE_STAGES * 2 * 8 * DECODE_GPS * DECODE_SROW * 4
         + 8 * DECODE_BN * 4 + 128)
    for fb in dict.fromkeys(fb for fb, _ in PLANE_SPLITS[bits]):
        s += x_bytes(-(-decode_groups(d, fb) // splits), fb, _pad_rows(B))
    return s


def _decode_plan(B: int, d: int, m_p: int, bits: int, sms: int) -> int:
    """Fan-in splits of K1-decode (the blocks of one cluster) on a card of
    ``sms`` SMs: one block of 256 columns an SM, so the most that keep the
    grid within one wave, at most ``DECODE_RULE_SPLITS`` and the groups of
    8 word rows of the shortest plane; a count that divides the groups
    evenly is taken when one lies within a factor 1.5 below; then more
    until the block's shared memory fits ``DECODE_SMEM_MAX``."""
    col_blocks = -(-m_p // DECODE_BN)
    groups = [decode_groups(d, fb) for fb, _ in PLANE_SPLITS[bits]]
    most = min(DECODE_MAX_SPLITS, min(groups))
    s = max(1, min(most, DECODE_RULE_SPLITS, sms // col_blocks))
    even = [c for c in range(1, s + 1)
            if all(g % c == 0 for g in groups) and c >= s / 1.5]
    if even:
        s = max(even)
    while _decode_smem(B, d, bits, s) > DECODE_SMEM_MAX and s < most:
        s += 1
    if _decode_smem(B, d, bits, s) > DECODE_SMEM_MAX:
        raise ValueError(f"dequant_matmul: d={d} at {bits} bits with {B} "
                         f"rows does not fit K1-decode's shared memory")
    return s


def decode_ragged(planes: Sequence[torch.Tensor]) -> bool:
    """Whether K1-decode fills its ring by cp.async copies instead of TMA:
    a tensor map needs 16-byte rows (m_p % 4 == 0) and a 16-byte aligned
    plane."""
    return any(p.shape[-1] % 4 or p.data_ptr() % 16 for p in planes)


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
                  code_bits: Optional[int] = None,
                  plan: Optional[tuple] = None) -> torch.Tensor:
    """For tests only: the index algebra of K1-tile in plain PyTorch, f32
    out. ``plan`` is (tokens a block N, fan-in splits), ``_tile_plan``'s on
    132 SMs by default. Rows of x pad to whole tiles of N tokens (TMA's
    zero fill; the work items (token tile, column tile, split) are
    independent, whichever block takes them); output columns go in blocks
    of 256, lane (g, t) of warp w of consumer warpgroup c holding columns
    256y + 128c + 32w + 4g + q, q = 2 mt + h (A tile mt, row 16w + g + 8h).
    Each plane reads x in its stage order, as ``dm_prep`` writes it:
    column 16 L + c is x's column k·2nw + 16·rg + c of slice L = (word row
    group rg = L // fph, field k = L % fph), zero past the field's span.
    Per split of the fan-in (stages [ns·split / splits, ns·(split + 1) /
    splits) of each plane) the planes run heavier first into one
    accumulator: stage s is xp's columns 128s .. + 127, two boxes of 64,
    slice u = 4 hb + v of it in box hb at v·16 (batch hb of 4 slices); its
    A registers are, for column (.., q): ((w >> f·k) & mask) | 0x43004300
    of the words (8rg + t + 4hi, column), two bf16 values 128 + c at
    k-index 2t + 8hi + half, less 128 in bf16 (word rows >= nw and columns
    >= m_p read zero). After a plane, acc *= its weight over the next
    one's (the last: its own). The splits' partials add in split order,
    then the fix-up with Σ bf16(x)."""
    B, d = x.shape
    m_p = planes[0].shape[-1]
    sb = PLANE_SPLITS[bits]
    n_tok, splits = plan or _tile_plan(B, d, m_p, bits, 132)
    Bp, ncol = -(-B // n_tok) * n_tok, -(-m_p // TILE_BN) * TILE_BN
    xb = torch.zeros((Bp, d), dtype=torch.bfloat16)
    xb[:B] = x.to(torch.bfloat16)
    xsum = xb[:B].to(torch.float32).sum(dim=1, keepdim=True)
    # a lane's first column for (column block y, warpgroup c, warp w, g)
    y_, c_, w_, g_ = torch.meshgrid(
        torch.arange(ncol // TILE_BN), torch.arange(2), torch.arange(4),
        torch.arange(8), indexing="ij")
    base = (TILE_BN * y_ + 128 * c_ + 32 * w_ + 4 * g_).reshape(-1)
    cols = base[:, None] + torch.arange(4)              # (lane, q)
    t_, hi_ = torch.arange(4)[:, None], torch.arange(2)[None, :]
    total = None
    for split in range(splits):
        acc = torch.zeros((Bp, ncol), dtype=torch.float32)
        for p in reversed(range(len(planes))):
            fb, pw = sb[p]
            fph, nw = 16 // fb, d * fb // 32
            ns = _tile_stages(d, fb)
            xp = torch.zeros((Bp, 128 * ns), dtype=torch.bfloat16)
            for L in range(-(-nw // 8) * fph):          # dm_prep
                rg, k = divmod(L, fph)
                n = max(0, min(16, 2 * nw - 16 * rg))
                c0 = k * 2 * nw + 16 * rg
                xp[:, 16 * L:16 * L + n] = xb[:, c0:c0 + n]
            words = torch.zeros((8 * -(-8 * ns // fph) + 8, ncol),
                                dtype=torch.int64)
            words[:nw, :m_p] = planes[p].to(torch.int64) & 0xFFFFFFFF
            pair_mask = ((1 << fb) - 1) * 0x00010001
            for s in range(ns * split // splits, ns * (split + 1) // splits):
                for hb in range(2):
                    box = xp[:, 128 * s + 64 * hb:128 * s + 64 * hb + 64]
                    for v in range(4):
                        rg, k = divmod(8 * s + 4 * hb + v, fph)
                        w = words[8 * rg + t_ + 4 * hi_][:, :, cols]
                        reg = ((w >> (fb * k)) & pair_mask) | 0x43004300
                        halves = torch.stack((reg & 0xFFFF, reg >> 16), -1)
                        a = halves.to(torch.int16).view(torch.bfloat16) - 128
                        # k-index 8hi + 2t + half; column (lane, q) in order
                        frag = a.permute(1, 0, 4, 2, 3).reshape(16, ncol)
                        acc += box[:, 16 * v:16 * v + 16].to(
                            torch.float32) @ frag.to(torch.float32)
            acc *= pw / sb[p - 1][1] if p else pw
        total = acc if total is None else total + acc
    y, maxq = total[:B, :m_p], float(2 ** (code_bits or bits) - 1)
    if qfn == "b":
        return (torch.as_tensor(scale, dtype=torch.float32)
                * ((2.0 / maxq) * y - xsum))
    sc = scale.reshape(-1).to(torch.float32)
    return sc * y - sc * zero.reshape(-1).to(torch.float32) * xsum


def decode_walk_ref(x: torch.Tensor, planes: Sequence[torch.Tensor],
                    scale, zero, *, bits: int, qfn: str = "b",
                    code_bits: Optional[int] = None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """For tests only: the index algebra of K1-decode in plain PyTorch, f32
    out, B <= 8. ``splits`` of the fan-in, ``_decode_plan``'s on 132 SMs by
    default. Output columns go in blocks of 256, 128 a consumer warpgroup
    c; row R = 16w + g + 8h of the warpgroup's m-tile mt (lane (g, t) of
    warp w) is column 256y + 128c + 32w + 4g + 2mt + h of block y (columns
    >= m_p read zero words). Per split of the
    fan-in (groups [G·split / splits, G·(split + 1) / splits) of 8 word
    rows of each plane) and plane (heavier first) x is staged as
    ``dm_decode`` does: slice (group, field k) holds x's columns k·2nw +
    16·group + (0..15), zero past the field's span. Group by group, in
    batches of 4 fields (2 at 4 bits), field by field, each m-tile's A is
    built from the words (8·group + t + 4hh, column), shifted once a run
    and masked in place, at bit f·r with r = k mod (7 // f) its place in
    the run, under the exponent of 2^(7 - f·r): two bf16 values 2^(7 - f·r)
    + c at k-index 2t + 8hh + h (word row 8·group + j at k-index 2j + h);
    D (64 x 8 rows of x) += A · (the slice's staged 16 x B), in f32, each
    plane into accumulators of its own; a split's partial is Σ_p
    pw_p·acc_p. The splits' partials add in split order, 128·Σ_p pw_p·Σ_k
    2^-(f·r)·Σ (field k's staged x) comes off once, then the fix-up with
    Σ bf16(x)."""
    B, d = x.shape
    assert 1 <= B <= DECODE_MAX_B
    m_p = planes[0].shape[-1]
    sb = PLANE_SPLITS[bits]
    splits = splits or _decode_plan(B, d, m_p, bits, 132)
    ncol = -(-m_p // DECODE_BN) * DECODE_BN
    # tile u = (block column base 128·(u // 2), m-tile u % 2), row R
    R, u = torch.arange(64), torch.arange(ncol // 64)[:, None]
    colmap = (128 * (u // 2) + 32 * (R // 16) + 4 * (R % 8) + 2 * (u % 2)
              + (R % 16) // 8).reshape(-1)
    xb = x.to(torch.bfloat16)
    as_bf16 = lambda v: v.to(torch.int16).view(torch.bfloat16)  # noqa: E731
    partial = torch.zeros((splits, B, ncol), dtype=torch.float32)
    sums_part = torch.zeros((splits, 2, B), dtype=torch.float32)
    for s in range(splits):
        part = torch.zeros((ncol, B), dtype=torch.float32)   # tile order
        for p in reversed(range(len(planes))):
            acc = torch.zeros((ncol, B), dtype=torch.float32)  # D
            fb, pw = sb[p]
            fph, nw, fg = 16 // fb, d * fb // 32, 7 // fb
            groups = decode_groups(d, fb)
            rg0, rg1 = groups * s // splits, groups * (s + 1) // splits
            # staged x: (slice, 16, B), zero past each field's span
            L = torch.arange((rg1 - rg0) * fph)
            k, rgl = L % fph, L // fph
            off = (16 * (rg0 + rgl))[:, None] + torch.arange(16)
            ok = off < 2 * nw
            src = torch.where(ok, (k * 2 * nw)[:, None] + off, 0)
            xs = torch.where(ok[..., None], xb.t()[src],
                             torch.zeros((), dtype=xb.dtype))
            staged = xs.to(torch.float32)                # (slice, 16, B)
            down = torch.pow(2.0, -fb * (k % fg).to(torch.float32))
            if p == 0:
                sums_part[s, 0] = staged.sum((0, 1))
            sums_part[s, 1] += pw * (staged * down[:, None, None]).sum((0, 1))
            words = torch.zeros((8 * groups, ncol), dtype=torch.int64)
            words[:nw, :m_p] = planes[p].to(torch.int64) & 0xFFFFFFFF
            words = words[:, colmap]                # columns in tile order
            pair_mask = ((1 << fb) - 1) * 0x00010001
            fpb = 2 if fb == 4 else 4
            for rg in range(rg0, rg1):
                w8 = words[8 * rg:8 * rg + 8]       # (j, tile row)
                for q in range(fph // fpb):         # a batch of fields
                    for v in range(fpb):
                        kk = q * fpb + v
                        sh, r = fb * fg * (kk // fg), kk % fg
                        er = 0x43004300 - fb * r * 0x00800080
                        reg = ((w8 >> sh) & (pair_mask << (fb * r))) | er
                        A = torch.stack((as_bf16(reg & 0xFFFF),
                                         as_bf16(reg >> 16)), -1)
                        A = A.permute(1, 0, 2).reshape(ncol, 16)  # 2j + h
                        acc += (A.to(torch.float32)
                                @ staged[(rg - rg0) * fph + kk])
            part += pw * acc
        partial[s][:, colmap] = part.t()
    total = torch.zeros((B, ncol), dtype=torch.float32)
    sums = torch.zeros((2, B), dtype=torch.float32)
    for s in range(splits):                     # split order
        total += partial[s]
        sums += sums_part[s]
    xsum = sums[0, :, None]
    y = total[:, :m_p] - 128.0 * sums[1, :, None]
    maxq = float(2 ** (code_bits or bits) - 1)
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
    ("decode" or "tile") overrides the dispatch rule ``route`` on a CUDA
    tensor, for measuring one kernel against the other."""
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, planes, scale, zero, bits=bits, qfn=qfn,
                                  code_bits=code_bits)
    global launches, launches_tile, launches_decode, launches_decode_ragged
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
    if path not in (None, "decode", "tile"):
        raise ValueError(f"dequant_matmul: unknown path {path!r}")
    if path is None:
        path = route(B, d, m_p, bits)
    elif path == "tile" and not tile_takes(d, m_p, bits):
        raise ValueError(f"dequant_matmul: K1-tile does not take d={d}, "
                         f"m={m_p} at {bits} bits")
    if x.data_ptr() % 32:
        x = x.clone()
    if path == "decode":
        ragged = decode_ragged(planes)
        # more than 8 rows (a shape K1-tile does not take): 8 at a time
        for b0 in range(0, B, DECODE_MAX_B):
            rows = min(DECODE_MAX_B, B - b0)
            splits = _decode_plan(rows, d, m_p, bits,
                                  _build.sm_count(x.get_device()))
            err = _entry_decode()(
                x[b0:].data_ptr(), int(x.dtype == torch.bfloat16), rows, d,
                planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
                nplanes, float(splits_bits[0][1]), float(pw1), m_p,
                int(ragged), splits, int(qfn == "b"), maxq, sc.data_ptr(),
                ze.data_ptr(), out[b0:].data_ptr(), stream)
            _build.check(err, "dequant_matmul (decode)")
            launches += 1
            launches_decode += 1
            launches_decode_ragged += int(ragged)
        return out
    n_tok, splits = _tile_plan(B, d, m_p, bits,
                               _build.sm_count(x.get_device()))
    # x in each plane's stage order (dm_prep), one copy per field width
    widths = {fb for fb, _ in splits_bits}
    xp = torch.empty((B, 128 * sum(_tile_stages(d, fb) for fb in widths)),
                     dtype=torch.bfloat16, device=x.device)
    work = torch.empty(-(-B // 4) * 4
                       + (splits * B * m_p if splits > 1 else 0),
                       dtype=torch.float32, device=x.device)
    err = _entry_tile()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, d,
        planes[0].data_ptr(), splits_bits[0][0], p1.data_ptr(), fb1,
        nplanes, float(splits_bits[0][1]), float(pw1), m_p, n_tok, splits,
        xp.data_ptr(), work.data_ptr(), int(qfn == "b"), maxq,
        sc.data_ptr(), ze.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "dequant_matmul (tile)")
    launches += 1
    launches_tile += 1
    return out
