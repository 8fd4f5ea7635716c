"""K3: one fused randomized-Hadamard/Kronecker (RHT) application.

``rht_apply_fused`` applies T = (L ⊗ R) · diag(vec) (or its transpose)
along the last axis of x (B, n) in ONE launch: the elementwise fold and
both Kronecker factor products. It replaces the Pallas kernels of
``quip_tpu/kernels/rht.py`` (``rht_apply_fused`` -> ``_kernel3``, and
``_kernel2`` when there is no right factor) with the hand-written CUDA
kernels in ``csrc/rht.cu``: ``rht_mma`` for bf16 (both products on
``wgmma``, 32 output columns a block;
``rht_walk_ref`` below walks its tiles in plain PyTorch) and ``rht_kernel``
for f32 (FMA on the CUDA cores: tensor-core products would change the f32
function). The un-fused form is ``core/incoherence.apply_rht`` (one
multiply and two matmuls, each with its casts). ``ops/qlinear.py`` routes
decode-size batches through it when ``QUIP_FUSED_RHT=1``. Its bytes and
operations are tiny for the card; the launch and one round trip to L2 set
its time (design note in the source).

  forward:    y = L @ reshape_{a,b}(x * vec) @ Rᵀ    (vec = signs, or
              signs / scaleWH: the divide folds into the same vector)
  transpose:  y = (Lᵀ @ reshape_{a,b}(x) @ R) * vec

The roundings are part of the function (T = x's dtype): ``x * vec`` in T,
each product summed in f32 and rounded to T, the transpose's ``* vec`` last
and in T; vec, L and R arrive f32 and are rounded to T. The bf16 kernel
reads them as bf16 copies in its own layout (``prepare``), made once per
set of factors and direction and kept in a cache keyed by the source
tensors (``operands``; ``refresh`` prepares again those whose sources were
written in place): derived state, never part of a module's ``state_dict``
or of a checkpoint.

Dispatch goes by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``rht_apply_fused_ref``, the plain version with the same
roundings.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from quip_tpu_torch.kernels import _build

launches = 0          # kernel launches, read by callers

NQ = 32               # output columns a block of the bf16 kernel (wgmma N)
VLD = NQ + 8          # row stride of a block's slice of the transpose's vec
_MAX_SMEM = {True: 220 * 1024, False: 227 * 1024}   # by bf16: what the
                                                     # kernels ask for
_fns = None
_fn_bf16 = None       # the bf16 entry (the tuning tools swap in copies)


def _entry():
    global _fns, _fn_bf16
    if _fns is None:
        lib = _build.load("rht")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.quip_rht_apply.argtypes = [P, I, I, I, P, P, P, I, P, P]
        lib.quip_rht_apply.restype = ctypes.c_int
        lib.quip_rht_apply_bf16.argtypes = [P, I, I, I, P, P, P, I, P, P]
        lib.quip_rht_apply_bf16.restype = ctypes.c_int
        lib.quip_rht_smem_bytes.argtypes = [I, I, I, I, I]
        lib.quip_rht_smem_bytes.restype = ctypes.c_longlong
        lib.quip_rht_empty.argtypes = [P]
        lib.quip_rht_empty.restype = ctypes.c_int
        _fns = (lib.quip_rht_apply, lib.quip_rht_smem_bytes,
                lib.quip_rht_empty)
        if _fn_bf16 is None:
            _fn_bf16 = lib.quip_rht_apply_bf16
    return _fns


def x_len(a: int, b: int) -> int:
    """Elements of x's (and the forward vec's) buffer in the bf16 kernel's
    shared memory: the row flat, 64 ceil(a / 64) rows of b, and the tail
    that its last k16 slices read, rounded up to 8; zero past the row."""
    return -(-(64 * -(-a // 64) * b + 64) // 8) * 8


def block_plan(a: int, b: int) -> Tuple[int, int]:
    """(blocks a row of x, m-tiles of 64 rows) of the bf16 kernel for an
    (a, b) split: a block owns NQ = 32 output columns, so a row takes
    ceil(b / 32) blocks (at most 8), and X's a rows are ceil(a / 64) tiles of wgmma's 64."""
    return -(-b // NQ), -(-a // 64)


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


class Operands(NamedTuple):
    """The bf16 kernel's operands for one set of factors and direction:
    ``left`` is Lop (L, or Lᵀ for the transpose) and ``right`` RopT (R, or
    Rᵀ; the 1 x 1 identity when there is no right factor), each
    zero-padded and laid out by ``_core``; ``vec`` bf16, forward in x's
    buffer layout (``x_len`` elements, zero past the n of the row),
    transpose by block: a rows of the block's NQ
    columns, VLD apart."""
    left: torch.Tensor
    right: torch.Tensor
    vec: torch.Tensor


def _core(m: torch.Tensor, rows: int, group: int,
          kmult: int = 16) -> torch.Tensor:
    """``m`` (r, k) rounded to bf16, zero-padded to (rows, k rounded up to
    ``kmult``), flat in the kernel's K-major layout, ``group`` rows at a
    time: for each
    group, k16 slice by k16 slice, its 8-row blocks, each as the core
    matrices of k 0-7 and 8-15 (8 rows of 8 values, 16 bytes a row). In
    bytes from a group's start: slice s at s · group · 32, the 8-row block
    at 256 more a block, the second half at 128 more: what
    ``desc_plain(addr, 128)`` reads."""
    r, k = m.shape
    kp = -(-k // kmult) * kmult
    out = torch.zeros(rows, kp, dtype=torch.bfloat16, device=m.device)
    out[:r, :k] = m.to(torch.bfloat16)
    return out.reshape(rows // group, group // 8, 8, kp // 16, 2, 8).permute(
        0, 3, 1, 4, 2, 5).reshape(-1)


def _core_read(flat: torch.Tensor, base: int, rows: int, kslices: int,
               slice_elems: int) -> torch.Tensor:
    """The (rows, 16 kslices) matrix that a K-major wgmma operand reads
    through ``desc_plain(addr, 128)`` at element ``base`` of ``flat``, its
    k16 slices ``slice_elems`` apart (the descriptor's addresses, in
    elements)."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16 * kslices)[None, :]
    idx = (base + (k // 16) * slice_elems + (r // 8) * 128
           + ((k % 16) // 8) * 64 + (r % 8) * 8 + k % 8)
    return flat[idx.to(flat.device)]


def prepare(vec: torch.Tensor, left: torch.Tensor,
            right: Optional[torch.Tensor], *, transpose: bool) -> Operands:
    """The bf16 kernel's operands for vec (n,), left (a, a) and right (b,
    b) or None (b = 1): Lop in m-tiles of 64 rows, RopT in blocks of NQ
    rows, its depth padded to batches of 4 k16 slices (the products are Z
    = X · RopTᵀ and Y = Lop · Z)."""
    a = left.shape[0]
    b = 1 if right is None else right.shape[0]
    nq, mt = block_plan(a, b)
    r = (torch.ones(1, 1, device=left.device) if right is None
         else right.t() if transpose else right)
    vb = vec.reshape(a, b).to(torch.bfloat16)
    if transpose:
        cols = torch.zeros(a, nq * NQ, dtype=torch.bfloat16,
                           device=vec.device)
        cols[:, :b] = vb
        v = torch.zeros(nq, a, VLD, dtype=torch.bfloat16, device=vec.device)
        v[:, :, :NQ] = cols.view(a, nq, NQ).permute(1, 0, 2)
        v = v.reshape(-1)
    else:
        v = torch.zeros(x_len(a, b), dtype=torch.bfloat16, device=vec.device)
        v[:a * b] = vb.reshape(-1)
    return Operands(_core(left.t() if transpose else left, 64 * mt, 64 * mt),
                    _core(r, NQ * nq, NQ, 64), v)


# (direction, ids of vec, left and right) -> their entry
_cache: dict = {}


class _Entry:
    """One cached set of operands: weak references to its sources, their
    (address, ``_version``) when it was last prepared, the operands."""
    __slots__ = ("refs", "stamp", "ops", "transpose")

    def __init__(self, srcs, ops: Operands, transpose: bool):
        self.refs = tuple(None if t is None else weakref.ref(t)
                          for t in srcs)
        self.stamp = _stamp(srcs)
        self.ops = ops
        self.transpose = transpose

    def sources(self):
        """The three sources, or None once one of them is gone."""
        srcs = tuple(None if r is None else r() for r in self.refs)
        if any(r is not None and t is None for r, t in zip(self.refs, srcs)):
            return None
        return srcs


def _stamp(srcs):
    return tuple(None if t is None else (t.data_ptr(), t._version)
                 for t in srcs)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _made(t: torch.Tensor) -> None:
    """Operands made (or remade) on the current stream are complete before
    a call on another stream reads them."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _renew(entry: _Entry, srcs) -> None:
    """Prepare ``srcs`` again into the entry's own tensors: their addresses
    stay, so a CUDA graph that captured them reads the new values from its
    next replay."""
    if _capturing(srcs[1]):
        raise RuntimeError(
            "rht operands: a factor was written in place since its bf16 "
            "copies were made; call kernels.rht.refresh() before capturing")
    new = prepare(*srcs, transpose=entry.transpose)
    for old, t in zip(entry.ops, new):
        if old.shape != t.shape:
            raise ValueError("rht operands: a factor changed its shape "
                             "while its bf16 copies serve")
        old.copy_(t)
    entry.stamp = _stamp(srcs)
    _made(srcs[1])


def operands(vec: torch.Tensor, left: torch.Tensor,
             right: Optional[torch.Tensor], *,
             transpose: bool) -> Operands:
    """``prepare``'s operands, made once per (vec, left, right, direction)
    and kept while the three tensors live. A source written in place since
    (its ``_version``) is prepared again into the same tensors, so a CUDA
    graph that captured them sees the new values from its next replay once
    this or ``refresh`` has run. Nothing is cached while a graph is being
    captured (the copies would exist only in its replays), and a stale
    entry then raises."""
    srcs = (vec, left, right)
    key = (transpose,) + tuple(id(t) for t in srcs)
    got = _cache.get(key)
    held = got.sources() if got is not None else None
    if held is not None and all(u is v for u, v in zip(held, srcs)):
        if got.stamp != _stamp(srcs):
            _renew(got, srcs)
        return got.ops
    ops = prepare(vec, left, right, transpose=transpose)
    if not _capturing(left):
        _cache[key] = _Entry(srcs, ops, transpose)
        for t in srcs:
            if t is not None:
                weakref.finalize(t, _cache.pop, key, None)
        _made(left)
    return ops


def refresh() -> None:
    """Prepare again, in place, every cached set of operands whose sources
    were written in place since it was made (``load_state_dict``'s copies:
    ``PackedLinear`` calls this after one), so that CUDA graphs captured
    before read the new factors from their next replay."""
    for entry in list(_cache.values()):
        srcs = entry.sources()
        if srcs is not None and entry.stamp != _stamp(srcs):
            _renew(entry, srcs)


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
                 right: Optional[torch.Tensor], *,
                 transpose: bool = False) -> torch.Tensor:
    """For tests only: the bf16 kernel's walk (``rht_mma``) in plain
    PyTorch, on the operands as ``prepare`` lays them out and read back the
    way the kernel's descriptors read them. Per block (``block_plan``: NQ
    columns q0.. of one row): X (64·mt, 16·ks) from the flat row, zero
    outside (a, b), times the bf16 vec forward (its A fragments); Z = X ·
    the block's RopT rowsᵀ summed in f32 and rounded to bf16 (its ks2 k16
    slices kept: Zᵀ in shared memory); Y = Lop · Z rounded to bf16, the
    transpose's vec last and in bf16; only p < a, q < b written; vec read
    back from its layout. x must be bf16."""
    a, b = _split(x, vec, left, right)
    assert x.dtype == torch.bfloat16
    B, n, f32 = x.shape[0], a * b, torch.float32
    nq, mt = block_plan(a, b)
    ks, ks2 = 4 * -(-b // 64), -(-a // 16)
    ops = prepare(vec, left, right, transpose=transpose)
    if transpose:
        v = ops.vec.reshape(nq, a, VLD)[:, :, :NQ].permute(1, 0, 2).reshape(
            a, nq * NQ)[:, :b]
    else:
        v = ops.vec[:a * b].reshape(a, b)
    lop = _core_read(ops.left, 0, 64 * mt, ks2, 1024 * mt).to(f32)
    X = torch.zeros((B, 64 * mt, 16 * ks), dtype=torch.bfloat16)
    X[:, :a, :b] = x.reshape(B, a, b)
    if not transpose:
        X[:, :a, :b] = X[:, :a, :b] * v
    out = torch.zeros((B, a, nq * NQ), dtype=torch.bfloat16)
    for qs in range(nq):
        ropt = _core_read(ops.right, qs * ks * 512, NQ, ks, 512).to(f32)
        Z = (X.to(f32) @ ropt.t()).to(torch.bfloat16)[:, :16 * ks2]
        Y = (lop @ Z.to(f32)).to(torch.bfloat16)[:, :a]
        out[:, :, qs * NQ:(qs + 1) * NQ] = Y
    out = out[:, :, :b]
    if transpose:
        out = out * v
    return out.reshape(B, n)


def rht_apply_fused(x: torch.Tensor, vec: torch.Tensor, left: torch.Tensor,
                    right: Optional[torch.Tensor], *,
                    transpose: bool = False) -> torch.Tensor:
    """One fused RHT application along the last axis of x (B, n), bf16 or
    f32. vec (n,): the elementwise fold, applied first (forward) or last
    (transpose); left (a, a); right (b, b), or None when n == a. vec, left
    and right are f32. Same semantics as core/incoherence.apply_rht.

    bf16 on the card takes a <= 128 and b <= 256 (every split of the
    models' widths up to 32768); it reads the bf16 copies of ``operands``,
    so a CUDA graph that captured a call sees vec, left or right written in
    place only once ``refresh`` (or an eager call) has run."""
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
    apply_f32, smem_bytes, _ = _entry()
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (a > 128 or b > 256):
        raise ValueError(f"rht_apply_fused: the bf16 kernel takes a <= 128 "
                         f"and b <= 256, got a={a}, b={b}")
    need = smem_bytes(int(bf16), a, b, int(right is not None),
                      int(transpose))
    if need > _MAX_SMEM[bf16]:
        raise ValueError(f"rht_apply_fused: a={a}, b={b} needs {need} bytes "
                         f"of shared memory, a block has {_MAX_SMEM[bf16]}")
    x = x.contiguous()
    if x.data_ptr() % 16:          # a view into a larger buffer
        x = x.clone()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    if bf16:
        ops = operands(vec, left, right, transpose=transpose)
        err = _fn_bf16(x.data_ptr(), B, a, b, ops.vec.data_ptr(),
                       ops.left.data_ptr(), ops.right.data_ptr(),
                       int(transpose), out.data_ptr(), stream)
    else:
        err = apply_f32(x.data_ptr(), B, a, b, vec.data_ptr(),
                        left.data_ptr(),
                        right.data_ptr() if right is not None else None,
                        int(transpose), out.data_ptr(), stream)
    _build.check(err, "rht_apply_fused")
    launches += 1
    return out
