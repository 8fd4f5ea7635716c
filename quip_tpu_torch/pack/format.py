"""Packed int2/3/4/8 weight format (bit-identical to quip_tpu's v2 planes).

A plane is an int32 tensor of shape (nwords, m): fan-in packed along the
word axis, out-features along the last axis. Word (j, i) carries the code
of weight row i at bit-field (16*h + bits*k), h in {0, 1},
k in 0..(16/bits)-1, for fan-in column ``c = k * (2 * nwords) + 2 * j + h``.
Every plane holds 1, 2 or 4-bit fields; wider widths compose planes
(PLANE_SPLITS). ``quip_tpu/pack/format.py`` is the reference: the tests
hold these planes equal to its planes word for word.

Codes on the CPU pack and unpack through the host packer
(``pack/native.py``, C++ built by g++ at first use), codes on the card
through the torch ops ``_pack_plane`` / ``_unpack_plane``, which are also
the plain version the tests hold the host packer against.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

from quip_tpu_torch.core import incoherence as inc

# Packed-plane layout version, quip_tpu's: v2 = halfword-spread transposed
# (nwords, m) planes. Checkpoints record it; loaders reject others.
PACK_FORMAT_VERSION = 2

# (field bit width, code-combine weight) per plane, keyed by total width
PLANE_SPLITS = {
    2: ((2, 1),),
    3: ((2, 1), (1, 4)),
    4: ((4, 1),),
    8: ((4, 1), (4, 16)),
}


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _pack_plane(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (m, d) integer codes (< 2**bits, bits in {1,2,4}) into a
    halfword-spread transposed (d*bits//32, m) int32 plane."""
    m, d = codes.shape
    fph = 16 // bits
    cpw = 2 * fph
    assert d % cpw == 0, f"d={d} must be divisible by {cpw}"
    nw = d // cpw
    # fan-in column c = k*(2*nw) + 2*j + h  ->  axes (k, j, h)
    c = codes.to(torch.int64).t().reshape(fph, nw, 2, m)
    word = torch.zeros((nw, m), dtype=torch.int64, device=codes.device)
    for k in range(fph):
        for h in range(2):
            word |= c[k, :, h, :] << (16 * h + bits * k)
    return _to_int32(word)


def _unpack_plane(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Inverse of _pack_plane -> (m, d) int32 codes."""
    fph = 16 // bits
    w = words.to(torch.int64) & 0xFFFFFFFF
    mask = 2 ** bits - 1
    c = torch.stack(
        [torch.stack([(w >> (16 * h + bits * k)) & mask for h in range(2)],
                     dim=1)
         for k in range(fph)], dim=0)              # (fph, nw, 2, m)
    return c.reshape(d, words.shape[-1]).t().to(torch.int32)


def padded_m(m: int, d: int, bits: int) -> int:
    """quip_tpu's out-feature pad (pack/format.py::padded_m): the smallest
    128-aligned m' <= m + ~2.5% whose tiles sit in its measured fast band.
    Kept here only so planes made by either package have the same shapes
    (22016 -> 22528 for Llama-2-7B's fused gate-up); the CUDA kernel takes
    any m. Padded rows are zero codes; qlinear slices them off.
    ``QUIP_NO_PAD_M=1`` (read at call time, as in quip_tpu) returns m."""
    if os.environ.get("QUIP_NO_PAD_M") == "1":
        return m

    def band_score(mm: int):
        scores = [abs(d * t * bits / 8 - 2.9e6)
                  for t in range(128, mm // 4 + 1, 128)
                  if mm % t == 0 and 1.5e6 <= d * t * bits / 8 <= 3.5e6
                  and 4 <= mm // t <= 16]
        return min(scores) if scores else None

    if m % 128 == 0 and band_score(m) is not None:
        return m
    cap = m + max(128, int(m * 0.025) // 128 * 128)
    best, best_score = m, None
    mm = (m + 127) // 128 * 128
    while mm <= cap:
        s = band_score(mm)
        if s is not None and (best_score is None or s < best_score):
            best, best_score = mm, s
        mm += 128
    return best


def pack_codes(codes: torch.Tensor, bits: int) -> Tuple[torch.Tensor, ...]:
    """Integer grid codes (m, d) -> one (nw, m) int32 plane per
    PLANE_SPLITS entry, on the codes' device (the host packer for CPU
    codes)."""
    if bits not in PLANE_SPLITS:
        raise ValueError(f"unsupported bit width {bits}")
    if codes.device.type == "cpu":
        from quip_tpu_torch.pack import native
        return native.pack(codes, bits)
    planes = []
    shift = 0
    codes = codes.to(torch.int64)
    for field_bits, _ in PLANE_SPLITS[bits]:
        part = (codes >> shift) & ((1 << field_bits) - 1)
        planes.append(_pack_plane(part, field_bits))
        shift += field_bits
    return tuple(planes)


def unpack_codes(planes, bits: int, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> (m, d) int32 codes."""
    if bits not in PLANE_SPLITS:
        raise ValueError(f"unsupported bit width {bits}")
    if planes[0].device.type == "cpu":
        from quip_tpu_torch.pack import native
        return native.unpack(planes, bits, d)
    out = None
    shift = 0
    for plane, (field_bits, _) in zip(planes, PLANE_SPLITS[bits]):
        part = _unpack_plane(plane, field_bits, d)
        out = part << shift if out is None else out | (part << shift)
        shift += field_bits
    return out


def _slot(t):
    """The JAX trees mark an absent rotation slot with ``()``."""
    return None if (isinstance(t, tuple) and not t) or t is None else t


class PackedLinear(nn.Module):
    """One packed quantized linear: y = x @ Ŵᵀ reconstructed from codes.

    qfn 'b': Ŵ_rot = ((codes/maxq)*2 - 1) * scale_b, with the rotation pair
    (U, V) and the diagonal rescale around it; qfn 'a': Ŵ = scale_row *
    (codes - zero_row), no rotation. Planes, grid parameters, bias and the
    rotation components are buffers, so ``.to(device)`` moves them all.

    ``rot`` has quip_tpu's layout. RHT modes: {'u': (signs|(), left,
    right|()), 'v': (...), 'vin': vector|()}, buffers ``u_signs``,
    ``u_left``, ``u_right`` (and v) and ``vin``. Butterfly modes: {'u':
    (blocks, perm_in, perm_out), 'v': (...)} with one or two blocks a side
    ((n/p or 1, p, p), buffers ``u_block0`` / ``u_block1``) and int32 perms
    or None ('nopermute'), buffers ``u_perm_in`` / ``u_perm_out``; their
    inverses ``u_inv_in`` / ``u_inv_out`` are derived here, once, so the
    transposed application gathers without an argsort, and are never
    written to a checkpoint. ``scaleWH`` stays its own buffer (no vin). A
    model made by the JAX package brings its materialised arrays;
    models/build.py draws them from a torch.Generator
    (materialize_rotation). None = no rotation.
    """

    def __init__(self, planes, scale=None, zero=None, scale_b=None,
                 scaleWH=None, bias=None, *, bits: int, qfn: str,
                 proj_mode: str, out_features: int, in_features: int,
                 rot=None, code_bits: Optional[int] = None):
        super().__init__()
        if len(planes) != len(PLANE_SPLITS[bits]):
            raise ValueError(f"{bits}-bit needs {len(PLANE_SPLITS[bits])} "
                             f"planes, got {len(planes)}")
        self.nplanes = len(planes)
        for p, plane in enumerate(planes):
            self.register_buffer(f"plane{p}", plane)
        self.register_buffer("scale", scale)        # (m,) qfn-a
        self.register_buffer("zero", zero)          # (m,) qfn-a
        self.register_buffer("scale_b", scale_b)    # () qfn-b
        self.register_buffer("scaleWH", scaleWH)    # (d,)
        self.register_buffer("bias", bias)          # (m,)
        self.has_rot = rot is not None
        self.butterfly = self.has_rot and inc.is_butterfly(proj_mode)
        self.has_vin = self.has_rot and "vin" in rot
        self.nblocks = {}
        for side in ("u", "v"):
            rht = (None,) * 3
            if self.butterfly:
                blocks, pin, pout = rot[side]
                self.nblocks[side] = len(blocks)
                for i, b in enumerate(blocks):
                    self.register_buffer(f"{side}_block{i}", b)
                for nm, t in (("in", _slot(pin)), ("out", _slot(pout))):
                    self.register_buffer(f"{side}_perm_{nm}", t)
                    self.register_buffer(f"{side}_inv_{nm}",
                                         inc.inverse_perm(t))
            elif self.has_rot:
                rht = rot[side]
            for nm, t in zip(("signs", "left", "right"), rht):
                self.register_buffer(f"{side}_{nm}", _slot(t))
        self.register_buffer(
            "vin", _slot(rot["vin"]) if self.has_vin else None)
        self.bits = bits
        self.qfn = qfn
        self.proj_mode = proj_mode
        self.out_features = out_features
        self.in_features = in_features
        self.code_bits = code_bits
        self.register_load_state_dict_post_hook(_refresh_fused)

    @property
    def planes(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"plane{p}") for p in range(self.nplanes))

    def extra_repr(self) -> str:
        return (f"{self.out_features}x{self.in_features}, {self.bits}-bit, "
                f"qfn={self.qfn!r}, proj_mode={self.proj_mode!r}")

    @property
    def maxq(self) -> float:
        return float(2 ** (self.code_bits or self.bits) - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from quip_tpu_torch.ops.qlinear import qlinear_apply
        return qlinear_apply(self, x)

    def _host_grid(self, dtype) -> bool:
        """Whether ``dequantize`` takes the host packer's grid step
        (``native.dequant_table``): single-plane (2- or 4-bit, widened
        3-bit codes too) qfn-b planes on the CPU, dequantized to
        float32."""
        return (self.qfn == "b" and self.nplanes == 1
                and dtype == torch.float32
                and self.plane0.device.type == "cpu")

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The dense Ŵ (m, d) in the original space (quip_tpu's
        ``PackedLinear.dequantize``): codes -> grid values -> Uᵀ · V -> the
        diagonal un-scale. Sign-folded modes carry no sign slot where the
        signs live in the codes, so one un-rotation covers all three."""
        if self._host_grid(dtype):
            # the host packer's one pass through the 2**bits grid values,
            # each made by the expression below: the same bits
            from quip_tpu_torch.pack import native
            grid = torch.arange(2 ** self.bits, dtype=dtype)
            grid = ((grid / self.maxq) * 2 - 1) * self.scale_b.to(dtype)
            W = native.dequant_table(self.planes, self.bits,
                                     self.in_features,
                                     grid)[: self.out_features]
        else:
            codes = unpack_codes(self.planes, self.bits, self.in_features)
            codes = codes[: self.out_features].to(dtype)
            if self.qfn == "b":
                W = ((codes / self.maxq) * 2 - 1) * self.scale_b.to(dtype)
            else:
                W = self.scale.to(dtype)[:, None] * (
                    codes - self.zero.to(dtype)[:, None])
        if self.butterfly:
            W = inc.unrotate_weight(*rot_to_butterflies(self), W)
        elif self.has_rot:
            U, V = rot_to_butterflies(self)
            W = inc.rht_unrotate_weight(U, V, W)
        if self.scaleWH is not None:
            W = W / self.scaleWH.to(dtype)[None, :]
        return W


def _refresh_fused(module: PackedLinear, incompatible_keys) -> None:
    """After ``load_state_dict``: the fused path's bf16 copies of the
    rotation buffers follow the values just copied in
    (ops/qlinear.py::refresh_fused)."""
    from quip_tpu_torch.ops.qlinear import refresh_fused
    refresh_fused(module)


def rotation_buffers(U, V, mode: str,
                     scaleWH: Optional[torch.Tensor] = None,
                     dtype=torch.float32, device=None):
    """The runtime rotation components of the given pair (U, V) in
    quip_tpu's ``rot`` layout (its materialize_rotation). 'rht': both sign
    vectors, plus vin = signs_V/scaleWH (the diagonal un-scale and the
    V-side sign flip in one vector); 'rht_sf': no sign slots (the signs
    live in the codes), vin = 1/scaleWH or nothing; 'rht_uf': the U-side
    signs in the code rows, the V side as 'rht'. Butterfly modes: each
    side's (blocks, perm_in, perm_out), perms int32 or None, no vin."""
    put = lambda t: t.to(dtype=dtype, device=device)  # noqa: E731
    if inc.is_butterfly(mode):
        perm = lambda t: (None if t is None  # noqa: E731
                          else t.to(dtype=torch.int32, device=device))
        return {side: (tuple(put(b) for b in t.blocks), perm(t.perm_in),
                       perm(t.perm_out))
                for side, t in (("u", U), ("v", V))}
    right = lambda t: () if t.right is None else put(t.right)  # noqa: E731
    sWH = None if scaleWH is None else put(scaleWH)
    if mode == "rht_sf":
        return {"u": ((), put(U.left), right(U)),
                "v": ((), put(V.left), right(V)),
                "vin": () if sWH is None else 1.0 / sWH}
    vs = put(V.signs)
    vin = vs if sWH is None else vs / sWH
    us = () if mode == "rht_uf" else put(U.signs)
    return {"u": (us, put(U.left), right(U)),
            "v": (vs, put(V.left), right(V)), "vin": vin}


def materialize_rotation(gen: Optional[torch.Generator], m: int, d: int,
                         mode: str, dtype=torch.float32, device=None,
                         scaleWH: Optional[torch.Tensor] = None):
    """``rotation_buffers`` of a fresh pair (U, V) drawn from ``gen`` (the
    RNG decision in core/incoherence.py); ``gen=None`` means no rotation.
    For the random-code builder (models/build.py): a quantized layer packs
    the pair it was quantized against (``pack_layer_result``)."""
    if gen is None:
        return None
    U, V = inc.gen_pair(gen, m, d, mode, dtype, device)
    return rotation_buffers(U, V, mode, scaleWH, dtype, device)


def rot_to_butterflies(q: PackedLinear):
    """(U, V) transform views over the stored rotation buffers: RHTs
    (absent sign slots stay None), or butterflies carrying their derived
    inverse permutations."""
    if q.butterfly:
        def bf(side, n):
            return inc.Butterfly(
                tuple(getattr(q, f"{side}_block{i}")
                      for i in range(q.nblocks[side])),
                getattr(q, f"{side}_perm_in"), getattr(q, f"{side}_perm_out"),
                n, getattr(q, f"{side}_inv_in"),
                getattr(q, f"{side}_inv_out"))
        return bf("u", q.out_features), bf("v", q.in_features)
    return (inc.RHT(q.u_signs, q.u_left, q.u_right, q.out_features),
            inc.RHT(q.v_signs, q.v_left, q.v_right, q.in_features))


def fold_rht_signs(codes: torch.Tensor, su: torch.Tensor, sv: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Fold the outer RHT sign vectors s_u (m,) and s_v (d,) into qfn-b
    codes (proj_mode 'rht_sf'): entry (i, j) of the sign-stripped payload
    differs from the quantized one by s_u[i]·s_v[j], and the symmetric grid
    negates exactly under c -> maxq - c."""
    neg = (su[:, None] * sv[None, :]) < 0
    return torch.where(neg, (2 ** bits - 1) - codes, codes)


def fold_rht_sign_rows(codes: torch.Tensor, su: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """Row-only fold for 'rht_uf': only the U-side signs are outer."""
    return torch.where(su[:, None] < 0, (2 ** bits - 1) - codes, codes)


def pack_layer_result(res, bits: int,
                      bias: Optional[torch.Tensor] = None) -> PackedLinear:
    """A PackedLinear from a ``quantize_layer`` LayerQuantResult, on the
    result's device. The rotation buffers are built from the result's own
    (U, V), the pair the codes were quantized against."""
    if res.codes is None:
        raise ValueError(
            "method produced no integer codes to pack (grouped grids "
            "(groupsize>0) quantize per-group and cannot be packed; use "
            "per-row grids)")
    codes = res.codes.to(torch.int32)
    m, d = codes.shape
    st = res.preproc
    if st.proj_mode in ("rht_sf", "rht_uf") and st.U is not None:
        if res.qfnb_scale is None:
            raise ValueError("sign folding needs the symmetric qfn-b grid "
                             "(c -> maxq - c)")
        su = st.U.signs.to(codes.device)
        if st.proj_mode == "rht_sf":
            codes = fold_rht_signs(codes, su, st.V.signs.to(codes.device),
                                   bits)
        else:
            codes = fold_rht_sign_rows(codes, su, bits)
    # qfn-b (scalar grid): pad out-features as quip_tpu does (padded_m);
    # qfn-a keeps m (its per-row scale/zero would need padding too)
    if res.qfnb_scale is not None:
        mp = padded_m(m, d, bits)
        if mp != m:
            codes = torch.nn.functional.pad(codes, (0, 0, 0, mp - m))
    f32 = lambda t: None if t is None else t.to(torch.float32)  # noqa: E731
    g = res.grid
    return PackedLinear(
        pack_codes(codes, bits),
        None if g is None else f32(g.scale).reshape(-1),
        None if g is None else f32(g.zero).reshape(-1),
        f32(res.qfnb_scale), f32(st.scaleWH), bias,
        bits=bits, qfn="b" if res.qfnb_scale is not None else "a",
        proj_mode=st.proj_mode, out_features=m, in_features=d,
        rot=None if st.U is None else rotation_buffers(
            st.U, st.V, st.proj_mode, st.scaleWH, device=codes.device))


def _rot_of(q: PackedLinear):
    """``q``'s rotation buffers back in quip_tpu's ``rot`` layout (None
    without a rotation; a 'nopermute' butterfly's perms None, an absent RHT
    slot ``()``, as quip_tpu's trees hold them)."""
    if not q.has_rot:
        return None
    if q.butterfly:
        return {side: (t.blocks, t.perm_in, t.perm_out)
                for side, t in zip(("u", "v"), rot_to_butterflies(q))}
    slot = lambda t: () if t is None else t  # noqa: E731
    rot = {side: tuple(slot(getattr(q, f"{side}_{nm}"))
                       for nm in ("signs", "left", "right"))
           for side in ("u", "v")}
    if q.has_vin:
        rot["vin"] = slot(q.vin)
    return rot


def widen_3bit(q: PackedLinear) -> PackedLinear:
    """3-in-4 serving transcode (quip_tpu's ``widen_3bit``): the two-plane
    3-bit format (a 2-bit plane and a 1-bit plane) repacked into ONE 4-bit
    plane of the same 3-bit codes (``code_bits=3`` keeps maxq = 7, so the
    grid and every dequantised weight are unchanged). Other widths come back
    as they are. The transcode unpacks and repacks on the planes' own
    device; everything but the planes is shared with ``q``.

    quip_tpu widens because the TPU's 1-bit plane costs 16 thin matrix-unit
    dots per word; on the H100 the 4-bit fields read a third more bytes
    than the two planes (PERF.md weighs the two layouts)."""
    if q.bits != 3:
        return q
    d = q.in_features
    planes = pack_codes(unpack_codes(q.planes, 3, d), 4)
    return PackedLinear(planes, q.scale, q.zero, q.scale_b, q.scaleWH,
                        q.bias, bits=4, qfn=q.qfn, proj_mode=q.proj_mode,
                        out_features=q.out_features, in_features=d,
                        rot=_rot_of(q), code_bits=3)


def widen_3bit_tree(params, memo: Optional[dict] = None):
    """``params`` (a models/model.py ``Model``) with every 3-bit
    PackedLinear widened (``widen_3bit``): a new Model whose blocks hold the
    widened linears and share every other module and tensor with
    ``params``, or ``params`` itself when nothing is 3-bit.
    ``QUIP_NO_WIDEN3=1`` (read at call time, as in quip_tpu) keeps the
    two-plane format. ``memo`` (id of a module -> its widened form),
    passed to the calls for a target and its draft, widens the blocks and
    linears they share once, and the results stay shared."""
    if os.environ.get("QUIP_NO_WIDEN3") == "1":
        return params
    from quip_tpu_torch.models import model as M
    memo = {} if memo is None else memo

    def once(obj, make):
        if id(obj) not in memo:
            memo[id(obj)] = (obj, make(obj))  # keep obj: ids stay unique
        return memo[id(obj)][1]

    def widen(w):
        if not (isinstance(w, PackedLinear) and w.bits == 3):
            return w
        return once(w, widen_3bit)

    def widen_block(b):
        specs = [M.LinearSpec(n, (grp, n), "")
                 for grp, names in (("attn", M.Attention.NAMES),
                                    ("mlp", M.MLP.NAMES))
                 for n in names if widen(getattr(getattr(b, grp), n))
                 is not getattr(getattr(b, grp), n)]
        if not specs:
            return b
        return M.replace_linears(b, specs, lambda _, w: widen(w))

    blocks = [once(b, widen_block) for b in params.blocks]
    head = widen(params.lm_head)
    if head is params.lm_head and all(
            n is b for n, b in zip(blocks, params.blocks)):
        return params
    return M.Model(params.cfg, params.embed, blocks, params.final_ln, head)
