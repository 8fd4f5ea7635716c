"""Packed int2/3/4/8 weight format (bit-identical to quip_tpu's v2 planes).

A plane is an int32 tensor of shape (nwords, m): fan-in packed along the
word axis, out-features along the last axis. Word (j, i) carries the code
of weight row i at bit-field (16*h + bits*k), h in {0, 1},
k in 0..(16/bits)-1, for fan-in column ``c = k * (2 * nwords) + 2 * j + h``.
Every plane holds 1, 2 or 4-bit fields; wider widths compose planes
(PLANE_SPLITS). ``quip_tpu/pack/format.py`` is the reference: the tests
hold these planes equal to its planes word for word.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from quip_tpu_torch.core import incoherence as inc

# (field bit width, code-combine weight) per plane, keyed by total width
PLANE_SPLITS = {
    2: ((2, 1),),
    3: ((2, 1), (1, 4)),
    4: ((4, 1),),
    8: ((4, 1), (4, 16)),
}

_RHT_MODES = ("rht", "rht_sf", "rht_uf")


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
    any m. Padded rows are zero codes; qlinear slices them off."""

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
    PLANE_SPLITS entry."""
    if bits not in PLANE_SPLITS:
        raise ValueError(f"unsupported bit width {bits}")
    planes = []
    shift = 0
    codes = codes.to(torch.int64)
    for field_bits, _ in PLANE_SPLITS[bits]:
        part = (codes >> shift) & ((1 << field_bits) - 1)
        planes.append(_pack_plane(part, field_bits))
        shift += field_bits
    return tuple(planes)


def unpack_codes(planes, bits: int, d: int) -> torch.Tensor:
    if bits not in PLANE_SPLITS:
        raise ValueError(f"unsupported bit width {bits}")
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

    qfn 'b': Ŵ_rot = ((codes/maxq)*2 - 1) * scale_b, with the RHT pair
    (U, V) and the diagonal rescale around it; qfn 'a': Ŵ = scale_row *
    (codes - zero_row), no rotation. Planes, grid parameters, bias and the
    rotation components are buffers, so ``.to(device)`` moves them all.

    ``rot`` has quip_tpu's layout: {'u': (signs|(), left, right|()),
    'v': (...), 'vin': vector|()}. A model made by the JAX package brings
    its materialised arrays; models/build.py draws them from a
    torch.Generator (materialize_rotation). None = no rotation.
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
        self.has_vin = rot is not None and "vin" in rot
        names = ("signs", "left", "right")
        for side in ("u", "v"):
            parts = rot[side] if rot is not None else (None,) * 3
            for nm, t in zip(names, parts):
                self.register_buffer(f"{side}_{nm}", _slot(t))
        self.register_buffer(
            "vin", _slot(rot["vin"]) if self.has_vin else None)
        self.bits = bits
        self.qfn = qfn
        self.proj_mode = proj_mode
        self.out_features = out_features
        self.in_features = in_features
        self.code_bits = code_bits

    @property
    def planes(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"plane{p}") for p in range(self.nplanes))

    def extra_repr(self) -> str:
        return (f"{self.out_features}x{self.in_features}, {self.bits}-bit, "
                f"qfn={self.qfn!r}, proj_mode={self.proj_mode!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from quip_tpu_torch.ops.qlinear import qlinear_apply
        return qlinear_apply(self, x)


def materialize_rotation(gen: Optional[torch.Generator], m: int, d: int,
                         mode: str, dtype=torch.float32, device=None,
                         scaleWH: Optional[torch.Tensor] = None):
    """Runtime rotation components in quip_tpu's ``rot`` layout, drawn from
    ``gen`` (the RNG decision in core/incoherence.py). ``gen=None`` means
    no rotation. 'rht': both sign vectors stay, plus vin = signs_V/scaleWH
    (the diagonal un-scale and the V-side sign flip in one vector);
    'rht_sf': no sign slots (the signs live in the codes), vin = 1/scaleWH
    or nothing; 'rht_uf': U-side signs in the code rows, V side as 'rht'."""
    if gen is None:
        return None
    if mode not in _RHT_MODES:
        raise NotImplementedError(
            f"proj_mode {mode!r}: butterfly modes are a later slice of the "
            f"port (ROADMAP queue 1)")
    U = inc.gen_rht(gen, m, dtype, device)
    V = inc.gen_rht(gen, d, dtype, device)
    right = lambda t: () if t.right is None else t.right  # noqa: E731
    if mode == "rht_sf":
        return {"u": ((), U.left, right(U)), "v": ((), V.left, right(V)),
                "vin": () if scaleWH is None else 1.0 / scaleWH.to(dtype)}
    vin = V.signs if scaleWH is None else V.signs / scaleWH.to(V.signs.dtype)
    us = () if mode == "rht_uf" else U.signs
    return {"u": (us, U.left, right(U)), "v": (V.signs, V.left, right(V)),
            "vin": vin}


def rot_to_butterflies(q: PackedLinear) -> Tuple[inc.RHT, inc.RHT]:
    """(U, V) transform views over the stored rotation buffers (RHT modes;
    absent sign slots stay None)."""
    if q.proj_mode not in _RHT_MODES:
        raise NotImplementedError(
            f"proj_mode {q.proj_mode!r}: butterfly modes are a later slice "
            f"of the port (ROADMAP queue 1)")
    return (inc.RHT(q.u_signs, q.u_left, q.u_right, q.out_features),
            inc.RHT(q.v_signs, q.v_left, q.v_right, q.in_features))
