"""The host packer: ctypes bindings of ``pack/csrc/packlib.cpp`` (port of
``quip_tpu/pack/native.py``).

Packs, unpacks and dequantizes quip_tpu's halfword-spread planes on CPU
tensors with one C++ pass over the codes, rows split over
``min(16, cpu_count)`` threads (quip_tpu's rule). ``pack/format.py`` routes
``pack_codes`` / ``unpack_codes`` of a CPU tensor here; its torch-ops
``_pack_plane`` / ``_unpack_plane`` stay the plain version that the tests
hold this library against, bit for bit.

The library is built by g++ at first use (``kernels/_build.py``, name
``packlib``). Unlike quip_tpu's wrapper there is no numpy fallback: a
missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import torch

from quip_tpu_torch.kernels import _build

_SIGNATURES = {
    "quip_pack": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_int, ctypes.c_int],
    "quip_unpack": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int],
    "quip_dequant_qfnb": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int],
    "quip_pack_i32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int],
    "quip_unpack_i32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int],
    "quip_dequant_table": [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int],
}


def _fn(name: str):
    fn = getattr(_build.load("packlib"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def threads() -> int:
    return min(16, os.cpu_count() or 1)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: packlib returned {rc}")


def _cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what} takes CPU tensors, got {t.device}")


def _cols(d: int, field_bits: int) -> int:
    if field_bits not in (1, 2, 4):
        raise ValueError(f"field width {field_bits} not in (1, 2, 4)")
    cpw = 32 // field_bits
    if d % cpw:
        raise ValueError(f"d={d} must be divisible by {cpw}")
    return d // cpw


def pack_plane(codes: torch.Tensor, field_bits: int) -> torch.Tensor:
    """(m, d) integer codes (< 2**field_bits, field_bits in {1, 2, 4}) on
    the CPU -> the (d*field_bits/32, m) int32 plane of
    ``pack/format.py::_pack_plane``."""
    _cpu(codes, "pack_plane")
    m, d = codes.shape
    nw = _cols(d, field_bits)
    c = codes.to(torch.uint8).contiguous()
    out = torch.empty((nw, m), dtype=torch.int32)
    _check(_fn("quip_pack")(c.data_ptr(), out.data_ptr(), m, d, field_bits,
                            threads()), "quip_pack")
    return out


def unpack_plane(words: torch.Tensor, field_bits: int, d: int
                 ) -> torch.Tensor:
    """Inverse of :func:`pack_plane` -> (m, d) uint8 codes."""
    _cpu(words, "unpack_plane")
    nw, m = words.shape
    if _cols(d, field_bits) != nw:
        raise ValueError(f"{nw} words a row do not hold d={d}")
    w = words.to(torch.int32).contiguous()
    out = torch.empty((m, d), dtype=torch.uint8)
    _check(_fn("quip_unpack")(w.data_ptr(), out.data_ptr(), m, d,
                              field_bits, threads()), "quip_unpack")
    return out


def _splits(bits: int):
    from quip_tpu_torch.pack.format import PLANE_SPLITS
    if bits not in PLANE_SPLITS:
        raise ValueError(f"unsupported bit width {bits}")
    return PLANE_SPLITS[bits]


def pack(codes: torch.Tensor, bits: int) -> Tuple[torch.Tensor, ...]:
    """(m, d) integer codes on the CPU -> one int32 plane per PLANE_SPLITS
    entry (``pack/format.py::pack_codes``: composite widths split over
    planes). The int32 codes are read in place, once a plane: each
    plane's field is ``(code >> shift) & (2**field_bits - 1)``."""
    _cpu(codes, "pack")
    m, d = codes.shape
    c = codes.to(torch.int32).contiguous()
    planes, shift = [], 0
    for field_bits, _ in _splits(bits):
        out = torch.empty((_cols(d, field_bits), m), dtype=torch.int32)
        _check(_fn("quip_pack_i32")(c.data_ptr(), out.data_ptr(), m, d,
                                    field_bits, shift, threads()),
               "quip_pack_i32")
        planes.append(out)
        shift += field_bits
    return tuple(planes)


def unpack(planes: Sequence[torch.Tensor], bits: int, d: int
           ) -> torch.Tensor:
    """Planes -> (m, d) int32 codes (``unpack_codes``): each plane's fields
    written, or OR-ed in, at their shift."""
    splits = _splits(bits)
    if len(planes) != len(splits):
        raise ValueError(f"{bits}-bit codes take {len(splits)} planes, got "
                         f"{len(planes)}")
    out, shift = None, 0
    for p, (plane, (field_bits, _)) in enumerate(zip(planes, splits)):
        _cpu(plane, "unpack")
        nw, m = plane.shape
        if _cols(d, field_bits) != nw:
            raise ValueError(f"{nw} words a row do not hold d={d}")
        if out is None:
            out = torch.empty((m, d), dtype=torch.int32)
        w = plane.to(torch.int32).contiguous()
        _check(_fn("quip_unpack_i32")(w.data_ptr(), out.data_ptr(), m, d,
                                      field_bits, shift, int(p > 0),
                                      threads()), "quip_unpack_i32")
        shift += field_bits
    return out


def _one_plane(planes: Sequence[torch.Tensor], bits: int, d: int,
               what: str) -> torch.Tensor:
    if bits not in (2, 4) or len(planes) != 1:
        raise ValueError(f"{what} takes one 2- or 4-bit plane, got "
                         f"{len(planes)} of {bits} bits")
    _cpu(planes[0], what)
    nw, _ = planes[0].shape
    if _cols(d, bits) != nw:
        raise ValueError(f"{nw} words a row do not hold d={d}")
    return planes[0].to(torch.int32).contiguous()


def dequant_qfnb(planes: Sequence[torch.Tensor], bits: int, d: int,
                 scale: float) -> torch.Tensor:
    """Single-plane 2- or 4-bit qfn-b planes -> the dense (m, d) float32
    grid values ``((q / maxq) * 2 - 1) * scale`` with maxq = 2**bits - 1,
    in one pass (quip_tpu's transcoding path, bit for bit): computed as
    ``a*q - scale`` with ``a = 2*scale/maxq``, within 1e-6 relative of the
    torch expression."""
    w = _one_plane(planes, bits, d, "dequant_qfnb")
    out = torch.empty((w.shape[1], d), dtype=torch.float32)
    _check(_fn("quip_dequant_qfnb")(w.data_ptr(), out.data_ptr(),
                                    w.shape[1], d, bits, float(scale),
                                    threads()), "quip_dequant_qfnb")
    return out


def dequant_table(planes: Sequence[torch.Tensor], bits: int, d: int,
                  table: torch.Tensor) -> torch.Tensor:
    """Single-plane 2- or 4-bit planes -> the dense (m, d) float32
    ``table[code]``, ``table`` a float32 tensor of 2**bits grid values:
    whatever expression made the table, each weight equals it bit for bit
    (``PackedLinear.dequantize``'s CPU grid step)."""
    w = _one_plane(planes, bits, d, "dequant_table")
    tab = table.to(device="cpu", dtype=torch.float32).contiguous()
    if tab.shape != (2 ** bits,):
        raise ValueError(f"table of {tuple(tab.shape)} for {bits}-bit codes")
    out = torch.empty((w.shape[1], d), dtype=torch.float32)
    _check(_fn("quip_dequant_table")(w.data_ptr(), out.data_ptr(),
                                     w.shape[1], d, bits, tab.data_ptr(),
                                     threads()), "quip_dequant_table")
    return out
