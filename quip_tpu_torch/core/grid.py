"""Scalar quantization grids ("qfn" a/b/c) as plain functions on tensors.

Port of ``quip_tpu/core/grid.py`` (reference quant.py:6-163):

  * qfn 'a' — asymmetric per-channel min/max grid (scale, zero point),
    optional MSE grid-shrink search.
  * qfn 'b' — symmetric grid with scale = 2.4 * RMS(W) + 1e-16, computed
    after incoherence preprocessing (the QuIP grid).
  * qfn 'c' — like 'a' but clamping before rounding; used for the
    LDLQ ≡ OPTQ equivalence check.

Grid parameters are a :class:`GridParams` tuple; ``maxq`` is a Python
float (2**bits - 1). ``find_params_qfna_act`` is the activation-tensor
grid ActQuant calibrates with (ops/actquant.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GridParams(NamedTuple):
    """Per-channel uniform-grid parameters: scale/zero of shape (rows, 1);
    ``maxq`` = 2**bits - 1."""

    scale: torch.Tensor
    zero: torch.Tensor
    maxq: float

    @property
    def bits(self) -> int:
        return int(round(math.log2(self.maxq + 1)))


def maxq_for_bits(bits: int) -> float:
    return float(2 ** bits - 1)


# ---------------------------------------------------------------------------
# qfn 'a': asymmetric min/max grid  (reference quant.py:6-8, 57-136)
# ---------------------------------------------------------------------------


def _rowwise_qfna(xr, maxq, sym, mse, norm, grid, maxshrink):
    """Min/max grid + optional MSE shrink over the rows (channels) of xr
    (reference quant.py:75-114)."""
    zeros = torch.zeros(xr.shape[0], dtype=xr.dtype, device=xr.device)
    xmin = torch.minimum(xr.amin(dim=1), zeros)
    xmax = torch.maximum(xr.amax(dim=1), zeros)

    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)

    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)

    scale = (xmax - xmin) / maxq
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)

    if mse:
        # grid-shrink MSE search (quant.py:95-114)
        best = torch.full((xr.shape[0],), math.inf, dtype=xr.dtype,
                          device=xr.device)
        for i in range(int(maxshrink * grid)):
            p = 1 - i / grid
            xmin1 = p * xmin
            xmax1 = p * xmax
            scale1 = (xmax1 - xmin1) / maxq
            zero1 = torch.round(-xmin1 / scale1) if not sym else zero
            q = quantize_qfna(xr, scale1[:, None], zero1[:, None], maxq)
            err = ((q - xr).abs() ** norm).sum(dim=1)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)
    return scale, zero


def find_params_qfna(x: torch.Tensor, bits: int, perchannel: bool = True,
                     sym: bool = False, mse: bool = False, norm: float = 2.4,
                     grid: int = 100, maxshrink: float = 0.8) -> GridParams:
    """(scale, zero) of the qfn-a grid over a weight matrix, rows =
    channels (reference ``Quantizer.find_params_qfna``, weight case)."""
    maxq = maxq_for_bits(bits)
    xr = x.reshape(x.shape[0], -1) if perchannel else x.reshape(1, -1)
    scale, zero = _rowwise_qfna(xr, maxq, sym, mse, norm, grid, maxshrink)
    if not perchannel:
        scale = scale.repeat(x.shape[0])
        zero = zero.repeat(x.shape[0])
    return GridParams(scale=scale[:, None], zero=zero[:, None], maxq=maxq)


def find_params_qfna_act(x: torch.Tensor, bits: int,
                         perchannel: bool = True, sym: bool = False,
                         mse: bool = False, norm: float = 2.4,
                         grid: int = 100,
                         maxshrink: float = 0.8) -> GridParams:
    """qfn-a grid for ACTIVATION tensors (the weight=False cases of
    reference find_params_qfna, quant.py:66-77, 117-136).

    Channel axis by rank: 4-D (N, C, H, W) -> axis 1; 3-D (B, S, C) and
    2-D (B, C) -> the last axis. scale/zero come shaped to broadcast
    against x: (1, C, 1, 1) / (1, 1, C) / (1, C); a 1-D input gets one
    whole-tensor grid of shape (1,)."""
    maxq = maxq_for_bits(bits)
    shape = x.shape
    if perchannel and x.dim() >= 2:
        if x.dim() == 4:
            xr = torch.movedim(x, 1, 0).reshape(shape[1], -1)
        elif x.dim() == 3:
            xr = x.reshape(-1, shape[-1]).t()
        else:
            xr = x.t()
    else:
        xr = x.reshape(1, -1)
    scale, zero = _rowwise_qfna(xr, maxq, sym, mse, norm, grid, maxshrink)
    if not perchannel and x.dim() >= 2:
        # the whole-tensor grid broadcast over the channels (quant.py:117-121)
        nch = shape[1] if x.dim() != 3 else shape[2]
        scale = scale.repeat(nch)
        zero = zero.repeat(nch)
    bshape = {4: (1, -1, 1, 1), 3: (1, 1, -1), 2: (1, -1)}.get(x.dim(),
                                                               (-1,))
    return GridParams(scale=scale.reshape(bshape),
                      zero=zero.reshape(bshape), maxq=maxq)


def quantize_qfna(x, scale, zero, maxq):
    """Round-to-nearest on the qfn-a grid (quant.py:6-8)."""
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def quantize_qfnc(x, scale, zero, maxq):
    """qfn-c: clamp before rounding (quant.py:17-21), the order of
    operations inside the LDLQ solver."""
    q = torch.round(torch.clamp((x / scale) + zero, 0, maxq))
    return scale * (q - zero)


# ---------------------------------------------------------------------------
# qfn 'b': symmetric RMS grid (the incoherence-processing grid)
# (reference quant.py:10-15, 148-151)
# ---------------------------------------------------------------------------


def qfnb_scale(w: torch.Tensor) -> torch.Tensor:
    """scale = 2.4 * RMS(W) + 1e-16 over the whole matrix (quant.py:150,
    vector_balance.py:522)."""
    return 2.4 * torch.sqrt(torch.mean(torch.square(w))) + 1e-16


def quantize_qfnb(x, scale, maxq):
    """Round-to-nearest on the qfn-b grid (quant.py:10-15)."""
    q = x / scale
    q = torch.clamp(torch.round(((q + 1) / 2) * maxq), 0, maxq)
    q = (q / maxq) * 2 - 1
    return q * scale


# ---------------------------------------------------------------------------
# Grid transforms around the adaptive-rounding solvers: the solvers
# (core/ldlq.py) work in grid coordinates, W mapped into [0, maxq]
# (vector_balance.py:499-532).
# ---------------------------------------------------------------------------


def to_grid_qfna(w, g: GridParams):
    """W -> clamp(W/scale + zero, 0, maxq)  (vector_balance.py:515)."""
    return torch.clamp(w / g.scale + g.zero, 0, g.maxq)


def from_grid_qfna(wq, g: GridParams):
    """grid codes -> scale * (q - zero)  (vector_balance.py:519)."""
    return g.scale * (wq - g.zero)


def to_grid_qfnb(w, scale, maxq):
    """W -> clamp(((W/scale)+1)/2 * maxq, 0, maxq)  (vector_balance.py:523)."""
    wr = w / scale
    return torch.clamp(((wr + 1) / 2) * maxq, 0, maxq)


def from_grid_qfnb(wq, scale, maxq):
    """grid codes -> ((q/maxq)*2 - 1) * scale  (vector_balance.py:528)."""
    return ((wq / maxq) * 2 - 1) * scale
