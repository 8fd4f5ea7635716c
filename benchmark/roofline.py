"""Operations and bytes: per kernel launch, per token of a model step, and
the card's peaks, counted from a configuration's shapes.

Each input byte is read once and each output byte written once, whatever a
kernel reads again. A launch's bound is the larger of its bytes over the
peak bandwidth and its operations over the peak bf16 rate; a kernel's
roofline share is the bound of its traced launches over their device
time. Model FLOPs are dense-equivalent: two per weight of every linear and
of the head a token, and four per key of the context a layer (q·k and
p·v, each over d_model).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, without sparsity
(a card set below its 700 W power limit runs slower; the run prints the
card's ``power.limit`` beside them).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

PEAK_FLOPS = 989e12          # bf16 tensor-core, dense
PEAK_BYTES = 3.35e12         # HBM3
BF16 = 2

# kernel key -> (name of its main kernel, names of helper kernels a call
# launches, whose device time the call's share counts too)
KERNELS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "k1_decode": (r"\bdm_decode\b", ()),
    "k1_tile": (r"\bdm_tile\b", (r"\bdm_prep\b", r"\bdm_tile_finish\b")),
    "k2": (r"\bflash_fwd\b", ()),
    "k3": (r"\brht_mma\b", ()),
}


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def linears(shape: dict) -> List[Tuple[int, int]]:
    """(m, d) of a block's packed linears in the order a step runs them:
    the fused qkv, the output projection, fc1, fc2."""
    D, F = shape["d_model"], shape["d_ff"]
    return [(3 * D, D), (D, D), (F, D), (D, F)]


def dequant_matmul(B: int, m: int, d: int, bits: int) -> Tuple[float, float]:
    """(flops, bytes) of y (B, m) = x (B, d) @ Ŵᵀ from bits-bit planes:
    the planes, x and y in bf16."""
    return 2.0 * B * m * d, m * d * bits / 8 + (B * d + B * m) * BF16


def flash(B: int, H: int, S: int, hd: int) -> Tuple[float, float]:
    """(flops, bytes) of causal attention over S tokens: q, k, v read and
    the output written in bf16; q·k and p·v over the S(S+1)/2 pairs."""
    return 4.0 * B * H * hd * S * (S + 1) / 2, 4 * B * S * H * hd * BF16


def rht(B: int, n: int, a: int, b: int) -> Tuple[float, float]:
    """(flops, bytes) of one fused RHT launch over B rows of size n = a·b:
    x read and y written in bf16, the sign vector and the two factors in
    float32 (as PERF.md's kernel table counts them); (L ⊗ R) x as two
    small products."""
    return 2.0 * B * n * (a + b), 2 * B * n * BF16 + (n + a * a + b * b) * 4


def _split(n: int) -> Tuple[int, int]:
    from benchmark.reference.planes import split
    return split(n)


def decode_step_bounds(shape: dict, B: int) -> Dict[str, List[float]]:
    """Bound seconds of each launch of one decode step at B rows, in
    launch order within a layer: K1-decode a linear; K3 twice a linear
    (the V side on its input, the U side on its output)."""
    bits = shape["bits"]
    k1, k3 = [], []
    for m, d in linears(shape):
        k1.append(bound_s(*dequant_matmul(B, m, d, bits)))
        k3.append(bound_s(*rht(B, d, *_split(d))))
        k3.append(bound_s(*rht(B, m, *_split(m))))
    return {"k1_decode": k1, "k3": k3}


def window_bounds(shape: dict, B: int, S: int) -> Dict[str, List[float]]:
    """Bound seconds of each launch of a (B, S) forward: K1-tile a linear
    over B·S rows; K2 once a layer."""
    bits = shape["bits"]
    H = shape["n_heads"]
    hd = shape["d_model"] // H
    return {"k1_tile": [bound_s(*dequant_matmul(B * S, m, d, bits))
                        for m, d in linears(shape)],
            "k2": [bound_s(*flash(B, H, S, hd))]}


def span_flops(shape: dict, first: int, last: int, heads: int) -> float:
    """Dense-equivalent FLOPs of the tokens at positions first..last-1 of
    one sequence, ``heads`` of which go through the head (the token at
    position p attends p + 1 keys)."""
    n = last - first
    if n <= 0:
        return 0.0
    D, L = shape["d_model"], shape["n_layers"]
    layer = sum(m * d for m, d in linears(shape))
    keys = (first + 1 + last) * n / 2          # sum of p + 1
    return (2.0 * L * layer * n + 2.0 * D * shape["vocab"] * heads
            + 4.0 * L * D * keys)


def step_flops(shape: dict, rows: int, ctx: float) -> float:
    """Dense-equivalent FLOPs of one decode step over ``rows`` rows, each
    through every linear and the head and attending ``ctx`` keys."""
    D, L = shape["d_model"], shape["n_layers"]
    layer = sum(m * d for m, d in linears(shape))
    return rows * (2.0 * L * layer + 2.0 * D * shape["vocab"]
                   + 4.0 * L * D * ctx)


def matches(pattern: str, name: str) -> bool:
    return re.search(pattern, name) is not None
