"""Float32 forwards of OPT and BLOOM from the raw tensors, layer by layer.

The raw tensors (``benchmark/weights.py`` draws them from the seed) are
stacked over layers: ``lin[name]`` the packed linears (``plane``,
``u_signs``, ``v_signs``, ``u_right``, ``v_right``), ``bias[name]``,
``ln`` (L, 2, 2, D: ln1 / ln2, scale / bias), ``tok`` (V, D), OPT's
``pos`` (positions + 2, D), BLOOM's ``emb_ln`` (2, D) and ``final_ln``
(2, D). Each layer's dense weights are decoded once for all sequences
(``planes.dense_weight``) and dropped before the next layer's, so the
reference fits beside nothing but its inputs.

The layer equations follow the published models: OPT (pre-LayerNorm
blocks, learned positions at offset 2, ReLU, biases everywhere, the head
tied to the token table) and BLOOM (the embedding LayerNorm, ALiBi with
the published slopes, exact GELU, biases, tied head). One departure from
the published checkpoints' layout, shared with the program: the fused
query-key-value projection's output is [q | k | v], each head-major, where
BLOOM's checkpoint interleaves them per head; with random weights the two
are the same model up to a permutation of the weight rows.

``precision="fp8"`` is the control: every activation that the program
holds in bfloat16 (the embedding, each norm's output, q, k, v, the
attention probabilities and output, each linear's output, the MLP's
activation, the residual stream after each add) is rounded to float8
e4m3 with a scale per row (its absolute maximum to 448), the step below
the bfloat16 that the configuration serves in; the weights stay exact.
"""
from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.nn.functional as F

from benchmark.reference import planes as P

LINEARS = ("qkv", "o", "fc1", "fc2")


def shapes(shape: dict) -> dict:
    """(out, in) of each linear."""
    D, Fd = shape["d_model"], shape["d_ff"]
    return {"qkv": (3 * D, D), "o": (D, D), "fc1": (Fd, D), "fc2": (D, Fd)}


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _cast(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "f32":
        return lambda x: x
    if precision == "fp8":
        return fp8_rows
    raise ValueError(f"unknown precision {precision!r}")


def layer_norm(x: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    p = p.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p[0] + p[1]


def alibi_slopes(n: int) -> List[float]:
    """BLOOM's slopes: 2^(-8 i / n) for i = 1..n when n is a power of two;
    otherwise the nearest lower power's series and every other slope of
    the doubled one."""
    def pow2(k):
        start = 2.0 ** (-(2.0 ** -(math.log2(k) - 3)))
        return [start ** (i + 1) for i in range(k)]
    if math.log2(n).is_integer():
        return pow2(n)
    c = 2 ** math.floor(math.log2(n))
    return pow2(c) + pow2(2 * c)[0::2][: n - c]


def attend(q, k, v, family: str, n_heads: int,
           cast=lambda x: x) -> torch.Tensor:
    """Causal softmax attention of one sequence: q, k, v (S, H, hd);
    ``cast`` rounds the probabilities."""
    S, H, hd = q.shape
    q, k, v = (t.permute(1, 0, 2) for t in (q, k, v))
    s = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device, dtype=torch.float32)
    if family == "bloom":
        slopes = torch.tensor(alibi_slopes(n_heads), device=q.device)
        s = s - slopes[:, None, None] * (pos[:, None] - pos[None, :])
    causal = pos[None, :] <= pos[:, None]
    s = s.masked_fill(~causal, float("-inf"))
    out = torch.matmul(cast(torch.softmax(s, dim=-1)), v)
    return out.permute(1, 0, 2).reshape(S, H * hd)


def hidden(raw: dict, shape: dict, seqs: List[torch.Tensor],
           precision: str = "f32") -> List[torch.Tensor]:
    """The final-LayerNorm hidden states (S_i, D) of each token sequence
    (1-D int64 on the weights' device)."""
    cast = _cast(precision)
    fam, eps = shape["family"], shape["eps"]
    H, D = shape["n_heads"], shape["d_model"]
    hd = D // H
    bits, sb = shape["bits"], shape["scale_b"]
    tok = raw["tok"]
    xs = []
    for t in seqs:
        x = tok[t].to(torch.float32)
        if fam == "opt":
            x = x + raw["pos"][torch.arange(len(t), device=t.device) + 2
                               ].to(torch.float32)
        if raw.get("emb_ln") is not None:
            x = layer_norm(x, raw["emb_ln"], eps)
        xs.append(cast(x))
    sh = shapes(shape)
    for layer in range(shape["n_layers"]):
        W = {}
        for n in LINEARS:
            lin = {k: (None if v is None else v[layer])
                   for k, v in raw["lin"][n].items()}
            W[n] = P.dense_weight(lin, bits, sb, *sh[n])
        b = {n: raw["bias"][n][layer].to(torch.float32) for n in LINEARS}
        ln = raw["ln"][layer]
        for i, x in enumerate(xs):
            h = cast(layer_norm(x, ln[0], eps))
            qkv = h @ W["qkv"].t() + b["qkv"]
            S = x.shape[0]
            q, k, v = (cast(qkv[:, j * D:(j + 1) * D]).reshape(S, H, hd)
                       for j in range(3))
            a = cast(attend(q, k, v, fam, H, cast))
            x = cast(x + cast(a @ W["o"].t() + b["o"]))
            h = cast(layer_norm(x, ln[1], eps))
            f = cast(h @ W["fc1"].t() + b["fc1"])
            f = cast(F.relu(f) if fam == "opt"
                     else F.gelu(f, approximate="none"))
            xs[i] = cast(x + cast(f @ W["fc2"].t() + b["fc2"]))
        del W
    return [cast(layer_norm(x, raw["final_ln"], eps)) for x in xs]


def logits(raw: dict, h: torch.Tensor, precision: str = "f32",
           block: int = 512) -> torch.Tensor:
    """Tied-head logits (rows of h, V) in float32, ``block`` rows at a
    time (the control rounds them too)."""
    E = raw["tok"].to(torch.float32)
    cast = _cast(precision)
    return torch.cat([cast(h[i:i + block] @ E.t())
                      for i in range(0, h.shape[0], block)])


def rows_from(raw: dict, shape: dict, seqs: List[torch.Tensor],
              starts: List[int], precision: str = "f32"
              ) -> List[torch.Tensor]:
    """Logits of each sequence from row ``starts[i]`` on (the rows that
    judge served tokens)."""
    hs = hidden(raw, shape, seqs, precision)
    return [logits(raw, h[s:], precision) for h, s in zip(hs, starts)]
