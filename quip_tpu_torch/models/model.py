"""Decoder LM for the Llama family (port of quip_tpu/models/model.py).

Parameters are ``nn.Module``s: a ``Model`` holds the embedding, the final
norm, the lm_head and an ``nn.ModuleList`` of per-layer ``Block``s (the
unrolled per-layer form that quip_tpu's ``paged.split_blocks`` builds by
hand). Every linear is y = x @ W with W stored (in, out), or a
``PackedLinear`` (pack/format.py); ``ops.qlinear.linear_apply`` dispatches.
Attention and the norms are plain functions on tensors, named as in
quip_tpu so each counterpart is easy to find.

Llama only in this slice: OPT (learned positions, LayerNorm, ReLU) and
BLOOM (ALiBi, embedding LayerNorm, GELU) raise NotImplementedError
(ROADMAP: "OPT/BLOOM branches").
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from quip_tpu_torch.kernels.flash_attn import flash_prefill_bshd
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.ops.qlinear import linear_apply
from quip_tpu_torch.pack.format import PackedLinear

Linear = Union[torch.Tensor, PackedLinear]

def check_supported(cfg: ModelConfig) -> None:
    """The functions below implement the Llama family only."""
    if (cfg.family != "llama" or cfg.positions != "rope" or cfg.norm != "rms"
            or cfg.act != "silu_glu" or not cfg.do_layer_norm_before
            or cfg.embed_proj_dim is not None or cfg.embed_layer_norm):
        raise NotImplementedError(
            f"model family {cfg.family!r} is a later slice of the port "
            f"(ROADMAP queue 1: OPT/BLOOM branches)")


# ---------------------------------------------------------------------------
# Modules (parameter containers)
# ---------------------------------------------------------------------------


def _set_linear(mod: nn.Module, name: str, w: Optional[Linear]) -> None:
    """A packed leaf becomes a submodule, a dense one a buffer."""
    if isinstance(w, nn.Module):
        setattr(mod, name, w)
    else:
        mod.register_buffer(name, w)


class Attention(nn.Module):
    """wqkv (fused) or wq/wk/wv, then wo; optional biases."""

    def __init__(self, **weights):
        super().__init__()
        self.fused = "wqkv" in weights
        for name in ("wqkv", "wq", "wk", "wv", "wo",
                     "bqkv", "bq", "bk", "bv", "bo"):
            _set_linear(self, name, weights.get(name))


class MLP(nn.Module):
    """wgu (fused gate+up) or wg/wu, then wd."""

    def __init__(self, **weights):
        super().__init__()
        self.fused = "wgu" in weights
        for name in ("wgu", "wg", "wu", "wd"):
            _set_linear(self, name, weights.get(name))


class Block(nn.Module):
    def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor, attn: Attention,
                 mlp: MLP):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)
        self.attn = attn
        self.mlp = mlp


class Model(nn.Module):
    """A decoder LM: embed_tokens (V, D), blocks, final_ln (D,) and lm_head
    ((D, V) dense or PackedLinear)."""

    def __init__(self, cfg: ModelConfig, embed_tokens: torch.Tensor,
                 blocks, final_ln: torch.Tensor,
                 lm_head: Optional[Linear] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.register_buffer("embed_tokens", embed_tokens)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_ln", final_ln)
        _set_linear(self, "lm_head", lm_head)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


# ---------------------------------------------------------------------------
# Norms / positions
# ---------------------------------------------------------------------------


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * scale


def norm(scale: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    return rms_norm(scale, x, cfg.norm_eps)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE at integer positions (…, hd/2), f32."""
    hd = cfg.hd
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32,
                     device=positions.device) / hd))
    ang = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """HF-style rotate-half RoPE. x: (..., seq, heads, hd)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention / MLP / block
# ---------------------------------------------------------------------------


def _flash_eligible(cfg: ModelConfig, S: int, x: torch.Tensor,
                    plen) -> bool:
    """Flash prefill gate: CUDA tensors, prefill from position 0 (plen
    given), S >= 512 (below it the dense logits are small), hd % 128 == 0,
    no ALiBi."""
    return (plen is not None and x.is_cuda and cfg.positions != "alibi"
            and S >= 512 and cfg.hd % 128 == 0)


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    """q (B, S, H, hd), k/v (B, S, KV, hd) before RoPE."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if p.fused:
        qkv = linear_apply(p.wqkv, x)
        if p.bqkv is not None:
            qkv = qkv + p.bqkv
        nq, nkv = H * hd, KV * hd
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q, k, v = (linear_apply(w, x) + (b if b is not None else 0.0)
                   for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def out_project(p: Attention, out: torch.Tensor) -> torch.Tensor:
    y = linear_apply(p.wo, out)
    return y + p.bo if p.bo is not None else y


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, mask: torch.Tensor,
              rope_cs=None, plen: Optional[torch.Tensor] = None):
    """Self-attention over the window x (B, S, D) without a cache.

    ``mask`` (B, S, S) True = attend. ``plen`` (B,) is the caller's
    contract that the mask is exactly causal & (key < plen): long prompts on
    the card then run the flash kernel (K2). Returns (out (B, S, D),
    (k, v)) with the post-RoPE K/V rows of the window."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, cfg)
    cos, sin = rope_cs if rope_cs is not None else rope_tables(cfg, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(hd)

    if _flash_eligible(cfg, S, x, plen):
        out = flash_prefill_bshd(q, k, v, plen, scale=scale)
        return out_project(p, out.reshape(B, S, H * hd)), (k, v)

    k_all, v_all = k, v
    if KV != H:
        k_all = k_all.repeat_interleave(H // KV, dim=2)
        v_all = v_all.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bshd,blhd->bhsl", q, k_all.to(q.dtype)) * scale
    neg = torch.finfo(logits.dtype).min
    logits = logits.masked_fill(~mask[:, None], neg)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
    out = torch.einsum("bhsl,blhd->bshd", probs, v_all.to(probs.dtype))
    return out_project(p, out.reshape(B, S, H * hd)), (k, v)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU MLP (the Llama family; Model rejects the others)."""
    if p.fused:
        gu = linear_apply(p.wgu, x)
        g, u = gu[..., : cfg.d_ff], gu[..., cfg.d_ff:]
    else:
        g, u = linear_apply(p.wg, x), linear_apply(p.wu, x)
    return linear_apply(p.wd, F.silu(g) * u)


def block_apply(p: Block, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, mask: torch.Tensor, rope_cs=None,
                plen: Optional[torch.Tensor] = None):
    """One pre-norm decoder block. Returns (y, (k, v))."""
    a, kv = attention(p.attn, norm(p.ln1, x, cfg), cfg, positions, mask,
                      rope_cs, plen=plen)
    x = x + a
    x = x + mlp(p.mlp, norm(p.ln2, x, cfg), cfg)
    return x, kv


# ---------------------------------------------------------------------------
# Embedding / head / forward
# ---------------------------------------------------------------------------


def embed(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor) -> torch.Tensor:
    return params.embed_tokens[tokens]


def head_input(params: Model, x: torch.Tensor, cfg: ModelConfig):
    """Hidden states as seen by the lm_head (final norm)."""
    if params.final_ln is not None:
        x = norm(params.final_ln, x, cfg)
    return x


def unembed(params: Model, x: torch.Tensor, cfg: ModelConfig):
    x = head_input(params, x, cfg)
    if cfg.tie_word_embeddings:
        return x @ params.embed_tokens.t()
    return linear_apply(params.lm_head, x)


def causal_mask(B: int, S: int, device=None) -> torch.Tensor:
    m = torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))
    return m.expand(B, S, S)


def forward(params: Model, tokens: torch.Tensor, cfg: ModelConfig):
    """Full-sequence forward -> logits (B, S, V)."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev).expand(B, S)
    mask = causal_mask(B, S, dev)
    plen = torch.full((B,), S, dtype=torch.int32, device=dev)
    x = embed(params, tokens, cfg, positions)
    cs = rope_tables(cfg, positions)
    for bp in params.blocks:
        x, _ = block_apply(bp, x, cfg, positions, mask, rope_cs=cs,
                           plen=plen)
    return unembed(params, x, cfg)
