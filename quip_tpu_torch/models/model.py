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
import os
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from quip_tpu_torch import resolve_device
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

    NAMES = ("wqkv", "wq", "wk", "wv", "wo", "bqkv", "bq", "bk", "bv", "bo")

    def __init__(self, **weights):
        super().__init__()
        self.fused = "wqkv" in weights
        for name in self.NAMES:
            _set_linear(self, name, weights.get(name))


class MLP(nn.Module):
    """wgu (fused gate+up) or wg/wu, then wd."""

    NAMES = ("wgu", "wg", "wu", "wd")

    def __init__(self, **weights):
        super().__init__()
        self.fused = "wgu" in weights
        for name in self.NAMES:
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


class KVCache(NamedTuple):
    """Contiguous KV cache, optionally int8: k8 = round(127·k/absmax) per
    (position, head) row, scale = absmax/127. Both scales fold exactly into
    the attention algebra (scores·ks after the K dot, probs·vs before the V
    dot), so no dequantised cache is ever built. ``attention`` writes the
    new rows into k/v (and ks/vs) in place."""

    k: torch.Tensor        # (batch, max_len, kv_heads, hd) float, or int8
    v: torch.Tensor
    length: torch.Tensor   # int32 scalar on the host: valid positions
    ks: Optional[torch.Tensor] = None   # (batch, max_len, kv_heads) f32
    vs: Optional[torch.Tensor] = None


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) -> int8 codes + per-(…)-row f32 scale (absmax/127)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_caches(batch: int, max_len: int, cfg: ModelConfig,
                dtype=torch.float32, quantized: bool = False,
                device="cuda") -> KVCache:
    """Stacked (n_layers-leading) KV caches for ``decode_step`` on
    ``device`` (an entry point: the card by default, raising without one).
    quantized=True stores int8 codes + per-(position, head) scales.
    ``length`` stays on the host wherever the cache lies: ``attention`` and
    ``decode_step`` read it as a Python int to slice the cache, which on
    the card would cost a device-to-host copy and a wait every layer."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    length = torch.zeros((cfg.n_layers,), dtype=torch.int32)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    if not quantized:
        return KVCache(z(shape, dtype), z(shape, dtype), length)
    return KVCache(z(shape, torch.int8), z(shape, torch.int8), length,
                   z(shape[:-1], torch.float32), z(shape[:-1], torch.float32))


def _flash_eligible(cfg: ModelConfig, S: int, x: torch.Tensor,
                    plen) -> bool:
    """Flash prefill gate: ``QUIP_FLASH_PREFILL`` not turned off (read at
    call time, default on, as in quip_tpu), CUDA tensors, prefill from
    position 0 (plen given), S >= 512 (below it the dense logits are
    small), hd % 128 == 0, no ALiBi."""
    if os.environ.get("QUIP_FLASH_PREFILL", "1") != "1":
        return False
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
              rope_cs=None, plen: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None,
              taps: Optional[dict] = None):
    """Self-attention over the window x (B, S, D).

    ``mask`` (B, S, L) True = attend, L = S without a cache, else the
    cache's max_len. ``plen`` (B,) is the caller's contract that the mask
    is exactly causal & (key < plen): long prompts on the card then run the
    flash kernel (K2). With a ``cache`` the window's post-RoPE K/V rows are
    written into it at ``cache.length`` (in place; int8 caches quantise
    them) and the window attends the whole cache. ``taps`` (a dict) records
    the inputs of the projections, 'attn_in' and 'o_in', on both attention
    paths. Returns (out (B, S, D), kv): the cache with its length advanced,
    or without one the window's (k, v) rows."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if taps is not None:
        taps["attn_in"] = x
    q, k, v = qkv_project(p, x, cfg)
    cos, sin = rope_cs if rope_cs is not None else rope_tables(cfg, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(hd)

    kv = (k, v)
    k_all, v_all = k, v
    ks_all = vs_all = None
    if cache is not None:
        rows = slice(int(cache.length), int(cache.length) + S)
        if cache.ks is not None:       # int8-quantised cache
            (cache.k[:, rows], cache.ks[:, rows]) = quantize_kv(k)
            (cache.v[:, rows], cache.vs[:, rows]) = quantize_kv(v)
            ks_all, vs_all = cache.ks, cache.vs
        else:
            cache.k[:, rows] = k.to(cache.k.dtype)
            cache.v[:, rows] = v.to(cache.v.dtype)
        kv = cache = cache._replace(length=cache.length + S)
        k_all, v_all = cache.k, cache.v

    if _flash_eligible(cfg, S, x, plen) and k_all.shape[1] == S:
        # blockwise over the FRESH k/v (the cache rows are already stored)
        out = flash_prefill_bshd(q, k, v, plen, scale=scale)
        out = out.reshape(B, S, H * hd)
        if taps is not None:
            taps["o_in"] = out
        return out_project(p, out), kv

    if KV != H:
        rep = H // KV
        k_all = k_all.repeat_interleave(rep, dim=2)
        v_all = v_all.repeat_interleave(rep, dim=2)
        if ks_all is not None:
            ks_all = ks_all.repeat_interleave(rep, dim=2)
            vs_all = vs_all.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,blhd->bhsl", q, k_all.to(q.dtype)) * scale
    if ks_all is not None:
        # fold the per-(position, head) K scales in after the int8 dot
        logits = logits * ks_all.permute(0, 2, 1)[:, :, None, :].to(
            logits.dtype)
    neg = torch.finfo(logits.dtype).min
    logits = logits.masked_fill(~mask[:, None], neg)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
    if vs_all is not None:
        # fold the V scales into the probabilities before the int8 dot
        probs = probs * vs_all.permute(0, 2, 1)[:, :, None, :].to(probs.dtype)
    out = torch.einsum("bhsl,blhd->bshd", probs, v_all.to(probs.dtype))
    out = out.reshape(B, S, H * hd)
    if taps is not None:
        taps["o_in"] = out
    return out_project(p, out), kv


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig,
        taps: Optional[dict] = None) -> torch.Tensor:
    """SwiGLU MLP (the Llama family; Model rejects the others). ``taps``
    records 'mlp_in' and 'down_in'."""
    if taps is not None:
        taps["mlp_in"] = x
    if p.fused:
        gu = linear_apply(p.wgu, x)
        g, u = gu[..., : cfg.d_ff], gu[..., cfg.d_ff:]
    else:
        g, u = linear_apply(p.wg, x), linear_apply(p.wu, x)
    h = F.silu(g) * u
    if taps is not None:
        taps["down_in"] = h
    return linear_apply(p.wd, h)


def block_apply(p: Block, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, mask: torch.Tensor, rope_cs=None,
                plen: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, with_taps: bool = False):
    """One pre-norm decoder block. Returns (y, kv) with ``attention``'s kv
    (the advanced cache, or the window's (k, v) rows); with ``with_taps``
    (y, kv, taps), taps holding each linear's input ('attn_in', 'o_in',
    'mlp_in', 'down_in'): the calibration driver's Hessian sources."""
    taps: Optional[dict] = {} if with_taps else None
    a, kv = attention(p.attn, norm(p.ln1, x, cfg), cfg, positions, mask,
                      rope_cs, plen=plen, cache=cache, taps=taps)
    x = x + a
    x = x + mlp(p.mlp, norm(p.ln2, x, cfg), cfg, taps)
    return (x, kv, taps) if with_taps else (x, kv)


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


def decode_step(params: Model, tokens: torch.Tensor, caches: KVCache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode against the stacked caches of ``init_caches``:
    tokens (B, 1) -> (logits (B, V), caches with every length + 1). The
    cache tensors are updated in place."""
    B = tokens.shape[0]
    dev = tokens.device
    length = int(caches.length[0])           # the same for all layers
    positions = torch.full((B, 1), length, dtype=torch.int64, device=dev)
    mask = (torch.arange(caches.k.shape[2], device=dev)[None, None, :]
            <= positions[:, :, None])        # (B, 1, L)
    x = embed(params, tokens, cfg, positions)
    cs = rope_tables(cfg, positions)
    quantized = caches.ks is not None
    for l, bp in enumerate(params.blocks):
        cache = KVCache(caches.k[l], caches.v[l], caches.length[l],
                        caches.ks[l] if quantized else None,
                        caches.vs[l] if quantized else None)
        x, _ = block_apply(bp, x, cfg, positions, mask, rope_cs=cs,
                           cache=cache)
    logits = unembed(params, x, cfg)
    return logits[:, -1, :], caches._replace(length=caches.length + 1)


# ---------------------------------------------------------------------------
# Initialization and the linear-layer registry for quantization
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Model:
    """Dense random Llama (port of quip_tpu's ``init_params``, Llama
    branch), un-fused (wq/wk/wv, wg/wu), in ``cfg.dtype``: linears are
    normal · fan_in^-1/2, the embedding and lm_head normal · 0.02, the norms
    ones. Drawn from ``gen`` on its own device (a CUDA generator for a
    full-size model), then moved to ``device``, an entry point's: the card
    by default. The same seed on another device gives other weights."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, device=gen.device) * std
        return t.to(device=dev, dtype=dtype)

    def lin(fan_in, fan_out):
        return normal((fan_in, fan_out), fan_in ** -0.5)

    ones = lambda: torch.ones(D, dtype=dtype, device=dev)  # noqa: E731
    embed = normal((V, D), 0.02)
    blocks = [
        Block(ones(), ones(),
              Attention(wq=lin(D, H * hd), wk=lin(D, KV * hd),
                        wv=lin(D, KV * hd), wo=lin(H * hd, D)),
              MLP(wg=lin(D, F_), wu=lin(D, F_), wd=lin(F_, D)))
        for _ in range(cfg.n_layers)]
    head = None if cfg.tie_word_embeddings else normal((D, V), 0.02)
    return Model(cfg, embed, blocks, ones(), head)


class LinearSpec(NamedTuple):
    """One quantizable linear inside a block. name: HF-compatible dotted
    name (reference find_layers keys, modelutils.py:7-16); path: attribute
    path inside the Block; tap: the recorded activation that feeds it (its
    Hessian source)."""

    name: str
    path: Tuple[str, ...]
    tap: str


def fuse_params(params: Model, cfg: ModelConfig) -> Model:
    """A Model with q/k/v (and gate/up) concatenated into fused leaves
    ``wqkv`` / ``wgu``: the same forward, one incoherence rotation and one
    packed matmul per group once quantized. Norms and the embedding are
    shared with ``params``."""
    blocks = []
    for b in params.blocks:
        a, m = b.attn, b.mlp
        attn = dict(wqkv=torch.cat([a.wq, a.wk, a.wv], dim=-1), wo=a.wo,
                    bo=a.bo)
        if a.bq is not None:
            attn["bqkv"] = torch.cat([a.bq, a.bk, a.bv], dim=-1)
        blocks.append(Block(b.ln1, b.ln2, Attention(**attn),
                            MLP(wgu=torch.cat([m.wg, m.wu], dim=-1),
                                wd=m.wd)))
    return Model(cfg, params.embed_tokens, blocks, params.final_ln,
                 params.lm_head)


def replace_linears(b: Block, specs, new) -> Block:
    """A Block with the linear w at each spec's path replaced by
    ``new(spec, w)``, in the order of ``specs``; the norms and every other
    weight are shared with ``b``."""
    parts = {"attn": {k: getattr(b.attn, k) for k in Attention.NAMES},
             "mlp": {k: getattr(b.mlp, k) for k in MLP.NAMES}}
    for spec in specs:
        grp, key = spec.path
        parts[grp][key] = new(spec, parts[grp][key])
    given = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if v is not None}
    return Block(b.ln1, b.ln2, Attention(**given(parts["attn"])),
                 MLP(**given(parts["mlp"])))


def linear_specs(cfg: ModelConfig, fused: bool = False) -> list:
    """The quantizable linears of a block, in quantization order."""
    check_supported(cfg)
    if fused:
        return [
            LinearSpec("self_attn.qkv_proj", ("attn", "wqkv"), "attn_in"),
            LinearSpec("self_attn.o_proj", ("attn", "wo"), "o_in"),
            LinearSpec("mlp.gate_up_proj", ("mlp", "wgu"), "mlp_in"),
            LinearSpec("mlp.down_proj", ("mlp", "wd"), "down_in"),
        ]
    return [
        LinearSpec("self_attn.q_proj", ("attn", "wq"), "attn_in"),
        LinearSpec("self_attn.k_proj", ("attn", "wk"), "attn_in"),
        LinearSpec("self_attn.v_proj", ("attn", "wv"), "attn_in"),
        LinearSpec("self_attn.o_proj", ("attn", "wo"), "o_in"),
        LinearSpec("mlp.gate_proj", ("mlp", "wg"), "mlp_in"),
        LinearSpec("mlp.up_proj", ("mlp", "wu"), "mlp_in"),
        LinearSpec("mlp.down_proj", ("mlp", "wd"), "down_in"),
    ]
