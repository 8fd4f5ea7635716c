"""Decoder LM for OPT / Llama / BLOOM (port of quip_tpu/models/model.py).

Parameters are ``nn.Module``s: a ``Model`` holds the embedding (``Embed``),
the final norm, the lm_head and an ``nn.ModuleList`` of per-layer
``Block``s (the unrolled per-layer form that quip_tpu's
``paged.split_blocks`` builds by hand). The attribute names follow
quip_tpu's tree keys (``embed.tokens``, ``embed.positions``,
``embed.proj_in`` / ``proj_out``, ``embed.ln``, ``ln1``, ``ln2``,
``final_ln``; a norm's ``scale`` and ``bias``). Every linear is y = x @ W
(+ b) with W stored (in, out), or a ``PackedLinear`` (pack/format.py);
``ops.qlinear.linear_apply`` dispatches. Attention and the norms are plain
functions on tensors, named as in quip_tpu so each counterpart is easy to
find.

Family specifics, as in quip_tpu: learned positions with offset 2, ReLU
MLP and OPT-350m's post-norm and project_in/out (OPT); RoPE, RMSNorm,
SwiGLU and GQA (Llama-2); ALiBi, the embedding LayerNorm and exact GELU
(BLOOM). OPT and BLOOM tie the lm_head to the token table.

Under tensor parallelism (parallel/mesh.py::shard_params) a block's
``Attention`` and ``MLP`` carry the mesh's tp axis (``tp``) and their
linears are ``TPLinear`` shards: each rank attends with its own
n_heads / tp query and kv_heads / tp key-value heads (taken from the
gathered q/k/v of a packed projection, or given directly by Megatron's
column-parallel dense ones), and the attention output and the MLP's hidden
vector are gathered or sliced to what the next linear takes. Unsharded
modules have ``tp`` None and run as before.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from quip_tpu_torch import resolve_device
from quip_tpu_torch.kernels.flash_attn import flash_prefill_bshd
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.ops.qlinear import TPLinear, linear_apply
from quip_tpu_torch.pack.format import PackedLinear
from quip_tpu_torch.parallel import comm

Linear = Union[torch.Tensor, PackedLinear]

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
    tp: Optional[comm.Axis] = None      # set on a tp shard (parallel/mesh)

    def __init__(self, **weights):
        super().__init__()
        self.fused = "wqkv" in weights
        for name in self.NAMES:
            _set_linear(self, name, weights.get(name))


class MLP(nn.Module):
    """SwiGLU: wgu (fused gate+up) or wg/wu, then wd. ReLU / GELU (OPT,
    BLOOM): w1 (+ b1), then w2 (+ b2)."""

    NAMES = ("wgu", "wg", "wu", "wd", "w1", "b1", "w2", "b2")
    tp: Optional[comm.Axis] = None

    def __init__(self, **weights):
        super().__init__()
        self.fused = "wgu" in weights
        for name in self.NAMES:
            _set_linear(self, name, weights.get(name))


Convert = Callable[[torch.Tensor], torch.Tensor]


def _mapped(t: Optional[torch.Tensor], fn: Convert):
    return None if t is None else fn(t)


class Norm(nn.Module):
    """One norm's parameters: ``scale`` (D,), and ``bias`` (D,) for a
    LayerNorm (None for RMSNorm)."""

    def __init__(self, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    def mapped(self, fn: Convert) -> "Norm":
        """A new Norm holding ``fn`` of each tensor (``to`` converts in
        place, and norms are shared between models)."""
        return Norm(fn(self.scale), _mapped(self.bias, fn))


class Embed(nn.Module):
    """The embedding: ``tokens`` (V, E); OPT's learned ``positions``
    (max_seq + 2, D); OPT-350m's ``proj_in`` (E, D) and ``proj_out``
    (D, E); BLOOM's embedding LayerNorm ``ln``. Absent parts are None."""

    TABLES = ("tokens", "positions", "proj_in", "proj_out")

    def __init__(self, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 proj_in: Optional[torch.Tensor] = None,
                 proj_out: Optional[torch.Tensor] = None,
                 ln: Optional[Norm] = None):
        super().__init__()
        for name, t in zip(self.TABLES, (tokens, positions, proj_in,
                                         proj_out)):
            self.register_buffer(name, t)
        self.ln = ln

    def mapped(self, fn: Convert) -> "Embed":
        return Embed(*(_mapped(getattr(self, k), fn) for k in self.TABLES),
                     ln=None if self.ln is None else self.ln.mapped(fn))


class Block(nn.Module):
    def __init__(self, ln1: Norm, ln2: Norm, attn: Attention, mlp: MLP):
        super().__init__()
        self.ln1 = ln1
        self.ln2 = ln2
        self.attn = attn
        self.mlp = mlp


class Model(nn.Module):
    """A decoder LM: embed (``Embed``), blocks, final_ln (a ``Norm``, None
    for OPT-350m's post-norm) and lm_head ((D, V) dense or PackedLinear;
    None for the tied families). A rank's shard (parallel/mesh.py) carries
    the mesh axes it runs over: ``tp`` (its blocks' linears) and ``dp``
    (the paged steps gather the hidden states over it)."""

    tp: Optional[comm.Axis] = None
    dp: Optional[comm.Axis] = None

    def __init__(self, cfg: ModelConfig, embed: Embed, blocks,
                 final_ln: Optional[Norm], lm_head: Optional[Linear] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_ln = final_ln
        _set_linear(self, "lm_head", lm_head)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


# ---------------------------------------------------------------------------
# Norms / positions
# ---------------------------------------------------------------------------


def layer_norm(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """quip_tpu's ``layer_norm`` (population variance). One fused kernel,
    which accumulates in f32 for bf16 x."""
    return F.layer_norm(x, x.shape[-1:], p.scale, p.bias, eps)


def rms_norm(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p.scale


def norm(p: Norm, x: torch.Tensor, cfg: ModelConfig):
    if cfg.norm == "rms":
        return rms_norm(p, x, cfg.norm_eps)
    return layer_norm(p, x, cfg.norm_eps)


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


def position_tables(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE's (cos, sin) at ``positions`` for the rope family, else None:
    the tables every layer of a step shares."""
    return rope_tables(cfg, positions) if cfg.positions == "rope" else None


def _slopes_list(n_heads: int) -> list:
    """BLOOM's ALiBi head slopes (quip_tpu's ``alibi_slopes``): a geometric
    series for a power-of-two head count; otherwise the nearest lower
    power's series plus every other slope of the doubled one."""
    def power_of_2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return power_of_2(n_heads)
    closest = 2 ** math.floor(math.log2(n_heads))
    return (power_of_2(closest)
            + power_of_2(2 * closest)[0::2][: n_heads - closest])


_SLOPES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """The (n_heads,) f32 ALiBi slopes on ``device`` (the CPU by default),
    made once per (n_heads, device) and cached: a CUDA graph's capture
    forbids the host-to-device copy that making them costs, and every
    graph is captured after an eager run of the same step, which fills
    the cache. Callers must not write into the result."""
    dev = torch.device(device or "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (n_heads, dev)
    if key not in _SLOPES:
        _SLOPES[key] = torch.tensor(_slopes_list(n_heads),
                                    dtype=torch.float32, device=dev)
    return _SLOPES[key]


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
    small), hd == 128 (the only width K2 takes; quip_tpu admits any
    multiple of 128, and every other width here takes dense attention,
    the same function), no ALiBi."""
    if os.environ.get("QUIP_FLASH_PREFILL", "1") != "1":
        return False
    return (plen is not None and x.is_cuda and cfg.positions != "alibi"
            and S >= 512 and cfg.hd == 128)


def take_slots(slots: Optional[Tuple[int, int]], *ts: torch.Tensor):
    """Each of ``ts`` cut to the global slots [lo, hi) that a dp shard of
    a cache holds (``slots``; None: all, the tensors as they are)."""
    if slots is None:
        return ts
    lo, hi = slots
    return tuple(t[lo:hi] for t in ts)


def head0(p: Attention, cfg: ModelConfig) -> int:
    """The first query head this rank attends with (0 unsharded)."""
    tp = p.tp
    return 0 if tp is None else tp.index * (cfg.n_heads // tp.size)


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    """q (B, S, H, hd), k/v (B, S, KV, hd) before RoPE; under tp this
    rank's H / tp and KV / tp heads."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if p.fused:
        qkv = linear_apply(p.wqkv, x)
        if p.bqkv is not None:
            qkv = qkv + p.bqkv
        # [q | k | v], whole or a column-parallel shard of each part
        n = qkv.shape[-1] // (H + 2 * KV)
        nq, nkv = H * n, KV * n
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q, k, v = (linear_apply(w, x) + (b if b is not None else 0.0)
                   for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
    q, k, v = (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
               v.reshape(B, S, -1, hd))
    tp = p.tp
    if tp is not None and tp.size > 1 and q.shape[2] == H:
        # a gathered projection: keep this rank's heads
        h0, kv0 = head0(p, cfg), tp.index * (KV // tp.size)
        q = q[:, :, h0:h0 + H // tp.size]
        k = k[:, :, kv0:kv0 + KV // tp.size]
        v = v[:, :, kv0:kv0 + KV // tp.size]
    return q, k, v


def _reshard(h: torch.Tensor, is_shard: bool, dst, tp) -> torch.Tensor:
    """``h`` (this rank's column shard if ``is_shard``, else whole) as the
    linear ``dst`` takes it under tensor parallelism: gathered over tp for
    a linear that takes the whole input, sliced for a row-parallel one."""
    if tp is None or tp.size == 1:
        return h
    want = isinstance(dst, TPLinear) and dst.takes_shard
    if is_shard and not want:
        return comm.all_gather(h, tp, dim=-1)
    if want and not is_shard:
        k = h.shape[-1] // tp.size
        return h[..., tp.index * k:(tp.index + 1) * k]
    return h


def out_project(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """``wo`` (+ bo) of the attention output (under tp this rank's heads:
    gathered over tp for a packed wo, as is for a row-parallel one)."""
    y = linear_apply(p.wo, _reshard(out, True, p.wo, p.tp))
    return y + p.bo if p.bo is not None else y


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, mask: torch.Tensor,
              rope_cs=None, plen: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None,
              taps: Optional[dict] = None):
    """Self-attention over the window x (B, S, D) at absolute
    ``positions`` (B, S).

    ``mask`` (B, S, L) True = attend, L = S without a cache, else the
    cache's max_len (key l at position l). RoPE (``rope_cs``, made here if
    None) rotates q and k for the rope family; ALiBi subtracts
    slope_h · (query_pos − key_pos) from the logits. ``plen`` (B,) is the
    caller's contract that the mask is exactly causal & (key < plen): long
    prompts on the card then run the flash kernel (K2; never with ALiBi).
    With a ``cache`` the window's K/V rows (after RoPE) are written into
    it at ``cache.length`` (in place; int8 caches quantise them) and the
    window attends the whole cache. ``taps`` (a dict) records
    the inputs of the projections, 'attn_in' and 'o_in', on both attention
    paths. Returns (out (B, S, D), kv): the cache with its length advanced,
    or without one the window's (k, v) rows."""
    B, S, _ = x.shape
    hd = cfg.hd
    if taps is not None:
        taps["attn_in"] = x
    q, k, v = qkv_project(p, x, cfg)
    H = q.shape[2]
    if cfg.positions == "rope":
        cos, sin = (rope_cs if rope_cs is not None
                    else rope_tables(cfg, positions))
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
    else:
        out = dense_attention(q, k_all, v_all, ks_all, vs_all, positions,
                              mask, cfg, x.dtype, head0(p, cfg))
    if taps is not None:
        taps["o_in"] = out
    return out_project(p, out), kv


def dense_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                    ks_all: Optional[torch.Tensor],
                    vs_all: Optional[torch.Tensor], positions: torch.Tensor,
                    mask: torch.Tensor, cfg: ModelConfig, dtype,
                    h0: int = 0) -> torch.Tensor:
    """Softmax attention of q (B, S, H, hd) at ``positions`` (B, S) over
    every key of k_all / v_all (B, L, KV, hd), key l at position l, under
    ``mask`` (B, S, L); int8 keys and values fold their scales ks_all /
    vs_all (B, L, KV) around the dots (``KVCache``). The probabilities are
    cast to ``dtype`` before the V dot; ``h0`` is the first query head q
    holds (ALiBi's slopes are those of heads h0..h0+H-1). Returns
    (B, S, H * hd)."""
    B, S, H, hd = q.shape
    KV = k_all.shape[2]
    scale = 1.0 / math.sqrt(hd)
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
    if cfg.positions == "alibi":
        # the bias in f32: bf16 holds positions exactly only up to 256
        L = logits.shape[-1]
        slopes = alibi_slopes(cfg.n_heads, logits.device)[h0:h0 + H]
        dist = (positions[:, None, :, None].to(torch.float32)
                - torch.arange(L, device=logits.device,
                               dtype=torch.float32))      # (B, 1, S, L)
        logits = logits.to(torch.float32) - slopes[None, :, None, None] * dist
    neg = torch.finfo(logits.dtype).min
    logits = logits.masked_fill(~mask[:, None], neg)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(dtype)
    if vs_all is not None:
        # fold the V scales into the probabilities before the int8 dot
        probs = probs * vs_all.permute(0, 2, 1)[:, :, None, :].to(probs.dtype)
    out = torch.einsum("bhsl,blhd->bshd", probs, v_all.to(probs.dtype))
    return out.reshape(B, S, H * hd)


def _biased(w: Linear, b: Optional[torch.Tensor], x: torch.Tensor):
    y = linear_apply(w, x)
    return y if b is None else y + b


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig,
        taps: Optional[dict] = None) -> torch.Tensor:
    """SwiGLU (Llama), or w1 -> ReLU (OPT) / exact GELU (BLOOM) -> w2 with
    their biases. ``taps`` records 'mlp_in' and 'down_in'."""
    if taps is not None:
        taps["mlp_in"] = x
    if cfg.act == "silu_glu":
        if p.fused:
            gu = linear_apply(p.wgu, x)
            # [gate | up], whole or a column-parallel shard of each half
            f = gu.shape[-1] // 2
            g, u = gu[..., :f], gu[..., f:]
            w_in = p.wgu
        else:
            g, u = linear_apply(p.wg, x), linear_apply(p.wu, x)
            w_in = p.wg
        h = F.silu(g) * u
        w_out, b_out = p.wd, None
    else:
        h = _biased(p.w1, p.b1, x)
        h = F.relu(h) if cfg.act == "relu" else F.gelu(h, approximate="none")
        w_in, w_out, b_out = p.w1, p.w2, p.b2
    if taps is not None:
        taps["down_in"] = h
    h = _reshard(h, isinstance(w_in, TPLinear) and w_in.gives_shard, w_out,
                 p.tp)
    return _biased(w_out, b_out, h)


def block_apply(p: Block, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, mask: torch.Tensor, rope_cs=None,
                plen: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, with_taps: bool = False):
    """One decoder block: pre-norm, or post-norm (the norm after each
    residual add) for ``do_layer_norm_before=False`` (OPT-350m). Returns
    (y, kv) with ``attention``'s kv (the advanced cache, or the window's
    (k, v) rows); with ``with_taps`` (y, kv, taps), taps holding each
    linear's input ('attn_in', 'o_in', 'mlp_in', 'down_in'): the
    calibration driver's Hessian sources."""
    taps: Optional[dict] = {} if with_taps else None
    attend = lambda h: attention(  # noqa: E731
        p.attn, h, cfg, positions, mask, rope_cs, plen=plen, cache=cache,
        taps=taps)
    x, kv = residual(p, x, cfg, attend,
                     lambda h: mlp(p.mlp, h, cfg, taps))
    return (x, kv, taps) if with_taps else (x, kv)


def residual(p: Block, x: torch.Tensor, cfg: ModelConfig, attend, ffn):
    """The block's two residual steps around ``attend(h) -> (a, kv)`` and
    ``ffn(h)``, pre- or post-norm as ``cfg`` says (quip_tpu's
    ``block_apply`` and paged ``_block_step``). Returns (x, kv)."""
    pre = cfg.do_layer_norm_before
    a, kv = attend(norm(p.ln1, x, cfg) if pre else x)
    x = x + a
    if not pre:
        x = norm(p.ln1, x, cfg)
    x = x + ffn(norm(p.ln2, x, cfg) if pre else x)
    if not pre:
        x = norm(p.ln2, x, cfg)
    return x, kv


# ---------------------------------------------------------------------------
# Embedding / head / forward
# ---------------------------------------------------------------------------


def embed(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
          positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Token rows, then OPT-350m's project_in, OPT's learned positions
    (row ``position + 2``; ``positions`` on the tokens' device) and BLOOM's
    embedding LayerNorm."""
    e = params.embed
    x = e.tokens[tokens]
    if cfg.embed_proj_dim is not None:
        x = x @ e.proj_in
    if cfg.positions == "learned":
        x = x + e.positions[positions + 2]
    if cfg.embed_layer_norm:
        x = layer_norm(e.ln, x, cfg.norm_eps)
    return x


def check_positions(params: Model, cfg: ModelConfig, n: int) -> None:
    """Raise if a sequence of ``n`` positions runs past OPT's learned
    table (rows 2.., max_seq of them): the gather would index out of
    bounds (on the card a device-side assert; quip_tpu's gather clamps to
    the table's last row instead)."""
    if cfg.positions == "learned":
        room = params.embed.positions.shape[0] - 2
        if n > room:
            raise ValueError(f"{n} positions exceed the learned position "
                             f"table's {room}")


def head_input(params: Model, x: torch.Tensor, cfg: ModelConfig):
    """Hidden states as seen by the lm_head (final norm, then OPT-350m's
    project_out): also the head's calibration tap."""
    if params.final_ln is not None:
        x = norm(params.final_ln, x, cfg)
    if cfg.embed_proj_dim is not None:
        x = x @ params.embed.proj_out
    return x


def unembed(params: Model, x: torch.Tensor, cfg: ModelConfig):
    """Logits; the tied families multiply by the token table (a dense
    matmul, as quip_tpu computes it)."""
    x = head_input(params, x, cfg)
    if cfg.tie_word_embeddings:
        return x @ params.embed.tokens.t()
    return linear_apply(params.lm_head, x)


def causal_mask(B: int, S: int, device=None) -> torch.Tensor:
    m = torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))
    return m.expand(B, S, S)


def forward(params: Model, tokens: torch.Tensor, cfg: ModelConfig):
    """Full-sequence forward -> logits (B, S, V)."""
    B, S = tokens.shape
    check_positions(params, cfg, S)
    dev = tokens.device
    positions = torch.arange(S, device=dev).expand(B, S)
    mask = causal_mask(B, S, dev)
    plen = torch.full((B,), S, dtype=torch.int32, device=dev)
    x = embed(params, tokens, cfg, positions)
    cs = position_tables(cfg, positions)
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
    check_positions(params, cfg, length + 1)
    positions = torch.full((B, 1), length, dtype=torch.int64, device=dev)
    mask = (torch.arange(caches.k.shape[2], device=dev)[None, None, :]
            <= positions[:, :, None])        # (B, 1, L)
    x = embed(params, tokens, cfg, positions)
    cs = position_tables(cfg, positions)
    quantized = caches.ks is not None
    for l, bp in enumerate(params.blocks):
        cache = KVCache(caches.k[l], caches.v[l], caches.length[l],
                        caches.ks[l] if quantized else None,
                        caches.vs[l] if quantized else None)
        x, _ = block_apply(bp, x, cfg, positions, mask, rope_cs=cs,
                           cache=cache)
    logits = unembed(params, x, cfg)
    return logits[:, -1, :], caches._replace(length=caches.length + 1)


def decode_scan(params: Model, tokens: torch.Tensor, caches: KVCache,
                cfg: ModelConfig, n_steps: int
                ) -> Tuple[torch.Tensor, KVCache]:
    """Greedy-decode ``n_steps`` tokens from tokens (B, 1), the last
    generated token, each step's argmax feeding the next (quip_tpu's
    ``decode_scan``, one jitted scan there, a loop of ``decode_step`` here).
    Returns (tokens (B, n_steps), caches)."""
    out = []
    tok = tokens
    for _ in range(n_steps):
        logits, caches = decode_step(params, tok, caches, cfg)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1), caches


# ---------------------------------------------------------------------------
# Initialization and the linear-layer registry for quantization
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Model:
    """Dense random model of any family (port of quip_tpu's
    ``init_params``), un-fused (wq/wk/wv, wg/wu), in ``cfg.dtype``: linears
    are normal · fan_in^-1/2 with zero biases (where the family has them),
    the embedding tables and lm_head normal · 0.02, the norms ones (and
    zero shifts); post-norm OPT has no final norm. Drawn from ``gen`` on
    its own device (a CUDA generator for a full-size model), then moved to
    ``device``, an entry point's: the card by default. The same seed on
    another device gives other weights."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    E = cfg.embed_proj_dim or D

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, device=gen.device) * std
        return t.to(device=dev, dtype=dtype)

    def lin(fan_in, fan_out):
        return normal((fan_in, fan_out), fan_in ** -0.5)

    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)  # noqa: E731

    def ln():
        return Norm(torch.ones(D, dtype=dtype, device=dev),
                    zeros(D) if cfg.norm == "ln" else None)

    tokens = normal((V, E), 0.02)
    emb = Embed(
        tokens,
        normal((cfg.max_seq + 2, D), 0.02)
        if cfg.positions == "learned" else None,
        *((normal((E, D), 0.02), normal((D, E), 0.02))
          if cfg.embed_proj_dim is not None else (None, None)),
        ln=ln() if cfg.embed_layer_norm else None)

    def block():
        attn = dict(wq=lin(D, H * hd), wk=lin(D, KV * hd),
                    wv=lin(D, KV * hd), wo=lin(H * hd, D))
        if cfg.attn_bias:
            attn.update(bq=zeros(H * hd), bk=zeros(KV * hd),
                        bv=zeros(KV * hd), bo=zeros(D))
        if cfg.act == "silu_glu":
            mlp_ = dict(wg=lin(D, F_), wu=lin(D, F_), wd=lin(F_, D))
        else:
            mlp_ = dict(w1=lin(D, F_), w2=lin(F_, D))
            if cfg.mlp_bias:
                mlp_.update(b1=zeros(F_), b2=zeros(D))
        return Block(ln(), ln(), Attention(**attn), MLP(**mlp_))

    blocks = [block() for _ in range(cfg.n_layers)]
    head = None if cfg.tie_word_embeddings else normal((D, V), 0.02)
    return Model(cfg, emb, blocks,
                 ln() if cfg.do_layer_norm_before else None, head)


class LinearSpec(NamedTuple):
    """One quantizable linear inside a block. name: HF-compatible dotted
    name (reference find_layers keys, modelutils.py:7-16); path: attribute
    path inside the Block; tap: the recorded activation that feeds it (its
    Hessian source)."""

    name: str
    path: Tuple[str, ...]
    tap: str


def fuse_params(params: Model, cfg: ModelConfig) -> Model:
    """A Model with q/k/v (and SwiGLU's gate/up) concatenated into fused
    leaves ``wqkv`` (with ``bqkv``) / ``wgu``: the same forward, one
    incoherence rotation and one packed matmul per group once quantized.
    Norms, the embedding and the other MLPs are shared with ``params``."""
    blocks = []
    for b in params.blocks:
        a, m = b.attn, b.mlp
        attn = dict(wqkv=torch.cat([a.wq, a.wk, a.wv], dim=-1), wo=a.wo,
                    bo=a.bo)
        if a.bq is not None:
            attn["bqkv"] = torch.cat([a.bq, a.bk, a.bv], dim=-1)
        if cfg.act == "silu_glu":
            m = MLP(wgu=torch.cat([m.wg, m.wu], dim=-1), wd=m.wd)
        blocks.append(Block(b.ln1, b.ln2, Attention(**attn), m))
    return Model(cfg, params.embed, blocks, params.final_ln, params.lm_head)


def replace_linears(b: Block, specs, new) -> Block:
    """A Block with the linear w at each spec's path replaced by
    ``new(spec, w)``, in the order of ``specs``; the norms, the biases and
    every other weight are shared with ``b``."""
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
    """The quantizable linears of a block, in quantization order, under
    each family's Hugging Face names (quip_tpu's ``linear_specs``)."""
    L = LinearSpec
    if cfg.act == "silu_glu":
        mlp_specs = [L("mlp.gate_proj", ("mlp", "wg"), "mlp_in"),
                     L("mlp.up_proj", ("mlp", "wu"), "mlp_in"),
                     L("mlp.down_proj", ("mlp", "wd"), "down_in")]
        fused_mlp = [L("mlp.gate_up_proj", ("mlp", "wgu"), "mlp_in"),
                     mlp_specs[2]]
    else:
        mlp_specs = fused_mlp = [L("fc1", ("mlp", "w1"), "mlp_in"),
                                 L("fc2", ("mlp", "w2"), "down_in")]
    if fused:
        return [L("self_attn.qkv_proj", ("attn", "wqkv"), "attn_in"),
                L("self_attn.o_proj", ("attn", "wo"), "o_in")] + fused_mlp
    if cfg.family == "bloom":
        qkv = "self_attention.query_key_value."
        return [L(qkv + "q", ("attn", "wq"), "attn_in"),
                L(qkv + "k", ("attn", "wk"), "attn_in"),
                L(qkv + "v", ("attn", "wv"), "attn_in"),
                L("self_attention.dense", ("attn", "wo"), "o_in"),
                L("mlp.dense_h_to_4h", ("mlp", "w1"), "mlp_in"),
                L("mlp.dense_4h_to_h", ("mlp", "w2"), "down_in")]
    if cfg.family not in ("opt", "llama"):
        raise ValueError(cfg.family)
    out = "out_proj" if cfg.family == "opt" else "o_proj"
    return [L("self_attn.q_proj", ("attn", "wq"), "attn_in"),
            L("self_attn.k_proj", ("attn", "wk"), "attn_in"),
            L("self_attn.v_proj", ("attn", "wv"), "attn_in"),
            L(f"self_attn.{out}", ("attn", "wo"), "o_in")] + mlp_specs
