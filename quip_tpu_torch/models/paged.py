"""Paged two-level KV cache (port of quip_tpu/models/paged.py).

The cache keeps quip_tpu's two levels and their API:

  * a **frozen** arena ``(n_layers, B, capacity, kv_heads, hd)`` read in
    pages up to the longest slot's ``base`` (a telescoped loop of big pages
    then small ones), so decode reads scale with used context;
  * a small **hot** ring ``(n_layers, B, hot, kv_heads, hd)`` that takes
    the newest rows; every ``hot`` steps :func:`flush_hot` appends each
    slot's hot run to the frozen arena at its ``base``.

In JAX the split exists because the runtime could not update buffers in
place; here the ring write and the flush are in-place tensor writes, and
the same semantics hold. Redesigning the two levels is later work.

The cursors ``base`` and ``hot_len`` are (B,) int32 tensors on the host:
the engine owns them, the page loop needs ``max(base)`` as a Python int,
and keeping them there saves a device read per step. bf16/f32 KV only;
int8 KV and the shared prefix are later slices.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig

_NEG = -1e30    # finite mask floor: exp(_NEG - _NEG) stays 1.0 (zero weight)


class PagedKV(NamedTuple):
    """Frozen level k/v (n_layers, B, capacity, kv_heads, hd), valid rows
    ``< base[b]``; hot level hot_k/hot_v (n_layers, B, hot, ...), valid
    rows ``< hot_len[b]`` at absolute positions ``base[b] + j``."""

    k: torch.Tensor
    v: torch.Tensor
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    base: torch.Tensor       # (B,) int32, host
    hot_len: torch.Tensor    # (B,) int32, host

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def hot_size(self) -> int:
        return self.hot_k.shape[2]


class Hot(NamedTuple):
    """A step's cache output: the (updated in place) hot ring and the new
    hot_len."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32, host


def advance(caches: PagedKV, hot: Hot) -> PagedKV:
    """Fold a step's Hot output back into the cache container."""
    return caches._replace(hot_k=hot.k, hot_v=hot.v, hot_len=hot.length)


def init_paged(batch: int, capacity: int, cfg: ModelConfig,
               dtype=torch.bfloat16, hot: int = 32, page=None,
               device="cpu") -> PagedKV:
    """Zero-initialised paged cache. ``page`` rounds capacity up to a page
    multiple (the page loop tiles the arena exactly). Drivers keep
    ``base + hot <= capacity`` so a flush always fits."""
    if page:
        capacity = -(-capacity // page) * page
    if hot < 1 or hot > capacity:
        raise ValueError(f"hot={hot} must be in [1, capacity={capacity}]")
    L, KV, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    fshape = (L, batch, capacity, KV, hd)
    hshape = (L, batch, hot, KV, hd)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return PagedKV(z(fshape), z(fshape), z(hshape), z(hshape),
                   torch.zeros(batch, dtype=torch.int32),
                   torch.zeros(batch, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Online-softmax attention over (pages of frozen) + hot
# ---------------------------------------------------------------------------


def _accum(state, q2, keys, vals, valid, scale: float):
    """One online-softmax block update (multi-query window).

    q2 (B, KV, rep, S, hd); keys/vals (B, T, KV, hd); valid (B, S, T).
    state = (m, lsum, acc) f32: (B, KV, rep, S) / same / (B, KV, rep, S, hd).
    """
    m, lsum, acc = state
    lg = torch.einsum("bkrsd,btkd->bkrst", q2,
                      keys.to(q2.dtype)).to(torch.float32) * scale
    vmask = valid[:, None, None, :, :]
    lg = lg.masked_fill(~vmask, _NEG)
    m_new = torch.maximum(m, lg.amax(dim=-1))
    pe = torch.exp(lg - m_new[..., None]).masked_fill(~vmask, 0.0)
    alpha = torch.exp(m - m_new)
    lsum = lsum * alpha + pe.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkrst,btkd->bkrsd", pe, vals.to(torch.float32))
    return m_new, lsum, acc


class _StepCtx(NamedTuple):
    """Per-step indices shared by every layer (built once per step)."""

    ring_rows: Tuple[torch.Tensor, torch.Tensor]  # (slot, ring row) to write
    win_rows: Tuple[torch.Tensor, torch.Tensor]   # (slot, window s) source
    hot_valid: torch.Tensor       # (B, S, P) bool
    base: torch.Tensor            # (B,) int32 on the device
    max_base: int


def _step_ctx(caches: PagedKV, S: int, device) -> _StepCtx:
    B, P = caches.hot_k.shape[1], caches.hot_size
    hlen = caches.hot_len.to(torch.int64)
    slot = torch.arange(B).repeat_interleave(S)
    s = torch.arange(S).repeat(B)
    row = hlen[slot] + s
    keep = row < P                    # rows past the ring end are dropped
    to = lambda t: t.to(device)  # noqa: E731
    qidx = hlen[:, None] + torch.arange(S)[None, :]            # (B, S)
    hot_valid = torch.arange(P)[None, None, :] <= qidx[:, :, None]
    return _StepCtx((to(slot[keep]), to(row[keep])),
                    (to(slot[keep]), to(s[keep])), to(hot_valid),
                    to(caches.base), int(caches.base.max()))


def _paged_attention(p: M.Attention, h: torch.Tensor, cfg: ModelConfig,
                     layer: int, caches: PagedKV, rope_cs, page: int,
                     ctx: _StepCtx) -> torch.Tensor:
    """Window attention against (frozen pages + hot) for one layer.

    h (B, S, D), the S-token append window (S = 1 is plain decode). The
    window's K/V rows are written into the layer's hot ring in place at
    each slot's hot_len. Returns out (B, S, D)."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    rep = H // KV
    q, k, v = M.qkv_project(p, h, cfg)
    cos, sin = rope_cs
    q = M.apply_rope(q, cos, sin)
    k = M.apply_rope(k, cos, sin)

    hot_k, hot_v = caches.hot_k[layer], caches.hot_v[layer]
    hot_k[ctx.ring_rows] = k[ctx.win_rows].to(hot_k.dtype)
    hot_v[ctx.ring_rows] = v[ctx.win_rows].to(hot_v.dtype)

    q2 = q.reshape(B, S, KV, rep, hd).permute(0, 2, 3, 1, 4)
    scale = 1.0 / math.sqrt(hd)
    f32 = dict(dtype=torch.float32, device=h.device)
    state = (torch.full((B, KV, rep, S), _NEG, **f32),
             torch.zeros((B, KV, rep, S), **f32),
             torch.zeros((B, KV, rep, S, hd), **f32))

    def page_step(state, start: int, psize: int):
        pk = caches.k[layer, :, start:start + psize]
        pv = caches.v[layer, :, start:start + psize]
        ridx = start + torch.arange(psize, device=h.device)
        # frozen rows are < base, hence before every query position
        valid = (ridx[None, :] < ctx.base[:, None])[:, None, :].expand(
            B, S, psize)
        return _accum(state, q2, pk, pv, valid, scale)

    # telescoped page loop: big pages (8x) cover the bulk, small pages the
    # tail, so reads round up only to the small page size
    big = 8 * page
    lo = 0
    if big < caches.capacity:
        n_big = ctx.max_base // big
        for pidx in range(n_big):
            state = page_step(state, pidx * big, big)
        lo = n_big * (big // page)
    for pidx in range(lo, -(-ctx.max_base // page)):
        state = page_step(state, pidx * page, page)

    # hot block: query s (hot index hlen+s) attends hot rows j <= hlen+s
    state = _accum(state, q2, hot_k, hot_v, ctx.hot_valid, scale)

    _, lsum, acc = state
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(h.dtype)
    return M.out_project(p, out)


# ---------------------------------------------------------------------------
# Decode step / flush / prefill
# ---------------------------------------------------------------------------


def paged_append_step(params: M.Model, tokens: torch.Tensor,
                      caches: PagedKV, cfg: ModelConfig, *, page: int = 256
                      ) -> Tuple[torch.Tensor, Hot]:
    """Append S tokens per slot and return their logits (B, S, V).

    The per-layer step of quip_tpu's ``paged_append_step_unrolled``: the
    window is causal (token s attends frozen + hot + window tokens <= s),
    and its K/V rows land in the hot ring at hot_len..hot_len+S-1, so
    callers keep ``max(hot_len) + S <= hot`` (flush first). Returns
    (logits, Hot with hot_len + S)."""
    if caches.capacity % page:
        raise ValueError(
            f"capacity {caches.capacity} must be a multiple of page {page} "
            f"(init_paged(..., page=...) rounds it up)")
    B, S = tokens.shape
    dev = tokens.device
    pos0 = (caches.base + caches.hot_len).to(torch.int64)
    positions = (pos0[:, None] + torch.arange(S)[None, :]).to(dev)
    x = M.embed(params, tokens, cfg, positions)
    rope_cs = M.rope_tables(cfg, positions)
    ctx = _step_ctx(caches, S, dev)
    for l, bp in enumerate(params.blocks):
        x = x + _paged_attention(bp.attn, M.norm(bp.ln1, x, cfg), cfg, l,
                                 caches, rope_cs, page, ctx)
        x = x + M.mlp(bp.mlp, M.norm(bp.ln2, x, cfg), cfg)
    logits = M.unembed(params, x, cfg)
    return logits, Hot(caches.hot_k, caches.hot_v, caches.hot_len + S)


def paged_decode_step(params: M.Model, tokens: torch.Tensor,
                      caches: PagedKV, cfg: ModelConfig, *, page: int = 256
                      ) -> Tuple[torch.Tensor, Hot]:
    """One decode token per slot: tokens (B, 1) -> (logits (B, V), Hot)
    (quip_tpu's ``paged_decode_step_unrolled``)."""
    logits, hot = paged_append_step(params, tokens, caches, cfg, page=page)
    return logits[:, -1, :], hot


def flush_hot(caches: PagedKV) -> PagedKV:
    """Append each slot's hot ring into the frozen arena at its base, in
    place. Rows past hot_len are garbage but land at >= the new base, which
    masks and later flushes overwrite. Slots must keep base + hot <=
    capacity (callers retire them earlier)."""
    P = caches.hot_size
    for b, at in enumerate(caches.base.tolist()):
        if at + P > caches.capacity:
            raise ValueError(f"flush_hot: slot {b} base {at} + hot {P} "
                             f"exceeds capacity {caches.capacity}")
        caches.k[:, b, at:at + P] = caches.hot_k[:, b]
        caches.v[:, b, at:at + P] = caches.hot_v[:, b]
    return caches._replace(base=caches.base + caches.hot_len,
                           hot_len=torch.zeros_like(caches.hot_len))


def _prompt_kv(params: M.Model, tokens: torch.Tensor, plen: torch.Tensor,
               cfg: ModelConfig):
    """Run the prompt through the model, returning the last real
    position's logits (B, V) and per-layer post-RoPE K/V (B, S, KV, hd).

    tokens (B, S) (right-padded); plen (B,) real lengths. Only the last
    real rows go through the lm_head."""
    B, S = tokens.shape
    dev = tokens.device
    plen = plen.to(device=dev, dtype=torch.int64)
    positions = torch.arange(S, device=dev).expand(B, S)
    key = torch.arange(S, device=dev)
    mask = ((key[None, None, :] <= positions[:, :, None])
            & (key[None, None, :] < plen[:, None, None]))
    x = M.embed(params, tokens, cfg, positions)
    rope_cs = M.rope_tables(cfg, positions)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for bp in params.blocks:
        x, (k, v) = M.block_apply(bp, x, cfg, positions, mask,
                                  rope_cs=rope_cs, plen=plen)
        ks.append(k)
        vs.append(v)
    last = x[torch.arange(B, device=dev), plen - 1][:, None]   # (B, 1, D)
    return M.unembed(params, last, cfg)[:, 0], ks, vs


def _store_kv(caches: PagedKV, ks, vs, slot: int) -> None:
    """Write per-layer prompt K/V (1, S, KV, hd) into the frozen arena of
    ``slot`` at position 0, in place."""
    for l, (k, v) in enumerate(zip(ks, vs)):
        S = k.shape[1]
        caches.k[l, slot, :S] = k[0].to(caches.k.dtype)
        caches.v[l, slot, :S] = v[0].to(caches.v.dtype)


def paged_prefill_slot(params: M.Model, tokens: torch.Tensor, plen: int,
                       caches: PagedKV, slot: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, PagedKV]:
    """Prefill ONE slot (continuous-batching admission). tokens (1, S),
    plen <= S real tokens. Returns (logits (V,), caches with
    base[slot] = plen, hot_len[slot] = 0)."""
    S = tokens.shape[1]
    if S > caches.capacity:
        raise ValueError(f"prompt of {S} exceeds capacity {caches.capacity}")
    plen_t = torch.tensor([int(plen)], dtype=torch.int32)
    logits, ks, vs = _prompt_kv(params, tokens, plen_t, cfg)
    _store_kv(caches, ks, vs, int(slot))
    base, hot_len = caches.base.clone(), caches.hot_len.clone()
    base[int(slot)] = int(plen)
    hot_len[int(slot)] = 0
    return logits[0], caches._replace(base=base, hot_len=hot_len)
