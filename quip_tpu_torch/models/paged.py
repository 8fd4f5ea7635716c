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

The cursors ``base`` and ``hot_len`` are (B,) int32 tensors on the host
for the serial step: the engine owns them, the page loop is sized from
``max(base)`` as a Python int, and keeping them there saves a device read
per step. The chunked loop (serve/engine.py) keeps them in fixed device
buffers instead and passes the page count itself (``n_pages``), so a step
reads nothing back and a CUDA graph can hold it. Both size the page loop
by :func:`page_bucket`, so the two do the same arithmetic.

int8 KV (``model.quantize_kv``) composes: codes and per-(slot, position,
head) scales live in both levels, and the scales fold around the attention
dots as in ``model.KVCache``. A shared :class:`Prefix` (a system prompt) is
computed once and attended first by every slot that opts in.

Every family runs here: RoPE rotates the keys before they are stored;
learned positions (OPT) enter at the embedding; ALiBi (BLOOM) biases each
block's logits by the keys' absolute positions (the prefix's 0..P0-1, a
slot's own rows shifted past its prefix).

Sharded (parallel/mesh.py): a rank's cache holds its dp shard of the
slots (``PagedKV.slots`` names them) and its tp shard of the kv heads,
while the cursors stay whole, as the engine keeps them on every rank. A
step takes every slot's tokens and cursors, runs its own slots (each rank
its own heads, the blocks' collectives over tp), then gathers the last
hidden states over dp, so every rank computes every slot's logits and
samples them alike. A slot's prefill runs in the dp row that owns it; its
last hidden state is broadcast over dp.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.parallel import comm

_NEG = -1e30    # finite mask floor: exp(_NEG - _NEG) stays 1.0 (zero weight)


class PagedKV(NamedTuple):
    """Frozen level k/v (n_layers, B, capacity, kv_heads, hd), valid rows
    ``< base[b]``; hot level hot_k/hot_v (n_layers, B, hot, ...), valid
    rows ``< hot_len[b]`` at absolute positions ``base[b] + j``. ks/vs (and
    hot_ks/hot_vs) are the int8 mode's scales."""

    k: torch.Tensor
    v: torch.Tensor
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    base: torch.Tensor       # (B,) int32, host
    hot_len: torch.Tensor    # (B,) int32, host
    ks: Optional[torch.Tensor] = None      # (n_layers, B, capacity, kv_heads)
    vs: Optional[torch.Tensor] = None
    hot_ks: Optional[torch.Tensor] = None  # (n_layers, B, hot, kv_heads)
    hot_vs: Optional[torch.Tensor] = None
    # a dp shard: the global slots [lo, hi) its tensors hold (the cursors
    # cover every slot); None: the tensors hold every slot
    slots: Optional[Tuple[int, int]] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def hot_size(self) -> int:
        return self.hot_k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.ks is not None


class Hot(NamedTuple):
    """A step's cache output: the (updated in place) hot ring and the new
    hot_len."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32, host
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None


class Prefix(NamedTuple):
    """Shared-prefix KV (a system prompt): computed once, read by every
    slot. k/v (n_layers, P, kv_heads, hd), no batch axis. Slots opt in per
    request; an opted-in slot attends these rows first and has its token
    positions offset by ``length``. ks/vs (n_layers, P, kv_heads) are the
    int8 mode's scales."""

    k: torch.Tensor
    v: torch.Tensor
    length: int
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None


def build_prefix(params: M.Model, tokens, cfg: ModelConfig,
                 quantized: bool = False) -> Tuple[torch.Tensor, Prefix]:
    """Run a shared prefix once and freeze its per-layer K/V. tokens: (P,)
    or (1, P) ids. Returns (last-position logits (V,), Prefix); the prefix
    takes absolute positions 0..P-1."""
    dev = params.embed.tokens.device
    tokens = torch.as_tensor(tokens, dtype=torch.int64).reshape(1, -1).to(dev)
    P = tokens.shape[1]
    logits, ks, vs = _prompt_kv(params, tokens,
                                torch.tensor([P], dtype=torch.int32), cfg)
    k = torch.stack([t[0] for t in ks])            # (L, P, KV, hd)
    v = torch.stack([t[0] for t in vs])
    if not quantized:
        return logits[0], Prefix(k, v, P)
    k8, ksc = M.quantize_kv(k)
    v8, vsc = M.quantize_kv(v)
    return logits[0], Prefix(k8, v8, P, ksc, vsc)


def _local_view(caches: PagedKV):
    """(the cache with the cursors of the slots its tensors hold, their
    global range or None)."""
    if caches.slots is None:
        return caches, None
    base, hot_len = M.take_slots(caches.slots, caches.base, caches.hot_len)
    return caches._replace(base=base, hot_len=hot_len,
                           slots=None), caches.slots


def advance(caches: PagedKV, hot: Hot) -> PagedKV:
    """Fold a step's Hot output back into the cache container."""
    return caches._replace(hot_k=hot.k, hot_v=hot.v, hot_len=hot.length,
                           hot_ks=hot.ks, hot_vs=hot.vs)


def init_paged(batch: int, capacity: int, cfg: ModelConfig,
               dtype=torch.bfloat16, quantized: bool = False, hot: int = 32,
               page=None, device="cuda") -> PagedKV:
    """Zero-initialised paged cache (int8 codes + f32 scales when
    ``quantized``) on ``device`` (an entry point: the card by default,
    raising without one). ``page`` rounds capacity up to a page multiple
    (the page loop tiles the arena exactly). Callers keep ``base + hot <=
    capacity`` so a flush always fits. The per-slot cursors stay on the
    host, as the engine keeps them."""
    device = resolve_device(device)
    if page:
        capacity = -(-capacity // page) * page
    if hot < 1 or hot > capacity:
        raise ValueError(f"hot={hot} must be in [1, capacity={capacity}]")
    L, KV, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    fshape = (L, batch, capacity, KV, hd)
    hshape = (L, batch, hot, KV, hd)
    dt = torch.int8 if quantized else dtype
    z = lambda s, t=dt: torch.zeros(s, dtype=t, device=device)  # noqa: E731
    scales = ()
    if quantized:
        scales = tuple(z(s[:-1], torch.float32)
                       for s in (fshape, fshape, hshape, hshape))
    return PagedKV(z(fshape), z(fshape), z(hshape), z(hshape),
                   torch.zeros(batch, dtype=torch.int32),
                   torch.zeros(batch, dtype=torch.int32), *scales)


# ---------------------------------------------------------------------------
# Online-softmax attention over (pages of frozen) + hot
# ---------------------------------------------------------------------------


class _Alibi(NamedTuple):
    """ALiBi's inputs to a block update: slopes (KV, rep) f32 and the
    queries' absolute positions pos (B, S)."""

    slopes: torch.Tensor
    pos: torch.Tensor


def _accum(state, q2, keys, vals, valid, ksc, vsc, scale: float,
           alibi: Optional[_Alibi] = None, kpos=None):
    """One online-softmax block update (multi-query window).

    q2 (B, KV, rep, S, hd); keys/vals (B, T, KV, hd); valid (B, S, T);
    ksc/vsc (B, T, KV) int8-mode scales or None; with ``alibi``, kpos
    (B or 1, T) the keys' absolute positions and the logits lose
    slope · (query_pos − key_pos).
    state = (m, lsum, acc) f32: (B, KV, rep, S) / same / (B, KV, rep, S, hd).
    """
    m, lsum, acc = state
    lg = torch.einsum("bkrsd,btkd->bkrst", q2,
                      keys.to(q2.dtype)).to(torch.float32) * scale
    if ksc is not None:
        lg = lg * ksc.permute(0, 2, 1)[:, :, None, None, :]
    if alibi is not None:
        dist = (alibi.pos[:, None, None, :, None].to(torch.float32)
                - kpos[:, None, None, None, :].to(torch.float32))
        lg = lg - alibi.slopes[None, :, :, None, None] * dist
    vmask = valid[:, None, None, :, :]
    lg = lg.masked_fill(~vmask, _NEG)
    m_new = torch.maximum(m, lg.amax(dim=-1))
    pe = torch.exp(lg - m_new[..., None]).masked_fill(~vmask, 0.0)
    alpha = torch.exp(m - m_new)
    lsum = lsum * alpha + pe.sum(dim=-1)
    if vsc is not None:
        # the V scales fold into the weighted sum only, never into the
        # softmax normaliser
        pe = pe * vsc.permute(0, 2, 1)[:, :, None, None, :]
    acc = acc * alpha[..., None] + torch.einsum(
        "bkrst,btkd->bkrsd", pe, vals.to(torch.float32))
    return m_new, lsum, acc


def page_bucket(max_base: int, page: int, capacity: int) -> int:
    """Pages the frozen-arena loop reads when the longest slot holds
    ``max_base`` rows: ceil(max_base / page) rounded up to a power of two
    (at least 1), capped at the arena's page count. Pages past a slot's
    base are masked and add exact zeros; the bucket sets how the loop
    groups its sums, and it is part of a chunk graph's key
    (serve/graphs.py), where quip_tpu traces the trip count instead."""
    need = max(1, -(-max_base // page))
    n = 1
    while n < need:
        n *= 2
    return min(n, capacity // page)


class _StepCtx(NamedTuple):
    """Per-step indices shared by every layer (built once per step)."""

    ring_rows: Tuple[torch.Tensor, torch.Tensor]  # (slot, ring row) to write
    win_rows: Tuple[torch.Tensor, torch.Tensor]   # (slot, window s) source
    hot_valid: torch.Tensor       # (B, S, P) bool
    base: torch.Tensor            # (B,) int32 on the device
    n_pages: int                  # frozen pages the loop reads
    pre_valid: Optional[torch.Tensor]   # (B, S, P0) bool, shared prefix
    pre_len: Optional[torch.Tensor]     # (B,) prefix rows a slot attends


def _step_ctx(caches: PagedKV, S: int, device,
              pre_len: Optional[torch.Tensor], P0: int,
              n_pages: int) -> _StepCtx:
    """The step context from host cursors, copied to ``device``. Rows past
    the ring end (other slots of a multi-token admission window) are
    dropped."""
    B, P = caches.hot_k.shape[1], caches.hot_size
    hlen = caches.hot_len.to(torch.int64)
    slot = torch.arange(B).repeat_interleave(S)
    s = torch.arange(S).repeat(B)
    row = hlen[slot] + s
    keep = row < P                    # rows past the ring end are dropped
    to = lambda t: t.to(device)  # noqa: E731
    qidx = hlen[:, None] + torch.arange(S)[None, :]            # (B, S)
    hot_valid = torch.arange(P)[None, None, :] <= qidx[:, :, None]
    pre_valid = None
    if pre_len is not None:       # opted-out slots mask the prefix entirely
        pre_valid = to((torch.arange(P0)[None, :] < pre_len[:, None])
                       [:, None, :].expand(B, S, P0))
        pre_len = to(pre_len)
    return _StepCtx((to(slot[keep]), to(row[keep])),
                    (to(slot[keep]), to(s[keep])), to(hot_valid),
                    to(caches.base), n_pages, pre_valid, pre_len)


def _step_ctx_dev(caches: PagedKV, S: int,
                  pre_len: Optional[torch.Tensor], P0: int,
                  n_pages: int) -> _StepCtx:
    """The same context from cursors on the device, at fixed shapes:
    nothing is read back and no shape depends on the data. Every slot
    writes its S rows at hot_len..hot_len+S-1, so the caller keeps
    ``max(hot_len) + S <= hot`` (the engine sizes a chunk by the ring's
    room); a row past the ring end is an out-of-range index, never a write
    onto another row."""
    B, P = caches.hot_k.shape[1], caches.hot_size
    dev = caches.base.device
    hlen = caches.hot_len.to(torch.int64)
    slot = torch.arange(B, device=dev)[:, None].expand(B, S).reshape(-1)
    s = torch.arange(S, device=dev).repeat(B)
    row = hlen[slot] + s
    qidx = hlen[:, None] + torch.arange(S, device=dev)[None, :]   # (B, S)
    hot_valid = torch.arange(P, device=dev)[None, None, :] <= qidx[:, :, None]
    pre_valid = None
    if pre_len is not None:
        pre_valid = ((torch.arange(P0, device=dev)[None, :] < pre_len[:, None])
                     [:, None, :].expand(B, S, P0))
    return _StepCtx((slot, row), (slot, s), hot_valid, caches.base, n_pages,
                    pre_valid, pre_len)


def _paged_attention(p: M.Attention, h: torch.Tensor, cfg: ModelConfig,
                     layer: int, caches: PagedKV, rope_cs, page: int,
                     ctx: _StepCtx, prefix: Optional[Prefix],
                     alibi: Optional[_Alibi] = None) -> torch.Tensor:
    """Window attention against (shared prefix + frozen pages + hot) for
    one layer.

    h (B, S, D), the S-token append window (S = 1 is plain decode). The
    window's K/V rows are written into the layer's hot ring in place at
    each slot's hot_len (int8 caches quantise them). ``rope_cs`` rotates
    q and k (the rope family; else None); ``alibi`` biases every block by
    its keys' absolute positions. Returns out (B, S, D)."""
    B, S, _ = h.shape
    hd = cfg.hd
    q, k, v = M.qkv_project(p, h, cfg)
    H, KV = q.shape[2], k.shape[2]       # this rank's heads under tp
    rep = H // KV
    if rope_cs is not None:
        cos, sin = rope_cs
        q = M.apply_rope(q, cos, sin)
        k = M.apply_rope(k, cos, sin)

    hot_k, hot_v = caches.hot_k[layer], caches.hot_v[layer]
    hot_ks = hot_vs = None
    if caches.quantized:
        hot_ks, hot_vs = caches.hot_ks[layer], caches.hot_vs[layer]
        k, ksc = M.quantize_kv(k)
        v, vsc = M.quantize_kv(v)
        hot_ks[ctx.ring_rows] = ksc[ctx.win_rows]
        hot_vs[ctx.ring_rows] = vsc[ctx.win_rows]
    hot_k[ctx.ring_rows] = k[ctx.win_rows].to(hot_k.dtype)
    hot_v[ctx.ring_rows] = v[ctx.win_rows].to(hot_v.dtype)

    q2 = q.reshape(B, S, KV, rep, hd).permute(0, 2, 3, 1, 4)
    scale = 1.0 / math.sqrt(hd)
    f32 = dict(dtype=torch.float32, device=h.device)
    state = (torch.full((B, KV, rep, S), _NEG, **f32),
             torch.zeros((B, KV, rep, S), **f32),
             torch.zeros((B, KV, rep, S, hd), **f32))

    def kpos(start, n: int):
        """The absolute positions (B, n) of n keys from row ``start`` of a
        slot's own rows, which sit past the prefix rows it attends."""
        if alibi is None:
            return None
        row = start + torch.arange(n, device=h.device)[None, :]
        return row if ctx.pre_len is None else row + ctx.pre_len[:, None]

    if prefix is not None:
        # one K/V slab read for the whole batch (positions 0..P0-1)
        ex = lambda t: t[layer][None].expand(B, *t.shape[1:])  # noqa: E731
        q8 = prefix.ks is not None
        state = _accum(state, q2, ex(prefix.k), ex(prefix.v), ctx.pre_valid,
                       ex(prefix.ks) if q8 else None,
                       ex(prefix.vs) if q8 else None, scale, alibi,
                       torch.arange(prefix.k.shape[1], device=h.device)[None])

    def page_step(state, start: int, psize: int):
        rows = (layer, slice(None), slice(start, start + psize))
        pk, pv = caches.k[rows], caches.v[rows]
        psc = pvs = None
        if caches.quantized:
            psc, pvs = caches.ks[rows], caches.vs[rows]
        ridx = start + torch.arange(psize, device=h.device)
        # frozen rows are < base, hence before every query position
        valid = (ridx[None, :] < ctx.base[:, None])[:, None, :].expand(
            B, S, psize)
        return _accum(state, q2, pk, pv, valid, psc, pvs, scale, alibi,
                      kpos(start, psize))

    # telescoped page loop over the bucket's pages: big pages (8x) cover
    # the bulk, small pages the tail
    big = 8 * page
    lo = 0
    if big < caches.capacity:
        n_big = ctx.n_pages * page // big
        for pidx in range(n_big):
            state = page_step(state, pidx * big, big)
        lo = n_big * (big // page)
    for pidx in range(lo, ctx.n_pages):
        state = page_step(state, pidx * page, page)

    # hot block: query s (hot index hlen+s) attends hot rows j <= hlen+s
    state = _accum(state, q2, hot_k, hot_v, ctx.hot_valid, hot_ks, hot_vs,
                   scale, alibi, kpos(ctx.base[:, None], caches.hot_size))

    _, lsum, acc = state
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(h.dtype)
    return M.out_project(p, out)


# ---------------------------------------------------------------------------
# Decode step / flush / prefill
# ---------------------------------------------------------------------------


def paged_append_step(params: M.Model, tokens: torch.Tensor,
                      caches: PagedKV, cfg: ModelConfig, *, page: int = 256,
                      prefix: Optional[Prefix] = None,
                      prefix_on: Optional[torch.Tensor] = None,
                      n_pages: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Hot]:
    """Append S tokens per slot and return their logits (B, S, V).

    The per-layer step of quip_tpu's ``paged_append_step_unrolled``: the
    window is causal (token s attends frozen + hot + window tokens <= s),
    and its K/V rows land in the hot ring at hot_len..hot_len+S-1, so
    callers keep ``max(hot_len) + S <= hot`` (flush first). S > 1 serves
    chunked admission (a prompt streamed through the hot ring). Returns
    (logits, Hot with hot_len + S).

    prefix + prefix_on (B,) 0/1 (None = all on): opted-in slots attend the
    prefix rows first and have their positions offset by prefix.length;
    their base/hot_len still count only their own rows.

    n_pages None: the cursors and prefix_on lie on the host and the page
    loop reads ``page_bucket(max(base))`` pages. Given: they lie on the
    tokens' device, the loop reads ``n_pages`` pages, and nothing is read
    back to the host (the chunked loop's form, see ``_step_ctx_dev``).

    A dp shard of the cache (``slots``) runs its own slots' tokens and
    gathers the hidden states over ``params.dp`` before the head: the
    logits are every slot's (B, S, V)."""
    if caches.capacity % page:
        raise ValueError(
            f"capacity {caches.capacity} must be a multiple of page {page} "
            f"(init_paged(..., page=...) rounds it up)")
    full_hot_len = caches.hot_len
    if n_pages is None:
        # every slot's longest base, also on a dp shard: the page loop
        # then groups its sums as the chunked loop's (and as unsharded)
        host_pages = page_bucket(int(caches.base.max()), page,
                                 caches.capacity)
    caches, rows = _local_view(caches)
    tokens, = M.take_slots(rows, tokens)
    if prefix_on is not None:
        prefix_on, = M.take_slots(rows, torch.as_tensor(prefix_on))
    B, S = tokens.shape
    dev = tokens.device
    cdev = caches.base.device            # where the cursors lie
    pos0 = (caches.base + caches.hot_len).to(torch.int64)
    pre_len = None
    if prefix is not None:
        on = (torch.ones(B, dtype=torch.int64, device=cdev)
              if prefix_on is None
              else torch.as_tensor(prefix_on).to(torch.int64))
        pre_len = on * prefix.length
        pos0 = pos0 + pre_len
    positions = (pos0[:, None]
                 + torch.arange(S, device=cdev)[None, :]).to(dev)
    x = M.embed(params, tokens, cfg, positions)
    rope_cs = M.position_tables(cfg, positions)
    alibi = None
    if cfg.positions == "alibi":
        tp = params.tp
        n = 1 if tp is None else tp.size
        h0 = 0 if tp is None else tp.index * (cfg.n_heads // n)
        alibi = _Alibi(M.alibi_slopes(cfg.n_heads, dev)[
            h0:h0 + cfg.n_heads // n].reshape(cfg.kv_heads // n, -1),
            positions)
    P0 = prefix.k.shape[1] if prefix is not None else 0
    if n_pages is None:
        ctx = _step_ctx(caches, S, dev, pre_len, P0, host_pages)
    else:
        ctx = _step_ctx_dev(caches, S, pre_len, P0, n_pages)
    for l, bp in enumerate(params.blocks):
        x, _ = M.residual(
            bp, x, cfg,
            lambda h, l=l, bp=bp: (_paged_attention(
                bp.attn, h, cfg, l, caches, rope_cs, page, ctx, prefix,
                alibi), None),
            lambda h, bp=bp: M.mlp(bp.mlp, h, cfg))
    if rows is not None:
        x = comm.all_gather(x, params.dp, dim=0)
    logits = M.unembed(params, x, cfg)
    return logits, Hot(caches.hot_k, caches.hot_v, full_hot_len + S,
                       caches.hot_ks, caches.hot_vs)


def paged_decode_step(params: M.Model, tokens: torch.Tensor,
                      caches: PagedKV, cfg: ModelConfig, *, page: int = 256,
                      prefix: Optional[Prefix] = None,
                      prefix_on: Optional[torch.Tensor] = None,
                      n_pages: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Hot]:
    """One decode token per slot: tokens (B, 1) -> (logits (B, V), Hot)
    (quip_tpu's ``paged_decode_step_unrolled``); ``n_pages`` as in
    :func:`paged_append_step`."""
    logits, hot = paged_append_step(params, tokens, caches, cfg, page=page,
                                    prefix=prefix, prefix_on=prefix_on,
                                    n_pages=n_pages)
    return logits[:, -1, :], hot


def flush_hot(caches: PagedKV) -> PagedKV:
    """Append each slot's hot ring into the frozen arena at its base, in
    place, the cursors on the host: a slice copy a slot, queued without a
    host-to-device copy of the cursors (which would wait for the stream).
    Rows past hot_len are garbage but land at >= the new base, which masks
    and later flushes overwrite. Slots must keep base + hot <= capacity
    (callers retire them earlier). A dp shard flushes its own slots; the
    cursors of all advance."""
    P = caches.hot_size
    view, _ = _local_view(caches)
    for b, at in enumerate(view.base.tolist()):
        if at + P > caches.capacity:
            raise ValueError(f"flush_hot: slot {b} base {at} + hot {P} "
                             f"exceeds capacity {caches.capacity}")
        caches.k[:, b, at:at + P] = caches.hot_k[:, b]
        caches.v[:, b, at:at + P] = caches.hot_v[:, b]
        if caches.quantized:
            caches.ks[:, b, at:at + P] = caches.hot_ks[:, b]
            caches.vs[:, b, at:at + P] = caches.hot_vs[:, b]
    return caches._replace(base=caches.base + caches.hot_len,
                           hot_len=torch.zeros_like(caches.hot_len))


def flush_hot_dev(caches: PagedKV, advance: bool = True) -> None:
    """The flush with nothing read back, so the cursors may lie on the
    device: every slot's whole ring lands at base..base+hot-1 through one
    indexed write a tensor, then (``advance``) base += hot_len and hot_len
    = 0 in the cursor tensors themselves. Caches that share one cursor pair
    (a speculative engine's draft and target) flush the others with
    ``advance=False`` first. Rows are clamped to the arena: a live slot
    keeps base + hot <= capacity (the engine retires it earlier), and only
    a free slot's frozen cursors could reach past it, onto its own dead
    rows. A dp shard flushes its own slots; the cursors of all advance."""
    B, P = caches.hot_k.shape[1], caches.hot_size
    dev = caches.k.device
    view, _ = _local_view(caches)
    rows = (view.base.to(dev, torch.int64)[:, None]
            + torch.arange(P, device=dev)[None, :]).clamp_(
                max=caches.capacity - 1)
    slot = torch.arange(B, device=dev)[:, None].expand(B, P)
    caches.k[:, slot, rows] = caches.hot_k
    caches.v[:, slot, rows] = caches.hot_v
    if caches.quantized:
        caches.ks[:, slot, rows] = caches.hot_ks
        caches.vs[:, slot, rows] = caches.hot_vs
    if advance:
        caches.base.add_(caches.hot_len)
        caches.hot_len.zero_()


def _prompt_kv(params: M.Model, tokens: torch.Tensor, plen: torch.Tensor,
               cfg: ModelConfig):
    """Run the prompt through the model, returning the last real
    position's logits (B, V) and per-layer K/V (B, S, KV, hd), after RoPE
    for the rope family.

    tokens (B, S) (right-padded); plen (B,) real lengths. Only the last
    real rows go through the lm_head."""
    last, ks, vs = _prompt_hidden(params, tokens, plen, cfg)
    return M.unembed(params, last, cfg)[:, 0], ks, vs


def _prompt_hidden(params: M.Model, tokens: torch.Tensor,
                   plen: torch.Tensor, cfg: ModelConfig):
    """``_prompt_kv`` before the head: the last real positions' hidden
    states (B, 1, D) and the per-layer K/V."""
    B, S = tokens.shape
    M.check_positions(params, cfg, S)
    dev = tokens.device
    plen = plen.to(device=dev, dtype=torch.int64)
    positions = torch.arange(S, device=dev).expand(B, S)
    key = torch.arange(S, device=dev)
    mask = ((key[None, None, :] <= positions[:, :, None])
            & (key[None, None, :] < plen[:, None, None]))
    x = M.embed(params, tokens, cfg, positions)
    rope_cs = M.position_tables(cfg, positions)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for bp in params.blocks:
        x, (k, v) = M.block_apply(bp, x, cfg, positions, mask,
                                  rope_cs=rope_cs, plen=plen)
        ks.append(k)
        vs.append(v)
    last = x[torch.arange(B, device=dev), plen - 1][:, None]   # (B, 1, D)
    return last, ks, vs


def _store_kv(caches: PagedKV, ks, vs, slot: int) -> None:
    """Write per-layer prompt K/V (1, S, KV, hd) into the frozen arena of
    ``slot`` at position 0, in place (int8 caches quantise them)."""
    for l, (k, v) in enumerate(zip(ks, vs)):
        k, v = k[0], v[0]
        S = k.shape[0]
        if caches.quantized:
            k, caches.ks[l, slot, :S] = M.quantize_kv(k)
            v, caches.vs[l, slot, :S] = M.quantize_kv(v)
        caches.k[l, slot, :S] = k.to(caches.k.dtype)
        caches.v[l, slot, :S] = v.to(caches.v.dtype)


def paged_prefill(params: M.Model, tokens: torch.Tensor, plen,
                  caches: PagedKV, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, PagedKV]:
    """Prefill ALL slots with right-padded prompts (quip_tpu's
    ``paged_prefill``). tokens (B, S), plen (B,) real lengths. Returns (the
    last real positions' logits (B, V), caches with base = plen and
    hot_len = 0, on the host). Padded rows land at >= base and are masked."""
    B, S = tokens.shape
    if S > caches.capacity:
        raise ValueError(f"prompt of {S} exceeds capacity {caches.capacity}")
    plen = torch.as_tensor(plen, dtype=torch.int32).reshape(B)
    logits, ks, vs = _prompt_kv(params, tokens, plen, cfg)
    for b in range(B):
        _store_kv(caches, [k[b:b + 1] for k in ks], [v[b:b + 1] for v in vs],
                  b)
    return logits, caches._replace(base=plen.cpu().clone(),
                                   hot_len=torch.zeros(B, dtype=torch.int32))


def paged_prefill_slot(params: M.Model, tokens: torch.Tensor, plen: int,
                       caches: PagedKV, slot: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, PagedKV]:
    """Prefill ONE slot (continuous-batching admission). tokens (1, S),
    plen <= S real tokens. Returns (logits (V,), caches with
    base[slot] = plen, hot_len[slot] = 0). On a dp shard only the dp row
    that holds the slot runs the prompt; its last hidden state is
    broadcast over dp, and every rank computes the logits."""
    S = tokens.shape[1]
    if S > caches.capacity:
        raise ValueError(f"prompt of {S} exceeds capacity {caches.capacity}")
    plen_t = torch.tensor([int(plen)], dtype=torch.int32)
    view, rows = _local_view(caches)
    if rows is None:
        logits, ks, vs = _prompt_kv(params, tokens, plen_t, cfg)
        _store_kv(caches, ks, vs, int(slot))
    else:
        lo, hi = rows
        if lo <= slot < hi:
            last, ks, vs = _prompt_hidden(params, tokens, plen_t, cfg)
            _store_kv(view, ks, vs, int(slot) - lo)
        else:
            last = torch.empty((1, 1, cfg.d_model),
                               dtype=params.embed.tokens.dtype,
                               device=tokens.device)
        last = comm.broadcast(last, params.dp, src=int(slot) // (hi - lo))
        logits = M.unembed(params, last, cfg)[:, 0]
    base, hot_len = caches.base.clone(), caches.hot_len.clone()
    base[int(slot)] = int(plen)
    hot_len[int(slot)] = 0
    return logits[0], caches._replace(base=base, hot_len=hot_len)
