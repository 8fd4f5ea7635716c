"""Speculative decoding over paged KV caches (port of
``quip_tpu/serve/speculative.py``).

A draft model proposes K tokens a slot; the target scores the window
[t0, d_1..d_{K-1}] in ONE multi-token paged append
(models/paged.paged_append_step) and keeps the longest prefix matching its
own choices, then emits one correction token. Greedy slots emit exactly
the target's greedy stream; sampled slots go through rejection sampling
(Leviathan et al. 2211.17192) and are distributed exactly as target-only
sampling with the same filters. Rollback is free: a rejected row sits past
its slot's cursor and the next window overwrites it.

The port keeps quip_tpu's functions and their contracts, with PyTorch's
idiom inside: the models are ``nn.Module``s, the loops are Python loops
(one CUDA graph holds a whole chunk on the card, serve/graphs.py), and
randomness comes from a ``torch.Generator`` passed in. A categorical draw
is uniforms from that generator and an argmax (the Gumbel form of the
engine's ``_sample_on``), so it stays inside a graph; the generator's
device decides where the uniforms are drawn (a CPU generator serves the
engine's serial loop on the card). ``spec_accept`` is a draw around a
deterministic core, ``spec_accept_core``, which takes the uniforms.

The cursors of both caches are either on the host (the serial forms:
``n_pages`` None) or on the tokens' device with the page loop's
``n_pages`` given (the chunked forms), as in ``paged_append_step``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models import paged as PG
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import Model

_TINY = 1e-38


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniforms in (0, 1) from ``gen``, drawn on its device, on ``device``."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u.to(device).clamp_(min=1e-20)


def _categorical(gen: torch.Generator, dist: torch.Tensor) -> torch.Tensor:
    """One draw a row from explicit probabilities (B, V), by the Gumbel
    argmax of log(dist); a zero-probability token is never drawn."""
    u = _uniform(gen, dist.shape, dist.device)
    return torch.argmax(torch.log(torch.clamp(dist, min=_TINY))
                        - torch.log(-torch.log(u)), dim=-1)


def _draft_steps(draft: Model, tokens: torch.Tensor, dcaches: PG.PagedKV,
                 cfg_d: ModelConfig, K: int, pick, **kw):
    """K draft decode steps from tokens (B, 1); ``pick(logits)`` returns
    (next tokens (B,), the distribution drawn from or None). Returns the
    drafts (B, K) and the distributions (B, K, V) or None."""
    tok, hot_len = tokens, dcaches.hot_len
    drafts, dists = [], []
    for _ in range(K):
        logits, hot = PG.paged_decode_step(
            draft, tok, dcaches._replace(hot_len=hot_len), cfg_d, **kw)
        hot_len = hot.length
        nxt, q = pick(logits)
        drafts.append(nxt)
        dists.append(q)
        tok = nxt[:, None]
    q = None if dists[0] is None else torch.stack(dists, dim=1)
    return torch.stack(drafts, dim=1), q


def _verify(target: Model, tokens: torch.Tensor, drafts: torch.Tensor,
            tcaches: PG.PagedKV, cfg_t: ModelConfig, K: int,
            **kw) -> torch.Tensor:
    """The target's logits (B, K, V) for the window [t0, d_1..d_{K-1}];
    row j is its distribution after t0 d_1..d_j."""
    window = torch.cat([tokens, drafts[:, :K - 1]], dim=1)
    logits, _ = PG.paged_append_step(target, window, tcaches, cfg_t, **kw)
    return logits


def _emit(drafts: torch.Tensor, n: torch.Tensor,
          correction: torch.Tensor) -> torch.Tensor:
    """(B, K): drafts before n, the correction at n, zeros after."""
    idx = torch.arange(drafts.shape[1], device=drafts.device)[None, :]
    return torch.where(idx < n[:, None], drafts,
                       torch.where(idx == n[:, None], correction[:, None],
                                   torch.zeros_like(drafts)))


def _advanced(caches: PG.PagedKV, n_emit: torch.Tensor) -> PG.Hot:
    """The cache's Hot with every slot's hot_len moved by its n_emit."""
    length = caches.hot_len.to(n_emit.device) + n_emit.to(torch.int32)
    return PG.Hot(caches.hot_k, caches.hot_v, length, caches.hot_ks,
                  caches.hot_vs)


def _step_kw(page: int, n_pages: Optional[int], prefix, prefix_on):
    """One model's keyword arguments of a paged step."""
    kw = dict(page=page, n_pages=n_pages)
    if prefix is not None:
        kw.update(prefix=prefix, prefix_on=prefix_on)
    return kw


def spec_decode_step(draft: Model, target: Model, tokens: torch.Tensor,
                     dcaches: PG.PagedKV, tcaches: PG.PagedKV,
                     cfg_d: ModelConfig, cfg_t: ModelConfig, K: int, *,
                     page: int = 64, d_prefix: Optional[PG.Prefix] = None,
                     t_prefix: Optional[PG.Prefix] = None, prefix_on=None,
                     n_pages: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, PG.Hot, PG.Hot]:
    """One greedy speculative iteration.

    tokens (B, 1): the last emitted token (in neither cache yet). Both
    caches need >= K rows of hot-ring room (callers flush first). Returns
    (emitted (B, K), positions >= n_emit padding; n_emit (B,) in [1, K];
    the draft's and the target's Hot, each slot's hot_len moved by its
    n_emit). d_prefix / t_prefix + prefix_on (B,): both models attend the
    same shared prefix through their own weights (one on-vector)."""
    dkw = _step_kw(page, n_pages, d_prefix, prefix_on)
    tkw = _step_kw(page, n_pages, t_prefix, prefix_on)
    drafts, _ = _draft_steps(
        draft, tokens, dcaches, cfg_d, K,
        lambda lg: (torch.argmax(lg, dim=-1), None), **dkw)
    greedy = torch.argmax(_verify(target, tokens, drafts, tcaches, cfg_t, K,
                                  **tkw), dim=-1)
    # g_j is the target's choice after t0 d_1..d_j; accept d_1..d_n with
    # d_j == g_{j-1}
    eq = (drafts[:, :K - 1] == greedy[:, :K - 1]).to(torch.int32)
    n = torch.cumprod(eq, dim=1).sum(dim=1)
    correction = torch.gather(greedy, 1, n[:, None])[:, 0]
    n_emit = n + 1
    return (_emit(drafts, n, correction), n_emit, _advanced(dcaches, n_emit),
            _advanced(tcaches, n_emit))


class SpecDecoder:
    """Greedy speculative generation (prefill, step loop and flushes) for a
    batch of equal-role slots, the cursors on the host."""

    def __init__(self, draft: Model, target: Model, cfg_d: ModelConfig,
                 cfg_t: ModelConfig, *, K: int = 4, max_seq: int = 512,
                 hot: int = 32, page: int = 64, batch: int = 1,
                 cache_dtype=torch.bfloat16, kv_quant: bool = False,
                 device="cuda"):
        if K >= hot:
            raise ValueError(f"K={K} must be < hot={hot}")
        self.device = resolve_device(device)
        self.K, self.page, self.hot = K, page, hot
        self.cfg_d, self.cfg_t = cfg_d, cfg_t
        self.draft = draft.to(self.device)
        self.target = target.to(self.device)
        self.max_seq = max_seq
        cap = max_seq + hot
        kw = dict(dtype=cache_dtype, quantized=kv_quant, hot=hot, page=page,
                  device=self.device)
        self.dc = PG.init_paged(batch, cap, cfg_d, **kw)
        self.tc = PG.init_paged(batch, cap, cfg_t, **kw)

    def generate(self, prompts, max_new_tokens: int = 64):
        """Greedy-generate for a batch of prompts (token lists). Returns
        (the generated lists, each the prefill's token plus
        max_new_tokens; the mean tokens emitted a step)."""
        B = self.dc.base.shape[0]
        assert len(prompts) == B, (len(prompts), B)
        plens = [len(p) for p in prompts]
        padded = np.zeros((B, max(plens)), np.int64)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        tokens = torch.from_numpy(padded).to(self.device)
        _, self.dc = PG.paged_prefill(self.draft, tokens, plens, self.dc,
                                      self.cfg_d)
        logits, self.tc = PG.paged_prefill(self.target, tokens, plens,
                                           self.tc, self.cfg_t)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [[int(t)] for t in tok[:, 0].tolist()]
        accept: List[int] = []
        while min(len(o) for o in out) < max_new_tokens + 1:
            if int(self.tc.hot_len.max()) + self.K > self.hot:
                self.dc = PG.flush_hot(self.dc)
                self.tc = PG.flush_hot(self.tc)
            emitted, n_emit, _, _ = spec_decode_step(
                self.draft, self.target, tok, self.dc, self.tc, self.cfg_d,
                self.cfg_t, self.K, page=self.page)
            em, ne = emitted.cpu(), n_emit.cpu()
            hot_len = self.tc.hot_len + ne.to(torch.int32)
            self.dc = self.dc._replace(hot_len=hot_len)
            self.tc = self.tc._replace(hot_len=hot_len)
            accept.extend(ne.tolist())
            for i in range(B):
                out[i].extend(em[i, :ne[i]].tolist())
            tok = em[torch.arange(B), ne - 1][:, None].to(self.device)
            if int((self.tc.base + self.tc.hot_len).max()) \
                    >= self.max_seq - self.K - 1:
                break
        return ([o[:max_new_tokens + 1] for o in out],
                float(np.mean(accept)) if accept else 0.0)


# -- stochastic speculative decoding (rejection sampling) --------------------


def spec_dist(logits: torch.Tensor, temps, top_ks=None,
              top_ps=None) -> torch.Tensor:
    """Per-slot sampling distributions as explicit probabilities (B, V).

    temps (B,): <= 0 is an exact one-hot greedy row. top_ks (B,) ints (0 =
    full vocabulary): a per-slot cutoff gathered from the sorted row, so a
    batch with mixed k is one graph. top_ps (B,) nucleus mass (1.0 = no
    filter). Order as the engine's sampler: scale, top-k, top-p."""
    B, V = logits.shape
    dev = logits.device
    temps = torch.as_tensor(temps, dtype=torch.float32,
                            device=dev).reshape(-1)
    greedy = torch.zeros((B, V), dtype=torch.float32, device=dev)
    greedy.scatter_(1, torch.argmax(logits, dim=-1)[:, None], 1.0)
    x = logits.to(torch.float32) / torch.clamp(temps, min=1e-6)[:, None]
    neg = torch.finfo(torch.float32).min
    if top_ks is not None:
        top_ks = torch.as_tensor(top_ks, device=dev).reshape(-1).long()
        sx = torch.sort(x, dim=-1, descending=True).values
        k = torch.clamp(torch.where(top_ks <= 0, V, top_ks), 1, V)
        kth = torch.gather(sx, 1, (k - 1)[:, None])
        x = torch.where(x >= kth, x, neg)
    if top_ps is not None:
        top_ps = torch.as_tensor(top_ps, dtype=torch.float32,
                                 device=dev).reshape(-1)
        probs = torch.softmax(x, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        cs = torch.cumsum(sp, dim=-1)
        keep = (cs - sp) < top_ps[:, None]
        thr = torch.where(keep, sp, torch.inf).amin(dim=-1)
        x = torch.where(probs >= thr[:, None], x, neg)
    return torch.where(temps[:, None] <= 0.0, greedy,
                       torch.softmax(x, dim=-1))


def spec_accept_core(drafts: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                     u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part of :func:`spec_accept`.

    drafts (B, K); q, p (B, K, V); u (B, K-1) uniforms. Accepts the longest
    prefix with u_j < p_j(d_{j+1}) / q_j(d_{j+1}) (j < K-1). Returns (n (B,)
    accepted drafts, the distribution (B, V) the correction is drawn from:
    norm(max(p_n - q_n, 0)) after a rejection at n, p_{K-1} when every
    comparable draft was accepted, and p_n where the residual is
    numerically empty)."""
    B, K, V = q.shape
    if K > 1:
        d = drafts[:, :K - 1, None]
        qd = torch.gather(q[:, :K - 1], 2, d)[..., 0]
        pd = torch.gather(p[:, :K - 1], 2, d)[..., 0]
        r = torch.where(qd > 0, pd / torch.clamp(qd, min=1e-30),
                        torch.zeros_like(pd))
        acc = (u < r).to(torch.int32)
        n = torch.cumprod(acc, dim=1).sum(dim=1)
    else:
        n = torch.zeros(B, dtype=torch.int64, device=q.device)
    at = n.long()[:, None, None].expand(B, 1, V)
    p_n = torch.gather(p, 1, at)[:, 0]
    q_n = torch.gather(q, 1, at)[:, 0]
    res = torch.where((n == K - 1)[:, None], p_n,
                      torch.clamp(p_n - q_n, min=0.0))
    tot = res.sum(dim=-1, keepdim=True)
    res = torch.where(tot > 0, res / torch.clamp(tot, min=1e-30), p_n)
    return n, res


def spec_accept(gen: torch.Generator, drafts: torch.Tensor, q: torch.Tensor,
                p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sample a drafted window against the target.

    drafts (B, K): d_{j+1} drawn from q_j; q, p (B, K, V) the draft's and
    the target's distributions, positions lined up with the verify append.
    Draws the uniforms and the correction from ``gen``. Returns (emitted
    (B, K), rows past n_emit zero; n_emit (B,) in [1, K]). The emitted
    stream's law is target-only sampling's (Leviathan et al., Thm 3.5)."""
    B, K, _ = q.shape
    u = _uniform(gen, (B, max(K - 1, 0)), q.device)
    n, res = spec_accept_core(drafts, q, p, u)
    corr = _categorical(gen, res)
    return _emit(drafts, n, corr), n + 1


def spec_sample_step(draft: Model, target: Model, tokens: torch.Tensor,
                     dcaches: PG.PagedKV, tcaches: PG.PagedKV,
                     cfg_d: ModelConfig, cfg_t: ModelConfig, K: int,
                     gen: torch.Generator, temps, top_ks=None, top_ps=None,
                     *, page: int = 64, d_prefix: Optional[PG.Prefix] = None,
                     t_prefix: Optional[PG.Prefix] = None, prefix_on=None,
                     n_pages: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, PG.Hot, PG.Hot]:
    """One stochastic speculative iteration: :func:`spec_decode_step`'s
    contract plus a generator and per-slot temps / top_ks / top_ps (each
    (B,) or None). Greedy slots (temps <= 0) emit what spec_decode_step
    emits."""
    dkw = _step_kw(page, n_pages, d_prefix, prefix_on)
    tkw = _step_kw(page, n_pages, t_prefix, prefix_on)

    def pick(logits):
        qd = spec_dist(logits, temps, top_ks, top_ps)
        return _categorical(gen, qd), qd

    drafts, q = _draft_steps(draft, tokens, dcaches, cfg_d, K, pick, **dkw)
    t_logits = _verify(target, tokens, drafts, tcaches, cfg_t, K, **tkw)
    B, _, V = t_logits.shape
    rep = lambda t: (None if t is None  # noqa: E731
                     else torch.as_tensor(t, device=t_logits.device)
                     .reshape(B, 1).expand(B, K).reshape(-1))
    p = spec_dist(t_logits.reshape(B * K, V), rep(temps), rep(top_ks),
                  rep(top_ps)).reshape(B, K, V)
    emitted, n_emit = spec_accept(gen, drafts, q, p)
    return (emitted, n_emit, _advanced(dcaches, n_emit),
            _advanced(tcaches, n_emit))


def make_self_draft(params: Model, cfg: ModelConfig,
                    n_layers: int) -> Tuple[Model, ModelConfig]:
    """Layer-skip self-draft: the target's own first ``n_layers`` blocks.

    Returns (draft, draft cfg): a Model whose ``blocks`` is a ModuleList of
    the target's first n Block modules and whose embedding, final norm and
    head are the target's, so no weight is copied. The shared modules
    convert in place and the draft holds the target's buffer table (a
    dense head) itself, so ``.to()`` on either moves both and never makes
    a second copy. Acceptance is the early-exit
    approximation's; verification keeps the emitted stream exact whatever
    the draft."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers must be in [1, {cfg.n_layers}], "
                         f"got {n_layers}")
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    draft = Model(dcfg, params.embed, params.blocks[:n_layers],
                  params.final_ln, params.lm_head)
    object.__setattr__(draft, "_buffers", params._buffers)
    return draft, dcfg


def spec_decode_chunk(draft: Model, target: Model, tokens: torch.Tensor,
                      dcaches: PG.PagedKV, tcaches: PG.PagedKV,
                      cfg_d: ModelConfig, cfg_t: ModelConfig, K: int,
                      S: int, *, page: int = 64,
                      gen: Optional[torch.Generator] = None, temps=None,
                      top_ks=None, top_ps=None,
                      d_prefix: Optional[PG.Prefix] = None,
                      t_prefix: Optional[PG.Prefix] = None, prefix_on=None,
                      active: Optional[torch.Tensor] = None,
                      n_pages: Optional[int] = None):
    """S speculative iterations back to back (one CUDA graph on the card).
    Callers guarantee S*K rows of hot-ring room (flush first).

    temps None runs the greedy step; otherwise the stochastic step with
    ``gen`` and per-slot temps / top_ks / top_ps (greedy slots exact).

    active (B,) 0/1 (None: all active): an inactive slot's n_emit is forced
    to 0, so its cursors do not move and its frontier row passes through.
    The overlapped spec pump keeps free slots' device cursors frozen this
    way: those cursors are authoritative there, and a free slot advancing
    without bound would push the ring past its end and inflate max(base),
    which sizes the page loop (the graph's page bucket).

    Returns (emitted (B, S, K), n_emit (B, S), the draft's Hot, the
    target's Hot, last (B, 1) the next-token frontier); per iteration s,
    positions >= n_emit[:, s] are padding. Nothing is read back."""
    tok, d_len, t_len = tokens, dcaches.hot_len, tcaches.hot_len
    kw = dict(page=page, d_prefix=d_prefix, t_prefix=t_prefix,
              prefix_on=prefix_on, n_pages=n_pages)
    act = None if active is None else active.to(torch.int32)
    ems, nes = [], []
    for _ in range(S):
        dc = dcaches._replace(hot_len=d_len)
        tc = tcaches._replace(hot_len=t_len)
        if temps is None:
            em, ne, d_hot, t_hot = spec_decode_step(
                draft, target, tok, dc, tc, cfg_d, cfg_t, K, **kw)
        else:
            em, ne, d_hot, t_hot = spec_sample_step(
                draft, target, tok, dc, tc, cfg_d, cfg_t, K, gen, temps,
                top_ks, top_ps, **kw)
        if act is not None:
            ne = ne * act          # frozen cursors and frontier, free slots
            d_hot, t_hot = _advanced(dc, ne), _advanced(tc, ne)
        nxt = torch.gather(em, 1, torch.clamp(ne - 1, min=0)[:, None].long())
        if act is not None:
            nxt = torch.where(act[:, None] > 0, nxt, tok)
        tok, d_len, t_len = nxt, d_hot.length, t_hot.length
        ems.append(em)
        nes.append(ne)
    return (torch.stack(ems, dim=1), torch.stack(nes, dim=1), d_hot, t_hot,
            tok)
