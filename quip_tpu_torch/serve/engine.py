"""Serving engine: continuous-batching decode over packed models.

Port of the paged path of ``quip_tpu/serve/engine.py``: requests claim
slots of a fixed (max_batch, max_seq) paged KV cache (models/paged.py),
each admission prefills its slot at the prompt's exact length (the JAX
engine's power-of-two buckets only fed XLA's compile cache), and two
loops decode, as in quip_tpu:

  * ``step`` decodes one token for all active slots eagerly, then retires
    finished requests and flushes the hot ring when it is full;
  * ``pump`` (``run(chunked=True)``) is the overlapped loop: up to 16
    tokens a slot per dispatch (``_decode_chunk_paged``: sampling on the
    device, the next-token frontier kept there), two chunks in flight, so
    each chunk's host read overlaps the next chunk's device work. On the
    card each chunk shape replays one CUDA graph (serve/graphs.py), where
    quip_tpu runs one jitted scan; ``warmup`` builds them before traffic.
    ``step_chunk`` is the serial form (dispatch, then read).

Retire rules are quip_tpu's: a request ends when it holds
``max_new_tokens + 1`` tokens (the prefill's token plus max_new_tokens),
when its length reaches ``max_seq - 1``, or on a stop token (emitted,
inclusive). ``submit`` clamps ``max_new_tokens`` to the room left in the
sequence.

``kv_quant=True`` keeps the cache as int8 codes with per-(position, head)
scales. ``shared_prefix=<tokens>`` computes a system prompt's KV once; a
request that opts in (``use_prefix``, the default on such an engine)
attends it first, and its own prompt streams through the hot ring in
power-of-two append windows, since the plain prefill cannot attend the
prefix rows.

Not ported yet (ROADMAP): the non-paged arena path (this Engine is paged
only), the speculative pump, ``stream``, the server, mesh sharding, and
the 3-bit 3-in-4 widening (a 3-bit model runs as two planes).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models import paged as PG
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import Model
from quip_tpu_torch.ops.qlinear import _fused_rht_enabled
from quip_tpu_torch.serve.graphs import ChunkGraphs


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 => greedy
    top_k: int = 0                     # 0 => full
    top_p: float = 1.0                 # 1 => no nucleus filter
    stop: Optional[List[int]] = None   # stop token ids (inclusive)
    use_prefix: bool = False           # attend the engine's shared prefix
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0               # first token produced (TTFT anchor)
    t_done: float = 0.0


def _filtered_logits(logits: torch.Tensor, temperature, top_k: int = 0,
                     top_p=None) -> torch.Tensor:
    """Temperature-scale, then mask logits to the top-k / nucleus support
    (order: scale -> top-k -> top-p; ties at the nucleus boundary are all
    kept). temperature (B,) clamped > 0; top_p (B,) in (0, 1] or None."""
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).reshape(-1)
    x = logits.to(torch.float32) / torch.clamp(t, min=1e-6)[:, None]
    neg = torch.finfo(torch.float32).min
    if top_k > 0:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1]
        x = torch.where(x >= kth[:, None], x, neg)
    if top_p is not None:
        top_p = torch.as_tensor(top_p, dtype=torch.float32,
                                device=logits.device).reshape(-1)
        probs = torch.softmax(x, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        cs = torch.cumsum(sp, dim=-1)
        # sorted token j stays iff the mass strictly before it is < top_p
        keep = (cs - sp) < top_p[:, None]
        thr = torch.where(keep, sp, torch.inf).amin(dim=-1)
        x = torch.where(probs >= thr[:, None], x, neg)
    return x


def _sample_on(gen: torch.Generator, logits: torch.Tensor,
               temps: torch.Tensor, top_k: int = 0,
               top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling over slots (B,) on the
    logits' device, with nothing read back (the chunk's sampler): temps
    (B,) and top_p (B,) or None are tensors there, the Gumbel noise comes
    from ``gen``, a generator there. temps <= 0 is greedy for that slot."""
    greedy = torch.argmax(logits, dim=-1)
    x = _filtered_logits(logits, temps, top_k, top_p)
    u = torch.rand(x.shape, generator=gen, device=x.device).clamp_(min=1e-20)
    sampled = torch.argmax(x - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def _sample(gen: torch.Generator, logits: torch.Tensor, temperature,
            top_k: int = 0, top_p=None) -> torch.Tensor:
    """The serial loop's sampler: the tokens on the host, drawn there from
    ``gen`` (a CPU generator); an all-greedy batch reads only the argmax."""
    t = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1)
    if not bool((t > 0).any()):
        return torch.argmax(logits, dim=-1).cpu()
    tp = (None if top_p is None
          else torch.as_tensor(top_p, dtype=torch.float32).reshape(-1))
    return _sample_on(gen, logits.float().cpu(), t, top_k, tp)


def _decode_chunk_paged(params: Model, tokens: torch.Tensor,
                        caches: PG.PagedKV, cfg: ModelConfig, *, page: int,
                        n_pages: int, gen: torch.Generator,
                        temps: Optional[torch.Tensor],
                        top_ps: Optional[torch.Tensor], n_steps: int,
                        top_k: int, prefix: Optional[PG.Prefix] = None,
                        prefix_on: Optional[torch.Tensor] = None):
    """``n_steps`` decode steps for every slot, each step's token feeding
    the next (quip_tpu's ``decode_chunk_paged``). tokens (B, 1) and the
    cursors of ``caches`` (and ``prefix_on``) are tensors on the device;
    the page loop reads ``n_pages`` pages. Tokens are drawn on the device:
    ``temps`` None is the all-greedy chunk (argmax only, no sampling op),
    else ``_sample_on`` with ``gen``. The hot ring is written in place at
    hot_len..hot_len+n_steps-1 (callers keep max(hot_len) + n_steps <=
    hot). Returns (toks (B, n_steps), last (B, 1)); nothing is read back,
    so a CUDA graph can hold the whole chunk."""
    tok, hot_len = tokens, caches.hot_len
    out = []
    for _ in range(n_steps):
        logits, hot = PG.paged_decode_step(
            params, tok, caches._replace(hot_len=hot_len), cfg, page=page,
            prefix=prefix, prefix_on=prefix_on, n_pages=n_pages)
        hot_len = hot.length
        t = (torch.argmax(logits, dim=-1) if temps is None
             else _sample_on(gen, logits, temps, top_k, top_ps))
        out.append(t)
        tok = t[:, None]
    return torch.stack(out, dim=1), tok


class Engine:
    """Continuous-batching generation engine over the paged KV cache."""

    def __init__(self, params: Model, cfg: ModelConfig, *,
                 max_batch: int = 8, max_seq: int = 512,
                 cache_dtype=torch.float32, kv_quant: bool = False,
                 hot: int = 32, page: int = 64, seed: int = 0,
                 shared_prefix=None, admit_limit: Optional[int] = None,
                 pipeline_depth: int = 2, device="cuda"):
        """``admit_limit`` caps the prefills per scheduling boundary while
        decode is ongoing (None: fill every free slot); ``pipeline_depth``
        chunks stay in flight before the pump commits the oldest (both as
        in quip_tpu)."""
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.gen = torch.Generator().manual_seed(seed)
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._queue: List[Request] = []
        self._uid = 0
        self._done_reqs = 0
        self._done_tokens = 0
        self._ttft_sum = 0.0
        self._req_time_sum = 0.0
        self.hot = min(hot, max_seq)
        self.page = page
        # capacity = max_seq + hot so a flush always fits (base <= max_seq)
        self.pkv = PG.init_paged(max_batch, max_seq + self.hot, cfg,
                                 dtype=cache_dtype, quantized=kv_quant,
                                 hot=self.hot, page=page, device=self.device)
        # host-authoritative per-slot cursors (pushed in each call)
        self._base = np.zeros(max_batch, np.int32)
        self._hotlen = np.zeros(max_batch, np.int32)
        # shared-prefix (system prompt) KV: computed once here, read by
        # every opted-in slot (models/paged.Prefix)
        self.prefix = None
        self._prefix_on = np.zeros(max_batch, np.int32)
        if shared_prefix is not None:
            _, self.prefix = PG.build_prefix(
                self.params, np.asarray(shared_prefix, np.int64), cfg,
                quantized=kv_quant)

        self.admit_limit = admit_limit
        # the overlapped loop (pump): dispatched-but-uncommitted chunks,
        # oldest first; slack_chunk caps chunks when the engine is
        # arrival-bound (no backlog, at most half the slots busy), so the
        # first-token wait behind the in-flight chunks stays short
        self._pending_q: List[Dict[str, Any]] = []
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.slack_chunk = 4
        self._front_live = False          # _tok holds the next frontier
        self._host_token_slots: set = set()
        self._cursors_dirty = True        # device cursors must be pushed
        self._first_pending: List = []    # [(slot, Request)]
        self._front_any = False
        self._t_pump = dict(dispatch=0.0, commit_read=0.0, bookkeep=0.0,
                            admit=0.0, resolve=0.0, steps=0, chunks=0)
        # its device state: fixed buffers that every chunk graph reads
        # (their storage outlives the graphs), and a generator of its own,
        # forked from the seed as quip_tpu's fold_in(key, 0x0EE1) is, so
        # the serial loop's draws are unchanged
        B, dev = max_batch, self.device
        self.gen_dev = torch.Generator(device=dev).manual_seed(seed ^ 0x0EE1)
        i32 = dict(dtype=torch.int32, device=dev)
        self._tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self._base_d = torch.zeros(B, **i32)
        self._hot_d = torch.zeros(B, **i32)
        self._pre_d = torch.zeros(B, **i32)
        self._temps_d = torch.zeros(B, dtype=torch.float32, device=dev)
        self._top_p_d = torch.ones(B, dtype=torch.float32, device=dev)
        self._ovr_d = torch.zeros((2, B), dtype=torch.int64, device=dev)
        # async first tokens: drawn on the device at admission into one
        # (B,) buffer; the mask marks the rows that replace the frontier
        # at the next dispatch
        self._first_buf = torch.zeros(B, dtype=torch.int64, device=dev)
        self._front_mask = torch.zeros(B, dtype=torch.bool, device=dev)
        self._graphs = ChunkGraphs(dev, self.gen_dev)

    def _sync_pkv(self) -> PG.PagedKV:
        return self.pkv._replace(base=torch.from_numpy(self._base.copy()),
                                 hot_len=torch.from_numpy(self._hotlen.copy()))

    def _prefix_args(self) -> Dict[str, Any]:
        """The prefix arguments of a paged step ({} without a prefix)."""
        if self.prefix is None:
            return {}
        return dict(prefix=self.prefix,
                    prefix_on=torch.from_numpy(self._prefix_on.copy()))

    def _push(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into a device buffer in stream order without
        waiting for the card: through fresh pinned memory, which the caching
        host allocator keeps until the copy has run."""
        src = torch.from_numpy(np.ascontiguousarray(arr)).reshape(dst.shape)
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _flush_now(self):
        self.pkv = PG.flush_hot(self._sync_pkv())
        self._base += self._hotlen
        self._hotlen[:] = 0
        self._cursors_dirty = True

    def _maybe_flush(self):
        if int(self._hotlen.max()) >= self.hot:
            self._flush_now()

    def _mark_done(self, req: Request) -> None:
        req.done = True
        req.t_done = time.time()
        self._done_reqs += 1
        self._done_tokens += len(req.generated)
        if req.t_first:
            self._ttft_sum += req.t_first - req.t_submit
        self._req_time_sum += req.t_done - req.t_submit

    def _retire_slot(self, i: int) -> None:
        self._mark_done(self._slots[i])
        self._slots[i] = None
        self._host_token_slots.discard(i)
        self._cursors_dirty = True
        self._base[i] = 0
        self._hotlen[i] = 0
        self._prefix_on[i] = 0

    def stats(self) -> Dict[str, Any]:
        """Host-side serving metrics: completed/queued counts, mean TTFT
        and request latency, and the pump's host time per chunk by phase
        (dispatch enqueue, commit read, bookkeeping, admission, first-token
        reads; ``steps`` counts its serial fallbacks)."""
        out: Dict[str, Any] = dict(
            completed=self._done_reqs,
            tokens=self._done_tokens,
            active=sum(s is not None for s in self._slots),
            queued=len(self._queue))
        if self._done_reqs:
            out["mean_ttft_s"] = self._ttft_sum / self._done_reqs
            out["mean_request_s"] = self._req_time_sum / self._done_reqs
        if self._t_pump["chunks"]:
            n = self._t_pump["chunks"]
            out["pump_phase_ms_per_chunk"] = {
                k: (round(v * 1e3 / n, 2) if k != "steps" else v)
                for k, v in self._t_pump.items() if k != "chunks"}
            out["pump_chunks"] = n
        return out

    def _take_tokens(self, req: Request, toks) -> tuple:
        """Budget- and stop-truncate a freshly decoded token run: returns
        (take, stopped); append toks[:take] (a stop token is included).
        Rows past the truncation stay in the cache, dead under the host
        cursors."""
        take = min(len(toks), req.max_new_tokens + 1 - len(req.generated))
        stopped = False
        if req.stop:
            for j in range(take):
                if toks[j] in req.stop:
                    take, stopped = j + 1, True
                    break
        return take, stopped

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, temperature=0.0,
               top_k=0, top_p=1.0, stop=None, use_prefix=None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size >= self.max_seq - 1:
            raise ValueError(
                f"prompt length {prompt.size} >= max_seq-1 "
                f"({self.max_seq - 1}); raise max_seq or truncate")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if use_prefix is None:
            use_prefix = self.prefix is not None
        if use_prefix and self.prefix is None:
            raise ValueError("use_prefix requires an engine built with "
                             "shared_prefix=...")
        # clamp to the room left in the sequence
        max_new_tokens = min(int(max_new_tokens),
                             self.max_seq - 1 - int(prompt.size))
        req = Request(self._uid, prompt, max_new_tokens, temperature,
                      top_k, top_p, list(stop) if stop else None,
                      use_prefix=bool(use_prefix), t_submit=time.time())
        self._uid += 1
        self._queue.append(req)
        return req.uid

    def _admit_with_prefix(self, i: int, req: Request) -> torch.Tensor:
        """Chunked-append admission for a shared-prefix request.

        The prompt must attend the prefix rows, which the plain prefill
        cannot do, so it streams through the hot ring in power-of-two
        windows (flushing when fewer than 2 rows are free). Other slots
        receive garbage hot-ring writes past their hot_len: dead rows under
        the host's cursors, overwritten by their next real step. Returns
        the last real prompt position's logits (V,).

        A last window that fills the ring exactly is flushed before
        returning: the decode step that follows needs a free row.
        (quip_tpu's ``_admit_with_prefix`` returns with the ring full there
        and its next step writes past the ring; ROADMAP queue 3.)"""
        self._base[i] = 0
        self._hotlen[i] = 0
        self._prefix_on[i] = 1
        pos = 0
        logits_last = None
        while pos < len(req.prompt):
            room = self.hot - int(self._hotlen.max())
            if room < 2:
                self._flush_now()
                room = self.hot
            S = 1
            while S * 2 <= room:
                S *= 2
            n = min(len(req.prompt) - pos, S)
            while S >= 2 * n:              # smallest pow2 window >= n
                S //= 2
            window = np.zeros((self.max_batch, S), np.int64)
            window[i, :n] = req.prompt[pos:pos + n]
            caches = self._sync_pkv()
            logits_w, hot = PG.paged_append_step(
                self.params, torch.from_numpy(window).to(self.device),
                caches, self.cfg, page=self.page, **self._prefix_args())
            self.pkv = PG.advance(caches, hot)
            self._hotlen[i] += n           # only this slot really advanced
            pos += n
            logits_last = logits_w[i, n - 1]
        self._maybe_flush()
        return logits_last

    def _first_token(self, logits: torch.Tensor, req: Request):
        """A request's first token drawn on the device from its prefill
        logits (V,), with the chunked loop's generator; a 0-d tensor."""
        if req.temperature <= 0.0:
            return torch.argmax(logits)
        f32 = dict(dtype=torch.float32, device=logits.device)
        tp = (torch.full((1,), req.top_p, **f32) if req.top_p < 1.0
              else None)
        return _sample_on(self.gen_dev, logits[None],
                          torch.full((1,), req.temperature, **f32),
                          req.top_k, tp)[0]

    def _admit(self, limit: Optional[int] = None,
               async_first: bool = False):
        """Fill free slots from the queue (prefill + first token).

        ``limit`` caps admissions at this boundary (engine default:
        ``self.admit_limit``) so prefills do not stall ongoing decode for a
        whole burst; ignored when nothing is decoding.

        ``async_first`` (the pump, non-prefix requests): the first token is
        drawn on the device into ``_first_buf`` and read back later, with
        the next commit, so admission never waits for the card."""
        if limit is None:
            limit = self.admit_limit
        if limit is not None and not any(
                s is not None for s in self._slots):
            limit = None          # idle: nothing to stall, fill greedily
        admitted = 0
        for i in range(self.max_batch):
            if self._slots[i] is None and self._queue:
                if limit is not None and admitted >= limit:
                    break
                admitted += 1
                self._host_token_slots.add(i)
                self._cursors_dirty = True
                req = self._queue.pop(0)
                self._slots[i] = req
                if req.use_prefix:
                    logits = self._admit_with_prefix(i, req)
                else:
                    plen = len(req.prompt)
                    tokens = torch.from_numpy(
                        req.prompt.astype(np.int64))[None]
                    logits, self.pkv = PG.paged_prefill_slot(
                        self.params, tokens.to(self.device), plen,
                        self._sync_pkv(), i, self.cfg)
                    self._base[i] = plen
                    self._hotlen[i] = 0
                if async_first and not req.use_prefix:
                    self._first_buf[i] = self._first_token(logits, req)
                    self._front_mask[i] = True
                    self._first_pending.append((i, req))
                    self._front_any = True
                    self._host_token_slots.discard(i)
                    continue
                tp = [req.top_p] if req.top_p < 1.0 else None
                tok = int(_sample(self.gen, logits[None], [req.temperature],
                                  req.top_k, tp)[0])
                req.generated.append(tok)
                req.t_first = time.time()
                if req.stop and tok in req.stop:
                    self._retire_slot(i)

    def step(self) -> None:
        """One continuous-batching iteration: admit, decode one token for
        all active slots, retire finished requests, flush a full ring."""
        self._drain_pipeline()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return
        last = np.zeros((self.max_batch, 1), np.int64)
        for i in active:
            last[i, 0] = self._slots[i].generated[-1]
        caches = self._sync_pkv()
        logits, hot = PG.paged_decode_step(
            self.params, torch.from_numpy(last).to(self.device), caches,
            self.cfg, page=self.page, **self._prefix_args())
        self.pkv = PG.advance(caches, hot)
        self._cursors_dirty = True      # the host advanced active slots only
        temps = np.zeros((self.max_batch,), np.float32)
        tops = np.ones((self.max_batch,), np.float32)
        for i in active:
            temps[i] = self._slots[i].temperature
            tops[i] = self._slots[i].top_p
        # per-slot top_k: sample per distinct k over the full (B, V)
        toks = np.zeros((self.max_batch,), np.int64)
        top_p_any = any(tops[i] < 1.0 for i in active)
        for kval in sorted({self._slots[i].top_k for i in active}):
            sub = _sample(self.gen, logits, temps, top_k=kval,
                          top_p=tops if top_p_any else None).numpy()
            for r in active:
                if self._slots[r].top_k == kval:
                    toks[r] = sub[r]
        for i in active:
            req = self._slots[i]
            req.generated.append(int(toks[i]))
            self._hotlen[i] += 1
            length = self._base[i] + self._hotlen[i]
            if (len(req.generated) >= req.max_new_tokens + 1
                    or length >= self.max_seq - 1
                    or (req.stop and int(toks[i]) in req.stop)):
                self._retire_slot(i)
        self._maybe_flush()

    # -- chunked decode -------------------------------------------------------

    def _chunk_key(self, T: int, n_pages: int, greedy: bool, top_k: int,
                   top_p_on: bool) -> tuple:
        """Everything a chunk graph is specialised on: its length, page
        bucket, greedy or sampled, top_k, top-p, the prefix, and the fused
        RHT switch (read when the graph is captured)."""
        return (T, n_pages, greedy, top_k, top_p_on, self.prefix is not None,
                _fused_rht_enabled())

    def _chunk_fn(self, T: int, n_pages: int, greedy: bool, top_k: int,
                  top_p_on: bool):
        """The chunk as a function of the engine's fixed buffers: it reads
        the frontier and the cursors there and leaves the next frontier and
        hot_len + T in them; returns the (B, T) tokens."""
        caches = self.pkv._replace(base=self._base_d, hot_len=self._hot_d)
        pre = ({} if self.prefix is None
               else dict(prefix=self.prefix, prefix_on=self._pre_d))

        def fn():
            toks, last = _decode_chunk_paged(
                self.params, self._tok, caches, self.cfg, page=self.page,
                n_pages=n_pages, gen=self.gen_dev,
                temps=None if greedy else self._temps_d,
                top_ps=self._top_p_d if top_p_on else None, n_steps=T,
                top_k=top_k, **pre)
            self._tok.copy_(last)
            self._hot_d.add_(T)
            return toks
        return fn

    def _push_cursors(self, temps: np.ndarray, tops: np.ndarray) -> None:
        self._push(self._base_d, self._base)
        self._push(self._hot_d, self._hotlen)
        self._push(self._pre_d, self._prefix_on)
        self._push(self._temps_d, temps)
        self._push(self._top_p_d, tops)
        self._cursors_dirty = False

    def _launch(self, active: List[int], T: int, top_k: int) -> torch.Tensor:
        """Run one T-token chunk for every slot from the device frontier
        on its key's graph, pushing the host cursors first when the device
        copies are stale; returns its (B, T) tokens on the device. The host
        cursors of the active slots advance by T (optimistically: a commit
        never adds again)."""
        # the ring must hold the chunk (models/paged._step_ctx_dev)
        assert int(self._hotlen.max()) + T <= self.hot, (self._hotlen, T)
        temps = np.zeros((self.max_batch,), np.float32)
        tops = np.ones((self.max_batch,), np.float32)
        for i in active:
            temps[i] = self._slots[i].temperature
            tops[i] = self._slots[i].top_p
        # device cursors equal the host's while every slot is busy (a chunk
        # advances hot_len for all slots, the host for the active ones)
        if self._cursors_dirty or any(s is None for s in self._slots):
            self._push_cursors(temps, tops)
        n_pages = PG.page_bucket(int(self._base.max()), self.page,
                                 self.pkv.capacity)
        args = (T, n_pages, not (temps > 0).any(), top_k,
                bool((tops < 1.0).any()))
        _t0 = time.perf_counter()
        toks = self._graphs.run(self._chunk_key(*args), self._chunk_fn(*args))
        self._t_pump["dispatch"] += time.perf_counter() - _t0
        for i in active:
            self._hotlen[i] += T
        return toks

    def _frontier_from_host(self, active: List[int]) -> None:
        last = np.zeros((self.max_batch, 1), np.int64)
        for i in active:
            last[i, 0] = self._slots[i].generated[-1]
        self._push(self._tok, last)

    def _copy_out(self, toks: torch.Tensor, first: bool = False):
        """Start a chunk's read: its tokens (with the first-token buffer
        as one more column) into fresh host memory, pinned on the card so
        the copy waits for nothing, enqueued right after the replay that
        wrote them (the graph's next replay overwrites its outputs).
        Returns (host tensor, the event its reader waits on, or None)."""
        if first:
            toks = torch.cat([toks, self._first_buf[:, None]], dim=1)
        host = torch.empty(toks.shape, dtype=torch.int64,
                           pin_memory=toks.is_cuda)
        host.copy_(toks, non_blocking=True)
        if not toks.is_cuda:
            return host, None
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def step_chunk(self, max_chunk: int = 16) -> int:
        """Decode up to ``max_chunk`` tokens for all active slots in one
        dispatch, then read them back (the serial chunk). Falls back to
        ``step()`` when slots disagree on top_k or a slot has fewer than 2
        tokens of room. Returns the tokens decoded per slot."""
        self._drain_pipeline()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        lens = self._base + self._hotlen
        remaining = min(
            min(self._slots[i].max_new_tokens + 1
                - len(self._slots[i].generated) for i in active),
            min(self.max_seq - 1 - int(lens[i]) for i in active))
        # a chunk cannot flush mid-way: cap T by the hot ring's room (its
        # last row goes to step(), which flushes the full ring)
        room = self.hot - int(self._hotlen.max())
        if room < 1:
            self._flush_now()
            room = self.hot
        remaining = min(remaining, room)
        ks = {self._slots[i].top_k for i in active}
        if remaining < 2 or max_chunk < 2 or len(ks) > 1:
            self.step()
            return 1
        T = 2
        while T * 2 <= min(remaining, max_chunk):
            T *= 2
        self._frontier_from_host(active)
        host, ready = self._copy_out(self._launch(active, T, ks.pop()))
        if ready is not None:
            ready.synchronize()
        toks = host.numpy()
        self._cursors_dirty = True      # stops left the device cursors ahead
        for i in active:
            req = self._slots[i]
            row = [int(t) for t in toks[i]]
            take, stopped = self._take_tokens(req, row)
            req.generated.extend(row[:take])
            self._hotlen[i] += take - T
            if (stopped or len(req.generated) >= req.max_new_tokens + 1
                    or self._base[i] + self._hotlen[i] >= self.max_seq - 1):
                self._retire_slot(i)
        self._maybe_flush()
        return T

    # -- the overlapped loop --------------------------------------------------
    #
    # The pump keeps up to pipeline_depth chunks in flight: chunk N+1 is
    # dispatched, its input frontier taken from chunk N's device output,
    # before chunk N's tokens are read, so the read and the host's
    # bookkeeping overlap the card's work. Cursors advance optimistically
    # by T at dispatch; a stop token or a retire is the only misprediction,
    # and both retire the slot at commit, which resets its cursors: the
    # in-flight rows of that slot are dead. Commits are uid-guarded, so a
    # slot re-admitted between dispatch and commit never receives the old
    # request's tokens.

    def _drain_pipeline(self) -> None:
        """Commit every chunk in flight and read the pending first tokens:
        the serial paths assume host-complete state."""
        while self._pending_q:
            self._commit_chunk(self._pending_q.pop(0))
        self._resolve_first_tokens()
        self._front_live = False
        self._host_token_slots.clear()

    def _resolve_first_tokens(self) -> None:
        """Read the asynchronously admitted first tokens (one read of the
        (B,) buffer, which waits for the work enqueued before it). A stop
        token there retires its slot."""
        if not self._first_pending:
            return
        pend, self._first_pending = self._first_pending, []
        _t0 = time.perf_counter()
        vals = self._first_buf.cpu().numpy()
        self._t_pump["resolve"] += time.perf_counter() - _t0
        self._take_firsts(pend, vals)

    def _take_firsts(self, pend, vals: np.ndarray) -> None:
        now = time.time()
        for i, req in pend:
            if self._slots[i] is not req:
                continue                      # already retired
            v = int(vals[i])
            req.generated.insert(0, v)
            req.t_first = now
            if req.stop and v in req.stop:
                self._retire_slot(i)

    def _pending_first_count(self, i: int) -> int:
        """First tokens of slot i's request drawn but not yet on the host
        (they count against its budget)."""
        req = self._slots[i]
        n = sum(1 for j, r in self._first_pending if j == i and r is req)
        for pend in self._pending_q:
            n += sum(1 for j, r in pend.get("first", ())
                     if j == i and r is req)
        return n

    def _try_dispatch(self, active: List[int], max_chunk: int,
                      pack_first: bool = True) -> Optional[Dict[str, Any]]:
        """Dispatch the next chunk against optimistic cursors. Returns the
        pending record (``_commit_chunk`` reads it) or None when the
        pipeline cannot proceed (mixed top_k, a slot within 2 tokens of the
        sequence cap, or chunking off). pack_first=False leaves pending
        first tokens to be read on their own."""
        if max_chunk < 2:
            return None
        ks = {self._slots[i].top_k for i in active}
        if len(ks) > 1:
            return None
        inflight: Dict[int, int] = {}
        for pend in self._pending_q:
            for i, uid in zip(pend["slots"], pend["uids"]):
                r = self._slots[i]
                if r is not None and r.uid == uid:
                    inflight[i] = inflight.get(i, 0) + pend["T"]
        # the sequence cap is hard (cursors never overflow the arena); the
        # token budget is soft: T covers the largest outstanding need and
        # a slot that overshoots truncates and retires at commit
        remaining = self.max_seq
        needed = 0
        for i in active:
            req = self._slots[i]
            infl = inflight.get(i, 0) + self._pending_first_count(i)
            committed = len(req.prompt) + len(req.generated) - 1
            remaining = min(remaining, self.max_seq - 1 - committed - infl)
            needed = max(needed, req.max_new_tokens + 1
                         - len(req.generated) - infl)
        if remaining < 2 or needed < 1:
            return None
        # the chunks fill the ring exactly (T = 1 takes its last row), so it
        # is flushed when full, where the serial step flushes it: both loops
        # keep every row in the same level of the cache and do the same
        # arithmetic (quip_tpu flushes one row early)
        room = self.hot - int(self._hotlen.max())
        if room < 1:
            self._flush_now()
            room = self.hot
        T = 1
        while T * 2 <= min(remaining, max(needed, 2), room, max_chunk):
            T *= 2

        # the input frontier: the previous chunk's last tokens on the
        # device; rows of slots admitted since come from the host (sync
        # admission) or from the first-token buffer (async admission)
        if not self._front_live:
            self._resolve_first_tokens()
            active = [i for i in active if self._slots[i] is not None]
            if not active:
                return None
            self._frontier_from_host(active)
            self._host_token_slots.clear()
        else:
            if self._front_any:
                self._tok.copy_(torch.where(self._front_mask[:, None],
                                            self._first_buf[:, None],
                                            self._tok))
            rows = sorted(self._host_token_slots.intersection(active))
            if rows:
                ov = np.zeros((2, self.max_batch), np.int64)
                for i in rows:
                    ov[:, i] = (self._slots[i].generated[-1], 1)
                self._push(self._ovr_d, ov)
                self._tok.copy_(torch.where(self._ovr_d[1][:, None] > 0,
                                            self._ovr_d[0][:, None],
                                            self._tok))
                self._host_token_slots.difference_update(rows)
        if self._front_any:
            self._front_mask.zero_()
            self._front_any = False

        toks = self._launch(active, T, ks.pop())
        self._t_pump["chunks"] += 1
        self._front_live = True
        self._maybe_flush()
        rec = dict(slots=list(active),
                   uids=[self._slots[i].uid for i in active], T=T)
        if pack_first and self._first_pending:
            # the first tokens ride this chunk's read: one read, not two
            rec["first"] = self._first_pending
            self._first_pending = []
        rec["host"], rec["ready"] = self._copy_out(toks, "first" in rec)
        return rec

    def _commit_chunk(self, pend: Dict[str, Any]) -> None:
        """Wait for a dispatched chunk's read and do its bookkeeping (take,
        stop, retire)."""
        first = pend.get("first")
        if first is None:
            self._resolve_first_tokens()
        _t0 = time.perf_counter()
        if pend["ready"] is not None:
            pend["ready"].synchronize()
        arr = pend["host"].numpy()
        self._t_pump["commit_read"] += time.perf_counter() - _t0
        if first is not None:
            self._take_firsts(first, arr[:, -1])
            arr = arr[:, :-1]
        _t0 = time.perf_counter()
        for i, uid in zip(pend["slots"], pend["uids"]):
            req = self._slots[i]
            if req is None or req.uid != uid:
                continue                            # slot was re-admitted
            row = [int(t) for t in arr[i]]
            take, stopped = self._take_tokens(req, row)
            req.generated.extend(row[:take])
            committed = len(req.prompt) + len(req.generated) - 1
            if (stopped or len(req.generated) >= req.max_new_tokens + 1
                    or committed >= self.max_seq - 1):
                # the rows past the truncation, and whatever the chunk in
                # flight wrote for this slot, are dead: cursors reset
                self._retire_slot(i)
        self._t_pump["bookkeep"] += time.perf_counter() - _t0

    def _default_max_chunk(self) -> int:
        return 16

    def _retire_plausible(self) -> bool:
        """Could a slot free at the next commit? True when some slot's
        budget or sequence cap is covered by its in-flight tokens (stop
        tokens are not predictable and not counted)."""
        infl: Dict[int, int] = {}
        for pend in self._pending_q:
            for i, uid in zip(pend["slots"], pend["uids"]):
                r = self._slots[i]
                if r is not None and r.uid == uid:
                    infl[i] = infl.get(i, 0) + pend["T"]
        for i, n in infl.items():
            req = self._slots[i]
            committed = len(req.prompt) + len(req.generated) - 1
            if (req.max_new_tokens + 1 - len(req.generated) <= n
                    or committed + n >= self.max_seq - 1):
                return True
        return False

    def pump(self, max_chunk: Optional[int] = None) -> bool:
        """One overlapped scheduling iteration: admit (subject to
        admit_limit), dispatch the next chunk, and commit the oldest chunk
        in flight once more than ``pipeline_depth`` are. Returns False once
        fully idle. Callers that feed arrivals call it directly;
        run(chunked=True) loops it.

        Under slack (no backlog, at most half the slots busy) chunks are
        short (``slack_chunk``, twice that up to half occupancy) and fresh
        first tokens are read before the next dispatch, so a new request's
        first token does not wait behind long chunks; a slot the pipeline
        cannot serve (mixed top_k, the sequence cap) makes serial progress
        by ``step()``."""
        if max_chunk is None:
            max_chunk = self._default_max_chunk()
        # with a queue waiting, no slot free and a retire in flight, commit
        # the oldest chunk first so the slot frees a chunk earlier
        if (self._queue and self._pending_q
                and not any(s is None for s in self._slots)
                and self._retire_plausible()):
            self._commit_chunk(self._pending_q.pop(0))
        _t0 = time.perf_counter()
        self._admit(async_first=True)
        self._t_pump["admit"] += time.perf_counter() - _t0
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active and not self._pending_q:
            return bool(self._queue)
        slack = not self._queue and 2 * len(active) <= self.max_batch
        if slack:
            deep = 4 * len(active) <= self.max_batch
            max_chunk = min(max_chunk, self.slack_chunk if deep
                            else 2 * self.slack_chunk)
        if self._first_pending and (slack or len(self._pending_q) <= 1):
            self._resolve_first_tokens()
            active = [i for i, r in enumerate(self._slots)
                      if r is not None]     # a stop at the first may retire
        nxt = self._try_dispatch(active, max_chunk) if active else None
        if nxt is not None:
            self._pending_q.append(nxt)
        if self._pending_q and (nxt is None or len(self._pending_q)
                                > self.pipeline_depth):
            self._commit_chunk(self._pending_q.pop(0))
        if nxt is None and not self._pending_q and active:
            # not pipelinable: serial progress, then back into the pipeline
            # with a frontier from the host
            self._resolve_first_tokens()
            if not any(s is not None for s in self._slots):
                return True
            self._t_pump["steps"] += 1
            self.step()
        return True

    def _page_buckets(self) -> List[int]:
        """Every page bucket a dispatch can pick (bases up to max_seq)."""
        return sorted({PG.page_bucket(b, self.page, self.pkv.capacity)
                       for b in range(self.max_seq)})

    def warmup(self, chunked: bool = True,
               page_buckets: Optional[List[int]] = None) -> "Engine":
        """Build the serving paths before real traffic, as quip_tpu's
        warmup compiles them: dummy requests of 30 and 17 new tokens,
        greedy and sampled, walk the chunk ladder (T = 16, 8, 4, 2) and the
        serial fallback; then the chunk graph of every rung (and of T = 1,
        which fills a ring's last row), greedy and sampled (top-p), is built
        and replayed once (a graph's first replay also uploads it to the
        card) at each of ``page_buckets``, by default every page bucket the
        engine can reach (``_page_buckets``; the dummy requests reach only
        the first). On the CPU the same chunks run eagerly. The engine is
        left idle, its stats as they were."""
        kept = (self._done_reqs, self._done_tokens, self._ttft_sum,
                self._req_time_sum, dict(self._t_pump))
        # slack would cap every dummy chunk at slack_chunk: off for the walk
        slack_sv, self.slack_chunk = self.slack_chunk, 1 << 30
        try:
            for n in (30, 17):
                self.run([dict(prompt=[1], max_new_tokens=n)],
                         chunked=chunked)
                self.run([dict(prompt=[1], max_new_tokens=n,
                               temperature=0.5, top_p=0.9)],
                         chunked=chunked)
        finally:
            self.slack_chunk = slack_sv
        if chunked:
            self.run([dict(prompt=[1], max_new_tokens=3)], chunked=False)
            self.run([dict(prompt=[1], max_new_tokens=3, temperature=0.5,
                           top_p=0.9)], chunked=False)
            rungs = sorted(t for t in {1, 2, 4, 8, 16, self.slack_chunk,
                                       2 * self.slack_chunk}
                           if t <= self.hot)      # a chunk fits the ring
            idle = np.zeros((self.max_batch,), np.float32)
            if page_buckets is None:
                page_buckets = self._page_buckets()
            for n_pages in page_buckets:
                for greedy, top_p_on in ((True, False), (False, True)):
                    for T in rungs:
                        args = (T, n_pages, greedy, 0, top_p_on)
                        key = self._chunk_key(*args)
                        for _ in range(1 if key in self._graphs else 2):
                            # idle: a chunk writes dead rows of free slots
                            self._push_cursors(idle, idle + 1.0)
                            self._graphs.run(key, self._chunk_fn(*args))
            self._cursors_dirty = True
            self._front_live = False
        (self._done_reqs, self._done_tokens, self._ttft_sum,
         self._req_time_sum, self._t_pump) = kept
        return self

    def run(self, requests: List[Dict], chunked: bool = False,
            overlap: bool = True,
            max_chunk: Optional[int] = None) -> List[Request]:
        """Submit all, drive until done, return the completed requests.
        chunked=True decodes up to ``max_chunk`` tokens per dispatch: with
        overlap=True through the pump, else through serial
        ``step_chunk``s; chunked=False steps one token at a time."""
        uids = [self.submit(**r) for r in requests]
        all_reqs = {r.uid: r for r in self._queue}
        if max_chunk is None:
            max_chunk = self._default_max_chunk()
        if chunked and overlap:
            while self.pump(max_chunk):
                pass
        else:
            while any(s is not None for s in self._slots) or self._queue:
                if chunked:
                    self.step_chunk(max_chunk)
                else:
                    self.step()
        return [all_reqs[uid] for uid in uids]
