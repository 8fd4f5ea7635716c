"""Serving engine: continuous-batching decode over packed models.

Port of the paged serial path of ``quip_tpu/serve/engine.py``: requests
claim slots of a fixed (max_batch, max_seq) paged KV cache
(models/paged.py), each admission prefills its slot at the prompt's exact
length (the JAX engine's power-of-two buckets only fed XLA's compile
cache), and every ``step`` decodes one token for all active slots, then
retires finished requests and flushes the hot ring when it is full.

Retire rules are quip_tpu's: a request ends when it holds
``max_new_tokens + 1`` tokens (the prefill's token plus max_new_tokens),
when its length reaches ``max_seq - 1``, or on a stop token (emitted,
inclusive). ``submit`` clamps ``max_new_tokens`` to the room left in the
sequence.

Not in this slice (ROADMAP): the overlapped pump / chunked decode, int8
KV, the shared prefix, speculative decoding, mesh sharding, and the 3-bit
3-in-4 widening (a 3-bit model runs as two planes).
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


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 => greedy
    top_k: int = 0                     # 0 => full
    top_p: float = 1.0                 # 1 => no nucleus filter
    stop: Optional[List[int]] = None   # stop token ids (inclusive)
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


def _sample(gen: torch.Generator, logits: torch.Tensor, temperature,
            top_k: int = 0, top_p=None) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling over slots (B,).
    temperature <= 0 means greedy for that slot; the Gumbel noise comes
    from ``gen`` (on the CPU)."""
    t = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1)
    greedy = torch.argmax(logits, dim=-1).cpu()
    if not bool((t > 0).any()):
        return greedy
    x = _filtered_logits(logits, t, top_k, top_p).cpu()
    u = torch.rand(x.shape, generator=gen).clamp_(min=1e-20)
    sampled = torch.argmax(x - torch.log(-torch.log(u)), dim=-1)
    return torch.where(t <= 0.0, greedy, sampled)


class Engine:
    """Continuous-batching generation engine over the paged KV cache."""

    def __init__(self, params: Model, cfg: ModelConfig, *,
                 max_batch: int = 8, max_seq: int = 512,
                 cache_dtype=torch.float32, hot: int = 32, page: int = 64,
                 seed: int = 0, device="cuda"):
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
                                 dtype=cache_dtype, hot=self.hot, page=page,
                                 device=self.device)
        # host-authoritative per-slot cursors (pushed in each call)
        self._base = np.zeros(max_batch, np.int32)
        self._hotlen = np.zeros(max_batch, np.int32)

    def _sync_pkv(self) -> PG.PagedKV:
        return self.pkv._replace(base=torch.from_numpy(self._base.copy()),
                                 hot_len=torch.from_numpy(self._hotlen.copy()))

    def _flush_now(self):
        self.pkv = PG.flush_hot(self._sync_pkv())
        self._base += self._hotlen
        self._hotlen[:] = 0

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
        self._base[i] = 0
        self._hotlen[i] = 0

    def stats(self) -> Dict[str, Any]:
        """Host-side serving metrics: completed/queued counts, mean TTFT
        and request latency."""
        out: Dict[str, Any] = dict(
            completed=self._done_reqs,
            tokens=self._done_tokens,
            active=sum(s is not None for s in self._slots),
            queued=len(self._queue))
        if self._done_reqs:
            out["mean_ttft_s"] = self._ttft_sum / self._done_reqs
            out["mean_request_s"] = self._req_time_sum / self._done_reqs
        return out

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, temperature=0.0,
               top_k=0, top_p=1.0, stop=None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size >= self.max_seq - 1:
            raise ValueError(
                f"prompt length {prompt.size} >= max_seq-1 "
                f"({self.max_seq - 1}); raise max_seq or truncate")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # clamp to the room left in the sequence
        max_new_tokens = min(int(max_new_tokens),
                             self.max_seq - 1 - int(prompt.size))
        req = Request(self._uid, prompt, max_new_tokens, temperature,
                      top_k, top_p, list(stop) if stop else None,
                      t_submit=time.time())
        self._uid += 1
        self._queue.append(req)
        return req.uid

    def _admit(self):
        """Fill every free slot from the queue: prefill + first token."""
        for i in range(self.max_batch):
            if self._slots[i] is None and self._queue:
                req = self._queue.pop(0)
                self._slots[i] = req
                plen = len(req.prompt)
                tokens = torch.from_numpy(req.prompt.astype(np.int64))[None]
                logits, self.pkv = PG.paged_prefill_slot(
                    self.params, tokens.to(self.device), plen,
                    self._sync_pkv(), i, self.cfg)
                self._base[i] = plen
                self._hotlen[i] = 0
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
            self.cfg, page=self.page)
        self.pkv = PG.advance(caches, hot)
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

    def run(self, requests: List[Dict]) -> List[Request]:
        """Submit all, step until done, return the completed requests."""
        uids = [self.submit(**r) for r in requests]
        all_reqs = {r.uid: r for r in self._queue}
        while any(s is not None for s in self._slots) or self._queue:
            self.step()
        return [all_reqs[uid] for uid in uids]
