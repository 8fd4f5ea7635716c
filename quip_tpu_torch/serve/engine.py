"""Serving engine: continuous-batching decode over packed models.

Port of ``quip_tpu/serve/engine.py``: requests claim slots of a fixed
(max_batch, max_seq) KV cache, each admission prefills its slot at the
prompt's exact length (the JAX engine's power-of-two buckets only fed XLA's
compile cache), and the loops decode, as in quip_tpu. The cache is
quip_tpu's default, the flat slot arena (serve/arena.py: ``paged=False``;
every step reads all max_seq rows of every slot), or with ``paged=True``
the two-level paged cache (models/paged.py), whose steps read only the
rows in use. A draft or a shared prefix forces the paged cache, as in
quip_tpu. 3-bit linears are widened to single-plane 4-bit fields at load
(``pack/format.py::widen_3bit_tree``; ``QUIP_NO_WIDEN3=1`` keeps the two
planes). On the paged cache:

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

``draft=(draft_model, draft_cfg)`` makes the engine speculative, as
quip_tpu's is: each loop runs draft-and-verify iterations of ``spec_k``
tokens (serve/speculative.py) over a draft cache that shares the target's
cursors. The spec pump keeps those cursors on the device while its chunks
are in flight (the host holds upper bounds), freezes free slots with an
active mask, and replays each spec chunk shape as one CUDA graph.
``stream`` yields one request's tokens as they come; serve/server.py is
the HTTP front end.

On the arena, ``step`` decodes one token for every slot and ``step_chunk``
up to 16 in one dispatch (``_decode_chunk_arena``: on the card one CUDA
graph for each chunk shape, where quip_tpu runs one jitted scan, the
lengths in a device buffer pushed from the host before each chunk);
``pump`` runs one serial ``step_chunk`` a call, as quip_tpu's arena pump
does (there is no overlapped arena loop).

``mesh=`` (a parallel/mesh.py (dp, tp) mesh; one process a rank, every
rank running the same host code) serves sharded, as quip_tpu's
``Engine(mesh=)``: it implies the paged cache and checks the same three
divisibilities. Each rank holds its dp shard of the slots and its tp shard
of the kv heads and of every packed linear's columns (the draft's too);
a slot's prefill runs in the dp row that owns it, and each step gathers
the last hidden states over dp, so every rank samples every slot from the
same logits with the same generators and the host state stays identical
on every rank. ``run`` is SPMD (every rank passes the same requests); for
``stream`` and the HTTP server, rank 0 owns the requests: its
``lead(op)`` broadcasts the requests it admitted since the last call and
the loop operation, which the other ranks replay in ``follow()``. On a
gloo group (ranks sharing a card, or the CPU) the chunks run eagerly, since a
CUDA graph cannot hold gloo's collectives; on NCCL they are captured.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from quip_tpu_torch import resolve_device, same_device
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models import paged as PG
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import Model
from quip_tpu_torch.ops.qlinear import _fused_rht_enabled
from quip_tpu_torch.pack.format import widen_3bit_tree
from quip_tpu_torch.serve import arena as AR
from quip_tpu_torch.serve import speculative as SP
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


def _graph_family(key: tuple) -> tuple:
    """A chunk graph's key (``Engine._chunk_key``, ``_arena_key``,
    ``_spec_key``) without its chunk length and page bucket: the keys of
    one family run the same operations on other shapes, so the eager run
    of its first key makes the derived state they all read (the fused
    RHT's operands, the sampling ops) before any of them is captured
    (serve/graphs.py)."""
    if key[0] == "arena":                 # ("arena", T, ...)
        return key[:1] + key[2:]
    if key[0] == "spec":                  # ("spec", S, K, n_pages, ...)
        return key[:1] + key[2:3] + key[4:]
    return key[2:]                        # (T, n_pages, ...)


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


def _decode_chunk_arena(params: Model, tokens: torch.Tensor,
                        lengths: torch.Tensor, kv: AR.BatchedKV,
                        cfg: ModelConfig, *, gen: torch.Generator,
                        temps: Optional[torch.Tensor],
                        top_ps: Optional[torch.Tensor], n_steps: int,
                        top_k: int):
    """``n_steps`` arena decode steps for every slot, each step's token
    feeding the next (quip_tpu's arena ``decode_chunk``): tokens (B, 1) and
    lengths (B,) on the device, every slot's length advancing by one a step
    (inactive slots too, on their own dead rows). Sampling as in
    ``_decode_chunk_paged``. Returns (toks (B, n_steps), last (B, 1));
    nothing is read back."""
    tok, lens = tokens, lengths
    out = []
    for _ in range(n_steps):
        logits = AR.slot_attention_step(params, cfg, tok, lens, kv)
        lens = lens + 1
        t = (torch.argmax(logits, dim=-1) if temps is None
             else _sample_on(gen, logits, temps, top_k, top_ps))
        out.append(t)
        tok = t[:, None]
    return torch.stack(out, dim=1), tok


class Engine:
    """Continuous-batching generation engine over the slot arena or the
    paged KV cache."""

    def __init__(self, params: Model, cfg: ModelConfig, *,
                 max_batch: int = 8, max_seq: int = 512,
                 cache_dtype=torch.float32, kv_quant: bool = False,
                 paged: bool = False, hot: int = 32, page: int = 64,
                 seed: int = 0, shared_prefix=None,
                 admit_limit: Optional[int] = None, pipeline_depth: int = 2,
                 draft=None, spec_k: int = 4, device="cuda", mesh=None):
        """``paged=False`` (quip_tpu's default) serves from the flat slot
        arena, ``paged=True`` from the two-level paged cache (hot ring of
        ``hot`` rows, frozen pages of ``page``), whose per-step reads scale
        with the context in use rather than max_seq. A draft or a
        ``shared_prefix`` implies ``paged=True``.

        ``admit_limit`` caps the prefills per scheduling boundary while
        decode is ongoing (None: fill every free slot); ``pipeline_depth``
        chunks stay in flight before the pump commits the oldest (both as
        in quip_tpu).

        draft=(draft_model, draft_cfg) makes the engine speculative: each
        iteration drafts ``spec_k`` tokens a slot and verifies them in one
        target append (serve/speculative.py). Greedy requests emit exactly
        the target's greedy tokens; sampled ones go through rejection
        sampling. A self-draft (``make_self_draft``) shares the target's
        tensors, and moving it to the device copies nothing.

        ``mesh`` (parallel/mesh.py): serve sharded over its dp and tp axes
        (module docstring); implies ``paged=True``; ``device`` must be the
        mesh's."""
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if not same_device(self.device, mesh.device):
                raise ValueError(
                    f"device {self.device} is not the mesh's device "
                    f"{mesh.device}: pass the mesh's device")
            dp, tp = mesh.axis("dp").size, mesh.axis("tp").size
            if max_batch % dp:
                raise ValueError(
                    f"max_batch={max_batch} must be divisible by the mesh "
                    f"dp axis ({dp}) — the KV cache shards its batch axis")
            if cfg.kv_heads % tp:
                raise ValueError(
                    f"kv_heads={cfg.kv_heads} must be divisible by the "
                    f"mesh tp axis ({tp}) — the KV cache shards its heads")
            if draft is not None and draft[1].kv_heads % tp:
                raise ValueError(
                    f"draft kv_heads={draft[1].kv_heads} must be divisible "
                    f"by the mesh tp axis ({tp}) — the draft KV cache "
                    f"shards its heads too")
            paged = True
        # positions run to the prefix's length + max_seq
        M.check_positions(params, cfg, max_seq + (
            0 if shared_prefix is None else len(shared_prefix)))
        # 3-in-4 serving transcode at load, the target's and the draft's
        # (shared modules once)
        memo: Dict[int, Any] = {}
        params = widen_3bit_tree(params, memo)
        if draft is not None:
            draft = (widen_3bit_tree(draft[0], memo), draft[1])
        self.paged = paged or draft is not None or shared_prefix is not None
        self.params = params.to(self.device)
        self._shard_memo: Dict[int, Any] = {}
        if mesh is not None:
            from quip_tpu_torch.parallel import mesh as PM
            PM.check_replicas(self.params, mesh)
            self.params = PM.shard_params(self.params, cfg, mesh,
                                          self._shard_memo)
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
        self.spec = draft is not None
        if self.spec and spec_k >= self.hot:
            raise ValueError(f"spec_k={spec_k} must be < hot={self.hot}")
        if self.paged:
            # capacity = max_seq + hot so a flush always fits (base <=
            # max_seq)
            self.pkv = self._init_paged(max_batch, max_seq + self.hot, cfg,
                                        dtype=cache_dtype,
                                        quantized=kv_quant, hot=self.hot,
                                        page=page, device=self.device)
        else:
            self.kv = AR.init_arena(cfg, max_batch, max_seq, cache_dtype,
                                    quantize=kv_quant, device=self.device)
        # host-authoritative per-slot cursors (pushed in each call): the
        # paged cache's base and hot_len, the arena's lengths
        self._base = np.zeros(max_batch, np.int32)
        self._hotlen = np.zeros(max_batch, np.int32)
        self._len = np.zeros(max_batch, np.int32)
        # shared-prefix (system prompt) KV: computed once here, read by
        # every opted-in slot (models/paged.Prefix)
        self.prefix = None
        self._prefix_on = np.zeros(max_batch, np.int32)
        if shared_prefix is not None:
            self._prefix_tokens = np.asarray(shared_prefix, np.int64)
            _, self.prefix = PG.build_prefix(
                self.params, self._prefix_tokens, cfg, quantized=kv_quant)

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
        self._len_d = torch.zeros(B, **i32)
        self._temps_d = torch.zeros(B, dtype=torch.float32, device=dev)
        self._top_p_d = torch.ones(B, dtype=torch.float32, device=dev)
        self._ovr_d = torch.zeros((2, B), dtype=torch.int64, device=dev)
        # async first tokens: drawn on the device at admission into one
        # (B,) buffer; the mask marks the rows that replace the frontier
        # at the next dispatch
        self._first_buf = torch.zeros(B, dtype=torch.int64, device=dev)
        self._front_mask = torch.zeros(B, dtype=torch.bool, device=dev)
        # a CUDA graph cannot hold gloo's collectives: chunks run eagerly
        self._graphs = ChunkGraphs(dev, self.gen_dev, eager=(
            mesh is not None and mesh.backend == "gloo"),
            family=_graph_family)
        self._unshared: List[Dict[str, Any]] = []
        self._t_shared = time.time()
        self.accept_hist: List[int] = []   # spec: tokens emitted a step
        self._spec_stale = False
        if self.spec:
            self._init_spec(draft, spec_k, cache_dtype, kv_quant)

    def _init_spec(self, draft, spec_k: int, cache_dtype, kv_quant: bool):
        """The draft's cache (same capacity, ring and page as the
        target's, so one pair of cursors serves both), its shared prefix
        built through its own weights, and the spec pump's state."""
        dmodel, self.draft_cfg = draft
        self.draft_params = dmodel.to(self.device)
        if self.mesh is not None:
            from quip_tpu_torch.parallel import mesh as PM
            self.draft_params = PM.shard_params(
                self.draft_params, self.draft_cfg, self.mesh,
                self._shard_memo)
        self.spec_k = spec_k
        B, dev = self.max_batch, self.device
        self.dkv = self._init_paged(B, self.pkv.capacity, self.draft_cfg,
                                    dtype=cache_dtype, quantized=kv_quant,
                                    hot=self.hot, page=self.page,
                                    device=dev)
        self.dprefix = None
        if self.prefix is not None:
            _, self.dprefix = PG.build_prefix(
                self.draft_params, self._prefix_tokens, self.draft_cfg,
                quantized=kv_quant)
        # device-authoritative cursors (the overlapped spec pump): a spec
        # chunk advances each slot by its acceptance counts, so while
        # chunks are in flight the device cursors (_base_d, _hot_d) are the
        # truth (_spec_stale) and the host keeps upper bounds: _ub_hot on
        # hot_len (dispatch adds S*K for the active slots, a commit takes
        # back its measured slack, a flush zeroes it) and _base_ub on base
        # (a flush adds _ub_hot; a commit after that flush takes the slack
        # back there). They size the ring's room and the page bucket.
        self._ub_hot = np.zeros(B, np.int64)
        self._base_ub = np.zeros(B, np.int64)
        self._flush_epoch = 0
        self._act_d = torch.zeros(B, dtype=torch.int32, device=dev)
        self._tks_d = torch.zeros(B, dtype=torch.int64, device=dev)

    def _init_paged(self, batch: int, capacity: int, cfg: ModelConfig,
                    **kw) -> PG.PagedKV:
        """A paged cache, or under a mesh this rank's shard of it."""
        if self.mesh is None:
            return PG.init_paged(batch, capacity, cfg, **kw)
        from quip_tpu_torch.parallel import mesh as PM
        return PM.init_paged_shard(batch, capacity, cfg, self.mesh, **kw)

    def _sync_pkv(self) -> PG.PagedKV:
        return self._with_cursors(self.pkv)

    def _sync_dkv(self) -> PG.PagedKV:
        return self._with_cursors(self.dkv)

    def _with_cursors(self, caches: PG.PagedKV) -> PG.PagedKV:
        """A cache with the authoritative cursors: the device buffers while
        spec chunks are in flight, else copies of the host's."""
        if self._spec_stale:
            return caches._replace(base=self._base_d, hot_len=self._hot_d)
        return caches._replace(base=torch.from_numpy(self._base.copy()),
                               hot_len=torch.from_numpy(self._hotlen.copy()))

    def _spec_prefix_args(self) -> Dict[str, Any]:
        """The prefix arguments of a host-cursor spec step."""
        if self.prefix is None:
            return {}
        return dict(d_prefix=self.dprefix, t_prefix=self.prefix,
                    prefix_on=torch.from_numpy(self._prefix_on.copy()))

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
        if self._spec_stale:
            # at the device cursors, in stream order behind the chunks in
            # flight; the draft's ring first, before the cursors move
            PG.flush_hot_dev(self._sync_dkv(), advance=False)
            PG.flush_hot_dev(self._sync_pkv())
            self._base_ub += self._ub_hot
            self._ub_hot[:] = 0
            self._flush_epoch += 1
            return
        self.pkv = PG.flush_hot(self._sync_pkv())
        if self.spec:
            self.dkv = PG.flush_hot(self._sync_dkv())
        self._base += self._hotlen
        self._hotlen[:] = 0
        self._cursors_dirty = True
        if self.spec:
            self._base_ub[:] = self._base
            self._ub_hot[:] = 0
            self._flush_epoch += 1

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
        self._len[i] = 0

    def _lengths(self) -> np.ndarray:
        """Per-slot sequence lengths (a host copy)."""
        return self._base + self._hotlen if self.paged else self._len.copy()

    def _advance(self, i: int, n: int) -> None:
        """Move slot i's host cursor by n rows."""
        if self.paged:
            self._hotlen[i] += n
        else:
            self._len[i] += n

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
        if self.mesh is not None:
            out["mesh"] = dict(
                dp=self.mesh.axis("dp").size, tp=self.mesh.axis("tp").size,
                backend=self.mesh.backend,
                chunks="eager (gloo)" if self._graphs.eager
                else "CUDA graphs")
        if self.spec and self.accept_hist:
            out["spec_emitted_mean"] = float(np.mean(self.accept_hist))
            out["spec_emitted_hist"] = np.bincount(
                np.asarray(self.accept_hist),
                minlength=self.spec_k + 1).tolist()
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
        and its next step writes past the ring; ROADMAP queue 3.) A spec
        engine streams the same windows through the draft's cache (its
        logits unused): both caches share the cursors, which are the
        host's here (the spec pump drains before a prefix admission)."""
        assert not self._spec_stale
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
            window = torch.from_numpy(window).to(self.device)
            caches = self._sync_pkv()
            logits_w, hot = PG.paged_append_step(
                self.params, window, caches, self.cfg, page=self.page,
                **self._prefix_args())
            self.pkv = PG.advance(caches, hot)
            if self.spec:
                dcaches = self._sync_dkv()
                _, d_hot = PG.paged_append_step(
                    self.draft_params, window, dcaches, self.draft_cfg,
                    page=self.page, prefix=self.dprefix,
                    prefix_on=torch.from_numpy(self._prefix_on.copy()))
                self.dkv = PG.advance(dcaches, d_hot)
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
                plen = len(req.prompt)
                tokens = (None if req.use_prefix else torch.from_numpy(
                    req.prompt.astype(np.int64))[None].to(self.device))
                if req.use_prefix:
                    logits = self._admit_with_prefix(i, req)
                elif not self.paged:
                    logits = AR.arena_prefill(self.params, tokens, self.kv,
                                              i, self.cfg)
                    self._len[i] = plen
                else:
                    logits, self.pkv = PG.paged_prefill_slot(
                        self.params, tokens, plen, self._sync_pkv(), i,
                        self.cfg)
                    if self.spec:
                        _, self.dkv = PG.paged_prefill_slot(
                            self.draft_params, tokens, plen,
                            self._sync_dkv(), i, self.draft_cfg)
                    self._base[i] = plen
                    self._hotlen[i] = 0
                    if self._spec_stale:
                        # the device cursors are the truth: reset this
                        # slot's there, in stream order behind the chunks
                        # in flight (which may still move them)
                        self._base_d[i] = plen
                        self._hot_d[i] = 0
                        self._pre_d[i] = 0
                        self._base_ub[i] = plen
                        self._ub_hot[i] = 0
                if async_first and self.paged and not req.use_prefix:
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

    def _step_spec(self) -> None:
        """One speculative iteration (the serial loop): admit, draft and
        verify up to spec_k tokens a slot on the host's cursors, retire
        finished requests. Sampled slots draw from the CPU generator."""
        self._drain_pipeline()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return
        K = self.spec_k
        if int(self._hotlen.max()) + K > self.hot:
            self._flush_now()
        last = np.zeros((self.max_batch, 1), np.int64)
        for i in active:
            last[i, 0] = self._slots[i].generated[-1]
        temps, tks, tps = self._sampling_arrays(active)
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        args = (self.draft_params, self.params, dev(last), self._sync_dkv(),
                self._sync_pkv(), self.draft_cfg, self.cfg, K)
        kw = dict(page=self.page, **self._spec_prefix_args())
        if (temps > 0).any():
            emitted, n_emit, _, _ = SP.spec_sample_step(
                *args, self.gen, dev(temps), dev(tks) if tks.any() else None,
                dev(tps) if (tps < 1.0).any() else None, **kw)
        else:
            emitted, n_emit, _, _ = SP.spec_decode_step(*args, **kw)
        em, ne = emitted.cpu().numpy(), n_emit.cpu().numpy()
        self._cursors_dirty = True
        self.accept_hist.extend(int(ne[i]) for i in active)
        for i in active:
            req = self._slots[i]
            # truncating keeps the host cursors exact: rows past hot_len
            # are dead
            toks = [int(t) for t in em[i, :ne[i]]]
            take, stopped = self._take_tokens(req, toks)
            req.generated.extend(toks[:take])
            self._hotlen[i] += take
            if (stopped or len(req.generated) >= req.max_new_tokens + 1
                    or self._base[i] + self._hotlen[i] >= self.max_seq - 1):
                self._retire_slot(i)

    def _sampling_arrays(self, active: List[int]):
        """Per-slot (temps, top_ks, top_ps) of the active slots; free slots
        greedy and unfiltered."""
        temps = np.zeros((self.max_batch,), np.float32)
        tks = np.zeros((self.max_batch,), np.int64)
        tps = np.ones((self.max_batch,), np.float32)
        for i in active:
            temps[i] = self._slots[i].temperature
            tks[i] = self._slots[i].top_k
            tps[i] = self._slots[i].top_p
        return temps, tks, tps

    def step(self) -> None:
        """One continuous-batching iteration: admit, decode one token for
        all active slots, retire finished requests, flush a full ring."""
        if self.spec:
            return self._step_spec()
        self._drain_pipeline()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return
        last = np.zeros((self.max_batch, 1), np.int64)
        for i in active:
            last[i, 0] = self._slots[i].generated[-1]
        tokens = torch.from_numpy(last).to(self.device)
        if self.paged:
            caches = self._sync_pkv()
            logits, hot = PG.paged_decode_step(
                self.params, tokens, caches, self.cfg, page=self.page,
                **self._prefix_args())
            self.pkv = PG.advance(caches, hot)
            self._cursors_dirty = True  # the host advanced active slots only
        else:
            logits = AR.slot_attention_step(
                self.params, self.cfg, tokens,
                torch.from_numpy(self._len.copy()).to(self.device), self.kv)
        temps, _, tops = self._sampling_arrays(active)
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
            self._advance(i, 1)
            if (len(req.generated) >= req.max_new_tokens + 1
                    or self._lengths()[i] >= self.max_seq - 1
                    or (req.stop and int(toks[i]) in req.stop)):
                self._retire_slot(i)
        if self.paged:
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
        if not self.paged:
            self._push(self._len_d, self._len)
        else:
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
        temps, _, tops = self._sampling_arrays(active)
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

    def _arena_key(self, T: int, greedy: bool, top_k: int,
                   top_p_on: bool) -> tuple:
        """An arena chunk graph's key: its length, greedy or sampled,
        top_k, top-p and the fused RHT switch (the arena has one shape, so
        no page bucket)."""
        return ("arena", T, greedy, top_k, top_p_on, _fused_rht_enabled())

    def _arena_chunk_fn(self, T: int, greedy: bool, top_k: int,
                        top_p_on: bool):
        """The arena chunk as a function of the engine's fixed buffers: it
        reads the frontier and the lengths there, leaves the next frontier
        and lengths + T in them, and returns the (B, T) tokens."""
        def fn():
            toks, last = _decode_chunk_arena(
                self.params, self._tok, self._len_d, self.kv, self.cfg,
                gen=self.gen_dev, temps=None if greedy else self._temps_d,
                top_ps=self._top_p_d if top_p_on else None, n_steps=T,
                top_k=top_k)
            self._tok.copy_(last)
            self._len_d.add_(T)
            return toks
        return fn

    def _launch_arena(self, active: List[int], T: int,
                      top_k: int) -> torch.Tensor:
        """Run one T-token arena chunk for every slot from the device
        frontier on its key's graph, the host's lengths pushed first (the
        host checked that every active slot stays below max_seq - 1);
        returns its (B, T) tokens on the device. The host lengths of the
        active slots advance by T, as ``_launch``'s cursors do."""
        temps, _, tops = self._sampling_arrays(active)
        self._push_cursors(temps, tops)
        args = (T, not (temps > 0).any(), top_k, bool((tops < 1.0).any()))
        toks = self._graphs.run(self._arena_key(*args),
                                self._arena_chunk_fn(*args))
        for i in active:
            self._len[i] += T
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

    # -- speculative chunks ---------------------------------------------------

    def _spec_key(self, S: int, n_pages: int, greedy: bool, top_k_on: bool,
                  top_p_on: bool) -> tuple:
        """A spec chunk graph's key: iterations S, window K, page bucket,
        greedy or sampled, top-k and top-p on, the prefix and the fused RHT
        switch (the rule of ``_chunk_key``)."""
        return ("spec", S, self.spec_k, n_pages, greedy, top_k_on, top_p_on,
                self.prefix is not None, _fused_rht_enabled())

    def _spec_chunk_fn(self, S: int, n_pages: int, greedy: bool,
                       top_k_on: bool, top_p_on: bool):
        """S spec iterations as a function of the engine's fixed buffers:
        it reads the frontier, the shared cursors of both caches, the
        sampling parameters and the active mask there, leaves the next
        frontier and the new hot_len in them, and returns the (B, S, K+1)
        tokens and acceptance counts, packed for one read."""
        tc = self.pkv._replace(base=self._base_d, hot_len=self._hot_d)
        dc = self.dkv._replace(base=self._base_d, hot_len=self._hot_d)
        pre = ({} if self.prefix is None else
               dict(d_prefix=self.dprefix, t_prefix=self.prefix,
                    prefix_on=self._pre_d))

        def fn():
            ems, nes, _, t_hot, last = SP.spec_decode_chunk(
                self.draft_params, self.params, self._tok, dc, tc,
                self.draft_cfg, self.cfg, self.spec_k, S, page=self.page,
                gen=self.gen_dev, temps=None if greedy else self._temps_d,
                top_ks=self._tks_d if top_k_on else None,
                top_ps=self._top_p_d if top_p_on else None,
                active=self._act_d, n_pages=n_pages, **pre)
            self._tok.copy_(last)
            self._hot_d.copy_(t_hot.length)
            return torch.cat([ems, nes[:, :, None]], dim=2)
        return fn

    def _launch_spec(self, active: List[int], S: int) -> torch.Tensor:
        """Run S spec iterations for every slot from the device frontier on
        the key's graph (the free slots frozen by the active mask) and
        enter device-authoritative mode; the host's cursors are pushed
        first when they are the truth. Returns the packed (B, S, K+1)
        tokens on the device."""
        temps, tks, tps = self._sampling_arrays(active)
        act = np.zeros((self.max_batch,), np.int32)
        act[active] = 1
        if self._spec_stale:
            self._push(self._temps_d, temps)
            self._push(self._top_p_d, tps)
            n_pages = PG.page_bucket(int(self._base_ub[active].max()),
                                     self.page, self.pkv.capacity)
        else:
            self._push_cursors(temps, tps)
            n_pages = PG.page_bucket(int(self._base.max()), self.page,
                                     self.pkv.capacity)
        self._push(self._tks_d, tks)
        self._push(self._act_d, act)
        greedy = not (temps > 0).any()
        args = (S, n_pages, greedy, not greedy and bool(tks.any()),
                not greedy and bool((tps < 1.0).any()))
        self._spec_stale = True
        _t0 = time.perf_counter()
        packed = self._graphs.run(self._spec_key(*args),
                                  self._spec_chunk_fn(*args))
        self._t_pump["dispatch"] += time.perf_counter() - _t0
        return packed

    def _take_spec(self, i: int, em: np.ndarray, ne: np.ndarray) -> int:
        """Commit slot i's part of a spec chunk: (S, K) tokens and (S,)
        counts. Records the counts, takes the tokens (budget, stop) and
        retires the slot when it is done; returns the tokens taken, or -1
        when it retired."""
        req = self._slots[i]
        self.accept_hist.extend(int(n) for n in ne)
        toks = [int(t) for s in range(len(ne)) for t in em[s, :ne[s]]]
        take, stopped = self._take_tokens(req, toks)
        req.generated.extend(toks[:take])
        committed = len(req.prompt) + len(req.generated) - 1
        if (stopped or len(req.generated) >= req.max_new_tokens + 1
                or committed >= self.max_seq - 1):
            self._retire_slot(i)
            return -1
        return take

    def _spec_S(self, used: int, iters: int, max_chunk: int) -> int:
        """A spec chunk's iteration count S, a power of two: flushes first
        when the ring's ``used`` rows (or their bound) leave room for fewer
        than two windows, then caps S by the ring's room, ``max_chunk`` and
        the ``iters`` the slots' budgets allow (at least 1)."""
        K = self.spec_k
        room = self.hot - used
        if room < 2 * K:
            self._flush_now()
            room = self.hot
        s_cap = min(room // K, max(1, max_chunk // K), max(1, iters))
        S = 1
        while S * 2 <= s_cap:
            S *= 2
        return S

    def _step_spec_chunk(self, max_chunk: int) -> int:
        """Up to max_chunk // spec_k spec iterations in one dispatch, then
        their read (the serial spec chunk), on the host's cursors. One
        iteration is a chunk of S = 1 here, where quip_tpu runs its serial
        step: both are one compiled program, and the port's serial step is
        eager."""
        self._drain_pipeline()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        K = self.spec_k
        lens = self._base + self._hotlen
        remaining = min(
            min(self._slots[i].max_new_tokens + 1
                - len(self._slots[i].generated) for i in active),
            min(self.max_seq - 1 - int(lens[i]) for i in active))
        S = self._spec_S(int(self._hotlen.max()), -(-remaining // K),
                         max_chunk)
        self._frontier_from_host(active)
        host, ready = self._copy_out(self._launch_spec(active, S))
        if ready is not None:
            ready.synchronize()
        arr = host.numpy()
        self._spec_stale = False          # host cursors exact again below
        self._cursors_dirty = True
        for i in active:
            take = self._take_spec(i, arr[i, :, :K], arr[i, :, K])
            if take >= 0:
                self._hotlen[i] += take
        return S * K

    def step_chunk(self, max_chunk: int = 16) -> int:
        """Decode up to ``max_chunk`` tokens for all active slots in one
        dispatch, then read them back (the serial chunk). Falls back to
        ``step()`` when slots disagree on top_k or a slot has fewer than 2
        tokens of room. Returns the tokens decoded per slot. A spec engine
        runs whole draft-and-verify iterations (``_step_spec_chunk``)."""
        if self.spec:
            return self._step_spec_chunk(max_chunk)
        self._drain_pipeline()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        lens = self._lengths()
        remaining = min(
            min(self._slots[i].max_new_tokens + 1
                - len(self._slots[i].generated) for i in active),
            min(self.max_seq - 1 - int(lens[i]) for i in active))
        if self.paged:
            # a chunk cannot flush mid-way: cap T by the hot ring's room
            # (its last row goes to step(), which flushes the full ring)
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
        launch = self._launch if self.paged else self._launch_arena
        host, ready = self._copy_out(launch(active, T, ks.pop()))
        if ready is not None:
            ready.synchronize()
        toks = host.numpy()
        self._cursors_dirty = True      # stops left the device cursors ahead
        for i in active:
            req = self._slots[i]
            row = [int(t) for t in toks[i]]
            take, stopped = self._take_tokens(req, row)
            req.generated.extend(row[:take])
            self._advance(i, take - T)
            if (stopped or len(req.generated) >= req.max_new_tokens + 1
                    or self._lengths()[i] >= self.max_seq - 1):
                self._retire_slot(i)
        if self.paged:
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
            pend = self._pending_q.pop(0)
            if pend.get("kind") == "spec":
                self._commit_chunk_spec(pend)
            else:
                self._commit_chunk(pend)
        self._resolve_first_tokens()
        self._front_live = False
        self._host_token_slots.clear()
        self._resync_spec_cursors()

    def _resync_spec_cursors(self) -> None:
        """Read the exact cursors back from the device after a spec-pump
        drain (the design's only blocking cursor read: the serial
        fallback, a prefix admission, a pump / step boundary). Free slots
        are zeroed on the host; their device values stay frozen until the
        next push."""
        if not self._spec_stale:
            return
        self._base = self._base_d.cpu().numpy().astype(np.int32)
        self._hotlen = self._hot_d.cpu().numpy().astype(np.int32)
        for i, r in enumerate(self._slots):
            if r is None:
                self._base[i] = 0
                self._hotlen[i] = 0
        self._spec_stale = False
        self._cursors_dirty = True

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

        active = self._prepare_frontier(active)
        if not active:
            return None
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

    def _prepare_frontier(self, active: List[int]) -> List[int]:
        """Make ``_tok`` the input frontier of the next chunk: the previous
        chunk's last tokens on the device, with the rows of slots admitted
        since from the host (sync admission) or from the first-token
        buffer (async admission); from the host alone when no chunk left
        one. Returns the slots still active (a first token read here may
        be a stop)."""
        if not self._front_live:
            self._resolve_first_tokens()
            active = [i for i in active if self._slots[i] is not None]
            if not active:
                return active
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
        return active

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

    # -- the overlapped speculative loop -------------------------------------
    #
    # The spec pump keeps the frontier, both caches' cursors and the
    # generator on the device, so chunk N+1 dispatches with no host read of
    # chunk N. Acceptance counts make each chunk's advance data-dependent,
    # so the host cannot mirror the cursors while chunks are in flight:
    #   * the device cursors are authoritative (_spec_stale) and the host
    #     keeps upper bounds (_ub_hot, _base_ub) for the ring's room, the
    #     flushes (_flush_now flushes at the device cursors) and the page
    #     bucket;
    #   * free slots are frozen by the chunk's active mask;
    #   * an admission prefills on the live caches and resets the slot's
    #     device cursors in stream order;
    #   * the serial paths (step, a prefix admission, the tail the pipeline
    #     cannot serve) drain it and read the exact cursors back once.
    # Greedy slots emit the target's greedy tokens whatever the schedule;
    # a stop, budget or sequence cap retires its slot at commit, and the
    # rows the chunks in flight wrote for it are dead.

    def _try_dispatch_spec(self, active: List[int],
                           max_chunk: int) -> Optional[Dict[str, Any]]:
        """Dispatch the next spec chunk against the device state. Returns
        the pending record (``_commit_chunk_spec`` reads it), or None when
        the pipeline cannot proceed (a slot within one window of its
        budget or the sequence cap)."""
        K = self.spec_k
        if not self._spec_stale:          # the host's values are exact
            self._ub_hot[:] = self._hotlen
            self._base_ub[:] = self._base
        infl: Dict[int, int] = {}
        for pend in self._pending_q:
            for i, uid in zip(pend["slots"], pend["uids"]):
                r = self._slots[i]
                if r is not None and r.uid == uid:
                    infl[i] = infl.get(i, 0) + pend["S"]
        # the sequence cap is hard (every iteration in flight may emit K);
        # the budget soft, counting the iterations in flight at the
        # running acceptance mean (quip_tpu's rule)
        est = float(K)
        if self.accept_hist:
            est = max(1.0, float(np.mean(self.accept_hist[-64:])))
        rem_seq = self.max_seq
        needed = 0
        for i in active:
            req = self._slots[i]
            it = infl.get(i, 0)
            committed = len(req.prompt) + len(req.generated) - 1
            needed = max(needed, req.max_new_tokens + 1
                         - len(req.generated) - int(it * est))
            rem_seq = min(rem_seq, self.max_seq - 1 - committed - it * K)
        if needed < 1 or rem_seq < K:
            return None
        # S = 1 stays in the pipeline (quip_tpu drains and steps there: its
        # serial step is one compiled program, the port's is eager)
        S = self._spec_S(int(self._ub_hot.max()),
                         min(-(-needed // K), rem_seq // K), max_chunk)
        active = self._prepare_frontier(active)
        if not active:
            return None
        packed = self._launch_spec(active, S)
        self._t_pump["chunks"] += 1
        self._front_live = True
        self._ub_hot[active] += S * K
        rec = dict(kind="spec", slots=list(active), S=S,
                   uids=[self._slots[i].uid for i in active],
                   epoch=self._flush_epoch)
        rec["host"], rec["ready"] = self._copy_out(packed)
        return rec

    def _commit_chunk_spec(self, pend: Dict[str, Any]) -> None:
        """Wait for a spec chunk's one read (tokens and counts packed) and
        do its bookkeeping; the bound that holds the chunk's slack (the
        ring's, or the base's after a flush) takes it back."""
        _t0 = time.perf_counter()
        if pend["ready"] is not None:
            pend["ready"].synchronize()
        arr = pend["host"].numpy()
        self._t_pump["commit_read"] += time.perf_counter() - _t0
        _t0 = time.perf_counter()
        K, S = self.spec_k, pend["S"]
        for i, uid in zip(pend["slots"], pend["uids"]):
            req = self._slots[i]
            if req is None or req.uid != uid:
                continue                            # slot was re-admitted
            ne = arr[i, :, K]
            if self._take_spec(i, arr[i, :, :K], ne) < 0:
                continue
            slack = S * K - int(ne.sum())
            bound = (self._ub_hot if pend["epoch"] == self._flush_epoch
                     else self._base_ub)
            bound[i] = max(0, int(bound[i]) - slack)
        self._t_pump["bookkeep"] += time.perf_counter() - _t0

    def _pump_spec(self, max_chunk: int) -> bool:
        """One overlapped speculative scheduling iteration (the section
        comment above); ``pump``'s contract."""
        if (self._queue and self._pending_q
                and not any(s is None for s in self._slots)
                and self._retire_plausible()):
            self._commit_chunk_spec(self._pending_q.pop(0))
        # a prefix admission streams windows on the host's cursors: drain
        if (self._spec_stale and any(s is None for s in self._slots)
                and any(r.use_prefix for r in self._queue)):
            self._drain_pipeline()
        _t0 = time.perf_counter()
        self._admit()
        self._t_pump["admit"] += time.perf_counter() - _t0
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active and not self._pending_q:
            if self._queue:
                return True
            if self._spec_stale:
                # idle: the next burst starts from the host's zeros, pushed
                # at its first dispatch
                self._base[:] = 0
                self._hotlen[:] = 0
                self._spec_stale = False
                self._cursors_dirty = True
            self._front_live = False
            return False
        nxt = self._try_dispatch_spec(active, max_chunk) if active else None
        if nxt is not None:
            self._pending_q.append(nxt)
        if self._pending_q and (nxt is None or len(self._pending_q)
                                > self.pipeline_depth):
            self._commit_chunk_spec(self._pending_q.pop(0))
        if nxt is None and not self._pending_q and active:
            # not pipelinable: drain (exact cursors), one serial spec
            # iteration, then back in with a frontier from the host
            self._drain_pipeline()
            if not any(s is not None for s in self._slots):
                return True
            self._t_pump["steps"] += 1
            self.step()
            self._front_live = False
        return True

    def _default_max_chunk(self) -> int:
        """The chunk cap: 16 tokens, or for a spec engine spec_k times
        S = min(8, hot // (2 spec_k)) iterations (at least 2), so the ring
        flushes at most every other chunk."""
        if not self.spec:
            return 16
        return self.spec_k * max(2, min(8, self.hot // (2 * self.spec_k)))

    def _retire_plausible(self) -> bool:
        """Could a slot free at the next commit? True when some slot's
        budget or sequence cap is covered by its in-flight tokens (stop
        tokens are not predictable and not counted)."""
        infl: Dict[int, int] = {}
        for pend in self._pending_q:
            n = pend["T"] if "T" in pend else pend["S"] * self.spec_k
            for i, uid in zip(pend["slots"], pend["uids"]):
                r = self._slots[i]
                if r is not None and r.uid == uid:
                    infl[i] = infl.get(i, 0) + n
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
        if not self.paged:
            # the arena has no overlapped loop: one serial chunk a call
            if any(s is not None for s in self._slots) or self._queue:
                self.step_chunk(max_chunk)
                return True
            return False
        if self.spec:
            return self._pump_spec(max_chunk)
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
        the first). A spec engine builds its spec chunk graphs instead: S =
        1, 2, 4, ... up to the default chunk's iterations. The arena has no
        page buckets: its rungs T = 2, 4, 8, 16 (a chunk's last token
        never needs T = 1 there) are built by the walk and replayed once.
        On the CPU the same chunks run eagerly. The engine is left idle,
        its stats as they were."""
        kept = (self._done_reqs, self._done_tokens, self._ttft_sum,
                self._req_time_sum, dict(self._t_pump),
                list(self.accept_hist))
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
            idle = np.zeros((self.max_batch,), np.float32)
            if not self.paged:
                page_buckets = [None]       # the arena has one shape
            elif page_buckets is None:
                page_buckets = self._page_buckets()
            for n_pages in page_buckets:
                for greedy, top_p_on in ((True, False), (False, True)):
                    for key, fn in self._warm_graphs(n_pages, greedy,
                                                     top_p_on):
                        for _ in range(1 if key in self._graphs else 2):
                            # idle: a chunk writes dead rows of free slots
                            self._push_cursors(idle, idle + 1.0)
                            if self.spec:
                                self._act_d.zero_()
                                self._tks_d.zero_()
                            self._graphs.run(key, fn)
            self._cursors_dirty = True
            self._front_live = False
        (self._done_reqs, self._done_tokens, self._ttft_sum,
         self._req_time_sum, self._t_pump, self.accept_hist) = kept
        return self

    def _warm_graphs(self, n_pages: int, greedy: bool, top_p_on: bool):
        """(key, function) of every chunk graph ``warmup`` builds at one
        page bucket: each rung of the chunk ladder that fits the ring (T =
        1 fills its last row), or each spec chunk S = 1, 2, 4, ... up to the
        default chunk's iterations; on the arena (``n_pages`` None) each
        rung from 2 to the default chunk."""
        if not self.paged:
            for T in (t for t in (2, 4, 8, 16) if t <= self.max_seq):
                args = (T, greedy, 0, top_p_on)
                yield self._arena_key(*args), self._arena_chunk_fn(*args)
            return
        if self.spec:
            top = min(self._default_max_chunk(), self.hot) // self.spec_k
            for S in (2 ** e for e in range(top.bit_length())):
                args = (S, n_pages, greedy, False, top_p_on)
                yield self._spec_key(*args), self._spec_chunk_fn(*args)
            return
        for T in sorted(t for t in {1, 2, 4, 8, 16, self.slack_chunk,
                                    2 * self.slack_chunk} if t <= self.hot):
            args = (T, n_pages, greedy, 0, top_p_on)
            yield self._chunk_key(*args), self._chunk_fn(*args)

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

    # -- rank 0 leads, the other ranks follow (a mesh) ----------------------

    @property
    def leader(self) -> bool:
        """Whether this rank owns the requests (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def submit_shared(self, **kw) -> int:
        """``submit`` on the leader, recorded for the next ``lead`` to
        broadcast (the other ranks submit it there)."""
        if not self.leader:
            raise RuntimeError("only rank 0 submits shared requests; the "
                               "other ranks call follow()")
        uid = self.submit(**kw)
        if self.mesh is not None:
            self._unshared.append(kw)
        return uid

    def _share(self, op: tuple):
        """Broadcast (the requests submitted since the last call, ``op``)
        from rank 0; returns what rank 0 sent."""
        from quip_tpu_torch.parallel import comm
        got = comm.broadcast_object(
            (self._unshared, op) if self.leader else None, self.mesh.world,
            src=0)
        self._unshared = []
        self._t_shared = time.time()
        return got

    def lead(self, op: str, *args):
        """Rank 0's loop operation (``step``, ``pump``, ``step_chunk``):
        under a mesh, first broadcast it with the requests admitted since
        the last one, so every other rank's ``follow`` runs the same
        operation on the same queue. Returns the operation's result."""
        if self.mesh is not None and self.mesh.size > 1:
            self._share((op,) + args)
        return getattr(self, op)(*args)

    def keepalive(self, every_s: float = 1.0) -> None:
        """An idle leader's heartbeat: share nothing at most every
        ``every_s`` seconds, so followers never wait out a group's
        timeout."""
        if (self.mesh is not None and self.mesh.size > 1
                and time.time() - self._t_shared >= every_s):
            self._share(("noop",))

    def release_followers(self) -> None:
        """End every other rank's ``follow`` loop (rank 0, under a mesh)."""
        if self.mesh is not None and self.mesh.size > 1 and self.leader:
            self._share(("stop",))

    def noop(self) -> None:
        return None

    def follow(self) -> None:
        """A non-leader rank's serving loop: replay rank 0's submissions
        and loop operations until it releases the followers."""
        while True:
            reqs, op = self._share(())
            for kw in reqs:
                self.submit(**kw)
            if op[0] == "stop":
                return
            getattr(self, op[0])(*op[1:])

    def stream(self, prompt, max_new_tokens=64, temperature=0.0, top_k=0,
               top_p=1.0, stop=None):
        """Yield one request's tokens as they are produced, stepping the
        engine (other requests keep decoding in the same steps). Under a
        mesh rank 0 streams and the other ranks ``follow``."""
        uid = self.submit_shared(prompt=prompt, max_new_tokens=max_new_tokens,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p, stop=stop)
        req = next(r for r in self._queue if r.uid == uid)
        emitted = 0
        while not req.done:
            self.lead("step")
            while emitted < len(req.generated):
                yield req.generated[emitted]
                emitted += 1
        while emitted < len(req.generated):
            yield req.generated[emitted]
            emitted += 1
