"""PyTorch LM adapter for the zero-shot harness (port of
``quip_tpu/eval/zeroshot/lm.py``; ``TorchLM`` is ``JaxLM``'s counterpart).

Capability parity with BaseLM (reference
zeroShot/models/models_utils.py:140-548): loglikelihood,
loglikelihood_rolling, greedy_until, with the reference's exact scoring
semantics (left-truncate to max_length+1, score the last len(cont) logits,
exact-greedy-match flag, length-descending reordering). Requests are padded
into power-of-two length buckets at a fixed batch size, as in quip_tpu.

Scoring stays on the model's device: one forward a batch, then the
log-softmax of only the continuation rows, the gather of their tokens and
the greedy check, so a batch brings back one (ll, is_greedy) a request
instead of the whole (B, L, V) log-prob array.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig


class ByteTokenizer:
    """Hermetic fallback tokenizer (tests / offline smoke): UTF-8 bytes
    offset by 1, eot = 0. Real evals use an HF tokenizer via
    `load_hf_tokenizer`."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.eot_token_id = 0

    def encode(self, s: str) -> List[int]:
        return [1 + (b % (self.vocab_size - 1)) for b in s.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes((i - 1) % 256 for i in ids if i > 0).decode(
            "utf-8", errors="replace")


def load_hf_tokenizer(model_name: str):
    """HF tokenizer from the local cache or a local path; raises when it is
    not there. Never goes to the network (quip_tpu's may, after a DNS
    probe). ``transformers`` is imported here, so the package imports
    without it."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_name, use_fast=False,
                                        local_files_only=True)

    class _Wrap:
        eot_token_id = tok.eos_token_id or 0
        vocab_size = tok.vocab_size

        def encode(self, s):
            return tok.encode(s, add_special_tokens=False)

        def decode(self, ids):
            return tok.decode(ids)

    return _Wrap()


class Reorderer:
    """Length-descending request reordering (models_utils.py:523-548)."""

    def __init__(self, arr, fn):
        self.size = len(arr)
        self.order = sorted(range(len(arr)), key=lambda i: fn(arr[i]))
        self.arr = [arr[i] for i in self.order]

    def get_reordered(self):
        return self.arr

    def get_original(self, newarr):
        res = [None] * self.size
        for pos, i in enumerate(self.order):
            res[i] = newarr[pos]
        assert all(r is not None for r in res)
        return res


def get_rolling_token_windows(token_list, prefix_token, max_seq_len,
                              context_len):
    """models_utils.py:480-520, verbatim semantics."""
    assert 1 <= context_len <= max_seq_len
    if not token_list:
        return
    pred_len = max_seq_len - context_len + 1
    predicted = 0
    first_seq_len = min(max_seq_len, len(token_list))
    yield ([prefix_token] + token_list[:first_seq_len - 1],
           token_list[:first_seq_len])
    predicted += first_seq_len
    while predicted < len(token_list):
        window_pred_len = min(len(token_list) - predicted, pred_len)
        window_end = predicted + window_pred_len
        yield (
            token_list[window_end - max_seq_len - 1:window_end - 1],
            token_list[window_end - window_pred_len:window_end],
        )
        predicted += window_pred_len


def make_disjoint_window(pair):
    a, b = pair
    return a[: len(a) - (len(b) - 1)], b


def _bucket_len(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def score_continuations(logits: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, toks: torch.Tensor, n: int):
    """Per-request (ll (n,) f64, is_greedy (n,) bool) on the logits' device
    for the n rows of a (B, L, V) batch. Token t of the flattened
    continuations is predicted by ``logits[rows[t], cols[t]]``; its log-prob
    is the f32 log-softmax over the vocabulary, and a row is greedy when
    every one of its tokens is the argmax there."""
    lp = torch.log_softmax(logits[rows, cols].float(), dim=-1)   # (T, V)
    tok_lp = lp.gather(1, toks[:, None])[:, 0]
    miss = (lp.argmax(dim=-1) != toks).to(torch.int32)
    ll = torch.zeros(n, dtype=torch.float64, device=lp.device)
    ll.index_add_(0, rows, tok_lp.double())
    bad = torch.zeros(n, dtype=torch.int32, device=lp.device)
    bad.index_add_(0, rows, miss)
    return ll, bad == 0


class TorchLM:
    """The LM interface consumed by the evaluator, on the model's device."""

    def __init__(self, params: M.Model, cfg: ModelConfig, tokenizer,
                 batch_size: int = 4, max_length: Optional[int] = None,
                 kv_quant: bool = False):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length or cfg.max_seq
        self.eot_token_id = tokenizer.eot_token_id
        # kv_quant: int8 KV caches in the generation engine only; scoring
        # runs the cache-free forward
        self.kv_quant = bool(kv_quant)
        self.device = params.embed_tokens.device

    def tok_encode(self, s: str) -> List[int]:
        return self.tokenizer.encode(s)

    # -- public API ---------------------------------------------------------

    def loglikelihood(self, requests: List[Tuple[str, str]]):
        new_reqs = []
        for context, continuation in requests:
            if context == "":
                context_enc = [self.eot_token_id]
            else:
                context_enc = self.tok_encode(context)
            continuation_enc = self.tok_encode(continuation)
            new_reqs.append(((context, continuation), context_enc,
                             continuation_enc))
        return self._loglikelihood_tokens(new_reqs)

    def loglikelihood_rolling(self, requests: List[Tuple[str]]):
        loglikelihoods = []
        for (string,) in requests:
            windows = list(map(
                make_disjoint_window,
                get_rolling_token_windows(
                    token_list=self.tok_encode(string),
                    prefix_token=self.eot_token_id,
                    max_seq_len=self.max_length,
                    context_len=1,
                )))
            windows = [(None,) + x for x in windows]
            nlls = self._loglikelihood_tokens(windows)
            loglikelihoods.append(sum(x[0] for x in nlls))
        return loglikelihoods

    def _loglikelihood_tokens(self, requests):
        res = []

        def _collate(x):
            toks = x[1] + x[2]
            return (-len(toks), tuple(toks))

        re_ord = Reorderer(requests, _collate)
        reqs = re_ord.get_reordered()
        B = self.batch_size

        for start in range(0, len(reqs), B):
            chunk = reqs[start:start + B]
            inps, rows, cols, toks = [], [], [], []
            for i, (_, context_enc, continuation_enc) in enumerate(chunk):
                assert len(context_enc) > 0
                assert len(continuation_enc) > 0
                assert len(continuation_enc) <= self.max_length
                inp = (context_enc + continuation_enc)[
                    -(self.max_length + 1):][:-1]
                inps.append(inp)
                n = len(continuation_enc)
                rows += [i] * n
                cols += range(len(inp) - n, len(inp))
                toks += continuation_enc

            L = _bucket_len(max(len(inp) for inp in inps))
            # pad rows on the right with token 0: under the causal mask no
            # scored position sees them
            batch = torch.zeros((B, L), dtype=torch.int64)
            for i, inp in enumerate(inps):
                batch[i, :len(inp)] = torch.tensor(inp)
            dev = self.device
            idx = lambda v: torch.tensor(v, dtype=torch.int64,  # noqa: E731
                                         device=dev)
            with torch.inference_mode():
                logits = M.forward(self.params, batch.to(dev), self.cfg)
                ll, greedy = score_continuations(
                    logits, idx(rows), idx(cols), idx(toks), len(chunk))
            res += zip(ll.tolist(), greedy.tolist())
        return re_ord.get_original(res)

    def _gen_engine(self, max_seq: int):
        """ONE paged Engine, rebuilt only when a request needs a LARGER
        max_seq bucket (a larger engine serves shorter requests too: decode
        cost follows used context, not capacity), as in quip_tpu. Its
        cache is in the model's activation dtype."""
        from quip_tpu_torch.serve.engine import Engine

        cur = getattr(self, "_gen_engine_cached", None)
        if cur is not None and cur.max_seq >= max_seq:
            return cur
        self._gen_engine_cached = None       # free the old cache first
        self._gen_engine_cached = Engine(
            self.params, self.cfg, max_batch=4, max_seq=max_seq,
            cache_dtype=self.params.embed_tokens.dtype,
            kv_quant=self.kv_quant, device=self.device)
        return self._gen_engine_cached

    def greedy_until(self, requests: List[Tuple[str, List[str]]],
                     max_gen_toks: int = 256):
        """Generate until a stop substring appears (models_utils.py:411-448),
        driven by ONE shared serving engine (greedy output is
        batch-invariant)."""
        def _collate(x):
            toks = self.tok_encode(x[0])
            return (len(toks), x[0])

        re_ord = Reorderer(requests, _collate)
        reqs = re_ord.get_reordered()
        if not reqs:
            return []
        encs = [self.tok_encode(ctx)[-(self.max_length - max_gen_toks):]
                for ctx, _ in reqs]
        need = max(len(e) for e in encs) + max_gen_toks + 8
        eng = self._gen_engine(min(self.max_length, _bucket_len(need)))
        outs = eng.run([dict(prompt=e, max_new_tokens=max_gen_toks)
                        for e in encs])
        res = []
        for (_, until), req in zip(reqs, outs):
            if isinstance(until, str):
                until = [until]
            s = self.tokenizer.decode(req.generated)
            for term in until:
                s = s.split(term)[0]
            res.append(s)
        return re_ord.get_original(res)
