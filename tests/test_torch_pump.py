"""Port parity for the chunked, overlapped serving loop (serve/engine.py:
pump, step_chunk, warmup; models/paged.py: the device-form step context and
the page bucket) on llama-tiny, 2-bit packed, carried over from quip_tpu by
params_from_numpy, all f32 on the CPU (where a chunk graph is the chunk
run eagerly).

Greedy tokens must equal quip_tpu's paged pump and the port's own serial
loop on the schedules of tests/test_engine_overlap.py; a chunk must equal
the same number of serial steps bit for bit (tokens and hot ring). The
page bucket regroups the frozen-page sums only: within 1e-5 of max |logit|
of quip_tpu's exact page loop (f32 summation order)."""
import numpy as np
import pytest
import torch

from quip_tpu.serve import engine as JE
from quip_tpu_torch.models import paged as TP
from quip_tpu_torch.serve import engine as TE
from tests.test_torch_model import _both, _jax_chain, _port_chain

_KW = dict(max_batch=2, max_seq=64, hot=8, page=8)


@pytest.fixture(scope="module")
def tiny():
    return _both(seed=4)


def _run(tparams, tcfg, reqs, chunked, eng_kw=None, **run_kw):
    eng = TE.Engine(tparams, tcfg, paged=True, device="cpu",
                    **{**_KW, **(eng_kw or {})})
    return eng, eng.run([dict(r) for r in reqs], chunked=chunked, **run_kw)


def _gen(outs):
    return [o.generated for o in outs]


def _mixed(V, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, V, int(rng.integers(1, 7))).tolist(),
                 max_new_tokens=int(rng.integers(5, 24))) for _ in range(n)]


@pytest.mark.parametrize("schedule", ["mixed", "readmission"])
def test_pump_matches_quip_tpu_pump(tiny, schedule):
    """The same requests through quip_tpu's paged pump and the port's."""
    jcfg, jparams, tcfg, tparams = tiny
    reqs = _mixed(jcfg.vocab_size, 4 if schedule == "mixed" else 7,
                  seed=1 if schedule == "mixed" else 2)
    want = JE.Engine(jparams, jcfg, paged=True, **_KW).run(
        [dict(r) for r in reqs], chunked=True)
    _, got = _run(tparams, tcfg, reqs, chunked=True)
    assert _gen(got) == _gen(want)
    assert [len(g) for g in _gen(got)] == [r["max_new_tokens"] + 1
                                            for r in reqs]


def _stop_mid_chunk(tcfg, tparams):
    _, [r] = _run(tparams, tcfg, [dict(prompt=[1, 2, 3],
                                       max_new_tokens=24)], chunked=False,
                  eng_kw=dict(max_batch=1))
    stop = int(r.generated[9])                  # inside the second chunk
    reqs = [dict(prompt=[1, 2, 3], max_new_tokens=24, stop=[stop]),
            dict(prompt=[4, 5], max_new_tokens=24)]
    _, over = _run(tparams, tcfg, reqs, chunked=True)
    assert over[0].generated[-1] == stop and len(over[0].generated) < 25
    return reqs, {}


def _serial_equal(reqs, eng_kw):
    return lambda tcfg, tparams: (reqs, eng_kw)


_SCHEDULES = {
    "overlap_equals_serial": _serial_equal(
        [dict(prompt=[1, 2, 3], max_new_tokens=19),
         dict(prompt=[4, 5], max_new_tokens=7),
         dict(prompt=[6, 7, 8, 9], max_new_tokens=23),
         dict(prompt=[10], max_new_tokens=12)], {}),
    "stop_mid_chunk": _stop_mid_chunk,
    "readmission": lambda tcfg, tparams: (_mixed(tcfg.vocab_size, 9, 3), {}),
    "shared_prefix": _serial_equal(
        [dict(prompt=[1, 2, 3], max_new_tokens=13),
         dict(prompt=[7, 8], max_new_tokens=18)],
        dict(shared_prefix=[11, 12, 13, 14])),
    "seq_cap": _serial_equal(
        [dict(prompt=list(range(1, 20)), max_new_tokens=60)],
        dict(max_batch=1, max_seq=40)),
    "overbudget_clamp": _serial_equal(
        [dict(prompt=[1, 2, 3], max_new_tokens=500),
         dict(prompt=[4, 5], max_new_tokens=9)], dict(max_seq=40)),
}


@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
def test_pump_matches_serial(tiny, schedule):
    """Overlapped pump and the serial per-token loop, fresh engines."""
    _, _, tcfg, tparams = tiny
    reqs, eng_kw = _SCHEDULES[schedule](tcfg, tparams)
    _, serial = _run(tparams, tcfg, reqs, chunked=False, eng_kw=eng_kw)
    eng, over = _run(tparams, tcfg, reqs, chunked=True, eng_kw=eng_kw)
    assert _gen(over) == _gen(serial)
    assert all(o.done for o in over) and eng._t_pump["chunks"] > 0
    assert not eng._pending_q and not eng._first_pending


def test_step_chunk_matches_serial(tiny):
    _, _, tcfg, tparams = tiny
    reqs = _SCHEDULES["overlap_equals_serial"](tcfg, tparams)[0]
    _, serial = _run(tparams, tcfg, reqs, chunked=False)
    _, chunk = _run(tparams, tcfg, reqs, chunked=True, overlap=False)
    assert _gen(chunk) == _gen(serial)


def test_admit_limit_token_equality(tiny):
    """Capped admission changes the schedule, not the tokens."""
    _, _, tcfg, tparams = tiny
    reqs = [dict(prompt=[i + 1, i + 2], max_new_tokens=11) for i in range(6)]
    kw = dict(max_batch=3)
    _, base = _run(tparams, tcfg, reqs, chunked=True, eng_kw=kw)
    _, capped = _run(tparams, tcfg, reqs, chunked=True,
                     eng_kw=dict(kw, admit_limit=1))
    _, serial = _run(tparams, tcfg, reqs, chunked=False, eng_kw=kw)
    assert _gen(base) == _gen(capped) == _gen(serial)


def test_pump_arrivals_between_pumps(tiny):
    """Requests submitted between pumps complete with the serial tokens."""
    _, _, tcfg, tparams = tiny
    eng = TE.Engine(tparams, tcfg, paged=True, device="cpu", **_KW)
    first = [dict(prompt=[1, 2], max_new_tokens=15),
             dict(prompt=[3, 4, 5], max_new_tokens=15)]
    late = [dict(prompt=[6, 7], max_new_tokens=9),
            dict(prompt=[8], max_new_tokens=5)]
    uids = [eng.submit(**r) for r in first]
    handles = {r.uid: r for r in eng._queue}
    for _ in range(2):
        assert eng.pump()
    uids += [eng.submit(**r) for r in late]
    handles.update({r.uid: r for r in eng._queue})
    while eng.pump():
        pass
    _, ref = _run(tparams, tcfg, first + late, chunked=False)
    assert [handles[u].generated for u in uids] == _gen(ref)


def test_pump_sampling_completes(tiny):
    """Sampled requests draw from the chunked loop's own generator; they
    complete with exactly their budgets."""
    _, _, tcfg, tparams = tiny
    _, outs = _run(tparams, tcfg,
                   [dict(prompt=[1, 2], max_new_tokens=10, temperature=0.8,
                         top_p=0.9),
                    dict(prompt=[3], max_new_tokens=14, temperature=1.1,
                         top_k=5)], chunked=True, eng_kw=dict(seed=5))
    assert [len(o.generated) for o in outs] == [11, 15]
    assert all(0 <= t < tcfg.vocab_size for o in outs for t in o.generated)


def test_overbudget_clamp_walks_the_ladder(tiny):
    """A budget past the sequence cap is clamped at submit; the pump then
    reaches the cap with at most one serial step."""
    _, _, tcfg, tparams = tiny
    eng = TE.Engine(tparams, tcfg, paged=True, device="cpu",
                    **dict(_KW, max_seq=40))
    uid = eng.submit(prompt=[1, 2, 3], max_new_tokens=500)
    req = next(r for r in eng._queue if r.uid == uid)
    assert req.max_new_tokens == 40 - 1 - 3
    while eng.pump():
        pass
    assert req.done and len(req.generated) == req.max_new_tokens + 1
    assert eng._t_pump["steps"] <= 1


@pytest.mark.parametrize("S,prefix", [(1, False), (4, False), (1, True)])
def test_step_ctx_dev_matches_host(S, prefix):
    """The device-form context holds the same rows, masks and page count
    as the host form at every hot_len the ring has room for."""
    _, _, tcfg, _ = _both()
    B, hot, page = 3, 8, 8
    kv = TP.init_paged(B, 64, tcfg, hot=hot, page=page, device="cpu")
    base = torch.tensor([17, 0, 40], dtype=torch.int32)
    pre_len = torch.tensor([5, 0, 5]) if prefix else None
    P0 = 5 if prefix else 0
    n_pages = TP.page_bucket(40, page, kv.capacity)
    for h in range(hot - S + 1):
        hl = torch.tensor([h, (h + 3) % (hot - S + 1), 0], dtype=torch.int32)
        caches = kv._replace(base=base, hot_len=hl)
        want = TP._step_ctx(caches, S, "cpu", pre_len, P0, page)
        got = TP._step_ctx_dev(caches, S, pre_len, P0, n_pages)
        assert got.n_pages == want.n_pages == 8
        for g, w in zip(got.ring_rows + got.win_rows,
                        want.ring_rows + want.win_rows):
            assert g.tolist() == w.tolist()
        assert torch.equal(got.hot_valid, want.hot_valid)
        assert torch.equal(got.base, want.base)
        if prefix:
            assert torch.equal(got.pre_valid, want.pre_valid)


@pytest.mark.parametrize("T,sampled", [(2, False), (8, False), (4, True)])
def test_decode_chunk_equals_serial_steps(T, sampled):
    """A chunk of T equals T serial steps fed its own tokens: the tokens,
    and the hot ring bit for bit (int8 KV, a shared prefix on one slot)."""
    _, _, tcfg, tparams = _both(kv_heads=2, seed=6)
    B, hot, page = 2, 16, 8
    prefix = TP.build_prefix(tparams, [3, 1, 4], tcfg, quantized=True)[1]
    kv = TP.init_paged(B, 48, tcfg, hot=hot, page=page, quantized=True,
                       device="cpu")
    for slot, pr in enumerate(([5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [2, 7])):
        _, kv = TP.paged_prefill_slot(tparams, torch.tensor([pr]), len(pr),
                                      kv, slot, tcfg)
    kv = kv._replace(hot_len=torch.tensor([3, 1], dtype=torch.int32))
    on = torch.tensor([1, 0], dtype=torch.int32)
    clone = lambda c: c._replace(**{f: getattr(c, f).clone()  # noqa: E731
                                    for f in ("k", "v", "hot_k", "hot_v",
                                              "ks", "vs", "hot_ks", "hot_vs")})
    tok0 = torch.tensor([[7], [11]])
    temps = torch.tensor([0.0, 0.9]) if sampled else None
    gen = torch.Generator().manual_seed(1)
    chunk_kv = clone(kv)
    toks, last = TE._decode_chunk_paged(
        tparams, tok0, chunk_kv, tcfg, page=page,
        n_pages=TP.page_bucket(11, page, kv.capacity), gen=gen, temps=temps,
        top_ps=None, n_steps=T, top_k=0, prefix=prefix, prefix_on=on)
    assert toks.shape == (B, T) and last.tolist() == toks[:, -1:].tolist()
    serial_kv = clone(kv)
    gen = torch.Generator().manual_seed(1)
    tok, want = tok0, []
    for _ in range(T):
        logits, hot_s = TP.paged_decode_step(tparams, tok, serial_kv, tcfg,
                                             page=page, prefix=prefix,
                                             prefix_on=on)
        serial_kv = TP.advance(serial_kv, hot_s)
        t = (torch.argmax(logits, -1) if temps is None
             else TE._sample_on(gen, logits, temps))
        want.append(t)
        tok = t[:, None]
    assert toks.tolist() == torch.stack(want, 1).tolist()
    for f in ("hot_k", "hot_v", "hot_ks", "hot_vs"):
        assert torch.equal(getattr(chunk_kv, f), getattr(serial_kv, f)), f


@pytest.mark.parametrize("plens", [(40, 23), (9, 62)])
def test_page_bucket_within_exact_loop(tiny, plens):
    """The port's bucketed page loop against quip_tpu's exact one on the
    same teacher-forced chain across a flush (hot = 8, page = 8, big pages
    of 64): 5 pages read as 8, one big page in place of five small ones;
    then 8 pages, and 9 read as 16. Logits within 1e-5 of max |logit|, the
    same greedy tokens."""
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(sum(plens))
    V = jcfg.vocab_size
    prompts = [rng.integers(0, V, n) for n in plens]
    steps = [rng.integers(0, V, 2) for _ in range(10)]
    want = _jax_chain(jparams, jcfg, prompts, list(plens), steps, 136, 8, 8)
    got = _port_chain(tparams, tcfg, prompts, list(plens), steps, 136, 8, 8)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        assert (g.argmax(-1) == w.argmax(-1)).all()


def test_page_bucket():
    assert [TP.page_bucket(b, 64, 1088) for b in (0, 1, 64, 65, 600, 1023,
                                                  1088)] == [1, 1, 1, 2, 16,
                                                             16, 17]


def test_warmup_leaves_engine_idle(tiny):
    """warmup walks the ladder and builds every chunk of every page
    bucket; afterwards the engine is idle, its stats untouched, and it
    serves the tokens a fresh engine serves."""
    _, _, tcfg, tparams = tiny
    eng = TE.Engine(tparams, tcfg, paged=True, device="cpu", **_KW)
    before = eng.stats()
    assert eng.warmup() is eng
    assert eng.stats() == before
    assert not eng._queue and all(s is None for s in eng._slots)
    assert not eng._pending_q and not eng._first_pending
    reqs = _mixed(tcfg.vocab_size, 3, seed=9)
    got = eng.run([dict(r) for r in reqs], chunked=True)
    _, want = _run(tparams, tcfg, reqs, chunked=True)
    assert _gen(got) == _gen(want)
