"""Port parity for the speculative engine (serve/engine.py: the serial spec
step and chunk, the overlapped spec pump with device-authoritative
cursors, warmup's spec graphs, Engine.stream) on llama-tiny, 2-bit packed,
carried over from quip_tpu by params_from_numpy, all f32 on the CPU (where
a chunk graph is the chunk run eagerly).

The schedules of tests/test_spec_pump.py: greedy tokens of the spec pump
must equal the serial spec chunk loop's, the port's own non-spec greedy
tokens, and on two schedules quip_tpu's spec engine's, bit for bit. The
device-cursor flush (models/paged.py::flush_hot_dev) must equal the host
one."""
import jax
import numpy as np
import pytest
import torch

from quip_tpu.serve import engine as JE
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.models import paged as TP
from quip_tpu_torch.serve import engine as TE
from quip_tpu_torch.serve.speculative import make_self_draft
from tests.test_torch_model import _both, _jax_packed_llama

_KW = dict(max_batch=2, max_seq=64, hot=16, page=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg, jparams, tcfg, tparams = _both(seed=4)
    jdraft = _jax_packed_llama(jcfg, seed=5)
    tdraft = params_from_numpy(jax.tree.map(np.asarray, jdraft), tcfg,
                               device="cpu")
    return jcfg, jparams, jdraft, tcfg, tparams, tdraft


def _spec(tcfg, tparams, tdraft, **kw):
    return TE.Engine(tparams, tcfg, paged=True, device="cpu",
                     draft=(tdraft, tcfg), spec_k=2, **{**_KW, **kw})


def _gen(outs):
    return [o.generated for o in outs]


def _plain(tcfg, tparams, reqs, **kw):
    """The port's non-spec greedy tokens, request by request (the serial
    loop, held to quip_tpu's by tests/test_torch_pump.py)."""
    kw = {**_KW, **kw}
    eng = TE.Engine(tparams, tcfg, paged=True, device="cpu", **kw)
    return _gen(eng.run([dict(r) for r in reqs]))


def _stop_mid_chunk(tcfg, tparams):
    [want] = _plain(tcfg, tparams, [dict(prompt=[1, 2, 3],
                                         max_new_tokens=20)])
    stop = int(want[8])
    return [dict(prompt=[1, 2, 3], max_new_tokens=20, stop=[stop]),
            dict(prompt=[4, 5], max_new_tokens=20)], {}


def _readmission(tcfg, tparams):
    rng = np.random.default_rng(7)
    return [dict(prompt=rng.integers(1, 50, rng.integers(1, 6)).tolist(),
                 max_new_tokens=int(rng.integers(3, 20)))
            for _ in range(7)], {}


_SCHEDULES = {
    "serial_and_greedy": lambda c, p: (
        [dict(prompt=[1, 2, 3], max_new_tokens=17),
         dict(prompt=[4, 5], max_new_tokens=7),
         dict(prompt=[6, 7, 8, 9], max_new_tokens=21),
         dict(prompt=[10], max_new_tokens=11)], {}),
    "readmission": _readmission,
    "stop_mid_chunk": _stop_mid_chunk,
    "flush_cadence": lambda c, p: (
        [dict(prompt=[3, 1], max_new_tokens=25),
         dict(prompt=[9], max_new_tokens=25)], dict(hot=8)),
    "int8_kv": lambda c, p: (
        [dict(prompt=[1, 2, 3], max_new_tokens=15),
         dict(prompt=[8, 9], max_new_tokens=12)], dict(kv_quant=True)),
    "shared_prefix": lambda c, p: (
        [dict(prompt=[1, 2, 3], max_new_tokens=11),
         dict(prompt=[7, 8], max_new_tokens=14)],
        dict(shared_prefix=[11, 12, 13, 14])),
    "mostly_free_slots": lambda c, p: (
        [dict(prompt=[2, 4], max_new_tokens=30)], dict(max_batch=4, hot=8)),
    "seq_cap": lambda c, p: (
        [dict(prompt=list(range(1, 20)), max_new_tokens=60)],
        dict(max_batch=1, max_seq=40)),
}


@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
def test_spec_pump_matches_serial_and_plain(tiny, schedule, monkeypatch):
    """The spec pump, the serial spec chunk loop and the non-spec serial
    loop, fresh engines: the same greedy tokens. With a small ring the pump
    flushes while chunks are in flight, at the device cursors."""
    _, _, _, tcfg, tparams, tdraft = tiny
    reqs, kw = _SCHEDULES[schedule](tcfg, tparams)
    in_flight = []                 # per flush: were the device cursors
    flush = TE.Engine._flush_now   # the truth (chunks in flight)?
    monkeypatch.setattr(TE.Engine, "_flush_now",
                        lambda self: (in_flight.append(self._spec_stale),
                                      flush(self))[1])
    eng = _spec(tcfg, tparams, tdraft, **kw)
    pump = eng.run([dict(r) for r in reqs], chunked=True)
    serial = _spec(tcfg, tparams, tdraft, **kw).run(
        [dict(r) for r in reqs], chunked=True, overlap=False)
    plain = _plain(tcfg, tparams, reqs, **kw)
    assert _gen(pump) == _gen(serial)
    for o, r, want in zip(pump, reqs, plain):
        assert o.done and o.generated == want
        if r.get("stop"):
            assert o.generated[-1] in r["stop"]
        else:
            assert len(o.generated) == min(
                r["max_new_tokens"] + 1,
                kw.get("max_seq", 64) - len(r["prompt"]))
    assert eng._t_pump["chunks"] > 0 and not eng._pending_q
    assert not eng._spec_stale                  # idle: host cursors again
    if schedule in ("flush_cadence", "mostly_free_slots"):
        assert any(in_flight)
    st = eng.stats()
    assert 1.0 <= st["spec_emitted_mean"] <= 2.0
    assert sum(st["spec_emitted_hist"]) == len(eng.accept_hist)


def test_spec_pump_matches_quip_tpu(tiny):
    """quip_tpu's spec engine (paged, its overlapped spec pump) and the
    port's on the same weights and requests: two schedules run one after
    the other on one engine of each (quip_tpu compiles once)."""
    jcfg, jparams, jdraft, tcfg, tparams, tdraft = tiny
    jeng = JE.Engine(jparams, jcfg, paged=True, draft=(jdraft, jcfg),
                     spec_k=2, **_KW)
    teng = _spec(tcfg, tparams, tdraft)
    for schedule in ("serial_and_greedy", "readmission"):
        reqs, _ = _SCHEDULES[schedule](tcfg, tparams)
        want = jeng.run([dict(r) for r in reqs], chunked=True)
        got = teng.run([dict(r) for r in reqs], chunked=True)
        assert _gen(got) == _gen(want), schedule
    assert teng.accept_hist == jeng.accept_hist


def test_spec_pump_step_interop(tiny):
    """pump, then a serial step (drain and cursor read-back), then pump:
    the tokens of the serial spec loop."""
    _, _, _, tcfg, tparams, tdraft = tiny
    reqs = [dict(prompt=[1, 2], max_new_tokens=15),
            dict(prompt=[3, 4, 5], max_new_tokens=15)]
    eng = _spec(tcfg, tparams, tdraft)
    uids = [eng.submit(**r) for r in reqs]
    handles = {r.uid: r for r in eng._queue}
    for _ in range(2):
        assert eng.pump()
    assert eng._spec_stale
    eng.step()
    assert not eng._spec_stale
    while eng.pump():
        pass
    assert [handles[u].generated for u in uids] == _plain(tcfg, tparams, reqs)


def test_spec_pump_arrivals_mid_flight(tiny):
    _, _, _, tcfg, tparams, tdraft = tiny
    eng = _spec(tcfg, tparams, tdraft)
    first = [dict(prompt=[1, 2], max_new_tokens=13),
             dict(prompt=[3, 4, 5], max_new_tokens=13)]
    late = [dict(prompt=[6, 7], max_new_tokens=8),
            dict(prompt=[8], max_new_tokens=5)]
    uids = [eng.submit(**r) for r in first]
    handles = {r.uid: r for r in eng._queue}
    for _ in range(2):
        assert eng.pump()
    uids += [eng.submit(**r) for r in late]
    handles.update({r.uid: r for r in eng._queue})
    while eng.pump():
        pass
    assert ([handles[u].generated for u in uids]
            == _plain(tcfg, tparams, first + late))


def test_spec_pump_sampling_budgets(tiny):
    """Sampled slots draw from the pump's device generator; budgets are
    exact and a greedy slot stays exact."""
    _, _, _, tcfg, tparams, tdraft = tiny
    outs = _spec(tcfg, tparams, tdraft, seed=3).run(
        [dict(prompt=[1, 2], max_new_tokens=10, temperature=0.8, top_p=0.9),
         dict(prompt=[7, 8], max_new_tokens=12)], chunked=True)
    assert [len(o.generated) for o in outs] == [11, 13]
    assert outs[1].generated == _plain(
        tcfg, tparams, [dict(prompt=[7, 8], max_new_tokens=12)])[0]


def test_spec_self_draft_warmup_and_stream(tiny):
    """A self-draft engine: warmup leaves it idle with its stats as they
    were, then the pump and ``stream`` give the plain greedy tokens; the
    warmed spec graphs are S = 1, 2 and 4 at every page bucket."""
    _, _, _, tcfg, tparams, _ = tiny
    eng = TE.Engine(tparams, tcfg, paged=True, device="cpu",
                    draft=make_self_draft(tparams, tcfg, 1), spec_k=2, **_KW)
    eng.warmup()
    assert eng.stats()["completed"] == 0 and not eng.accept_hist
    keys = [k for k, _ in eng._warm_graphs(1, True, False)]
    assert [k[:3] for k in keys] == [("spec", 1, 2), ("spec", 2, 2),
                                     ("spec", 4, 2)]
    reqs = [dict(prompt=[5, 6, 7], max_new_tokens=14),
            dict(prompt=[2], max_new_tokens=9)]
    want = _plain(tcfg, tparams, reqs)
    assert _gen(eng.run([dict(r) for r in reqs], chunked=True)) == want
    assert list(eng.stream([5, 6, 7], max_new_tokens=14)) == want[0]
    plain = TE.Engine(tparams, tcfg, paged=True, device="cpu", **_KW)
    assert list(plain.stream([2], max_new_tokens=9)) == want[1]


def test_flush_matches_slot_loop():
    """flush_hot_dev (cursors left in place, nothing read back) and
    flush_hot (host cursors, a new pair) write the frozen rows and move
    the cursors as a slot-by-slot copy of each ring does (bf16 and int8
    caches)."""
    _, _, tcfg, _ = _both()
    for quantized in (False, True):
        kv = TP.init_paged(3, 64, tcfg, hot=8, page=8, quantized=quantized,
                           device="cpu")
        g = torch.Generator().manual_seed(0)
        for t in (kv.hot_k, kv.hot_v) + ((kv.hot_ks, kv.hot_vs)
                                         if quantized else ()):
            t.copy_(torch.randint(-100, 100, t.shape, generator=g)
                    .to(t.dtype))
        kv = kv._replace(base=torch.tensor([0, 17, 40], dtype=torch.int32),
                         hot_len=torch.tensor([8, 3, 0], dtype=torch.int32))
        clone = lambda c: c._replace(**{  # noqa: E731
            f: getattr(c, f).clone() for f in c._fields
            if isinstance(getattr(c, f), torch.Tensor)})
        want = clone(kv)
        pairs = [("k", "hot_k"), ("v", "hot_v")] + (
            [("ks", "hot_ks"), ("vs", "hot_vs")] if quantized else [])
        for b, at in enumerate(kv.base.tolist()):
            for arena, ring in pairs:
                dst, src = getattr(want, arena), getattr(want, ring)
                dst[:, b, at:at + 8] = src[:, b]
        want = want._replace(base=kv.base + kv.hot_len,
                             hot_len=torch.zeros(3, dtype=torch.int32))
        in_place = clone(kv)
        TP.flush_hot_dev(in_place)
        for got in (in_place, TP.flush_hot(clone(kv))):
            for f in want._fields:
                if isinstance(getattr(want, f), torch.Tensor):
                    assert torch.equal(getattr(got, f), getattr(want, f)), f
