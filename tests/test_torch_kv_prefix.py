"""Port parity for int8 KV, the non-paged decode_step, the shared prefix
and the engine's kv_quant / shared_prefix configuration, on llama-tiny
(2 layers, GQA with 2 KV heads), 2-bit packed, carried over from quip_tpu by
params_from_numpy. All f32 on the CPU. Tolerances: float caches 1e-4
(summation order). int8 caches 2e-3: a float difference of 1e-6 can flip
one int8 code by one step (1/127 of a row's absmax), which moves a logit
by up to about 1e-3 here; codes and scales themselves are compared
exactly where the inputs are identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models import model as JM
from quip_tpu.models import paged as JP
from quip_tpu.serve import engine as JE
from quip_tpu_torch import convert as TC
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.models import paged as TP
from quip_tpu_torch.serve import engine as TE
from tests.test_torch_model import _both


@pytest.fixture(scope="module")
def gqa():
    return _both(kv_heads=2, seed=3)


def _tol(quantized):
    return dict(rtol=2e-3, atol=2e-3) if quantized else dict(rtol=1e-4,
                                                             atol=1e-4)


@pytest.mark.parametrize("shape,scale", [((3, 5, 2, 16), 1.0),
                                         ((2, 7, 8), 30.0), ((4, 16), 0.0)])
def test_quantize_kv_bit_for_bit(shape, scale):
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    x[0, ..., 0] = x[0].max()          # an exact absmax element: code 127
    jq, js = JM.quantize_kv(jnp.asarray(x))
    tq, ts = TM.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # bf16 input (the serving dtype) quantises from its f32 value
    xb = torch.from_numpy(x).bfloat16()
    tq2, _ = TM.quantize_kv(xb)
    jq2, _ = JM.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_matches(gqa, quantized):
    """Non-paged decode_step over the stacked KVCache, 6 teacher-forced
    tokens, batch 2; the JAX caches converted midway continue the chain."""
    jcfg, jparams, tcfg, tparams = gqa
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (6, 2))
    jc = JM.init_caches(2, 16, jcfg, jnp.float32, quantized=quantized)
    tc = TM.init_caches(2, 16, tcfg, torch.float32, quantized=quantized,
                        device="cpu")
    assert (tc.ks is not None) == quantized
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for i, t in enumerate(toks):
        jl, jc = jstep(jparams, jnp.asarray(t, jnp.int32)[:, None], jc)
        if i == 3:                       # carry the reference's cache over
            tc = TC.kvcache_from_numpy(jax.tree.map(np.asarray, jc_prev),
                                       device="cpu")
        tl, tc = TM.decode_step(tparams, torch.from_numpy(t)[:, None], tc,
                                tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **_tol(quantized))
        jc_prev = jc
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [6, 6]
    if quantized:
        assert tc.k.dtype == torch.int8
        # at most one code step apart where the floats differed by an ulp
        dk = np.abs(tc.k.numpy().astype(int) - np.asarray(jc.k).astype(int))
        assert dk.max() <= 1 and (dk > 0).mean() < 1e-2


def _jax_chain(params, cfg, prompt, steps, *, quantized, prefix, hot, page):
    caches = JP.init_paged(2, 48, cfg, dtype=jnp.float32, hot=hot, page=page,
                           quantized=quantized)
    out = []
    lg, caches = JP.paged_prefill_slot(
        params, jnp.asarray(prompt, jnp.int32)[None],
        jnp.asarray(len(prompt)), caches, jnp.asarray(1), cfg)
    out.append(np.asarray(lg))
    on = jnp.asarray([1, 0], jnp.int32) if prefix is not None else None
    misc, layers = JP.split_blocks(params)
    step = jax.jit(lambda m, l, t, c: JP.paged_append_step_unrolled(
        m, l, t, c, cfg, page=page, prefix=prefix, prefix_on=on))
    flush = jax.jit(JP.flush_hot)
    for t in steps:
        if int(np.max(np.asarray(caches.hot_len))) + t.shape[1] > hot:
            caches = flush(caches)
        lg, hot_s = step(misc, layers, jnp.asarray(t, jnp.int32), caches)
        caches = JP.advance(caches, hot_s)
        out.append(np.asarray(lg))
    return out, caches


def _port_chain(params, cfg, prompt, steps, *, quantized, prefix, hot, page,
                start=None):
    caches = start if start is not None else TP.init_paged(
        2, 48, cfg, dtype=torch.float32, hot=hot, page=page,
        quantized=quantized, device="cpu")
    out = []
    if start is None:
        lg, caches = TP.paged_prefill_slot(
            params, torch.as_tensor(prompt)[None], len(prompt), caches, 1,
            cfg)
        out.append(lg.numpy())
    on = torch.tensor([1, 0]) if prefix is not None else None
    for t in steps:
        if int(caches.hot_len.max()) + t.shape[1] > hot:
            caches = TP.flush_hot(caches)
        lg, hot_s = TP.paged_append_step(params, torch.as_tensor(t), caches,
                                         cfg, page=page, prefix=prefix,
                                         prefix_on=on)
        caches = TP.advance(caches, hot_s)
        out.append(lg.numpy())
    return out, caches


@pytest.mark.parametrize("quantized,with_prefix", [(True, False),
                                                   (False, True),
                                                   (True, True)])
def test_paged_int8_and_prefix_match(gqa, quantized, with_prefix):
    """Slot 1 prefilled (11 tokens, no prefix); then teacher-forced append
    windows of 4, 1, 1, 2, 1 ... tokens for both slots across two flushes
    (hot = 8). With a prefix, slot 0 opts in (its window attends the 5
    prefix rows and sits at positions 5..) and slot 1 opts out."""
    jcfg, jparams, tcfg, tparams = gqa
    rng = np.random.default_rng(7)
    V = jcfg.vocab_size
    prompt = rng.integers(0, V, 11)
    steps = [rng.integers(0, V, (2, s)) for s in (4, 1, 1, 2, 1, 1, 4, 1, 1)]
    jpre = tpre = None
    if with_prefix:
        ptoks = rng.integers(0, V, 5)
        jlg, jpre = JP.build_prefix(jparams, ptoks, jcfg, quantized=quantized)
        tlg, tpre = TP.build_prefix(tparams, ptoks, tcfg, quantized=quantized)
        assert tpre.length == jpre.length == 5
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                                   atol=1e-4)
        if quantized:
            dk = np.abs(tpre.k.numpy().astype(int)
                        - np.asarray(jpre.k).astype(int))
            assert dk.max() <= 1 and (dk > 0).mean() < 1e-2
            np.testing.assert_allclose(tpre.ks.numpy(), np.asarray(jpre.ks),
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(tpre.k.numpy(), np.asarray(jpre.k),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(tpre.v.numpy(), np.asarray(jpre.v),
                                       rtol=1e-4, atol=1e-5)
        # the reference's prefix, converted, serves the port's steps
        tpre = TC.prefix_from_numpy(jax.tree.map(np.asarray, jpre),
                                    device="cpu")
    kw = dict(quantized=quantized, hot=8, page=8)
    want, jcaches = _jax_chain(jparams, jcfg, prompt, steps, prefix=jpre,
                               **kw)
    got, tcaches = _port_chain(tparams, tcfg, prompt, steps, prefix=tpre,
                               **kw)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **_tol(quantized))
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    assert tcaches.base.tolist() == np.asarray(jcaches.base).tolist()
    assert tcaches.hot_len.tolist() == np.asarray(jcaches.hot_len).tolist()
    # the reference's cache, converted, continues the port's chain
    conv = TC.paged_from_numpy(jax.tree.map(np.asarray, jcaches),
                               device="cpu")
    assert conv.quantized == quantized
    more = [rng.integers(0, V, (2, 1)) for _ in range(2)]
    want2, _ = _jax_chain_continue(jparams, jcfg, jcaches, more, jpre, 8)
    got2, _ = _port_chain(tparams, tcfg, None, more, prefix=tpre, start=conv,
                          **kw)
    for g, w in zip(got2, want2):
        np.testing.assert_allclose(g, w, **_tol(quantized))


def _jax_chain_continue(params, cfg, caches, steps, prefix, page):
    on = jnp.asarray([1, 0], jnp.int32) if prefix is not None else None
    out = []
    for t in steps:
        if int(np.max(np.asarray(caches.hot_len))) + t.shape[1] > \
                caches.hot_size:
            caches = JP.flush_hot(caches)
        lg, hot_s = JP.paged_append_step(params, jnp.asarray(t, jnp.int32),
                                         caches, cfg, page=page,
                                         prefix=prefix, prefix_on=on)
        caches = JP.advance(caches, hot_s)
        out.append(np.asarray(lg))
    return out, caches


_PRE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_prefix_tokens_equal(gqa, kv_quant):
    """Greedy tokens equal the JAX engine's serial step loop: mixed
    use_prefix on / off, a prompt longer than the hot ring (chunked
    admission across a flush), three requests through two slots (slot reuse
    resets the flag)."""
    jcfg, jparams, tcfg, tparams = gqa
    reqs = [dict(prompt=[7, 2, 9, 1, 8, 8, 1, 2, 3, 4, 5], max_new_tokens=8),
            dict(prompt=[8, 8, 8], max_new_tokens=8, use_prefix=False),
            dict(prompt=[7, 2], max_new_tokens=6),
            dict(prompt=[1], max_new_tokens=6, use_prefix=False),
            dict(prompt=[5, 5, 5], max_new_tokens=12)]
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8, kv_quant=kv_quant)
    je = JE.Engine(jparams, jcfg, paged=True, shared_prefix=_PRE, **kw)
    want = [r.generated for r in je.run(reqs)]
    te = TE.Engine(tparams, tcfg, shared_prefix=_PRE, device="cpu", **kw)
    got = [r.generated for r in te.run(reqs)]
    assert [len(g) for g in got] == [9, 9, 7, 7, 13]
    assert got == want
    assert te._prefix_on.tolist() == [0, 0]        # retired slots opt out
    assert te.pkv.quantized == kv_quant
    # a prefix request equals the plain engine on prefix + prompt
    plain = TE.Engine(tparams, tcfg, device="cpu", **kw)
    [r] = plain.run([dict(prompt=_PRE + [7, 2], max_new_tokens=6)])
    assert r.generated == got[2]


@pytest.mark.parametrize("plen", [8, 16])
def test_engine_prefix_prompt_filling_the_ring(gqa, plen):
    """A prefix prompt whose last window fills the hot ring exactly (plen a
    multiple of hot = 8): the port flushes before the first decode step.
    quip_tpu's _admit_with_prefix does not (its next step writes past the
    ring and its tokens go wrong), so the oracle is quip_tpu's engine
    WITHOUT a prefix on prefix + prompt, which test_serve.py holds equal
    to the prefix engine for prompts that do not end on a ring boundary."""
    jcfg, jparams, tcfg, tparams = gqa
    prompt = list(range(1, plen + 1))
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8)
    je = JE.Engine(jparams, jcfg, paged=True, **kw)
    [want] = je.run([dict(prompt=_PRE + prompt, max_new_tokens=6)])
    te = TE.Engine(tparams, tcfg, shared_prefix=_PRE, device="cpu", **kw)
    [got] = te.run([dict(prompt=prompt, max_new_tokens=6)])
    assert got.generated == want.generated


def test_engine_prefix_validation(gqa):
    _, _, tcfg, tparams = gqa
    eng = TE.Engine(tparams, tcfg, max_batch=1, max_seq=32, hot=8, page=8,
                    device="cpu")
    with pytest.raises(ValueError, match="use_prefix"):
        eng.submit([1, 2], use_prefix=True)
    assert eng.prefix is None and eng._prefix_args() == {}
