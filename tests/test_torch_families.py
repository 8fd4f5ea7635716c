"""Port parity for the OPT and BLOOM families against quip_tpu, all f32 on
the CPU.

Models are quip_tpu's ``init_params`` with every bias, norm shift and norm
scale redrawn nonzero in the numpy tree (zeros would hide a dropped add),
then carried over by ``params_from_numpy``. Variants: opt-tiny (pre-norm,
learned positions, ReLU), bloom-tiny (ALiBi, embedding LayerNorm, GELU)
and an OPT-350m-style opt-tiny (post-norm, project_in/out, no final norm).
Tolerances: logits within 1e-4 of max |logit| against quip_tpu (summation
order); the paged cache against the full forward as quip_tpu's own test
holds it (5e-4); int8 caches 2e-3 (one code step moves a logit by about
1e-3 here)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.models import paged as JP
from quip_tpu.serve import engine as JE
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.models import paged as TP
from quip_tpu_torch.serve import engine as TE
from quip_tpu_torch.serve.speculative import make_self_draft

_OPT350 = dict(do_layer_norm_before=False, embed_proj_dim=32)
VARIANTS = ["opt-tiny", "bloom-tiny", "opt-350m-style"]


def _cfgs(name, **over):
    base = "opt-tiny" if name == "opt-350m-style" else name
    over = {**(_OPT350 if name == "opt-350m-style" else {}), **over}
    return (dataclasses.replace(jget_config(base), **over),
            dataclasses.replace(get_config(base), **over))


def _nonzero(tree, rng):
    """Redraw biases, norm shifts and scales of a numpy param tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, np.ndarray) and (k.startswith("b")
                                              or k == "scale"):
                noise = rng.standard_normal(v.shape).astype(v.dtype) * 0.1
                v = noise + (1.0 if k == "scale" else 0.0)
            out[k] = _nonzero(v, rng)
        return out
    return tree


def _both(name, seed=0, fused=False, **over):
    jcfg, tcfg = _cfgs(name, **over)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed),
                                                   jcfg))
    tree = _nonzero(tree, np.random.default_rng(seed))
    if fused:
        tree = jax.tree.map(np.asarray, JM.fuse_params(tree, jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, params_from_numpy(tree, tcfg, device="cpu")


def _close(got, want, frac=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module", params=VARIANTS)
def fam(request):
    return request.param, _both(request.param, seed=VARIANTS.index(
        request.param))


@pytest.mark.parametrize("fused", [False, True])
def test_forward_and_decode_match(fam, fused):
    """forward (B=2, S=12) and 6 decode_steps over the stacked cache."""
    name, _ = fam
    jcfg, jparams, tcfg, tparams = _both(name, seed=1, fused=fused)
    b = tparams.blocks[0]
    assert b.ln1.bias is not None and float(b.ln1.bias.abs().max()) > 0
    assert (b.attn.bqkv if fused else b.attn.bq) is not None
    assert (tparams.final_ln is None) == (name == "opt-350m-style")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    _close(tparams(torch.from_numpy(toks)).numpy(),
           JM.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg))
    jc = JM.init_caches(2, 16, jcfg, jnp.float32)
    tc = TM.init_caches(2, 16, tcfg, torch.float32, device="cpu")
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for t in toks[:, :6].T:
        jl, jc = jstep(jparams, jnp.asarray(t, jnp.int32)[:, None], jc)
        tl, tc = TM.decode_step(tparams, torch.from_numpy(t)[:, None], tc,
                                tcfg)
        _close(tl.numpy(), jl)


def test_paged_append_mixed_windows(fam):
    """Teacher-forced append windows of mixed sizes through the paged
    cache (flushes, a page boundary) equal the full forward, and quip_tpu's
    paged steps on the same windows."""
    name, (jcfg, jparams, tcfg, tparams) = fam
    seq = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 21))
    want = np.asarray(JM.forward(jparams, jnp.asarray(seq, jnp.int32),
                                 jcfg))
    jc = JP.init_paged(2, 64, jcfg, dtype=jnp.float32, hot=8)
    tc = TP.init_paged(2, 64, tcfg, dtype=torch.float32, hot=8,
                       device="cpu")
    jstep = jax.jit(lambda p, t, c: JP.paged_append_step(p, t, c, jcfg,
                                                         page=8))
    got, i = [], 0
    for S in (3, 1, 4, 2, 5, 1, 3, 2):
        jl, jh = jstep(jparams, jnp.asarray(seq[:, i:i + S]), jc)
        tl, th = TP.paged_append_step(tparams, torch.from_numpy(
            seq[:, i:i + S]), tc, tcfg, page=8)
        _close(tl.numpy(), jl)
        jc, tc = JP.advance(jc, jh), TP.advance(tc, th)
        if int(tc.hot_len.max()) > 8 - 5:
            jc, tc = JP.flush_hot(jc), TP.flush_hot(tc)
        got.append(tl.numpy())
        i += S
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny", "bloom-tiny"])
def test_prefix_equals_inline(name):
    """A shared prefix + own rows equals one slot prefilled with prefix +
    prompt, for learned, RoPE and ALiBi positions; decode goes on across a
    flush with equal tokens. The prefix logits equal quip_tpu's."""
    jcfg, jparams, tcfg, tparams = _both(name, seed=4)
    p, q = [3, 1, 4, 1, 5], [9, 2, 6, 8]
    jlg, _ = JP.build_prefix(jparams, p, jcfg)
    tlg, prefix = TP.build_prefix(tparams, p, tcfg)
    _close(tlg.numpy(), jlg)
    on = torch.tensor([1])
    ca = TP.init_paged(1, 32, tcfg, dtype=torch.float32, hot=8, page=8,
                       device="cpu")
    la, hot = TP.paged_append_step(tparams, torch.tensor([q]), ca, tcfg,
                                   page=8, prefix=prefix, prefix_on=on)
    ca, la = TP.advance(ca, hot), la[:, -1]
    cb = TP.init_paged(1, 32, tcfg, dtype=torch.float32, hot=8, page=8,
                       device="cpu")
    lb, cb = TP.paged_prefill(tparams, torch.tensor([p + q]), [len(p + q)],
                              cb, tcfg)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=2e-4)
    for _ in range(6):
        ta, tb = la.argmax(-1)[:, None], lb.argmax(-1)[:, None]
        assert int(ta) == int(tb)
        la, hot = TP.paged_decode_step(tparams, ta, ca, tcfg, page=8,
                                       prefix=prefix, prefix_on=on)
        ca = TP.advance(ca, hot)
        lb, hot = TP.paged_decode_step(tparams, tb, cb, tcfg, page=8)
        cb = TP.advance(cb, hot)
        if int(ca.hot_len[0]) >= 7:
            ca, cb = TP.flush_hot(ca), TP.flush_hot(cb)
        np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=2e-4)


def test_int8_kv_codes(fam):
    """int8 paged caches over a prefilled prompt and 8 decode tokens:
    quip_tpu's float rows quantise to its codes and scales bit for bit
    through the port's ``quantize_kv``; the port's own codes differ from
    quip_tpu's by at most one step (rarely: the float rows differ by an
    ulp, e.g. in the LayerNorm), scales within 1e-5; logits within 2e-3."""
    name, (jcfg, jparams, tcfg, tparams) = fam
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, jcfg.vocab_size, 7)
    steps = rng.integers(0, jcfg.vocab_size, (8, 2))
    jc = JP.init_paged(2, 32, jcfg, dtype=jnp.float32, hot=8, page=8,
                       quantized=True)
    tc = TP.init_paged(2, 32, tcfg, dtype=torch.float32, hot=8, page=8,
                       quantized=True, device="cpu")
    jl, jc = JP.paged_prefill_slot(jparams, jnp.asarray(prompt)[None],
                                   jnp.asarray(7), jc, jnp.asarray(0), jcfg)
    tl, tc = TP.paged_prefill_slot(tparams, torch.from_numpy(prompt)[None],
                                   7, tc, 0, tcfg)
    _close(tl.numpy(), jl)
    jstep = jax.jit(lambda p, t, c: JP.paged_decode_step(p, t, c, jcfg,
                                                         page=8))
    for t in steps:
        jl, jh = jstep(jparams, jnp.asarray(t)[:, None], jc)
        tl, th = TP.paged_decode_step(tparams, torch.from_numpy(t)[:, None],
                                      tc, tcfg, page=8)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3)
        jc, tc = JP.advance(jc, jh), TP.advance(tc, th)
    # quip_tpu's float prompt rows quantise to its stored codes and scales
    _, jks, jvs = JP._prompt_kv(jparams, jnp.asarray(prompt)[None],
                                jnp.asarray([7]), jcfg)
    for rows, codes, scales in ((jks, jc.k, jc.ks), (jvs, jc.v, jc.vs)):
        q, sc = TM.quantize_kv(torch.tensor(np.asarray(rows)[:, 0]))
        np.testing.assert_array_equal(q.numpy(), np.asarray(codes[:, 0, :7]))
        np.testing.assert_array_equal(sc.numpy(),
                                      np.asarray(scales[:, 0, :7]))
    for mine, ref in ((tc.k, jc.k), (tc.v, jc.v), (tc.hot_k, jc.hot_k),
                      (tc.hot_v, jc.hot_v)):
        d = np.abs(mine.numpy().astype(int) - np.asarray(ref).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-2
    np.testing.assert_allclose(tc.ks.numpy(), np.asarray(jc.ks), rtol=1e-5)


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_greedy_equal(fam, chunked):
    """Greedy tokens of the serial step and of the pump equal quip_tpu's
    paged Engine's: 3 requests through 2 slots behind a shared prefix (the
    second opts out), a prompt longer than the hot ring, flushes."""
    name, (jcfg, jparams, tcfg, tparams) = fam
    rng = np.random.default_rng(5)
    V = jcfg.vocab_size
    reqs = [dict(prompt=rng.integers(0, V, n).tolist(), max_new_tokens=m)
            for n, m in ((5, 12), (11, 9), (3, 14))]
    reqs[1]["use_prefix"] = False
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8,
              shared_prefix=rng.integers(0, V, 6).tolist())
    want = JE.Engine(jparams, jcfg, paged=True, **kw).run(
        [dict(r) for r in reqs], chunked=chunked)
    got = TE.Engine(tparams, tcfg, paged=True, device="cpu", **kw).run(
        [dict(r) for r in reqs], chunked=chunked)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [len(r.generated) for r in got] == [13, 10, 15]


@pytest.mark.parametrize("n_heads", [12, 16, 32, 6])
def test_alibi_slopes(n_heads):
    want = np.asarray(JM.alibi_slopes(n_heads))
    got = TM.alibi_slopes(n_heads)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert TM.alibi_slopes(n_heads) is got          # made once, cached


def test_learned_positions_bound(fam):
    """A sequence past OPT's learned position table raises (quip_tpu's
    gather clamps to the last row); ALiBi has no table."""
    name, (jcfg, jparams, tcfg, tparams) = fam
    rows = jcfg.max_seq                           # 128 positions
    raises = pytest.raises(ValueError, match="learned position table")
    learned = tcfg.positions == "learned"
    with raises if learned else contextlib.nullcontext():
        TE.Engine(tparams, tcfg, max_batch=1, max_seq=rows + 1, hot=8,
                  page=8, paged=True, device="cpu")
    with raises if learned else contextlib.nullcontext():
        tparams(torch.zeros((1, rows + 1), dtype=torch.int64))
    TE.Engine(tparams, tcfg, max_batch=1, max_seq=rows, hot=8, page=8,
              paged=True, device="cpu")


def test_self_draft_spec_engine(fam):
    """A speculative engine with a 1-layer self-draft (the target's
    embedding, norms and tied head shared) emits the plain engine's greedy
    tokens, serially and through the spec pump."""
    name, (jcfg, jparams, tcfg, tparams) = fam
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, tcfg.vocab_size, n).tolist(),
                 max_new_tokens=10) for n in (4, 9)]
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8, paged=True,
              device="cpu")
    want = [r.generated for r in TE.Engine(tparams, tcfg, **kw).run(
        [dict(r) for r in reqs])]
    draft = make_self_draft(tparams, tcfg, 1)
    assert draft[0].embed is tparams.embed
    for chunked in (False, True):
        eng = TE.Engine(tparams, tcfg, draft=draft, spec_k=2, **kw)
        got = eng.run([dict(r) for r in reqs], chunked=chunked)
        assert [r.generated for r in got] == want
