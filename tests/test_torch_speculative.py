"""Port parity for speculative decoding (serve/speculative.py) on
llama-tiny, 2-bit packed, carried over from quip_tpu by params_from_numpy,
all f32 on the CPU; the cases of tests/test_speculative.py.

Greedy tokens and acceptance counts must equal quip_tpu's bit for bit.
``spec_dist`` matches quip_tpu's within 1e-6 (both f32 softmaxes).
``spec_accept_core`` given quip_tpu's own uniforms accepts the same count
bit for bit, and its residual distribution matches quip_tpu's formula
within 1e-6. The sampled draws come from a torch generator, so the law is
checked instead: the first emitted token's by Monte Carlo."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models import model as JM
from quip_tpu.models import paged as JP
from quip_tpu.serve import speculative as JS
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.models import paged as TP
from quip_tpu_torch.serve import speculative as SP
from quip_tpu_torch.serve.engine import Engine
from tests.test_torch_model import _both, _jax_packed_llama

DIST_TOL = 1e-6


@pytest.fixture(scope="module")
def tiny():
    """Target (seed 0) and an unrelated draft (seed 1) in both packages."""
    jcfg, jparams, tcfg, tparams = _both(seed=0)
    jdraft = _jax_packed_llama(jcfg, seed=1)
    tdraft = params_from_numpy(jax.tree.map(np.asarray, jdraft), tcfg,
                               device="cpu")
    return jcfg, jparams, jdraft, tcfg, tparams, tdraft


def _plain_greedy(tparams, tcfg, prompt, n):
    """The port's non-spec greedy tokens (held to quip_tpu's by
    tests/test_torch_engine.py)."""
    eng = Engine(tparams, tcfg, max_batch=1, max_seq=64, hot=8, page=8,
                 paged=True, device="cpu")
    [r] = eng.run([dict(prompt=list(prompt), max_new_tokens=n)])
    return r.generated


def test_spec_dist_matches_quip_tpu():
    """Mixed temperatures, per-slot top-k (0 = all) and top-p, two greedy
    rows; and the greedy-only form."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 40)) * 3).astype(np.float32)
    temps = np.array([0.7, 1.3, 0.0, 0.9, 2.0, -1.0], np.float32)
    tks = np.array([3, 0, 5, 40, 1, 2], np.int32)
    tps = np.array([0.8, 1.0, 0.5, 0.3, 1.0, 0.9], np.float32)
    want = np.asarray(JS.spec_dist(jnp.asarray(logits), jnp.asarray(temps),
                                   jnp.asarray(tks), jnp.asarray(tps)))
    got = SP.spec_dist(torch.from_numpy(logits), torch.from_numpy(temps),
                       torch.from_numpy(tks), torch.from_numpy(tps)).numpy()
    np.testing.assert_allclose(got, want, atol=DIST_TOL, rtol=0)
    for kw in (dict(), dict(top_ks=tks), dict(top_ps=tps)):
        w = np.asarray(JS.spec_dist(
            jnp.asarray(logits), jnp.asarray(temps),
            **{k: jnp.asarray(v) for k, v in kw.items()}))
        g = SP.spec_dist(torch.from_numpy(logits), torch.from_numpy(temps),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(g.numpy(), w, atol=DIST_TOL, rtol=0)
    g = SP.spec_dist(torch.from_numpy(logits), torch.zeros(6))
    assert (g.argmax(-1) == torch.from_numpy(logits).argmax(-1)).all()
    assert torch.equal(g.max(-1).values, torch.ones(6))


def _residual_ref(n, q, p, K):
    """quip_tpu's correction distribution (speculative.py:251-258), in
    numpy: norm(max(p_n - q_n, 0)), p_{K-1} when all were accepted, p_n
    where the residual is empty."""
    rows = np.arange(len(n))
    p_n, q_n = p[rows, n], q[rows, n]
    res = np.where((n == K - 1)[:, None], p_n, np.maximum(p_n - q_n, 0.0))
    tot = res.sum(-1, keepdims=True)
    return np.where(tot > 0, res / np.maximum(tot, 1e-30), p_n)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_spec_accept_core_matches_quip_tpu(K):
    """The same drafts, q and p, and quip_tpu's own uniforms (its key's
    first half, as spec_accept splits it): the accept count bit for bit,
    the residual within 1e-6."""
    B, V = 64, 12
    rng = np.random.default_rng(K)

    def dists():
        x = rng.standard_normal((B, K, V)) * 2
        x[rng.random((B, K, V)) < 0.3] = -np.inf   # zero-probability tokens
        x[..., 0] = np.maximum(x[..., 0], 0.0)
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    q, p = dists(), dists()
    p[:8] = q[:8]                                   # p == q: empty residual
    q64 = q.astype(np.float64)
    drafts = np.stack([[rng.choice(V, p=q64[b, j] / q64[b, j].sum())
                        for j in range(K)] for b in range(B)]).astype(np.int32)
    key = jax.random.key(7)
    _, n_emit = JS.spec_accept(key, jnp.asarray(drafts), jnp.asarray(q),
                               jnp.asarray(p))
    u = np.array(jax.random.uniform(jax.random.split(key)[0], (B, K - 1)))
    n, res = SP.spec_accept_core(torch.from_numpy(drafts.astype(np.int64)),
                                 torch.from_numpy(q), torch.from_numpy(p),
                                 torch.from_numpy(u))
    assert n.tolist() == (np.asarray(n_emit) - 1).tolist()
    if K > 1:
        assert 0 < int(n.sum()) < B * (K - 1)       # both outcomes occur
    np.testing.assert_allclose(res.numpy(),
                               _residual_ref(n.numpy(), q, p, K),
                               atol=DIST_TOL, rtol=0)


def test_spec_accept_first_token_marginal():
    """The first emitted token's law is the target's p_0 whatever the draft
    q (Leviathan et al.), by Monte Carlo with the port's generator."""
    V, K, B = 6, 3, 60000
    g = torch.Generator().manual_seed(42)
    q = torch.softmax(torch.randn(K, V, generator=g) * 2.0, -1)
    p = torch.softmax(torch.randn(K, V, generator=g) * 2.0, -1)
    drafts = torch.stack([torch.multinomial(q[j], B, replacement=True,
                                            generator=g) for j in range(K)],
                         dim=1)
    emitted, n_emit = SP.spec_accept(g, drafts, q.expand(B, K, V),
                                     p.expand(B, K, V))
    emp = torch.bincount(emitted[:, 0], minlength=V).double() / B
    assert (emp - p[0].double()).abs().sum() < 0.02, (emp, p[0])
    assert (n_emit >= 1).all() and (n_emit <= K).all()


def test_spec_accept_onehot_is_prefix_match():
    """One-hot p and q reduce rejection sampling to greedy prefix match."""
    V, K = 8, 4
    oh = lambda rows: torch.nn.functional.one_hot(  # noqa: E731
        torch.tensor(rows), V).float()
    g = torch.Generator().manual_seed(0)
    p = oh([[2, 5, 1, 7]])
    emitted, n_emit = SP.spec_accept(g, torch.tensor([[2, 5, 0, 7]]),
                                     oh([[2, 5, 0, 7]]), p)
    assert int(n_emit[0]) == 3 and emitted[0, :3].tolist() == [2, 5, 1]
    emitted, n_emit = SP.spec_accept(g, torch.tensor([[2, 5, 1, 0]]),
                                     oh([[2, 5, 1, 0]]), p)
    assert int(n_emit[0]) == K and emitted[0].tolist() == [2, 5, 1, 7]


def test_make_self_draft_shares_storage(tiny):
    """The draft's leaves are the target's own tensors (data_ptr equal,
    through .to() too), and its logits equal quip_tpu's self-draft's."""
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    draft, dcfg = SP.make_self_draft(tparams, tcfg, 1)
    assert dcfg.n_layers == 1 and len(draft.blocks) == 1
    assert draft.blocks[0] is tparams.blocks[0]
    assert draft.lm_head is tparams.lm_head
    assert draft.embed is tparams.embed
    assert draft.final_ln is tparams.final_ln
    for mine, theirs in ((draft.embed.tokens, tparams.embed.tokens),
                         (draft.final_ln.scale, tparams.final_ln.scale)):
        assert mine.data_ptr() == theirs.data_ptr()
    assert draft.to("cpu").embed.tokens is tparams.embed.tokens
    with pytest.raises(ValueError):
        SP.make_self_draft(tparams, tcfg, tcfg.n_layers + 1)
    jd, jdcfg = JS.make_self_draft(jparams, jcfg, 1)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 9))
    want = np.asarray(JM.forward(jd, jnp.asarray(toks, jnp.int32), jdcfg))
    got = draft(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _prefilled(jcfg, jparams, jdraft, tcfg, tparams, tdraft, prompts, hot):
    """Both packages' (draft cache, target cache, first token) after a
    batched paged prefill of ``prompts`` (right-padded)."""
    B = len(prompts)
    plens = [len(p) for p in prompts]
    padded = np.zeros((B, max(plens)), np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    out = []
    for pkg in ("jax", "port"):
        caches = []
        for params, cfg in (((jdraft, jcfg), (jparams, jcfg)) if pkg == "jax"
                            else ((tdraft, tcfg), (tparams, tcfg))):
            if pkg == "jax":
                c = JP.init_paged(B, 64, cfg, dtype=jnp.float32, hot=hot,
                                  page=8)
                lg, c = JP.paged_prefill(
                    params, jnp.asarray(padded, jnp.int32),
                    jnp.asarray(plens, jnp.int32), c, cfg)
            else:
                c = TP.init_paged(B, 64, cfg, dtype=torch.float32, hot=hot,
                                  page=8, device="cpu")
                lg, c = TP.paged_prefill(params, torch.from_numpy(padded),
                                         plens, c, cfg)
            caches.append(c)
        out.append((caches[0], caches[1], np.asarray(lg)))
    (jdc, jtc, jlg), (tdc, ttc, tlg) = out
    np.testing.assert_allclose(tlg, jlg, rtol=1e-4, atol=1e-4)
    tok = jlg.argmax(-1)[:, None]
    return (jdc, jtc, jnp.asarray(tok, jnp.int32)), \
        (tdc, ttc, torch.from_numpy(tok.astype(np.int64)))


@pytest.mark.parametrize("draft", ["unrelated", "perfect"])
def test_spec_decode_step_and_chunk_match_quip_tpu(tiny, draft):
    """One spec_decode_step and one S = 3 spec_decode_chunk from the same
    prefilled caches (two slots): emitted tokens, counts and cursors equal
    quip_tpu's; the chunk equals three steps; a perfect draft accepts all
    K; an inactive slot stays frozen."""
    jcfg, jparams, jdraft, tcfg, tparams, tdraft = tiny
    if draft == "perfect":
        jdraft, tdraft = jparams, tparams
    K, S = 3, 3
    (jdc, jtc, jtok), (tdc, ttc, ttok) = _prefilled(
        jcfg, jparams, jdraft, tcfg, tparams, tdraft,
        [[5, 2, 9, 1], [7, 3]], hot=16)
    jem, jne, _, jth = JS.spec_decode_step(jdraft, jparams, jtok, jdc, jtc,
                                           jcfg, jcfg, K, page=8)
    tem, tne, _, tth = SP.spec_decode_step(tdraft, tparams, ttok, tdc, ttc,
                                           tcfg, tcfg, K, page=8)
    assert tne.tolist() == np.asarray(jne).tolist()
    assert tem.tolist() == np.asarray(jem).tolist()
    assert tth.length.tolist() == np.asarray(jth.length).tolist()
    if draft == "perfect":
        assert tne.tolist() == [K, K]

    jems, jnes, _, jth, jlast, _ = JS.spec_decode_chunk(
        jdraft, jparams, jtok, jdc, jtc, jcfg, jcfg, K, S, page=8)
    tems, tnes, _, tth, tlast = SP.spec_decode_chunk(
        tdraft, tparams, ttok, tdc, ttc, tcfg, tcfg, K, S, page=8)
    assert tnes.tolist() == np.asarray(jnes).tolist()
    assert tems.tolist() == np.asarray(jems).tolist()
    assert tth.length.tolist() == np.asarray(jth.length).tolist()
    assert tlast.tolist() == np.asarray(jlast).tolist()

    # the chunk equals S sequential steps (port alone)
    tok, dc, tc, stream = ttok, tdc, ttc, []
    for _ in range(S):
        em, ne, dh, th = SP.spec_decode_step(tdraft, tparams, tok, dc, tc,
                                             tcfg, tcfg, K, page=8)
        stream.append((em, ne))
        tok = torch.gather(em, 1, (ne - 1)[:, None])
        dc, tc = TP.advance(dc, dh), TP.advance(tc, th)
    assert torch.equal(tems, torch.stack([e for e, _ in stream], 1))
    assert torch.equal(tnes, torch.stack([n for _, n in stream], 1))

    # slot 1 inactive: its counts are 0, its cursor and frontier frozen
    ems, nes, _, th, last = SP.spec_decode_chunk(
        tdraft, tparams, ttok, tdc, ttc, tcfg, tcfg, K, S, page=8,
        active=torch.tensor([1, 0]))
    assert torch.equal(ems[0], tems[0]) and nes[1].tolist() == [0] * S
    assert th.length.tolist() == [int(tnes[0].sum()), 0]
    assert last[1].tolist() == ttok[1].tolist()


def test_spec_sample_step_greedy_equals_decode_step(tiny):
    """temps = 0 through the sampled step emits what the greedy step
    does, whatever the generator."""
    jcfg, jparams, jdraft, tcfg, tparams, tdraft = tiny
    _, (tdc, ttc, ttok) = _prefilled(jcfg, jparams, jdraft, tcfg, tparams,
                                     tdraft, [[5, 2, 9, 1]], hot=8)
    em_g, ne_g, _, th_g = SP.spec_decode_step(tdraft, tparams, ttok, tdc,
                                              ttc, tcfg, tcfg, 3, page=8)
    em_s, ne_s, _, th_s = SP.spec_sample_step(
        tdraft, tparams, ttok, tdc, ttc, tcfg, tcfg, 3,
        torch.Generator().manual_seed(7), torch.zeros(1), page=8)
    assert torch.equal(ne_g, ne_s) and torch.equal(em_g, em_s)
    assert torch.equal(th_g.length, th_s.length)


@pytest.mark.parametrize("draft", ["unrelated", "perfect"])
def test_spec_decoder_matches_quip_tpu(tiny, draft):
    """SpecDecoder.generate (batched prefill, step loop, flushes at hot =
    8) equals quip_tpu's SpecDecoder and the plain greedy tokens; a
    perfect draft accepts K every step."""
    jcfg, jparams, jdraft, tcfg, tparams, tdraft = tiny
    if draft == "perfect":
        jdraft, tdraft = jparams, tparams
    prompts = [[5, 2, 9, 1], [3, 7, 7]]
    kw = dict(K=4, max_seq=64, hot=8, page=8, batch=2)
    got, accept = SP.SpecDecoder(tdraft, tparams, tcfg, tcfg,
                                 cache_dtype=torch.float32, device="cpu",
                                 **kw).generate(prompts, max_new_tokens=20)
    for p, o in zip(prompts, got):
        assert o == _plain_greedy(tparams, tcfg, p, 20)
    if draft == "perfect":
        assert accept == 4.0
    else:
        want, jaccept = JS.SpecDecoder(
            jdraft, jparams, jcfg, jcfg, cache_dtype=jnp.float32,
            **kw).generate(prompts, max_new_tokens=20)
        assert got == want and accept == jaccept


def test_engine_spec_sampling(tiny):
    """A spec engine takes sampled requests through rejection sampling:
    the same seed gives the same tokens, in the serial loop and the pump,
    and a greedy slot in the same batch stays exact."""
    _, _, _, tcfg, tparams, tdraft = tiny
    reqs = [dict(prompt=[1, 2, 3], max_new_tokens=10, temperature=0.9,
                 top_p=0.9, top_k=50),
            dict(prompt=[7, 8], max_new_tokens=10)]
    want = _plain_greedy(tparams, tcfg, [7, 8], 10)
    for chunked in (False, True):
        def run(seed):
            eng = Engine(tparams, tcfg, max_batch=2, max_seq=64, hot=16,
                         page=8, draft=(tdraft, tcfg), spec_k=2, seed=seed,
                         paged=True, device="cpu")
            return [r.generated for r in eng.run([dict(r) for r in reqs],
                                                 chunked=chunked)]
        a, b, c = run(11), run(11), run(12)
        assert a == b and a[0] != c[0]
        assert a[1] == want and c[1] == want
        assert [len(x) for x in a] == [11, 11]
        assert all(0 <= t < tcfg.vocab_size for t in a[0])


def test_engine_spec_rejects_k_at_least_hot(tiny):
    _, _, _, tcfg, tparams, tdraft = tiny
    with pytest.raises(ValueError, match="spec_k"):
        Engine(tparams, tcfg, max_seq=64, hot=8, page=8,
               draft=(tdraft, tcfg), spec_k=8, paged=True, device="cpu")
