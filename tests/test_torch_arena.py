"""Port parity for the slot arena (quip_tpu's default, non-paged serving
cache): serve/arena.py and ``Engine(paged=False)`` against quip_tpu's
``Engine(paged=False)`` on each family, all f32 on the CPU.

Families: llama-tiny 2-bit packed (RoPE), opt-tiny (learned positions)
and bloom-tiny (ALiBi), the last two dense with nonzero biases. Greedy
tokens must be equal; logits and the K/V rows a step writes within 1e-4
of their max magnitude (summation order, as tests/test_torch_model.py
holds them), int8 codes within one step (a rounding tie), and every row a
step does not write bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models import model as JM
from quip_tpu.serve import engine as JE
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.models import paged as TP
from quip_tpu_torch.serve import arena as AR
from quip_tpu_torch.serve import engine as TE
from quip_tpu_torch.serve.speculative import make_self_draft
from tests import test_torch_families as FAM
from tests.test_torch_model import _llama_via_checkpoint

FAMILIES = ["llama-tiny", "opt-tiny", "bloom-tiny"]
_MODELS = {}


def _models(name):
    """(jcfg, jparams, tcfg, tparams) of a family, made once."""
    if name not in _MODELS:
        _MODELS[name] = (_llama_via_checkpoint(seed=2)
                         if name == "llama-tiny"
                         else FAM._both(name, seed=3))
    return _MODELS[name]


def _schedule(V, seed=7):
    """7 requests through 3 slots (queueing, retire, re-admission),
    prompts 1..8 tokens (quip_tpu's first prefill bucket: one compile),
    budgets 1..15."""
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(1, V, int(rng.integers(1, 9))).tolist(),
                 max_new_tokens=int(rng.integers(1, 16))) for _ in range(7)]


_JAX_TOKENS = {}


def _jax_tokens(name, int8):
    """quip_tpu's arena Engine on the schedule: its serial loop's greedy
    tokens (its own tests hold its chunked loop to them)."""
    key = (name, int8)
    if key not in _JAX_TOKENS:
        jcfg, jparams, _, _ = _models(name)
        eng = JE.Engine(jparams, jcfg, max_batch=3, max_seq=48,
                        cache_dtype=jnp.bfloat16, kv_quant=int8)
        assert not eng.paged
        _JAX_TOKENS[key] = [r.generated for r in eng.run(
            _schedule(jcfg.vocab_size))]
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("chunked", [False, True], ids=["serial", "chunked"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_arena_greedy_equal(name, int8, chunked):
    """Greedy tokens of the port's arena Engine (bf16 or int8 arena; the
    serial step or the chunked loop) equal quip_tpu's arena Engine's."""
    jcfg, _, tcfg, tparams = _models(name)
    eng = TE.Engine(tparams, tcfg, max_batch=3, max_seq=48,
                    cache_dtype=torch.bfloat16, kv_quant=int8, device="cpu")
    assert not eng.paged and not hasattr(eng, "pkv")
    got = [r.generated for r in eng.run(_schedule(jcfg.vocab_size),
                                        chunked=chunked)]
    assert got == _jax_tokens(name, int8)
    assert eng.stats()["completed"] == 7
    assert not eng._len.any()            # every slot retired and reset


def _filled_arena(cfg, B, L, int8, rng):
    """An arena of random rows (and scales), as numpy arrays."""
    shape = (cfg.n_layers, B, L, cfg.kv_heads, cfg.hd)
    if not int8:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)] + [None, None]
    return ([rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(2)]
            + [(rng.random(shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
               for _ in range(2)])


@pytest.mark.parametrize("name,B,int8", [
    ("llama-tiny", 1, False), ("llama-tiny", 1, True),
    ("llama-tiny", 3, False), ("llama-tiny", 3, True),
    ("opt-tiny", 3, False), ("bloom-tiny", 3, True)])
def test_slot_attention_step_matches(name, B, int8):
    """One arena step at per-slot lengths against quip_tpu's
    ``_slot_attention_step`` at B = 1 (its slice write) and B = 3 (its
    one-hot write), f32 and int8 arenas; each family's positions at B = 3:
    logits and the written rows within the tolerances above, every other
    row of the arena untouched."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(B + 2 * int8)
    L = 24
    arena = _filled_arena(jcfg, B, L, int8, rng)
    lengths = rng.integers(0, L, B).astype(np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 1))
    want, jarena = JE._slot_attention_step(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths),
        tuple(None if a is None else jnp.asarray(a) for a in arena))
    kv = AR.BatchedKV(*(None if a is None else torch.from_numpy(a.copy())
                        for a in arena))
    got = AR.slot_attention_step(tparams, tcfg, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths), kv)
    FAM._close(got.numpy(), want)
    new = np.zeros((B, L), bool)
    new[np.arange(B), lengths] = True
    for n, (mine, ref) in enumerate(zip(kv, jarena)):
        if ref is None:
            continue
        mine, ref = mine.numpy(), np.asarray(ref)
        # every other row untouched, bit for bit
        np.testing.assert_array_equal(mine[:, ~new], ref[:, ~new])
        if mine.dtype == np.int8:        # one code step at a rounding tie
            assert np.abs(mine[:, new].astype(int)
                          - ref[:, new].astype(int)).max() <= 1
        else:
            FAM._close(mine[:, new], ref[:, new])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_slot_attention_step_equals_decode_step(int8):
    """With every slot at the same length, an arena step is
    ``model.decode_step`` on a contiguous cache (the bench CLI's arena
    step): the same logits and rows."""
    _, _, tcfg, tparams = _models("llama-tiny")
    B, L = 2, 16
    caches = TM.init_caches(B, L, tcfg, torch.float32, quantized=int8,
                            device="cpu")
    kv = AR.init_arena(tcfg, B, L, torch.float32, quantize=int8,
                       device="cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (5, B))
    for n, t in enumerate(toks):
        t = torch.from_numpy(t)[:, None]
        want, caches = TM.decode_step(tparams, t, caches, tcfg)
        got = AR.slot_attention_step(tparams, tcfg, t,
                                     torch.full((B,), n), kv)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for mine, ref in ((kv.k, caches.k), (kv.v, caches.v),
                      (kv.ks, caches.ks), (kv.vs, caches.vs)):
        if ref is not None:
            assert torch.equal(mine, ref)


def test_arena_prefill_matches_forward():
    """An arena prefill (dense over max_seq keys, exact length) gives the
    full forward's last logits, and its rows are the forward's K/V."""
    _, _, tcfg, tparams = _models("bloom-tiny")
    kv = AR.init_arena(tcfg, 2, 32, torch.float32, device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(5).integers(0, tcfg.vocab_size, (1, 11)))
    got = AR.arena_prefill(tparams, prompt, kv, 1, tcfg)
    want = tparams(prompt)[0, -1]
    FAM._close(got.numpy(), want.numpy())
    _, ks, vs = TP._prompt_kv(tparams, prompt, torch.tensor([11]), tcfg)
    for l in range(tcfg.n_layers):
        FAM._close(kv.k[l, 1, :11].numpy(), ks[l][0].numpy())
        FAM._close(kv.v[l, 1, :11].numpy(), vs[l][0].numpy())
    assert not kv.k[:, 0].any() and not kv.k[:, 1, 11:].any()


def test_warmup_leaves_arena_engine_idle():
    """warmup walks the arena's chunk ladder (eager here), leaves the
    engine idle with its stats as they were, and the tokens after it equal
    a cold engine's."""
    jcfg, _, tcfg, tparams = _models("opt-tiny")
    kw = dict(max_batch=3, max_seq=48, device="cpu")
    eng = TE.Engine(tparams, tcfg, **kw).warmup()
    assert eng.stats()["completed"] == 0 and not eng._len.any()
    assert all(s is None for s in eng._slots)
    keys = [k for T in (2, 4, 8, 16) for k in (
        eng._arena_key(T, True, 0, False), eng._arena_key(T, False, 0, True))]
    assert len(set(keys)) == 8
    reqs = _schedule(jcfg.vocab_size, seed=9)
    got = [r.generated for r in eng.run([dict(r) for r in reqs],
                                        chunked=True)]
    cold = TE.Engine(tparams, tcfg, **kw)
    assert got == [r.generated for r in cold.run(reqs)]


@pytest.mark.parametrize("force", ["prefix", "draft"])
def test_forced_paged(force):
    """A shared prefix or a draft makes ``Engine(paged=False)`` paged, as
    in quip_tpu (engine.py:421-433): its tokens are those of the engine
    built with ``paged=True`` (held against quip_tpu's in
    tests/test_torch_kv_prefix.py and tests/test_torch_spec_pump.py); a
    self-draft engine's are also the arena engine's (greedy spec is
    exact)."""
    jcfg, _, tcfg, tparams = _models("llama-tiny")
    reqs = _schedule(jcfg.vocab_size, seed=11)[:4]
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8, device="cpu")
    if force == "prefix":
        pre = np.random.default_rng(11).integers(1, jcfg.vocab_size, 6)
        extra = dict(shared_prefix=pre.tolist())
    else:
        extra = dict(draft=make_self_draft(tparams, tcfg, 1), spec_k=2)
    eng = TE.Engine(tparams, tcfg, **extra, **kw)
    assert eng.paged and hasattr(eng, "pkv")
    got = [r.generated for r in eng.run([dict(r) for r in reqs])]
    want = [r.generated for r in TE.Engine(
        tparams, tcfg, paged=True, **extra, **kw).run(
            [dict(r) for r in reqs])]
    assert got == want
    if force == "draft":
        arena = TE.Engine(tparams, tcfg, **kw)
        assert got == [r.generated for r in arena.run(reqs)]


def test_arena_default_device():
    """The arena, like every entry point, defaults to the card."""
    _, _, tcfg, _ = _models("llama-tiny")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            AR.init_arena(tcfg, 1, 8)


def test_decode_scan_matches():
    """``decode_scan``'s greedy tokens equal quip_tpu's (its jitted scan)
    from the same cache, and the cache advances n_steps rows."""
    jcfg, jparams, tcfg, tparams = _models("opt-tiny")
    B, L, n = 2, 24, 9
    jc = JM.init_caches(B, L, jcfg, jnp.float32)
    tc = TM.init_caches(B, L, tcfg, torch.float32, device="cpu")
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, 1))
    want, jc = JM.decode_scan(jparams, jnp.asarray(tok, jnp.int32), jc,
                              jcfg, n)
    got, tc = TM.decode_scan(tparams, torch.from_numpy(tok), tc, tcfg, n)
    assert got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tc.length[0]) == n
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4,
                               atol=1e-5)


def test_arena_learned_positions_bound():
    """OPT's learned table bounds the arena's max_seq as it bounds the
    paged cache's."""
    _, _, tcfg, tparams = _models("opt-tiny")
    rows = tcfg.max_seq
    with pytest.raises(ValueError, match="learned position table"):
        TE.Engine(tparams, tcfg, max_batch=1, max_seq=rows + 1, device="cpu")
    TE.Engine(tparams, tcfg, max_batch=1, max_seq=rows, device="cpu")
