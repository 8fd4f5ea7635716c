"""Port parity for the 3-in-4 widening (``pack/format.py::widen_3bit`` and
``widen_3bit_tree``) against quip_tpu's, on a 3-bit packed llama-tiny.

The widened planes must equal quip_tpu's bit for bit; a widened model must
give the two-plane model's logits exactly (the same codes on the same grid,
dequantised to the same f32 weights by the plain path); greedy tokens of
the arena Engine, which widens at load, must equal quip_tpu's Engine's."""
import numpy as np
import pytest
import torch

from quip_tpu.pack import format as JF
from quip_tpu.serve import engine as JE
from quip_tpu_torch.pack import format as TF
from quip_tpu_torch.pack.format import PackedLinear
from quip_tpu_torch.serve import engine as TE
from quip_tpu_torch.serve.speculative import make_self_draft
from tests.test_torch_model import _llama_via_checkpoint


@pytest.fixture(scope="module")
def tiny3():
    """A 3-bit llama-tiny (packed head too) in both packages."""
    return _llama_via_checkpoint(bits=3, seed=4)


def _linears(model):
    for b in model.blocks:
        for grp in (b.attn, b.mlp):
            for name, mod in grp.named_children():
                if isinstance(mod, PackedLinear):
                    yield mod
    if isinstance(model.lm_head, PackedLinear):
        yield model.lm_head


def test_widen_planes_equal_quip_tpu(tiny3, monkeypatch):
    """Every widened plane of the tree equals quip_tpu's widened plane of
    the same layer, word for word; bits 4, code_bits 3, the rest shared."""
    monkeypatch.delenv("QUIP_NO_WIDEN3", raising=False)
    jcfg, jparams, tcfg, tparams = tiny3
    jw = JF.widen_3bit_tree(jparams)
    tw = TF.widen_3bit_tree(tparams)
    assert tw is not tparams
    for l, b in enumerate(tw.blocks):
        for grp, name in (("attn", "wqkv"), ("attn", "wo"), ("mlp", "wgu"),
                          ("mlp", "wd")):
            got = getattr(getattr(b, grp), name)
            want = jw["blocks"][grp][name]
            old = getattr(getattr(tparams.blocks[l], grp), name)
            assert (got.bits, got.code_bits, got.nplanes) == (4, 3, 1)
            assert (want.bits, want.code_bits) == (4, 3)
            np.testing.assert_array_equal(got.plane0.numpy(),
                                          np.asarray(want.planes[0][l]))
            assert old.bits == 3 and old.nplanes == 2   # the source stays
            assert got.u_left is old.u_left and got.vin is old.vin
            assert got.scale_b is old.scale_b
        assert b.ln1 is tparams.blocks[l].ln1
    np.testing.assert_array_equal(tw.lm_head.plane0.numpy(),
                                  np.asarray(jw["lm_head"].planes[0]))
    assert tw.embed is tparams.embed


def test_widen_3bit_single_linear(tiny3):
    """One linear: the codes are unchanged (unpacked through both
    layouts), and the plain dequantised weight is the same."""
    _, _, _, tparams = tiny3
    q = tparams.blocks[0].attn.wo
    w = TF.widen_3bit(q)
    d = q.in_features
    assert torch.equal(TF.unpack_codes(w.planes, 4, d),
                       TF.unpack_codes(q.planes, 3, d))
    assert w.maxq == q.maxq == 7.0
    assert torch.equal(w.dequantize(), q.dequantize())
    assert TF.widen_3bit(w) is w                 # other widths unchanged


def test_widened_model_same_logits(tiny3):
    _, _, tcfg, tparams = tiny3
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 9)))
    want = tparams(toks)
    got = TF.widen_3bit_tree(tparams)(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_no_widen3_read_at_call_time(tiny3, monkeypatch):
    """QUIP_NO_WIDEN3=1 keeps the two planes; read at each call, as
    quip_tpu reads it; a tree with no 3-bit linear comes back as it is."""
    _, _, tcfg, tparams = tiny3
    monkeypatch.setenv("QUIP_NO_WIDEN3", "1")
    assert TF.widen_3bit_tree(tparams) is tparams
    monkeypatch.setenv("QUIP_NO_WIDEN3", "0")
    wide = TF.widen_3bit_tree(tparams)
    assert all(q.bits == 4 for q in _linears(wide))
    assert TF.widen_3bit_tree(wide) is wide
    monkeypatch.setenv("QUIP_NO_WIDEN3", "1")
    eng = TE.Engine(tparams, tcfg, max_batch=1, max_seq=16, device="cpu")
    assert all(q.bits == 3 for q in _linears(eng.params))


_JAX_TOKENS = {}


@pytest.mark.parametrize("no_widen", ["0", "1"])
def test_engine_widens_at_load(tiny3, monkeypatch, no_widen):
    """The arena Engine widens at load (or keeps the two planes under
    QUIP_NO_WIDEN3=1) and its greedy tokens equal quip_tpu's arena
    Engine's, which widens at load (the widening leaves every dequantised
    weight as it was, so both layouts give those tokens); a self-draft's
    shared blocks are widened once, the draft keeping the target's widened
    modules."""
    jcfg, jparams, tcfg, tparams = tiny3
    rng = np.random.default_rng(2)
    reqs = [dict(prompt=rng.integers(1, jcfg.vocab_size, n).tolist(),
                 max_new_tokens=m) for n, m in ((5, 9), (8, 6), (3, 11))]
    if not _JAX_TOKENS:
        monkeypatch.delenv("QUIP_NO_WIDEN3", raising=False)
        _JAX_TOKENS["want"] = [r.generated for r in JE.Engine(
            jparams, jcfg, max_batch=2, max_seq=32).run(
                [dict(r) for r in reqs])]
    want = _JAX_TOKENS["want"]
    monkeypatch.setenv("QUIP_NO_WIDEN3", no_widen)
    eng = TE.Engine(tparams, tcfg, max_batch=2, max_seq=32, device="cpu")
    bits = 3 if no_widen == "1" else 4
    assert all(q.bits == bits for q in _linears(eng.params))
    assert [r.generated for r in eng.run(reqs)] == want
    spec = TE.Engine(tparams, tcfg, max_batch=2, max_seq=32, hot=8, page=8,
                     draft=make_self_draft(tparams, tcfg, 1), spec_k=2,
                     device="cpu")
    assert spec.draft_params.blocks[0] is spec.params.blocks[0]
    assert all(q.bits == bits for q in _linears(spec.draft_params))
    assert [r.generated for r in spec.run(reqs)] == want
