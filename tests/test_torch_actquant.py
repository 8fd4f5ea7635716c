"""Port parity for activation quantization (ActQuant): the stateless
fake-quant, the activation grid finder, add_actquant + calibrate_actquant
on a packed llama-tiny, the wrapped model's logits, and the engine's
greedy tokens through the wrappers, each against quip_tpu on the same
numpy inputs (float64 where the function is stateless: 1e-12; the f32
llama-tiny: calibrated scales within 1e-5 relative, logits within 1e-4 of
quip_tpu's with its grids handed across). The engine's tokens equal the
serial forward's greedy tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.core import grid as JGr
from quip_tpu.models import model as JM
from quip_tpu.ops import actquant as JA
from quip_tpu_torch.core import grid as TGr
from quip_tpu_torch.ops import actquant as TA
from quip_tpu_torch.pack.format import PackedLinear
from quip_tpu_torch.serve import engine as TE
from tests.test_torch_model import _llama_via_checkpoint


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("per_token,sym", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_quantize_activations_matches(per_token, sym):
    x = np.random.default_rng(0).standard_normal((3, 5, 16)) * 3
    want = JA.quantize_activations(jnp.asarray(x), 4, per_token, sym)
    got = TA.quantize_activations(t(x), 4, per_token, sym)
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 10), (2, 3, 4, 5), (7,)])
@pytest.mark.parametrize("perchannel,sym", [(True, False), (True, True),
                                            (False, False)])
def test_find_params_qfna_act_matches(shape, perchannel, sym):
    x = np.random.default_rng(len(shape)).standard_normal(shape)
    want = JGr.find_params_qfna_act(jnp.asarray(x), 4, perchannel, sym)
    got = TGr.find_params_qfna_act(t(x), 4, perchannel, sym)
    assert got.scale.shape == want.scale.shape
    _close(got.scale.numpy(), want.scale, 1e-12)
    _close(got.zero.numpy(), want.zero, 1e-12)
    assert got.maxq == float(want.maxq)


_MODEL = {}


def _wrapped():
    """A packed llama-tiny in both packages, 8-bit wrappers added and
    calibrated on the same tokens by each package."""
    if not _MODEL:
        jcfg, jparams, tcfg, tparams = _llama_via_checkpoint(seed=5)
        tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                                   (2, 12))
        jw = JA.calibrate_actquant(JA.add_actquant(jparams, jcfg, 8), jcfg,
                                   jnp.asarray(tokens, jnp.int32))
        tw = TA.calibrate_actquant(TA.add_actquant(tparams, tcfg, 8), tcfg,
                                   torch.from_numpy(tokens))
        _MODEL.update(jcfg=jcfg, tcfg=tcfg, jw=jw, tw=tw, tparams=tparams)
    return _MODEL


def _pairs(m):
    """(port wrapper, quip_tpu wrapper's per-layer scale, zero) a linear."""
    out = []
    for li, b in enumerate(m["tw"].blocks):
        for grp, names in (("attn", ("wqkv", "wo")), ("mlp", ("wgu", "wd"))):
            for nm in names:
                jaq = m["jw"]["blocks"][grp][nm]
                out.append((getattr(getattr(b, grp), nm),
                            np.asarray(jaq.scale[li]),
                            np.asarray(jaq.zero[li])))
    jh = m["jw"]["lm_head"]
    out.append((m["tw"].lm_head, np.asarray(jh.scale), np.asarray(jh.zero)))
    return out


def test_add_and_calibrate_actquant_match():
    m = _wrapped()
    pairs = _pairs(m)
    assert len(pairs) == 2 * 4 + 1
    for aq, js, jz in pairs:
        assert isinstance(aq, TA.ActQuant)
        assert isinstance(aq.inner, PackedLinear) and aq.maxq == 255.0
        _close(aq.scale.numpy(), js, 1e-5)
        assert (aq.zero.numpy() == jz).mean() >= 0.99
    # an uncalibrated wrapper is the identity
    raw = TA.wrap_actquant(m["tparams"].blocks[0].mlp.wd)
    x = torch.randn(3, raw.inner.in_features)
    assert torch.equal(raw.quantize(x), x)


def test_wrapped_logits_match():
    m = _wrapped()
    tw = m["tw"]
    for aq, js, jz in _pairs(m):      # quip_tpu's grids handed across
        aq.scale.copy_(t(js))
        aq.zero.copy_(t(jz))
    tokens = np.random.default_rng(4).integers(0, m["tcfg"].vocab_size,
                                               (2, 9))
    want = np.asarray(JM.forward(m["jw"], jnp.asarray(tokens, jnp.int32),
                                 m["jcfg"]))
    got = tw(torch.from_numpy(tokens)).numpy()
    _close(got, want, 1e-4)
    # the wrappers do act: unwrapped logits differ
    plain = m["tparams"](torch.from_numpy(tokens)).numpy()
    assert np.abs(plain - got).max() > 1e-4


def test_engine_tokens_with_wrappers():
    m = _wrapped()
    tw, cfg = m["tw"], m["tcfg"]
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                 max_new_tokens=5) for n in (7, 3)]
    eng = TE.Engine(tw, cfg, max_batch=2, max_seq=32, device="cpu")
    got = [r.generated for r in eng.run([dict(r) for r in reqs])]
    for req, gen in zip(reqs, got):
        toks = list(req["prompt"])
        assert len(gen) >= req["max_new_tokens"]
        for _ in range(len(gen)):
            with torch.no_grad():
                toks.append(int(tw(torch.tensor([toks]))[0, -1].argmax()))
        assert gen == toks[len(req["prompt"]):]
