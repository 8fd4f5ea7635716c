"""Port parity for the quantizer's core: grids, Hessian accumulation,
incoherence pre/post-processing, the LDLQ / OPTQ solvers and
quantize_layer, each held against its quip_tpu function on the same numpy
inputs at float64 (conftest turns on x64). Codes bit for bit; W_hat and
rotated matrices within 1e-9; losses within 1e-9 relative. Shapes include
d not a multiple of blocksize ((24, 40) at blocksize 16), so the padding
path runs. quip_tpu draws rotations from PRNG keys, the port from
generators: the JAX rotations are replayed into the port (``jax_rot``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.core import gptq as JG
from quip_tpu.core import grid as JGr
from quip_tpu.core import hessian as JH
from quip_tpu.core import incoherence as JI
from quip_tpu.core import ldlq as JL
from quip_tpu.quantize import pipeline as JP
from quip_tpu.quantize.config import PreprocConfig as JPC
from quip_tpu.quantize.config import QuantConfig as JQC
from quip_tpu_torch.core import gptq as TG
from quip_tpu_torch.core import grid as TGr
from quip_tpu_torch.core import hessian as TH
from quip_tpu_torch.core import incoherence as TI
from quip_tpu_torch.core import ldlq as TL
from quip_tpu_torch.quantize import pipeline as TP
from quip_tpu_torch.quantize.config import PreprocConfig as TPC
from quip_tpu_torch.quantize.config import QuantConfig as TQC
from tests.conftest import make_psd_hessian


def t(a):
    return torch.from_numpy(np.array(a))


def rht_to_torch(r):
    """A quip_tpu RHT (jax arrays) as the port's RHT."""
    return TI.RHT(None if r.signs is None else t(r.signs), t(r.left),
                  None if r.right is None else t(r.right), r.n)


def jax_rot(key, m, d, dtype=jnp.float64):
    """The (U, V) that quip_tpu's quantize_layer(W, H, cfg, key) draws:
    kproj, _ = split(key); ku, kv = split(kproj); gen_rht at W's dtype."""
    kproj, _ = jax.random.split(JI.raw_key(key))
    ku, kv = jax.random.split(kproj)
    return (rht_to_torch(JI.gen_rht(ku, m, dtype)),
            rht_to_torch(JI.gen_rht(kv, d, dtype)))


def t_cfg(jc: "JQC") -> TQC:
    """The port's QuantConfig equal to quip_tpu's ``jc``."""
    kw = {k: v for k, v in jc.__dict__.items() if k != "preproc"}
    return TQC(**kw, preproc=TPC(**jc.preproc.__dict__))


def _wh(seed, m, d):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, d)), make_psd_hessian(rng, d)


def _close(got, want, tol=1e-9):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perchannel,sym,mse", [
    (True, False, False), (True, True, False), (True, False, True),
    (False, False, False)])
def test_find_params_qfna_matches(perchannel, sym, mse):
    W, _ = _wh(1, 12, 40)
    W[3] = 0.0                                    # a degenerate row
    want = JGr.find_params_qfna(jnp.asarray(W), 3, perchannel, sym, mse)
    got = TGr.find_params_qfna(t(W), 3, perchannel, sym, mse)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(want.zero))
    assert got.maxq == float(want.maxq) and got.bits == 3


def test_grid_transforms_match():
    W, _ = _wh(2, 16, 32)
    g = JGr.find_params_qfna(jnp.asarray(W), 2)
    tg = TGr.GridParams(t(g.scale), t(g.zero), float(g.maxq))
    jw, s = jnp.asarray(W), JGr.qfnb_scale(jnp.asarray(W))
    pairs = [
        (TGr.quantize_qfna(t(W), tg.scale, tg.zero, 3.0),
         JGr.quantize_qfna(jw, g.scale, g.zero, g.maxq)),
        (TGr.quantize_qfnc(t(W), tg.scale, tg.zero, 3.0),
         JGr.quantize_qfnc(jw, g.scale, g.zero, g.maxq)),
        (TGr.qfnb_scale(t(W)), s),
        (TGr.quantize_qfnb(t(W), t(s), 3.0), JGr.quantize_qfnb(jw, s, 3.0)),
        (TGr.to_grid_qfna(t(W), tg), JGr.to_grid_qfna(jw, g)),
        (TGr.from_grid_qfna(t(W), tg), JGr.from_grid_qfna(jw, g)),
        (TGr.to_grid_qfnb(t(W), t(s), 3.0), JGr.to_grid_qfnb(jw, s, 3.0)),
        (TGr.from_grid_qfnb(t(W), t(s), 3.0),
         JGr.from_grid_qfnb(jw, s, 3.0)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Hessians, pre/post-processing
# ---------------------------------------------------------------------------


def test_hessian_accumulator_matches():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, 16, 24)).astype(np.float32)
          for _ in range(3)]
    ja, ta = JH.HessianAccumulator.init(24), TH.HessianAccumulator.init(24)
    for x in xs:
        ja, ta = ja.add_batch(jnp.asarray(x)), ta.add_batch(t(x))
    assert ta.nsamples == int(ja.nsamples) == 6
    # f32 sums in another order: 1e-6 of the largest entry
    _close(ta.finalize().numpy(), ja.finalize(), 1e-6)
    H = TH.accumulate_hessian(t(xs[0]), TH.accumulate_hessian(t(xs[1])))
    _close(H.numpy(), JH.accumulate_hessian(
        jnp.asarray(xs[0]), JH.accumulate_hessian(jnp.asarray(xs[1]))), 1e-6)


@pytest.mark.parametrize("mode", ["rht", "rht_sf", "rht_uf"])
@pytest.mark.parametrize("rescale", [True, False])
def test_preproc_postproc_match(mode, rescale):
    W, H = _wh(4, 24, 40)
    key = jax.random.key(7)
    H[:, 5] = H[5, :] = 0.0                       # a dead column
    jW, jH, jst = JH.preproc(jnp.asarray(W), jnp.asarray(H), rescale=rescale,
                             proj=True, proj_key=key, proj_mode=mode,
                             gptqH=True)
    ku, kv = jax.random.split(key)
    rot = (rht_to_torch(JI.gen_rht(ku, 24, jnp.float64)),
           rht_to_torch(JI.gen_rht(kv, 40, jnp.float64)))
    tW, tH, tst = TH.preproc(t(W), t(H), rescale=rescale, proj=True,
                             rot=rot, proj_mode=mode, gptqH=True)
    _close(tW.numpy(), jW)
    _close(tH.numpy(), jH)
    if rescale:
        _close(tst.scaleWH.numpy(), jst.scaleWH)
    jW2, jH2 = JH.postproc(jW, jH, jst)
    tW2, tH2 = TH.postproc(tW, tH, tst)
    _close(tW2.numpy(), jW2)
    _close(tH2.numpy(), jH2)
    assert TH.postproc(tW, None, tst)[1] is None


def test_materialize_rht_matches():
    for n in (64, 96):               # 96 = 32 x 3: a random right factor
        r = JI.gen_rht(jax.random.key(n), n, jnp.float64)
        _close(TI.materialize_rht(rht_to_torch(r), torch.float64).numpy(),
               JI.materialize_rht(r, jnp.float64))


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

SHAPES = [(24, 40, 16), (16, 64, 32)]   # (m, d, blocksize); 40 % 16 != 0


def _grid_w(W, bits):
    """W in qfn-b grid coordinates."""
    s = JGr.qfnb_scale(jnp.asarray(W))
    return np.asarray(JGr.to_grid_qfnb(jnp.asarray(W), s, 2 ** bits - 1))


@pytest.mark.parametrize("npasses", [0, 2])
@pytest.mark.parametrize("m,d,bs", SHAPES)
def test_round_ldl_matches(m, d, bs, npasses):
    W, H = _wh(6 + m, m, d)
    Wg = _grid_w(W, 2)
    want = JL.round_ldl(jnp.asarray(Wg), jnp.asarray(H), 2, npasses,
                        blocksize=bs)
    got = TL.round_ldl(t(Wg), t(H), 2, npasses, blocksize=bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dW = Wg - np.asarray(want)
    np.testing.assert_allclose(float(TL.hessian_loss(t(dW), t(H))),
                               float(JL.hessian_loss(jnp.asarray(dW),
                                                     jnp.asarray(H))),
                               rtol=1e-9)


@pytest.mark.parametrize("m,d,bs", SHAPES)
def test_round_ldl_gptqequiv_and_nearest_match(m, d, bs):
    W, H = _wh(8 + m, m, d)
    Wg = _grid_w(W, 3)
    want = JL.round_ldl_gptqequiv(jnp.asarray(Wg), jnp.asarray(H), 3,
                                  blocksize=bs)
    got = TL.round_ldl_gptqequiv(t(Wg), t(H), 3, blocksize=bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TL.round_nearest(t(Wg), 3).numpy(),
                                  np.asarray(JL.round_nearest(
                                      jnp.asarray(Wg), 3)))
    assert TL.check_nbits(got, 3) and JL.check_nbits(np.asarray(want), 3)
    assert TL.weight_entropy(got, 3) == JL.weight_entropy(want, 3)


def test_ldl_factor_and_cholesky_inv_match():
    _, H = _wh(9, 1, 24)
    _close(TL.ldl_factor(t(H)).numpy(), JL.ldl_factor(jnp.asarray(H)))
    _close(TG.cholesky_inv_upper(t(H)).numpy(),
           JG.cholesky_inv_upper(jnp.asarray(H)))


def test_cholesky_failure_raises():
    """jnp.linalg.cholesky returns NaNs on a singular H; the port raises."""
    H = np.ones((8, 8))
    for fn in (TL.ldl_factor, TG.cholesky_inv_upper):
        with pytest.raises(torch.linalg.LinAlgError, match="positive"):
            fn(t(H))


@pytest.mark.parametrize("qfn", ["a", "b", "c"])
@pytest.mark.parametrize("m,d,bs", SHAPES)
def test_gptq_round_matches(m, d, bs, qfn):
    W, H = _wh(10 + m, m, d)
    g = JGr.find_params_qfna(jnp.asarray(W), 2)
    want = JG.gptq_round(jnp.asarray(W), jnp.asarray(H), g, qfn, bs)
    tg = TGr.GridParams(t(g.scale), t(g.zero), float(g.maxq))
    got = TG.gptq_round(t(W), t(H), tg, qfn, bs)
    _close(got.numpy(), want)
    if qfn != "b":      # the codes the pipeline recovers from the grid
        np.testing.assert_array_equal(
            np.round(got.numpy() / np.asarray(g.scale) + np.asarray(g.zero)),
            np.round(np.asarray(want) / g.scale + g.zero))
    # grouped grids (every 8 columns re-derived from the live weights)
    want_g = JG.gptq_round(jnp.asarray(W), jnp.asarray(H), g, qfn, bs,
                           groupsize=8)
    _close(TG.gptq_round(t(W), t(H), tg, qfn, bs, groupsize=8).numpy(),
           want_g)


# ---------------------------------------------------------------------------
# quantize_layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("incoh", [True, False])
@pytest.mark.parametrize("qfn", ["a", "b", "c"])
@pytest.mark.parametrize("method", ["ldlq", "ldl_gptqequiv", "nearest",
                                    "gptq"])
def test_quantize_layer_matches(method, qfn, incoh):
    m, d = 24, 40
    W, H = _wh(11, m, d)
    if incoh:
        jc = JQC(wbits=2, method=method, qfn=qfn, blocksize=16,
                 preproc=JPC(rescale=True, proj=True, gptqH=True))
    else:
        jc = JQC(wbits=2, method=method, qfn=qfn, blocksize=16,
                 preproc=JPC(gptqH=True))
    key = jax.random.key(3)
    want = JP.quantize_layer(jnp.asarray(W), jnp.asarray(H), jc, key)
    got = TP.quantize_layer(t(W), t(H), t_cfg(jc),
                            rot=jax_rot(key, m, d) if incoh else None)
    if want.codes is None:
        assert got.codes is None                  # gptq + qfn-b
    else:
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
    _close(got.W_hat.numpy(), want.W_hat)
    np.testing.assert_allclose(float(got.error), float(want.error),
                               rtol=1e-9)
    np.testing.assert_allclose(float(got.Hmag), float(want.Hmag), rtol=1e-12)
    if got.codes is not None:    # the codes rebuild the result's W_hat
        _close(TP.dequantize_result(got, 2, torch.float64).numpy(),
               want.W_hat)


@pytest.mark.parametrize("mode", ["rht_sf", "rht_uf"])
def test_quantize_layer_sign_folded_modes_match(mode):
    m, d = 24, 40
    W, H = _wh(12, m, d)
    jc = JQC.incoherence(2, "ldlq", proj_mode=mode, blocksize=16)
    key = jax.random.key(5)
    want = JP.quantize_layer(jnp.asarray(W), jnp.asarray(H), jc, key)
    got = TP.quantize_layer(t(W), t(H), t_cfg(jc), rot=jax_rot(key, m, d))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    _close(got.W_hat.numpy(), want.W_hat)
