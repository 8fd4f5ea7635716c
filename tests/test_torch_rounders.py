"""Port parity for the rounders beyond LDLQ: allbal (biased and unbiased),
LDLQ-RG, allbal sorted, LDL-ADMM (the feedback solve and the sorted
rounder), grouped OPTQ and TrueOBS's outlier escape, and quantize_layer
for allbal / ldlqRG / ldlbal_admm / trueobs, each against its quip_tpu
function on the same float64 inputs (conftest turns on x64). quip_tpu
draws its dither with threefry, which the port does not reproduce: the
tests draw quip_tpu's uniforms with its own jax calls and hand them in.
Integer codes must match bit for bit; dense results within 1e-10
(relative to the largest entry); the ADMM feedback matrix Z within
1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.core import gptq as JG
from quip_tpu.core import grid as JGr
from quip_tpu.core import ldlq as JL
from quip_tpu.quantize import pipeline as JP
from quip_tpu.quantize.config import QuantConfig as JQC
from quip_tpu_torch.core import gptq as TG
from quip_tpu_torch.core import grid as TGr
from quip_tpu_torch.core import ldlq as TL
from quip_tpu_torch.pack.format import pack_layer_result
from quip_tpu_torch.quantize import pipeline as TP
from tests.conftest import make_psd_hessian
from tests.test_torch_quant_core import jax_rot, t_cfg

TOL = 1e-10


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _grid_case(seed, m, d, bits=2):
    """W in qfn-b grid coordinates and a PSD H (distinct diagonals, so
    the diag(H) sorts have no ties)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((m, d))
    H = make_psd_hessian(rng, d) * (1 + rng.random(d))[None, :]
    H = (H + H.T) / 2
    Wj = jnp.asarray(W)
    s = JGr.qfnb_scale(Wj)
    return np.asarray(JGr.to_grid_qfnb(Wj, s, 2 ** bits - 1)), H


def _uniforms(key, nb, B, m):
    """quip_tpu's per-pass allbal dither: uniform(fold_in(key, pass))."""
    return lambda ip: t(jax.random.uniform(jax.random.fold_in(key, ip),
                                           (nb, B, m), dtype=jnp.float64))


# one shape (40 % 16 != 0: the padded path), so that each quip_tpu program
# compiles once a module
M_, D_, BS = 12, 40, 16


@pytest.mark.parametrize("unbiased,sort", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_round_allbal_matches(unbiased, sort):
    m, d, bs = M_, D_, BS
    Wg, H = _grid_case(m + d, m, d)
    key = jax.random.key(5)
    jfn = JL.round_allbal_sorted if sort else JL.round_allbal
    tfn = TL.round_allbal_sorted if sort else TL.round_allbal
    want = jfn(jnp.asarray(Wg), jnp.asarray(H), 2, 3, unbiased, key, bs)
    nb = -(-d // bs)
    got = tfn(t(Wg), t(H), 2, 3, unbiased, None, bs,
              uniforms=_uniforms(key, nb, bs, m) if unbiased else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("npasses,unbiased", [(0, False), (2, False),
                                              (0, True)])
def test_round_ldlqRG_matches(npasses, unbiased):
    m, d, bs = M_, D_, BS
    Wg, H = _grid_case(2 * m + d, m, d)
    key = jax.random.key(6)
    want = JL.round_ldlqRG(jnp.asarray(Wg), jnp.asarray(H), 2, npasses,
                           unbiased, key, bs)
    dp = -(-d // bs) * bs
    eta = t(jax.random.uniform(key, (m, dp), dtype=jnp.float64)) \
        if unbiased else None
    got = TL.round_ldlqRG(t(Wg), t(H), 2, npasses, unbiased, None, bs,
                          eta=eta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ldlp_admm_matches():
    _, H = _grid_case(3, 4, 24)
    Hn = H / H.diagonal().max()
    want = JL.ldlp_admm(jnp.asarray(Hn), niters=40)
    got = TL.ldlp_admm(t(Hn), niters=40)
    _close(got.numpy(), want)
    assert np.abs(np.triu(got.numpy())).max() == 0     # strictly lower


@pytest.mark.parametrize("npasses,unbiased", [(2, False), (0, True)])
def test_round_ldl_admm_sorted_matches(npasses, unbiased):
    m, d = 8, 24
    Wg, H = _grid_case(4, m, d)
    key = jax.random.key(7)
    want = JL.round_ldl_admm_sorted(jnp.asarray(Wg), jnp.asarray(H), 2,
                                    npasses, unbiased, key)
    eta = t(jax.random.uniform(key, (m, d), dtype=jnp.float64)) \
        if unbiased else None
    got = TL.round_ldl_admm_sorted(t(Wg), t(H), 2, npasses, unbiased,
                                   eta=eta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _wh(seed, m, d):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, d)), make_psd_hessian(rng, d)


@pytest.mark.parametrize("groupsize,qfn", [(8, "a"), (16, "c")])
def test_gptq_grouped_matches(groupsize, qfn):
    W, H = _wh(21, 12, 32)
    g = JGr.find_params_qfna(jnp.asarray(W), 2)
    want = JG.gptq_round(jnp.asarray(W), jnp.asarray(H), g, qfn, 16,
                         groupsize)
    tg = TGr.GridParams(t(g.scale), t(g.zero), float(g.maxq))
    got = TG.gptq_round(t(W), t(H), tg, qfn, 16, groupsize)
    _close(got.numpy(), want)


@pytest.mark.parametrize("qfn", ["a", "b"])
def test_gptq_sparse_outlier_matches(qfn):
    W, H = _wh(22, 12, 40)
    W[2, 5] = 9.0                          # an outlier the escape keeps
    g = JGr.find_params_qfna(jnp.asarray(W), 2)
    if qfn == "b":
        g = g._replace(scale=jnp.ones_like(g.scale),
                       zero=jnp.zeros_like(g.zero))
    want = np.asarray(JG.gptq_round(jnp.asarray(W), jnp.asarray(H), g, qfn,
                                    16, sparse_outlier=0.25))
    tg = TGr.GridParams(t(g.scale), t(g.zero), float(g.maxq))
    got = TG.gptq_round(t(W), t(H), tg, qfn, 16, sparse_outlier=0.25)
    _close(got.numpy(), want)
    plain = TG.gptq_round(t(W), t(H), tg, qfn, 16).numpy()
    assert not np.allclose(plain, want)     # the escape changed something


@pytest.mark.parametrize("method,incoh", [
    ("allbal", True), ("ldlqRG", True), ("ldlbal_admm", True),
    ("trueobs", True), ("trueobs", False)])
def test_quantize_layer_methods_match(method, incoh):
    m, d = 16, 32
    W, H = _wh(23, m, d)
    kw = dict(npasses=2, blocksize=16)
    if incoh:
        jc = JQC.incoherence(2, method, **kw)
    else:
        jc = JQC(wbits=2, method=method, qfn="a", **kw)
    key = jax.random.key(8)
    want = JP.quantize_layer(jnp.asarray(W), jnp.asarray(H), jc, key)
    rot = jax_rot(key, m, d) if incoh else None
    got = TP.quantize_layer(t(W), t(H), t_cfg(jc), rot=rot)
    _close(got.W_hat.numpy(), want.W_hat)
    _close(float(got.error), float(want.error))
    if want.codes is None:
        assert got.codes is None
        with pytest.raises(ValueError, match="no integer codes"):
            pack_layer_result(got, 2)
    else:
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
