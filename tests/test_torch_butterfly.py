"""Port parity for the butterfly incoherence modes ('block', 'noblock',
'nopermute'): the factor split, butterfly application and its
materialisation, the rotate / unrotate functions, preproc / postproc, a
butterfly PackedLinear through qlinear_apply and dequantize, llama-tiny
logits in 'noblock' and 'block' mode, checkpoints written by either
package, and the quantize CLI's default --pre_proj route, each against
quip_tpu on the same numpy inputs. quip_tpu's threefry-drawn blocks and
permutations are handed across (``bf_to_torch``). Tolerances: butterfly
application 1e-12 at float64 (relative to the largest entry); preproc /
postproc 1e-9; the packed layer 1e-5 in float32; logits 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.core import hessian as JH
from quip_tpu.core import incoherence as JI
from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.ops import qlinear as JQ
from quip_tpu.pack import format as JF
from quip_tpu.pack import model as JPM
from quip_tpu.quantize import pipeline as JP
from quip_tpu.quantize.config import QuantConfig as JQC
from quip_tpu_torch.cli import quantize as CLI
from quip_tpu_torch.convert import packed_from_numpy, params_from_numpy
from quip_tpu_torch.core import hessian as TH
from quip_tpu_torch.core import incoherence as TI
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models.build import packed_model
from quip_tpu_torch.ops.qlinear import qlinear_apply
from quip_tpu_torch.pack import format as TF
from quip_tpu_torch.pack import model as TPM
from quip_tpu_torch.quantize import pipeline as TP
from tests.test_torch_quant_core import _wh, t, t_cfg

MODES = ["block", "noblock", "nopermute"]


def bf_to_torch(bf):
    """A quip_tpu Butterfly (jax arrays) as the port's (int32 perms)."""
    perm = lambda p: None if p is None else t(p).to(torch.int32)  # noqa
    return TI.Butterfly(tuple(t(b) for b in bf.blocks), perm(bf.perm_in),
                        perm(bf.perm_out), bf.n)


def jax_bf_rot(key, m, d, mode, dtype=jnp.float64):
    """The (U, V) quip_tpu's quantize_layer(W, H, cfg, key) draws in a
    butterfly mode: kproj, _ = split(key); ku, kv = split(kproj)."""
    kproj, _ = jax.random.split(JI.raw_key(key))
    ku, kv = jax.random.split(kproj)
    return (JI.gen_butterfly(ku, m, mode, dtype),
            JI.gen_butterfly(kv, d, mode, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("n", [16, 96, 4096, 11008, 12288, 22016, 32000])
def test_factors_match(n):
    assert TI.prime_factors(n) == JI.prime_factors(n)
    assert TI.butterfly_factors(n) == JI.butterfly_factors(n)


@pytest.mark.parametrize("n", [64, 96, 86])
@pytest.mark.parametrize("mode", MODES)
def test_apply_butterfly_matches(mode, n):
    bf = JI.gen_butterfly(jax.random.key(n), n, mode, jnp.float64)
    tb = bf_to_torch(bf)
    x = np.random.default_rng(n).standard_normal((3, n, 5))
    for axis in (1, -2):
        for tr in (False, True):
            want = JI.apply_butterfly(bf, jnp.asarray(x), axis, tr)
            got = TI.apply_butterfly(tb, t(x), axis, tr)
            _close(got.numpy(), want, 1e-12)
    _close(TI.materialize(tb, torch.float64).numpy(),
           JI.materialize(bf, jnp.float64), 1e-12)
    # the inverse permutations, kept or derived, give the same gather
    kept = tb._replace(inv_in=TI.inverse_perm(tb.perm_in),
                       inv_out=TI.inverse_perm(tb.perm_out))
    assert torch.equal(TI.apply_butterfly(kept, t(x), 1, True),
                       TI.apply_butterfly(tb, t(x), 1, True))


@pytest.mark.parametrize("mode", MODES)
def test_rotations_and_preproc_match(mode):
    m, d = 64, 96      # the dims above: quip_tpu's eager ops compile once
    W, H = _wh(3, m, d)
    key = jax.random.key(4)
    ju, jv = jax_bf_rot(key, m, d, mode)
    tu, tv = bf_to_torch(ju), bf_to_torch(jv)
    Wj, Hj = jnp.asarray(W), jnp.asarray(H)
    pairs = [(TI.rotate_weight(tu, tv, t(W)), JI.rotate_weight(ju, jv, Wj)),
             (TI.rotate_hessian(tv, t(H)), JI.rotate_hessian(jv, Hj)),
             (TI.unrotate_weight(tu, tv, t(W)),
              JI.unrotate_weight(ju, jv, Wj)),
             (TI.unrotate_hessian(tv, t(H)), JI.unrotate_hessian(jv, Hj))]
    for got, want in pairs:
        _close(got.numpy(), want, 1e-12)
    kproj, _ = jax.random.split(JI.raw_key(key))
    jW, jH, jst = JH.preproc(Wj, Hj, rescale=True, proj=True, proj_key=kproj,
                             proj_mode=mode, gptqH=True)
    tW, tH, tst = TH.preproc(t(W), t(H), rescale=True, proj=True,
                             rot=(tu, tv), proj_mode=mode, gptqH=True)
    _close(tW.numpy(), jW, 1e-9)
    _close(tH.numpy(), jH, 1e-9)
    jW2, jH2 = JH.postproc(jW, jH, jst)
    tW2, tH2 = TH.postproc(tW, tH, tst)
    _close(tW2.numpy(), jW2, 1e-9)
    _close(tH2.numpy(), jH2, 1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_port_drawn_butterflies_orthogonal(mode):
    gen = torch.Generator().manual_seed(0)
    for n in (96, 86, 64):
        bf = TI.gen_butterfly(gen, n, mode)
        for b in bf.blocks:
            bd = b.double()
            eye = torch.eye(b.shape[-1], dtype=torch.float64)
            assert torch.allclose(bd @ bd.transpose(-1, -2), eye, atol=1e-5)
            assert torch.allclose(torch.linalg.det(bd),
                                  torch.ones((), dtype=torch.float64),
                                  atol=1e-5)
        assert (bf.perm_in is None) == (mode == "nopermute")
        M = TI.materialize(bf, torch.float64)
        assert torch.allclose(M @ M.t(), torch.eye(n, dtype=torch.float64),
                              atol=1e-5)
    with pytest.raises(ValueError, match="unknown"):
        TI.gen_butterfly(gen, 8, "rht")
    with pytest.raises(ValueError, match="unknown"):
        TI.is_butterfly("hadamard")


def _jax_packed(mode, rescale, m=96, d=64, pad=32):
    """A quip_tpu packed butterfly layer (qfn b, 2-bit, random codes, its
    own materialize_rotation, f32) whose planes carry ``pad`` extra zero
    out-feature rows, as padded_m pads a full-size layer."""
    rng = np.random.default_rng(7)
    codes = np.zeros((m + pad, d), np.int32)
    codes[:m] = rng.integers(0, 4, (m, d))
    sWH = jnp.asarray(rng.uniform(0.5, 2.0, d), jnp.float32) \
        if rescale else None
    key = jax.random.key(11)
    return JF.PackedLinear(
        JF.pack_codes(jnp.asarray(codes), 2), None, None,
        jnp.asarray(0.05, jnp.float32), sWH, JI.raw_key(key), None, bits=2,
        qfn="b", proj_mode=mode, out_features=m, in_features=d,
        rot=JF.materialize_rotation(key, m, d, mode, scaleWH=sWH))


@pytest.mark.parametrize("rescale", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_qlinear_butterfly_matches(mode, rescale):
    jq = _jax_packed(mode, rescale)
    tq = packed_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    assert tq.butterfly and tq.plane0.shape[-1] == 128 and \
        tq.out_features == 96
    assert (tq.scaleWH is not None) == rescale
    x = np.random.default_rng(1).standard_normal((2, 3, 64)).astype(
        np.float32)
    want = JQ.qlinear_apply(jq, jnp.asarray(x), use_kernel=False)
    got = qlinear_apply(tq, t(x))
    assert got.shape == (2, 3, 96)
    _close(got.numpy(), want, 1e-5)
    _close(tq.dequantize().numpy(), jq.dequantize(jnp.float32), 1e-5)
    # widen_3bit carries the butterfly over
    assert TF.widen_3bit(tq) is tq


def _logits(jcfg, jparams, tparams, tokens):
    want = np.asarray(JM.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                 jcfg))
    got = tparams(torch.from_numpy(tokens)).numpy()
    return got, want


@pytest.mark.parametrize("mode", ["noblock", "block"])
def test_llama_tiny_butterfly_logits_and_checkpoints(mode, tmp_path):
    tcfg, jcfg = get_config("llama-tiny"), jget_config("llama-tiny")
    tparams = packed_model(tcfg, bits=2, seed=3, dtype=torch.float32,
                           head_bits=2, device="cpu", proj=mode)
    assert tparams.blocks[0].attn.wqkv.butterfly
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    TPM.save_checkpoint(port_dir, tparams, {"model": "llama-tiny"})
    jparams, _ = JPM.load_checkpoint(port_dir)        # quip_tpu reads it
    rot = jparams["blocks"]["mlp"]["wgu"].rot
    assert isinstance(rot["u"][0], tuple) and rot["u"][1].dtype == jnp.int32
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 9))
    got, want = _logits(jcfg, jparams, tparams, tokens)
    _close(got, want, 1e-4)
    # quip_tpu writes, the port reads every buffer equal
    JPM.save_checkpoint(jax_dir, jparams, {"model": "llama-tiny"})
    tree, _ = TPM.load_checkpoint(jax_dir)
    back = params_from_numpy(tree, tcfg, device="cpu")
    want_sd, got_sd = tparams.state_dict(), back.state_dict()
    assert list(want_sd) == list(got_sd)
    for k, v in want_sd.items():
        assert v.dtype == got_sd[k].dtype and torch.equal(v, got_sd[k]), k


def test_cli_pre_proj_defaults_to_noblock(tmp_path):
    """--pre_proj without --proj_mode: --pre_proj_extra's default 1 is
    'noblock', as in quip_tpu's CLI; quip_tpu serves the checkpoint."""
    out = str(tmp_path / "ck")
    newp, art = CLI.main([
        "llama-tiny", "synthetic", "--weights", "random", "--wbits", "2",
        "--quant", "ldlq", "--pre_gptqH", "--pre_rescale", "--pre_proj",
        "--qfn", "b", "--fuse", "--quant_head", "--packed", "--save", out,
        "--nsamples", "2", "--seqlen", "16", "--chunk", "2",
        "--device", "cpu"])
    res = art.results["layers.0.self_attn.qkv_proj"]
    assert res.preproc.proj_mode == "noblock"
    assert isinstance(res.preproc.U, TI.Butterfly)
    jparams, _ = JPM.load_checkpoint(out)
    assert jparams["blocks"]["attn"]["wo"].proj_mode == "noblock"
    tcfg = dataclasses.replace(get_config("llama-tiny"), max_seq=16)
    jcfg = dataclasses.replace(jget_config("llama-tiny"), max_seq=16)
    tree, _ = TPM.load_checkpoint(out)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 8))
    got, want = _logits(jcfg, jparams, tparams, tokens)
    _close(got, want, 1e-4)
    # and the packed layers reproduce the dense W_hat the driver returned
    torch.testing.assert_close(tparams.blocks[1].mlp.wd.dequantize().t(),
                               newp.blocks[1].mlp.wd, rtol=0, atol=1e-5)
