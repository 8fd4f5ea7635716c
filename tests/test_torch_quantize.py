"""Port parity for the calibration + quantization driver, the data loader
and the quantize CLI on llama-tiny (the driver on opt-tiny too), and plain
properties of the solvers.

The driver against quip_tpu's quantize_model (float64 model, synthetic
calibration, 4 samples of 32 tokens, quant_head), with quip_tpu's
rotations replayed: both packages accumulate H in float32 whatever the
model's dtype, and the model's float32 steps (the RMS norm's variance, the
softmax) round differently in XLA and in torch, so H agrees to about 1e-7.
Layer 0 reads the same embedding on both sides: its codes are equal bit
for bit. Past it, a code that sits within that noise of a rounding
boundary can flip and its row's errors feed the next columns: at least
95 % of all codes are equal and every linear's proxy loss agrees within
5e-2 relative. The driver's own plumbing (which Hessian feeds which
linear, rotations, write-back, the head's tap) is held bit for bit:
every linear's codes equal quip_tpu's quantize_layer on the Hessian the
port's driver kept."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.data import calib as JC
from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.quantize import driver as JD
from quip_tpu.quantize.config import QuantConfig as JQC
from quip_tpu.utils import name_salt as jname_salt
from quip_tpu_torch.cli import quantize as CLI
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.data import calib as TC
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.pack.model import load_checkpoint
from quip_tpu_torch.quantize import driver as TD
from quip_tpu_torch.quantize.config import QuantConfig as TQC
from quip_tpu_torch.quantize.pipeline import draw_rotation, quantize_layer
from quip_tpu_torch.utils import name_salt
from tests.conftest import make_psd_hessian
from tests.test_torch_quant_core import jax_rot, t, t_cfg


def test_name_salt_and_synthetic_match():
    for n in ("lm_head", "layers.31.mlp.down_proj", ""):
        assert name_salt(n) == jname_salt(n)
    want = JC.get_loaders("synthetic", 3, 5, 64, vocab_size=300)
    got = TC.get_loaders("synthetic", 3, 5, 64, vocab_size=300)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError, match="not in the repository"):
        TC.get_loaders("wikitext2")
    with pytest.raises(ValueError):
        TC.get_loaders("nope")


def test_init_fuse_and_specs():
    cfg = get_config("llama-tiny")
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(gen, cfg, device="cpu")
    f = TM.fuse_params(p, cfg)
    x = torch.randint(0, cfg.vocab_size, (2, 9))
    torch.testing.assert_close(f(x), p(x), rtol=1e-5, atol=1e-5)
    jcfg = jget_config("llama-tiny")
    jp = JM.init_params(jax.random.key(0), jcfg)
    for fused in (False, True):
        assert [tuple(s) for s in TM.linear_specs(cfg, fused)] == \
            [tuple(s) for s in JM.linear_specs(jcfg, fused)]
    # the same shapes as quip_tpu's tree, std fan_in^-1/2
    assert tuple(p.blocks[0].mlp.wd.shape) == jp["blocks"]["mlp"]["wd"].shape[1:]
    assert abs(float(p.blocks[0].mlp.wd.std()) - 128 ** -0.5) < 0.01


def _jax_rotations(key, dtype=jnp.float64):
    """quip_tpu's driver's rotation of each linear: its key is
    fold_in(key, name_salt(name)), then quantize_layer's splits."""
    def rot(name, m, d):
        return jax_rot(jax.random.fold_in(key, jname_salt(name)), m, d,
                       dtype)
    return rot


def _driver_both(name, fused, quant_head, tree_fn=lambda tree: tree):
    """quip_tpu's driver and the port's (handed quip_tpu's rotations) on
    the same float64 model of preset ``name`` and the same calibration.
    Returns (jp, jcfg, key, jc, jart, tnew, tart)."""
    jcfg = dataclasses.replace(jget_config(name), dtype="float64")
    tcfg = dataclasses.replace(get_config(name), dtype="float64")
    tree = tree_fn(jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(1), jcfg)))
    jp = jax.tree.map(jnp.asarray, tree)
    if fused:
        jp = JM.fuse_params(jp, jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    calib, _ = JC.get_synthetic(4, 0, 32, jcfg.vocab_size)
    key = jax.random.key(0)
    jc = JQC.incoherence(2, "ldlq")
    jnew, jart = JD.quantize_model(jp, jcfg, jnp.asarray(calib), jc, key,
                                   chunk=2, quant_head=quant_head)
    tnew, tart = TD.quantize_model(tp, tcfg, torch.from_numpy(calib),
                                   t_cfg(jc), rotations=_jax_rotations(key),
                                   chunk=2, quant_head=quant_head,
                                   keep_hessians=True)
    assert sorted(tart.results) == sorted(jart.results)
    return jp, jcfg, key, jc, jart, tnew, tart


def _codes_and_plumbing(jp, jcfg, key, jc, jart, tart, fused):
    """Per linear: the port's codes against quip_tpu's (returns the share
    equal) and against quip_tpu's quantize_layer on the Hessian the port's
    driver kept (bit for bit)."""
    equal = total = 0
    for name, jr in jart.results.items():
        got, want = tart.results[name].codes.numpy(), np.asarray(jr.codes)
        if name.startswith("layers.0."):
            np.testing.assert_array_equal(got, want, err_msg=name)
        equal += int((got == want).sum())
        total += got.size
        np.testing.assert_allclose(tart.errors[name], jart.errors[name],
                                   rtol=5e-2, err_msg=name)
        W = (jp["lm_head"] if name == "lm_head" else
             _jax_weight(jp, jcfg, name, fused))
        lkey = jax.random.fold_in(key, jname_salt(name))
        ref = JD._jitted_quantize_layer(jc)(
            jnp.asarray(W).T, jnp.asarray(tart.hessians[name].numpy()), lkey)
        np.testing.assert_array_equal(got, np.asarray(ref.codes),
                                      err_msg=name)
    return equal / total


@pytest.mark.parametrize("fused", [False, True])
def test_quantize_model_matches(fused):
    jp, jcfg, key, jc, jart, tnew, tart = _driver_both("llama-tiny", fused,
                                                       True)
    share = _codes_and_plumbing(jp, jcfg, key, jc, jart, tart, fused)
    assert share >= 0.95, share
    # the new model holds W_hat (in, out) in the model's dtype
    wd = tnew.blocks[1].mlp.wd
    assert wd.dtype == torch.float64
    np.testing.assert_array_equal(
        wd.numpy(), tart.results["layers.1.mlp.down_proj"].W_hat.numpy().T)
    assert set(tart.phase_times) == {"layers.0", "layers.1"}
    assert set(tart.times) == {"layers.0", "layers.1", "lm_head"}


@pytest.mark.parametrize("fused", [False, True])
def test_quantize_model_matches_opt(fused):
    """opt-tiny with nonzero biases and LayerNorm shifts: learned
    positions in the calibration windows, the fc1 / fc2 taps, biases kept
    as they were beside the quantized weights."""
    from tests.test_torch_families import _nonzero
    jp, jcfg, key, jc, jart, tnew, tart = _driver_both(
        "opt-tiny", fused, False,
        lambda tree: _nonzero(tree, np.random.default_rng(1)))
    assert sorted({n.split(".", 2)[2] for n in tart.results}) == (
        ["fc1", "fc2", "self_attn.o_proj", "self_attn.qkv_proj"] if fused
        else ["fc1", "fc2", "self_attn.k_proj", "self_attn.out_proj",
              "self_attn.q_proj", "self_attn.v_proj"])
    share = _codes_and_plumbing(jp, jcfg, key, jc, jart, tart, fused)
    assert share == 1.0, share
    b = tnew.blocks[1]
    np.testing.assert_array_equal(b.mlp.b1.numpy(),
                                  np.asarray(jp["blocks"]["mlp"]["b1"][1]))
    np.testing.assert_array_equal(
        b.mlp.w2.numpy(), tart.results["layers.1.fc2"].W_hat.numpy().T)


def test_quant_head_on_a_tied_family_raises():
    """Both packages refuse to quantize a tied lm_head (OPT, BLOOM)."""
    calib, _ = JC.get_synthetic(2, 0, 16, 512)
    for name in ("opt-tiny", "bloom-tiny"):
        jcfg, tcfg = jget_config(name), get_config(name)
        with pytest.raises(ValueError, match="untied"):
            JD.quantize_model(JM.init_params(jax.random.key(0), jcfg), jcfg,
                              jnp.asarray(calib), JQC.incoherence(2, "ldlq"),
                              jax.random.key(0), chunk=2, quant_head=True)
        tp = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
        with pytest.raises(ValueError, match="untied"):
            TD.quantize_model(tp, tcfg, torch.from_numpy(calib),
                              TQC.incoherence(2, "ldlq"), chunk=2,
                              quant_head=True)


def _jax_weight(jp, jcfg, name, fused):
    li = int(name.split(".")[1])
    spec = {s.name: s for s in JM.linear_specs(jcfg, fused=fused)}[
        name.split(".", 2)[2]]
    w = jp["blocks"]
    for k in spec.path:
        w = w[k]
    return w[li]


def test_quantize_model_filter_keep_and_raises(tmp_path):
    cfg = get_config("llama-tiny")
    p = TM.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    calib = torch.from_numpy(TC.get_synthetic(2, 0, 16, cfg.vocab_size)[0])
    qc = TQC.incoherence(2, "ldlq")
    new, art = TD.quantize_model(p, cfg, calib, qc, chunk=2,
                                 layer_filter=["mlp.down_proj"],
                                 keep_hessians=["layers.1.mlp.down_proj"])
    assert sorted(art.results) == ["layers.0.mlp.down_proj",
                                   "layers.1.mlp.down_proj"]
    assert list(art.hessians) == ["layers.1.mlp.down_proj"]
    assert new.blocks[0].attn.wq is p.blocks[0].attn.wq
    assert not torch.equal(new.blocks[0].mlp.wd, p.blocks[0].mlp.wd)
    # the same seed draws the same rotations: the same codes again
    _, art2 = TD.quantize_model(p, cfg, calib, qc, chunk=2,
                                layer_filter=["mlp.down_proj"])
    assert torch.equal(art2.results["layers.1.mlp.down_proj"].codes,
                       art.results["layers.1.mlp.down_proj"].codes)
    # resume_dir and host_offload give the same codes again
    for kw in (dict(resume_dir=str(tmp_path / "resume")),
               dict(host_offload=True)):
        _, art3 = TD.quantize_model(p, cfg, calib, qc, chunk=2,
                                    layer_filter=["mlp.down_proj"], **kw)
        assert torch.equal(art3.results["layers.1.mlp.down_proj"].codes,
                           art.results["layers.1.mlp.down_proj"].codes)
    with pytest.raises(ValueError, match="divisible"):
        TD.quantize_model(p, cfg, calib, qc, chunk=3)


def test_cli_quantize_packed(tmp_path):
    out = str(tmp_path / "ckpt")
    newp, art = CLI.main([
        "llama-tiny", "synthetic", "--weights", "random", "--wbits", "2",
        "--quant", "ldlq", "--incoh_processing", "--fuse", "--quant_head",
        "--packed", "--save", out, "--nsamples", "4", "--seqlen", "32",
        "--device", "cpu"])
    assert len(art.results) == 2 * 4 + 1
    tree, meta = load_checkpoint(out)
    assert meta == {"model": "llama-tiny", "wbits": 2, "quant": "ldlq",
                    "packed": True, "seqlen": 32}
    cfg = dataclasses.replace(get_config("llama-tiny"), max_seq=32)
    model = params_from_numpy(tree, cfg, device="cpu")
    # the packed layers reproduce the dense W_hat the driver returned
    for got, want in ((model.blocks[1].attn.wqkv, newp.blocks[1].attn.wqkv),
                      (model.lm_head, newp.lm_head)):
        torch.testing.assert_close(got.dequantize().t(), want, rtol=0,
                                   atol=1e-5)
    x = torch.randint(0, cfg.vocab_size, (1, 12))
    torch.testing.assert_close(model(x), newp(x), rtol=1e-4, atol=1e-4)
    # --dp keeps quip_tpu's checks (before any model load): the chunk
    # must span every window (tests/test_torch_mesh.py runs --dp 2)
    with pytest.raises(SystemExit):
        CLI.main(["llama-tiny", "synthetic", "--wbits", "2", "--device",
                  "cpu", "--dp", "2"])
    # --resume_dir and --host_offload run (tests/test_torch_driver_options
    # holds their results)
    resume = str(tmp_path / "resume")
    for flag in (["--resume_dir", resume], ["--host_offload"]):
        _, art_f = CLI.main([
            "llama-tiny", "synthetic", "--weights", "random", "--wbits",
            "2", "--quant", "ldlq", "--incoh_processing", "--nsamples", "4",
            "--seqlen", "32", "--device", "cpu", *flag])
        assert len(art_f.results) == 2 * 7
    assert sorted(os.listdir(resume)) == ["layer_0.npz", "layer_1.npz"]
    # Hugging Face weights load from a local directory only
    with pytest.raises(FileNotFoundError, match="must be local"):
        CLI.main(["llama-tiny", "synthetic", "--wbits", "2", "--device",
                  "cpu", "--weights", "/some/hf/dir"])


# ---------------------------------------------------------------------------
# plain properties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ldlq_beats_nearest(seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((32, 64))
    H = make_psd_hessian(rng, 64, nsamples=80)   # low-rank-ish: LDLQ helps
    gen = torch.Generator().manual_seed(seed)
    rot = draw_rotation(gen, 32, 64)
    losses = {m: float(quantize_layer(t(W), t(H), TQC.incoherence(2, m),
                                      rot=rot).error)
              for m in ("ldlq", "nearest")}
    assert losses["ldlq"] <= losses["nearest"], losses


def test_unbiased_codes_in_range_and_mean_error_small():
    rng = np.random.default_rng(4)
    W = rng.standard_normal((16, 32))
    H = make_psd_hessian(rng, 32)
    qc = TQC.incoherence(2, "ldlq", unbiased=True)
    rot = jax_rot(jax.random.key(0), 16, 32)
    errs = []
    for seed in range(24):
        r = quantize_layer(t(W), t(H), qc, rot=rot,
                           gen=torch.Generator().manual_seed(seed))
        assert int(r.codes.max()) <= 3
        errs.append(r.W_hat.numpy() - W)
    errs = np.stack(errs)
    # zero-mean rounding: the mean over 24 draws shrinks like 1/sqrt(24)
    # (0.2) of one draw's error; allow twice that
    assert np.sqrt((errs.mean(0) ** 2).mean()) < \
        0.4 * np.sqrt((errs ** 2).mean())
    with pytest.raises(ValueError, match="Generator"):
        quantize_layer(t(W), t(H), qc, rot=rot)
