"""The driver's options on llama-tiny: per-layer resume (quip_tpu's
``layer_{i}.npz`` files, read and written by both packages), host
offload, save_hessians, and the quantize CLI's --resume_dir /
--host_offload / --trace.

Resumed layers are the stored dense weights bit for bit. quip_tpu's
resume directory resumes in the port (float64 model, quip_tpu's rotations
replayed): every block equals quip_tpu's quantized block bit for bit, and
the head, which the port quantizes on its own replay of those blocks,
gets quip_tpu's codes up to the calibration noise that
tests/test_torch_quantize.py describes (H agrees to about 1e-7, because
both packages accumulate it in float32): at least 95 % of them equal, the
proxy loss within 5e-2 relative. For the same reason save_hessians holds
quip_tpu's Hessians within 1e-6 relative to the largest entry, and the
port's own quantize_model's kept Hessians bit for bit."""
import contextlib
import dataclasses
import glob
import io
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
from quip_tpu_torch.cli import quantize as CLI
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.data import calib as TC
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.quantize import driver as TD
from quip_tpu_torch.quantize.config import QuantConfig as TQC
from tests.test_torch_quant_core import t_cfg
from tests.test_torch_quantize import _jax_rotations


def _tiny(dtype="float32", seed=0):
    cfg = dataclasses.replace(get_config("llama-tiny"), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    p = TM.fuse_params(TM.init_params(gen, cfg, device="cpu"), cfg)
    calib = torch.from_numpy(TC.get_synthetic(4, 0, 16, cfg.vocab_size)[0])
    return p, cfg, calib


def _quiet(fn, *a, **kw):
    """fn(*a, **kw) and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _assert_same_blocks(a, b):
    for x, y in zip(a.blocks, b.blocks):
        sx, sy = x.state_dict(), y.state_dict()
        assert list(sx) == list(sy)
        for k in sx:
            assert sx[k].dtype == sy[k].dtype and torch.equal(sx[k], sy[k]), k


def test_resume_skips_finished_layers(tmp_path):
    p, cfg, calib = _tiny()
    qc = TQC.incoherence(2, "ldlq")
    rd = str(tmp_path / "resume")
    new, art = TD.quantize_model(p, cfg, calib, qc, chunk=2, resume_dir=rd,
                                 quant_head=True)
    assert sorted(os.listdir(rd)) == ["layer_0.npz", "layer_1.npz"]
    (new2, art2), out = _quiet(TD.quantize_model, p, cfg, calib, qc,
                               chunk=2, resume_dir=rd, quant_head=True,
                               progress=True)
    assert out.count("(resumed)") == cfg.n_layers
    assert sorted(art2.results) == ["lm_head"]      # as in quip_tpu
    assert art2.errors == art.errors
    _assert_same_blocks(new2, new)
    assert torch.equal(art2.results["lm_head"].codes,
                       art.results["lm_head"].codes)
    # a file of another layout version, or of another model, is refused
    path = os.path.join(rd, "layer_1.npz")
    with np.load(path) as data:
        files = {k: data[k] for k in data.files}
    np.savez(path, **{**files, "__format_version__": np.asarray(1)})
    with pytest.raises(ValueError, match="layout v1"):
        TD.quantize_model(p, cfg, calib, qc, chunk=2, resume_dir=rd)
    np.savez(path, **{**files, "leaf_0": files["leaf_0"][:, :8]})
    with pytest.raises(ValueError, match="stale resume dir"):
        TD.quantize_model(p, cfg, calib, qc, chunk=2, resume_dir=rd)


_JAX_RUN = {}


def _jax_resume_run(tmp_path_factory):
    """quip_tpu's driver on a float64 fused llama-tiny with resume_dir and
    quant_head; the same model as the port's, its calibration and key."""
    if not _JAX_RUN:
        jcfg = dataclasses.replace(jget_config("llama-tiny"),
                                   dtype="float64")
        tcfg = dataclasses.replace(get_config("llama-tiny"), dtype="float64")
        jp = JM.fuse_params(JM.init_params(jax.random.key(1), jcfg), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        calib, _ = JC.get_synthetic(4, 0, 16, jcfg.vocab_size)
        key = jax.random.key(0)
        jc = JQC.incoherence(2, "ldlq")
        rd = str(tmp_path_factory.mktemp("jax_resume"))
        jnew, jart = JD.quantize_model(jp, jcfg, jnp.asarray(calib), jc, key,
                                       chunk=2, quant_head=True,
                                       resume_dir=rd)
        _JAX_RUN.update(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, calib=calib,
                        key=key, jc=jc, rd=rd, jnew=jnew, jart=jart)
    return _JAX_RUN


def _dense_model(jtree, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), tcfg,
                             device="cpu")


def test_quip_tpu_resume_dir_resumes_in_port(tmp_path_factory):
    r = _jax_resume_run(tmp_path_factory)
    (tnew, tart), out = _quiet(
        TD.quantize_model, r["tp"], r["tcfg"],
        torch.from_numpy(r["calib"]), t_cfg(r["jc"]),
        rotations=_jax_rotations(r["key"]), chunk=2, quant_head=True,
        resume_dir=r["rd"], progress=True)
    assert out.count("(resumed)") == r["tcfg"].n_layers
    _assert_same_blocks(tnew, _dense_model(r["jnew"], r["tcfg"]))
    for k, v in r["jart"].errors.items():
        if k != "lm_head":
            assert tart.errors[k] == v, k
    got = tart.results["lm_head"].codes.numpy()
    want = np.asarray(r["jart"].results["lm_head"].codes)
    assert (got == want).mean() >= 0.95
    assert abs(tart.errors["lm_head"] / r["jart"].errors["lm_head"] - 1) \
        <= 5e-2


def test_port_resume_dir_resumes_in_quip_tpu(tmp_path_factory, tmp_path):
    r = _jax_resume_run(tmp_path_factory)
    rd = str(tmp_path / "port_resume")
    tnew, _ = TD.quantize_model(
        r["tp"], r["tcfg"], torch.from_numpy(r["calib"]), t_cfg(r["jc"]),
        rotations=_jax_rotations(r["key"]), chunk=2, resume_dir=rd)
    jnew, jart = JD.quantize_model(r["jp"], r["jcfg"],
                                   jnp.asarray(r["calib"]), r["jc"],
                                   r["key"], chunk=2, resume_dir=rd)
    assert not jart.results                     # every layer resumed
    _assert_same_blocks(_dense_model(jnew, r["tcfg"]), tnew)


def test_host_offload_matches(tmp_path):
    p, cfg, calib = _tiny()
    qc = TQC.incoherence(2, "ldlq")
    new, art = TD.quantize_model(p, cfg, calib, qc, chunk=2,
                                 quant_head=True)
    off, aoff = TD.quantize_model(p, cfg, calib, qc, chunk=2,
                                  quant_head=True, host_offload=True,
                                  device="cpu")
    _assert_same_blocks(off, new)
    assert torch.equal(off.lm_head, new.lm_head)
    for k, res in art.results.items():
        assert torch.equal(aoff.results[k].codes, res.codes), k
        assert aoff.results[k].W_hat.device.type == "cpu"


def test_save_hessians_matches():
    jcfg = dataclasses.replace(jget_config("llama-tiny"), dtype="float64")
    tcfg = dataclasses.replace(get_config("llama-tiny"), dtype="float64")
    jp = JM.init_params(jax.random.key(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    calib, _ = JC.get_synthetic(4, 0, 16, jcfg.vocab_size)
    want = JD.save_hessians(jp, jcfg, jnp.asarray(calib), chunk=2)
    got = TD.save_hessians(tp, tcfg, torch.from_numpy(calib), chunk=2)
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)
    # layer 0's are the Hessians the driver quantizes against (past it the
    # driver replays quantized blocks, save_hessians the model's own)
    _, art = TD.quantize_model(tp, tcfg, torch.from_numpy(calib),
                               TQC(wbits=2, method="nearest"), chunk=2,
                               keep_hessians=True)
    for k, H in art.hessians.items():
        if k.startswith("layers.0."):
            assert torch.equal(got[k], H), k


def test_cli_resume_offload_trace(tmp_path):
    rd, tr = str(tmp_path / "resume"), str(tmp_path / "trace")
    argv = ["llama-tiny", "synthetic", "--weights", "random", "--wbits", "2",
            "--quant", "ldlqRG", "--incoh_processing", "--fuse",
            "--nsamples", "2", "--seqlen", "16", "--chunk", "2",
            "--device", "cpu", "--resume_dir", rd, "--host_offload"]
    first, _ = CLI.main(argv + ["--trace", tr])
    assert glob.glob(os.path.join(tr, "*.json"))
    (second, _), out = _quiet(CLI.main, argv)
    assert out.count("(resumed)") == 2
    _assert_same_blocks(second, first)
    # --dp 2 (two gloo ranks, this process rank 0) resumes every layer of
    # the same directory, each rank deciding before either writes
    (third, _), out = _quiet(CLI.main, argv + ["--dp", "2"])
    assert out.count("(resumed)") == 2
    _assert_same_blocks(third, first)
