"""Port parity for the analysis tools (analysis.py), the tools CLI and
utils/profiling.py, against quip_tpu on the same inputs: Hessian npz IO
(the same keys), the Hessian summary at float64 (1e-9), the eigenspectrum
CSV (numpy on both sides: equal text), the proxy evaluation with
quip_tpu's rotations replayed (1e-9 relative), the OPTQ == LDLQ check
(1e-9), the CLI's save-hessians / proxy / hsummary / equiv-check on
llama-tiny, ``transcode`` of a packed llama-tiny checkpoint written by
quip_tpu ('rht' and butterfly 'block' at 2 bits, 'rht' at 3 bits; the same
leaves, dtypes and meta, linears within 1e-5 relative, each package
reading the other's output) and ``counter``'s rows at n = 64 in float64
(1e-7 relative)."""
import contextlib
import dataclasses
import glob
import io
import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu import analysis as JAn
from quip_tpu.cli import tools as JT
from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.quantize.config import QuantConfig as JQC
from quip_tpu_torch import analysis as TAn
from quip_tpu_torch.cli import tools as TT
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu.pack import model as JPM
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models.build import packed_model
from quip_tpu_torch.pack import model as TPM
from quip_tpu_torch.utils import profiling as TPf
from tests.conftest import make_psd_hessian
from tests.test_torch_quant_core import t_cfg
from tests.test_torch_quantize import _jax_rotations


def _hessians(n=3, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return {f"layers.{i}.mlp.fc2": make_psd_hessian(rng, d)
            for i in range(n)}


def test_hessian_npz_and_summaries_match(tmp_path):
    Hs = _hessians()
    TAn.save_hessians_npz(str(tmp_path / "t" / "H.npz"),
                          {k: torch.from_numpy(v) for k, v in Hs.items()})
    JAn.save_hessians_npz(str(tmp_path / "j" / "H.npz"), Hs)
    got = TAn.load_hessians_npz(str(tmp_path / "t" / "H.npz"))
    want = JAn.load_hessians_npz(str(tmp_path / "j" / "H.npz"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for k, H in Hs.items():
        np.testing.assert_allclose(TAn.hessian_summary(H),
                                   JAn.hessian_summary(H), rtol=1e-9)
    pk = str(tmp_path / "s.pkl")
    rows = TAn.hessian_summary_sweep(Hs, pickle_path=pk)
    with open(pk, "rb") as f:
        assert pickle.load(f) == rows
    jrows = JAn.hessian_summary_sweep(Hs)
    for k in Hs:
        np.testing.assert_allclose(rows[k], jrows[k], rtol=1e-9)
    TAn.eigenspectrum_csv(str(tmp_path / "t.csv"), Hs)
    JAn.eigenspectrum_csv(str(tmp_path / "j.csv"), Hs)
    with open(tmp_path / "t.csv") as a, open(tmp_path / "j.csv") as b:
        assert a.read() == b.read()


def test_proxy_eval_matches():
    jcfg = dataclasses.replace(jget_config("llama-tiny"), dtype="float64")
    tcfg = dataclasses.replace(get_config("llama-tiny"), dtype="float64")
    jp = JM.init_params(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    Hs = {"layers.1.self_attn.o_proj": make_psd_hessian(rng, 64)}
    jc = JQC.incoherence(2, "ldlq")
    key = jax.random.key(0)
    want = JAn.proxy_eval(jp, jcfg, Hs, jc, key)
    got = TAn.proxy_eval(tp, tcfg, Hs, t_cfg(jc),
                         rotations=_jax_rotations(key))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] / want[k] - 1) <= 1e-9, k
    assert TAn.proxy_eval(tp, tcfg, Hs, t_cfg(jc), layer_indices=[0]) == {}


def test_equivalence_check_matches():
    want = JAn.optq_ldlq_equivalence_check(32, 48, 3, 1)
    got = TAn.optq_ldlq_equivalence_check(32, 48, 3, 1, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9 * max(1.0, abs(want[k])), k
    assert got["frac_agree_1e6"] > 0.99


def test_equivalence_check_defaults_to_the_card():
    """An entry point: its device defaults to "cuda" and, with no card,
    the default raises instead of running on the CPU."""
    import inspect
    fn = TAn.optq_ldlq_equivalence_check
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(32, 48, 3, 1)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def test_tools_cli(tmp_path):
    tH, jH = str(tmp_path / "tH.npz"), str(tmp_path / "jH.npz")
    common = ["llama-tiny", "synthetic", "--weights", "random",
              "--nsamples", "2", "--seqlen", "16", "--chunk", "2"]
    _, out = _run(TT.main, ["save-hessians", *common, "--out", tH,
                            "--device", "cpu"])
    assert "saved 14 Hessians" in out
    _run(JT.main, ["save-hessians", *common, "--out", jH,
                   "--no_compile_cache"])
    assert list(TAn.load_hessians_npz(tH)) == \
        list(JAn.load_hessians_npz(jH))
    res, out = _run(TT.main, [
        "proxy", "llama-tiny", "--weights", "random", "--hessians", tH,
        "--wbits", "2", "--quant", "ldlq", "--incoh_processing",
        "--layers", "0", "--names", "mlp.down_proj,self_attn.o_proj",
        "--device", "cpu"])
    assert json.loads(out) == res and res["n"] == 2
    assert sorted(res["per_layer"]) == ["layers.0.mlp.down_proj",
                                        "layers.0.self_attn.o_proj"]
    # the butterfly flags (no --incoh_processing) and a grouped OPTQ
    res, _ = _run(TT.main, [
        "proxy", "llama-tiny", "--weights", "random", "--hessians", tH,
        "--wbits", "2", "--quant", "gptq", "--groupsize", "16",
        "--pre_gptqH", "--pre_rescale", "--pre_proj", "--layers", "1",
        "--names", "mlp.down_proj", "--device", "cpu"])
    assert list(res["per_layer"]) == ["layers.1.mlp.down_proj"]
    csv = str(tmp_path / "e.csv")
    rows, out = _run(TT.main, ["hsummary", "--hessians", tH, "--eigens_csv",
                               csv, "--device", "cpu"])
    assert len(rows) == 14 and "incoherency mu" in out
    assert os.path.exists(csv)
    res, out = _run(TT.main, ["equiv-check", "--m", "16", "--d", "32",
                              "--device", "cpu"])
    assert "EQUIVALENCE OK" in out


def _read_ckpt(path):
    """A checkpoint's tree.json and its arrays, as stored."""
    with open(os.path.join(path, "tree.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return spec, {k: data[k] for k in data.files}


@pytest.mark.parametrize("mode,bits", [("rht", 2), ("block", 2),
                                       ("rht", 3)])
def test_transcode_matches(mode, bits, tmp_path):
    """quip_tpu writes a packed llama-tiny (bf16 embedding and norms,
    packed head); the port's transcode of it holds quip_tpu's leaf for
    leaf, and each package loads the other's dense checkpoint."""
    tcfg = get_config("llama-tiny")
    tparams = packed_model(tcfg, bits=bits, seed=5, dtype=torch.bfloat16,
                           head_bits=bits, device="cpu", proj=mode)
    port_dir, packed = str(tmp_path / "port"), str(tmp_path / "packed")
    TPM.save_checkpoint(port_dir, tparams, {"model": "llama-tiny",
                                            "wbits": bits, "packed": True})
    JPM.save_checkpoint(packed, *JPM.load_checkpoint(port_dir))
    jdir, tdir = str(tmp_path / "jdense"), str(tmp_path / "tdense")
    _run(JT.main, ["transcode", "--load", packed, "--save", jdir])
    tree, meta = TPM.transcode(packed, tdir, device="cpu")
    assert meta == {"model": "llama-tiny", "wbits": bits, "packed": False,
                    "transcoded_from": packed}
    jspec, jarr = _read_ckpt(jdir)
    tspec, tarr = _read_ckpt(tdir)
    assert tspec == jspec                 # structure, dtypes, meta
    assert sorted(tarr) == sorted(jarr)
    linears = 0
    for k, want in jarr.items():
        got = tarr[k]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), k
        if want.dtype == np.float32 and want.ndim >= 2:   # a linear
            linears += 1
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5, (k, err)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert linears == 5 and len(jspec["leaf_dtypes"]) == len(jarr) - 5
    # the dense tree the function returns is what it wrote
    assert tree["blocks"]["mlp"]["wgu"].shape == (2, 64, 256)
    assert tree["embed"]["tokens"].dtype == torch.bfloat16
    # each package reads the other's output
    jtree, jmeta = JPM.load_checkpoint(tdir)
    assert jmeta == meta and jtree["lm_head"].dtype == jnp.float32
    back, bmeta = TPM.load_checkpoint(jdir)
    assert bmeta == meta
    assert torch.equal(back["embed"]["tokens"], tree["embed"]["tokens"])
    if mode == "rht" and bits == 2:       # the CLI is the function
        cdir = str(tmp_path / "cli")
        _, out = _run(TT.main, ["transcode", "--load", packed, "--save",
                                cdir, "--device", "cpu"])
        assert out == f"transcoded {packed} -> dense at {cdir}\n"
        cspec, carr = _read_ckpt(cdir)
        assert cspec == tspec
        for k, v in tarr.items():
            np.testing.assert_array_equal(carr[k], v, err_msg=k)


def test_counter_matches():
    """The counterexample's rows at n = 64: the port in float64 against
    quip_tpu's CLI (x64 on in the tests), and the port's CLI in float32."""
    _, out = _run(JT.main, ["counter", "--sizes", "64"])
    want = json.loads(out)
    got = TAn.counter_rows(64, torch.float64, "cpu")
    assert list(got) == [k for k in want if k != "n"]
    for k, v in got.items():
        assert abs(v / want[k] - 1) <= 1e-7, (k, v, want[k])
    assert got["ldlq"] < got["nearest"] / 2
    rows, out = _run(TT.main, ["counter", "--sizes", "64,96", "--device",
                               "cpu"])
    assert [json.loads(line) for line in out.splitlines()] == rows
    assert [r["n"] for r in rows] == [64, 96]
    for k, v in got.items():
        assert abs(rows[0][k] / v - 1) <= 1e-5, (k, rows[0][k], v)


def test_profiling_utils(tmp_path):
    timer = TPf.PhaseTimer()
    for _ in range(2):
        with timer.phase("solve"):
            pass
    assert timer.counts["solve"] == 2 and "solve" in timer.summary()
    with TPf.trace(None):
        pass
    log_dir = str(tmp_path / "tr")
    with TPf.trace(log_dir):
        torch.ones(4) @ torch.ones(4)
    assert glob.glob(os.path.join(log_dir, "*.json"))
    g = TPf.seed_everything(5)
    a = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=g).item())
    g = TPf.seed_everything(5)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item(),
                 torch.rand(1, generator=g).item())
