"""Port parity for the analysis tools (analysis.py), the tools CLI and
utils/profiling.py, against quip_tpu on the same inputs: Hessian npz IO
(the same keys), the Hessian summary at float64 (1e-9), the eigenspectrum
CSV (numpy on both sides: equal text), the proxy evaluation with
quip_tpu's rotations replayed (1e-9 relative), the OPTQ == LDLQ check
(1e-9), and the CLI's save-hessians / proxy / hsummary / equiv-check on
llama-tiny."""
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
from quip_tpu_torch.models import get_config
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
    got = TAn.optq_ldlq_equivalence_check(32, 48, 3, 1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9 * max(1.0, abs(want[k])), k
    assert got["frac_agree_1e6"] > 0.99


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
