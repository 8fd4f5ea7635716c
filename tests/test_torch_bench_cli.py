"""The port's decode-benchmark CLI (``quip_tpu_torch/cli/bench.py``)
against ``quip_tpu.cli.bench`` on a quip_tpu-written 2-bit llama-tiny
checkpoint, on the CPU: the same JSON keys, the same flags and checks, and
a continuation nll within 1e-3 of quip_tpu's (f32 weights and a bf16 KV
cache in both; the nll is a mean over greedy steps that both take, so
only summation order separates them, about 1e-6 here)."""
import json

import pytest

from quip_tpu.cli import bench as jbench
from quip_tpu.pack import model as JPM
from quip_tpu_torch.cli import bench as tbench
from tests.test_torch_model import _llama_via_checkpoint

NLL_TOL = 1e-3


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench_ckpt"))
    _, jparams, _, _ = _llama_via_checkpoint(seed=8)
    JPM.save_checkpoint(path, jparams, {"model": "llama-tiny", "wbits": 2})
    return path


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", [
    [], ["--paged", "--hot", "8", "--page", "8"],
    ["--batch", "2", "--prefix", "5", "--kv_quant"]],
    ids=["arena", "paged", "arena-b2-prefix-int8"])
def test_bench_matches_quip_tpu(ckpt, capsys, mode):
    args = ["llama-tiny", "--load", ckpt, "--tokens", "8", "--max_seq",
            "48", "--check"] + mode
    jbench.main(args)
    want = _last_json(capsys.readouterr().out)
    got = tbench.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded {" in out
    assert _last_json(out) == got
    assert set(got) == set(want)
    for k in ("batch", "mesh", "kv_quant", "paged", "prefix"):
        assert got[k] == want[k], k
    assert abs(got["continuation_nll"] - want["continuation_nll"]) <= NLL_TOL
    assert got["tokens_per_sec"] > 0 and got["median_s_per_token_synced"] > 0


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"],
                                   ["--tokens", "40"]])
def test_bench_refusals(ckpt, capsys, flags):
    """A run past the cache stops as quip_tpu's does. The mesh flags run
    sharded on two gloo ranks (this process rank 0, the only one that
    prints) and match quip_tpu's sharded run on its virtual mesh: the same
    keys and mesh, the continuation nll within NLL_TOL."""
    args = ["llama-tiny", "--load", ckpt, "--max_seq", "48", "--tokens",
            "8"] + flags
    if flags[0] == "--tokens":
        with pytest.raises(SystemExit):
            tbench.main(args + ["--device", "cpu"])
        assert "raise --max_seq" in capsys.readouterr().err
        return
    args += ["--batch", "2", "--check"]
    jbench.main(args)
    want = _last_json(capsys.readouterr().out)
    got = tbench.main(args + ["--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == got
    assert set(got) == set(want) and got["mesh"] == want["mesh"]
    assert abs(got["continuation_nll"] - want["continuation_nll"]) <= NLL_TOL
