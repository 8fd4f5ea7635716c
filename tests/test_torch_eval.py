"""Windowed perplexity and the eval CLIs against quip_tpu (llama-tiny, CPU).

The same numpy-seeded windows go through ``quip_tpu.eval.ppl`` and the
port's ``eval/ppl.py``: on a dense f32 model carried across by
``convert.params_from_numpy`` (relative 1e-5 on the ppl: both sum f32
cross-entropies, the port's from ``F.cross_entropy``, quip_tpu's from a
gathered log-softmax), and on a packed 2-bit checkpoint written by
quip_tpu (relative 1e-4: the packed linears' plain dequant-matmul and
RHTs round in another order than the Pallas path's reference). The port's
``cli/eval`` reads that checkpoint and prints quip_tpu's ppl within the
same 1e-4; ``cli/quantize --eval`` prints the ppl of the dense quantized
model it returns."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.cli import eval as jecli
from quip_tpu.data.calib import get_synthetic
from quip_tpu.eval import ppl as JPPL
from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.pack import model as JPM
from quip_tpu_torch.cli import eval as ecli
from quip_tpu_torch.cli import quantize as qcli
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.eval import ppl as PPL
from quip_tpu_torch.models import get_config
from quip_tpu_torch.pack import model as TPM
from tests.test_torch_model import _jax_packed_llama

SEQLEN = 32
DENSE_RTOL = 1e-5
PACKED_RTOL = 1e-4


@pytest.fixture(scope="module")
def dense():
    """quip_tpu's random f32 llama-tiny and the port's copy of it."""
    cfg = jget_config("llama-tiny")
    jp = JM.init_params(jax.random.key(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config(
        "llama-tiny"), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """quip_tpu's packed 2-bit llama-tiny (random codes, real RHT
    rotations, fused, packed head; made by `_jax_packed_llama` of
    tests/test_torch_model.py, which runs no quantizer): its params, the
    port's load of its checkpoint, and the directory."""
    jp = _jax_packed_llama(jget_config("llama-tiny"), seed=2)
    path = str(tmp_path_factory.mktemp("eval_ckpt"))
    JPM.save_checkpoint(path, jp, {"model": "llama-tiny", "wbits": 2})
    tp = params_from_numpy(TPM.load_checkpoint(path)[0],
                           get_config("llama-tiny"), device="cpu")
    return jp, tp, path


def _stream(n_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, n_tokens).astype(np.int32)


def _rel(got, want):
    return abs(got - want) / abs(want)


def test_window_nll_matches(dense):
    jp, tp = dense
    toks = _stream(3 * SEQLEN).reshape(3, SEQLEN)
    want = np.asarray(JPPL.window_nll(jp, jnp.asarray(toks),
                                      jget_config("llama-tiny")))
    got = PPL.window_nll(tp, torch.from_numpy(toks.astype(np.int64)),
                         get_config("llama-tiny"))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=DENSE_RTOL)


# 7 windows and a ragged tail: batch 3 leaves a last batch of one window
# (two pad rows), batch 7 none, batch 8 one short batch
@pytest.mark.parametrize("model", ["dense", "packed"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_perplexity_matches(request, model, batch):
    jp, tp = request.getfixturevalue(model)[:2]
    stream = _stream(7 * SEQLEN + 11, seed=batch)
    want = JPPL.perplexity(jp, jget_config("llama-tiny"), stream, SEQLEN,
                           batch=batch)
    got = PPL.perplexity(tp, get_config("llama-tiny"), stream, SEQLEN,
                         batch=batch)
    assert np.isfinite(got) and got > 1
    assert _rel(got, want) <= (DENSE_RTOL if model == "dense"
                               else PACKED_RTOL), (got, want)


def test_perplexity_batch_drops_pad_rows(dense):
    """The pad rows of a short last batch add nothing: batch 3 over 7
    windows gives batch 1's ppl."""
    _, tp = dense
    cfg = get_config("llama-tiny")
    stream = _stream(7 * SEQLEN)
    one = PPL.perplexity(tp, cfg, stream, SEQLEN, batch=1)
    assert _rel(PPL.perplexity(tp, cfg, stream, SEQLEN, batch=3), one) <= 1e-6


def _printed_ppl(out: str) -> float:
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["dataset"] == "synthetic"
    return rec["ppl"]


def test_eval_cli_matches_quip_tpu(packed, capsys):
    _, _, path = packed
    args = ["llama-tiny", "synthetic", "--nsamples", "8", "--seqlen", "64",
            "--load", path, "--batch", "8"]
    jecli.main(args + ["--no_compile_cache"])
    want = _printed_ppl(capsys.readouterr().out)
    got = ecli.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded {'model': 'llama-tiny', 'wbits': 2}" in out
    assert _printed_ppl(out) == got
    assert np.isfinite(got) and _rel(got, want) <= PACKED_RTOL, (got, want)


def test_eval_cli_load_draws_no_random_model(packed, monkeypatch):
    """With --load the CLI builds cfg alone: init_params is never called."""
    from quip_tpu_torch.models import model as TM

    def refuse(*a, **kw):
        raise AssertionError("init_params called under --load")

    monkeypatch.setattr(TM, "init_params", refuse)
    ppl = ecli.main(["llama-tiny", "synthetic", "--nsamples", "1",
                     "--seqlen", "64", "--load", packed[2], "--device",
                     "cpu", "--batch", "16"])
    assert np.isfinite(ppl)


@pytest.mark.parametrize("proxy_only", [False, True])
def test_quantize_cli_eval(capsys, proxy_only):
    newp, _ = qcli.main(
        ["llama-tiny", "synthetic", "--wbits", "2", "--quant", "ldlq",
         "--incoh_processing", "--nsamples", "8", "--seqlen", "64",
         "--eval", "--device", "cpu"]
        + (["--proxy_only"] if proxy_only else []))
    out = capsys.readouterr().out
    if proxy_only:
        assert '"ppl"' not in out
        return
    got = _printed_ppl(out)
    _, test_stream = get_synthetic(8, 0, 64, 512)
    want = PPL.perplexity(newp, newp.cfg, test_stream, 64)
    assert np.isfinite(got) and _rel(got, want) <= 1e-12, (got, want)


@pytest.mark.parametrize("B", [2048, 4 * 2048])
def test_window_rows_take_unsplit_k1_tile(B):
    """A 2048-token window (and a batch of 4) sends each of Llama-2-7B's
    packed linears to K1-tile with one fan-in split on an H100's 132 SMs,
    so no (splits, B, m_p) f32 scratch is allocated at these rows."""
    from quip_tpu_torch.kernels import dequant_matmul as DM
    from quip_tpu_torch.pack.format import padded_m
    for m, d in [(12288, 4096), (4096, 4096), (22528, 4096), (4096, 11008),
                 (32000, 4096)]:
        m_p = padded_m(m, d, 2)
        assert DM.route(B, d, m_p, 2) == "tile"
        assert DM._tile_plan(B, d, m_p, 2, 132) == (64, 8, 1), (m, d)
