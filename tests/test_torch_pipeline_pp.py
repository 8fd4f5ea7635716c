"""The port's GPipe forward (parallel/pipeline.py) against quip_tpu's.

One spawn per mesh shape (gloo ranks on the CPU; workers in
tests/torch_mesh_workers.py): pp = 2, and pp = 2 x tp = 2 (each stage's
linears Megatron-sharded within it), each at M = 2 and 4 micro-batches, on
a dense f32 4-layer llama-tiny. quip_tpu's ``pipelined_forward`` runs the
same weights (read back from a checkpoint the port wrote) on its virtual
CPU mesh. Tolerance: 2e-4, quip_tpu's own pipelined-against-scan limit
in f32 (tests/test_pipeline_pp.py); the two packages order their f32 sums
differently, and tp adds an all-reduce's.
"""
import tempfile

import jax
import numpy as np
import pytest

import torch_mesh_workers as W
from quip_tpu.models import get_config as jget_config
from quip_tpu.pack import model as JPM
from quip_tpu.parallel import mesh as JPMESH
from quip_tpu.parallel.pipeline import pipelined_forward as jpipelined
from quip_tpu_torch.pack import model as TPM
from quip_tpu_torch.parallel import mesh as PM
from quip_tpu_torch.parallel.pipeline import pipeline_comm_bytes

MICRO = (2, 4)
TOL = 2e-4


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 512, (4, 16))


@pytest.fixture(scope="module")
def want(tokens):
    """quip_tpu's pipelined logits (pp = 2) on the port's weights."""
    import dataclasses
    model, _ = W._pp_model()
    with tempfile.TemporaryDirectory() as path:
        TPM.save_checkpoint(path, model, {"model": "llama-tiny"})
        jparams, _ = JPM.load_checkpoint(path)
    jcfg = dataclasses.replace(jget_config("llama-tiny"), n_layers=4,
                               dtype="float32")
    mesh = JPMESH.make_pp_mesh(2)
    return {mb: np.asarray(jpipelined(jparams, jax.numpy.asarray(tokens),
                                      jcfg, mesh, microbatches=mb))
            for mb in MICRO}


@pytest.fixture(scope="module")
def pp2(tokens):
    return PM.run_ranks(W.pipeline, 2, (2, 1, tokens, MICRO),
                        timeout_s=180)


@pytest.fixture(scope="module")
def pp2tp2(tokens):
    return PM.run_ranks(W.pipeline, 4, (2, 2, tokens, MICRO),
                        timeout_s=180)


@pytest.mark.parametrize("mb", MICRO)
@pytest.mark.parametrize("shape", ["pp2", "pp2tp2"])
def test_pipelined_forward_matches_quip_tpu(request, want, shape, mb):
    """Every rank returns quip_tpu's logits within the f32 tolerance."""
    ranks = request.getfixturevalue(shape)
    i = MICRO.index(mb)
    for r in ranks:
        np.testing.assert_allclose(r[i][0].numpy(), want[mb], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mb", MICRO)
def test_pipeline_hops(pp2, mb):
    """Stage 0 sends M hops, stage 1 receives them, the last stage
    broadcasts the hidden states: M of the GPipe model's M + pp - 1 ticks
    a link (pipeline_comm_bytes, copied from quip_tpu)."""
    cfg = W._pp_model()[1]
    model = pipeline_comm_bytes(cfg, 4, 16, mb, 2, dtype_bytes=4)
    i = MICRO.index(mb)
    send, recv = pp2[0][i][1]["send"], pp2[1][i][1]["recv"]
    assert send["count"] == recv["count"] == mb
    assert send["bytes"] == recv["bytes"] == mb * model["hop_bytes"]
    assert send["wire_bytes"] == mb * model["hop_bytes"]
    assert model["ticks"] == mb + 1
    assert "send" not in pp2[1][i][1] and "recv" not in pp2[0][i][1]
    assert pp2[0][i][1]["broadcast"]["count"] == 1
