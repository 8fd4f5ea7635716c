"""The port's sharded serving engine (``Engine(mesh=)``) against quip_tpu's.

One spawn of four gloo ranks on the CPU (dp = 2 x tp = 2; the workers are
tests/torch_mesh_workers.py) serves every case; meanwhile this process
runs the same requests through the port's unsharded paged engine and
quip_tpu's unsharded and ``make_mesh(2, 2)`` engines (on its virtual
8-device CPU mesh) on the same weights, read back from a checkpoint the
port wrote. Greedy tokens must be equal, as tests/test_engine_sharded.py
asserts for quip_tpu: 2-bit llama-tiny (bf16 and int8 KV, the shared
prefix, 3-bit widened at load, the speculative draft, the pump), opt-tiny
and bloom-tiny (biases, ALiBi heads over tp) and dense llama-tiny
(Megatron's all-reduce; its fused form split part by part).
"""
import tempfile
import threading

import pytest
import torch

import torch_mesh_workers as W
from quip_tpu.models import get_config as jget_config
from quip_tpu.pack import model as JPM
from quip_tpu.parallel.mesh import make_mesh as jmake_mesh
from quip_tpu.serve.engine import Engine as JEngine
from quip_tpu.serve.speculative import make_self_draft as jmake_self_draft
from quip_tpu_torch.pack import model as TPM
from quip_tpu_torch.parallel import mesh as PM
from quip_tpu_torch.serve.engine import Engine

# quip_tpu's engines compared: unsharded for the llama-tiny cases, and
# make_mesh(2, 2) for bf16 and int8 KV (its own tests/test_engine_sharded.py
# holds its sharded prefix, 3-bit and spec engines to its unsharded ones;
# each of its engines compiles for 4-11 s here)
JAX_PLAIN = ("bf16", "kv_int8", "prefix", "3bit", "spec")
JAX_MESH = ("bf16", "kv_int8")


def _jax_engine(case, mesh=None):
    model, _ = W.build(case)
    with tempfile.TemporaryDirectory() as path:
        TPM.save_checkpoint(path, model, {"model": "llama-tiny"})
        jparams, _ = JPM.load_checkpoint(path)
    jcfg = jget_config("llama-tiny")
    kw = dict(W.ENGINE_CASES[case][0])
    if kw.pop("spec", None):
        kw.update(draft=jmake_self_draft(jparams, jcfg, 1), spec_k=2)
    return JEngine(jparams, jcfg, max_batch=2, max_seq=64, paged=True,
                   hot=8, page=8, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def runs():
    """The ranks' results (every rank's), the port's unsharded tokens and
    quip_tpu's, by case. The spawn runs in a thread while the references
    are computed here."""
    box = {}

    def spawn():
        try:
            box["ranks"] = PM.run_ranks(W.engine_cases, 4, (2, 2),
                                        timeout_s=300)
        except BaseException as e:     # re-raised below, on this thread
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    try:
        plain = {c: W.run_case(W.engine(c), c) for c in W.ENGINE_CASES}
        jax_plain = {c: W.run_case(_jax_engine(c), c) for c in JAX_PLAIN}
        jax_mesh = {c: W.run_case(_jax_engine(c, jmake_mesh(dp=2, tp=2)), c)
                    for c in JAX_MESH}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return dict(ranks=box["ranks"], plain=plain, jax_plain=jax_plain,
                jax_mesh=jax_mesh)


@pytest.mark.parametrize("case", list(W.ENGINE_CASES))
def test_sharded_engine_tokens(runs, case):
    """Every rank emits the unsharded engines' greedy tokens."""
    got = [r[case][0] for r in runs["ranks"]]
    assert all(g == got[0] for g in got)
    assert got[0] == runs["plain"][case]
    if case in runs["jax_plain"]:
        assert got[0] == runs["jax_plain"][case]
    if case in runs["jax_mesh"]:
        assert got[0] == runs["jax_mesh"][case]
    assert runs["ranks"][0][case][2] == dict(
        dp=2, tp=2, backend="gloo", chunks="eager (gloo)")


@pytest.mark.parametrize("case,kind,per_layer", [
    ("bf16", "all-gather", 5), ("opt", "all-gather", 5),
    ("dense", "all-reduce", 2), ("dense_fused", "all-reduce", 2)])
def test_sharded_engine_collectives(runs, case, kind, per_layer):
    """The design's collectives over tp: a packed block's 5 all-gathers
    (qkv, attention output, wo, gate-up, wd), a dense block's 2
    all-reduces (after wo and after the down projection) and no tp
    all-gather; every forward runs whole layers of them."""
    counts = runs["ranks"][0][case][1]
    n = W.build(case)[1].n_layers
    tp = counts.get((kind, "tp"), 0)
    assert tp > 0 and tp % (per_layer * n) == 0, counts
    if kind == "all-reduce":
        assert ("all-gather", "tp") not in counts, counts
    # each step gathers the hidden states over dp once
    assert counts.get(("all-gather", "dp"), 0) > 0, counts


def test_sharded_engine_stream(runs):
    """Engine.stream on rank 0 with the other ranks following: the same
    tokens as the serial run."""
    assert runs["ranks"][0]["stream"] == runs["plain"]["bf16"][0]


def test_sharded_engine_http(runs):
    """The HTTP front end on rank 0 of the mesh (the other ranks follow
    its loop): concurrent requests get the serial run's tokens (greedy
    tokens do not depend on which requests share a step)."""
    assert runs["ranks"][0]["http"] == runs["plain"]["bf16"]


def test_engine_mesh_checks():
    """quip_tpu's three divisibility checks, with its messages, on
    virtual meshes (no process group)."""
    model, cfg = W.build("bf16")
    with pytest.raises(ValueError, match="max_batch=3 must be divisible"):
        Engine(model, cfg, max_batch=3, max_seq=64, device="cpu",
               mesh=PM.make_mesh(2, 2, rank=0, device="cpu"))
    with pytest.raises(ValueError, match="kv_heads=4 must be divisible"):
        Engine(model, cfg, max_batch=2, max_seq=64, device="cpu",
               mesh=PM.make_mesh(1, 3, rank=0, device="cpu"))
    with pytest.raises(ValueError, match="draft kv_heads"):
        import dataclasses
        dcfg = dataclasses.replace(cfg, n_kv_heads=1)
        Engine(model, cfg, max_batch=2, max_seq=64, device="cpu",
               mesh=PM.make_mesh(1, 2, rank=0, device="cpu"),
               draft=(model, dcfg))


def test_engine_mesh_raises_without_card():
    """A mesh on the card is the default: with no card it raises unless
    the ranks run on the CPU. Engine(mesh=) keeps its own device: a CPU
    mesh does not move an engine asked for the card to the CPU, and a
    device other than the mesh's raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.init_distributed(device="cuda", rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh(1, 1, rank=0)
    model, cfg = W.build("bf16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, cfg, max_batch=2, max_seq=64,
               mesh=PM.make_mesh(1, 1, rank=0, device="cpu"))
    with pytest.raises(ValueError, match="not the mesh's device"):
        Engine(model, cfg, max_batch=2, max_seq=64, device="cpu",
               mesh=PM.make_mesh(1, 1, rank=0, device="meta"))
    eng = Engine(model, cfg, max_batch=2, max_seq=64, device="cpu",
                 mesh=PM.make_mesh(1, 1, rank=0, device="cpu"))
    assert eng.device.type == "cpu" and eng.paged
