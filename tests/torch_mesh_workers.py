"""Rank workers of the port's parallel tests (tests/test_torch_engine_sharded.py,
test_torch_pipeline_pp.py, test_torch_mesh.py). Each rank is a process
started by ``parallel/mesh.py::run_ranks``, which imports this module by
name: it imports the port only. Every function here runs on every rank and
returns what the tests read (rank 0's value, or every rank's)."""
from __future__ import annotations

import dataclasses

import torch

from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.build import packed_model
from quip_tpu_torch.parallel import comm
from quip_tpu_torch.parallel import mesh as PM
from quip_tpu_torch.serve.engine import Engine
from quip_tpu_torch.serve.speculative import make_self_draft

REQS = [dict(prompt=[1, 2, 3], max_new_tokens=6),
        dict(prompt=[7, 5], max_new_tokens=6),
        dict(prompt=[9, 9, 2, 4], max_new_tokens=6)]
PREFIX = [5, 9, 3, 1]


def build(case: str):
    """(model, cfg) of an engine case, the same weights on every rank:
    packed models from ``packed_model``'s seed (llama-tiny with a packed
    head, as tests/test_torch_model.py::_llama_via_checkpoint makes it),
    dense ones from ``init_params``' seed."""
    name = {"opt": "opt-tiny", "bloom": "bloom-tiny"}.get(case,
                                                          "llama-tiny")
    cfg = get_config(name)
    if case.startswith("dense"):
        model = M.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
        return (M.fuse_params(model, cfg) if case == "dense_fused"
                else model), cfg
    bits = 3 if case == "3bit" else 2
    head = None if cfg.tie_word_embeddings else bits
    return packed_model(cfg, bits=bits, seed=0, dtype=torch.float32,
                        head_bits=head, device="cpu"), cfg


# case -> (Engine keyword arguments, run keyword arguments)
ENGINE_CASES = {
    "bf16": ({}, {}),
    "kv_int8": (dict(kv_quant=True), {}),
    "prefix": (dict(shared_prefix=PREFIX), {}),
    "3bit": ({}, {}),
    "spec": (dict(spec=1), {}),
    "spec_pump": (dict(spec=1), dict(chunked=True)),
    "pump": ({}, dict(chunked=True)),
    "opt": ({}, {}),
    "bloom": ({}, {}),
    "dense": ({}, {}),
    "dense_fused": ({}, {}),
}


def engine(case: str, mesh=None) -> Engine:
    model, cfg = build(case)
    kw = dict(ENGINE_CASES[case][0])
    if kw.pop("spec", None):
        kw.update(draft=make_self_draft(model, cfg, 1), spec_k=2)
    return Engine(model, cfg, max_batch=2, max_seq=64, hot=8, page=8,
                  paged=True, device="cpu", mesh=mesh, **kw)


def run_case(eng: Engine, case: str):
    return [r.generated for r in eng.run([dict(r) for r in REQS],
                                         **ENGINE_CASES[case][1])]


def engine_cases(dp: int, tp: int):
    """Every engine case on a (dp, tp) mesh: {case: (greedy tokens, the
    run's collectives counted by (kind, axis), the engine's mesh stats)},
    then the serial stream of one request (rank 0 streams, the others
    follow)."""
    from collections import Counter
    mesh = PM.make_mesh(dp=dp, tp=tp)
    out = {}
    for case in ENGINE_CASES:
        eng = engine(case, mesh)
        rep = comm.comm_report(run_case, (eng, case))
        out[case] = (rep["result"], dict(Counter(
            (c["kind"], c["axis"]) for c in rep["collectives"])),
            eng.stats()["mesh"])
    eng = engine("bf16", mesh)
    if eng.leader:
        streamed = list(eng.stream(**REQS[0]))
        eng.release_followers()
    else:
        eng.follow()
        streamed = None
    out["stream"] = streamed
    out["http"] = _http(engine("bf16", mesh))
    return out


def _http(eng: Engine):
    """Rank 0 serves HTTP (serve/server.py) and posts every request of
    REQS at once from threads of its own; the other ranks follow. Returns
    rank 0's tokens by request."""
    import json
    import threading
    import urllib.request
    from quip_tpu_torch.serve.server import serve_http
    if not eng.leader:
        eng.follow()
        return None
    httpd, loop = serve_http(eng, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    got = [None] * len(REQS)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(REQS[i]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got[i] = json.loads(r.read())["tokens"]

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(REQS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    httpd.shutdown()
    loop.shutdown()                  # releases the followers
    return got


def _pp_model():
    cfg = dataclasses.replace(get_config("llama-tiny"), n_layers=4,
                              dtype="float32")
    return M.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu"), cfg


def pipeline(pp: int, tp: int, tokens, microbatches):
    """pipelined_forward of the dense f32 4-layer llama-tiny of
    ``_pp_model`` on a pp (x tp) mesh at each of ``microbatches``:
    [(logits, per-kind collectives)]."""
    from quip_tpu_torch.parallel.pipeline import pipelined_forward
    model, cfg = _pp_model()
    if tp == 1:
        mesh = PM.make_pp_mesh(pp)
        stage = PM.shard_params_pp(model, cfg, mesh)
    else:
        mesh = PM.make_mesh_pp_tp(pp, tp)
        stage = PM.shard_params_pp_tp(model, cfg, mesh)
    out = []
    for mb in microbatches:
        rep = comm.comm_report(pipelined_forward,
                               (stage, torch.as_tensor(tokens), cfg, mesh,
                                mb))
        out.append((rep["result"], rep["per_kind"]))
    return out
