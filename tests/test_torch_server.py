"""The port's HTTP front end (serve/server.py) and serving CLI
(cli/serve.py) on llama-tiny, 2-bit packed, all f32 on the CPU.

The loopback cases of tests/test_server.py, on a spec engine (a one-layer
self-draft): greedy tokens over HTTP must equal ``Engine.run``'s of the
same requests on the same engine. The CLI reads a quip_tpu checkpoint and
must print quip_tpu's CLI's completions (greedy, with and without
``--self_draft 1``, and on the slot arena with ``--no_paged``)."""
import json
import threading
import urllib.error
import urllib.request

import pytest

from quip_tpu.cli import serve as jcli
from quip_tpu.models import get_config as jget_config
from quip_tpu.pack import model as JPM
from quip_tpu_torch.cli import serve as tcli
from quip_tpu_torch.serve.engine import Engine
from quip_tpu_torch.serve.server import serve_http
from quip_tpu_torch.serve.speculative import make_self_draft
from tests.test_torch_model import _both, _jax_packed_llama


@pytest.fixture(scope="module")
def http_server():
    _, _, tcfg, tparams = _both(seed=3)
    eng = Engine(tparams, tcfg, max_batch=2, max_seq=64, hot=16, page=8,
                 draft=make_self_draft(tparams, tcfg, 1), spec_k=2,
                 paged=True, device="cpu")
    httpd, loop = serve_http(eng, port=0)          # port 0: any free port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    ref = Engine(tparams, tcfg, max_batch=2, max_seq=64, hot=16, page=8,
                 draft=make_self_draft(tparams, tcfg, 1), spec_k=2,
                 paged=True, device="cpu")
    yield eng, ref, httpd.server_address[1]
    httpd.shutdown()
    loop.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(port, body, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _run_tokens(ref, reqs):
    return [r.generated for r in ref.run([dict(q) for q in reqs],
                                         chunked=True)]


def test_http_generate_greedy(http_server):
    _, ref, port = http_server
    code, out = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 5})
    assert code == 200, out
    assert out["tokens"] == _run_tokens(
        ref, [dict(prompt=[1, 2, 3], max_new_tokens=5)])[0]


def test_http_concurrent_requests(http_server):
    """Four greedy and two sampled requests at once on a two-slot engine;
    the greedy ones get Engine.run's tokens."""
    _, ref, port = http_server
    results = {}
    bodies = [{"prompt": [i + 1, i + 2], "max_new_tokens": 6}
              for i in range(4)]
    bodies += [{"prompt": [9, 9], "max_new_tokens": 4, "temperature": 0.7,
                "top_p": 0.9}] * 2

    def go(i):
        results[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert all(results[i][0] == 200 for i in range(len(bodies))), results
    for i in range(4):
        assert results[i][1]["tokens"] == _run_tokens(
            ref, [dict(prompt=bodies[i]["prompt"], max_new_tokens=6)])[0]
    assert all(len(results[i][1]["tokens"]) == 5 for i in (4, 5))


def test_http_health_and_errors(http_server):
    _, _, port = http_server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok"
    assert _post(port, {"prompt": []})[0] == 400
    assert _post(port, {"text": "hi"})[0] == 400      # no tokenizer loaded
    code, out = _post(port, {"prompt": [1], "top_p": 0.0})
    assert code == 400 and "top_p" in out["error"]
    code, out = _post(port, {"prompt": [1], "use_prefix": True})
    assert code == 400 and "shared_prefix" in out["error"]
    assert _post(port, {"prompt": [1]}, path="/nope")[0] == 404


def test_http_stop_tokens(http_server):
    _, ref, port = http_server
    gen = _run_tokens(ref, [dict(prompt=[1, 2, 3], max_new_tokens=6)])[0]
    code, out = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                             "stop": [gen[2]]})
    assert code == 200
    assert out["tokens"] == gen[:gen.index(gen[2]) + 1]


def test_http_streaming(http_server):
    """stream=true: one {"token": id} line per emitted token, then the full
    result; they equal the batch result. A bad request streams one error
    line."""
    _, ref, port = http_server

    def stream(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(dict(body, stream=True)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            return [json.loads(ln) for ln in r.read().splitlines()]

    *toks, final = stream({"prompt": [1, 2, 3], "max_new_tokens": 5})
    assert [t["token"] for t in toks] == final["tokens"]
    assert final["tokens"] == _run_tokens(
        ref, [dict(prompt=[1, 2, 3], max_new_tokens=5)])[0]
    lines = stream({"prompt": [1], "top_p": 0.0})
    assert len(lines) == 1 and "error" in lines[0]


def test_http_metrics(http_server):
    eng, _, port = http_server
    _post(port, {"prompt": [9, 9], "max_new_tokens": 3})
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        m = json.loads(r.read())
    assert m["completed"] >= 1 and m["tokens"] >= 3
    assert m["mean_request_s"] >= m["mean_ttft_s"] >= 0.0
    assert 1.0 <= m["spec_emitted_mean"] <= 2.0
    assert len(m["spec_emitted_hist"]) == eng.spec_k + 1


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """quip_tpu's packed 2-bit llama-tiny, saved by quip_tpu."""
    path = str(tmp_path_factory.mktemp("serve_ckpt"))
    JPM.save_checkpoint(path, _jax_packed_llama(jget_config("llama-tiny"),
                                                seed=6),
                        {"model": "llama-tiny", "wbits": 2})
    return path


def _completions(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("extra", [[], ["--self_draft", "1"]])
def test_serve_cli_matches_quip_tpu(ckpt, capsys, monkeypatch, extra):
    """The same checkpoint, prompts and flags through both CLIs (the byte
    tokenizer: no Hugging Face files here): the same completions. Token by
    token (``--no_chunked``), where quip_tpu compiles least; the pump's
    tokens are held to the serial loop's in tests/test_torch_spec_pump.py."""
    monkeypatch.setenv("QUIP_TPU_HF_ONLINE", "0")
    args = (["llama-tiny", "--load", ckpt, "--max_batch", "2",
             "--max_seq", "64", "--hot", "16", "--page", "8",
             "--max_new_tokens", "12", "--spec_k", "2", "--prompt", "Hi",
             "--prompt", "quip", "--prompt", "a longer prompt",
             "--no_chunked"] + extra)
    jcli.main(args + ["--no_compile_cache"])
    want = _completions(capsys.readouterr().out)
    reqs = tcli.main(args + ["--device", "cpu", "--warmup"])
    got = _completions(capsys.readouterr().out)
    assert got == want and len(got) == 3
    assert [len(r.generated) for r in reqs] == [13] * 3
    assert reqs[0].prompt.tolist() == [1 + ord(c) for c in "Hi"]


def test_serve_cli_stop_eos(ckpt):
    """--stop_eos stops at the tokenizer's end-of-text id (the byte
    tokenizer's 0) beside the --stop_token ids."""
    reqs = tcli.main(["llama-tiny", "--load", ckpt, "--device", "cpu",
                      "--max_seq", "64", "--max_new_tokens", "3",
                      "--stop_token", "7", "--stop_eos", "--no_chunked"])
    assert reqs[0].stop == [7, 0]


@pytest.mark.parametrize("model", ["opt-tiny", "bloom-tiny"])
def test_serve_cli_default_max_seq(model, capsys):
    """The default --max_seq (512) serves every family: OPT's engine is
    capped at its learned position table (128 rows for opt-tiny), which
    quip_tpu's gather would run past; ALiBi has no table to cap at."""
    reqs = tcli.main([model, "--device", "cpu", "--max_new_tokens", "3",
                      "--prompt", "Hi", "--no_chunked"])
    err = capsys.readouterr().err
    assert len(reqs[0].generated) == 4
    assert ("capped at 128" in err) == (model == "opt-tiny"), err


def test_serve_cli_no_paged_matches_quip_tpu(ckpt, capsys, monkeypatch):
    """``--no_paged`` serves from the slot arena: the completions of
    quip_tpu's CLI with the same flags (its arena, token by token), through
    the port's chunked arena loop."""
    monkeypatch.setenv("QUIP_TPU_HF_ONLINE", "0")
    args = ["llama-tiny", "--load", ckpt, "--max_batch", "2", "--max_seq",
            "64", "--max_new_tokens", "12", "--prompt", "Hi", "--prompt",
            "quip", "--prompt", "a longer prompt", "--no_paged"]
    jcli.main(args + ["--no_chunked", "--no_compile_cache"])
    want = _completions(capsys.readouterr().out)
    reqs = tcli.main(args + ["--device", "cpu"])
    got = _completions(capsys.readouterr().out)
    assert got == want and len(got) == 3
    assert [len(r.generated) for r in reqs] == [13] * 3


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"],
                                   ["--self_draft", "1", "--spec_draft", "x"],
                                   ["--tp", "2", "--no_paged"]])
def test_serve_cli_refuses_unported_flags(flags, ckpt, capsys, monkeypatch):
    """Conflicting flags stop with quip_tpu's errors (two drafts; a mesh
    on the slot arena). --tp 2 / --dp 2 serve on two gloo ranks (this
    process rank 0, the only one that prints) and print the completions
    of quip_tpu's CLI with the same flags on its virtual mesh."""
    monkeypatch.setenv("QUIP_TPU_HF_ONLINE", "0")
    if "--self_draft" in flags or "--no_paged" in flags:
        with pytest.raises(SystemExit):
            tcli.main(["llama-tiny", "--device", "cpu"] + flags)
        err = capsys.readouterr().err
        assert "mutually exclusive" in err or "incompatible" in err
        return
    args = ["llama-tiny", "--load", ckpt, "--max_batch", "2", "--max_seq",
            "64", "--max_new_tokens", "8", "--prompt", "Hi", "--prompt",
            "quip", "--prompt", "a longer prompt"] + flags
    jcli.main(args + ["--no_chunked", "--no_compile_cache"])
    want = _completions(capsys.readouterr().out)
    reqs = tcli.main(args + ["--device", "cpu"])
    got = _completions(capsys.readouterr().out)
    assert got == want and len(got) == 3
    assert [len(r.generated) for r in reqs] == [9] * 3
