"""HTTP front end over the continuous-batching Engine (port of
``quip_tpu/serve/server.py``).

One worker thread owns the Engine (it is not thread-safe: every device
call, graph replay included, runs on that thread); HTTP handlers submit
requests through a queue and wait on per-request events. Stdlib only
(http.server). A sharded engine (``Engine(mesh=)``) serves from rank 0:
its loop runs each operation through ``Engine.lead``, which broadcasts the
newly admitted requests to the other ranks (``Engine.follow``), and a
heartbeat while idle; ``shutdown`` releases them.

API:
    GET  /health            -> {"status": "ok", "active": n, "queued": m}
    GET  /metrics           -> Engine.stats() JSON
    POST /generate          -> JSON body:
        {"prompt": [int, ...] | "text": str,   # token ids or raw text
         "max_new_tokens": int, "temperature": float, "top_k": int,
         "top_p": float, "stop": [int, ...], "use_prefix": bool,
         "stream": bool}
      response: {"tokens": [...], "text": str|null, "uid": int}
      stream=true: NDJSON, one {"token": id} line per emitted token as it
      decodes, then the final full-result line
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from quip_tpu_torch.serve.engine import Engine


class EngineLoop:
    """Owns the Engine on a single worker thread; thread-safe submit."""

    def __init__(self, engine: Engine, tokenizer=None, chunked: bool = True,
                 overlap: bool = True, max_chunk=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.chunked = chunked
        self.overlap = overlap
        # None = the engine's per-mode default (16 plain / S=min(8,
        # hot//2K) spec iterations — Engine._default_max_chunk)
        self.max_chunk = max_chunk
        self._inbox: "queue.Queue" = queue.Queue()
        self._events: dict = {}           # uid -> (Event, Request)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False

    def start(self):
        self._started = True
        self._thread.start()

    def shutdown(self):
        self._stop.set()
        if self._started:
            self._thread.join(timeout=30)
        self.engine.release_followers()

    def submit(self, stream: bool = False, **kw):
        """Thread-safe: enqueue a request; returns (uid_future_event,
        result_holder). Call from any thread.

        stream=True additionally puts a Queue at holder["stream"]: the
        engine thread pushes each new token id as it is emitted, then the
        sentinel None when the request retires (read tokens from the
        queue; the final full list still lands in holder["tokens"])."""
        ev = threading.Event()
        holder: dict = {}
        if stream:
            holder["stream"] = queue.Queue()
        self._inbox.put((kw, ev, holder))
        return ev, holder

    def counts(self):
        eng = self.engine
        with self._lock:
            active = sum(s is not None for s in eng._slots)
            queued = len(eng._queue) + self._inbox.qsize()
        return active, queued

    def _drain_inbox(self):
        while True:
            try:
                kw, ev, holder = self._inbox.get_nowait()
            except queue.Empty:
                return
            try:
                uid = self.engine.submit_shared(**kw)
            except (ValueError, TypeError) as e:      # bad request
                holder["error"] = str(e)
                if "stream" in holder:
                    holder["stream"].put(None)
                ev.set()
                continue
            req = next(r for r in self.engine._queue if r.uid == uid)
            self._events[uid] = (ev, req, holder, [0])

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                self._drain_inbox()
                # _pending: a dispatched-but-uncommitted chunk from the
                # overlapped pump loop — the loop must keep pumping until
                # it is committed even if every slot just retired
                busy = (any(s is not None for s in self.engine._slots)
                        or self.engine._queue
                        or bool(self.engine._pending_q))
                if busy:
                    if self.chunked and self.overlap:
                        # overlapped double-buffered scheduling: the host
                        # read of chunk N runs while chunk N+1 executes
                        self.engine.lead("pump", self.max_chunk)
                    elif self.chunked:
                        self.engine.lead(
                            "step_chunk", self.max_chunk
                            or self.engine._default_max_chunk())
                    else:
                        self.engine.lead("step")
                else:
                    self.engine.keepalive()
                done = []
                for uid, (_, r, h, sent) in self._events.items():
                    if "stream" in h:           # push newly emitted tokens
                        while sent[0] < len(r.generated):
                            h["stream"].put(r.generated[sent[0]])
                            sent[0] += 1
                    if r.done:
                        done.append(uid)
                for uid in done:
                    ev, req, holder, _ = self._events.pop(uid)
                    holder["tokens"] = list(req.generated)
                    holder["uid"] = uid
                    if "stream" in holder:
                        holder["stream"].put(None)      # end-of-stream
                    ev.set()
            if not busy:
                # idle: park briefly so submits wake us promptly
                self._stop.wait(0.005)


def make_handler(loop: EngineLoop, timeout_s: float = 600.0):
    tokenizer = loop.tokenizer

    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the engine loop is the interesting log
        def log_message(self, *a):     # noqa: N802
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):              # noqa: N802
            if self.path == "/health":
                active, queued = loop.counts()
                return self._json(200, {"status": "ok", "active": active,
                                        "queued": queued})
            if self.path == "/metrics":
                with loop._lock:
                    stats = loop.engine.stats()
                return self._json(200, stats)
            return self._json(404, {"error": "not found"})

        def do_POST(self):             # noqa: N802
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body.get("prompt")
                if prompt is None and "text" in body:
                    if tokenizer is None:
                        return self._json(400,
                                          {"error": "no tokenizer loaded; "
                                                    "send token ids in "
                                                    "'prompt'"})
                    prompt = tokenizer.encode(body["text"])
                if not prompt:
                    return self._json(400, {"error": "empty prompt"})
                kw = dict(prompt=prompt,
                          max_new_tokens=int(body.get("max_new_tokens", 32)),
                          temperature=float(body.get("temperature", 0.0)),
                          top_k=int(body.get("top_k", 0)),
                          top_p=float(body.get("top_p", 1.0)),
                          stop=body.get("stop"))
                if "use_prefix" in body:
                    kw["use_prefix"] = bool(body["use_prefix"])
                stream = bool(body.get("stream", False))
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            ev, holder = loop.submit(stream=stream, **kw)
            if stream:
                return self._stream_response(holder)
            if not ev.wait(timeout_s):
                return self._json(504, {"error": "generation timed out"})
            if "error" in holder:
                return self._json(400, {"error": holder["error"]})
            toks = holder["tokens"]
            text = tokenizer.decode(toks) if tokenizer is not None else None
            self._json(200, {"tokens": toks, "text": text,
                             "uid": holder["uid"]})

        def _stream_response(self, holder):
            """NDJSON token stream: one {"token": id} line per emitted
            token as it decodes, then a final line with the full result
            (or {"error": ...}). No Content-Length — the connection close
            delimits the body (HTTP/1.0 semantics of http.server)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            q = holder["stream"]
            while True:
                try:
                    tok = q.get(timeout=timeout_s)
                except queue.Empty:
                    self.wfile.write(
                        json.dumps({"error": "generation timed out"})
                        .encode() + b"\n")
                    return
                if tok is None:
                    break
                self.wfile.write(
                    json.dumps({"token": int(tok)}).encode() + b"\n")
                self.wfile.flush()
            if "error" in holder:
                final = {"error": holder["error"]}
            else:
                toks = holder["tokens"]
                final = {"tokens": toks, "uid": holder["uid"],
                         "text": (tokenizer.decode(toks)
                                  if tokenizer is not None else None)}
            self.wfile.write(json.dumps(final).encode() + b"\n")

    return Handler


def serve_http(engine: Engine, host: str = "127.0.0.1", port: int = 8000,
               tokenizer=None, chunked: bool = True, overlap: bool = True,
               max_chunk=None) -> tuple:
    """Start the engine loop + HTTP server. Returns (httpd, loop); call
    httpd.shutdown() and loop.shutdown() to stop. Blocking callers can
    invoke httpd.serve_forever() themselves via the returned object."""
    loop = EngineLoop(engine, tokenizer=tokenizer, chunked=chunked,
                      overlap=overlap, max_chunk=max_chunk)
    loop.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(loop))
    return httpd, loop
