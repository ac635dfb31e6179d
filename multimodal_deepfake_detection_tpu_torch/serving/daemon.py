"""HTTP scoring daemon over :class:`~.batcher.MicroBatcher` engines.

Counterpart of ``multimodal_deepfake_detection_tpu/serving/daemon.py``.
Endpoints (all JSON responses):

* ``POST /v1/score/<engine>``: score ONE clip. The body is either
  ``application/json`` (payload arrays as nested lists, coerced to the
  engine's dtypes) or ``application/x-npz`` (an ``np.savez`` archive, the
  efficient binary path). Responds ``{"engine", "score", "latency_ms"}``.
* ``GET /healthz``: liveness and the engine list.
* ``GET /v1/stats``: per-engine batching and latency counters.

Requests are handled by a thread per connection (``ThreadingHTTPServer``);
concurrency is what gives the micro-batcher something to coalesce. The
card's work stays serialized inside each engine's dispatcher thread, so
its batches stay large instead of many and small.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Mapping, Optional

import numpy as np

from .batcher import MicroBatcher

__all__ = ["ServingDaemon"]

_MAX_BODY = 512 * 1024 * 1024  # refuse absurd uploads outright


class _Server(ThreadingHTTPServer):
    """A thread per connection, with a listen backlog for bursts. The
    socketserver default queues 5 connections: while the handler threads
    and the dispatcher hold the interpreter, a burst of clients overflows
    it, the kernel drops their SYNs, and each waits for TCP's 1 s
    retransmission (one request of a 16-thread burst read 1.0-1.4 s on the
    card, the rest under 0.1 s)."""

    request_queue_size = 1024


class ServingDaemon:
    """Serve one or more micro-batched engines over HTTP.

    ``engines`` maps route names (``visual``, ``audio``, ``au_face``,
    ``au_patch``, ``av``) to *started or unstarted* :class:`MicroBatcher`
    instances; ``start()`` starts them all plus the HTTP listener.
    """

    def __init__(self, engines: Mapping[str, MicroBatcher], host: str = "127.0.0.1", port: int = 8810):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines: Dict[str, MicroBatcher] = dict(engines)
        self.host, self.port = host, int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingDaemon":
        for b in self.engines.values():
            b.start()
        handler = _make_handler(self)
        self._httpd = _Server((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="serving-daemon")
        self._thread.start()
        self._t_start = time.monotonic()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for b in self.engines.values():
            b.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def warmup(self, engine: str, **payload) -> None:
        """Warm the (batch-bucket x time-bucket) grid for a payload shape:
        scores the example once per batch bucket, so live traffic never pays
        a first call's set-up (kernel builds, cuDNN's algorithm search, the
        allocator's first blocks)."""
        b = self.engines[engine]
        for bucket in b.batch_buckets:
            futs = [b.submit(**payload) for _ in range(bucket)]
            for f in futs:
                f.result(timeout=600)

    def stats(self) -> dict:
        return {
            "uptime_s": round(time.monotonic() - self._t_start, 1) if self._t_start else 0.0,
            "engines": {name: b.stats() for name, b in self.engines.items()},
        }


def _decode_body(handler: BaseHTTPRequestHandler) -> Mapping[str, np.ndarray]:
    length = int(handler.headers.get("Content-Length", 0))
    if length <= 0:
        raise ValueError("empty request body")
    if length > _MAX_BODY:
        raise ValueError(f"body too large ({length} bytes)")
    body = handler.rfile.read(length)
    ctype = (handler.headers.get("Content-Type") or "application/json").split(";")[0].strip()
    if ctype == "application/x-npz":
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    if ctype == "application/json":
        obj = json.loads(body)
        if not isinstance(obj, dict):
            raise ValueError("JSON body must be an object of named arrays")
        return {k: np.asarray(v) for k, v in obj.items()}
    raise ValueError(f"unsupported Content-Type {ctype!r}")


def _make_handler(daemon: ServingDaemon):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet by default; stats carry the signal
            pass

        def _reply(self, code: int, obj: dict) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "engines": sorted(daemon.engines)})
            elif self.path == "/v1/stats":
                self._reply(200, daemon.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if not self.path.startswith("/v1/score/"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            engine = self.path[len("/v1/score/"):]
            batcher = daemon.engines.get(engine)
            if batcher is None:
                self._reply(404, {"error": f"unknown engine {engine!r}", "engines": sorted(daemon.engines)})
                return
            t0 = time.monotonic()
            try:
                payload = _decode_body(self)
            except Exception as e:  # noqa: BLE001 — malformed client input
                self._reply(400, {"error": str(e)})
                return
            try:
                fut = batcher.submit(**payload)
            except ValueError as e:  # payload failed engine validation
                self._reply(400, {"error": str(e)})
                return
            try:
                score = fut.result(timeout=600)
            except Exception as e:  # noqa: BLE001 — engine-side failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(
                200,
                {
                    "engine": engine,
                    "score": score,
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                },
            )

    return Handler
