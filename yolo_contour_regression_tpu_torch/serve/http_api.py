"""Standard-library HTTP front end for ``InferenceServer`` (counterpart of
the JAX package's ``serve/http_api.py``).

- ``POST /predict``: the body is an encoded image (JPEG or PNG, decoded by
  ``data/imcodec.py``, byte-equal to ``cv2.imdecode``); the reply is
  ``{"results": <Results.tojson()>, "speed_ms": ...}``, 400 with the reason
  on an empty body or an image that cannot be decoded.
- ``GET /stats``: ``InferenceServer.stats()``.
- ``GET /healthz``: 200 while the dispatcher thread lives, else 503.

Request threads (``ThreadingHTTPServer``) all feed the server's one
dispatcher, so HTTP concurrency becomes batch fill.
"""
from __future__ import annotations

import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..data.imcodec import imdecode
from .server import InferenceServer

LOGGER = logging.getLogger(__name__)


def make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            LOGGER.debug("serve.http: " + fmt % args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                alive = server._thread is not None and server._thread.is_alive()
                self._reply(200 if alive else 503, {"ok": alive})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                self._reply(400, {"error": "empty body (expected image bytes)"})
                return
            raw = self.rfile.read(n)
            try:
                img = imdecode(raw)
            except (ValueError, NotImplementedError) as e:
                self._reply(400, {"error": f"could not decode image: {e}"})
                return
            t0 = time.perf_counter()
            try:
                res = server.submit(img).result(timeout=60.0)
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"results": json.loads(res.tojson()),
                              "speed_ms": round((time.perf_counter() - t0) * 1e3, 2)})

    return Handler


def serve_http(weights, host: str = "127.0.0.1", port: int = 8570, imgsz: int = 640,
               max_batch: int = 32, max_delay_ms: float = 5.0,
               warmup_buckets: Optional[list] = None, **server_kwargs) -> ThreadingHTTPServer:
    """Start an ``InferenceServer`` and its HTTP front end; returns the httpd
    (the caller runs ``httpd.serve_forever()``; ``httpd.engine`` is the
    server). ``warmup_buckets``: None warms every bucket before traffic, a
    list warms those, ``()`` none. The port is bound before the warm-up,
    and everything is closed if the warm-up fails."""
    engine = InferenceServer(weights, imgsz=imgsz, max_batch=max_batch,
                             max_delay_ms=max_delay_ms, **server_kwargs)
    httpd = ThreadingHTTPServer((host, port), make_handler(engine))
    try:
        engine.start()
        if warmup_buckets is None:
            engine.warmup()
        elif warmup_buckets:
            engine.warmup(warmup_buckets)
    except BaseException:
        httpd.server_close()
        engine.close(drain=False)
        raise
    httpd.engine = engine
    LOGGER.info(f"serve.http: listening on http://{host}:{httpd.server_address[1]} "
                f"(POST /predict)")
    return httpd
