"""Stdlib-only HTTP front-end over the AsyncDriver — the port's copy of
``repro/serve/server.py``.

Three endpoints, no dependencies beyond ``http.server``:

  * ``POST /generate`` — body ``{"prompt": [ids...], "max_new": N,
    "stream": bool, "priority": int, "deadline_s": float}``.
    Non-streaming returns one JSON object ``{"rid", "tokens", "done",
    "expired"}`` when the request completes; ``"stream": true``
    switches to chunked transfer encoding and writes one JSON line PER
    TOKEN as the engine produces it (``{"rid", "token", "index"}``),
    closing with ``{"rid", "done": true, "expired": false,
    "tokens": [...]}`` — TTFT is the wire gap before the first line.
    ``deadline_s`` is a relative SLO: a request still QUEUED when it
    elapses is dropped (``done=false, expired=true``, no tokens) instead
    of occupying a slot it can no longer use. Validation failures
    (empty prompt, pool bounds, bad JSON, non-numeric ``"timeout"``)
    are HTTP 400 with the engine's message. A non-streaming request
    waits at most ``"timeout"`` seconds (client-set), else the server's
    ``result_timeout`` / watchdog timeout / 300s cap, and answers 504 —
    a wedged request never pins a handler thread forever.
  * ``GET /metrics`` — Prometheus text exposition: the driver's
    TTFT/TPOT/step summaries plus every numeric ``engine.stats`` field
    as ``serve_engine_*`` gauges (serve/metrics.py documents the
    glossary).
  * ``GET /healthz`` — ``{"status": "ok", ...}`` liveness probe with
    queue/slot occupancy, ``last_step_age_s``/``step_in_flight_s``
    progress signals (a wedged-but-alive engine shows a growing age
    while the queue piles up), and the watchdog-fired count; served
    LOCK-FREE so it answers even while a stalled step holds the driver
    lock — a load balancer can drain a replica whose watchdog keeps
    firing.
  * ``GET /debug/flight`` — flight-recorder snapshot (recent step
    records with per-phase timings + live/finished request span trees,
    per replica), also lock-free.
  * ``GET /debug/trace`` — the merged Chrome/Perfetto ``trace_event``
    JSON export (replica lanes as processes, engine-step + slot lanes
    as threads); load it in ui.perfetto.dev or chrome://tracing.

``ServeHTTPServer`` binds a ``ThreadingHTTPServer`` (port 0 picks a free
port — tests use that), serves on a daemon thread, and ``close()`` shuts
it down; it closes over an existing :class:`AsyncDriver` so the engine,
driver, and HTTP layers stay independently testable. Construction
normally goes through ``repro_torch.api.Session.serve_http(...)`` or
``launch/serve.py --serve --port N``.

Over tensor-parallel ranks (serve/driver.py) the server is built on every
rank, and only rank 0's (``driver.lead``) binds a port: a follower's
holds no socket (``port`` and ``url`` None), its driver replays rank 0's
events, and its ``close()`` returns when rank 0 has stopped. The
handlers call nothing that issues a collective: ``/metrics`` renders
the stats the loop took, ``/healthz`` reads the last pass's ``busy``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.serve.driver import AsyncDriver

#: request body / streamed line size guard (1 MiB)
MAX_BODY_BYTES = 1 << 20

#: non-streaming /generate wait cap when neither the client sent a
#: "timeout" nor the server was built with ``result_timeout`` and the
#: driver runs no watchdog — a handler thread must never block forever
#: on a wedged or never-admitted request (it 504s instead)
DEFAULT_RESULT_TIMEOUT_S = 300.0


def _make_handler(driver: AsyncDriver,
                  result_timeout: Optional[float] = None):
    """Handler class closed over ``driver`` (BaseHTTPRequestHandler is
    instantiated per connection by the server, so state rides on the
    class). ``result_timeout`` caps how long a non-streaming /generate
    waits for completion when the client sent no ``"timeout"``; None
    falls back to the driver's watchdog timeout, then
    :data:`DEFAULT_RESULT_TIMEOUT_S`."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "repro-torch-serve/1.0"

        # silence the default per-request stderr lines; the metrics
        # endpoint is the observability story
        def log_message(self, fmt, *args):
            pass

        # ------------------------------------------------------ helpers
        def _send_json(self, obj, code: int = 200):
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, text: str, code: int = 200,
                       ctype: str = "text/plain; version=0.0.4"):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        # --------------------------------------------------------- GET
        def do_GET(self):
            if self.path == "/metrics":
                self._send_text(driver.render_metrics())
            elif self.path == "/healthz":
                # LOCK-FREE on purpose: driver.health() never takes the
                # driver lock, so a load balancer still gets an answer —
                # with a growing last_step_age_s exposing the wedge —
                # while a stalled step holds it
                h = driver.health()
                h["status"] = "ok"
                h["busy"] = driver.busy()
                h["active_slots"] = int(
                    driver.metrics.active_slots.value)
                h["watchdog_fired"] = int(
                    driver.metrics.watchdog_fired.value)
                self._send_json(h)
            elif self.path == "/debug/flight":
                self._send_json(driver.flight())
            elif self.path == "/debug/trace":
                self._send_json(driver.trace())
            else:
                self._send_json({"error": f"no route {self.path}"}, 404)

        # -------------------------------------------------------- POST
        def do_POST(self):
            if self.path != "/generate":
                self._send_json({"error": f"no route {self.path}"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    raise ValueError(
                        f"body {length}B exceeds {MAX_BODY_BYTES}B")
                spec = json.loads(self.rfile.read(length) or b"{}")
                prompt = spec["prompt"]
                if not isinstance(prompt, list) or \
                        not all(isinstance(t, int) for t in prompt):
                    raise ValueError("prompt must be a list of token ids")
                deadline_s = spec.get("deadline_s")
                # validate BEFORE submit: a non-numeric "timeout" must
                # 400 like any other bad field, not escape as a 500
                timeout = spec.get("timeout")
                if timeout is not None:
                    timeout = float(timeout)
                stream = driver.submit(
                    prompt, int(spec.get("max_new", 16)),
                    priority=int(spec.get("priority", 0)),
                    deadline_s=(None if deadline_s is None
                                else float(deadline_s)))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._send_json({"error": str(e)}, 400)
                return
            if spec.get("stream"):
                self._stream_response(stream)
            else:
                if timeout is None:
                    # no client timeout: never block the handler thread
                    # forever on a wedged/never-admitted request — wait
                    # at most the server-level cap, then 504
                    timeout = result_timeout \
                        if result_timeout is not None \
                        else (driver.watchdog_timeout
                              or DEFAULT_RESULT_TIMEOUT_S)
                try:
                    rec = stream.result(timeout=timeout)
                except TimeoutError as e:
                    self._send_json({"error": str(e),
                                     "rid": stream.rid}, 504)
                    return
                self._send_json({
                    "rid": stream.rid,
                    "tokens": list(rec.out),
                    "done": bool(rec.done),
                    "expired": bool(getattr(rec, "expired", False))})

        def _stream_response(self, stream):
            """Chunked transfer: one JSON line per token, then the
            closing record. A client disconnect mid-stream just stops
            the writes — the request itself finishes in the engine."""
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonlines")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            tokens = []
            try:
                for i, tok in enumerate(stream):
                    tokens.append(tok)
                    self._chunk((json.dumps(
                        {"rid": stream.rid, "token": tok, "index": i})
                        + "\n").encode())
                rec = stream.result(timeout=0.0)
                self._chunk((json.dumps(
                    {"rid": stream.rid, "done": bool(rec.done),
                     "expired": bool(getattr(rec, "expired", False)),
                     "tokens": list(rec.out)}) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass

    return Handler


class ServeHTTPServer:
    """One HTTP front-end bound to an AsyncDriver.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``close()`` stops the HTTP listener and, when the server owns its
    driver (``own_driver=True``), drains and stops the driver too.
    Usable as a context manager.
    """

    def __init__(self, driver: AsyncDriver, *, host: str = "127.0.0.1",
                 port: int = 0, own_driver: bool = False,
                 result_timeout: Optional[float] = None):
        self.driver = driver
        self._own_driver = own_driver
        self._httpd = None
        self.host = self.port = None
        if not driver.lead:            # a follower rank binds nothing
            return
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(driver,
                                        result_timeout=result_timeout))
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> Optional[str]:
        if self._httpd is None:
            return None
        return f"http://{self.host}:{self.port}"

    def close(self, drain: bool = True):
        """Stop listening and, when the server owns its driver, stop it
        (a follower's: wait until rank 0 has stopped)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10.0)
        if self._own_driver:
            self.driver.stop(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))


def serve_http(engine, *, host: str = "127.0.0.1", port: int = 0,
               watchdog_timeout: Optional[float] = None,
               metrics=None,
               result_timeout: Optional[float] = None) -> ServeHTTPServer:
    """Wrap ``engine`` (ServeEngine or ReplicaRouter) in an AsyncDriver
    and expose it over HTTP; the returned server owns the driver
    (``close()`` stops both). ``result_timeout`` caps non-streaming
    /generate waits when the client sends no ``"timeout"`` (default:
    the watchdog timeout, else 300s — a wedged request 504s instead of
    pinning its handler thread forever)."""
    driver = AsyncDriver(engine, watchdog_timeout=watchdog_timeout,
                         metrics=metrics)
    return ServeHTTPServer(driver, host=host, port=port, own_driver=True,
                           result_timeout=result_timeout)
