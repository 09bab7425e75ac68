"""Stdlib HTTP front end for one generation engine.

The port of ``sparknet_tpu/serve/server.py`` in generation mode:
``http.server.ThreadingHTTPServer`` (one thread per connection) over a
``StreamBatcher`` — handler threads block on their stream's events
while the batcher's worker runs continuous batching.  The ``/predict``
engine and the replica ``Router`` come with later slices.

Endpoints:
  POST /generate  body {"prompt": [token ids], "max_new": n} -> chunked
                  NDJSON, one event per line: {"event": "token", ...}
                  per decoded token, then a terminal {"event": "done" |
                  "stopped" | "error"}.  Admission errors (429 with
                  ``X-Shed-Cause``, 503, 400, 504) are sent as plain JSON
                  BEFORE any chunk — the status line is only committed
                  once the first token exists.  A drain deadline ends
                  live streams with "stopped", never a dead connection.
  GET  /healthz   {"status": "ok"} | 503 draining, plus the request-
                  profile block while a ``RequestProfiler`` is installed.
  GET  /metrics   Prometheus text (the engine pool's registry: stream,
                  KV-arena and front-end series in one payload).

Graceful drain: SIGTERM/SIGINT (``utils/signals.py``) flips /healthz to
503, stops admitting new work, serves everything queued, then shuts the
listener down.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional

from sparknet_tpu_torch.obs import reqtrace as _reqtrace
from sparknet_tpu_torch.obs.exporter import JsonHTTPHandler
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.serve.batcher import QueueFull, StreamBatcher
from sparknet_tpu_torch.serve.kv_cache import KVBudgetExceeded
from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction

_RETRY = [("Retry-After", "1")]


def _shed_headers(cause: str):
    """429/503 headers: Retry-After plus the machine-readable shed
    cause (queue_full | kv_reserve | draining) — the header twin of the
    ``cause=`` label on ``sparknet_gen_streams_shed_total``."""
    return [("Retry-After", "1"), ("X-Shed-Cause", cause)]


class _Handler(JsonHTTPHandler):
    # set per-server via the factory in ServeServer
    server_ctx: "ServeServer"

    def _verbose(self) -> bool:
        return self.server_ctx.verbose

    def log_message(self, fmt, *args):
        if self._verbose():
            print("serve: " + fmt % args)

    def do_GET(self):
        ctx = self.server_ctx
        if self.path == "/healthz":
            code, payload = ctx.health_payload()
            self._send_json(
                code, payload,
                extra_headers=_RETRY if code == 503 else (),
            )
        elif self.path == "/metrics":
            self._send(
                200,
                ctx.metrics.render().encode("utf-8"),
                "text/plain; version=0.0.4",
            )
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        ctx = self.server_ctx
        # ALWAYS consume the body first: early returns that leave it
        # unread corrupt HTTP/1.1 keep-alive connections
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
        except ValueError:
            length = 0
        raw = self.rfile.read(length) if length > 0 else b""
        if self.path == "/predict":
            self._send_json(
                404, {"error": "generation server — use POST /generate"}
            )
            return
        if self.path != "/generate":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        ctx.m_open_requests.inc()
        try:
            self._generate(ctx, raw)
        finally:
            ctx.m_open_requests.dec()

    def _generate(self, ctx: "ServeServer", raw: bytes) -> None:
        # the request id is minted HERE, at admission — every span the
        # request touches downstream carries it
        rid = _reqtrace.maybe_rid()
        if ctx.draining:
            _reqtrace.note_shed("draining", rid=rid)
            self._send_json(
                503, {"status": "draining"},
                extra_headers=_shed_headers("draining"),
            )
            return
        try:
            body = json.loads(raw or b"{}")
            prompt = [int(t) for t in body["prompt"]]
            max_new = int(body.get("max_new", 16))
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request body: {e}"})
            return
        if not prompt or max_new < 1:
            self._send_json(
                400, {"error": "need a non-empty prompt and max_new >= 1"}
            )
            return
        # Pull the FIRST event before committing the status line: every
        # admission failure still maps to a clean JSON status this way.
        # After the first token the response is chunked NDJSON and
        # errors become error events.
        try:
            events = ctx.submit_stream(prompt, max_new, rid=rid)
            first = next(events)
        except QueueFull as e:
            cause = (
                "kv_reserve" if isinstance(e, KVBudgetExceeded)
                else "queue_full"
            )
            self._send_json(
                429,
                {"error": "queue or KV budget full, retry later",
                 "cause": cause},
                extra_headers=_shed_headers(cause),
            )
            return
        except ValueError as e:  # prompt/max_new vs engine geometry
            self._send_json(400, {"error": str(e)})
            return
        except TimeoutError as e:
            self._send_json(504, {"error": str(e)})
            return
        except StopIteration:
            self._send_json(500, {"error": "stream produced no events"})
            return
        except RuntimeError as e:
            if ctx.draining:
                self._send_json(
                    503, {"status": "draining"},
                    extra_headers=_shed_headers("draining"),
                )
            else:
                self._send_json(500, {"error": f"generation failed: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — a response beats a hang
            self._send_json(500, {"error": f"generation failed: {e}"})
            return
        try:
            self._send_chunked_start(200, "application/x-ndjson")
            self._write_event(first, rid)
            try:
                for ev in events:  # stops itself after a terminal event
                    self._write_event(ev, rid)
            except TimeoutError as e:
                # headers are long gone — the failure IS an event
                self._write_event({"event": "error", "error": str(e)}, rid)
            self._end_chunks()
        except OSError:
            # client hung up mid-stream; the connection is unusable
            self.close_connection = True

    def _write_event(self, ev: dict, rid) -> None:
        """One NDJSON chunk; with a request id the socket write is a
        ``stream_write`` span."""
        data = json.dumps(ev).encode("utf-8") + b"\n"
        if rid is None:
            self._send_chunk(data)
            return
        with span("stream_write", cat="req", req=rid):
            self._send_chunk(data)


class ServeServer:
    """HTTP listener over one ``GenerationEngine`` (engine + stream
    batcher), with signal-driven drain.

    ``run()`` blocks until SIGTERM/SIGINT (call it from the main thread:
    CPython installs signal handlers there only); tests drive the same
    lifecycle with ``start()`` / ``initiate_drain()`` / ``shutdown()``.
    """

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 8361,
        max_queue: int = 256,
        request_timeout_s: float = 60.0,
        verbose: bool = False,
    ):
        self.engine = engine
        # share the engine pool's registry so ONE /metrics payload
        # carries the stream series AND the sparknet_kv_* arena gauges
        self.batcher = StreamBatcher(
            engine, max_queue=max_queue, metrics=engine.pool.metrics,
        )
        self.metrics = self.batcher.metrics
        t0 = time.monotonic()
        self.m_uptime = self.metrics.gauge(
            "serve_uptime_seconds", "seconds since server construction",
            fn=lambda: time.monotonic() - t0,
        )
        self.m_open_requests = self.metrics.gauge(
            "serve_open_requests",
            "in-flight /generate requests (parse + queue + generation)",
        )
        self.request_timeout_s = float(request_timeout_s)
        self.verbose = verbose
        self._drain_evt = threading.Event()

        ctx = self

        class BoundHandler(_Handler):
            server_ctx = ctx

        self.httpd = ThreadingHTTPServer((host, port), BoundHandler)
        self.httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    @property
    def address(self):
        """(host, port) actually bound (port 0 resolves here)."""
        return self.httpd.server_address[:2]

    def submit_stream(self, prompt, max_new, rid=None):
        """Event iterator for one generation stream."""
        st = self.batcher.submit_stream(prompt, max_new, rid=rid)
        return st.iter_events(timeout=self.request_timeout_s)

    @property
    def draining(self) -> bool:
        return self._drain_evt.is_set() or self.batcher.draining

    def health_payload(self):
        """(code, payload) for /healthz."""
        payload = {"status": "ok"}
        rp = _reqtrace.state()  # live request-profile block, if any
        if rp is not None:
            payload["request_profile"] = rp
        if self.draining:
            payload["status"] = "draining"
            return 503, payload
        return 200, payload

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Start serving on a background thread (non-blocking)."""
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="serve-http",
            daemon=True,
        )
        self._serve_thread.start()

    def initiate_drain(self) -> None:
        """Flip health to 503 + stop admissions; in-flight and queued
        streams still complete."""
        self._drain_evt.set()
        self.batcher.drain()

    def shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Drain the queue, stop the worker, close the listener."""
        self.initiate_drain()
        deadline = time.perf_counter() + drain_timeout_s
        while (
            self.batcher.queue_depth() > 0
            and time.perf_counter() < deadline
        ):
            time.sleep(0.02)
        self.batcher.stop(drain=True, timeout=drain_timeout_s)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5.0)

    # ------------------------------------------------------------------
    def run(self, poll_s: float = 0.2) -> int:
        """Blocking serve loop with signal-driven graceful drain
        (SIGTERM and SIGINT -> STOP)."""
        handler = SignalHandler(
            sigint_effect=SolverAction.STOP,
            sighup_effect=SolverAction.NONE,
            sigterm_effect=SolverAction.STOP,
        )
        self.start()
        host, port = self.address
        print(f"serving on http://{host}:{port} (SIGTERM drains)")
        try:
            while handler.get_action() != SolverAction.STOP:
                time.sleep(poll_s)
            print("serve: stop signal — draining")
        finally:
            self.shutdown()
            handler.restore()
        print("serve: drained and shut down")
        return 0
