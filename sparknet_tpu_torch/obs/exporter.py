"""The telemetry sidecar (``/metrics`` + ``/healthz`` for any run) and
the HTTP handler plumbing shared by the port's HTTP front ends.

The port's own copy of ``sparknet_tpu/obs/exporter.py``.
``JsonHTTPHandler``: length-correct sends, JSON helpers, HTTP/1.1
keep-alive, chunked transfer for token streaming, and access logs off
unless the bound server context says otherwise (``serve/server.py`` and
``obs/fleet.py`` subclass it).  ``ObsExporter`` is the stdlib listener
``--obs`` starts over a run's registry: ``/metrics`` (Prometheus text),
``/healthz`` (503 while the run reports unhealthy; the sentry,
profile, membership and slo blocks ride along), and with ``--slo``
``/query``, ``/slo`` and ``/signals`` over the run's TSDB and SLO
evaluator.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse


class JsonHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _verbose(self) -> bool:
        return False

    def log_message(self, fmt, *args):
        if self._verbose():
            print(self.__class__.__name__ + ": " + fmt % args)

    def _send(self, code: int, payload: bytes, ctype: str,
              extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj, extra_headers=()) -> None:
        self._send(
            code, json.dumps(obj).encode("utf-8"), "application/json",
            extra_headers,
        )

    # Chunked transfer (HTTP/1.1): Content-Length framing cannot stream
    # an unknown-length body over keep-alive; chunked framing can, and
    # the 0-length terminal chunk keeps the connection clean.
    def _send_chunked_start(self, code: int, ctype: str,
                            extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()

    def _send_chunk(self, payload: bytes) -> None:
        if not payload:
            return  # an empty chunk would terminate the stream
        self.wfile.write(b"%X\r\n" % len(payload) + payload + b"\r\n")
        self.wfile.flush()

    def _end_chunks(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()


class _ObsHandler(JsonHTTPHandler):
    exporter: "ObsExporter"  # bound per server by ObsExporter

    def do_GET(self):
        ex = self.exporter
        if self.path == "/metrics":
            self._send(200, ex.registry.render().encode("utf-8"),
                       "text/plain; version=0.0.4")
        elif self.path.startswith("/query") and ex.tsdb is not None:
            q = parse_qs(urlparse(self.path).query)

            def _one(key, default=None):
                vals = q.get(key)
                return vals[0] if vals else default

            series = _one("series")
            if not series:
                self._send_json(400, {"error": "series= is required"})
                return
            try:
                range_s = float(_one("range", "300"))
                step = _one("step")
                step_s = float(step) if step is not None else None
            except ValueError as e:
                self._send_json(400, {"error": f"bad range/step: {e}"})
                return
            res = ex.tsdb.query(series, host=_one("host"), range_s=range_s,
                                step_s=step_s)
            if res is None:
                self._send_json(404, {"error": f"unknown series {series!r}"})
                return
            res["tsdb"] = ex.tsdb.stats()
            self._send_json(200, res)
        elif self.path == "/slo" and ex.slo is not None:
            self._send_json(200, ex.slo.evaluate())
        elif self.path == "/signals" and ex.slo is not None:
            ex.slo.maybe_evaluate()
            self._send_json(200, ex.slo.signals())
        elif self.path == "/healthz":
            reason = ex.health_fn() if ex.health_fn is not None else None
            from sparknet_tpu_torch import obs as _obs

            # "stalled" (a reason) vs "diverged" (the sentry halted)
            payload = {}
            sentry = _obs.sentry_state()
            if sentry is not None:
                payload["sentry"] = sentry
                if sentry.get("halted"):
                    reason = reason or (
                        "sentry_halt: " + str(sentry.get("halt_reason")))
            for key, block in (("profile", _obs.profile_state()),
                               ("membership", _obs.membership_state()),
                               ("slo", _obs.slo_state())):
                # an SLO page is an objective's verdict, not a wedged
                # process: the run stays 200
                if block is not None:
                    payload[key] = block
            if reason:
                payload.update({"status": "unhealthy", "reason": reason})
                self._send_json(503, payload)
            else:
                payload["status"] = "ok"
                self._send_json(200, payload)
        else:
            self._send_json(404, {"error": f"no route {self.path}"})


class ObsExporter:
    """Background ``/metrics`` + ``/healthz`` listener over a registry.
    ``health_fn() -> Optional[str]`` gives the unhealthy reason (None =
    healthy); ``tsdb`` and ``slo`` (``--slo``) add ``/query``, ``/slo``
    and ``/signals``.  Port 0 binds an ephemeral port, read back from
    ``address``."""

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 8380,
                 health_fn: Optional[Callable[[], Optional[str]]] = None,
                 tsdb=None, slo=None):
        self.registry = registry
        self.health_fn = health_fn
        self.tsdb = tsdb
        self.slo = slo
        ex = self

        class BoundHandler(_ObsHandler):
            exporter = ex

        self.httpd = ThreadingHTTPServer((host, port), BoundHandler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """(host, port) actually bound (port 0 resolves here)."""
        return self.httpd.server_address[:2]

    def start(self) -> "ObsExporter":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-exporter", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
