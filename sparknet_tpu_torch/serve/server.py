"""Stdlib HTTP front-end for the inference engine — or a whole fleet.

The port of ``sparknet_tpu/serve/server.py``, with its routes, status
codes and drain.  A CUDA error in a forward is a ``RuntimeError``: it
answers 500, never a 503 (only a drain or an unservable fleet is 503).

``http.server.ThreadingHTTPServer`` (one thread per connection) over a
shared ``MicroBatcher`` (single-engine mode) or a ``serve/fleet.py``
``Router`` (fleet mode) — handler threads block in ``submit`` while the
worker(s) coalesce their requests into forward passes, which is exactly
the concurrency the micro-batchers feed on.

Endpoints:
  POST /predict   body {"data": <nested list, (n,C,H,W) or (C,H,W)>}
                  -> {"outputs": [...], "shape": [...], "batched": n}
                  429 when admission sheds (fleet-wide bound in fleet
                  mode), 503 while draining or when NO live replica
                  remains, 400 on malformed input.
  POST /generate  (generation mode only: a ``GenerationEngine`` or a
                  stream-mode fleet) body {"prompt": [token ids],
                  "max_new": n} -> chunked NDJSON, one event per line:
                  {"event": "token", ...} per decoded token, then a
                  terminal {"event": "done" | "stopped" | "error"}.
                  Admission errors (429/503/400/504) are sent as plain
                  JSON BEFORE any chunk — the status line is only
                  committed once the first token exists.  A drain
                  deadline ends live streams with "stopped" (partial
                  tokens included), never a dead connection.
  GET  /healthz   single engine: {"status": "ok"} | 503 draining.
                  fleet: per-replica state rows (live/draining/ejected)
                  + the delivery phase block (incumbent, canary,
                  decision-window progress).  503 ONLY when the whole
                  fleet is unservable (draining, or zero live
                  replicas) — one draining/ejected replica keeps the
                  endpoint 200 so an LB doesn't pull a healthy fleet.
  GET  /metrics   Prometheus text (the shared obs.metrics registry; in
                  fleet mode the per-replica sparknet_serve_replica_*
                  families + fleet sums render here).

Graceful drain: SIGTERM/SIGINT (via ``utils/signals.py`` SignalHandler)
flips /healthz to 503 (LB takes the server out of rotation), stops
admitting new work, serves everything queued, then shuts the listener
down.
"""

from __future__ import annotations

import json
import signal as _signal
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional

import numpy as np

from sparknet_tpu_torch.obs import reqtrace as _reqtrace
from sparknet_tpu_torch.obs.exporter import JsonHTTPHandler
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.serve.batcher import (
    MicroBatcher,
    QueueFull,
    StreamBatcher,
)
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.fleet import FleetUnservable, Router
from sparknet_tpu_torch.serve.kv_cache import KVBudgetExceeded
from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction

_RETRY = [("Retry-After", "1")]


def _shed_headers(cause: str):
    """429/503 headers: Retry-After plus the machine-readable shed
    cause (queue_full | kv_reserve | draining) — the header twin of the
    ``cause=`` label on ``sparknet_gen_streams_shed_total``."""
    return [("Retry-After", "1"), ("X-Shed-Cause", cause)]


class _Handler(JsonHTTPHandler):
    """Send/JSON plumbing comes from the shared obs handler machinery
    (the training /metrics sidecar runs the same base class)."""

    # set per-server via the factory in ServeServer
    server_ctx: "ServeServer"

    def _verbose(self) -> bool:  # route access logs to the app
        return self.server_ctx.verbose

    def log_message(self, fmt, *args):
        if self._verbose():
            print("serve: " + fmt % args)

    # ------------------------------------------------------------------
    def do_GET(self):
        ctx = self.server_ctx
        if self.path == "/healthz":
            code, payload = ctx.health_payload()
            # Retry-After on every 503/429: retrying clients (e.g.
            # utils/retry.py honors the header) back off instead of
            # hammering a server that is leaving rotation
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
        # unread corrupt HTTP/1.1 keep-alive connections (the leftover
        # bytes parse as the next request line)
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
        except ValueError:
            length = 0
        raw = self.rfile.read(length) if length > 0 else b""
        # each server speaks exactly one inference dialect: /predict on
        # classifier engines, /generate on generation engines — the
        # other route 404s with a pointer instead of half-working
        if self.path == "/predict" and not ctx.gen_mode:
            handler = self._predict
        elif self.path == "/generate" and ctx.gen_mode:
            handler = self._generate
        elif self.path == "/predict" and ctx.gen_mode:
            self._send_json(
                404, {"error": "generation server — use POST /generate"}
            )
            return
        elif self.path == "/generate" and not ctx.gen_mode:
            self._send_json(
                404, {"error": "prediction server — use POST /predict"}
            )
            return
        else:
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        # the open-request gauge covers the full front-end residency of
        # a request (parse + queue wait + inference + serialize)
        ctx.m_open_requests.inc()
        try:
            handler(ctx, raw)
        finally:
            ctx.m_open_requests.dec()

    def _predict(self, ctx: "ServeServer", raw: bytes) -> None:
        if ctx.draining:
            self._send_json(
                503, {"status": "draining"}, extra_headers=_RETRY
            )
            return
        try:
            body = json.loads(raw or b"{}")
            x = np.asarray(body["data"], np.float32)
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request body: {e}"})
            return
        item_ndim = len(ctx.item_shape)
        if x.ndim == item_ndim + 1 and x.shape[0] == 0:
            self._send_json(400, {"error": "empty batch"})
            return
        if x.ndim not in (item_ndim, item_ndim + 1) or (
            tuple(x.shape[-item_ndim:]) != ctx.item_shape
        ):
            self._send_json(
                400,
                {
                    "error": "input shape %s does not match net input %s"
                    % (list(x.shape), list(ctx.item_shape))
                },
            )
            return
        try:
            out = ctx.submit(x, timeout=ctx.request_timeout_s)
        except QueueFull:
            self._send_json(
                429,
                {"error": "queue full, retry later"},
                extra_headers=_RETRY,
            )
            return
        except FleetUnservable as e:
            # the WHOLE fleet is out — the only replica-related 503
            self._send_json(
                503, {"status": "unservable", "error": str(e)},
                extra_headers=_RETRY,
            )
            return
        except TimeoutError as e:
            self._send_json(504, {"error": str(e)})
            return
        except RuntimeError as e:
            # only an actual drain is a 503; anything else (engine
            # errors surface as RuntimeError, CUDA errors among them)
            # must NOT masquerade as one — the LB would keep routing
            # while operators chase a phantom drain
            if ctx.draining:
                self._send_json(
                    503, {"status": "draining"}, extra_headers=_RETRY
                )
            else:
                self._send_json(500, {"error": f"inference failed: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — a response beats a hang
            self._send_json(500, {"error": f"inference failed: {e}"})
            return
        self._send_json(
            200,
            {
                "outputs": out.tolist(),
                "shape": list(out.shape),
                "batched": int(x.shape[0]) if x.ndim == item_ndim + 1 else 1,
            },
        )

    # ------------------------------------------------------------------
    def _generate(self, ctx: "ServeServer", raw: bytes) -> None:
        # the request id is minted HERE, at admission — every span the
        # request touches downstream (queue, KV, prefill, decode steps,
        # chunk writes) and every shed instant carries it
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
        # admission failure (shed, unservable fleet, bad geometry) still
        # maps to a clean JSON status this way.  After the first token
        # the response is chunked NDJSON and errors become error events.
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
        except FleetUnservable as e:
            self._send_json(
                503, {"status": "unservable", "error": str(e)},
                extra_headers=_RETRY,
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
                self._write_event(
                    {"event": "error", "error": str(e)}, rid
                )
            self._end_chunks()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client hung up mid-stream; the connection is unusable
            self.close_connection = True

    def _write_event(self, ev: dict, rid) -> None:
        """One NDJSON chunk; with a request id the socket write is a
        ``stream_write`` span (a stalled client reads as write-bound,
        not decode-bound)."""
        data = json.dumps(ev).encode("utf-8") + b"\n"
        if rid is None:
            self._send_chunk(data)
            return
        with span("stream_write", cat="req", req=rid):
            self._send_chunk(data)


class ServeServer:
    """HTTP listener over one engine (engine + micro-batcher) or a
    replicated fleet (``router=`` a ``serve/fleet.py`` Router, with an
    optional ``delivery=`` controller feeding the /healthz delivery
    block), with signal-driven drain.

    ``run()`` blocks until SIGTERM/SIGINT (must be called from the main
    thread — CPython restricts signal handler installation); tests drive
    the same lifecycle with ``start()`` / ``initiate_drain()`` /
    ``shutdown()`` instead.
    """

    def __init__(
        self,
        engine: Optional[InferenceEngine] = None,
        host: str = "127.0.0.1",
        port: int = 8361,
        max_queue: int = 256,
        max_wait_ms: float = 2.0,
        request_timeout_s: float = 60.0,
        verbose: bool = False,
        router: Optional[Router] = None,
        delivery=None,
    ):
        if (engine is None) == (router is None):
            raise ValueError("pass exactly one of engine= or router=")
        self.engine = engine
        self.router = router
        self.delivery = delivery
        if router is not None:
            self.batcher = None
            self.metrics = router.pool.registry
            # a stream-mode fleet serves /generate; a predict fleet
            # serves /predict — the pool's build flag decides
            self.gen_mode = bool(getattr(router.pool, "stream", False))
        elif hasattr(engine, "admit"):  # GenerationEngine duck type
            # share the engine pool's registry so ONE /metrics payload
            # carries the stream series AND the sparknet_kv_* arena
            # gauges (the standalone-server contract in kv_cache.py)
            self.batcher = StreamBatcher(
                engine, max_queue=max_queue,
                metrics=engine.pool.metrics,
            )
            self.metrics = self.batcher.metrics
            self.gen_mode = True
        else:
            self.batcher = MicroBatcher(
                engine, max_queue=max_queue, max_wait_ms=max_wait_ms
            )
            self.metrics = self.batcher.metrics
            self.gen_mode = False
        # front-end series ride on the SAME shared registry the backend
        # built (obs.metrics) — one /metrics payload, no second registry
        t0 = time.monotonic()
        self.m_uptime = self.metrics.gauge(
            "serve_uptime_seconds", "seconds since server construction",
            fn=lambda: time.monotonic() - t0,
        )
        self.m_open_requests = self.metrics.gauge(
            "serve_open_requests",
            "in-flight /predict requests (parse + queue + inference)",
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

    @property
    def item_shape(self):
        if self.router is not None:
            return self.router.item_shape
        return self.engine.item_shape

    def submit(self, x, timeout=None):
        if self.router is not None:
            return self.router.submit(x, timeout=timeout)
        return self.batcher.submit(x, timeout=timeout)

    def submit_stream(self, prompt, max_new, rid=None):
        """Event iterator for one generation stream (gen mode only)."""
        if self.router is not None:
            return self.router.submit_stream(
                prompt, max_new, timeout=self.request_timeout_s, rid=rid
            )
        st = self.batcher.submit_stream(prompt, max_new, rid=rid)
        return st.iter_events(timeout=self.request_timeout_s)

    @property
    def draining(self) -> bool:
        if self.router is not None:
            return self._drain_evt.is_set() or self.router.draining
        return self._drain_evt.is_set() or self.batcher.draining

    def health_payload(self):
        """(code, payload) for /healthz.  Fleet mode 503s ONLY when the
        whole fleet is unservable; one draining replica stays 200."""
        rp = _reqtrace.state()  # live request-profile block, if any
        if self.router is None:
            payload = {"status": "ok"}
            if rp is not None:
                payload["request_profile"] = rp
            if self.draining:
                payload["status"] = "draining"
                return 503, payload
            return 200, payload
        pool = self.router.pool
        states = pool.states()
        # live means SERVABLE: a nominally-live replica whose worker
        # died does not count (the router ejects it on next pick)
        live = len(pool.live_replicas())
        payload = {
            "replicas": states,
            "fleet": {
                "size": len(states),
                "live": live,
                "inflight": self.router.inflight(),
                "incumbent": pool.incumbent_id,
            },
        }
        if rp is not None:
            payload["request_profile"] = rp
        if self.delivery is not None:
            payload["delivery"] = self.delivery.status()
        if self.draining:
            payload["status"] = "draining"
            return 503, payload
        if live == 0:
            payload["status"] = "unservable"
            return 503, payload
        payload["status"] = "ok"
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
        requests still complete."""
        self._drain_evt.set()
        if self.router is not None:
            self.router.initiate_drain()
        else:
            self.batcher.drain()

    def _queue_depth(self) -> int:
        if self.router is not None:
            return self.router.queue_depth()
        return self.batcher.queue_depth()

    def shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Drain the queue(s), stop the worker(s), close the listener."""
        self.initiate_drain()
        deadline = time.perf_counter() + drain_timeout_s
        while (
            self._queue_depth() > 0
            and time.perf_counter() < deadline
        ):
            time.sleep(0.02)
        if self.delivery is not None:
            self.delivery.stop()
        if self.router is not None:
            self.router.close()
        else:
            self.batcher.stop(drain=True, timeout=drain_timeout_s)
        # httpd.shutdown() waits for serve_forever to return: only a
        # started server has that loop to stop
        if self._serve_thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5.0)

    # ------------------------------------------------------------------
    def run(self, poll_s: float = 0.2) -> int:
        """Blocking serve loop with signal-driven graceful drain
        (SIGTERM and SIGINT -> STOP via utils/signals.py)."""
        handler = SignalHandler(
            sigint_effect=SolverAction.STOP,
            sighup_effect=SolverAction.NONE,
            sigterm_effect=SolverAction.STOP,
        )
        self.start()
        host, port = self.address
        print(f"serving on http://{host}:{port} (SIGTERM drains)")
        try:
            while True:
                if handler.get_action() == SolverAction.STOP:
                    print("serve: stop signal — draining")
                    break
                time.sleep(poll_s)
        finally:
            self.shutdown()
            handler.restore()
        print("serve: drained and shut down")
        return 0

    # convenience used by tests/bench: emulate SIGTERM delivery
    def send_sigterm_to_self(self) -> None:
        import os

        os.kill(os.getpid(), _signal.SIGTERM)
