"""Continuous batching for autoregressive generation.

The port of the generation half of ``sparknet_tpu/serve/batcher.py``:
``QueueFull`` (the 429 load-shedding signal), ``GenStream`` (one
client stream's event queue) and ``StreamBatcher`` (iteration-level
continuous batching over a ``GenerationEngine``).  The image
micro-batcher (``MicroBatcher``) comes with the ``/predict`` slice.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from sparknet_tpu_torch.obs import reqtrace as _reqtrace
from sparknet_tpu_torch.obs.metrics import MetricsRegistry
from sparknet_tpu_torch.obs.trace import span


class QueueFull(RuntimeError):
    """Admission queue at capacity — shed load (HTTP 429)."""


# ----------------------------------------------------------------------
# Continuous (in-flight) batching for autoregressive generation
# ----------------------------------------------------------------------
TERMINAL_EVENTS = ("done", "error", "stopped")


class GenStream:
    """One client stream: the handle ``submit_stream`` returns.

    Events arrive on an unbounded per-stream queue as dicts —
    ``{"event": "token", "token": t, "logprob": lp, "index": i}`` per
    generated token, then exactly one terminal event: ``"done"``
    (finish_reason "length"), ``"error"`` (clean failure — never a
    hang), or ``"stopped"`` (drain deadline hit; tokens so far
    included).  Consume with ``iter_events`` (the server's chunked
    NDJSON loop is a direct forward of it) or ``result``."""

    __slots__ = (
        "prompt", "max_new", "engine", "blocks", "events", "tokens",
        "logprobs", "t_submit", "t_first", "t_last", "slot", "finished",
        "rid", "_sp_queue", "_sp_request",
    )

    def __init__(self, prompt: List[int], max_new: int, engine, blocks,
                 rid: Optional[str] = None):
        self.prompt = prompt
        self.max_new = max_new
        self.engine = engine  # pinned at submit: hot swaps never move a stream
        self.blocks = blocks  # worst-case KV reservation (engine owns post-admit)
        self.events: "queue.Queue" = queue.Queue()
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.slot: Optional[int] = None
        self.finished = False
        # request-trace state: the admission-minted id plus the two
        # cross-thread spans (opened on the submit thread, closed on the
        # worker — the pattern trace.py's _Span supports by design)
        self.rid = rid
        self._sp_queue = None
        self._sp_request = None

    def iter_events(self, timeout: Optional[float] = 60.0):
        """Yield events until (and including) the terminal one.  A
        per-event timeout raises ``TimeoutError`` — a stuck stream
        surfaces as an exception, never a silent hang."""
        while True:
            try:
                ev = self.events.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no stream event within {timeout}s"
                ) from None
            yield ev
            if ev.get("event") in TERMINAL_EVENTS:
                return

    def result(self, timeout: Optional[float] = 60.0) -> Dict:
        """Block to the terminal event and return it (bench/tests)."""
        last = None
        for ev in self.iter_events(timeout=timeout):
            last = ev
        return last


class StreamBatcher:
    """Iteration-level continuous batching over a ``GenerationEngine``
    (the Orca design): every worker iteration first backfills free
    decode slots from the queue (prefill + first token out), then runs
    ONE fixed-shape decode step per engine with live streams — finished
    sequences exit and queued prompts join between any two iterations,
    no bucket coalescing, no waiting for stragglers.

    Admission is doubly bounded and synchronous at ``submit_stream``:
    the queue bound AND the worst-case KV-block reservation
    (``KVBudgetExceeded`` is a ``QueueFull`` — both shed as HTTP 429).

    Hot-swap contract: a stream is pinned to the engine captured at
    submit.  After ``self.engine`` is replaced, new streams admit to the
    new engine while the old one keeps decoding its in-flight streams to
    completion."""

    def __init__(
        self,
        engine,
        max_queue: int = 64,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.engine = engine
        self.max_queue = int(max_queue)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._running = True
        self._draining = False
        # id(engine) -> {slot: stream}; engines leave when their last
        # stream finishes (the post-swap old engine's retirement)
        self._active: Dict[int, Dict[int, GenStream]] = {}
        self._engines: Dict[int, object] = {}

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self.m_streams = m.counter(
            "sparknet_gen_streams_total", "streams admitted to the queue"
        )
        self.m_shed = m.counter(
            "sparknet_gen_streams_shed_total",
            "streams refused at admission, by cause (queue_full, "
            "kv_reserve, draining — HTTP 429/503)",
            labels=("cause",),
        )
        self.m_tokens = m.counter(
            "sparknet_gen_tokens_total", "tokens generated and emitted"
        )
        self.m_errors = m.counter(
            "sparknet_gen_stream_errors_total",
            "streams ended by an error event",
        )
        self.m_active = m.gauge(
            "sparknet_gen_active_streams",
            "streams currently holding a decode slot",
            fn=lambda: self.active_count(),
        )
        self.m_ttft = m.histogram(
            "sparknet_gen_ttft_seconds",
            "submit-to-first-token latency per stream",
        )
        self.m_intertoken = m.histogram(
            "sparknet_gen_intertoken_seconds",
            "gap between consecutive tokens of one stream",
        )
        self.m_occupancy = m.histogram(
            "sparknet_gen_decode_batch_occupancy",
            "active streams / decode slots per decode iteration",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        self.m_jit_cache = m.gauge(
            "sparknet_gen_jit_cache_size",
            "shapes warmed behind prefill+decode+score (constant "
            "after warmup iff no new shape ran)",
            # read through self.engine: hot swaps re-point the gauge
            fn=lambda: self.engine.jit_cache_size(),
        )

        self._worker = threading.Thread(
            target=self._loop, name="streambatcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # Client side
    # ------------------------------------------------------------------
    def submit_stream(self, prompt: Sequence[int], max_new: int,
                      rid: Optional[str] = None) -> GenStream:
        """Admit one generation stream (non-blocking — consume the
        returned handle's events).  Raises ``ValueError`` on geometry
        (400 upstream), ``QueueFull``/``KVBudgetExceeded`` on shed
        (429), ``RuntimeError`` when stopped or draining (503).

        ``rid`` is the request id minted upstream (HTTP handler or
        router); with tracing on and no id given, one is minted here so
        direct callers get request anatomy too.  Every refusal lands on
        the ``cause=``-labeled shed counter and a ``shed`` instant."""
        eng = self.engine
        prompt = [int(t) for t in prompt]
        max_new = int(max_new)
        eng.validate(len(prompt), max_new)
        rid = _reqtrace.maybe_rid(rid)
        with self._lock:
            if not self._running or self._draining:
                self.m_shed.labels("draining").inc()
                _reqtrace.note_shed("draining", rid=rid)
                raise RuntimeError("batcher is stopped or draining")
            if len(self._q) >= self.max_queue:
                self.m_shed.labels("queue_full").inc()
                _reqtrace.note_shed("queue_full", rid=rid)
                raise QueueFull(
                    f"stream queue at capacity ({self.max_queue})"
                )
            try:
                blocks = eng.reserve(len(prompt), max_new, rid=rid)
            except QueueFull:  # KVBudgetExceeded included
                self.m_shed.labels("kv_reserve").inc()
                _reqtrace.note_shed("kv_reserve", rid=rid)
                raise
            st = GenStream(prompt, max_new, eng, blocks, rid=rid)
            if rid is not None:
                # open the lifetime + queue-wait spans on the submit
                # thread; the worker closes them (queue_wait at slot
                # admit, request at the terminal event)
                args = {"req": rid}
                st._sp_request = span("request", cat="req", **args)
                st._sp_request.__enter__()
                st._sp_queue = span("queue_wait", cat="req", **args)
                st._sp_queue.__enter__()
            self._q.append(st)
            self.m_streams.inc()
            self._nonempty.notify()
        return st

    # ------------------------------------------------------------------
    # Worker side
    # ------------------------------------------------------------------
    @staticmethod
    def _text(tokens: List[int]) -> str:
        return bytes(t & 0xFF for t in tokens).decode("latin-1")

    def _end(self, st: GenStream, ev: Dict) -> None:
        if st.finished:  # idempotent: exactly one terminal event
            return
        st.finished = True
        if ev["event"] == "error":
            self.m_errors.inc()
        sp = st._sp_queue  # stream shed/errored before slot admit
        if sp is not None:
            st._sp_queue = None
            sp.__exit__(None, None, None)
        sp = st._sp_request
        if sp is not None:
            st._sp_request = None
            args = getattr(sp, "args", None)
            if args is not None:
                args["outcome"] = ev["event"]
                args["tokens"] = len(st.tokens)
            sp.__exit__(None, None, None)
        st.events.put(ev)

    def _emit_token(self, st: GenStream, tok: int, lp: float) -> None:
        now = time.perf_counter()
        idx = len(st.tokens)
        st.tokens.append(tok)
        st.logprobs.append(lp)
        self.m_tokens.inc()
        if st.t_last is not None:
            self.m_intertoken.observe(now - st.t_last)
        st.t_last = now
        st.events.put(
            {"event": "token", "token": tok, "logprob": lp, "index": idx}
        )

    def _finish_stream(self, key: int, st: GenStream) -> None:
        st.engine.finish(st.slot)
        with self._lock:
            slots = self._active.get(key)
            if slots is not None:
                slots.pop(st.slot, None)
                if not slots:
                    self._active.pop(key, None)
                    self._engines.pop(key, None)
        self._end(
            st,
            {
                "event": "done",
                "tokens": list(st.tokens),
                "text": self._text(st.tokens),
                "finish_reason": "length",
            },
        )

    def _admit_queued(self) -> bool:
        admitted = False
        while True:
            with self._lock:
                st = None
                if self._q and self._q[0].engine.free_slots() > 0:
                    st = self._q.popleft()
            if st is None:
                return admitted
            sp = st._sp_queue  # queue wait ends as prefill begins
            if sp is not None:
                st._sp_queue = None
                sp.__exit__(None, None, None)
            try:
                slot, tok, lp = st.engine.admit(
                    st.prompt, st.max_new, blocks=st.blocks, rid=st.rid
                )
            except BaseException as e:  # noqa: BLE001 — becomes an event
                try:
                    st.engine.release(st.blocks)
                except Exception:  # noqa: BLE001 — best-effort give-back
                    pass
                st.blocks = None
                self._end(
                    st, {"event": "error", "error": f"admit failed: {e}"}
                )
                continue
            st.blocks = None  # the engine owns the reservation now
            st.slot = slot
            st.t_first = time.perf_counter()
            self.m_ttft.observe(st.t_first - st.t_submit)
            key = id(st.engine)
            with self._lock:
                self._active.setdefault(key, {})[slot] = st
                self._engines[key] = st.engine
            self._emit_token(st, tok, lp)
            admitted = True
            if len(st.tokens) >= st.max_new:
                self._finish_stream(key, st)

    def _fail_engine(self, key: int, msg: str) -> None:
        with self._lock:
            slots = self._active.pop(key, {})
            self._engines.pop(key, None)
        for st in slots.values():
            try:
                st.engine.finish(st.slot)
            except Exception:  # noqa: BLE001 — engine may be poisoned
                pass
            self._end(st, {"event": "error", "error": msg})

    def _step_engines(self) -> bool:
        with self._lock:
            engines = [
                (k, self._engines[k])
                for k in list(self._active)
                if self._active[k]
            ]
        stepped = False
        for key, eng in engines:
            try:
                out = eng.step()
            except BaseException as e:  # noqa: BLE001 — becomes events
                self._fail_engine(key, f"decode failed: {e}")
                continue
            if not out:
                continue
            stepped = True
            self.m_occupancy.observe(len(out) / eng.max_streams)
            for slot, (tok, lp) in sorted(out.items()):
                with self._lock:
                    st = self._active.get(key, {}).get(slot)
                if st is None:
                    # a slot the engine still decodes but nobody owns
                    # (raced finish) — drop the token on the floor
                    continue
                self._emit_token(st, tok, lp)
                if len(st.tokens) >= st.max_new:
                    self._finish_stream(key, st)
        return stepped

    def _loop(self) -> None:
        while True:
            with self._lock:
                if not self._running:
                    return
            progressed = self._admit_queued()
            progressed = self._step_engines() or progressed
            if not progressed:
                with self._nonempty:
                    if self._running and not self._q:
                        self._nonempty.wait(timeout=0.01)

    # ------------------------------------------------------------------
    # Introspection / lifecycle (the surface the server speaks)
    # ------------------------------------------------------------------
    def active_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._active.values())

    def queue_depth(self) -> int:
        return len(self._q)

    def drain(self) -> None:
        """Stop admitting; in-flight streams keep decoding (SIGTERM)."""
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut down.  With ``drain``: streams get up to ``timeout`` to
        finish, then overdue ones end with a final ``"stopped"`` event
        (tokens so far — a clean end, not a reset).  Without: every
        queued and in-flight stream ends NOW with a clean ``"error"``
        event (the kill path — a resuming client's contract
        rides on that event arriving)."""
        deadline = time.perf_counter() + timeout
        with self._lock:
            self._draining = True
        if drain:
            while time.perf_counter() < deadline:
                with self._lock:
                    busy = bool(self._q) or any(
                        self._active.get(k) for k in self._active
                    )
                if not busy:
                    break
                time.sleep(0.005)
        with self._lock:
            self._running = False
            self._nonempty.notify_all()
            leftovers_q = list(self._q)
            self._q.clear()
            leftovers_a = [
                st
                for slots in self._active.values()
                for st in slots.values()
            ]
            self._active.clear()
            self._engines.clear()
        self._worker.join(max(0.1, deadline - time.perf_counter()) + 1.0)
        kind = "stopped" if drain else "error"
        for st in leftovers_q:
            if st.blocks is not None:
                try:
                    st.engine.release(st.blocks)
                except Exception:  # noqa: BLE001
                    pass
                st.blocks = None
            self._end_leftover(st, kind)
        for st in leftovers_a:
            try:
                st.engine.finish(st.slot)
            except Exception:  # noqa: BLE001
                pass
            self._end_leftover(st, kind)

    def _end_leftover(self, st: GenStream, kind: str) -> None:
        if kind == "stopped":
            self._end(
                st,
                {
                    "event": "stopped",
                    "tokens": list(st.tokens),
                    "text": self._text(st.tokens),
                    "finish_reason": "stopped",
                },
            )
        else:
            self._end(
                st, {"event": "error", "error": "batcher stopped"}
            )
