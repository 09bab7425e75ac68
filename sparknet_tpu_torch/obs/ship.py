"""Per-host telemetry shipper: the push side of the fleet plane.

The port's own copy of ``sparknet_tpu/obs/ship.py``.  The registry, the
tracer, the sentry and the round profiler each see one process;
``Shipper`` pushes what this process sees to a ``FleetCollector``
(``obs/fleet.py``) over HTTP:

- **metric deltas**: counter increments since the last successful push
  (``MetricsRegistry.snapshot()`` + ``counter_deltas()``, reset-safe),
  plus the current gauge values;
- **run-log events**: the span/instant records the flight recorder
  rings (``obs/trace.py`` feeds the shipper as it feeds the flight
  ring), stamped with wall time so the collector can merge N hosts'
  traces onto one clock-aligned timeline;
- **a round heartbeat**: the newest round seen in span args, which the
  collector's late/dead attribution reads.

Degradation contract (what keeps training safe):

- shipping runs on its own thread (``obs-shipper``): a training thread
  never blocks on the network; ``record_event`` is a bounded deque
  append under a lock;
- when the collector is unreachable the push retries under a small
  ``utils/retry`` budget, then the events stay buffered and the loop
  backs off exponentially (capped); counter deltas are not lost either,
  since the previous snapshot advances only on a successful push;
- the buffer is bounded: overflow drops the oldest events and counts
  them (``sparknet_ship_dropped_total`` and the payload's
  ``dropped_total``).

Seams: ``SPARKNET_SHIP_INTERVAL_S`` overrides the flush cadence and
``SPARKNET_SHIP_CLOCK_SKEW_S`` skews this host's reported wall clock,
which the collector's clock alignment must recover.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.request
import uuid
from collections import deque
from typing import Dict, List, Optional

DEFAULT_INTERVAL_S = 0.5
DEFAULT_CAPACITY = 8192
DEFAULT_MAX_BATCH = 1024
# push attempts within one flush (fail fast, keep buffering); the flush
# loop adds its own exponential inter-flush backoff on top
_PUSH_TIMEOUT_S = 2.0
_BACKOFF_CAP_S = 5.0


def default_host_id() -> str:
    """Stable-enough per-process host identity: the env override first
    (multi-process launchers set it per worker), else host:pid."""
    return os.environ.get(
        "SPARKNET_HOST_ID", f"{socket.gethostname()}:{os.getpid()}"
    )


class Shipper:
    """Pushes this process's metric deltas + run-log events to a fleet
    collector from a dedicated thread.  Construct, ``start()``, and
    ``stop()`` in the run's ``finally`` (stop attempts one final
    flush so a clean shutdown ships its tail)."""

    def __init__(
        self,
        collector_url: str,
        host: Optional[str] = None,
        interval_s: Optional[float] = None,
        capacity: int = DEFAULT_CAPACITY,
        max_batch: int = DEFAULT_MAX_BATCH,
        registry=None,
    ):
        self.url = collector_url.rstrip("/")
        if "://" not in self.url:
            self.url = "http://" + self.url
        self.host = host or default_host_id()
        env_iv = os.environ.get("SPARKNET_SHIP_INTERVAL_S")
        self.interval_s = float(
            interval_s if interval_s is not None
            else (env_iv or DEFAULT_INTERVAL_S)
        )
        # test seam: a skewed host clock (the whole host's wall
        # clock reads shifted) — collector alignment must recover it
        self.clock_skew_s = float(
            os.environ.get("SPARKNET_SHIP_CLOCK_SKEW_S", "0") or 0.0
        )
        self.capacity = int(capacity)
        self.max_batch = int(max_batch)
        self._registry = registry  # None -> the training registry, lazily
        self.boot_id = uuid.uuid4().hex
        self._lock = threading.Lock()
        self._buf: deque = deque()
        self._prev_counters: Dict[str, float] = {}
        self._seq = 0
        self._max_round: Optional[int] = None
        # cumulative shipper-side accounting (also mirrored onto the
        # sparknet_ship_* registry series when metrics are enabled)
        self.events_total = 0
        self.dropped_total = 0
        self.pushes_total = 0
        self.push_failures_total = 0
        self.resets_seen: List[str] = []
        self._stop_evt = threading.Event()
        self._backoff_s = 0.0
        self._drain_deadline: Optional[float] = None
        self._thread = threading.Thread(
            target=self._loop, name="obs-shipper", daemon=True
        )

    # ------------------------------------------------------------------
    # hot-path side: called by the trace layer on training threads
    def record_event(self, rec: Dict) -> None:
        """Buffer one span/instant record (the trace layer's JSONL
        shape).  Bounded, never blocks; the shipper's own thread's
        events are skipped (a push's spans must not feed the next
        push's payload forever)."""
        if threading.current_thread() is self._thread:
            return
        args = rec.get("args")
        r = args.get("round") if isinstance(args, dict) else None
        with self._lock:
            self.events_total += 1
            if isinstance(r, int) and (
                self._max_round is None or r > self._max_round
            ):
                self._max_round = r
            self._buf.append(rec)
            while len(self._buf) > self.capacity:
                self._buf.popleft()
                self.dropped_total += 1

    def note_round(self, r: int) -> None:
        """Explicit round heartbeat (a loop whose spans carry no
        ``round=`` arg still feeds the late/dead attribution)."""
        with self._lock:
            if self._max_round is None or int(r) > self._max_round:
                self._max_round = int(r)

    # ------------------------------------------------------------------
    def start(self) -> "Shipper":
        self._thread.start()
        return self

    def stop(self, flush_timeout_s: float = 5.0) -> None:
        """Signal the ship thread and wait for its final DRAIN: the
        exit path flushes repeatedly (bounded by ``flush_timeout_s``)
        until the buffer is empty — a backlog larger than one batch is
        not silently abandoned on a clean exit — and the last payload
        carries ``final: true``, the terminal heartbeat that tells the
        collector this host FINISHED (it is never later classified
        ``dead`` for going quiet)."""
        self._drain_deadline = time.monotonic() + float(flush_timeout_s)
        self._stop_evt.set()
        self._thread.join(timeout=flush_timeout_s + 1.0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def buffered(self) -> int:
        with self._lock:
            return len(self._buf)

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s + self._backoff_s):
            ok = self._flush()
            if ok:
                self._backoff_s = 0.0
            else:
                # exponential inter-flush backoff, capped — an
                # unreachable collector must not be hammered at the
                # flush cadence
                self._backoff_s = min(
                    _BACKOFF_CAP_S, max(self.interval_s, self._backoff_s * 2)
                )
        self._drain_tail()  # bounded final drain + terminal heartbeat

    def _drain_tail(self) -> None:
        """Clean-exit drain: flush until the buffer is empty (each
        push moves at most ``max_batch`` events — one final flush used
        to strand a larger backlog) or the stop() deadline passes.
        The LAST push is marked ``final`` so the collector records the
        host as finished instead of letting the dead-after deadline
        condemn a cleanly-exited process."""
        deadline = self._drain_deadline or (time.monotonic() + 5.0)
        while True:
            # the LAST push of the drain is always the final one: when
            # the remaining backlog fits one batch, or when the
            # deadline forces an early exit (a timed-out drain still
            # delivers the terminal heartbeat; only a DOWN collector —
            # a failed push — exits without one, and a down collector
            # could not have received it anyway)
            final = (
                self.buffered() <= self.max_batch
                or time.monotonic() >= deadline
            )
            ok = self._flush(final=final)
            if not ok:
                # collector down: _flush already spent its retry
                # budget — a clean exit must not stall on an outage
                # (whatever remains stays accounted in dropped/lost)
                return
            if final:
                return  # terminal heartbeat delivered

    def _snapshot(self):
        reg = self._registry
        if reg is None:
            from sparknet_tpu_torch import obs as _obs

            tm = _obs.training_metrics()
            reg = tm.registry if tm is not None else None
        if reg is None:
            return {"counters": {}, "gauges": {}}
        return reg.snapshot()

    def _flush(self, final: bool = False) -> bool:
        """Compose one push from the buffered events + the counter
        delta since the last SUCCESSFUL push; returns success.  On
        failure everything stays buffered (events re-queued, snapshot
        not advanced) so nothing is lost while the collector is down —
        only a buffer overflow drops (and counts) events.  ``final``
        marks the payload as this host's terminal heartbeat."""
        from sparknet_tpu_torch.obs.metrics import counter_deltas
        from sparknet_tpu_torch.utils import retry as _retry

        with self._lock:
            pending = []
            while self._buf and len(pending) < self.max_batch:
                pending.append(self._buf.popleft())
            max_round = self._max_round
            # the accounting the collector's lost-event check consumes:
            # enqueued events MINUS the ones still buffered here (they
            # are neither delivered nor lost yet — a backlog larger
            # than one batch must not read as loss)
            events_total = self.events_total - len(self._buf)
            dropped_total = self.dropped_total
        if self.clock_skew_s:
            # the skewed-clock seam covers the whole host clock: event
            # stamps ship as this host's (skewed) wall time too, so the
            # collector's alignment is what un-skews them (copies —
            # the buffered originals stay true for a failed-push requeue)
            skewed = []
            for rec in pending:
                t = rec.get("t_s")
                if isinstance(t, (int, float)):
                    rec = dict(rec, t_s=t + self.clock_skew_s)
                skewed.append(rec)
            ship_events = skewed
        else:
            ship_events = pending
        snap = self._snapshot()
        deltas, resets = counter_deltas(
            self._prev_counters, snap["counters"]
        )
        payload = {
            "v": 1,
            "host": self.host,
            "boot_id": self.boot_id,
            "seq": self._seq,
            "t_send": time.time() + self.clock_skew_s,
            "round": max_round,
            "counters": deltas,
            "gauges": snap["gauges"],
            "events": ship_events,
            "events_total": events_total,
            "dropped_total": dropped_total,
            "resets": resets,
            "final": bool(final),
        }
        body = json.dumps(payload, default=str).encode("utf-8")
        policy = _retry.RetryPolicy(
            max_attempts=3, base_s=0.05, cap_s=0.5, budget_s=2.0
        )

        def attempt():
            req = urllib.request.Request(
                self.url + "/push", data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=_PUSH_TIMEOUT_S) as rsp:
                rsp.read()

        try:
            _retry.retry_call(attempt, policy=policy)
        except Exception:  # noqa: BLE001 — collector down: keep buffering
            with self._lock:
                self.push_failures_total += 1
                # requeue in order; the bound then drops the OLDEST
                self._buf.extendleft(reversed(pending))
                while len(self._buf) > self.capacity:
                    self._buf.popleft()
                    self.dropped_total += 1
            self._mirror_metrics()
            return False
        self._prev_counters = snap["counters"]
        with self._lock:
            self._seq += 1
            self.pushes_total += 1
            if resets:
                self.resets_seen.extend(resets)
        self._mirror_metrics()
        return True

    def _mirror_metrics(self) -> None:
        """Mirror the shipper's own accounting onto the sparknet_ship_*
        series (no-op until training metrics are enabled).  Counters are
        monotonic: set via inc-by-difference."""
        from sparknet_tpu_torch import obs as _obs

        tm = _obs.training_metrics()
        if tm is None:
            return
        for counter, value in (
            (tm.ship_events, self.events_total),
            (tm.ship_dropped, self.dropped_total),
            (tm.ship_pushes, self.pushes_total),
            (tm.ship_push_failures, self.push_failures_total),
        ):
            d = value - counter.value
            if d > 0:
                counter.inc(d)
