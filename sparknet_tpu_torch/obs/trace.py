"""Spans: Chrome trace-event JSON + a structured JSONL log.

The port's own copy of ``sparknet_tpu/obs/trace.py``.  Its sinks: an
installed ``Tracer``, the phase observer (``cat="phase"`` spans into the
run's ``sparknet_phase_latency_seconds``), a span observer (the round
profiler, the request profiler, or both chained), the flight recorder's
ring (``obs/flight.py``) and the fleet shipper's buffer (``obs/ship.py``,
records stamped with wall time so the collector can clock-align hosts).
A ``Tracer`` collects complete events (``ph: "X"``) from ``span()`` and
instant events (``ph: "i"``) from ``instant()``, each stamped with the OS
thread id, so the batcher worker and the HTTP handler threads show as
separate tracks in Perfetto.

Cost discipline: with no sink installed, ``span()`` returns one shared
no-op object (two global reads); with tracing on, a span is two
``perf_counter`` reads and one list append under a lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class Tracer:
    """Collects trace events; thread-safe; bounded by ``max_events``
    (the overflow is counted in ``dropped_events``)."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 max_events: int = 500_000):
        self._t0 = time.perf_counter()
        self._epoch = time.time()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._dropped = 0
        self._max_events = int(max_events)
        self._thread_names: Dict[int, str] = {}
        self._pid = os.getpid()
        # truncate: one Tracer = one run's log, as save() rewrites JSON
        self._jsonl = open(jsonl_path, "w") if jsonl_path else None
        self.jsonl_path = jsonl_path

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _note_thread(self, tid: int) -> None:
        # called under self._lock
        if tid not in self._thread_names:
            name = threading.current_thread().name
            self._thread_names[tid] = name
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": self._pid,
                "tid": tid, "args": {"name": name},
            })

    def _emit(self, ev: dict, jsonl_rec: dict) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
            else:
                self._note_thread(ev["tid"])
                self._events.append(ev)
            f = self._jsonl
        if f is not None:
            try:
                f.write(json.dumps(jsonl_rec) + "\n")
                f.flush()
            except ValueError:  # closed mid-shutdown: drop, don't die
                pass

    def complete(self, name: str, cat: str, t_start_us: float,
                 dur_us: float, args: Optional[dict] = None) -> None:
        """Record a finished span (chrome ``ph: "X"``)."""
        tid = threading.get_ident()
        ev = {
            "name": name, "cat": cat, "ph": "X",
            "ts": t_start_us, "dur": dur_us,
            "pid": self._pid, "tid": tid,
        }
        rec = {
            "kind": "span", "name": name, "cat": cat,
            "ts_s": round(t_start_us / 1e6, 6),
            "dur_ms": round(dur_us / 1e3, 4),
            "thread": threading.current_thread().name,
        }
        if args:
            ev["args"] = args
            rec["args"] = args
        self._emit(ev, rec)

    def instant(self, name: str, cat: str = "event",
                args: Optional[dict] = None) -> None:
        """Record a point event (chrome ``ph: "i"``, thread-scoped)."""
        ts = self._now_us()
        tid = threading.get_ident()
        ev = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": ts, "pid": self._pid, "tid": tid,
        }
        rec = {
            "kind": "instant", "name": name, "cat": cat,
            "ts_s": round(ts / 1e6, 6),
            "thread": threading.current_thread().name,
        }
        if args:
            ev["args"] = args
            rec["args"] = args
        self._emit(ev, rec)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path: str) -> str:
        """Write the Chrome trace-event JSON (Perfetto-loadable)."""
        with self._lock:
            doc = {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {
                    "producer": "sparknet_tpu_torch.obs",
                    "epoch_unix_s": self._epoch,
                    "dropped_events": self._dropped,
                },
            }
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


# ----------------------------------------------------------------------
# module-level fast path: install_tracer() flips span()/instant() from
# shared no-ops to recording — instrumented code never holds a Tracer

_tracer: Optional[Tracer] = None
# observes EVERY completed span: fn(name, cat, t0_s, t1_s, thread_name,
# args) with perf_counter times; the round profiler (obs/profile.py)
# and the request profiler (obs/reqtrace.py) install themselves here,
# the request profiler chaining one already installed; None = off
_span_observer = None
# the flight recorder's ring (obs/flight.py): every span and instant
# lands there too while one is installed, tracer or not
_flight = None
# observes (name, dur_s) of cat="phase" spans into the run's phase
# histogram while telemetry is on (obs.start; None = off)
_phase_observer = None
# the fleet shipper's buffer (obs/ship.py; None = off): spans and
# instants feed it like the flight ring, stamped with wall time
_ship = None


def install_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    _tracer = tracer
    return tracer


def uninstall_tracer() -> Optional[Tracer]:
    global _tracer
    t, _tracer = _tracer, None
    return t


def get_tracer() -> Optional[Tracer]:
    return _tracer


def set_phase_observer(fn) -> None:
    global _phase_observer
    _phase_observer = fn


def set_ship(shipper) -> None:
    """Point span()/instant() at a fleet shipper's buffer (None
    detaches; the ObsRun owns the lifecycle)."""
    global _ship
    _ship = shipper


def set_flight(recorder) -> None:
    """Point span()/instant() at a flight recorder's ring (None
    detaches; obs/flight.py's install/uninstall own the lifecycle)."""
    global _flight
    _flight = recorder


def set_span_observer(fn) -> None:
    """Point span() completions at a profiler (the install/uninstall
    lifecycle is obs/profile.py's and obs/reqtrace.py's)."""
    global _span_observer
    _span_observer = fn


class _NullSpan:
    """The disabled-path span: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        dur_s = t1 - self._t0
        t = _tracer
        if t is not None:
            t.complete(
                self.name, self.cat,
                (self._t0 - t._t0) * 1e6, dur_s * 1e6, self.args,
            )
        f = _flight
        if f is not None:
            rec = {
                "kind": "span", "name": self.name, "cat": self.cat,
                "t_s": round(time.time(), 3),
                "dur_ms": round(dur_s * 1e3, 4),
                "thread": threading.current_thread().name,
            }
            if self.args:
                rec["args"] = self.args
            f.record_event(rec)
        sh = _ship
        if sh is not None:
            # the full-resolution wall START time: the collector
            # subtracts the host's clock offset from it when merging
            rec = {
                "kind": "span", "name": self.name, "cat": self.cat,
                "t_s": time.time() - dur_s,
                "dur_ms": round(dur_s * 1e3, 4),
                "thread": threading.current_thread().name,
            }
            if self.args:
                rec["args"] = self.args
            sh.record_event(rec)
        po = _phase_observer
        if po is not None and self.cat == "phase":
            po(self.name, dur_s)
        so = _span_observer
        if so is not None:
            so(
                self.name, self.cat, self._t0, t1,
                threading.current_thread().name, self.args,
            )
        return False


def span(name: str, cat: str = "phase", **args):
    """Context manager timing one piece of work (``cat="phase"`` spans
    also feed the phase histogram while telemetry is on); near-free when
    no sink is installed."""
    if (_tracer is None and _span_observer is None and _flight is None
            and _phase_observer is None and _ship is None):
        return _NULL_SPAN
    return _Span(name, cat, args or None)


def instant(name: str, cat: str = "event", **args) -> None:
    """Record a tagged point event (no-op when tracing and flight
    recording are off)."""
    t = _tracer
    if t is not None:
        t.instant(name, cat, args or None)
    f = _flight
    if f is not None:
        rec = {
            "kind": "instant", "name": name, "cat": cat,
            "t_s": round(time.time(), 3),
            "thread": threading.current_thread().name,
        }
        if args:
            rec["args"] = args
        f.record_event(rec)
    sh = _ship
    if sh is not None:
        rec = {
            "kind": "instant", "name": name, "cat": cat,
            "t_s": time.time(),
            "thread": threading.current_thread().name,
        }
        if args:
            rec["args"] = args
        sh.record_event(rec)


def jsonl_path_for(trace_out: str) -> str:
    """``run.trace.json`` -> ``run.trace.jsonl`` (the structured run
    log that rides along with every Chrome trace)."""
    if trace_out.endswith(".json"):
        return trace_out[: -len(".json")] + ".jsonl"
    return trace_out + ".jsonl"
