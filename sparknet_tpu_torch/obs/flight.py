"""Crash flight recorder: a bounded ring of recent telemetry, dumped as
one postmortem JSON bundle when a run dies.

The port's own copy of ``sparknet_tpu/obs/flight.py``.  While installed
the recorder receives every span and instant of ``obs/trace.py`` (with
or without a ``Tracer``), every ``HealthSentry`` verdict and its metric
samples (loss and grad norm a round).  ``dump(reason)`` writes the
bundle atomically; it fires on an uncaught exception (chained
``sys.excepthook``), on SIGTERM (chained handler, and any SIGTERM a
``utils.signals.SignalHandler`` fields) and on a sentry halt or
rollback (``obs/health.py``).  Repeated dumps overwrite the same path
(``dump_index`` counts them).  Bundles are the JAX package's: each
package's ``load_bundle`` reads the other's.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional

DEFAULT_BUNDLE_PATH = "flight_postmortem.json"

_active: Optional["FlightRecorder"] = None


class FlightRecorder:
    """Bounded in-memory rings + the atomic postmortem dump.
    ``metrics`` (a ``TrainingMetrics``), when set, is rendered into the
    bundle."""

    def __init__(self, path: str = DEFAULT_BUNDLE_PATH, capacity: int = 4096,
                 metrics=None):
        self.path = path
        self.metrics = metrics
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self._verdicts: deque = deque(maxlen=512)
        self._samples: deque = deque(maxlen=1024)
        self._dumps = 0
        self._t0 = time.time()
        self._prev_excepthook = None
        self._prev_sigterm = None

    # ------------------------------------------------------------------
    def record_event(self, rec: Dict) -> None:
        """A span/instant record (the trace layer's JSONL shape)."""
        with self._lock:
            self._events.append(rec)

    def record_verdict(self, verdict: Dict) -> None:
        """Record (or refresh) a round's health verdict: a re-record of
        the same round (the sentry's ``action`` filled in) replaces the
        earlier one."""
        with self._lock:
            if self._verdicts and \
                    self._verdicts[-1].get("round") == verdict.get("round"):
                self._verdicts[-1] = verdict
            else:
                self._verdicts.append(verdict)

    def record_sample(self, name: str, value, **labels) -> None:
        rec = {"name": name, "value": value,
               "t_s": round(time.time() - self._t0, 3)}
        rec.update(labels)
        with self._lock:
            self._samples.append(rec)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"events": len(self._events),
                    "verdicts": len(self._verdicts),
                    "samples": len(self._samples)}

    # ------------------------------------------------------------------
    def dump(self, reason: str, extra: Optional[Dict] = None) -> str:
        """Write the postmortem bundle (tmp + rename).  Never raises: a
        failing dump must not mask the crash it documents."""
        from sparknet_tpu_torch import obs as _obs

        with self._lock:
            self._dumps += 1
            bundle = {
                "kind": "sparknet_flight_bundle",
                "version": 1,
                "reason": reason,
                "wall_time_unix_s": time.time(),
                "uptime_s": round(time.time() - self._t0, 3),
                "pid": os.getpid(),
                "dump_index": self._dumps,
                "events": list(self._events),
                "verdicts": list(self._verdicts),
                "samples": list(self._samples),
            }
        if extra:
            bundle["extra"] = extra
        try:
            bundle["sentry"] = _obs.sentry_state()
            bundle["metrics_text"] = (self.metrics.registry.render()
                                      if self.metrics is not None else None)
        except Exception:  # noqa: BLE001 — the postmortem must not die
            pass
        try:
            tmp = f"{self.path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(bundle, f, default=str)
            os.replace(tmp, self.path)
        except Exception:  # noqa: BLE001 — runs inside the crash paths
            pass
        return self.path

    # ------------------------------------------------------------------
    # crash + SIGTERM chaining (installed by install())
    def _excepthook(self, etype, exc, tb):
        self.dump(f"crash:{etype.__name__}",
                  extra={"exception": repr(exc)[:500]})
        hook = self._prev_excepthook or sys.__excepthook__
        hook(etype, exc, tb)

    def _sigterm(self, signum, frame):
        self.dump("signal_SIGTERM")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == _signal.SIG_DFL:
            # the default terminate semantics, after the dump
            _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
            os.kill(os.getpid(), _signal.SIGTERM)


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Make ``recorder`` the process's flight recorder: trace events feed
    its ring, crash and SIGTERM dumps are chained.  A second install
    replaces the first."""
    global _active
    if _active is not None:
        uninstall(_active)
    _active = recorder
    from sparknet_tpu_torch.obs import trace as _trace

    _trace.set_flight(recorder)
    recorder._prev_excepthook = sys.excepthook
    sys.excepthook = recorder._excepthook
    try:  # signals bind on the main thread only
        recorder._prev_sigterm = _signal.getsignal(_signal.SIGTERM)
        _signal.signal(_signal.SIGTERM, recorder._sigterm)
    except ValueError:
        recorder._prev_sigterm = None
    return recorder


def uninstall(recorder: Optional[FlightRecorder] = None) -> None:
    """Detach the active recorder and put back the hooks it chained (its
    bundles stay on disk)."""
    global _active
    rec = recorder if recorder is not None else _active
    if rec is None or rec is not _active:
        return
    _active = None
    from sparknet_tpu_torch.obs import trace as _trace

    _trace.set_flight(None)
    if sys.excepthook == rec._excepthook:
        sys.excepthook = rec._prev_excepthook or sys.__excepthook__
    try:
        if _signal.getsignal(_signal.SIGTERM) == rec._sigterm:
            _signal.signal(_signal.SIGTERM, rec._prev_sigterm or _signal.SIG_DFL)
    except ValueError:
        pass


def active() -> Optional[FlightRecorder]:
    return _active


def record_verdict(verdict: Dict) -> None:
    rec = _active
    if rec is not None:
        rec.record_verdict(verdict)


def record_sample(name: str, value, **labels) -> None:
    rec = _active
    if rec is not None:
        rec.record_sample(name, value, **labels)


def dump_if_active(reason: str, extra: Optional[Dict] = None) -> Optional[str]:
    """Dump the bundle if a recorder is installed (a no-op otherwise)."""
    rec = _active
    if rec is None:
        return None
    return rec.dump(reason, extra=extra)


def load_bundle(path: str) -> Dict:
    """Read and sanity-check a dumped bundle."""
    with open(path) as f:
        bundle = json.load(f)
    if bundle.get("kind") != "sparknet_flight_bundle":
        raise ValueError(f"{path}: not a sparknet flight bundle")
    return bundle
