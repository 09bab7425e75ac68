"""Declarative SLOs and multi-window burn-rate alerting over the TSDB.

The port's own copy of ``sparknet_tpu/obs/slo.py``.  An ``SLO`` names an
objective over series the run already emits:

- **availability**: the non-shed fraction: bad = the
  ``sparknet_gen_streams_shed_total{cause=...}`` family's windowed
  increase, total = admitted streams plus the sheds (a refused stream
  never reached the admitted counter);
- **latency**: a TTFT/TPOT threshold read from the histogram's bucket
  counters: the windowed increase of the first ``le >= threshold``
  bucket is the good count (the threshold snaps to the next bucket
  boundary), with a windowed-mean test when no bucket series exist;
- **round_time / straggler-free**: the training objectives over
  ``sparknet_rounds_total`` / ``sparknet_straggler_rounds_total``.

Evaluation is the multi-window multi-burn-rate rule (the Google SRE
workbook): burn rate = (bad fraction over the window) / (1 - target);
the default policy pages at 14.4x over 5 m AND 1 h and warns at 1x over
6 h.  The long window keeps a blip from paging; the short one lets the
page clear soon after the burn stops.

An alert transition shows four ways: a run-log instant (``slo_alert``,
cat ``slo``), the ``sparknet_slo_*`` families, the ``/slo`` view and the
``/healthz`` block (``obs.slo_state()``); a page also dumps the flight
recorder when one is armed.  ``signals()`` (``GET /signals``) gives the
scaling inputs (admission pressure and its trend, the queue-depth
slope, the TTFT p99 trend, each host's round rate, the error budget
left), each derived from TSDB series that ``/query`` also serves.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sparknet_tpu_torch.obs.tsdb import TSDB, bucket_quantile

# the three evaluation windows (seconds): short/mid gate the page rule,
# long carries the warn rule and the error-budget ledger
WINDOW_SHORT_S = 300.0
WINDOW_MID_S = 3600.0
WINDOW_LONG_S = 21600.0


@dataclass(frozen=True)
class BurnRule:
    """One alerting rule: fire ``severity`` when the burn rate meets
    ``burn`` over EVERY window in ``windows``."""

    severity: str  # "page" | "warn"
    burn: float
    windows: Tuple[float, ...]


DEFAULT_POLICY: Tuple[BurnRule, ...] = (
    BurnRule("page", 14.4, (WINDOW_SHORT_S, WINDOW_MID_S)),
    BurnRule("warn", 1.0, (WINDOW_LONG_S,)),
)

_SEVERITY_RANK = {"no_data": -1, "ok": 0, "warn": 1, "page": 2}
_STATUS_GAUGE = {"no_data": -1.0, "ok": 0.0, "warn": 1.0, "page": 2.0}


def window_label(w: float) -> str:
    w = int(w)
    if w % 3600 == 0:
        return "%dh" % (w // 3600)
    if w % 60 == 0:
        return "%dm" % (w // 60)
    return "%ds" % w


class SLO:
    """One declarative objective; ``indicator`` returns the windowed
    ``(bad, total)`` event counts, or None when no events moved."""

    def __init__(
        self,
        name: str,
        kind: str,
        target: float,
        description: str = "",
        bad_series: Optional[str] = None,
        bad_is_prefix: bool = False,
        total_series: Optional[str] = None,
        bad_outside_total: bool = False,
        hist: Optional[str] = None,
        threshold_s: Optional[float] = None,
        rounds_series: Optional[str] = None,
    ):
        if kind not in ("availability", "latency", "round_time"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.description = description
        self.bad_series = bad_series
        self.bad_is_prefix = bad_is_prefix
        self.total_series = total_series
        self.bad_outside_total = bad_outside_total
        self.hist = hist
        self.threshold_s = threshold_s
        self.rounds_series = rounds_series

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    # ------------------------------------------------------------------
    @classmethod
    def availability(cls, name, target, bad, total, description="",
                     bad_is_prefix=False, bad_outside_total=True):
        """``bad_outside_total=True`` when the bad counter's events are
        NOT included in the total counter (a shed stream never reached
        the admitted total); False when they are (a straggler round IS
        a round)."""
        return cls(
            name, "availability", target, description,
            bad_series=bad, bad_is_prefix=bad_is_prefix,
            total_series=total, bad_outside_total=bad_outside_total,
        )

    @classmethod
    def latency(cls, name, target, hist, threshold_s, description=""):
        return cls(
            name, "latency", target, description,
            hist=hist, threshold_s=float(threshold_s),
        )

    @classmethod
    def round_time(cls, name, target, rounds, threshold_s,
                   description=""):
        return cls(
            name, "round_time", target, description,
            rounds_series=rounds, threshold_s=float(threshold_s),
        )

    # ------------------------------------------------------------------
    def indicator(
        self, tsdb: TSDB, window_s: float, now: float,
        host: Optional[str] = None,
    ) -> Optional[Tuple[float, float]]:
        if self.kind == "availability":
            if self.bad_is_prefix:
                bad, _ = tsdb.window_delta_prefix(
                    self.bad_series, window_s, now, host=host
                )
            else:
                bad, _ = tsdb.window_delta(
                    self.bad_series, window_s, now, host=host
                )
            total, _ = tsdb.window_delta(
                self.total_series, window_s, now, host=host
            )
            if self.bad_outside_total:
                total += bad
            return (bad, total) if total > 0 else None
        if self.kind == "latency":
            hw = tsdb.histogram_window(self.hist, window_s, now, host=host)
            if hw is None:
                return None
            total = hw["count"]
            les = hw["le"]
            if les:
                good = 0.0
                for le, inc in les:
                    if le >= self.threshold_s - 1e-12:
                        good = inc
                        break
                return (max(0.0, total - good), total)
            # no bucket series shipped: windowed-mean fallback (the
            # whole window is good or bad as one event batch)
            mean = hw["sum"] / total
            return (total if mean > self.threshold_s else 0.0, total)
        # round_time: seconds-per-round over the covered span.  A
        # single round in the window is unjudgeable — its "span" is
        # whatever rollup-bucket granularity it landed in, not a
        # measured cadence — so cold starts report no_data instead of
        # a spurious first-eval alert.
        delta, span = tsdb.window_delta(
            self.rounds_series, window_s, now, host=host
        )
        if delta < 2 or span <= 0:
            return None
        rt = span / delta
        return (delta if rt > self.threshold_s else 0.0, delta)


def default_slos(
    ttft_threshold_s: float = 0.5,
    tpot_threshold_s: float = 0.05,
    round_time_threshold_s: float = 30.0,
) -> List[SLO]:
    """The stock objective set over series the stack already emits."""
    return [
        SLO.availability(
            "serve-availability", 0.999,
            bad="sparknet_gen_streams_shed_total{",
            bad_is_prefix=True,
            total="sparknet_gen_streams_total",
            bad_outside_total=True,
            description="non-shed fraction of arriving generation "
            "streams (sheds by any cause count against the budget)",
        ),
        SLO.latency(
            "serve-ttft-p99", 0.99,
            hist="sparknet_gen_ttft_seconds",
            threshold_s=ttft_threshold_s,
            description="fraction of streams whose submit->first-token "
            "latency beat the threshold",
        ),
        SLO.latency(
            "serve-tpot-p99", 0.99,
            hist="sparknet_gen_intertoken_seconds",
            threshold_s=tpot_threshold_s,
            description="fraction of decode steps whose inter-token "
            "gap beat the threshold",
        ),
        SLO.round_time(
            "train-round-time", 0.99,
            rounds="sparknet_rounds_total",
            threshold_s=round_time_threshold_s,
            description="rounds completing under the per-round "
            "wall-clock threshold (windowed seconds-per-round)",
        ),
        SLO.availability(
            "train-straggler-free", 0.9,
            bad="sparknet_straggler_rounds_total",
            total="sparknet_rounds_total",
            bad_outside_total=False,
            description="fraction of rounds without a straggler "
            "verdict",
        ),
    ]


class SLOEvaluator:
    """Evaluates the objective set over the TSDB, remembers alert
    transitions, exports the metric families, and serves the
    ``/slo`` + ``/signals`` payloads."""

    def __init__(
        self,
        tsdb: TSDB,
        slos: Optional[List[SLO]] = None,
        registry=None,
        policy: Tuple[BurnRule, ...] = DEFAULT_POLICY,
        eval_interval_s: float = 15.0,
        host: Optional[str] = None,
        live_registry=None,
        signal_window_s: float = WINDOW_SHORT_S,
    ):
        self.tsdb = tsdb
        self.slos = list(default_slos() if slos is None else slos)
        self.policy = tuple(
            sorted(policy, key=lambda r: -_SEVERITY_RANK[r.severity])
        )
        self.eval_interval_s = float(eval_interval_s)
        self.host = host
        self.live_registry = live_registry
        self.signal_window_s = float(signal_window_s)
        self.alerts: deque = deque(maxlen=256)
        self._status: Dict[str, str] = {}
        self._eval_lock = threading.Lock()
        self._last_eval_t: Optional[float] = None
        self._last_payload: Optional[Dict] = None
        self._windows = tuple(sorted({
            w for rule in self.policy for w in rule.windows
        }))
        self._m_burn = self._m_budget = None
        self._m_status = self._m_alerts = None
        self._sig_pressure = self._sig_qslope = None
        self._sig_p99trend = self._sig_roundrate = None
        self._sig_budget_min = None
        if registry is not None:
            r = registry
            self._m_burn = r.get("sparknet_slo_burn_rate") or r.gauge(
                "sparknet_slo_burn_rate",
                "error-budget burn rate per objective and window "
                "(1.0 = burning exactly the budget; the page rule "
                "fires at 14.4x over the short AND mid windows)",
                labels=("slo", "window"),
            )
            self._m_budget = (
                r.get("sparknet_slo_error_budget_remaining") or r.gauge(
                    "sparknet_slo_error_budget_remaining",
                    "fraction of the error budget left over the long "
                    "window (1.0 = untouched, 0.0 = exhausted)",
                    labels=("slo",),
                )
            )
            self._m_status = r.get("sparknet_slo_status") or r.gauge(
                "sparknet_slo_status",
                "objective state (-1 no data, 0 ok, 1 warn, 2 page)",
                labels=("slo",),
            )
            self._m_alerts = (
                r.get("sparknet_slo_alerts_total") or r.counter(
                    "sparknet_slo_alerts_total",
                    "alert transitions by objective and severity "
                    "(page/warn on entry, recover on return to ok)",
                    labels=("slo", "severity"),
                )
            )
            self._sig_pressure = (
                r.get("sparknet_signal_admission_pressure") or r.gauge(
                    "sparknet_signal_admission_pressure",
                    "fraction of arriving streams refused at admission "
                    "over the signal window (sheds / arrivals)",
                )
            )
            self._sig_qslope = (
                r.get("sparknet_signal_queue_depth_slope") or r.gauge(
                    "sparknet_signal_queue_depth_slope",
                    "least-squares slope of the serve queue-depth "
                    "gauge over the signal window (streams per second)",
                )
            )
            self._sig_p99trend = (
                r.get("sparknet_signal_p99_trend") or r.gauge(
                    "sparknet_signal_p99_trend",
                    "windowed TTFT p99 vs the preceding window "
                    "(1.0 = flat, >1 = degrading)",
                )
            )
            self._sig_roundrate = (
                r.get("sparknet_signal_round_rate") or r.gauge(
                    "sparknet_signal_round_rate",
                    "per-host training rounds per second over the "
                    "signal window",
                    labels=("host",),
                )
            )
            self._sig_budget_min = (
                r.get("sparknet_signal_error_budget_min") or r.gauge(
                    "sparknet_signal_error_budget_min",
                    "smallest error-budget-remaining fraction across "
                    "the objective set (the autoscaler's caution "
                    "input)",
                )
            )

    # ------------------------------------------------------------------
    def maybe_evaluate(self, now: Optional[float] = None) -> Optional[Dict]:
        """Rate-limited ``evaluate`` — the per-push hook."""
        now = time.time() if now is None else float(now)
        if (
            self._last_eval_t is not None
            and now - self._last_eval_t < self.eval_interval_s
        ):
            return None
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> Dict:
        """One full evaluation pass: burn rates per window, policy
        fold, alert transitions, metric export.  Returns the ``/slo``
        payload."""
        now = time.time() if now is None else float(now)
        with self._eval_lock:
            self._last_eval_t = (
                now if self._last_eval_t is None
                else max(self._last_eval_t, now)
            )
            rows = []
            for slo in self.slos:
                rows.append(self._evaluate_one(slo, now))
            payload = {
                "t": now,
                "host": self.host or "fleet",
                "policy": [
                    {
                        "severity": r.severity,
                        "burn": r.burn,
                        "windows": [window_label(w) for w in r.windows],
                    }
                    for r in self.policy
                ],
                "slos": rows,
                "alerts": list(self.alerts)[-32:],
            }
            self._last_payload = payload
            return payload

    def _evaluate_one(self, slo: SLO, now: float) -> Dict:
        frac: Dict[float, Optional[float]] = {}
        for w in self._windows:
            ind = slo.indicator(self.tsdb, w, now, host=self.host)
            if ind is None:
                frac[w] = None
            else:
                bad, total = ind
                frac[w] = (bad / total) if total > 0 else None
        burn = {
            w: (None if frac[w] is None else frac[w] / slo.budget)
            for w in self._windows
        }
        status = "ok"
        if all(frac[w] is None for w in self._windows):
            status = "no_data"
        else:
            for rule in self.policy:  # page first (severity-sorted)
                if all(
                    burn[w] is not None and burn[w] >= rule.burn
                    for w in rule.windows
                ):
                    status = rule.severity
                    break
        long_w = self._windows[-1]
        budget_remaining = (
            1.0 if frac[long_w] is None
            else max(0.0, 1.0 - frac[long_w] / slo.budget)
        )
        self._transition(slo, status, burn, now)
        if self._m_burn is not None:
            for w in self._windows:
                self._m_burn.labels(slo.name, window_label(w)).set(
                    burn[w] or 0.0
                )
            self._m_budget.labels(slo.name).set(budget_remaining)
            self._m_status.labels(slo.name).set(_STATUS_GAUGE[status])
        row = {
            "name": slo.name,
            "kind": slo.kind,
            "target": slo.target,
            "description": slo.description,
            "status": status,
            "budget_remaining": round(budget_remaining, 6),
            "windows": {
                window_label(w): {
                    "bad_frac": (
                        None if frac[w] is None else round(frac[w], 6)
                    ),
                    "burn": (
                        None if burn[w] is None else round(burn[w], 3)
                    ),
                }
                for w in self._windows
            },
        }
        if slo.threshold_s is not None:
            row["threshold_s"] = slo.threshold_s
        return row

    def _transition(self, slo: SLO, status: str, burn, now: float) -> None:
        prev = self._status.get(slo.name, "ok")
        self._status[slo.name] = status
        eff_prev = "ok" if prev == "no_data" else prev
        eff = "ok" if status == "no_data" else status
        if eff == eff_prev:
            return
        severity = eff if eff in ("warn", "page") else "recover"
        rec = {
            "t": round(now, 3),
            "slo": slo.name,
            "severity": severity,
            "from": eff_prev,
            "to": eff,
            "burn": {
                window_label(w): (None if b is None else round(b, 3))
                for w, b in burn.items()
            },
        }
        self.alerts.append(rec)
        if self._m_alerts is not None:
            self._m_alerts.labels(slo.name, severity).inc()
        from sparknet_tpu_torch.obs import trace as _trace

        _trace.instant(
            "slo_alert", cat="slo", slo=slo.name, severity=severity,
            prev=eff_prev, burn=rec["burn"],
        )
        if severity == "page":
            from sparknet_tpu_torch.obs import flight as _flight

            _flight.dump_if_active(
                "slo_page", extra={"slo": slo.name, "burn": rec["burn"]}
            )

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        """The compact /healthz block (statuses + recent alerts)."""
        statuses = dict(self._status) or {
            s.name: "no_data" for s in self.slos
        }
        worst = max(
            statuses.values(),
            key=lambda s: _SEVERITY_RANK[s],
            default="no_data",
        )
        return {
            "status": worst,
            "slos": statuses,
            "alerts": list(self.alerts)[-5:],
            "evaluated_t": self._last_eval_t,
        }

    # ------------------------------------------------------------------
    def signals(self, now: Optional[float] = None) -> Dict:
        """The scaling-signal payload (``GET /signals``): every value
        is derived from TSDB series ``/query`` also serves, so a
        consumer can audit any input."""
        now = self._last_eval_t if now is None else float(now)
        if now is None:
            now = time.time()
        w = self.signal_window_s
        host = self.host
        tsdb = self.tsdb
        shed, _ = tsdb.window_delta_prefix(
            "sparknet_gen_streams_shed_total{", w, now, host=host
        )
        admitted, _ = tsdb.window_delta(
            "sparknet_gen_streams_total", w, now, host=host
        )
        arrivals = admitted + shed
        pressure = shed / arrivals if arrivals > 0 else 0.0
        shed_p, _ = tsdb.window_delta_prefix(
            "sparknet_gen_streams_shed_total{", w, now - w, host=host
        )
        adm_p, _ = tsdb.window_delta(
            "sparknet_gen_streams_total", w, now - w, host=host
        )
        arr_p = adm_p + shed_p
        pressure_prev = shed_p / arr_p if arr_p > 0 else 0.0
        queue_series = "sparknet_gen_active_streams"
        if queue_series not in self.tsdb.series_names(queue_series):
            queue_series = "sparknet_feed_queue_depth"
        qslope = tsdb.slope_per_s(queue_series, w, now, host=host)
        p99 = p99_prev = 0.0
        hw = tsdb.histogram_window(
            "sparknet_gen_ttft_seconds", w, now, host=host
        )
        if hw is not None:
            p99 = bucket_quantile(hw["le"], 0.99)
        hw_p = tsdb.histogram_window(
            "sparknet_gen_ttft_seconds", w, now - w, host=host
        )
        if hw_p is not None:
            p99_prev = bucket_quantile(hw_p["le"], 0.99)
        p99_trend = (p99 / p99_prev) if p99_prev > 0 else (
            0.0 if p99 == 0 else 1.0
        )
        p99_live = None
        if self.live_registry is not None:
            h = self.live_registry.get("sparknet_gen_ttft_seconds")
            if h is not None and hasattr(h, "window_quantile"):
                p99_live = h.window_quantile(0.99, window_s=w)
        round_rate: Dict[str, float] = {}
        for h in tsdb.hosts():
            delta, span = tsdb.window_delta(
                "sparknet_rounds_total", w, now, host=h
            )
            if span > 0:
                round_rate[h] = round(delta / span, 6)
        budgets: Dict[str, float] = {}
        long_w = self._windows[-1]
        for slo in self.slos:
            ind = slo.indicator(self.tsdb, long_w, now, host=host)
            if ind is None:
                budgets[slo.name] = 1.0
            else:
                bad, total = ind
                f = bad / total if total > 0 else 0.0
                budgets[slo.name] = round(
                    max(0.0, 1.0 - f / slo.budget), 6
                )
        budget_min = min(budgets.values()) if budgets else 1.0
        if self._sig_pressure is not None:
            self._sig_pressure.set(pressure)
            self._sig_qslope.set(qslope)
            self._sig_p99trend.set(p99_trend)
            for h, rr in round_rate.items():
                self._sig_roundrate.labels(h).set(rr)
            self._sig_budget_min.set(budget_min)
        out = {
            "t": now,
            "window_s": w,
            "admission_pressure": round(pressure, 6),
            "admission_pressure_trend": round(
                pressure - pressure_prev, 6
            ),
            "queue_depth_series": queue_series,
            "queue_depth_slope_per_s": round(qslope, 6),
            "ttft_p99_s": round(p99, 6),
            "ttft_p99_trend": round(p99_trend, 4),
            "round_rate_per_s": round_rate,
            "error_budget_remaining": budgets,
            "error_budget_min": round(budget_min, 6),
        }
        if p99_live is not None:
            out["ttft_p99_live_s"] = round(p99_live, 6)
        return out


class TsdbSampler:
    """Single-host retention loop: snapshots the process registry into
    the TSDB every interval and runs the SLO evaluator — the piece
    that gives a ``--slo`` run without a fleet collector the same
    ``/query`` + ``/slo`` surface."""

    def __init__(
        self,
        tsdb: TSDB,
        registry,
        evaluator: Optional[SLOEvaluator] = None,
        host: str = "local",
        interval_s: float = 1.0,
    ):
        self.tsdb = tsdb
        self.registry = registry
        self.evaluator = evaluator
        self.host = host
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def sample_once(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        snap = self.registry.snapshot()
        self.tsdb.record_snapshot(
            self.host, snap["counters"], snap["gauges"], now
        )
        if self.evaluator is not None:
            self.evaluator.maybe_evaluate(now)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 — telemetry must not die
                self.last_error = e

    def start(self) -> "TsdbSampler":
        self._thread = threading.Thread(
            target=self._run, name="obs-tsdb-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        # one final sample so short runs land their tail
        try:
            self.sample_once()
        except Exception as e:  # noqa: BLE001 — teardown must not die
            self.last_error = e
