"""In-process time-series store: the retention half of the obs plane.

The port's own copy of ``sparknet_tpu/obs/tsdb.py``.  ``/metrics``
answers "what is the counter now"; this store answers "how fast has it
moved over the last hour".  Fixed-interval ring buffers per series x
host with staged downsampling: raw 1 s buckets cascade into 10 s and
60 s rollups, each bucket carrying min/max/sum/count/last.  Memory is
bounded by construction: every stage is a preallocated ``array('d')``
ring, a new series is admitted only while the accounted byte budget
holds, and nothing grows per sample.

- **Series identity** is the full inline-labeled sample name as
  ``MetricsRegistry.snapshot()`` keys it (``m{cause="queue_full"}``) x
  the reporting host.
- **Counters are stored cumulative** (a bucket's ``last`` is the running
  total); a bucket's rate is derived at query time from consecutive
  ``last`` samples with Prometheus reset semantics.  Gauges use the same
  bucket statistics with ``last`` as the newest level.
- **Downsampling is exact**: every record lands in all stages at once,
  so a 60 s bucket's sum/count/min/max fold exactly the raw samples of
  its span.
- **Queries are sparse**: empty buckets are skipped, the stage is the
  finest one covering the requested range at (or above) the requested
  step, and the response states the step it used.

``obs/slo.py`` evaluates burn-rate objectives over this store;
``obs/fleet.py`` records every merged push into it and serves
``GET /query``.
"""

from __future__ import annotations

import re
import threading
from array import array
from typing import Dict, List, Optional, Sequence, Tuple

# staged retention: (bucket seconds, bucket count) — 1 s raw for 5 min,
# 10 s rollups for 70 min, 60 s rollups for 7 h (the 6 h burn-rate
# window fits the coarsest stage with headroom)
DEFAULT_STAGES: Tuple[Tuple[float, int], ...] = (
    (1.0, 300),
    (10.0, 420),
    (60.0, 420),
)
DEFAULT_BUDGET_BYTES = 32 << 20
# fixed per-series overhead charged against the budget beyond the rings
# (dict slots, key strings, object headers — a deliberate overestimate)
SERIES_OVERHEAD_BYTES = 512

_LE_RE = re.compile(r'le="([^"]+)"')


class _Stage:
    """One fixed-step ring of rollup buckets for one series."""

    __slots__ = ("step", "cap", "mn", "mx", "sm", "ct", "last", "newest")

    def __init__(self, step: float, cap: int):
        self.step = float(step)
        self.cap = int(cap)
        zeros = [0.0] * self.cap
        self.mn = array("d", zeros)
        self.mx = array("d", zeros)
        self.sm = array("d", zeros)
        self.last = array("d", zeros)
        self.ct = array("q", [0] * self.cap)
        self.newest: Optional[int] = None  # absolute bucket index

    def nbytes(self) -> int:
        return sum(
            a.buffer_info()[1] * a.itemsize
            for a in (self.mn, self.mx, self.sm, self.last, self.ct)
        )

    def record(self, t: float, v: float) -> None:
        b = int(t // self.step)
        if self.newest is None:
            self.newest = b
        elif b > self.newest:
            span = b - self.newest
            if span >= self.cap:
                for i in range(self.cap):
                    self.ct[i] = 0
            else:
                for k in range(self.newest + 1, b + 1):
                    self.ct[k % self.cap] = 0
            self.newest = b
        elif b <= self.newest - self.cap:
            return  # older than this stage retains
        i = b % self.cap
        if self.ct[i] == 0:
            self.mn[i] = self.mx[i] = self.sm[i] = v
            self.ct[i] = 1
        else:
            if v < self.mn[i]:
                self.mn[i] = v
            if v > self.mx[i]:
                self.mx[i] = v
            self.sm[i] += v
            self.ct[i] += 1
        self.last[i] = v

    def buckets(self, from_t: float, to_t: float):
        """Non-empty ``(bucket_start_s, mn, mx, sm, ct, last)`` rows in
        ``[from_t, to_t]``, oldest first."""
        if self.newest is None:
            return
        lo = max(int(from_t // self.step), self.newest - self.cap + 1)
        hi = min(int(to_t // self.step), self.newest)
        for b in range(lo, hi + 1):
            i = b % self.cap
            if self.ct[i]:
                yield (
                    b * self.step, self.mn[i], self.mx[i], self.sm[i],
                    self.ct[i], self.last[i],
                )


class Series:
    """All retention stages for one series×host."""

    __slots__ = ("kind", "stages", "nbytes", "last_t")

    def __init__(self, kind: str, stages: Sequence[Tuple[float, int]]):
        self.kind = kind  # "counter" | "gauge"
        self.stages = [_Stage(step, cap) for step, cap in stages]
        self.nbytes = (
            sum(s.nbytes() for s in self.stages) + SERIES_OVERHEAD_BYTES
        )
        self.last_t = float("-inf")

    def record(self, t: float, v: float) -> None:
        if t > self.last_t:
            self.last_t = t
        for s in self.stages:
            s.record(t, v)


def _counter_increase(rows: List[tuple], from_t: float) -> Tuple[float, float]:
    """(increase, covered_span_s) of a cumulative counter over the
    window, from its bucket ``last`` samples (rows may start before
    ``from_t`` to provide the baseline).  Reset semantics: a drop means
    the post-reset value IS the increment."""
    inc = 0.0
    prev_v: Optional[float] = None
    prev_t: Optional[float] = None
    t_first_in = None
    t_last_in = None
    for t, _mn, _mx, _sm, _ct, last in rows:
        if prev_v is not None and t >= from_t:
            inc += last if last < prev_v else last - prev_v
            if t_first_in is None:
                t_first_in = prev_t
            t_last_in = t
        prev_v, prev_t = last, t
    span = (t_last_in - t_first_in) if t_last_in is not None else 0.0
    return inc, span


class TSDB:
    """The bounded store: ``record`` on every push, ``query`` for the
    HTTP plane, windowed folds for the SLO evaluator."""

    def __init__(
        self,
        budget_bytes: int = DEFAULT_BUDGET_BYTES,
        stages: Sequence[Tuple[float, int]] = DEFAULT_STAGES,
        registry=None,
    ):
        self.budget_bytes = int(budget_bytes)
        self.stage_spec = tuple(
            (float(step), int(cap))
            for step, cap in sorted(stages, key=lambda sc: sc[0])
        )
        self._lock = threading.Lock()
        # name -> host -> Series
        self._series: Dict[str, Dict[str, Series]] = {}
        self._bytes = 0
        self._nseries = 0
        self._samples = 0
        self._dropped = 0
        self._m_bytes = self._m_series = None
        self._m_samples = self._m_dropped = None
        self._exported_samples = 0
        self._exported_dropped = 0
        if registry is not None:
            r = registry
            self._m_bytes = r.get("sparknet_tsdb_resident_bytes") or r.gauge(
                "sparknet_tsdb_resident_bytes",
                "accounted bytes resident in the time-series store "
                "(rings + per-series overhead; bounded by the budget)",
            )
            self._m_series = r.get("sparknet_tsdb_series") or r.gauge(
                "sparknet_tsdb_series",
                "series x host ring sets currently allocated",
            )
            self._m_samples = (
                r.get("sparknet_tsdb_samples_total") or r.counter(
                    "sparknet_tsdb_samples_total",
                    "samples folded into the store (one per series per "
                    "recorded push)",
                )
            )
            self._m_dropped = (
                r.get("sparknet_tsdb_dropped_series_total") or r.counter(
                    "sparknet_tsdb_dropped_series_total",
                    "new-series admissions refused at the byte budget "
                    "(existing series keep recording)",
                )
            )

    # ------------------------------------------------------------------
    # write side
    def record(self, name: str, host: str, value: float, t: float,
               kind: str = "gauge") -> bool:
        """Fold one sample; returns False when a NEW series was refused
        at the byte budget (existing series always record)."""
        with self._lock:
            return self._record_locked(name, host, float(value), t, kind)

    def _record_locked(self, name, host, value, t, kind) -> bool:
        hosts = self._series.get(name)
        if hosts is None:
            hosts = self._series[name] = {}
        sr = hosts.get(host)
        if sr is None:
            sr = Series(kind, self.stage_spec)
            if self._bytes + sr.nbytes > self.budget_bytes:
                self._dropped += 1
                if not hosts:
                    del self._series[name]
                return False
            hosts[host] = sr
            self._bytes += sr.nbytes
            self._nseries += 1
        sr.record(t, value)
        self._samples += 1
        return True

    def record_snapshot(
        self,
        host: str,
        counters: Dict[str, float],
        gauges: Dict[str, float],
        t: float,
    ) -> None:
        """Fold one host's merged sample maps (the fleet ``ingest``
        path / the single-host sampler path) in one lock hold."""
        with self._lock:
            for name, v in counters.items():
                self._record_locked(name, host, float(v), t, "counter")
            for name, v in gauges.items():
                self._record_locked(name, host, float(v), t, "gauge")
        self.refresh_metrics()

    def refresh_metrics(self) -> None:
        """Push the store's own accounting into its registry gauges."""
        if self._m_bytes is None:
            return
        with self._lock:
            nbytes, nseries = self._bytes, self._nseries
            samples, dropped = self._samples, self._dropped
        self._m_bytes.set(nbytes)
        self._m_series.set(nseries)
        if samples > self._exported_samples:
            self._m_samples.inc(samples - self._exported_samples)
            self._exported_samples = samples
        if dropped > self._exported_dropped:
            self._m_dropped.inc(dropped - self._exported_dropped)
            self._exported_dropped = dropped

    # ------------------------------------------------------------------
    # introspection
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._bytes,
                "series": self._nseries,
                "samples_total": self._samples,
                "dropped_series_total": self._dropped,
                "stages": [
                    {"step_s": step, "buckets": cap,
                     "retention_s": step * cap}
                    for step, cap in self.stage_spec
                ],
            }

    def series_names(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(
                n for n in self._series if n.startswith(prefix)
            )

    def hosts(self) -> List[str]:
        with self._lock:
            out = set()
            for hosts in self._series.values():
                out.update(hosts)
            return sorted(out)

    def latest(self, name: str, host: Optional[str] = None) -> Optional[float]:
        """Newest ``last`` across the finest stage holding data (summed
        across hosts when ``host`` is None — counter semantics)."""
        with self._lock:
            hosts = self._series.get(name)
            if not hosts:
                return None
            total, seen = 0.0, False
            for h, sr in hosts.items():
                if host is not None and h != host:
                    continue
                for st in sr.stages:
                    if st.newest is not None:
                        total += st.last[st.newest % st.cap]
                        seen = True
                        break
            return total if seen else None

    # ------------------------------------------------------------------
    # read side
    def _pick_stage_spec(
        self, range_s: float, step_s: Optional[float],
        reach_s: Optional[float] = None,
    ) -> int:
        """Index of the finest stage at/above the requested step whose
        retention covers the range (else the coarsest candidate).
        ``reach_s`` is how far back from the series' NEWEST data the
        window's oldest edge sits: a ring only retains relative to
        what it last recorded, so a historic window (``now`` in the
        past — the signals' previous-window reads) must fall to a
        stage whose retention actually reaches it."""
        need = max(float(range_s), reach_s or 0.0)
        cands = [
            i for i, (step, _cap) in enumerate(self.stage_spec)
            if step_s is None or step >= float(step_s) - 1e-9
        ] or [len(self.stage_spec) - 1]
        for i in cands:
            step, cap = self.stage_spec[i]
            if step * cap >= need:
                return i
        return cands[-1]

    def query(
        self,
        name: str,
        host: Optional[str] = None,
        range_s: float = 300.0,
        step_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[Dict]:
        """The ``GET /query`` payload: sparse rollup points over
        ``[now - range_s, now]``.  ``host=None`` aggregates across
        hosts (min of mins, max of maxes, pooled sum/count, ``last``
        and ``rate`` summed — the fleet-total read).  Returns None for
        an unknown series."""
        with self._lock:
            hosts = self._series.get(name)
            if not hosts:
                return None
            picked = [
                (h, sr) for h, sr in sorted(hosts.items())
                if host is None or h == host
            ]
            if not picked:
                return None
            kind = picked[0][1].kind
            newest = max(sr.last_t for _h, sr in picked)
            if now is None:
                now = newest if newest > float("-inf") else 0.0
            from_t = now - float(range_s)
            si = self._pick_stage_spec(
                float(range_s), step_s,
                reach_s=newest - from_t if newest > from_t else None,
            )
            step = self.stage_spec[si][0]
            merged: Dict[float, List[float]] = {}
            for _h, sr in picked:
                st = sr.stages[si]
                rows = list(st.buckets(from_t - step, now))
                prev_last: Optional[float] = None
                prev_t: Optional[float] = None
                for t, mn, mx, sm, ct, last in rows:
                    rate = None
                    if kind == "counter" and prev_last is not None:
                        inc = (
                            last if last < prev_last else last - prev_last
                        )
                        dt = t - prev_t
                        rate = inc / dt if dt > 0 else None
                    prev_last, prev_t = last, t
                    if t < from_t:
                        continue
                    agg = merged.get(t)
                    if agg is None:
                        merged[t] = [mn, mx, sm, ct, last,
                                     rate if rate is not None else 0.0,
                                     1 if rate is not None else 0]
                    else:
                        agg[0] = min(agg[0], mn)
                        agg[1] = max(agg[1], mx)
                        agg[2] += sm
                        agg[3] += ct
                        agg[4] += last
                        if rate is not None:
                            agg[5] += rate
                            agg[6] += 1
        points = []
        for t in sorted(merged):
            mn, mx, sm, ct, last, rate, nrate = merged[t]
            points.append({
                "t": round(t, 3),
                "min": mn,
                "max": mx,
                "mean": sm / ct if ct else 0.0,
                "count": int(ct),
                "last": last,
                "rate": (rate if nrate else None),
            })
        return {
            "series": name,
            "host": host or "fleet",
            "kind": kind,
            "step_s": step,
            "from_s": round(now - float(range_s), 3),
            "to_s": round(now, 3),
            "points": points,
        }

    def window_delta(
        self,
        name: str,
        window_s: float,
        now: float,
        host: Optional[str] = None,
    ) -> Tuple[float, float]:
        """Counter increase over ``[now - window_s, now]`` (summed
        across hosts when ``host`` is None) with reset semantics, plus
        the covered span actually observed (0 when there are not two
        samples to difference)."""
        from_t = now - float(window_s)
        total, span = 0.0, 0.0
        with self._lock:
            hosts = self._series.get(name)
            if not hosts:
                return 0.0, 0.0
            picked = [
                sr for h, sr in hosts.items()
                if host is None or h == host
            ]
            if not picked:
                return 0.0, 0.0
            newest = max(sr.last_t for sr in picked)
            si = self._pick_stage_spec(
                float(window_s), None,
                reach_s=newest - from_t if newest > from_t else None,
            )
            step = self.stage_spec[si][0]
            for sr in picked:
                st = sr.stages[si]
                # one bucket of lookback supplies the baseline sample
                rows = list(st.buckets(from_t - step * st.cap, now))
                inc, sp = _counter_increase(rows, from_t)
                total += inc
                span = max(span, sp)
        return total, span

    def window_delta_prefix(
        self,
        prefix: str,
        window_s: float,
        now: float,
        host: Optional[str] = None,
    ) -> Tuple[float, float]:
        """Summed ``window_delta`` over every series whose full sample
        name starts with ``prefix`` — the label-family fold (all shed
        causes, all phases)."""
        total, span = 0.0, 0.0
        for name in self.series_names(prefix):
            inc, sp = self.window_delta(name, window_s, now, host=host)
            total += inc
            span = max(span, sp)
        return total, span

    def window_stats(
        self,
        name: str,
        window_s: float,
        now: float,
        host: Optional[str] = None,
    ) -> Optional[Dict[str, float]]:
        """min/max/mean/last of a gauge over the window (pooled across
        hosts when ``host`` is None; ``last`` sums — the fleet-level
        read for additive gauges like queue depth)."""
        res = self.query(
            name, host=host, range_s=window_s, step_s=None, now=now
        )
        if res is None or not res["points"]:
            return None
        pts = res["points"]
        tot_ct = sum(p["count"] for p in pts)
        return {
            "min": min(p["min"] for p in pts),
            "max": max(p["max"] for p in pts),
            "mean": (
                sum(p["mean"] * p["count"] for p in pts) / tot_ct
                if tot_ct else 0.0
            ),
            "last": pts[-1]["last"],
        }

    def slope_per_s(
        self,
        name: str,
        window_s: float,
        now: float,
        host: Optional[str] = None,
    ) -> float:
        """Least-squares slope (value units per second) of the bucket
        means over the window — the trend primitive behind the scaling
        signals.  0.0 with fewer than two points."""
        res = self.query(
            name, host=host, range_s=window_s, step_s=None, now=now
        )
        if res is None or len(res["points"]) < 2:
            return 0.0
        pts = res["points"]
        n = len(pts)
        t0 = pts[0]["t"]
        xs = [p["t"] - t0 for p in pts]
        ys = [p["mean"] for p in pts]
        mean_x = sum(xs) / n
        mean_y = sum(ys) / n
        den = sum((x - mean_x) ** 2 for x in xs)
        if den <= 0:
            return 0.0
        return sum(
            (x - mean_x) * (y - mean_y) for x, y in zip(xs, ys)
        ) / den

    def histogram_window(
        self,
        hist: str,
        window_s: float,
        now: float,
        host: Optional[str] = None,
    ) -> Optional[Dict]:
        """Windowed view of a (label-free) histogram's shipped bucket
        counters: ``{"le": [(le, increase), ...] cumulative ascending,
        "count": N, "sum": S}`` — the input to bucket-quantile and
        threshold-fraction folds.  None when no count moved."""
        count, _ = self.window_delta(f"{hist}_count", window_s, now, host)
        if count <= 0:
            return None
        total_sum, _ = self.window_delta(f"{hist}_sum", window_s, now, host)
        les: List[Tuple[float, float]] = []
        for name in self.series_names(f"{hist}_bucket{{"):
            m = _LE_RE.search(name)
            if not m:
                continue
            raw = m.group(1)
            le = float("inf") if raw == "+Inf" else float(raw)
            inc, _ = self.window_delta(name, window_s, now, host)
            les.append((le, inc))
        les.sort(key=lambda p: p[0])
        return {"le": les, "count": count, "sum": total_sum}


def bucket_quantile(les: List[Tuple[float, float]], q: float) -> float:
    """Quantile from cumulative ``(le, windowed_increase)`` rows, the
    Prometheus ``histogram_quantile`` fold: linear interpolation inside
    the winning bucket, the +Inf bucket reporting its lower bound."""
    if not les:
        return 0.0
    total = les[-1][1]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_le, prev_c = 0.0, 0.0
    for le, c in les:
        if c >= rank:
            if le == float("inf"):
                return prev_le
            width = le - prev_le
            in_bucket = c - prev_c
            if in_bucket <= 0 or width <= 0:
                return le
            return prev_le + width * (rank - prev_c) / in_bucket
        prev_le, prev_c = le, c
    return prev_le
