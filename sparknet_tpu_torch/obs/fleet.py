"""Fleet collector: the cross-host control plane of the telemetry.

The port's own copy of ``sparknet_tpu/obs/fleet.py``, the pull side of
the fleet plane (``obs/ship.py`` is the push side): a stdlib HTTP
service that merges every host's metric deltas and run-log events into
one fleet view.

- **Monotonic counter merge across restarts**: hosts push counter
  deltas; the collector accumulates per-host and fleet totals that only
  grow, detects a host restart by its ``boot_id``
  (``sparknet_fleet_resets_total``) and clamps a negative delta as a
  reset.  The merge is at-least-once; sequence gaps count as
  ``lost_pushes``.
- **Clock alignment**: each push carries the host's send wall time; the
  collector keeps the largest ``t_send - t_recv`` per host (network
  delay is nonnegative, so the largest sample converges on the
  host-minus-collector offset).  The merged trace and run log subtract
  each host's offset.
- **Liveness**: a host whose round heartbeat lags the fleet median by
  more than ``late_round_lag`` is ``late``; one that has not pushed
  within ``dead_after_s`` is ``dead``; one whose last push was marked
  final exited cleanly (``finished``).  The verdicts export as
  ``sparknet_fleet_hosts{state=...}``, each host's round and the
  cross-host round skew.

The collector embeds the retention plane (``obs/tsdb.py``): every
merged series is recorded per host on each push, and the burn-rate SLO
evaluator (``obs/slo.py``) runs over it at its interval.

Endpoints: ``POST /push``, ``GET /fleet``, ``GET /metrics`` (the fleet
families and every merged per-host series with a ``host`` label),
``GET /runlog`` (the merged clock-aligned JSONL run log), ``GET
/trace`` (the merged Chrome trace, one Perfetto process lane per host),
``GET /query?series=&host=&range=&step=``, ``GET /slo``, ``GET
/signals`` and ``GET /healthz``.  ``pause()``/``resume()`` take the
listener down and rebind the same port: the chaos ``collector_outage``
fault's seam.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from sparknet_tpu_torch.obs.exporter import JsonHTTPHandler
from sparknet_tpu_torch.obs.metrics import MetricsRegistry, _escape_label, _fmt
from sparknet_tpu_torch.obs.slo import SLOEvaluator
from sparknet_tpu_torch.obs.tsdb import TSDB

DEFAULT_FLEET_PORT = 8381


def parse_hostport(value: str) -> tuple:
    """``"HOST:PORT"`` / ``"HOST"`` / ``"PORT"`` -> (host, port), with
    the fleet defaults filling the missing half — the one parser behind
    every ``--fleet_collector`` flag (obs.start, tools/launch.py)."""
    s = str(value).strip()
    host, sep, port = s.rpartition(":")
    if not sep:
        # bare value: a number is a port, anything else a host
        if s.isdigit():
            return "127.0.0.1", int(s)
        return s or "127.0.0.1", DEFAULT_FLEET_PORT
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise ValueError(
            f"--fleet_collector expects HOST:PORT (got {value!r})"
        ) from None
# liveness defaults: a host is dead after this many seconds without a
# push (several flush intervals), late when this many rounds behind the
# fleet median
DEFAULT_DEAD_AFTER_S = 10.0
DEFAULT_LATE_ROUND_LAG = 2


class HostState:
    """Everything the collector knows about one host."""

    def __init__(self, host: str, events_capacity: int):
        self.host = host
        self.boot_id: Optional[str] = None
        self.last_seq: Optional[int] = None
        self.round: Optional[int] = None
        self.first_seen = time.time()
        self.last_seen_mono = time.monotonic()
        self.last_t_send: Optional[float] = None
        # one-way-filter clock offset estimate (host clock - collector
        # clock, in seconds); None until the first push
        self.clock_offset_s: Optional[float] = None
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.events: deque = deque(maxlen=events_capacity)
        self.received_events = 0
        self.reported_events_total = 0
        self.reported_dropped_total = 0
        self.pushes = 0
        self.restarts = 0
        self.lost_pushes = 0
        # terminal heartbeat seen (shipper stop() marks its last push
        # final): a cleanly-finished host, exempt from dead-marking
        self.finished = False

    def lost_events(self) -> int:
        """Events the shipper enqueued that neither arrived here nor
        were counted as dropped — the number the outage proof pins
        at zero."""
        return max(
            0,
            self.reported_events_total
            - self.reported_dropped_total
            - self.received_events,
        )


class FleetCollector:
    """Merges shipper pushes into the fleet view and serves it."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = DEFAULT_FLEET_PORT,
        dead_after_s: float = DEFAULT_DEAD_AFTER_S,
        late_round_lag: int = DEFAULT_LATE_ROUND_LAG,
        events_per_host: int = 65536,
        tsdb_budget_bytes: Optional[int] = None,
        slo_eval_interval_s: float = 15.0,
        slos=None,
    ):
        self._bind_host = host
        self.dead_after_s = float(dead_after_s)
        self.late_round_lag = int(late_round_lag)
        self.events_per_host = int(events_per_host)
        self._lock = threading.Lock()
        self._hosts: Dict[str, HostState] = {}
        self._t0 = time.time()
        self.registry = MetricsRegistry()
        r = self.registry
        self.m_hosts = r.gauge(
            "sparknet_fleet_hosts",
            "hosts per liveness state (live = heartbeating and keeping "
            "up, late = round heartbeat lags the fleet median past the "
            "threshold, dead = missed the push deadline, finished = "
            "terminal heartbeat seen: a clean exit, never dead)",
            labels=("state",),
        )
        self.m_round = r.gauge(
            "sparknet_fleet_round",
            "newest absolute round each host reported (its round "
            "heartbeat)",
            labels=("host",),
        )
        self.m_round_skew = r.gauge(
            "sparknet_fleet_round_skew",
            "max - min round over non-dead hosts (0 = lockstep fleet)",
        )
        self.m_clock_offset = r.gauge(
            "sparknet_fleet_clock_offset_seconds",
            "one-way-filter estimate of each host's clock offset vs "
            "collector (applied when merging traces/run logs)",
            labels=("host",),
        )
        self.m_events = r.counter(
            "sparknet_fleet_events_total",
            "run-log events received per host",
            labels=("host",),
        )
        self.m_dropped = r.counter(
            "sparknet_fleet_dropped_events_total",
            "events each host's shipper dropped at its buffer bound "
            "(as reported on its pushes)",
            labels=("host",),
        )
        self.m_lost = r.counter(
            "sparknet_fleet_lost_events_total",
            "events enqueued on a host that neither arrived nor were "
            "counted dropped (push sequence gaps)",
            labels=("host",),
        )
        self.m_pushes = r.counter(
            "sparknet_fleet_pushes_total",
            "shipper pushes ingested per host",
            labels=("host",),
        )
        self.m_resets = r.counter(
            "sparknet_fleet_resets_total",
            "host process restarts detected (boot id changed on a "
            "delta push) — the merged totals keep growing across them",
            labels=("host",),
        )
        # the retention plane: every merged series lands in bounded
        # ring-buffer history on each push, and the burn-rate SLO
        # evaluator runs over it (rate-limited to its eval interval)
        from sparknet_tpu_torch.obs.tsdb import DEFAULT_BUDGET_BYTES

        self.tsdb = TSDB(
            budget_bytes=(
                DEFAULT_BUDGET_BYTES if tsdb_budget_bytes is None
                else tsdb_budget_bytes
            ),
            registry=self.registry,
        )
        self.slo = SLOEvaluator(
            self.tsdb, slos=slos, registry=self.registry,
            eval_interval_s=slo_eval_interval_s,
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._port = int(port)

    # ------------------------------------------------------------------
    # lifecycle
    def start(self) -> "FleetCollector":
        self._serve()
        return self

    def _serve(self) -> None:
        collector = self

        class BoundHandler(_FleetHandler):
            fleet = collector

        self._httpd = ThreadingHTTPServer(
            (self._bind_host, self._port), BoundHandler
        )
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]  # resolve port 0 once
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="fleet-collector",
            daemon=True,
        )
        self._thread.start()

    @property
    def address(self):
        return (self._bind_host, self._port)

    @property
    def url(self) -> str:
        return f"http://{self._bind_host}:{self._port}"

    def pause(self) -> None:
        """Take the listener down (the collector_outage chaos seam);
        state is kept, ``resume()`` rebinds the same port."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def resume(self) -> None:
        if self._httpd is None:
            self._serve()

    def close(self) -> None:
        self.pause()

    # ------------------------------------------------------------------
    # merge
    def ingest(self, payload: Dict, t_recv: Optional[float] = None) -> Dict:
        """Fold one shipper push into the fleet state (the HTTP handler
        calls this; tests can call it directly).  Returns a small ack
        dict."""
        t_recv = time.time() if t_recv is None else t_recv
        host = str(payload.get("host", "?"))
        with self._lock:
            st = self._hosts.get(host)
            if st is None:
                st = self._hosts[host] = HostState(
                    host, self.events_per_host
                )
            boot = payload.get("boot_id")
            if st.boot_id is not None and boot != st.boot_id:
                # host process restarted: new shipper epoch.  Totals
                # keep accumulating; per-epoch seq restarts.
                st.restarts += 1
                st.last_seq = None
                self.m_resets.labels(host).inc()
            st.boot_id = boot
            if payload.get("final"):
                st.finished = True
            elif st.finished:
                # the same host pushing again after its terminal
                # heartbeat (a restart under the same id with the same
                # boot_id is impossible; same id + new boot_id resets
                # above) — treat it as live again
                st.finished = False
            seq = payload.get("seq")
            if isinstance(seq, int) and st.last_seq is not None:
                if seq > st.last_seq + 1:
                    gap = seq - st.last_seq - 1
                    st.lost_pushes += gap
            if isinstance(seq, int):
                st.last_seq = (
                    seq if st.last_seq is None else max(st.last_seq, seq)
                )
            st.pushes += 1
            self.m_pushes.labels(host).inc()
            st.last_seen_mono = time.monotonic()
            t_send = payload.get("t_send")
            if isinstance(t_send, (int, float)):
                st.last_t_send = float(t_send)
                # offset = host clock - collector clock.  One sample is
                # t_send - t_recv = offset - network_delay <= offset;
                # delay is nonnegative, so the MAX over pushes converges
                # on the true offset (minus the smallest delay seen)
                off = float(t_send) - t_recv
                if st.clock_offset_s is None or off > st.clock_offset_s:
                    st.clock_offset_s = off
                self.m_clock_offset.labels(host).set(st.clock_offset_s)
            r = payload.get("round")
            if isinstance(r, int) and (st.round is None or r > st.round):
                st.round = r
                self.m_round.labels(host).set(r)
            for name, delta in (payload.get("counters") or {}).items():
                if not isinstance(delta, (int, float)):
                    continue
                if delta < 0:
                    # a negative delta is a shipper-side bug or an
                    # unflagged reset: the post-reset value cannot be
                    # recovered from the delta alone, so count nothing
                    # rather than un-counting (or inflating) history
                    delta = 0.0
                    st.restarts += 1
                    self.m_resets.labels(host).inc()
                st.counters[name] = st.counters.get(name, 0.0) + delta
            for name, value in (payload.get("gauges") or {}).items():
                if isinstance(value, (int, float)):
                    st.gauges[name] = float(value)
            events = payload.get("events") or []
            for ev in events:
                if isinstance(ev, dict):
                    st.events.append(ev)
                    st.received_events += 1
            if events:
                self.m_events.labels(host).inc(len(events))
            et = payload.get("events_total")
            if isinstance(et, int):
                st.reported_events_total = max(
                    st.reported_events_total, et
                )
            dt = payload.get("dropped_total")
            if isinstance(dt, int) and dt > st.reported_dropped_total:
                self.m_dropped.labels(host).inc(
                    dt - st.reported_dropped_total
                )
                st.reported_dropped_total = dt
            lost = st.lost_events()
            prev_lost = self.m_lost.labels(host).value
            if lost > prev_lost:
                self.m_lost.labels(host).inc(lost - prev_lost)
            # copies for the retention plane: the TSDB records OUTSIDE
            # the collector lock (its own lock is a leaf — no
            # collector->tsdb hold-chain for /query readers to contend)
            counters_now = dict(st.counters)
            gauges_now = dict(st.gauges)
        self.tsdb.record_snapshot(host, counters_now, gauges_now, t_recv)
        self.slo.maybe_evaluate(t_recv)
        return {"ok": True, "host": host, "t_collector": t_recv}

    # ------------------------------------------------------------------
    # views
    def _classify(self, now_mono: Optional[float] = None) -> Dict[str, str]:
        """host -> live|late|dead (called under self._lock)."""
        now_mono = time.monotonic() if now_mono is None else now_mono
        states: Dict[str, str] = {}
        live_rounds: List[int] = []
        for h, st in self._hosts.items():
            if st.finished:
                # terminal heartbeat seen: a clean exit, never "dead"
                states[h] = "finished"
            elif now_mono - st.last_seen_mono > self.dead_after_s:
                states[h] = "dead"
            else:
                states[h] = "live"
                if st.round is not None:
                    live_rounds.append(st.round)
        if live_rounds:
            median = sorted(live_rounds)[len(live_rounds) // 2]
            for h, st in self._hosts.items():
                if (
                    states[h] == "live"
                    and st.round is not None
                    and median - st.round > self.late_round_lag
                ):
                    states[h] = "late"
        return states

    def fleet_view(self) -> Dict:
        """The /fleet JSON: per-host detail + fleet aggregates; also
        refreshes the state/skew gauges (one source of truth for the
        classification)."""
        with self._lock:
            states = self._classify()
            hosts = {}
            rounds = []
            fleet_counters: Dict[str, float] = {}
            for h, st in sorted(self._hosts.items()):
                # skew/median cover hosts still PARTICIPATING: a dead
                # host's stale round is a detection anchor, a finished
                # host's is history — neither may drag the aggregates
                # (a host finishing at round N would otherwise grow
                # round_skew forever as the rest train on)
                if states[h] not in ("dead", "finished") and (
                    st.round is not None
                ):
                    rounds.append(st.round)
                for name, v in st.counters.items():
                    fleet_counters[name] = fleet_counters.get(name, 0.0) + v
                age_s = round(time.monotonic() - st.last_seen_mono, 3)
                hosts[h] = {
                    "state": states[h],
                    "round": st.round,
                    "age_s": age_s,
                    # explicit alias of the push-age clock vs the
                    # dead_after_s deadline: a live host at
                    # last_push_age_s ~ dead_after_s is seconds from
                    # being condemned — visible BEFORE the verdict
                    "last_push_age_s": age_s,
                    "dead_in_s": (
                        None if states[h] in ("dead", "finished")
                        else round(max(0.0, self.dead_after_s - age_s), 3)
                    ),
                    "clock_offset_s": (
                        round(st.clock_offset_s, 6)
                        if st.clock_offset_s is not None else None
                    ),
                    "boot_id": st.boot_id,
                    "pushes": st.pushes,
                    "restarts": st.restarts,
                    "received_events": st.received_events,
                    "reported_events_total": st.reported_events_total,
                    "reported_dropped_total": st.reported_dropped_total,
                    "lost_events": st.lost_events(),
                    "lost_pushes": st.lost_pushes,
                    "counters": dict(st.counters),
                    "gauges": dict(st.gauges),
                }
            skew = (max(rounds) - min(rounds)) if rounds else 0
            by_state = {"live": 0, "late": 0, "dead": 0, "finished": 0}
            for s in states.values():
                by_state[s] += 1
        for s, n in by_state.items():
            self.m_hosts.labels(s).set(n)
        self.m_round_skew.set(skew)
        return {
            "hosts": hosts,
            "fleet": {
                "hosts_total": len(hosts),
                "hosts_live": by_state["live"],
                "hosts_late": by_state["late"],
                "hosts_dead": by_state["dead"],
                "hosts_finished": by_state["finished"],
                "round_median": (
                    sorted(rounds)[len(rounds) // 2] if rounds else None
                ),
                "round_skew": skew,
                "counters": {
                    k: fleet_counters[k] for k in sorted(fleet_counters)
                },
            },
        }

    def render_metrics(self) -> str:
        """Prometheus text: the fleet families plus every merged
        per-host series re-exported with a ``host`` label (and a
        ``host="fleet"`` sum for counters)."""
        self.fleet_view()  # refresh state/skew gauges
        lines = [self.registry.render().rstrip("\n")]
        with self._lock:
            merged_c: Dict[str, Dict[str, float]] = {}
            merged_g: Dict[str, Dict[str, float]] = {}
            for h, st in sorted(self._hosts.items()):
                for name, v in st.counters.items():
                    merged_c.setdefault(name, {})[h] = v
                for name, v in st.gauges.items():
                    merged_g.setdefault(name, {})[h] = v
        for merged, typ in ((merged_c, "counter"), (merged_g, "gauge")):
            for name in sorted(merged):
                base, labels = _split_sample_name(name)
                lines.append(f"# TYPE {base} {typ}")
                for h, v in sorted(merged[name].items()):
                    hostlbl = 'host="%s"' % _escape_label(h)
                    full = (
                        f"{base}{{{hostlbl},{labels}}}" if labels
                        else f"{base}{{{hostlbl}}}"
                    )
                    lines.append("%s %s" % (full, _fmt(v)))
                if typ == "counter":
                    total = sum(merged[name].values())
                    full = (
                        f'{base}{{host="fleet",{labels}}}' if labels
                        else f'{base}{{host="fleet"}}'
                    )
                    lines.append("%s %s" % (full, _fmt(total)))
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    # clock-aligned merged exports
    def _aligned_events(self):
        """(host, corrected_wall_s, rec) for every buffered event, the
        per-host offset estimate subtracted, sorted by corrected
        time."""
        with self._lock:
            rows = []
            for h, st in self._hosts.items():
                off = st.clock_offset_s or 0.0
                for rec in st.events:
                    t = rec.get("t_s")
                    if not isinstance(t, (int, float)):
                        continue
                    rows.append((h, float(t) - off, rec))
        rows.sort(key=lambda r: r[1])
        return rows

    def merged_runlog(self) -> str:
        """The merged JSONL run log: every host's records on one
        corrected clock, each line tagged ``host=``."""
        rows = self._aligned_events()
        base = rows[0][1] if rows else 0.0
        out = []
        for h, t, rec in rows:
            line = dict(rec)
            line["host"] = h
            line["ts_s"] = round(t - base, 6)
            out.append(json.dumps(line, default=str))
        return "\n".join(out) + ("\n" if out else "")

    def merged_trace(self) -> Dict:
        """Merged Chrome trace: one Perfetto process lane per host
        (pid = host index, process_name metadata), thread lanes from
        the shipped thread names, timestamps clock-aligned."""
        rows = self._aligned_events()
        base = rows[0][1] if rows else 0.0
        events: List[dict] = []
        pids: Dict[str, int] = {}
        tids: Dict[tuple, int] = {}
        for h, t, rec in rows:
            pid = pids.get(h)
            if pid is None:
                pid = pids[h] = len(pids) + 1
                events.append({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": h},
                })
            thread = str(rec.get("thread", "?"))
            tid = tids.get((h, thread))
            if tid is None:
                tid = tids[(h, thread)] = len(tids) + 1
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": thread},
                })
            ts_us = (t - base) * 1e6
            args = dict(rec.get("args") or {})
            args["host"] = h
            if rec.get("kind") == "span":
                # t_s IS the span's start (the ship hook stamps
                # end_wall - dur) — emit it as-is, like merged_runlog
                dur_us = float(rec.get("dur_ms", 0.0)) * 1e3
                events.append({
                    "name": rec.get("name", "?"),
                    "cat": rec.get("cat", "phase"), "ph": "X",
                    "ts": ts_us, "dur": dur_us,
                    "pid": pid, "tid": tid, "args": args,
                })
            else:
                events.append({
                    "name": rec.get("name", "?"),
                    "cat": rec.get("cat", "event"), "ph": "i", "s": "t",
                    "ts": ts_us, "pid": pid, "tid": tid, "args": args,
                })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "sparknet_tpu_torch.obs.fleet",
                "hosts": sorted(pids),
                "clock_aligned": True,
                "epoch_unix_s": self._t0,
            },
        }


def _split_sample_name(name: str):
    """``'m{a="b"}'`` -> ``('m', 'a="b"')``; bare names -> ``(name,
    '')`` (sample names from ``MetricsRegistry.snapshot`` carry their
    label set inline)."""
    if "{" in name and name.endswith("}"):
        base, rest = name.split("{", 1)
        return base, rest[:-1]
    return name, ""


class _FleetHandler(JsonHTTPHandler):
    fleet: "FleetCollector"  # bound per-server in FleetCollector._serve

    def do_POST(self):
        if self.path != "/push":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        t_recv = time.time()
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, OSError) as e:
            self._send_json(400, {"error": f"bad push body: {e}"})
            return
        self._send_json(200, self.fleet.ingest(payload, t_recv))

    def do_GET(self):
        if self.path.startswith("/query"):
            self._handle_query()
            return
        if self.path == "/fleet":
            self._send_json(200, self.fleet.fleet_view())
        elif self.path == "/metrics":
            self._send(
                200,
                self.fleet.render_metrics().encode("utf-8"),
                "text/plain; version=0.0.4",
            )
        elif self.path == "/runlog":
            self._send(
                200,
                self.fleet.merged_runlog().encode("utf-8"),
                "application/jsonl",
            )
        elif self.path == "/trace":
            self._send_json(200, self.fleet.merged_trace())
        elif self.path == "/slo":
            self._send_json(200, self.fleet.slo.evaluate())
        elif self.path == "/signals":
            self.fleet.slo.maybe_evaluate()
            self._send_json(200, self.fleet.slo.signals())
        elif self.path == "/healthz":
            self._send_json(
                200, {"status": "ok", "slo": self.fleet.slo.state()}
            )
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _handle_query(self):
        """``GET /query?series=&host=&range=&step=`` over the embedded
        TSDB (``range``/``step`` in seconds; ``host`` omitted = the
        cross-host aggregate)."""
        q = parse_qs(urlparse(self.path).query)

        def _one(key, default=None):
            vals = q.get(key)
            return vals[0] if vals else default

        series = _one("series")
        if not series:
            self._send_json(400, {
                "error": "series= is required",
                "series_available": len(self.fleet.tsdb.series_names()),
            })
            return
        try:
            range_s = float(_one("range", "300"))
            step = _one("step")
            step_s = float(step) if step is not None else None
        except ValueError as e:
            self._send_json(400, {"error": f"bad range/step: {e}"})
            return
        res = self.fleet.tsdb.query(
            series, host=_one("host"), range_s=range_s, step_s=step_s
        )
        if res is None:
            self._send_json(404, {
                "error": f"unknown series {series!r}",
                "series_available": len(self.fleet.tsdb.series_names()),
                "hint": "names are full inline-labeled sample names "
                "as /metrics exports them",
            })
            return
        res["tsdb"] = self.fleet.tsdb.stats()
        self._send_json(200, res)
