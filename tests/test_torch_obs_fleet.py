"""The port's fleet plane (``obs/ship.py``, ``obs/fleet.py``) against the
JAX package's, on the same inputs.

- The collector merge: one seeded sequence of shipper pushes (three
  hosts, a process restart, a sequence gap, a negative delta, skewed
  clocks, span and instant events, a final heartbeat) ingested at
  pinned receive times by a JAX and a port ``FleetCollector``: the
  merged ``/metrics`` text and the ``/fleet`` view are equal, leaving
  out the push ages (monotonic clock reads).
- Liveness: late and dead attribution and the finished state, the same
  in both.
- Clock alignment: the merged ``/trace`` and ``/runlog`` equal the JAX
  collector's, and each host's offset is recovered.
- The shipper: snapshot deltas with counter-reset detection, the bound
  (oldest dropped, counted), and an outage with buffered replay and 0
  lost events over real HTTP.
- Two processes (``utils/procs.fleet_ship_worker``) shipping to one
  collector.
"""

import copy
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np
import pytest

from sparknet_tpu.obs import fleet as jfleet
from sparknet_tpu_torch import obs
from sparknet_tpu_torch.obs import fleet as tfleet
from sparknet_tpu_torch.obs.metrics import MetricsRegistry
from sparknet_tpu_torch.obs.ship import Shipper
from sparknet_tpu_torch.utils import procs
from tests.test_torch_obs_tsdb_slo import same

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
# the /fleet fields read off the collector's monotonic clock
_AGES = ("age_s", "last_push_age_s", "dead_in_s")


def _wait(pred, timeout_s=20.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def pushes(seed=0):
    """``(payload, t_recv)`` of three hosts' shipper pushes."""
    rng = np.random.RandomState(seed)
    skew = {"h0": 0.0, "h1": 5.0, "h2": -3.0}
    boot = {h: f"boot-{h}-0" for h in skew}
    seq = {h: 0 for h in skew}
    totals = {h: 0 for h in skew}
    out = []
    for k in range(40):
        for h in sorted(skew):
            t_recv = T0 + 0.5 * k + 0.01 * len(out)
            if h == "h2" and k == 20:
                seq[h] += 2  # two pushes lost in flight
            if h == "h1" and k == 25:
                boot[h], seq[h] = "boot-h1-1", 0  # the process restarted
            events = []
            for e in range(int(rng.randint(0, 4))):
                t_host = t_recv + skew[h] - 0.05 * rng.rand()
                if rng.rand() < 0.7:
                    events.append({
                        "kind": "span", "name": ("execute", "average")[e % 2],
                        "cat": "phase", "t_s": t_host - 0.02,
                        "dur_ms": round(float(rng.rand() * 20), 4),
                        "thread": "MainThread", "args": {"round": k}})
                else:
                    events.append({"kind": "instant", "name": "fault_x",
                                   "cat": "fault", "t_s": t_host,
                                   "thread": "feed"})
            totals[h] += len(events)
            counters = {"sparknet_rounds_total": 1.0,
                        "sparknet_iters_total": float(rng.randint(1, 5)),
                        'sparknet_collective_bytes_total{compress="int8"}':
                            float(rng.randint(0, 1000))}
            if h == "h0" and k == 30:
                counters["sparknet_iters_total"] = -3.0  # an unflagged reset
            payload = {
                "v": 1, "host": h, "boot_id": boot[h], "seq": seq[h],
                "t_send": t_recv + skew[h] - 0.001 * rng.rand(),
                "round": k - (4 if h == "h2" else 0),
                "counters": counters,
                "gauges": {"sparknet_feed_queue_depth": float(rng.randint(9))},
                "events": events, "events_total": totals[h],
                "dropped_total": 0, "resets": [],
                "final": bool(h == "h0" and k == 39),
            }
            seq[h] += 1
            out.append((payload, t_recv))
    return out


def _collectors(**kw):
    return jfleet.FleetCollector(port=0, **kw), tfleet.FleetCollector(port=0, **kw)


def _ingest(cs, seq):
    for payload, t_recv in seq:
        for c in cs:
            c.ingest(copy.deepcopy(payload), t_recv)


def _view(c):
    v = c.fleet_view()
    for st in v["hosts"].values():
        for k in _AGES:
            st.pop(k)
    return v


def test_merged_metrics_and_fleet_view_equal_jax():
    cs = _collectors()
    _ingest(cs, pushes())
    jv, tv = _view(cs[0]), _view(cs[1])
    same(jv, tv)
    assert tv["hosts"]["h1"]["restarts"] == 1
    assert tv["hosts"]["h2"]["lost_pushes"] == 2
    assert tv["hosts"]["h0"]["state"] == "finished"
    assert tv["hosts"]["h0"]["restarts"] == 1  # the negative delta
    assert cs[0].render_metrics() == cs[1].render_metrics()
    text = cs[1].render_metrics()
    assert 'sparknet_rounds_total{host="fleet"} 120' in text
    assert 'sparknet_fleet_hosts{state="finished"} 1' in text


def test_liveness_late_and_dead_equal_jax():
    cs = _collectors(dead_after_s=5.0, late_round_lag=2)
    _ingest(cs, [(p, t) for p, t in pushes() if not p["final"]])
    jv, tv = _view(cs[0]), _view(cs[1])
    same(jv, tv)
    assert tv["hosts"]["h2"]["state"] == "late"  # 4 rounds behind
    assert tv["hosts"]["h0"]["state"] == tv["hosts"]["h1"]["state"] == "live"
    for c in cs:  # h1 goes quiet past the deadline
        c._hosts["h1"].last_seen_mono -= 60.0
    jv, tv = _view(cs[0]), _view(cs[1])
    same(jv, tv)
    assert tv["hosts"]["h1"]["state"] == "dead"
    assert tv["fleet"]["hosts_dead"] == 1 and tv["fleet"]["hosts_late"] == 1
    same(cs[0].render_metrics(), cs[1].render_metrics())


def test_merged_trace_and_runlog_clock_aligned_as_jax():
    cs = _collectors()
    seq = pushes(seed=1)
    _ingest(cs, seq)
    jt, tt = cs[0].merged_trace(), cs[1].merged_trace()
    for t in (jt, tt):
        t["otherData"].pop("epoch_unix_s")
        t["otherData"].pop("producer")
    same(jt, tt)
    assert cs[0].merged_runlog() == cs[1].merged_runlog()
    offsets = {h: st["clock_offset_s"]
               for h, st in cs[1].fleet_view()["hosts"].items()}
    # the one-way filter recovers each host's skew within the send jitter
    for h, skew in (("h0", 0.0), ("h1", 5.0), ("h2", -3.0)):
        assert abs(offsets[h] - skew) < 2e-3, (h, offsets[h])
    # corrected, the hosts' spans interleave on one timeline
    spans = [e for e in tt["traceEvents"] if e["ph"] == "X"]
    assert spans == sorted(spans, key=lambda e: e["ts"])
    assert len({e["pid"] for e in spans}) == 3
    assert min(e["ts"] for e in tt["traceEvents"] if "ts" in e) < 1e6


def test_http_endpoints_serve_the_merge():
    c = tfleet.FleetCollector(port=0).start()
    try:
        for payload, t_recv in pushes()[:30]:
            req = urllib.request.Request(
                c.url + "/push", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                assert json.loads(r.read())["ok"]

        def get(path):
            with urllib.request.urlopen(c.url + path, timeout=10) as r:
                return r.status, r.read().decode()

        assert set(json.loads(get("/fleet")[1])["hosts"]) == {"h0", "h1", "h2"}
        assert "sparknet_fleet_pushes_total" in get("/metrics")[1]
        assert get("/runlog")[1].count("\n") >= 1
        assert json.loads(get("/trace")[1])["otherData"]["clock_aligned"]
        q = json.loads(get("/query?series=sparknet_rounds_total&range=600")[1])
        assert q["kind"] == "counter" and q["points"]
        assert json.loads(get("/slo")[1])["slos"]
        assert "round_rate_per_s" in json.loads(get("/signals")[1])
        assert json.loads(get("/healthz")[1])["status"] == "ok"
        c.pause()
        with pytest.raises(OSError):
            urllib.request.urlopen(c.url + "/fleet", timeout=2)
        c.resume()
        assert get("/fleet")[0] == 200
    finally:
        c.close()


def test_shipper_deltas_and_counter_resets():
    """Pushes carry the increase since the last successful push; a
    registry whose counters dropped (a restart) ships its new value as
    the increment, and the merged total keeps growing."""
    c = tfleet.FleetCollector(port=0).start()
    try:
        reg = MetricsRegistry()
        rounds = reg.counter("sparknet_rounds_total")
        s = Shipper(c.url, host="d", interval_s=3600, registry=reg).start()
        rounds.inc(5)
        assert s._flush()
        rounds.inc(2)
        assert s._flush()
        st = c.fleet_view()["hosts"]["d"]
        assert st["counters"]["sparknet_rounds_total"] == 7.0
        fresh = MetricsRegistry()
        fresh.counter("sparknet_rounds_total").inc(3)
        s._registry = fresh
        assert s._flush()
        assert s.resets_seen == ["sparknet_rounds_total"]
        st = c.fleet_view()["hosts"]["d"]
        assert st["counters"]["sparknet_rounds_total"] == 10.0
        s.stop()
        assert c.fleet_view()["hosts"]["d"]["state"] == "finished"
    finally:
        c.close()


def test_shipper_bound_drops_the_oldest_and_counts():
    s = Shipper("http://127.0.0.1:9", host="b", interval_s=3600, capacity=10)
    for i in range(25):
        s.record_event({"kind": "instant", "name": f"e{i}", "t_s": 0.0,
                        "thread": "t", "args": {"round": i}})
    assert s.events_total == 25 and s.dropped_total == 15
    assert s.buffered() == 10 and s._buf[-1]["name"] == "e24"
    assert s._max_round == 24


def test_outage_buffered_replay_loses_no_event():
    """The collector goes down mid-run: pushes fail, the buffer holds,
    the replay after it returns delivers every event (0 lost, 0
    dropped); the span hook feeds the shipper from training code."""
    c = tfleet.FleetCollector(port=0).start()
    reg = MetricsRegistry()
    s = Shipper(c.url, host="oh", interval_s=0.03, registry=reg).start()
    obs.set_ship(s)
    try:
        def received():
            return c.fleet_view()["hosts"].get("oh", {}).get(
                "received_events", 0)

        for r in range(20):
            with obs.span("execute", round=r):
                pass
        assert _wait(lambda: received() >= 20)
        c.pause()
        for r in range(20, 50):
            obs.instant("tick", round=r)
        assert _wait(lambda: s.push_failures_total > 0)
        c.resume()
        assert _wait(lambda: received() >= 50)
        obs.set_ship(None)
        s.stop()
        st = c.fleet_view()["hosts"]["oh"]
        assert st["received_events"] == 50 and st["lost_events"] == 0
        assert st["reported_dropped_total"] == 0 and s.dropped_total == 0
        assert st["round"] == 49 and st["state"] == "finished"
    finally:
        obs.set_ship(None)
        if s.alive:
            s.stop()
        c.close()


def test_two_processes_ship_to_one_collector():
    """Two real worker processes (the toy solver, 4 rounds each, one
    host's clock skewed by 2 s) ship to one collector."""
    c = tfleet.FleetCollector(port=0).start()
    try:
        env = procs.repo_env(_REPO, {"SPARKNET_SHIP_TO": c.url,
                                     "SPARKNET_SHIP_INTERVAL_S": "0.1",
                                     "SPARKNET_FLEET_ROUNDS": "4"})
        with tempfile.TemporaryDirectory(prefix="fleet_ship_") as d:
            script = os.path.join(d, "worker.py")
            with open(script, "w") as f:
                f.write(procs.fleet_ship_worker("FLEET_OK"))
            cmds = [[sys.executable, script, str(pid)] for pid in range(2)]
            envs = [dict(env, SPARKNET_HOST_ID=f"host{pid}",
                         SPARKNET_SHIP_CLOCK_SKEW_S=("2.0" if pid else "0"))
                    for pid in range(2)]
            results, _, timed_out = procs.reap_processes(cmds, envs, 240)
        assert not timed_out
        for pid in range(2):
            rc, out = results[pid]
            assert rc == 0 and f"FLEET_OK p{pid}" in out, out
        view = c.fleet_view()
        assert sorted(view["hosts"]) == ["host0", "host1"]
        for h, st in view["hosts"].items():
            assert st["state"] == "finished" and st["round"] == 3, (h, st)
            assert st["lost_events"] == 0, (h, st)
            assert st["received_events"] >= 4, (h, st)
            assert st["counters"]["sparknet_iters_total"] == 4.0, (h, st)
        assert view["fleet"]["counters"]["sparknet_rounds_total"] == 8.0
        assert abs(view["hosts"]["host1"]["clock_offset_s"] - 2.0) < 0.5
        spans = [e for e in c.merged_trace()["traceEvents"]
                 if e.get("name") == "execute"]
        assert sorted({e["args"]["host"] for e in spans}) == ["host0", "host1"]
        # the worker's round span (the solver's own execute nests in it)
        assert len([e for e in spans if "round" in e["args"]]) == 8
    finally:
        c.close()
