"""The port's retention and SLO plane (``obs/tsdb.py``, ``obs/slo.py``)
against the JAX package's, on the same inputs.

One seeded serving-and-training history (numpy ``RandomState``) is fed,
at pinned timestamps, into a JAX ``TSDB`` + ``SLOEvaluator`` and the
port's:

- two hosts, cumulative counters (streams, sheds of two causes, rounds,
  straggler rounds, the TTFT histogram's buckets, sum and count), a
  queue-depth gauge, and a process restart on one host (its counters
  drop);
- a clean stretch, a shed burst that warns, a sustained burn that
  pages, a long clean stretch that recovers.

Held equal to 1e-12 relative: every ``query`` (each series, host and
fleet, several ranges and steps, the 1 s / 10 s / 60 s rollups, now and
in the past), ``window_delta`` / ``window_delta_prefix`` /
``window_stats`` / ``slope_per_s`` / ``histogram_window`` /
``bucket_quantile``, the ``/slo`` payloads (burn rates, budgets,
statuses) and alert transitions at each checkpoint, ``state()``,
``signals()``, and the ``sparknet_tsdb_*`` / ``sparknet_slo_*`` /
``sparknet_signal_*`` metric text.  Also: the byte budget's refusals,
the single-host sampler over a registry, the sliding-window histogram
quantile, and ``MetricsRegistry.snapshot`` with ``counter_deltas``.
"""

import math
import numbers

import numpy as np
import pytest

from sparknet_tpu.obs import metrics as jmetrics
from sparknet_tpu.obs import slo as jslo
from sparknet_tpu.obs import tsdb as jtsdb
from sparknet_tpu_torch.obs import metrics as tmetrics
from sparknet_tpu_torch.obs import slo as tslo
from sparknet_tpu_torch.obs import tsdb as ttsdb

# divisible by every stage step, so window edges align with buckets
T0 = 1_700_000_000.0
RTOL = 1e-12
LES = tuple(jmetrics.LATENCY_BUCKETS_S)


def same(a, b, path="$"):
    """``a`` and ``b`` equal, floats to ``RTOL`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, numbers.Real) and not isinstance(a, bool):
        assert isinstance(b, numbers.Real), (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert a == b or math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), \
                (path, a, b)
    else:
        assert a == b, (path, a, b)


def _le(v):
    return "+Inf" if v == math.inf else jmetrics._fmt(v)


def history(seed=0):
    """``(t, host, counters, gauges)`` snapshots of the scenario: 10 s
    cadence, two hosts; ``(name, t)`` checkpoint markers in between."""
    rng = np.random.RandomState(seed)
    state = {h: {"streams": 0.0, "qf": 0.0, "kv": 0.0, "rounds": 0.0,
                 "strag": 0.0, "sum": 0.0, "count": 0.0,
                 "b": np.zeros(len(LES) + 1), "depth": 0.0}
             for h in ("h0", "h1")}
    t = T0
    # (seconds, streams/s, shed/s, slow ttft) per stretch
    plan = [("clean", 7200, 10.0, 0.0, False), ("burst", 60, 10.0, 5.0, True),
            ("sustained", 600, 10.0, 5.0, True),
            ("recovered", 21600, 10.0, 0.0, False)]
    for name, dur, rate, shed, slow in plan:
        end = t + dur
        while t < end - 1e-9:
            t += 10.0
            for h, s in state.items():
                if h == "h1" and name == "sustained" and abs(t - (end - 300)) < 5:
                    # a process restart on h1: its counters start over
                    for k in ("streams", "qf", "kv", "rounds", "strag", "sum",
                              "count"):
                        s[k] = 0.0
                    s["b"][:] = 0
                n = float(rng.poisson(rate * 10))
                s["streams"] += n
                s["qf"] += float(rng.poisson(shed * 7))
                s["kv"] += float(rng.poisson(shed * 3))
                s["rounds"] += float(rng.randint(0, 4))
                s["strag"] += float(rng.rand() < 0.05)
                lat = rng.lognormal(np.log(0.9 if slow else 0.08), 0.5, int(n))
                s["b"] += np.histogram(lat, bins=(0.0,) + LES + (np.inf,))[0]
                s["sum"] += float(lat.sum())
                s["count"] += float(len(lat))
                s["depth"] = max(0.0, s["depth"] + rng.randn())
                cum = np.cumsum(s["b"])
                counters = {
                    "sparknet_gen_streams_total": s["streams"],
                    'sparknet_gen_streams_shed_total{cause="queue_full"}': s["qf"],
                    'sparknet_gen_streams_shed_total{cause="kv_reserve"}': s["kv"],
                    "sparknet_rounds_total": s["rounds"],
                    "sparknet_straggler_rounds_total": s["strag"],
                    "sparknet_gen_ttft_seconds_sum": s["sum"],
                    "sparknet_gen_ttft_seconds_count": s["count"],
                }
                for le, c in zip(LES + (math.inf,), cum):
                    counters['sparknet_gen_ttft_seconds_bucket{le="%s"}'
                             % _le(le)] = float(c)
                yield t, h, counters, {"sparknet_gen_active_streams": s["depth"]}
        yield name, t, None, None


class Pair:
    """A JAX and a port store + evaluator fed the same history."""

    def __init__(self, budget=None, seed=0, limit=None):
        self.regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
        kw = {} if budget is None else {"budget_bytes": budget}
        self.tsdbs = (jtsdb.TSDB(registry=self.regs[0], **kw),
                      ttsdb.TSDB(registry=self.regs[1], **kw))
        self.evs = (
            jslo.SLOEvaluator(self.tsdbs[0], registry=self.regs[0],
                              eval_interval_s=0.0),
            tslo.SLOEvaluator(self.tsdbs[1], registry=self.regs[1],
                              eval_interval_s=0.0))
        self.checkpoints = {}
        self.payloads = []
        for i, (t, host, counters, gauges) in enumerate(history(seed)):
            if limit is not None and i == limit:
                self.checkpoints["cut"] = t
                self.payloads.append((t, [ev.evaluate(now=t)
                                          for ev in self.evs]))
                break
            if counters is None:  # a checkpoint: (name, t)
                self.checkpoints[t] = host
                self.payloads.append((t, [ev.evaluate(now=host)
                                          for ev in self.evs]))
                continue
            for db in self.tsdbs:
                db.record_snapshot(host, counters, gauges, t)
        self.end = max(self.checkpoints.values())

    def both(self, fn):
        a, b = fn(self.tsdbs[0]), fn(self.tsdbs[1])
        same(a, b)
        return a


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_store_contents_and_accounting_equal(pair):
    names = pair.both(lambda d: d.series_names())
    # 7 counters, the TTFT buckets with +Inf, the queue gauge
    assert len(names) == 7 + len(LES) + 1 + 1
    assert pair.both(lambda d: d.hosts()) == ["h0", "h1"]
    pair.both(lambda d: d.stats())
    pair.both(lambda d: d.resident_bytes)
    for name in names:
        for host in (None, "h0", "h1"):
            pair.both(lambda d: d.latest(name, host))


@pytest.mark.parametrize("range_s,step_s", [
    (120.0, None), (300.0, 1.0), (3600.0, None), (3600.0, 10.0),
    (21600.0, None), (21600.0, 60.0), (600.0, 60.0)],
    ids=["2m", "5m@1s", "1h", "1h@10s", "6h", "6h@60s", "10m@60s"])
def test_queries_and_rollups_equal(pair, range_s, step_s):
    """Every series, per host and fleet-wide, now and at the end of the
    sustained burn (a window in the past)."""
    steps = set()
    for name in pair.both(lambda d: d.series_names()):
        for host in (None, "h0", "h1"):
            for now in (pair.end, pair.checkpoints["sustained"], None):
                res = pair.both(lambda d: d.query(
                    name, host=host, range_s=range_s, step_s=step_s, now=now))
                if res is not None:
                    steps.add(res["step_s"])
    assert steps  # the stage the range and step select


def test_window_folds_equal(pair):
    for now in (pair.end, pair.checkpoints["burst"],
                pair.checkpoints["sustained"]):
        for w in (300.0, 3600.0, 21600.0):
            for host in (None, "h0", "h1"):
                for name in ("sparknet_gen_streams_total",
                             "sparknet_rounds_total",
                             'sparknet_gen_streams_shed_total{cause="kv_reserve"}'):
                    pair.both(lambda d: d.window_delta(name, w, now, host))
                pair.both(lambda d: d.window_delta_prefix(
                    "sparknet_gen_streams_shed_total{", w, now, host))
                pair.both(lambda d: d.window_stats(
                    "sparknet_gen_active_streams", w, now, host))
                pair.both(lambda d: d.slope_per_s(
                    "sparknet_gen_active_streams", w, now, host))
                hw = pair.both(lambda d: d.histogram_window(
                    "sparknet_gen_ttft_seconds", w, now, host))
                if hw is not None:
                    for q in (0.5, 0.9, 0.99, 1.0):
                        same(jtsdb.bucket_quantile(hw["le"], q),
                             ttsdb.bucket_quantile(hw["le"], q))


def test_slo_payloads_statuses_and_alerts_equal(pair):
    for t, (a, b) in pair.payloads:
        same(a, b)
    statuses = {t: {r["name"]: r["status"] for r in a["slos"]}
                for t, (a, _) in pair.payloads}
    # the storm moved the availability objective through warn and page
    seen = {s["serve-availability"] for s in statuses.values()}
    assert {"ok", "page"} <= seen, statuses
    same(list(pair.evs[0].alerts), list(pair.evs[1].alerts))
    severities = [a["severity"] for a in pair.evs[1].alerts]
    assert "page" in severities and "recover" in severities
    same(pair.evs[0].state(), pair.evs[1].state())


@pytest.mark.parametrize("which", ["end", "sustained", "burst"])
def test_signals_equal(pair, which):
    now = pair.end if which == "end" else pair.checkpoints[which]
    same(pair.evs[0].signals(now=now), pair.evs[1].signals(now=now))


def _families(text, prefixes):
    """The lines (HELP, TYPE and samples) of the families under
    ``prefixes``."""
    out = []
    for ln in text.splitlines():
        name = (ln.split()[2] if ln.startswith("#")
                else ln.split("{")[0].split(" ")[0])
        if name.startswith(prefixes):
            out.append(ln)
    return out


def test_tsdb_slo_and_signal_metric_text_equal(pair):
    for ev in pair.evs:
        ev.signals(now=pair.end)
    for db in pair.tsdbs:
        db.refresh_metrics()
    prefixes = ("sparknet_tsdb_", "sparknet_slo_", "sparknet_signal_")
    jt = sorted(_families(pair.regs[0].render(), prefixes))
    tt = sorted(_families(pair.regs[1].render(), prefixes))
    assert jt == tt
    assert any(ln.startswith("sparknet_slo_burn_rate{") for ln in tt)
    assert any(ln.startswith("sparknet_tsdb_series ") for ln in tt)
    assert any(ln.startswith("sparknet_signal_round_rate{") for ln in tt)


def test_budget_refuses_new_series_as_jax():
    small = Pair(budget=8 * 40_000, seed=1, limit=200)
    st = small.both(lambda d: d.stats())
    assert st["dropped_series_total"] > 0 and st["series"] > 0
    for t, (a, b) in small.payloads:
        same(a, b)


def test_sampler_over_a_registry_equals_jax():
    """The single-host path: a registry's snapshots sampled at pinned
    times into the store, the evaluator run each time."""
    sides = []
    for m, db, sl in ((jmetrics, jtsdb, jslo), (tmetrics, ttsdb, tslo)):
        reg = m.MetricsRegistry()
        c = reg.counter("sparknet_rounds_total")
        s = reg.counter("sparknet_straggler_rounds_total")
        h = reg.histogram("sparknet_gen_ttft_seconds")
        g = reg.gauge("sparknet_feed_queue_depth")
        store = db.TSDB(registry=reg)
        ev = sl.SLOEvaluator(store, registry=reg, live_registry=reg,
                             eval_interval_s=5.0)
        sampler = sl.TsdbSampler(store, reg, evaluator=ev, host="local")
        rng = np.random.RandomState(2)
        for i in range(200):
            c.inc(int(rng.randint(0, 3)))
            s.inc(int(rng.rand() < 0.2))
            for v in rng.lognormal(-2.0, 1.0, 4):
                h.observe(float(v))
            g.set(float(rng.randint(0, 9)))
            sampler.sample_once(now=T0 + 3.0 * i)
        sides.append((store, ev, reg))
    now = T0 + 3.0 * 199
    for name in sides[0][0].series_names():
        same(sides[0][0].query(name, range_s=600.0, now=now),
             sides[1][0].query(name, range_s=600.0, now=now))
    same(sides[0][1].evaluate(now=now), sides[1][1].evaluate(now=now))
    sig = [side[1].signals(now=now) for side in sides]
    for s_ in sig:  # the live p99 reads the wall clock's window: apart
        s_.pop("ttft_p99_live_s")
    same(sig[0], sig[1])


def test_histogram_window_quantile_equals_jax():
    hs = [m.MetricsRegistry().histogram("lat") for m in (jmetrics, tmetrics)]
    vals = np.random.RandomState(3).lognormal(-3.0, 1.0, 500)
    for h in hs:
        for v in vals:
            h.observe(float(v))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        same(hs[0].window_quantile(q, window_s=600.0),
             hs[1].window_quantile(q, window_s=600.0))
        same(hs[0].quantile(q), hs[1].quantile(q))
    assert hs[1].window_count(window_s=600.0) == 500
    same(hs[0].mean(), hs[1].mean())
    # a window that ends far in the future holds nothing
    assert hs[1].window_quantile(0.5, window_s=1.0, now=1e12) == 0.0


def test_snapshot_and_counter_deltas_equal():
    snaps = []
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        c = reg.counter("jobs_total")
        f = reg.counter("shed_total", labels=("cause",))
        g = reg.gauge("depth")
        h = reg.histogram("lat", buckets=(0.1, 1.0))
        c.inc(3)
        f.labels("queue_full").inc(2)
        g.set(7)
        h.observe(0.05)
        h.observe(5.0)
        snaps.append(reg.snapshot())
    same(snaps[0], snaps[1])
    assert snaps[1]["counters"]['lat_bucket{le="+Inf"}'] == 2.0
    prev = {"jobs_total": 5.0, 'shed_total{cause="queue_full"}': 1.0,
            "gone_total": 4.0}
    same(jmetrics.counter_deltas(prev, snaps[0]["counters"]),
         tmetrics.counter_deltas(prev, snaps[1]["counters"]))
    deltas, resets = tmetrics.counter_deltas(prev, snaps[1]["counters"])
    assert resets == ["jobs_total"] and deltas["jobs_total"] == 3.0
    assert deltas['shed_total{cause="queue_full"}'] == 1.0
    assert "gone_total" not in deltas
