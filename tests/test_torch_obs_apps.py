"""The telemetry plane in the port's entry points, against the JAX
package's.

- ``cifar_app --compress int8`` on the CPU with every telemetry flag
  (``--obs --obs_port 0 --slo --trace_out --fleet_collector --profile
  --flight_recorder``) and the JAX ``cifar_app`` with the same flags:
  the same metric families and label sets (``sparknet_jit_cache_size``
  excepted: the port compiles no programs), equal ``rounds_total``,
  ``iters_total``, int8 ``collective_bytes_total`` and per-phase
  ``phase_latency_seconds`` counts, and the same phase spans in each
  round of the trace (each span's count equal to its histogram count).
- The sidecar's ``/metrics``, ``/healthz``, ``/query``, ``/slo`` and
  ``/signals`` answer while the run is alive, and the collector's
  ``/fleet`` shows the run's one host.

The runs' bits with telemetry on and off, ``cli serve --slo`` and the
per-rank trace files are in ``tests/test_torch_obs_bits.py``.

``run_until_telemetry`` (used by the entry points' flag tests) runs an
entry point until its telemetry has started, then stops it.
"""

import json
import re
import time
import urllib.request
from collections import Counter

import pytest
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.apps import cifar_app, guards

ROUNDS = 2
CIFAR = ["--workers", "2", "--tau", "1", "--batch", "20", "--rounds",
         str(ROUNDS), "--test_every", "100", "--compress", "int8",
         "--seed", "0"]
FLAGS = ["--obs", "--obs_port", "0", "--slo", "--fleet_collector",
         "127.0.0.1:0", "--profile"]
# the families the port leaves out, with the reason in ROADMAP §C
NO_COUNTERPART = {"sparknet_jit_cache_size"}
# families whose children depend on the run's wall time, with their
# label names
TIMED_CHILDREN = {"sparknet_signal_round_rate": ("host",),
                  "sparknet_slo_alerts_total": ("severity", "slo")}


class TelemetryStarted(BaseException):
    """Raised where an entry point's telemetry has started (its flags
    ran); a BaseException, so no ``except Exception`` of the app
    swallows it."""


def get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def run_until_telemetry(monkeypatch, main, argv):
    """``main(argv)`` up to its ``obs.start``: the real start runs, the
    sidecar (when on) is scraped, the run is closed and the entry point
    stopped.  Returns ``start``'s arguments, the ObsRun and the
    scrapes."""
    real = obs.start
    seen = {}

    def start(**kw):
        run = real(**kw)
        seen.update(kwargs=kw, run=run)
        if run.exporter is not None:
            h, p = run.address
            seen["metrics"] = get(f"http://{h}:{p}/metrics")
            seen["healthz"] = get(f"http://{h}:{p}/healthz")
        run.close()
        raise TelemetryStarted()

    monkeypatch.setattr(obs, "start", start)
    with pytest.raises(TelemetryStarted):
        main(argv)
    monkeypatch.setattr(obs, "start", real)
    return seen


def flag_runs(monkeypatch, tmp_path, main, argv):
    """The telemetry flags in ``argv`` run: ``main`` starts what they
    ask for.  Stand-in values are made local first: a ``--trace_out``
    path goes under ``tmp_path``, a ``--ship_to`` URL becomes a loopback
    collector's, and ``--obs`` / ``--slo`` bind an ephemeral port."""
    from sparknet_tpu_torch.obs.fleet import FleetCollector

    collector = FleetCollector(port=0).start()
    argv = list(argv)
    try:
        for i, a in enumerate(argv[:-1]):
            if a == "--trace_out":
                argv[i + 1] = str(tmp_path / "trace.json")
            elif a == "--ship_to":
                argv[i + 1] = collector.url
        if "--host_id" in argv and "--ship_to" not in argv:
            argv += ["--ship_to", collector.url]
        if ("--obs" in argv or "--slo" in argv) and "--obs_port" not in argv:
            argv += ["--obs_port", "0"]
        seen = run_until_telemetry(monkeypatch, main, argv)
        run, kw = seen["run"], seen["kwargs"]
        if "--trace_out" in argv:
            assert run.tracer is not None
            with open(tmp_path / "trace.json") as f:
                assert "traceEvents" in json.load(f)
        if "--obs" in argv or "--slo" in argv:
            assert seen["metrics"][0] == 200 and seen["healthz"][0] == 200
            assert "sparknet_phase_latency_seconds" in seen["metrics"][1]
        if "--slo" in argv:
            assert run.sampler is not None
            assert "slo" in json.loads(seen["healthz"][1])
        if "--obs_port" in argv:
            assert kw["port"] == int(argv[argv.index("--obs_port") + 1])
        if "--ship_to" in argv:
            host = kw["host_id"] or run.shipper.host
            assert run.shipper.url == collector.url
            assert collector.fleet_view()["hosts"][host]["state"] == "finished"
        if "--host_id" in argv:
            assert kw["host_id"] == argv[argv.index("--host_id") + 1]
            assert kw["host_id"] in collector.fleet_view()["hosts"]
        return seen
    finally:
        collector.close()


def small_cifar(d) -> str:
    """A CIFAR binary set of 200 train and 40 test images under ``d``."""
    from sparknet_tpu_torch.data import CifarLoader

    path = str(d / "cifar")
    CifarLoader.write_synthetic(path, num_train=200, num_test=40)
    return path


def families(text):
    """``{family: sorted label-name tuples}`` of a Prometheus text (a
    histogram's ``le`` left out)."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    out = {name: set() for name in types}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample = line.split(" ")[0]
        name, _, labels = sample.partition("{")
        if name not in types:
            name = re.sub(r"_(bucket|sum|count)$", "", name)
        keys = tuple(sorted(k for k in re.findall(r'(\w+)="', labels)
                            if k != "le"))
        out[name].add(keys)
    return {k: sorted(v) for k, v in out.items()}


def sample(text, name):
    m = re.search(r"^%s (\S+)$" % re.escape(name), text, re.M)
    return None if m is None else float(m.group(1))


def phase_counts(text):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^sparknet_phase_latency_seconds_count\{phase="(\w+)"\} (\S+)$',
        text, re.M)}


def trace_rounds(path):
    """Each round's phase-span names in order, split at the main
    thread's ``average`` spans (one a round), plus the names' counts."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") == "phase"), key=lambda e: e["ts"])
    ends = [e["ts"] + e["dur"] for e in spans if e["name"] == "average"]
    rounds = [[] for _ in ends]
    for e in spans:
        r = next((i for i, t in enumerate(ends) if e["ts"] < t), None)
        if r is not None and e["name"] not in ("assemble", "h2d"):
            rounds[r].append(e["name"])
    return rounds, Counter(e["name"] for e in spans)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and the port's, both with every flag, on one small
    synthesized CIFAR set; the port's sidecar scraped at its round 1
    commit."""
    from sparknet_tpu import obs as jobs
    from sparknet_tpu.apps import cifar_app as jcifar

    d = tmp_path_factory.mktemp("obs_apps")
    data = small_cifar(d)
    torch.set_num_threads(1)
    out = {"dir": d}
    mp = pytest.MonkeyPatch()
    jax_run, jax_start = {}, jobs.start

    def jstart(*a, **kw):
        jax_run["run"] = jax_start(*a, **kw)
        return jax_run["run"]

    mp.setattr(jobs, "start", jstart)
    jobs._reset_training_metrics_for_tests()
    try:
        assert jcifar.main(CIFAR + FLAGS + ["--data", data, "--trace_out",
                                            str(d / "jax.json")]) == 0
        # the /signals read the port's run gets below
        jax_run["run"].sampler.evaluator.signals(now=time.time())
        out["jax_text"] = jobs.training_metrics().registry.render()
    finally:
        mp.undo()
        jobs._reset_training_metrics_for_tests()
        jobs.set_slo_evaluator(None)

    live, real_start, real_commit = {}, obs.start, guards.RoundGuards.commit

    def start(**kw):
        live["run"] = real_start(**kw)
        return live["run"]

    def commit(self, r, **meta):
        real_commit(self, r, **meta)
        if r == 1:  # the run is alive: scrape its endpoints
            run = live["run"]
            run.sampler.sample_once()
            h, p = run.address
            base = f"http://{h}:{p}"
            live["scrapes"] = {
                path: get(base + path) for path in (
                    "/metrics", "/healthz", "/slo", "/signals",
                    "/query?series=sparknet_rounds_total&range=300")}
            deadline = time.time() + 10  # the shipper pushes every 0.5 s
            while True:
                fleet = json.loads(get(run.collector.url + "/fleet")[1])
                if fleet["hosts"] or time.time() > deadline:
                    break
                time.sleep(0.05)
            live["fleet"] = fleet

    mp.setattr(obs, "start", start)
    mp.setattr(guards.RoundGuards, "commit", commit)
    try:
        on = {}
        assert cifar_app.main(
            CIFAR + FLAGS + ["--device", "cpu", "--data", data, "--trace_out",
                             str(d / "port.json"), "--flight_recorder",
                             str(d / "flight.json")], result=on) == 0
    finally:
        mp.undo()
    out.update(on=on, live=live, port_text=on["metrics"].registry.render())
    return out


def test_metric_families_and_label_sets_equal_jax(runs):
    jf, tf = families(runs["jax_text"]), families(runs["port_text"])
    assert set(jf) - set(tf) == NO_COUNTERPART
    assert set(tf) - set(jf) == set()
    for name in tf:
        if name in TIMED_CHILDREN:
            # children that exist once a wall-clock event happened: a
            # host's two samples a bucket apart, an alert transition
            assert set(tf[name]) | set(jf[name]) <= {TIMED_CHILDREN[name]}
            continue
        assert tf[name] == jf[name], name
    for name in ("sparknet_phase_latency_seconds", "sparknet_uptime_seconds",
                 "sparknet_device_bytes", "sparknet_host_rss_bytes",
                 "sparknet_ship_events_total", "sparknet_ship_dropped_total",
                 "sparknet_ship_pushes_total",
                 "sparknet_ship_push_failures_total",
                 "sparknet_tsdb_series", "sparknet_slo_burn_rate"):
        assert name in tf, name


def test_counts_equal_jax(runs):
    jt, tt = runs["jax_text"], runs["port_text"]
    for name in ("sparknet_rounds_total", "sparknet_iters_total",
                 'sparknet_collective_bytes_total{compress="int8"}'):
        assert sample(tt, name) == sample(jt, name), name
    assert sample(tt, "sparknet_rounds_total") == ROUNDS
    assert sample(tt, "sparknet_iters_total") == ROUNDS
    assert sample(tt, 'sparknet_collective_bytes_total{compress="int8"}') > 0
    assert phase_counts(tt) == phase_counts(jt)
    assert sample(tt, "sparknet_ship_dropped_total") == 0
    assert sample(tt, "sparknet_device_bytes") == 0  # a CPU run


def test_trace_phases_each_round_equal_jax(runs):
    d = runs["dir"]
    jr, jc = trace_rounds(str(d / "jax.json"))
    tr, tc = trace_rounds(str(d / "port.json"))
    assert len(tr) == ROUNDS and tr == jr
    assert tc == jc
    # each span's count is its phase histogram's count
    assert {k: float(v) for k, v in tc.items()} == \
        phase_counts(runs["port_text"])
    with open(str(d / "port.jsonl")) as f:
        names = Counter(json.loads(ln)["name"] for ln in f)
    assert all(names[k] == v for k, v in tc.items())


def test_endpoints_answer_while_the_run_is_alive(runs):
    s = runs["live"]["scrapes"]
    assert all(code == 200 for code, _ in s.values()), s
    assert sample(s["/metrics"][1], "sparknet_rounds_total") == 2
    health = json.loads(s["/healthz"][1])
    assert health["status"] == "ok" and "slo" in health and "profile" in health
    slo = json.loads(s["/slo"][1])
    assert {r["name"] for r in slo["slos"]} >= {"train-round-time",
                                                "train-straggler-free"}
    assert "round_rate_per_s" in json.loads(s["/signals"][1])
    q = json.loads(s["/query?series=sparknet_rounds_total&range=300"][1])
    assert q["kind"] == "counter" and q["points"]
    fleet = runs["live"]["fleet"]
    assert fleet["fleet"]["hosts_total"] == 1
    (host,) = fleet["hosts"].values()
    assert host["state"] == "live" and host["lost_events"] == 0
