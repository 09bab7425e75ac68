"""Observability of the port: metrics, spans, the ``/metrics`` sidecar,
the retention and SLO plane, the fleet plane, request tracing, the
training-health sentry, the flight recorder and the round profiler.

The port's own copy of ``sparknet_tpu/obs/``:

- ``obs.metrics``: counters, gauges, histograms and label families on a
  ``MetricsRegistry`` (Prometheus text, ``snapshot()``), and
  ``TrainingMetrics``, the training series of a run;
- ``obs.trace``: ``span()``/``instant()`` into a Chrome trace plus a
  JSONL run log (``--trace_out``), the phase histogram, the flight ring
  and the shipper;
- ``obs.exporter``: the ``/metrics`` + ``/healthz`` sidecar (``--obs``),
  with ``/query``, ``/slo`` and ``/signals`` under ``--slo``;
- ``obs.tsdb`` and ``obs.slo``: the in-process time-series store and the
  burn-rate SLO evaluator over it (``--slo``);
- ``obs.ship`` and ``obs.fleet``: the per-host shipper (``--ship_to``,
  ``--host_id``) and the cross-host collector (``--fleet_collector``);
- ``obs.health``, ``obs.flight``, ``obs.profile``, ``obs.reqtrace``: the
  sentry (``--health``), the flight recorder (``--flight_recorder``), the
  round profiler (``--profile``) and the request profiler.  ``health``
  and ``profile`` are imported on demand: they pull torch.

Instrumented code calls the module-level hooks (``obs.span``,
``obs.instant``, ``obs.training_metrics()``, ``obs.fault``), near-free
no-ops until ``start`` turns them on.  The port has no process-wide
``TrainingMetrics``: an app makes its own and hands it to
``start(tm=...)``, which installs it where the data plane, the shipper
and the fault hook read it (``training_metrics()``) and feeds the
phase spans into its histogram; ``ObsRun.close`` puts the previous one
back.  Each entry point has one ``start_from_args`` / ``ObsRun.close``
pair for all of its telemetry.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional

from sparknet_tpu_torch.obs import flight  # noqa: F401
from sparknet_tpu_torch.obs import trace as _trace
from sparknet_tpu_torch.obs.exporter import JsonHTTPHandler, ObsExporter  # noqa: F401
from sparknet_tpu_torch.obs.fleet import (  # noqa: F401
    DEFAULT_FLEET_PORT,
    FleetCollector,
    parse_hostport,
)
from sparknet_tpu_torch.obs.ship import Shipper  # noqa: F401
from sparknet_tpu_torch.obs.trace import (  # noqa: F401
    Tracer,
    get_tracer,
    install_tracer,
    instant,
    jsonl_path_for,
    set_phase_observer,
    set_ship,
    span,
    uninstall_tracer,
)

DEFAULT_OBS_PORT = 8380

_unhealthy_reason: Optional[str] = None
# the active divergence sentry (obs/health.py), membership controller
# (runtime/membership.py) and SLO evaluator (obs/slo.py): /healthz and
# flight bundles read their exported state
_sentry = None
_membership = None
_slo_evaluator = None
_training_metrics = None


def set_training_metrics(metrics):
    """Install the run's TrainingMetrics for the data plane (None
    clears); returns the one it replaces."""
    global _training_metrics
    prev, _training_metrics = _training_metrics, metrics
    return prev


def training_metrics():
    """The installed TrainingMetrics, or None."""
    return _training_metrics


@contextlib.contextmanager
def installed_metrics(metrics):
    """``set_training_metrics(metrics)`` for the block, the previous one
    put back after it."""
    prev = set_training_metrics(metrics)
    try:
        yield metrics
    finally:
        set_training_metrics(prev)


def set_sentry(sentry) -> None:
    """Register the run's HealthSentry (None clears)."""
    global _sentry
    _sentry = sentry


def sentry_state() -> Optional[dict]:
    """The active sentry's exported state, or None when no sentry."""
    s = _sentry
    return None if s is None else s.state_dict()


def set_membership(controller) -> None:
    """Register the run's MembershipController (None clears)."""
    global _membership
    _membership = controller


def membership_state() -> Optional[dict]:
    """The active membership controller's exported view, or None."""
    m = _membership
    return None if m is None else m.state_dict()


def profile_state() -> Optional[dict]:
    """The active round profiler's exported state, or None: the
    /healthz ``profile`` block."""
    from sparknet_tpu_torch.obs import profile

    return profile.state()


def set_slo_evaluator(evaluator) -> None:
    """Register the run's SLO evaluator (None clears): /healthz gains an
    ``slo`` block."""
    global _slo_evaluator
    _slo_evaluator = evaluator


def slo_state() -> Optional[dict]:
    """The active SLO evaluator's compact state, or None."""
    ev = _slo_evaluator
    return None if ev is None else ev.state()


def fault(kind: str, **args) -> None:
    """Tag an injected fault: an instant on the trace, the per-kind
    counter of the installed metrics and a flight-recorder dump when one
    is installed."""
    instant(f"fault_{kind}", cat="fault", **args)
    tm = _training_metrics
    if tm is not None:
        tm.faults.labels(kind).inc()
    flight.dump_if_active(f"fault_{kind}", extra=args or None)


def report_unhealthy(reason: str) -> None:
    """Flip /healthz to 503 (a sentry halt, a feed stall)."""
    global _unhealthy_reason
    _unhealthy_reason = reason


def report_healthy() -> None:
    """A round completed: clear the unhealthy flag."""
    global _unhealthy_reason
    _unhealthy_reason = None


def health_reason() -> Optional[str]:
    return _unhealthy_reason


# ----------------------------------------------------------------------
# the flags every entry point takes (the JAX package's add_cli_args)


def add_cli_args(parser) -> None:
    parser.add_argument(
        "--obs", action="store_true",
        help="serve live Prometheus /metrics + /healthz for this run "
        "(sidecar on --obs_port)",
    )
    parser.add_argument(
        "--obs_port", type=int, default=DEFAULT_OBS_PORT,
        help="telemetry sidecar port (0 = ephemeral)",
    )
    parser.add_argument(
        "--trace_out", "--trace-out", default=None, metavar="TRACE.json",
        help="write a Chrome trace (load in Perfetto: ui.perfetto.dev) "
        "of round phases to this path, plus a .jsonl structured run log "
        "(across processes rank r > 0 writes TRACE.p<r>.json)",
    )
    parser.add_argument(
        "--health", nargs="?", const="warn", default=None,
        choices=["warn", "halt", "rollback"], metavar="POLICY",
        help="enable the numerics audit + divergence sentry "
        "(warn|halt|rollback; bare --health = warn).  rollback restores "
        "the newest verified snapshot and skips the poisoned window "
        "(loops without snapshots degrade it to halt)",
    )
    parser.add_argument(
        "--health_policy", default=None, choices=["warn", "halt", "rollback"],
        help="sentry policy (overrides --health's value)",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="install the round-anatomy profiler (obs/profile.py): the "
        "per-phase breakdown, measured H2D and collective hidden "
        "fractions, per-worker skew and straggler verdicts, and "
        "achieved FLOP/s / MFU; a summary table prints when the run ends",
    )
    parser.add_argument(
        "--profile_out", default=None, metavar="SUMMARY.json",
        help="write the end-of-run RoundProfiler.summary() as JSON "
        "(implies --profile; rank 0 writes it across processes)",
    )
    parser.add_argument(
        "--slo", action="store_true",
        help="retain metric history in the in-process TSDB "
        "(obs/tsdb.py ring buffers, staged 1s/10s/60s rollups) and "
        "evaluate burn-rate SLOs over it (obs/slo.py): the sidecar "
        "gains /query, /slo and /signals plus an slo /healthz block "
        "(implies --obs)",
    )
    parser.add_argument(
        "--ship_to", default=None, metavar="http://HOST:PORT",
        help="ship this process's metric deltas + run-log events to a "
        "fleet collector (obs/ship.py; own thread, bounded buffer, retry "
        "backoff: training never blocks on the network)",
    )
    parser.add_argument(
        "--fleet_collector", nargs="?",
        const=f"127.0.0.1:{DEFAULT_FLEET_PORT}", default=None,
        metavar="HOST:PORT",
        help="start the fleet collector in this process (obs/fleet.py: "
        "cross-host metric/event merge, clock-aligned /trace + /runlog, "
        "global /fleet + /metrics with live|late|dead attribution).  "
        "Without --ship_to this process also ships to its own collector",
    )
    parser.add_argument(
        "--host_id", default=None,
        help="this process's identity in the fleet view (default: "
        "$SPARKNET_HOST_ID, else hostname:pid)",
    )
    parser.add_argument(
        "--flight_recorder", nargs="?", const=flight.DEFAULT_BUNDLE_PATH,
        default=None, metavar="BUNDLE.json",
        help="keep a bounded ring of recent spans, samples and health "
        "verdicts and dump it as a postmortem JSON bundle on crash, "
        "SIGTERM, sentry halt, rollback or an injected fault (across "
        "processes rank r > 0 writes BUNDLE.p<r>.json)",
    )


class ObsRun:
    """One run's telemetry; ``close()`` is idempotent: it prints and
    writes the profile summary (kept in ``profile_summary``), stops the
    sampler, the sidecar, the tracer (writing the trace file), the
    flight recorder, the shipper (its final flush) and the collector,
    and puts back the phase observer and the installed metrics that
    ``start`` replaced."""

    def __init__(self, exporter=None, tracer=None, trace_out=None,
                 metrics=None, recorder=None, profiler=None, echo=None,
                 profile_out: Optional[str] = None, shipper=None,
                 collector=None, sampler=None, restore=None):
        self.exporter = exporter
        self.tracer = tracer
        self.trace_out = trace_out
        self.metrics = metrics
        self.recorder = recorder
        self.profiler = profiler
        self.profile_out = profile_out
        self.profile_summary: Optional[dict] = None
        self.shipper = shipper
        self.collector = collector
        self.sampler = sampler
        self._echo = echo
        # (previous metrics, previous phase observer) when start
        # installed this run's
        self._restore = restore
        self._closed = False

    @property
    def address(self):
        return self.exporter.address if self.exporter is not None else None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.profiler is not None:
            from sparknet_tpu_torch.obs import profile

            self.profile_summary = self.profiler.summary()
            if self._echo is not None and self.profiler.rounds_profiled:
                self._echo(profile_summary_text(self.profiler))
            if self.profile_out:
                with open(self.profile_out, "w") as f:
                    json.dump(self.profile_summary, f, indent=1)
                if self._echo is not None:
                    self._echo(f"obs: profile summary -> {self.profile_out}")
            profile.uninstall(self.profiler)
        if self.sampler is not None:
            # a final sample and evaluation, then detach: a later run in
            # this process must not inherit this run's alert state
            self.sampler.stop()
            set_slo_evaluator(None)
        if self.exporter is not None:
            self.exporter.close()
        if self.tracer is not None:
            if get_tracer() is self.tracer:
                uninstall_tracer()
            if self.trace_out:
                self.tracer.save(self.trace_out)
            self.tracer.close()
        if self.recorder is not None:
            # a clean close detaches without dumping
            flight.uninstall(self.recorder)
        if self.shipper is not None:
            # detach the hook first (nothing enqueues during the final
            # flush), then stop: stop() ships the buffered tail
            if _trace._ship is self.shipper:
                set_ship(None)
            self.shipper.stop()
        if self.collector is not None:
            # after the shipper's final flush, so a local collector sees
            # this run's tail before its listener goes down
            self.collector.close()
        if self._restore is not None:
            prev_metrics, prev_phase = self._restore
            set_phase_observer(prev_phase)
            set_training_metrics(prev_metrics)
        # the sentry and the membership controller are scoped to the run
        set_sentry(None)
        set_membership(None)


def profile_summary_text(profiler) -> str:
    """The one-screen rendering of a profiler summary (the end-of-run
    table of ``--profile``)."""
    s = profiler.summary()
    lines = ["profile: round anatomy over %d round(s)" % s["rounds"]]
    for name, p in s["phases"].items():
        lines.append(
            "  %-10s p50 %9.2f ms  p90 %9.2f ms  max %9.2f ms  [%s]"
            % (name, p["p50_ms"], p["p90_ms"], p["max_ms"], p["bound"]))
    for key, label in (("hidden_frac_h2d", "H2D hidden fraction"),
                       ("hidden_frac_comm", "collective hidden fraction")):
        if s.get(key):
            lines.append("  %s: p50 %.3f (min %.3f)"
                         % (label, s[key]["p50"], s[key]["min"]))
    if s.get("worker_skew"):
        lines.append(
            "  worker skew (max/median): p50 %.3f max %.3f; straggler "
            "rounds %d%s"
            % (s["worker_skew"]["p50"], s["worker_skew"]["max"],
               s["straggler_rounds"],
               " (last: worker %s @ round %s)"
               % (s["last_straggler_worker"], s["last_straggler_round"])
               if s["last_straggler_worker"] is not None else ""))
    if s.get("achieved_flops_per_s"):
        mfu = s.get("mfu")
        lines.append(
            "  achieved %.2f GFLOP/s%s"
            % (s["achieved_flops_per_s"] / 1e9,
               "  (MFU %.2f%% of %.0f TFLOP/s)"
               % (100 * mfu, s["peak_flops"] / 1e12) if mfu
               else "  (no peak for this device: MFU n/a)"))
    return "\n".join(lines)


def start(
    metrics: bool = False,
    port: int = DEFAULT_OBS_PORT,
    host: str = "127.0.0.1",
    trace_out: Optional[str] = None,
    flight_out: Optional[str] = None,
    profile_rounds: bool = False,
    profile_out: Optional[str] = None,
    ship_to: Optional[str] = None,
    fleet_collector: Optional[str] = None,
    host_id: Optional[str] = None,
    slo: bool = False,
    echo=print,
    tm=None,
    registry=None,
    announce=None,
) -> ObsRun:
    """Turn telemetry on for a run: ``metrics=True`` starts the
    /metrics + /healthz sidecar; ``trace_out`` installs the tracer;
    ``flight_out`` the flight recorder (bundle path); ``profile_rounds``
    the round profiler; ``fleet_collector`` ("HOST:PORT") starts the
    fleet collector in this process; ``ship_to`` (a collector URL)
    ships this process's metric deltas and run-log events there (with a
    collector and no ``ship_to`` the process ships to its own).
    ``slo=True`` (implies ``metrics``) arms the TSDB sampler and the
    burn-rate evaluator, and the sidecar serves /query, /slo and
    /signals too.  Sidecar, trace, profile and ship install ``tm`` (a
    ``TrainingMetrics``; when None a fresh one, on ``registry`` when
    given) as the run's metrics and feed the phase spans into its
    histogram.  ``echo`` takes the log
    lines, ``announce`` (default ``echo``) the start-up ones.  Returns
    the ``ObsRun`` to ``close()`` in the run's ``finally``."""
    say = announce or echo
    profile_rounds = profile_rounds or bool(profile_out)
    metrics = metrics or slo
    if not any((metrics, trace_out, flight_out, profile_rounds, ship_to,
                fleet_collector)):
        return ObsRun()
    recorder = None
    if flight_out:
        recorder = flight.install(flight.FlightRecorder(flight_out, metrics=tm))
        if say is not None:
            say(f"obs: flight recorder armed -> {flight_out}")
    profiler = None
    if profile_rounds:
        from sparknet_tpu_torch.obs import profile

        profiler = profile.install(profile.RoundProfiler())
        if say is not None:
            say("obs: round-anatomy profiler on (phase breakdown, hidden "
                "fractions, straggler verdicts)")
    collector = None
    if fleet_collector:
        chost, cport = parse_hostport(fleet_collector)
        collector = FleetCollector(host=chost, port=cport).start()
        if say is not None:
            say("obs: fleet collector on %s/fleet (merged /metrics, "
                "clock-aligned /trace + /runlog)" % collector.url)
        if not ship_to:
            ship_to = collector.url  # one flag = a self-shipping fleet
    if not any((metrics, trace_out, profile_rounds, ship_to)):
        return ObsRun(recorder=recorder, collector=collector, echo=echo)
    if tm is None:
        from sparknet_tpu_torch.obs.metrics import TrainingMetrics

        tm = TrainingMetrics(registry)
    fam = tm.phase_latency
    restore = (set_training_metrics(tm), _trace._phase_observer)
    set_phase_observer(lambda name, dur_s: fam.labels(name).observe(dur_s))
    sampler = evaluator = tsdb = None
    if slo:
        from sparknet_tpu_torch.obs.slo import SLOEvaluator, TsdbSampler
        from sparknet_tpu_torch.obs.tsdb import TSDB

        tsdb = TSDB(registry=tm.registry)
        evaluator = SLOEvaluator(tsdb, registry=tm.registry,
                                 live_registry=tm.registry, host=host_id)
        set_slo_evaluator(evaluator)
        sampler = TsdbSampler(tsdb, tm.registry, evaluator=evaluator,
                              host=host_id or "local").start()
        if say is not None:
            say("obs: SLO plane armed — TSDB sampler + burn-rate evaluator "
                "(/query, /slo, /signals)")
    exporter = None
    if metrics:
        exporter = ObsExporter(tm.registry, host=host, port=port,
                               health_fn=health_reason, tsdb=tsdb,
                               slo=evaluator).start()
        if say is not None:
            h, p = exporter.address
            say(f"obs: serving /metrics and /healthz on http://{h}:{p}")
    tracer = None
    if trace_out:
        tracer = install_tracer(Tracer(jsonl_path=jsonl_path_for(trace_out)))
        if say is not None:
            say(f"obs: tracing round phases -> {trace_out} "
                f"(+ {jsonl_path_for(trace_out)})")
    shipper = None
    if ship_to:
        shipper = Shipper(ship_to, host=host_id, registry=tm.registry).start()
        set_ship(shipper)
        if say is not None:
            say("obs: shipping metric deltas + run-log events to %s as "
                "host %r" % (shipper.url, shipper.host))
    return ObsRun(exporter, tracer, trace_out, tm, recorder, profiler, echo,
                  profile_out=profile_out, shipper=shipper,
                  collector=collector, sampler=sampler, restore=restore)


def rank_path(path: Optional[str], rank: int) -> Optional[str]:
    """The file a rank writes for ``path``: the path itself on rank 0,
    ``STEM.p<rank>EXT`` on any other (no two processes write one
    file)."""
    if not path or rank == 0:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.p{rank}{ext}"


def start_from_args(args, echo=print, tm=None, registry=None,
                    rank: Optional[int] = None) -> ObsRun:
    """``start`` from an entry point's parsed flags.  Across processes
    (``rank``, default this process's index in the joined world) rank
    r > 0 writes its own trace and flight bundle (``rank_path``) and no
    ``--profile_out``, and prints its start-up lines (its sidecar's
    address) beside logging them."""
    if rank is None:
        from sparknet_tpu_torch.parallel import mesh

        rank = mesh.process_index()
    announce = None
    if rank > 0:
        def announce(line: str) -> None:
            if echo is not None:
                echo(line)
            print(f"rank {rank}: {line}", flush=True)
    return start(
        metrics=getattr(args, "obs", False),
        port=getattr(args, "obs_port", DEFAULT_OBS_PORT),
        trace_out=rank_path(getattr(args, "trace_out", None), rank),
        flight_out=rank_path(getattr(args, "flight_recorder", None), rank),
        profile_rounds=bool(getattr(args, "profile", False)
                            or getattr(args, "profile_out", None)),
        profile_out=getattr(args, "profile_out", None) if rank == 0 else None,
        ship_to=getattr(args, "ship_to", None),
        fleet_collector=getattr(args, "fleet_collector", None),
        host_id=getattr(args, "host_id", None),
        slo=getattr(args, "slo", False),
        echo=echo,
        tm=tm,
        registry=registry,
        announce=announce,
    )
