"""Observability of the port: metrics, spans, request tracing, the
training-health sentry and the flight recorder.

Own copies of the parts of ``sparknet_tpu/obs/`` that the port's slices
use.  ``obs.span`` and ``obs.instant`` are ``obs/trace.py``'s,
re-exported as the JAX package's ``obs`` does.  The state hooks below
(``set_sentry``, ``set_membership``, ``report_unhealthy``, ...) hold
what the JAX package's ``/healthz`` sidecar reads; the sidecar itself
(``--obs``) is not ported.  ``--profile`` / ``--profile_out`` install
the round-anatomy profiler (``obs/profile.py``) for a run
(``profile_from_args``; ``close_profile`` prints its summary and writes
the JSON).  ``fault`` tags an injected fault (the chaos harness).
``obs.health`` and ``obs.profile`` are imported on demand: they pull
torch.

``set_training_metrics`` installs a run's ``TrainingMetrics`` where the
data plane reads it (``training_metrics()``, the JAX package's hook):
the chunk cache, the retry layer and the prefetch watchdog count into
it.  The trainer and the comm plane record into the object they are
handed.
"""

import contextlib
from typing import Optional

from sparknet_tpu_torch.obs import flight  # noqa: F401
from sparknet_tpu_torch.obs.trace import instant, span  # noqa: F401

_unhealthy_reason: Optional[str] = None
# the active divergence sentry (obs/health.py) and membership controller
# (runtime/membership.py): flight bundles and a health endpoint read
# their exported state
_sentry = None
_membership = None
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
    """Mark the run unhealthy (a sentry halt, a feed stall)."""
    global _unhealthy_reason
    _unhealthy_reason = reason


def report_healthy() -> None:
    """A round completed: clear the unhealthy flag."""
    global _unhealthy_reason
    _unhealthy_reason = None


def health_reason() -> Optional[str]:
    return _unhealthy_reason


# the JAX parser's telemetry flags the port takes but does not run yet
# (the /metrics + /healthz sidecar, the trace file, the fleet plane):
# (flag, takes a value)
NOT_YET_PORTED = (
    ("--obs", False), ("--obs_port", True), ("--trace_out", True),
    ("--slo", False), ("--ship_to", True), ("--fleet_collector", True),
    ("--host_id", True),
)


def add_cli_args(parser) -> None:
    """The JAX package's telemetry flags: ``--health`` /
    ``--health_policy`` / ``--flight_recorder`` / ``--profile`` /
    ``--profile_out``, and the ones ``check_args`` refuses
    (``NOT_YET_PORTED``)."""
    for flag, takes_value in NOT_YET_PORTED:
        if flag == "--trace_out":
            parser.add_argument(flag, "--trace-out", default=None,
                                help="not yet ported")
        elif takes_value:
            parser.add_argument(flag, default=None, help="not yet ported")
        else:
            parser.add_argument(flag, action="store_true",
                                help="not yet ported")
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
        "--flight_recorder", nargs="?", const=flight.DEFAULT_BUNDLE_PATH,
        default=None, metavar="BUNDLE.json",
        help="keep a bounded ring of recent spans, samples and health "
        "verdicts and dump it as a postmortem JSON bundle on crash, "
        "SIGTERM, sentry halt or rollback",
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
        "(implies --profile)",
    )


def check_args(args, app: str) -> None:
    """Refuse the telemetry flags that are not yet ported, naming the
    flag."""
    for flag, _ in NOT_YET_PORTED:
        if getattr(args, flag.lstrip("-"), None) not in (None, False):
            raise SystemExit(
                f"{app}: {flag} is not yet ported to sparknet_tpu_torch")


def flight_from_args(args, metrics=None) -> Optional["flight.FlightRecorder"]:
    """Install the flight recorder ``--flight_recorder`` asks for (None
    when it is off); the caller ``flight.uninstall``s it."""
    path = getattr(args, "flight_recorder", None)
    if not path:
        return None
    return flight.install(flight.FlightRecorder(path, metrics=metrics))


def profile_from_args(args, echo=None):
    """Install the round profiler ``--profile``/``--profile_out`` ask for
    (None when both are off); the caller ends it with
    ``close_profile``."""
    if not (getattr(args, "profile", False) or getattr(args, "profile_out", None)):
        return None
    from sparknet_tpu_torch.obs import profile

    profiler = profile.install(profile.RoundProfiler())
    if echo is not None:
        echo("obs: round-anatomy profiler on (phase breakdown, hidden "
             "fractions, straggler verdicts)")
    return profiler


def close_profile(profiler, profile_out=None, echo=None) -> Optional[dict]:
    """End a profiled run: print the summary table, write the summary
    JSON to ``profile_out`` and uninstall; returns the summary."""
    import json

    from sparknet_tpu_torch.obs import profile

    if profiler is None:
        return None
    summary = profiler.summary()
    if echo is not None and profiler.rounds_profiled:
        echo(profile_summary_text(profiler))
    if profile_out:
        with open(profile_out, "w") as f:
            json.dump(summary, f, indent=1)
        if echo is not None:
            echo(f"obs: profile summary -> {profile_out}")
    profile.uninstall(profiler)
    return summary


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
