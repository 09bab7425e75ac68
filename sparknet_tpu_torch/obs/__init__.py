"""Observability of the port: metrics, spans, request tracing, the
training-health sentry and the flight recorder.

Own copies of the parts of ``sparknet_tpu/obs/`` that the port's slices
use.  ``obs.span`` and ``obs.instant`` are ``obs/trace.py``'s,
re-exported as the JAX package's ``obs`` does.  The state hooks below
(``set_sentry``, ``set_membership``, ``report_unhealthy``, ...) hold
what the JAX package's ``/healthz`` sidecar reads; the sidecar itself
(``--obs``) and the round profiler (``--profile``) are not ported.
``obs.health`` is imported on demand: it pulls torch.
"""

from typing import Optional

from sparknet_tpu_torch.obs import flight  # noqa: F401
from sparknet_tpu_torch.obs.trace import instant, span  # noqa: F401

_unhealthy_reason: Optional[str] = None
# the active divergence sentry (obs/health.py) and membership controller
# (runtime/membership.py): flight bundles and a health endpoint read
# their exported state
_sentry = None
_membership = None


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


def report_unhealthy(reason: str) -> None:
    """Mark the run unhealthy (a sentry halt)."""
    global _unhealthy_reason
    _unhealthy_reason = reason


def report_healthy() -> None:
    """A round completed: clear the unhealthy flag."""
    global _unhealthy_reason
    _unhealthy_reason = None


def health_reason() -> Optional[str]:
    return _unhealthy_reason


# the JAX parser's telemetry flags the port takes but does not run yet
# (the /metrics + /healthz sidecar, the round profiler, the fleet plane):
# (flag, takes a value)
NOT_YET_PORTED = (
    ("--obs", False), ("--obs_port", True), ("--trace_out", True),
    ("--profile", False), ("--profile_out", True), ("--slo", False),
    ("--ship_to", True), ("--fleet_collector", True), ("--host_id", True),
)


def add_cli_args(parser) -> None:
    """The JAX package's telemetry flags: ``--health`` /
    ``--health_policy`` / ``--flight_recorder``, and the ones
    ``check_args`` refuses (``NOT_YET_PORTED``)."""
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
