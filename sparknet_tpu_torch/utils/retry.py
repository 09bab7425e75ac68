"""Retry with exponential backoff and full jitter — the I/O resilience
layer (the port of ``sparknet_tpu/utils/retry.py``, stdlib only).

SparkNet inherited fault tolerance from Spark's RDD lineage: a lost
partition was recomputed and the driver loop never noticed
(SparkNet §3; the reference's own restart-from-snapshot is SURVEY §5).
The framework talks to object stores and record DBs directly, so
transient I/O failure has to be absorbed here instead: every network
fetch goes through ``retry_call`` with

- **exponential backoff + full jitter**: attempt ``k`` sleeps
  ``uniform(0, min(cap, base * 2**k))`` (the AWS-recommended full-jitter
  schedule — decorrelates a fleet of workers hammering a recovering
  endpoint),
- **a per-call retry budget**: total sleep across attempts is bounded by
  ``budget_s`` so a stuck endpoint fails the call in bounded time
  instead of retrying forever,
- **retryable-error classification**: 5xx/429/timeouts/connection-resets
  retry; other 4xx (permanent: bad key, no auth) fail immediately,
- **Retry-After honoring**: a 429/503 carrying ``Retry-After: N`` floors
  the computed backoff at ``min(N, cap)`` (the serving front-end emits
  exactly this header — ``serve/server.py``).

Deterministic injection/testing: pass ``rng=random.Random(seed)`` and/or
``sleep=`` to make schedules reproducible without real waiting.
"""

from __future__ import annotations

import errno
import http.client
import os
import random
import socket
import time
import urllib.error
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

from sparknet_tpu_torch import obs

T = TypeVar("T")

# OS-level errno values that mean "the far side hiccuped", not "you asked
# for something that does not exist"
_RETRYABLE_ERRNOS = frozenset(
    {
        errno.ECONNRESET,
        errno.ECONNREFUSED,
        errno.ECONNABORTED,
        errno.ETIMEDOUT,
        errno.EPIPE,
        errno.ENETUNREACH,
        errno.EHOSTUNREACH,
        errno.EAGAIN,
    }
)

# HTTP statuses worth retrying: throttling + anything server-side
_RETRYABLE_HTTP = frozenset({408, 429, 500, 502, 503, 504})


class RetryBudgetExceeded(OSError):
    """All attempts (or the sleep budget) exhausted; ``__cause__`` is the
    last underlying error.  Subclasses ``OSError`` so callers with
    ordinary I/O-error handling (``except OSError``) treat exhaustion as
    the I/O failure it is — e.g. ``HTTPStore.list``'s index.txt ->
    auto-index fallback keeps working when the index fetch exhausts its
    budget rather than failing on the first attempt."""


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule knobs.  ``SPARKNET_RETRY_ATTEMPTS`` /
    ``SPARKNET_RETRY_BUDGET_S`` override the defaults process-wide (ops
    escape hatch; tests pass explicit policies)."""

    max_attempts: int = 5
    base_s: float = 0.05
    cap_s: float = 5.0
    budget_s: float = 30.0

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            max_attempts=int(os.environ.get("SPARKNET_RETRY_ATTEMPTS", "5")),
            budget_s=float(os.environ.get("SPARKNET_RETRY_BUDGET_S", "30")),
        )


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """Seconds from a ``Retry-After`` header, if the error carries one
    (numeric form only; HTTP-date is rare and not worth stdlib date
    parsing here)."""
    headers = getattr(exc, "headers", None)
    if headers is None:
        return None
    try:
        val = headers.get("Retry-After")
    except AttributeError:
        return None
    if val is None:
        return None
    try:
        return max(0.0, float(val))
    except ValueError:
        return None


def is_retryable(exc: BaseException) -> bool:
    """Transient vs permanent classification.

    Retryable: 5xx/429/408 HTTP statuses, socket timeouts, connection
    resets/refusals, remote disconnects, truncated reads, and URLErrors
    whose underlying reason is one of those.  NOT retryable: other 4xx
    (permanent client errors — retrying a 404 just burns the budget) and
    non-network OSErrors (ENOENT and friends)."""
    # HTTPError first: it subclasses URLError AND OSError
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in _RETRYABLE_HTTP or exc.code >= 500
    if isinstance(exc, urllib.error.URLError):
        reason = exc.reason
        if isinstance(reason, BaseException):
            return is_retryable(reason)
        return True  # bare-string reason: DNS hiccups etc — assume transient
    if isinstance(exc, (socket.timeout, TimeoutError)):
        return True
    if isinstance(exc, socket.gaierror):
        # DNS: EAI_AGAIN ("temporary failure in name resolution") is the
        # transient one; NXDOMAIN and friends are permanent
        return exc.errno in (
            socket.EAI_AGAIN,
            getattr(socket, "EAI_NODATA", socket.EAI_AGAIN),
        )
    if isinstance(exc, ConnectionError):  # reset/refused/aborted
        return True
    if isinstance(
        exc,
        (
            http.client.RemoteDisconnected,
            http.client.IncompleteRead,
            http.client.BadStatusLine,
        ),
    ):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _RETRYABLE_ERRNOS
    return False


def backoff_s(
    attempt: int, policy: RetryPolicy, rng: random.Random
) -> float:
    """Full-jitter delay before retry number ``attempt`` (0-based)."""
    return rng.uniform(0.0, min(policy.cap_s, policy.base_s * (2.0 ** attempt)))


def retry_call(
    fn: Callable[[], T],
    policy: Optional[RetryPolicy] = None,
    retryable: Callable[[BaseException], bool] = is_retryable,
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn()`` with the policy's backoff schedule.

    Non-retryable errors propagate immediately.  Retryable errors retry
    until success, ``max_attempts`` calls, or the cumulative sleep budget
    runs out — then raise ``RetryBudgetExceeded`` from the last error.
    ``on_retry(exc, attempt, delay_s)`` observes each scheduled retry
    (logging / chaos-harness bookkeeping)."""
    policy = policy or RetryPolicy.from_env()
    rng = rng or random.Random()
    slept = 0.0
    attempts = 0
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            attempts += 1
            if not retryable(e):
                raise
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            delay = backoff_s(attempt, policy, rng)
            hint = retry_after_hint(e)
            if hint is not None:
                delay = max(delay, min(hint, policy.cap_s))
            if slept + delay > policy.budget_s:
                break
            # telemetry: every scheduled retry ticks the counter and
            # tags the trace (no-ops when obs is off); the caller's
            # on_retry still observes afterwards, unchanged
            tm = obs.training_metrics()
            if tm is not None:
                tm.retries.inc()
            obs.instant(
                "retry", cat="io", attempt=attempt,
                delay_ms=round(delay * 1e3, 2), error=type(e).__name__,
            )
            if on_retry is not None:
                on_retry(e, attempt, delay)
            slept += delay
            sleep(delay)
    raise RetryBudgetExceeded(
        f"gave up after {attempts} of {policy.max_attempts} allowed "
        f"attempts ({slept:.2f}s of {policy.budget_s:.0f}s budget slept)"
    ) from last
