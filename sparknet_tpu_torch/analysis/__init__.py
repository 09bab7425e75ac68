"""Framework-aware static analysis: the port's hot-path invariant linter.

The port of ``sparknet_tpu/analysis``.  The overlap the port is built
on — round r+1's batch copied on a side stream while round r trains,
the comm plane's chunks paced on their own thread — rests on invariants
no runtime test names when they break: no implicit host<->device syncs
in steady-state rounds, no write into a buffer the card is still
reading, disciplined threading across the modules that spawn
producer/comm/watchdog/server threads, and emitter/folder agreement on
every metric and span name.  This package enforces them statically —
each checker is a small AST visitor emitting the shared
:class:`findings.Finding` shape — and ``python -m
sparknet_tpu_torch.tools.lint --check`` runs the set against a
committed allowlist as a tier-1 guard.  The dynamic half is
``chip_smoke.py`` phase 23: steady rounds under
``torch.cuda.set_sync_debug_mode("warn")``, every synchronizing call
held to an annotated site (``sanitize``).

Checkers
--------
- ``sync_check``     — sync-in-hot-path: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``float()``/``int()``/
  ``bool()`` on non-shape values, ``np.asarray``/``np.array``,
  ``synchronize()``, ``nonzero``, a pageable H2D ``torch.tensor(...,
  device=)`` inside the registered round-loop/producer/comm scopes
  (``hotpaths.HOT_PATHS``) and inside any function spawned as a thread
  target.
- ``donation_check`` — the counterpart of donation discipline: a buffer
  handed to a ``non_blocking`` copy (or a known async producer) and
  written again before a synchronize or stream/event wait.
- ``thread_check``   — thread hygiene: anonymous threads, implicit
  daemon policy, un-timeouted ``join()`` outside shutdown paths, bare
  or swallowed ``except`` in thread targets, and a cross-module lock
  acquisition-order graph with cycle detection.
- ``registry_audit`` — trace/metrics registry drift: every emitted
  ``sparknet_*`` metric name and phase-cat ``span(...)`` literal must
  appear in the canonical sets (``analysis.registry``) and in the
  PERF.md telemetry reference, and vice versa.

Suppression marker grammar: an inline ``# sparknet: <rule>-ok(<reason>)``
comment on any line of the flagged statement suppresses that checker's
finding there — ``sync-ok``, ``donation-ok``, ``thread-ok``,
``join-ok``, ``except-ok``, ``lock-ok``.  The reason is mandatory; an
empty one is itself a finding.  Suppressed sites stay enumerable
(``Report.suppressed``, ``lint --show-suppressed``): the sanitizer holds
each sync the card reports to one of them.
"""

from sparknet_tpu_torch.analysis.findings import Finding, Report  # noqa: F401
from sparknet_tpu_torch.analysis.runner import (  # noqa: F401
    scan_package,
    scan_source,
)
