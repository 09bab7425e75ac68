"""Signal-driven stop/snapshot: the poll-a-flag discipline.

The port's own copy of ``sparknet_tpu/utils/signals.py`` (reference:
``caffe/src/caffe/util/signal_handler.cpp:9-60``, the solver's
per-iteration action poll, ``solver.cpp:267-280``, and the CLI flags
``--sigint_effect/--sighup_effect``, tools/caffe.cpp:43-46).  Handlers
only set flags; the training loop polls between rounds.  ``cli train``
polls for STOP and SNAPSHOT, the serving front end
(``serve/server.py``) stops on SIGTERM and drains.  The JAX package's
SIGTERM hooks (for its membership and chaos runtimes) and its
flight-recorder dump are not ported.
"""

from __future__ import annotations

import enum
import signal


class SolverAction(enum.Enum):
    NONE = 0
    STOP = 1
    SNAPSHOT = 2


class SignalHandler:
    """Installs a handler for each signal whose effect is not NONE.  Use
    as a context manager so the previous handlers come back on any
    exit."""

    def __init__(
        self,
        sigint_effect: SolverAction = SolverAction.STOP,
        sighup_effect: SolverAction = SolverAction.SNAPSHOT,
        sigterm_effect: SolverAction = SolverAction.NONE,
    ):
        self._effects = {}
        self._flags = {SolverAction.STOP: False, SolverAction.SNAPSHOT: False}
        self._prev = {}
        for sig, effect in (
            (signal.SIGINT, sigint_effect),
            (signal.SIGHUP, sighup_effect),
            (signal.SIGTERM, sigterm_effect),
        ):
            if effect != SolverAction.NONE:
                self._effects[sig] = effect
                self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        effect = self._effects.get(signum)
        if effect is not None:
            self._flags[effect] = True

    def get_action(self) -> SolverAction:
        """Poll-and-clear, highest priority first (STOP beats SNAPSHOT)."""
        if self._flags[SolverAction.STOP]:
            self._flags[SolverAction.STOP] = False
            return SolverAction.STOP
        if self._flags[SolverAction.SNAPSHOT]:
            self._flags[SolverAction.SNAPSHOT] = False
            return SolverAction.SNAPSHOT
        return SolverAction.NONE

    def restore(self):
        """Reinstall the previous handlers.  Idempotent — a second call
        is a no-op, so it can never clobber handlers installed later."""
        prev, self._prev = self._prev, {}
        for sig, handler in prev.items():
            signal.signal(sig, handler)

    def __enter__(self) -> "SignalHandler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.restore()
