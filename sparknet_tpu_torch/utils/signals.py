"""Signal-driven stop: the poll-a-flag discipline of the serving front end.

The port's own copy of ``sparknet_tpu/utils/signals.py``, cut to what
``serve/server.py`` uses: handlers only set a flag, and the serve loop
polls it (SIGTERM is the orchestrator's shutdown signal, and the server
drains on it).  The flight-recorder dump and the preemption hooks of
the JAX package belong to the training slices and are not here.
"""

from __future__ import annotations

import enum
import signal


class SolverAction(enum.Enum):
    NONE = 0
    STOP = 1
    SNAPSHOT = 2


class SignalHandler:
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
