"""Signal-driven stop/snapshot: the poll-a-flag discipline.

The port's own copy of ``sparknet_tpu/utils/signals.py`` (reference:
``caffe/src/caffe/util/signal_handler.cpp:9-60``, the solver's
per-iteration action poll, ``solver.cpp:267-280``, and the CLI flags
``--sigint_effect/--sighup_effect``, tools/caffe.cpp:43-46).  Handlers
only set flags; the training loop polls between rounds.  ``cli train``
polls for STOP and SNAPSHOT, the serving front end
(``serve/server.py``) stops on SIGTERM and drains.  A SIGTERM also
dumps the flight recorder's bundle (``obs/flight.py``, when one is
installed) and calls the SIGTERM hooks: the orchestrator's preemption
notice, which the elastic membership controller
(``runtime/membership.py``) subscribes to without the process acting on
it.
"""

from __future__ import annotations

import enum
import signal
from typing import Callable, List


class SolverAction(enum.Enum):
    NONE = 0
    STOP = 1
    SNAPSHOT = 2


# SIGTERM preemption hooks, fired from any installed SignalHandler's
# SIGTERM path; they must be signal-safe (set a flag, append to a list:
# no locks, no I/O).  A SignalHandler built with ``sigterm_hooks=True``
# installs its SIGTERM handler for these callbacks alone.
_sigterm_hooks: List[Callable[[], None]] = []


def add_sigterm_hook(fn: Callable[[], None]) -> Callable[[], None]:
    """Subscribe ``fn`` to SIGTERM deliveries; returns ``fn``."""
    _sigterm_hooks.append(fn)
    return fn


def remove_sigterm_hook(fn: Callable[[], None]) -> None:
    """Unsubscribe (a hook already removed is a no-op)."""
    try:
        _sigterm_hooks.remove(fn)
    except ValueError:
        pass


class SignalHandler:
    """Installs a handler for each signal whose effect is not NONE (and
    for SIGTERM with ``sigterm_hooks``).  Use as a context manager so the
    previous handlers come back on any exit."""

    def __init__(
        self,
        sigint_effect: SolverAction = SolverAction.STOP,
        sighup_effect: SolverAction = SolverAction.SNAPSHOT,
        sigterm_effect: SolverAction = SolverAction.NONE,
        sigterm_hooks: bool = False,
    ):
        self._effects = {}
        self._flags = {SolverAction.STOP: False, SolverAction.SNAPSHOT: False}
        self._prev = {}
        for sig, effect in (
            (signal.SIGINT, sigint_effect),
            (signal.SIGHUP, sighup_effect),
            (signal.SIGTERM, sigterm_effect),
        ):
            if effect != SolverAction.NONE or (
                    sig == signal.SIGTERM and sigterm_hooks):
                if effect != SolverAction.NONE:
                    self._effects[sig] = effect
                self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        effect = self._effects.get(signum)
        if effect is not None:
            self._flags[effect] = True
        if signum == signal.SIGTERM:
            from sparknet_tpu_torch.obs import flight as _flight

            _flight.dump_if_active("signal_SIGTERM")
            # each hook guarded: a bad subscriber must not break the
            # handler's stop/snapshot contract
            for fn in list(_sigterm_hooks):
                try:
                    fn()
                except Exception:  # noqa: BLE001 — signal context
                    pass

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
