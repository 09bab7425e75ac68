"""The fault-tolerance surface of an averaging app's round loop.

One object per run bundles what the JAX package's apps wire by hand
around each round: the divergence sentry (``--health``, built before
the trainer, whose audit it turns on), the two-tier spec (``--slices``,
``--cross_slice_every``), the elastic membership controller
(``--elastic``, in the apps that wire it), the run journal
(``--journal``; under ``--stale_bound`` each intent and commit carries
the trainer's ``worker_rounds``), the flight recorder
(``--flight_recorder``) and the round profiler (``--profile``,
``--profile_out``: its summary prints and is written at ``close``).
The loop calls ``begin`` (the write-ahead intent), ``boundary`` (membership
views and readmission, the round's live mask), ``round`` (the trainer's
round, under the sentry when there is one) and ``commit``, inside
``signals()`` (the SIGTERM preemption hooks), and ``close`` at the end.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional


class RoundGuards:
    """Build with ``from_args``; every part is None when its flag is
    off."""

    def __init__(self, trainer, sentry=None, spec=None, membership=None,
                 auto_rejoin=None, journal=None, recorder=None, log=None,
                 profiler=None, profile_out=None):
        self.trainer = trainer
        self.profiler = profiler
        self.profile_out = profile_out
        self.profile_summary = None
        self.sentry = sentry
        self.spec = spec
        self.membership = membership
        self.auto_rejoin = auto_rejoin
        self.journal = journal
        self.recorder = recorder
        self._log = log

    @classmethod
    def from_args(cls, args, solver, n_workers: int, *, app: str, log,
                  metrics, journal_path: Optional[str], resuming: bool = False,
                  wire_membership: bool = True,
                  restore_prefix: Optional[str] = None,
                  mesh=None) -> "RoundGuards":
        """The sentry (restoring from ``restore_prefix`` on rollback; none
        degrades rollback to halt), the spec, the trainer, the membership
        controller (``wire_membership``; otherwise ``--elastic`` only
        logs, as the JAX app does), the journal at ``journal_path`` and
        the flight recorder.  ``mesh`` (``parallel/mesh.py``) places the
        workers over processes (the trainer's ``mesh``)."""
        from sparknet_tpu_torch import obs
        from sparknet_tpu_torch.io import journal as journal_mod
        from sparknet_tpu_torch.obs import health
        from sparknet_tpu_torch.parallel import hierarchy

        obs.check_args(args, app)
        sentry = health.sentry_from_args(args, solver, echo=log.log,
                                         metrics=metrics)
        spec = hierarchy.spec_from_args(args, n_workers)
        extra = {} if mesh is None else {"mesh": mesh}
        trainer = hierarchy.averaging_trainer_from_args(
            args, solver, n_workers, hierarchy=spec, metrics=metrics, **extra)
        if sentry is not None and restore_prefix:
            sentry.restore_fn = health.make_restore_fn(
                solver, restore_prefix, trainer=trainer, metrics=metrics)
        membership = auto_rejoin = None
        if getattr(args, "elastic", False):
            if wire_membership:
                from sparknet_tpu_torch.runtime import membership as mm

                membership = mm.MembershipController(
                    spec if spec is not None
                    else hierarchy.HierarchySpec.flat(n_workers),
                    echo=log.log, metrics=metrics)
                # a SIGTERM marks this process's slice leaving
                my_slice = int(os.environ.get(
                    "SPARKNET_SLICE_ID", membership.spec.num_slices - 1))
                membership.sigterm_marks(my_slice)
                auto_rejoin = mm.AutoRejoin(membership, args.rejoin_after)
                obs.set_membership(membership)
            else:
                log.log("--elastic: the membership controller is wired in "
                        "cifar_app and lm_app (this app applies the "
                        "--slices/--cross_slice_every schedule)")
        jr = (journal_mod.journal_from_args(args, journal_path,
                                            resuming=resuming, metrics=metrics)
              if journal_path else None)
        if jr is not None:
            log.log(f"run journal: {jr.path} (fsync={jr.fsync})")
        recorder = obs.flight_from_args(args, metrics=metrics)
        profiler = obs.profile_from_args(args, echo=log.log)
        return cls(trainer, sentry, spec, membership, auto_rejoin, jr,
                   recorder, log, profiler, getattr(args, "profile_out", None))

    # ------------------------------------------------------------------
    def signals(self):
        """The SIGTERM handler that delivers preemption notices to the
        membership hook (no handler without a controller)."""
        if self.membership is None:
            return contextlib.nullcontext()
        from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction

        return SignalHandler(sigint_effect=SolverAction.NONE,
                             sighup_effect=SolverAction.NONE,
                             sigterm_hooks=True)

    def view_epoch(self) -> int:
        return self.membership.view.epoch if self.membership is not None else 0

    def _stale_meta(self) -> dict:
        """A bounded-staleness trainer's worker-round vector (versioned
        into every journal record), else nothing."""
        if getattr(self.trainer, "stale_bound", 0) > 0:
            return {"worker_rounds": [int(v) for v in self.trainer.worker_rounds],
                    "stale_bound": self.trainer.stale_bound}
        return {}

    def begin(self, r: int, **meta) -> None:
        """Round ``r``'s write-ahead intent (with the view epoch)."""
        if self.journal is not None:
            self.journal.begin_round(r, view_epoch=self.view_epoch(),
                                     **self._stale_meta(), **meta)

    def boundary(self, state, r: int):
        """Apply the membership events at round ``r``'s boundary and
        readmit pending joiners from the survivor consensus; returns
        ``(state, live mask or None)``."""
        if self.membership is None:
            return state, None
        from sparknet_tpu_torch.runtime import membership as mm

        self.membership.advance(r)
        self.auto_rejoin.on_round(r)
        if self.membership.pending_joiners():
            state, _ = mm.readmit_from_survivors(
                self.trainer, state, self.membership, r,
                echo=None if self._log is None else self._log.log)
        return state, self.membership.live_mask()

    def round(self, state, batches, mask, r: int):
        """``(state, losses)`` of one round, under the sentry when on."""
        if self.sentry is not None:
            return self.sentry.guarded_round(self.trainer, state, batches,
                                             live_mask=mask, round_index=r)
        return self.trainer.round(state, batches, live_mask=mask,
                                  round_index=r)

    def commit(self, r: int, **meta) -> None:
        """Round ``r``'s commit (with the folded worker-round vector)."""
        if self.journal is not None:
            self.journal.commit_round(r, **self._stale_meta(), **meta)

    def job_extra(self) -> dict:
        """The sentry's and the membership's jobstate sections."""
        extra = {}
        if self.sentry is not None:
            extra["sentry"] = self.sentry.export_state()
        if self.membership is not None:
            extra["membership"] = self.membership.export_state()
        return extra

    def restore_job(self, js) -> None:
        """Put back ``job_extra``'s sections from a restored jobstate."""
        if not js:
            return
        if self.sentry is not None and "sentry" in js:
            self.sentry.load_state(js["sentry"])
        if self.membership is not None and "membership" in js:
            # the epoch clock continues, never rewinds
            self.membership.load_state(js["membership"])

    def close(self) -> None:
        from sparknet_tpu_torch import obs
        from sparknet_tpu_torch.obs import flight

        if self.membership is not None:
            self.membership.detach()
            obs.set_membership(None)
        if self.sentry is not None:
            obs.set_sentry(None)
        if self.journal is not None:
            self.journal.close()
        if self.recorder is not None:
            flight.uninstall(self.recorder)
        if self.profiler is not None:
            self.profile_summary = obs.close_profile(
                self.profiler, self.profile_out,
                echo=None if self._log is None else self._log.log)
            self.profiler = None
