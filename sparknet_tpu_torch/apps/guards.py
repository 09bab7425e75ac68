"""The fault-tolerance surface of an averaging app's round loop.

One object per run bundles what the JAX package's apps wire by hand
around each round: the divergence sentry (``--health``, built before
the trainer, whose audit it turns on), the two-tier spec (``--slices``,
``--cross_slice_every``), the elastic membership controller
(``--elastic``, in the apps that wire it), the run journal
(``--journal``; under ``--stale_bound`` each intent and commit carries
the trainer's ``worker_rounds``).  The run's telemetry (the flight
recorder, the round profiler, the sidecar, the trace, the SLO and fleet
planes) is ``obs.start_from_args``'s, which the app starts after these
guards and closes in its ``finally``.  The loop calls ``begin`` (the
write-ahead intent), ``boundary`` (membership views and readmission,
the round's live mask), ``round`` (the trainer's round, under the
sentry when there is one) and ``commit``, inside ``signals()`` (the
SIGTERM preemption hooks), and ``close`` at the end.

Across processes (a trainer over a mesh whose dp axis spans them) every
rank builds the same guards: the membership events are agreed over the
dp group at each boundary before the view advances (``MembershipController.
agree_events``), the journal has one writer, rank 0 (each JAX process
opens the same path; the port keeps one ledger a run and rank 0
decides a resume from it).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional


class RoundGuards:
    """Build with ``from_args``; every part is None when its flag is
    off."""

    def __init__(self, trainer, sentry=None, spec=None, membership=None,
                 auto_rejoin=None, journal=None, log=None):
        self.trainer = trainer
        self.sentry = sentry
        self.spec = spec
        self.membership = membership
        self.auto_rejoin = auto_rejoin
        self.journal = journal
        self._log = log

    @classmethod
    def from_args(cls, args, solver, n_workers: int, *, log,
                  metrics, journal_path: Optional[str], resuming: bool = False,
                  wire_membership: bool = True,
                  restore_prefix: Optional[str] = None,
                  mesh=None) -> "RoundGuards":
        """The sentry (restoring from ``restore_prefix`` on rollback; none
        degrades rollback to halt), the spec, the trainer, the membership
        controller (``wire_membership``; otherwise ``--elastic`` only
        logs, as the JAX app does) and the journal at ``journal_path``.
        ``mesh`` (``parallel/mesh.py``) places the workers over processes
        (the trainer's ``mesh``)."""
        from sparknet_tpu_torch import obs
        from sparknet_tpu_torch.io import journal as journal_mod
        from sparknet_tpu_torch.obs import health
        from sparknet_tpu_torch.parallel import hierarchy

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
        # across processes rank 0 alone keeps the ledger
        root = trainer.group is None or mesh.process_index == 0
        jr = (journal_mod.journal_from_args(args, journal_path,
                                            resuming=resuming, metrics=metrics)
              if journal_path and root else None)
        if jr is not None:
            log.log(f"run journal: {jr.path} (fsync={jr.fsync}"
                    + ("" if trainer.group is None else
                       f"; rank 0 writes it for all {mesh.process_count}")
                    + ")")
        return cls(trainer, sentry, spec, membership, auto_rejoin, jr, log)

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

        group = getattr(self.trainer, "group", None)
        # across processes a notice reached only some ranks: agree first
        events = (None if group is None
                  else self.membership.agree_events(group))
        self.membership.advance(r, events=events)
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

        if self.membership is not None:
            self.membership.detach()
            obs.set_membership(None)
        if self.sentry is not None:
            obs.set_sentry(None)
        if self.journal is not None:
            self.journal.close()
