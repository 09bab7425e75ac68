"""The journaled driver loop: crash-consistent training, provable.

The port of ``sparknet_tpu/runtime/recover.py``.  ``run_driver`` is a
small cifar10_quick parameter-averaging loop (W=2, tau=2, batch 8, int8
delta averaging, the audit on) wired as a crash-consistent driver must
be:

- every round is bracketed by a write-ahead **intent** and a durable
  **commit** in the run journal (``io/journal.RunJournal``),
- every committed boundary snapshots the full job state: params and
  history, every worker's momentum, the comm plane's error-feedback
  residuals, the sentry's EMA and cooldown, the membership view and the
  data cursor (``io/checkpoint.snapshot(extra_state=...)``),
- a resume reconciles ledger and snapshots
  (``checkpoint.restore_newest_valid_journaled``): it rewinds to the
  last committed boundary, re-executes the one in-flight round and
  never a committed one.

``--kill_at PHASE:ROUND`` kills the process at a named point —

    assemble            after the round's host batch is built
    h2d                 after the batch is copied to the device
    execute             after the round (local steps + average) returns
    average             after the sentry consumed the round's stats
    snapshot_mid_write  the solverstate's temporary file written, its
                        publish rename not yet done
    journal_mid_append  half the commit record written (a torn tail)
    stale_boundary      (--stale_bound > 0) after the stale boundary
                        folded its arrivals, before the snapshot and the
                        commit of the advanced worker-round vector

— and a resumed run's ``state_digest`` (params, stats, history, iter,
EF residuals, sentry EMA, the worker-round ledger) equals an
uninterrupted control's.  With ``--no_journal`` a resume takes the plain
newest snapshot and resets the residuals and the sentry, so its digest
differs.

``--stale_bound B`` runs the bounded-staleness leg
(``parallel/stale.py``, no compression): the last worker never arrives
by itself, so each boundary's arrival set is a pure function of the
journaled ``worker_rounds`` (the bound forces the straggler in every
B-th boundary); every intent and commit record carries the vector, each
worker trains on the window of its own next round (``stale_window``)
and the snapshots carry every worker's replica.

    python -m sparknet_tpu_torch.runtime.recover --workdir D --rounds 4 \\
        [--kill_at execute:2] [--resume] [--no_journal] [--stale_bound 2] \\
        [--device cpu]

prints one JSON line.  ``RecoverContext`` and ``run_driver(kill=<a
raiser>)`` are the in-process pieces.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal as _signal
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

KILL_POINTS = (
    "assemble",
    "h2d",
    "execute",
    "average",
    "snapshot_mid_write",
    "journal_mid_append",
    # bounded-staleness runs only (--stale_bound > 0): the arrival set
    # folded and the ledger advanced in memory, neither the snapshot nor
    # the commit landed; a resume replays from the journaled vector
    "stale_boundary",
)


class SimulatedKill(BaseException):
    """The in-process stand-in for SIGKILL, raised by a kill hook: a
    BaseException, so no ``except Exception`` absorbs it."""


def sigkill_self() -> None:
    os.kill(os.getpid(), _signal.SIGKILL)


def parse_kill_at(value: Optional[str]) -> Tuple[Optional[str], int]:
    if not value:
        return None, -1
    phase, _, r = value.partition(":")
    if phase not in KILL_POINTS:
        raise ValueError(f"kill_at phase {phase!r}: expected one of {KILL_POINTS}")
    return phase, int(r or 0)


class RecoverContext:
    """Data, solver (audit on) and trainer (int8 delta averaging, so real
    error-feedback state is carried; with ``stale_bound`` > 0 the
    bounded-staleness trainer, uncompressed), built once and reused
    across control, crash and resume runs."""

    def __init__(self, workdir: str, workers: int = 2, tau: int = 2,
                 batch: int = 8, seed: int = 7, compress: str = "int8",
                 stale_bound: int = 0, device=None, metrics=None):
        from sparknet_tpu_torch import config as cfg, models
        from sparknet_tpu_torch.data import CifarLoader
        from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
        from sparknet_tpu_torch.parallel.stale import BoundedStalenessTrainer
        from sparknet_tpu_torch.solver import Solver

        self.workdir = workdir
        self.workers = workers
        self.tau = tau
        self.batch = batch
        self.seed = seed
        self.stale_bound = int(stale_bound)
        if self.stale_bound > 0:
            # stale boundaries do not compose with the comm plane's
            # residuals: the stale leg carries the ledger and replicas
            compress = "none"
        self.compress = compress
        self.metrics = metrics
        os.makedirs(workdir, exist_ok=True)
        data_dir = os.path.join(workdir, "data")
        if not os.path.isdir(data_dir):
            CifarLoader.write_synthetic(data_dir, num_train=256, num_test=32,
                                        seed=seed)
        self.xs, self.ys = CifarLoader(data_dir).minibatches(batch, train=True)
        netp = cfg.replace_data_layers(
            models.load_model("cifar10_quick"),
            [(batch, 3, 32, 32), (batch,)], [(batch, 3, 32, 32), (batch,)],
        )
        # audit on: the journaled sentry EMA is real state
        self.solver = Solver(models.load_model_solver("cifar10_quick"),
                             net_param=netp, audit=True, device=device)
        self.device = self.solver.device
        if self.stale_bound > 0:
            self.trainer = BoundedStalenessTrainer(
                self.solver, workers, stale_bound=self.stale_bound,
                metrics=metrics)
            # the deterministic straggler: the last worker never arrives
            # by itself, so every boundary's arrival set is a function of
            # the journaled worker-round vector
            self.straggler = workers - 1
        else:
            self.trainer = ParameterAveragingTrainer(
                self.solver, workers, compress=compress, metrics=metrics)
            self.straggler = None
        self.prefix = os.path.join(workdir, "recover_ckpt")

    def batch_for(self, r: int) -> Dict[str, np.ndarray]:
        """Round ``r``'s host batch, a pure function of the absolute
        round (a resume re-derives the same draw)."""
        W, tau, B, n = self.workers, self.tau, self.batch, len(self.xs)
        data = np.empty((W, tau) + self.xs[0].shape, np.float32)
        label = np.empty((W, tau, B), np.float32)
        for w in range(W):
            for t in range(tau):
                i = (r * W * tau + w * tau + t) % n
                data[w, t] = self.xs[i]
                label[w, t] = self.ys[i]
        return {"data": data, "label": label}

    def make_sentry(self):
        from sparknet_tpu_torch.obs.health import HealthSentry

        return HealthSentry(policy="warn", metrics=self.metrics)

    def arrival_for(self) -> np.ndarray:
        """The boundary's self-arrival set (the same every round: the
        straggler folds in when the bound forces it)."""
        arr = np.ones((self.workers,), bool)
        if self.straggler is not None:
            arr[self.straggler] = False
        return arr


def state_digest(state, comm_state=None, sentry_state=None,
                 stale_state=None) -> str:
    """sha256 over the full job state: every TrainState leaf (params,
    stats, history, iter), the EF residuals, the sentry's EMA scalars and
    (stale runs) the worker-round ledger.  Equal digests == bit-identical
    runs."""
    from sparknet_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(tuple(state)):
        arr = leaf.detach().cpu().numpy()
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    if comm_state is not None:
        resid = comm_state["resid"]
        for i in range(len(resid)):
            h.update(np.asarray(resid[str(i)]).tobytes())
    if sentry_state is not None:
        h.update(json.dumps({k: sentry_state.get(k)
                             for k in ("ema", "emvar", "seen", "cooldown")},
                            sort_keys=True).encode())
    if stale_state is not None:
        h.update(json.dumps({
            "boundary": int(np.asarray(stale_state["boundary"])),
            "worker_rounds": [int(v) for v in np.asarray(
                stale_state["worker_rounds"]).reshape(-1)],
        }, sort_keys=True).encode())
    return h.hexdigest()


def run_driver(ctx: RecoverContext, rounds: int, *, journal: bool = True,
               resume: bool = False,
               kill_at: Optional[Tuple[Optional[str], int]] = None,
               kill: Optional[Callable[[], None]] = None,
               fsync: str = "commit", run_dir: Optional[str] = None) -> Dict:
    """One driver invocation (fresh or ``resume``); returns the run
    record.  ``kill_at=(phase, round)`` arms the kill (``kill`` defaults
    to a real SIGKILL); ``run_dir`` holds this leg's snapshots and
    ledger (in-process harnesses run legs in separate directories off
    one context)."""
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.io.journal import RunJournal, default_journal_path
    from sparknet_tpu_torch.parallel import (
        export_worker_history,
        first_worker,
        restore_worker_history,
    )
    from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
    from sparknet_tpu_torch.parallel.stale import (
        export_worker_replicas,
        restore_worker_replicas,
        stale_window,
    )
    from sparknet_tpu_torch.runtime import membership as membership_mod

    kill = kill or sigkill_self
    kp, kr = kill_at or (None, -1)
    stale = ctx.stale_bound > 0
    if kp == "stale_boundary" and not stale:
        raise ValueError("kill_at stale_boundary needs a --stale_bound > 0 "
                         "context")

    def maybe_kill(phase: str, r: int) -> None:
        if kp == phase and r == kr:
            kill()

    trainer, metrics = ctx.trainer, ctx.metrics
    prefix = ctx.prefix
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        prefix = os.path.join(run_dir, "recover_ckpt")
    jr = (RunJournal(default_journal_path(prefix), fsync=fsync, metrics=metrics)
          if journal else None)
    sentry = ctx.make_sentry()
    # a flat membership controller rides along so the view epoch is real
    # journaled state (flat spec, all live: no effect on the math)
    membership = membership_mod.MembershipController(
        HierarchySpec.flat(ctx.workers))

    start_round = 0
    restore_s = resumed_from = info = None
    try:
        state = None
        if resume:
            t0 = time.perf_counter()
            st = js = None
            if jr is not None:
                try:
                    st, used, js, info = checkpoint.restore_newest_valid_journaled(
                        ctx.solver, prefix, jr, metrics=metrics)
                except FileNotFoundError:
                    info = jr.reconcile()  # round 0 never committed
                start_round = info["resume_round"]
                if info["in_flight_round"] is not None and metrics is not None:
                    metrics.recover_replayed.inc()
            else:
                try:
                    st, used = checkpoint.restore_newest_valid(
                        ctx.solver, prefix, metrics=metrics)
                    start_round = int(st.iter) // ctx.tau
                except FileNotFoundError:
                    pass
            if st is not None:
                resumed_from = os.path.basename(used)
                state = trainer.broadcast_state(st)  # resets the plane
                if js:
                    if "comm" in js:
                        trainer.restore_comm_state(js["comm"])
                    if "sentry" in js:
                        sentry.load_state(js["sentry"])
                    if "membership" in js:
                        membership.load_state(js["membership"])
                    if "workers" in js:
                        # every worker's momentum (the consensus snapshot
                        # carries worker 0's)
                        state = restore_worker_history(state, js["workers"])
                    if stale and "stale" in js:
                        # stale replicas diverge between boundaries: the
                        # full per-worker stacks replace the consensus,
                        # and the ledger resumes where it was
                        state = restore_worker_replicas(
                            state, js["stale"]["replicas"])
                        trainer.load_stale_state(js["stale"]["ledger"])
            restore_s = time.perf_counter() - t0
        if state is None:
            trainer.reset_comm_state()
            if stale:
                trainer.reset_stale_state()
            state = trainer.init_state(seed=ctx.seed)

        rounds_executed: List[int] = []
        round_ms: List[float] = []
        losses = None
        for r in range(start_round, rounds):
            t_r = time.perf_counter()
            view = membership.advance(r)
            meta = {}
            if stale:
                # the journal versions every worker's round vector: the
                # intent what each was about to fold, the commit what it
                # folded
                meta = {"worker_rounds": [int(v) for v in trainer.worker_rounds],
                        "stale_bound": ctx.stale_bound}
            if jr is not None:
                # the write-ahead intent: what restart needs to know
                jr.begin_round(r, iter=r * ctx.tau, view_epoch=view.epoch,
                               cursor=r, rng="default_train_key(0)", **meta)
            if stale:
                # each worker trains on the window of its own next round
                host = stale_window(ctx.batch_for, trainer.worker_rounds)
            else:
                host = ctx.batch_for(r)
            maybe_kill("assemble", r)
            placed = {k: torch.from_numpy(v).to(ctx.device)
                      for k, v in host.items()}
            maybe_kill("h2d", r)
            if stale:
                state, losses, stats = trainer.round(
                    state, placed, arrived=ctx.arrival_for(), round_index=r)
            else:
                state, losses, stats = trainer.round(state, placed,
                                                     round_index=r)
            rounds_executed.append(r)
            maybe_kill("execute", r)
            if stale:
                maybe_kill("stale_boundary", r)
                lb = trainer.last_boundary
                sentry.observe(r, losses, stats, arrived=lb["arrived"],
                               worker_rounds=[lb["boundary"] - l
                                              for l in lb["lag"]])
            else:
                sentry.observe(r, losses, stats)
            maybe_kill("average", r)
            # the durable boundary: the full job state beside params,
            # then the commit record that references it
            extra = {
                "sentry": sentry.export_state(),
                "membership": membership.export_state(),
                "cursor": {"next_round": r + 1},
                "workers": export_worker_history(state),
            }
            comm_state = trainer.export_comm_state()
            if comm_state is not None:
                extra["comm"] = comm_state
            if stale:
                # the consensus snapshot under-determines a stale fleet
                extra["stale"] = {"ledger": trainer.export_stale_state(),
                                  "replicas": export_worker_replicas(state)}
            if kp == "snapshot_mid_write" and r == kr:
                # the kill lands with the solverstate's temporary file
                # written and unpublished: restore must never see it
                checkpoint.set_crash_hook(
                    lambda path: kill() if path.endswith(".solverstate.npz")
                    else None)
            try:
                _, state_path = checkpoint.snapshot(
                    ctx.solver, first_worker(state), prefix,
                    fmt="BINARYPROTO", extra_state=extra, metrics=metrics)
            finally:
                checkpoint.set_crash_hook(None)
            if jr is not None:
                if kp == "journal_mid_append" and r == kr:
                    jr.crash_hook = kill
                commit_meta = dict(meta)
                if stale:  # the post-fold vector the boundary owns
                    commit_meta["worker_rounds"] = [
                        int(v) for v in trainer.worker_rounds]
                jr.commit_round(r, iter=(r + 1) * ctx.tau,
                                snapshot=os.path.basename(state_path),
                                **commit_meta)
            round_ms.append((time.perf_counter() - t_r) * 1e3)

        final_comm = trainer.export_comm_state()
        final_sentry = sentry.export_state()
        final_stale = trainer.export_stale_state() if stale else None
        return {
            "rounds": rounds,
            "start_round": start_round,
            "rounds_executed": rounds_executed,
            "final_iter": int(state.iter.reshape(-1)[0]),
            "final_digest": state_digest(state, final_comm, final_sentry,
                                         final_stale),
            "final_loss": (float(losses.double().mean())
                           if losses is not None else None),
            "sentry_ema": final_sentry["ema"],
            "view_epoch": membership.view.epoch,
            "journal": journal,
            "journal_truncated_bytes": jr.truncated_bytes if jr is not None else 0,
            "resumed_from": resumed_from,
            "resume_info": info,
            "stale_bound": ctx.stale_bound,
            "worker_rounds": ([int(v) for v in trainer.worker_rounds]
                              if stale else None),
            "restore_s": round(restore_s, 4) if restore_s is not None else None,
            "round_ms": [round(m, 2) for m in round_ms],
        }
    finally:
        if jr is not None:
            jr.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.runtime.recover",
                                description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--tau", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--compress", default="int8")
    p.add_argument("--stale_bound", type=int, default=0,
                   help="run the bounded-staleness driver leg: the last "
                   "worker never arrives by itself (the bound forces it), "
                   "the journal versions the worker-round vector, snapshots "
                   "carry every worker's replica.  0 = the synchronous driver")
    p.add_argument("--kill_at", default=None, metavar="PHASE:ROUND",
                   help="SIGKILL self at this point of this round (points: "
                   f"{', '.join(KILL_POINTS)})")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no_journal", dest="journal", action="store_false",
                   default=True,
                   help="run without the ledger (the divergence control)")
    p.add_argument("--fsync", default="commit")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    args = p.parse_args(argv)
    kill_at = parse_kill_at(args.kill_at)
    from sparknet_tpu_torch.utils.devices import (
        deterministic_algorithms,
        resolve_device,
    )

    device = resolve_device(args.device)
    # a resumed run takes the algorithms the uninterrupted one took
    with deterministic_algorithms():
        ctx = RecoverContext(args.workdir, workers=args.workers, tau=args.tau,
                             batch=args.batch, seed=args.seed,
                             compress=args.compress,
                             stale_bound=args.stale_bound, device=device)
        rec = run_driver(ctx, args.rounds, journal=args.journal,
                         resume=args.resume, kill_at=kill_at, fsync=args.fsync)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
