"""Elastic worker membership: train through a preempted slice.

The port of ``sparknet_tpu/runtime/membership.py``.  The W workers are
fixed when the trainer is built; the roster behind them is not.  One
``MembershipController`` per driver keeps an epoch-numbered
**membership view** that decides each round's live mask:

- **views advance only at round boundaries.**  Signals (a SIGTERM
  preemption notice, a fleet liveness verdict, an explicit join) queue
  *events*; ``advance(round)`` applies them at once and bumps the epoch
  once per changed view.  The trainer never sees a mid-round change.
- **worker states**: ``live -> leaving -> dead -> joining -> live``.  A
  preemption notice or a late heartbeat demotes to ``leaving``; a hard
  death, or ``leave_grace_rounds`` boundaries spent leaving, completes
  the departure to ``dead``.  A join on a ``dead`` worker makes it
  ``joining``; a join that arrives while it is still leaving waits for
  the leave to complete.  Only ``live`` workers carry mask weight.
- **readmission**: ``readmit`` (through a snapshot) or
  ``readmit_from_survivors`` merges catch-up params into the joining
  rows of the stacked state, zeroes their momentum, and ``admit()``
  flips them live at a new epoch.

Across processes every rank keeps its own controller, and a notice
reaches only some of them (a SIGTERM lands on the preempted slice's
processes alone).  So each rank drains its queued events at every round
boundary and the group agrees on them (``agree_events``: one
``mesh.agree_max`` over per-worker flags of each kind) before
``advance``: every rank then applies the same events, in a canonical
order (preempt, late, dead, join; one event a slice), and computes the
same view and epoch.  Readmission from the survivors takes the first
live worker's params from the rank that holds it (``broadcast``).

``metrics`` (a ``TrainingMetrics``) receives ``sparknet_membership_*``;
``obs.set_membership`` exports ``state_dict()``.  ``ingest_fleet_view``
turns a fleet collector's per-host verdicts into events (the collector,
``obs/fleet.py``, is not ported).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparknet_tpu_torch import obs as _obs
from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
from sparknet_tpu_torch.utils.tree import tree_map

LIVE = "live"
LEAVING = "leaving"
DEAD = "dead"
JOINING = "joining"
STATES = (LIVE, LEAVING, DEAD, JOINING)


class MembershipView:
    """One immutable epoch-numbered snapshot of the roster."""

    __slots__ = ("epoch", "round", "states", "spec")

    def __init__(self, epoch: int, round: int, states: Tuple[str, ...],
                 spec: HierarchySpec):
        self.epoch = epoch
        self.round = round
        self.states = states
        self.spec = spec

    def live_mask(self) -> np.ndarray:
        """The (W,) 0/1 mask the trainer consumes: LIVE workers only."""
        return np.asarray([1.0 if s == LIVE else 0.0 for s in self.states],
                          np.float32)

    def workers_in(self, state: str) -> Tuple[int, ...]:
        return tuple(w for w, s in enumerate(self.states) if s == state)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATES}
        for s in self.states:
            out[s] += 1
        return out

    def __repr__(self):
        return (f"MembershipView(epoch={self.epoch}, round={self.round}, "
                f"states={self.states})")


class MembershipController:
    """Maintains the roster; events may come from any thread or a signal
    handler, ``advance`` from the driver alone."""

    def __init__(self, spec: HierarchySpec, leave_grace_rounds: int = 1,
                 echo: Optional[Callable[[str], None]] = None, metrics=None):
        self.spec = spec
        self.num_workers = spec.num_workers
        self.leave_grace_rounds = max(0, int(leave_grace_rounds))
        self.metrics = metrics
        self._echo = echo
        self._lock = threading.Lock()
        self._states: List[str] = [LIVE] * self.num_workers
        self._epoch = 0
        self._round = -1
        self._leaving_since: Dict[int, int] = {}
        # (kind, workers), applied at the next advance()
        self._events: List[Tuple[str, Tuple[int, ...]]] = []
        self._deferred_joins: set = set()
        self._view = MembershipView(0, -1, tuple(self._states), spec)
        # (epoch, round, kind, workers) of every applied change
        self.transitions: List[Tuple[int, int, str, Tuple[int, ...]]] = []
        self._sigterm_hook = None
        self._host_boot_ids: Dict[str, Optional[str]] = {}
        self._publish_metrics()

    # --- event side: safe from signal handlers and other threads -------
    def _queue(self, kind: str, workers: Iterable[int]) -> None:
        ws = tuple(int(w) for w in workers)
        if not ws:
            return
        # lock-free on purpose: the SIGTERM hook runs in signal context
        # on the driver thread, which may hold self._lock in advance();
        # list.append is atomic and advance()'s swap-drain loses nothing
        self._events.append((kind, ws))

    def note_preempt(self, workers: Optional[Sequence[int]] = None,
                     slice_index: Optional[int] = None) -> None:
        """A preemption notice: the workers (or a whole slice) start
        LEAVING at the next round boundary."""
        if workers is None:
            if slice_index is None:
                raise ValueError("pass workers or slice_index")
            workers = self.spec.slices[slice_index]
        self._queue("preempt", workers)

    def note_late(self, workers: Sequence[int]) -> None:
        """A late heartbeat demotes to LEAVING, never straight to dead."""
        self._queue("late", workers)

    def note_dead(self, workers: Sequence[int]) -> None:
        """A hard death (missed deadline, process gone)."""
        self._queue("dead", workers)

    def note_join(self, workers: Sequence[int]) -> None:
        """A (re)join request, honored once the worker's leave has
        completed."""
        self._queue("join", workers)

    def sigterm_marks(self, slice_index: int):
        """Register a SIGTERM hook marking ``slice_index`` preempted; use
        inside ``SignalHandler(sigterm_hooks=True)``.  Returns the hook."""
        from sparknet_tpu_torch.utils import signals as _signals

        workers = self.spec.slices[slice_index]

        def hook():
            self.note_preempt(workers=workers)

        self._sigterm_hook = _signals.add_sigterm_hook(hook)
        return hook

    def detach(self) -> None:
        if self._sigterm_hook is not None:
            from sparknet_tpu_torch.utils import signals as _signals

            _signals.remove_sigterm_hook(self._sigterm_hook)
            self._sigterm_hook = None

    def ingest_fleet_view(self, view: Dict,
                          host_workers: Dict[str, Sequence[int]]) -> None:
        """Translate a fleet collector's ``fleet_view()`` into events: a
        ``late`` host's workers start leaving, a ``dead`` host's die, and
        a host seen live again after its workers departed (or whose
        ``boot_id`` changed: a restart) requests a rejoin."""
        hosts = view.get("hosts", {})
        for host, workers in host_workers.items():
            st = hosts.get(host)
            if st is None:
                continue
            hstate = st.get("state")
            boot = st.get("boot_id")
            prev_boot = self._host_boot_ids.get(host)
            restarted = (prev_boot is not None and boot is not None
                         and boot != prev_boot)
            self._host_boot_ids[host] = boot
            with self._lock:
                cur = {self._states[w] for w in workers}
            if hstate == "dead":
                self.note_dead(workers)
            elif hstate == "late":
                if LIVE in cur:
                    self.note_late(workers)
            elif hstate == "live":
                if restarted and LIVE in cur:
                    # restarted between polls while still marked live:
                    # the old state is gone, so walk leave -> rejoin
                    self.note_dead(workers)
                    self.note_join(workers)
                elif restarted or cur <= {DEAD, LEAVING, JOINING}:
                    if cur != {JOINING} and cur != {LIVE}:
                        self.note_join(workers)

    # --- driver side: round boundaries ----------------------------------
    @property
    def view(self) -> MembershipView:
        return self._view

    @property
    def epoch(self) -> int:
        return self._view.epoch

    def live_mask(self) -> np.ndarray:
        return self._view.live_mask()

    def pending_joiners(self) -> Tuple[int, ...]:
        return self._view.workers_in(JOINING)

    _KINDS = ("preempt", "late", "dead", "join")

    def agree_events(self, group=None) -> List[Tuple[str, Tuple[int, ...]]]:
        """Drain this rank's queued events and agree them over ``group``
        (every rank of it calls this at the same boundary): a worker
        flagged for a kind on any rank is flagged on all.  Returns the
        events every rank passes to ``advance``, one a slice for each
        kind, in ``_KINDS`` order.  An event queued after the drain (a
        signal mid-call) waits for the next boundary."""
        from sparknet_tpu_torch.parallel import mesh as _mesh

        events, self._events = self._events, []
        W = self.num_workers
        flags = np.zeros((len(self._KINDS), W), np.int64)
        for kind, ws in events:
            flags[self._KINDS.index(kind), list(ws)] = 1
        agreed = np.asarray(_mesh.agree_max(flags.reshape(-1).tolist(), group),
                            np.int64).reshape(flags.shape)
        out = []
        for k, kind in enumerate(self._KINDS):
            for members in self.spec.slices:
                ws = tuple(w for w in members if agreed[k, w])
                if ws:
                    out.append((kind, ws))
        return out

    def advance(self, round_index: int,
                events: Optional[Sequence[Tuple[str, Tuple[int, ...]]]] = None
                ) -> MembershipView:
        """Apply every queued event (or ``events``, the boundary's agreed
        ones across processes, ``agree_events``) at this boundary; bump
        the epoch once if anything changed.  Demotions, deaths and
        leave-completions first, then joins, for workers already dead
        BEFORE this boundary only (a join racing its own leave waits a
        boundary)."""
        with self._lock:
            if events is None:
                events, self._events = self._events, []
            events = list(events)
            dead_before = {w for w, s in enumerate(self._states) if s == DEAD}
            changed: List[Tuple[str, Tuple[int, ...]]] = []

            def move(w: int, to: str) -> bool:
                if self._states[w] == to:
                    return False
                self._states[w] = to
                return True

            for kind, ws in events:
                if kind in ("preempt", "late"):
                    moved = tuple(w for w in ws if self._states[w] == LIVE
                                  and move(w, LEAVING))
                    for w in moved:
                        self._leaving_since[w] = round_index
                    if moved:
                        changed.append(("leave" if kind == "preempt" else "late",
                                        moved))
                elif kind == "dead":
                    moved = tuple(w for w in ws
                                  if self._states[w] in (LIVE, LEAVING)
                                  and move(w, DEAD))
                    for w in moved:
                        self._leaving_since.pop(w, None)
                    if moved:
                        changed.append(("death", moved))
                elif kind == "join":
                    self._deferred_joins.update(int(w) for w in ws)

            expired = tuple(
                w for w, since in list(self._leaving_since.items())
                if self._states[w] == LEAVING
                and round_index - since >= self.leave_grace_rounds
            )
            for w in expired:
                move(w, DEAD)
                self._leaving_since.pop(w, None)
            if expired:
                changed.append(("death", expired))

            ready = tuple(w for w in sorted(self._deferred_joins)
                          if w in dead_before and self._states[w] == DEAD)
            for w in ready:
                move(w, JOINING)
                self._deferred_joins.discard(w)
            if ready:
                changed.append(("join_request", ready))
            self._deferred_joins = {w for w in self._deferred_joins
                                    if self._states[w] in (LEAVING, DEAD)}

            self._round = int(round_index)
            if changed:
                self._epoch += 1
                self._view = MembershipView(self._epoch, self._round,
                                            tuple(self._states), self.spec)
                for kind, ws in changed:
                    self.transitions.append((self._epoch, self._round, kind, ws))
            else:
                self._view = MembershipView(self._view.epoch, self._round,
                                            tuple(self._states), self.spec)
        if changed:
            self._note_changes(changed)
        return self._view

    def admit(self, round_index: int,
              workers: Optional[Sequence[int]] = None) -> MembershipView:
        """Flip ``joining`` workers to ``live`` at a new view epoch."""
        with self._lock:
            ws = tuple(
                int(w) for w in (
                    workers if workers is not None
                    else [w for w, s in enumerate(self._states) if s == JOINING]
                )
                if self._states[int(w)] == JOINING
            )
            if not ws:
                return self._view
            for w in ws:
                self._states[w] = LIVE
            self._epoch += 1
            self._round = int(round_index)
            self._view = MembershipView(self._epoch, self._round,
                                        tuple(self._states), self.spec)
            self.transitions.append((self._epoch, self._round, "rejoin", ws))
        self._note_changes([("rejoin", ws)])
        return self._view

    # ------------------------------------------------------------------
    def _note_changes(self, changed) -> None:
        view = self._view
        if self._echo is not None:
            for kind, ws in changed:
                self._echo("membership: epoch %d (round %d): %s %s -> %s"
                           % (view.epoch, view.round, kind, list(ws),
                              dict(view.counts())))
        _obs.instant("membership_view", cat="membership", epoch=view.epoch,
                     round=view.round,
                     changes=[[k, list(ws)] for k, ws in changed],
                     counts=view.counts())
        if self.metrics is not None:
            for kind, ws in changed:
                self.metrics.membership_transitions.labels(kind).inc(len(ws))
        self._publish_metrics()

    def _publish_metrics(self) -> None:
        tm = self.metrics
        if tm is None:
            return
        tm.membership_epoch.set(self._view.epoch)
        for s, n in self._view.counts().items():
            tm.membership_workers.labels(s).set(n)

    def state_dict(self) -> Dict:
        """The membership block a health endpoint exports."""
        view = self._view
        return {
            "epoch": view.epoch,
            "round": view.round,
            "workers": view.counts(),
            "states": list(view.states),
            "slices": [list(s) for s in self.spec.slices],
            "cross_slice_every": self.spec.cross_slice_every,
            "pending_joiners": list(view.workers_in(JOINING)),
            "transitions": len(self.transitions),
        }

    # --- full job state ---------------------------------------------------
    def export_state(self) -> Dict:
        """Epoch, round, per-worker states and leave bookkeeping: what a
        restarted driver needs to continue the same view history.  Queued
        events are not part of it (their source re-delivers)."""
        with self._lock:
            return {
                "epoch": int(self._epoch),
                "round": int(self._round),
                "states": list(self._states),
                "leaving_since": {str(w): int(r)
                                  for w, r in self._leaving_since.items()},
            }

    def load_state(self, d: Dict) -> None:
        """Restore ``export_state``'s view: the epoch clock continues
        where the crashed driver's stopped."""
        states = [str(s) for s in d["states"]]
        if len(states) != self.num_workers:
            raise ValueError(f"jobstate roster has {len(states)} workers, "
                             f"spec has {self.num_workers}")
        with self._lock:
            self._epoch = int(d["epoch"])
            self._round = int(d["round"])
            self._states = states
            self._leaving_since = {int(w): int(r) for w, r in
                                   (d.get("leaving_since") or {}).items()}
            self._view = MembershipView(self._epoch, self._round,
                                        tuple(self._states), self.spec)
        self._publish_metrics()

    def epochs_monotonic(self) -> bool:
        es = [e for e, _, _, _ in self.transitions]
        return all(b >= a for a, b in zip(es, es[1:]))


class AutoRejoin:
    """Request a departed worker's rejoin once its leave has completed
    and ``after`` boundaries have passed since it left (the stand-in for
    an orchestrator's relaunch notice; ``after <= 0`` disables it).
    Call ``on_round`` right after ``advance``."""

    def __init__(self, controller: MembershipController, after: int):
        self.controller = controller
        self.after = int(after)
        self._gone_since: Dict[int, int] = {}

    def on_round(self, round_index: int) -> None:
        if self.after <= 0:
            return
        ready = []
        for w, s in enumerate(self.controller.view.states):
            if s == LIVE:
                self._gone_since.pop(w, None)
                continue
            self._gone_since.setdefault(w, round_index)
            if s == DEAD and round_index - self._gone_since[w] >= self.after:
                ready.append(w)
        if ready:
            self.controller.note_join(ready)


# ----------------------------------------------------------------------
# readmission: catch-up params, broadcast, merge, zero momentum


def consensus_state(state, live_mask):
    """A single-replica TrainState from the FIRST LIVE worker of a
    stacked state (dead slots may hold stale params under the
    intra-slice tier); views on the device, no copy."""
    live = np.flatnonzero(np.asarray(live_mask, np.float32).reshape(-1) > 0)
    w = int(live[0]) if live.size else 0
    return type(state)(*(tree_map(lambda x: x[w], f) for f in state))


def survivor_consensus(trainer, state, live_mask):
    """``consensus_state`` of a trainer's state: across processes the
    first live worker's row, broadcast over the dp group from the rank
    that holds it (every rank calls this)."""
    if getattr(trainer, "group", None) is None:
        return consensus_state(state, live_mask)
    from sparknet_tpu_torch.parallel import mesh as _mesh
    from sparknet_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    live = np.flatnonzero(np.asarray(live_mask, np.float32).reshape(-1) > 0)
    w = int(live[0]) if live.size else 0
    rows = _mesh.all_gather_objects((trainer.rows.start, trainer.rows.stop),
                                    trainer.group)
    src = next(i for i, (lo, hi) in enumerate(rows) if lo <= w < hi)
    mine = trainer.rows
    local = w - mine.start if mine.start <= w < mine.stop else 0
    one = type(state)(*(tree_map(lambda x: x[local], f) for f in state))
    leaves = _mesh.broadcast_leaves(tree_leaves(one), trainer.group, src=src)
    return tree_unflatten(one, leaves)


def readmit_state(trainer, state, restored, workers):
    """Merge ``restored`` (a single-replica state) into the rows of
    ``workers``: their params and stats come from it (placed through
    ``trainer.broadcast_state``, which resets the comm plane, as in the
    JAX package), their momentum is zeroed, every other row is
    untouched.  Across processes ``state`` holds this process's rows
    (``trainer.rows``)."""
    full = trainer.broadcast_state(restored)
    rows = getattr(trainer, "rows", slice(0, trainer.num_workers))
    row = np.zeros((trainer.num_workers,), bool)
    row[list(workers)] = True
    row = row[rows]
    n = row.shape[0]
    placed: Dict[str, torch.Tensor] = {}  # the row mask, once a device

    def rows_for(x):
        key = str(x.device)
        if key not in placed:
            placed[key] = torch.from_numpy(row).to(x.device)
        return placed[key].reshape((n,) + (1,) * (x.dim() - 1))

    def pick(cur, new):
        return torch.where(rows_for(cur), new, cur)

    def zero_row(cur):
        return torch.where(rows_for(cur), torch.zeros_like(cur), cur)

    return type(state)(
        tree_map(pick, state.params, full.params),
        tree_map(pick, state.stats, full.stats),
        tree_map(zero_row, state.history),
        state.iter,
    )


def readmit(trainer, solver, state, prefix: str,
            controller: MembershipController, round_index: int,
            snapshot: bool = True, live_mask=None,
            snapshot_fmt: Optional[str] = None,
            echo: Optional[Callable[[str], None]] = None, metrics=None):
    """The readmission of every pending joiner through a snapshot:
    publish a fresh consensus snapshot (unless ``snapshot=False``),
    restore through ``restore_newest_valid`` (corrupt snapshots
    quarantined as on any resume), merge with ``readmit_state`` and
    ``admit()``.  Returns ``(state, view or None)``."""
    workers = controller.pending_joiners()
    if not workers:
        return state, None
    from sparknet_tpu_torch.io import checkpoint

    if snapshot:
        mask = controller.live_mask() if live_mask is None else live_mask
        checkpoint.snapshot(solver, consensus_state(state, mask), prefix,
                            fmt=snapshot_fmt, metrics=metrics)
    restored, used = checkpoint.restore_newest_valid(solver, prefix,
                                                     metrics=metrics)
    state = readmit_state(trainer, state, restored, workers)
    view = controller.admit(round_index)
    if echo is not None:
        echo("membership: readmitted worker(s) %s from %s at epoch %d "
             "(momentum zeroed)" % (list(workers), os.path.basename(used),
                                    view.epoch))
    return state, view


def readmit_from_survivors(trainer, state, controller, round_index, echo=None):
    """Readmission without snapshots: the joiners take the live
    consensus state directly (the same merge and momentum zeroing)."""
    workers = controller.pending_joiners()
    if not workers:
        return state, None
    restored = survivor_consensus(trainer, state, controller.live_mask())
    state = readmit_state(trainer, state, restored, workers)
    view = controller.admit(round_index)
    if echo is not None:
        echo("membership: readmitted worker(s) %s from the survivor "
             "consensus at epoch %d (momentum zeroed)"
             % (list(workers), view.epoch))
    return state, view
