"""Bounded-staleness parameter averaging: τ as a spectrum, not a gate.

The port of ``sparknet_tpu/parallel/stale.py``.  Workers run ahead up
to a **staleness bound B** (``--stale_bound``) and each averaging
boundary takes **whoever has arrived**:

- boundary ``b`` folds in the workers whose τ-window finished, each
  weighted ``discount ** lag`` with ``lag = b - worker_rounds[w]``;
- a worker whose window is still in flight keeps all its local state
  (params, stats, momentum, iter) bit-untouched, and its loss and audit
  rows read 0;
- the bound is hard: a live worker at ``lag >= B`` is forced into the
  boundary; a dead worker never is (it goes maximally stale);
- ``B = 0`` forces every live worker every round, and ``round()``
  hands over to ``ParameterAveragingTrainer.round``: bit-identical to
  the synchronous averaging.

With fractional weights the mean is the true weighted mean
``Σ(w·θ) / Σ(w)`` over the stacked worker axis, ``where()``-guarded on
both sides so an absent worker's replica never enters the sum; arrived
workers adopt it, absent workers keep their own replica.  Under a
two-tier ``HierarchySpec`` an intra boundary forms each slice's
weighted mean over its own arrivals, a cross boundary the global one,
and arrivals coarsen to slices (a slice arrives when every live member
did).

The W workers run one after another on one device
(``parallel/trainers.py``).  The JAX package runs every worker's window
in SPMD and discards the windows of workers that have not arrived; here
a window that would be discarded wholesale is not run at all, which
leaves every output equal (each worker's window draws from
``fold_in(train_key(0), w)`` alone) and launches nothing for it.

Across processes (``mesh=``, as ``ParameterAveragingTrainer`` takes
it) each process runs its own workers' windows; the arrival sets, the
lags, the forced waits and the ``discount ** lag`` weights are host
arrays computed from the same inputs on every rank, and each group's
weighted mean runs over the params and stats gathered from every rank
of the dp group, so a boundary gives the stacked run's bits.

The comm plane's delta-quantized and overlapped collectives assume a
synchronous boundary, so ``compress``/``overlap_avg`` are refused with
``B > 0``.  Drivers journal ``worker_rounds`` beside each round
(``export_stale_state``) and keep full per-worker replicas in their
job state (``export_worker_replicas``): between boundaries the
replicas diverge by design.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.obs import health as _health
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.parallel import mesh as _mesh
from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
from sparknet_tpu_torch.parallel.trainers import (
    ParameterAveragingTrainer,
    _bshape,
    gather_rows,
    zero_rows,
)
from sparknet_tpu_torch.solver import TrainState
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_unflatten

# the weighted mean's denominator guard: an all-absent boundary never
# divides (it is skipped), an all-masked-by-audit one reaches Σw == 0
_DENOM_EPS = 1e-8


def stale_window(window_fn, worker_rounds) -> Dict[str, np.ndarray]:
    """The mixed-round batch of one stale boundary: worker ``w``'s rows
    come from ``window_fn(worker_rounds[w])``, the window of its own next
    round.  ``window_fn(r)`` is the absolute-round feed (leaves
    ``(num_workers, tau, ...)``); rounds are deduplicated, so a fleet in
    step costs one call."""
    rounds = [int(r) for r in np.asarray(worker_rounds).reshape(-1)]
    per_round = {r: window_fn(r) for r in sorted(set(rounds))}
    out: Dict[str, np.ndarray] = {}
    first = per_round[rounds[0]]
    for key in first:
        base = np.array(np.asarray(first[key]), copy=True)
        for w, r in enumerate(rounds):
            base[w] = np.asarray(per_round[r][key])[w]
        out[key] = base
    return out


def export_worker_replicas(state) -> Dict[str, np.ndarray]:
    """Every leaf of a worker-stacked state as numpy, keyed by its leaf
    index: the jobstate's ``stale`` replicas block."""
    return {str(i): l.detach().cpu().numpy()
            for i, l in enumerate(tree_leaves(tuple(state)))}


def restore_worker_replicas(state, replicas: Dict) -> TrainState:
    """Put ``export_worker_replicas``' stacks back onto a placed state of
    the same geometry, each on its leaf's device; a shape mismatch fails
    loudly (the jobstate belongs to another trainer geometry)."""
    cur = tree_leaves(tuple(state))
    leaves = [np.asarray(replicas[str(i)]) for i in range(len(cur))]
    if any(tuple(l.shape) != tuple(c.shape) for l, c in zip(leaves, cur)):
        raise ValueError(
            "jobstate worker replicas do not match this trainer's shapes")
    return TrainState(*tree_unflatten(tuple(state), [
        torch.from_numpy(np.array(l)).to(device=c.device, dtype=c.dtype)
        for l, c in zip(leaves, cur)
    ]))


class BoundedStalenessTrainer(ParameterAveragingTrainer):
    """τ-step local SGD + bounded-staleness weighted averaging.

    A ``ParameterAveragingTrainer`` (placement, eval, the comm plane and
    job state are its) with the ledger:

    - ``worker_rounds``: how many τ-windows each worker has folded into a
      boundary; ``lag = boundary - worker_rounds[w]``;
    - ``round(state, batches, arrived=...)``: one boundary (see
      ``round``);
    - ``last_boundary``: the boundary's host readout (lags, arrival,
      forced and skipped masks, weights, tier).

    ``batches`` at a stale boundary are mixed-round: each worker's rows
    from its own next round (``stale_window``)."""

    def __init__(self, solver, num_workers: int, *, stale_bound: int = 0,
                 discount: float = 0.5, compress: str = "none",
                 overlap_avg: bool = False, metrics=None,
                 hierarchy: Optional[HierarchySpec] = None, mesh=None,
                 axis: str = "dp"):
        if stale_bound < 0:
            raise ValueError(f"stale_bound={stale_bound}: must be >= 0")
        if not (0.0 < discount <= 1.0):
            raise ValueError(f"discount={discount}: must be in (0, 1]")
        if stale_bound > 0 and (compress != "none" or overlap_avg):
            # the error-feedback residuals are anchored on a synchronous
            # consensus; a partial-arrival boundary breaks the anchor
            raise ValueError(
                "stale_bound > 0 does not compose with compress/overlap_avg "
                "(the comm plane assumes synchronous boundaries); run "
                "compress='none'")
        super().__init__(solver, num_workers, compress=compress,
                         overlap_avg=overlap_avg, metrics=metrics,
                         hierarchy=hierarchy, mesh=mesh, axis=axis)
        self.stale_bound = int(stale_bound)
        self.discount = float(discount)
        self.worker_rounds = np.zeros((self.num_workers,), np.int64)
        self._boundary = 0
        self.last_boundary: Optional[Dict] = None

    # --- the staleness ledger (journaled every intent and commit) ------
    def export_stale_state(self) -> Dict:
        return {
            "stale_bound": np.asarray(self.stale_bound, np.int64),
            "discount": np.asarray(self.discount, np.float64),
            "boundary": np.asarray(self._boundary, np.int64),
            "worker_rounds": np.asarray(self.worker_rounds, np.int64),
        }

    def reset_stale_state(self) -> None:
        """Zero the ledger (a fresh run on a reused trainer)."""
        self.worker_rounds[:] = 0
        self._boundary = 0
        self.last_boundary = None

    def load_stale_state(self, frag: Dict) -> None:
        wr = np.asarray(frag["worker_rounds"], np.int64).reshape(-1)
        if wr.shape[0] != self.num_workers:
            raise ValueError(
                f"stale jobstate covers {wr.shape[0]} workers, trainer has "
                f"{self.num_workers}")
        self.worker_rounds = wr.copy()
        self._boundary = int(np.asarray(frag["boundary"]))

    def lags(self, boundary: Optional[int] = None) -> np.ndarray:
        """Per-worker staleness at ``boundary`` (default: the next one),
        floored at 0."""
        b = self._boundary if boundary is None else int(boundary)
        return np.maximum(b - self.worker_rounds, 0)

    # --- job state: the ledger and the per-worker replicas -------------
    def export_job_state(self, state: TrainState, cursor) -> Dict:
        """The synchronous jobstate fragment, plus (``B > 0``) the
        ``stale`` block: the ledger and every worker's replica."""
        extra = super().export_job_state(state, cursor)
        if self.stale_bound > 0:
            if self.group is not None:  # every rank's rows (collectives)
                leaves, _ = _mesh.all_gather_leaves(
                    tree_leaves(tuple(state)[:3]), self.group)
                iters = np.concatenate(_mesh.all_gather_objects(
                    state.iter.numpy(), self.group))
                state = TrainState(*tree_unflatten(tuple(state)[:3], leaves),
                                   torch.from_numpy(iters))
            extra["stale"] = {"ledger": self.export_stale_state(),
                              "replicas": export_worker_replicas(state)}
        return extra

    def resume_from(self, st: TrainState, used: str, js, tau: int):
        """The synchronous resume, then the ``stale`` block: the replicas
        replace the broadcast consensus and the ledger resumes."""
        state, start_round, js = super().resume_from(st, used, js, tau)
        if self.stale_bound > 0 and "stale" in js:
            replicas = js["stale"]["replicas"]
            if self.group is not None:  # every worker's: keep this rank's
                replicas = {k: np.asarray(v)[self.rows]
                            for k, v in replicas.items()}
            state = restore_worker_replicas(state, replicas)
            self.load_stale_state(js["stale"]["ledger"])
        return state, start_round, js

    # ------------------------------------------------------------------
    def _arrival_sets(self, b: int, arrived, live: np.ndarray):
        """``(eff, forced, lag)``: the effective arrival mask, which of
        those the bound forced, and the per-worker lag.  Dead workers
        never arrive and never force; under a two-tier hierarchy a slice
        arrives when every live member did."""
        lag = np.maximum(b - self.worker_rounds, 0)
        if arrived is None:
            arr = live > 0
        else:
            arr = np.asarray(arrived, bool).reshape(-1)
            if arr.shape[0] != self.num_workers:
                raise ValueError(
                    f"arrived has {arr.shape[0]} entries, trainer has "
                    f"{self.num_workers} workers")
            arr = arr & (live > 0)
        forced = (lag >= self.stale_bound) & (live > 0) & ~arr
        eff = arr | forced
        if self._two_tier:
            eff2 = eff.copy()
            for members in self.hierarchy.slices:
                m = np.asarray(members, np.int64)
                lv = live[m] > 0
                ok = bool(np.all(eff[m] | ~lv)) and bool(np.any(lv))
                eff2[m] = ok & lv
            forced = forced & eff2
            eff = eff2
        return eff, forced, lag

    def round(self, state: TrainState, batches: Dict[str, torch.Tensor],
              arrived=None, live_mask=None, round_index: Optional[int] = None):
        """One averaging boundary.

        ``arrived`` (W,) bools: whose τ-window has finished by this
        boundary (None: every live worker).  Live workers at
        ``lag >= stale_bound`` are forced in, and arrivals coarsen to
        slices under a two-tier hierarchy; the resolved masks land in
        ``last_boundary``.  ``stale_bound == 0`` hands over to the
        synchronous round.  A boundary with no arrival runs nothing and
        returns the state untouched with zero losses (and None stats)."""
        b = self._boundary if round_index is None else int(round_index)
        W = self.num_workers
        live = (np.ones((W,), np.float32) if live_mask is None
                else np.asarray(live_mask, np.float32).reshape(-1))
        if self.stale_bound == 0:
            out = super().round(state, batches, live_mask=live_mask,
                                round_index=round_index)
            self._boundary = b + 1
            # the ledger stays coherent for the journal and telemetry
            self.worker_rounds[live > 0] += 1
            self.last_boundary = {
                "boundary": b, "lag": [0] * W,
                "arrived": [bool(v > 0) for v in live],
                "forced": [False] * W,
                "weights": [float(v > 0) for v in live],
                "skipped": False, "tier": "sync",
            }
            self._emit_metrics()
            return out

        eff, forced, lag = self._arrival_sets(b, arrived, live)
        weights = np.where(eff, np.power(self.discount, lag.astype(np.float64)),
                           0.0).astype(np.float32)
        intra = self._two_tier and not self.hierarchy.is_cross_round(b)
        self.last_boundary = {
            "boundary": b,
            "lag": [int(v) for v in lag],
            "arrived": [bool(v) for v in eff],
            "forced": [bool(v) for v in forced],
            "weights": [float(v) for v in weights],
            "skipped": not bool(eff.any()),
            "tier": "intra" if intra else "cross",
        }
        self._boundary = b + 1
        self._auto_round = b + 1
        audit = self.solver.audit
        if not eff.any():
            # nobody reached this boundary: no window runs, no state
            # changes, the ledger does not advance
            self._emit_metrics()
            tau = int(next(iter(batches.values())).shape[1])
            losses = torch.zeros((W, tau), dtype=torch.float32,
                                 device=self.device)
            if audit:
                return state, losses, None
            return state, losses
        self.worker_rounds[eff] += 1

        self.last_group_bytes = 0
        with span("average"):
            state, losses, stats = self._fold(state, batches, eff, weights,
                                              intra, audit)
            if self.group is not None:
                # every rank reads every worker's losses and audit rows
                losses = _mesh.all_gather_rows(losses, self.group)
                if stats is not None:
                    stats = gather_rows(stats, self.group)
            self.solver.note_losses(losses)
        tm = self.metrics
        if tm is not None:
            tm.rounds.inc()
            tm.iters.inc(losses.shape[-1])
            if self.hierarchy is not None:
                tier = self.last_boundary["tier"]
                tm.hierarchy_rounds.labels(tier).inc()
                tm.hierarchy_bytes.labels(tier).inc(
                    self.last_group_bytes if self.group is not None
                    else self._payload_bytes(state))
        self._emit_metrics()
        self._observe_profile(losses, state)
        obs.report_healthy()
        if audit:
            return state, losses, stats
        return state, losses

    def _fold(self, state, batches, eff, weights, intra: bool, audit: bool):
        """Run the arrived workers' windows (only theirs), then the
        weighted mean; returns ``(state, losses, stats)`` (this process's
        rows of the losses and stats across processes)."""
        state, losses, stats = self._local(state, batches, run=eff)
        dev = losses.device
        keep = torch.from_numpy(eff.copy()).to(dev)
        w = torch.from_numpy(weights.copy()).to(dev)
        bad = None
        if audit:
            # an arrived worker whose window went non-finite weighs 0;
            # an absent one never reads as bad (its stats are zero)
            bad = _health.bad_workers(stats)
            ok = torch.where(bad, 0.0, 1.0).to(w.dtype)
            stats["masked"] = (1.0 - ok) * keep[self.rows].to(w.dtype)
            if self.group is not None:
                ok = _mesh.all_gather_rows(ok, self.group)
            w = w * ok
        return self._weighted_mean(state, w, keep, bad, intra), losses, stats

    @staticmethod
    def _wmean(x, w, denom):
        """``Σ where(w > 0, x·w, 0) / denom`` over the worker axis."""
        wb = _bshape(w.to(x.dtype), x.dim())
        contrib = torch.where(_bshape(w > 0, x.dim()), x * wb,
                              torch.zeros_like(x))
        return contrib.sum(dim=0) / denom.to(x.dtype)

    def _weighted_mean(self, state: TrainState, w, keep, bad,
                       intra: bool) -> TrainState:
        """Each group's weighted mean over its own arrivals (every worker
        on a cross boundary, each slice on an intra one), adopted by the
        group's arrived workers; absent workers keep their own replica,
        and a group with no finite arrival keeps each own.  ``w`` and
        ``keep`` cover every worker, ``bad`` is this process's rows.
        Across processes a group's rows held by other ranks are gathered
        first, in worker order: a cross boundary's over the dp group, an
        intra one's over the slice's own group (``mesh.slice_groups``;
        a slice held by one rank gathers nothing), so a boundary gives
        the stacked run's bits and ``last_group_bytes`` counts what
        reached this rank."""
        dev = w.device
        leaves = tree_leaves(state.params) + tree_leaves(state.stats)
        out = [x.clone() for x in leaves]
        adopted = torch.zeros((self.local_workers,), dtype=torch.bool,
                              device=dev)
        for members, local, gather in self._mean_groups(intra, dev):
            ws = w.index_select(0, members)
            d0 = ws.sum()
            denom = torch.clamp_min(d0, _DENOM_EPS)
            adopt = keep.index_select(0, members) & (d0 > 0)
            xs = [x.index_select(0, local) for x in leaves]
            if gather is not None:
                xs = gather(xs)
            # this rank's rows of the group, in the group's worker order
            mine = adopt.index_select(0, members.new_tensor(
                [i for i, m in enumerate(members.tolist())
                 if self.rows.start <= m < self.rows.stop]))
            for y, x in zip(out, xs):
                m = self._wmean(x, ws, denom)
                own = y.index_select(0, local)
                y.index_copy_(0, local, torch.where(
                    _bshape(mine, own.dim()),
                    m.unsqueeze(0).expand_as(own), own))
            adopted.index_copy_(0, local, mine)
        history = state.history
        if bad is not None:
            # a masked arrival adopts the survivor mean; its momentum
            # still holds the poisoned window
            history = zero_rows(history, bad & adopted)
        n = len(tree_leaves(state.params))
        return TrainState(tree_unflatten(state.params, out[:n]),
                          tree_unflatten(state.stats, out[n:]), history,
                          state.iter)

    def _mean_groups(self, intra: bool, dev):
        """``(members, local, gather)`` for each group of this boundary
        that holds a row of this process: the group's workers (global
        indices), this process's rows of them (local indices) and the
        gather that turns those rows into the group's, or None when this
        process holds the whole group."""
        W = self.num_workers
        if self.group is None:
            groups = self.hierarchy.slices if intra else [tuple(range(W))]
            for g in groups:
                idx = torch.tensor(g, device=dev)
                yield idx, idx, None
            return
        if not intra:
            local = torch.arange(self.local_workers, device=dev)

            def everyone(xs):
                full, nbytes = _mesh.all_gather_leaves(xs, self.group)
                self.last_group_bytes += nbytes
                return full

            yield torch.arange(W, device=dev), local, everyone
            return
        for sg, (idx, keep) in zip(self._slice_groups,
                                   self._slice_places(dev)):
            if not sg.local:
                continue
            yield (torch.tensor(sg.workers, device=dev), idx,
                   None if sg.group is None
                   else lambda xs, sg=sg, keep=keep: self._gather_slice(
                       sg, keep, xs))

    def _emit_metrics(self) -> None:
        """The boundary readout on the trainer's metrics: the per-worker
        staleness gauge, arrival and skip counters, forced waits (the
        bound's synchronous cost) and skipped boundaries."""
        tm = self.metrics
        lb = self.last_boundary
        if tm is None or lb is None:
            return
        for w in range(self.num_workers):
            tm.staleness.labels(str(w)).set(float(lb["lag"][w]))
            if lb["arrived"][w]:
                tm.stale_arrivals.labels(str(w)).inc()
            else:
                tm.stale_skipped.labels(str(w)).inc()
        nforced = sum(1 for v in lb["forced"] if v)
        if nforced:
            tm.stale_forced_waits.inc(nforced)
        if lb["skipped"]:
            tm.stale_boundaries_skipped.inc()
