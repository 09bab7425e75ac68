"""The two data-parallel training modes: SparkNet's parameter averaging
(W workers stacked on a device, over one process or several) and
Caffe's synchronous gradient all-reduce on the global batch
(``AllReduceTrainer``, one rank a block of the batch's rows).

The port of ``ParameterAveragingTrainer`` (``sparknet_tpu/parallel/
trainers.py:214``): every worker keeps its own replica of params and
solver history, runs tau local SGD iterations with no communication,
then the parameters (only — history is never averaged, the reference's
``getWeights``, ``Net.scala:151-171``) are averaged over the workers.

State is worker-stacked: every leaf of the ``TrainState`` carries a
leading ``(W, ...)`` axis on one device (``iter`` a (W,) CPU tensor).
A round runs the workers one after another on views of the stacked
leaves, and the JAX package's ``psum`` over ``dp`` becomes a masked
mean over the leading axis with the same ``where()`` (not multiply)
semantics and the same survivor count ``denom0``.  ``compress`` /
``overlap_avg`` engage the comm plane (``parallel/comm.py``).

With the solver's audit on (``solver.audit``, read each round)
``round`` also returns the per-worker stats tree, and the in-round
worker mask is armed: a worker whose window produced a non-finite grad
or param leaves that round's average (``alive = live x ok``, a device
tensor throughout), its slot receives the survivor mean and its
momentum history is zeroed; with no finite worker each keeps its own
params.  ``hierarchy`` (``parallel/
hierarchy.py``) declares the two-tier schedule: a non-cross round
averages each slice's live workers only (a masked mean per slice, no
comm kernel), a cross round is the global round above.

Across processes (``mesh=``, a ``parallel/mesh.py`` mesh whose ``dp``
axis spans processes): each process stacks only its own block of
workers (``local_worker_slice``) on its device, and the average reduces
over the mesh's dp group.  The reduction gathers every rank's
contributions — params and stats as one flat buffer a rank, the
survivor mask, then the round's losses and audit rows — and runs the
same masked mean over the gathered (W, ...) stack, so a run of W workers
over P processes gives the bits of the one-process stacked run of the
same W on the same device type, for any W (an ``all_reduce(SUM)``
would give them only for one worker on each of two ranks).  The
survivor count ``denom0`` is the gathered mask's sum, and the audit's
in-round mask folds each rank's verdicts into it the same way.  Under
gloo a CUDA payload crosses through host copies (``mesh.STAGING``);
``last_group_bytes`` is what reached this rank from the others in the
last round.  The two-tier schedule runs across processes too: each
slice whose workers span processes gets a group of its own
(``mesh.slice_groups``), an intra-slice round gathers that slice's
rows over it and runs the same masked mean (a slice inside one process
moves nothing), and a cross round is the global round above.  The
overlapped comm plane stays single-process (refused, as in JAX).
"""

from __future__ import annotations

import types
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.obs import health as _health
from sparknet_tpu_torch.obs import profile as _profile
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.parallel import mesh as _mesh
from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
from sparknet_tpu_torch.parallel.mesh import local_worker_slice
from sparknet_tpu_torch.solver import Solver, TrainState
from sparknet_tpu_torch.utils import dp, rngs
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def worker_state(state: TrainState, w: int) -> TrainState:
    """Worker ``w``'s slice of a worker-stacked state (views, no copy)."""
    return TrainState(*(tree_map(lambda x: x[w], f) for f in state))


def stack_states(states: List[TrainState]) -> TrainState:
    """The inverse of ``worker_state`` over all workers."""
    cols = [tree_leaves(s) for s in states]
    stacked = [torch.stack(xs) for xs in zip(*cols)]
    return tree_unflatten(states[0], stacked)


def first_worker(stacked_tree):
    """Worker 0's slice of a worker-stacked tree (a ``TrainState`` or any
    container of stacked leaves) — the consensus a snapshot keeps."""
    return tree_map(lambda x: x[0], stacked_tree)


def export_worker_history(state: TrainState) -> Dict:
    """Per-worker momentum stacks as a ``.jobstate.npz`` fragment (the
    ``workers`` key): the consensus snapshot keeps worker 0's history
    only, so the true (W, ...) stacks ride beside it."""
    return {"history": {str(i): l.detach().cpu().numpy()
                        for i, l in enumerate(tree_leaves(state.history))}}


def restore_worker_history(state: TrainState, workers_fragment) -> TrainState:
    """Put the per-worker momentum stacks of ``export_worker_history``
    back onto a broadcast-restored state, each on its leaf's device; a
    shape mismatch fails loudly (the jobstate belongs to another trainer
    geometry)."""
    hd = workers_fragment["history"]
    cur = tree_leaves(state.history)
    leaves = [np.asarray(hd[str(i)]) for i in range(len(cur))]
    if len(hd) != len(cur) or any(
        tuple(l.shape) != tuple(c.shape) for l, c in zip(leaves, cur)
    ):
        raise ValueError(
            "jobstate worker history does not match this trainer's shapes"
        )
    return state._replace(history=tree_unflatten(state.history, [
        torch.from_numpy(np.array(l, np.float32)).to(c.device)
        for l, c in zip(leaves, cur)
    ]))


def zero_rows(tree, rows: torch.Tensor):
    """``tree`` with the workers where ``rows`` (W,) is true zeroed;
    ``where()``, so false rows keep their exact bits."""
    def zero(h):
        return torch.where(_bshape(rows, h.dim()), torch.zeros_like(h), h)

    return tree_map(zero, tree)


def _bshape(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (ndim - 1))


def masked_mean(x: torch.Tensor, alive: torch.Tensor,
                denom: torch.Tensor) -> torch.Tensor:
    """``psum(where(alive > 0, x, 0)) / denom`` over the worker axis."""
    contrib = torch.where(_bshape(alive > 0, x.dim()), x, torch.zeros_like(x))
    return contrib.sum(dim=0) / denom


def gather_rows(tree, group):
    """Each leaf's rows of every rank, in rank order (``mesh.
    all_gather_rows``); ``tree`` unchanged without a group."""
    if group is None:
        return tree
    return tree_map(lambda x: _mesh.all_gather_rows(x, group), tree)


class ParameterAveragingTrainer:
    """tau-step local SGD + parameter averaging over ``num_workers``."""

    _LIVE_CACHE_MAX = 64

    def __init__(
        self,
        solver: Solver,
        num_workers: int,
        compress: str = "none",
        overlap_avg: bool = False,
        metrics: Optional[TrainingMetrics] = None,
        hierarchy: Optional[HierarchySpec] = None,
        mesh=None,
        axis: str = "dp",
    ):
        """Params and stat blobs are averaged; ``metrics`` receives the
        training series (rounds, iters, collective bytes, the comm plane's
        kernel launches and quantization error, the hierarchy's tiers);
        None records nothing.  The solver's audit arms the in-round
        worker mask; ``hierarchy`` is the two-tier schedule (a flat spec
        is bit-identical to none).  ``mesh`` (``parallel/mesh.py``)
        places the workers: ``num_workers`` is its ``axis`` size, this
        process stacks its own block of them, and the average reduces
        over the axis's group when it has one."""
        from sparknet_tpu_torch.parallel import comm as _comm

        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if compress not in _comm.COMPRESS_MODES:
            raise ValueError(
                f"compress={compress!r}: expected one of {_comm.COMPRESS_MODES}"
            )
        if hierarchy is not None and hierarchy.num_workers != num_workers:
            raise ValueError(
                f"hierarchy spec covers {hierarchy.num_workers} workers, "
                f"trainer has {num_workers}"
            )
        self.solver = solver
        self.device = solver.device
        self.num_workers = int(num_workers)
        self.mesh = mesh
        self.group = None
        self.rows = slice(0, self.num_workers)
        if mesh is not None:
            if mesh.shape.get(axis) != self.num_workers:
                raise ValueError(
                    f"mesh axis {axis!r} has {mesh.shape.get(axis)} workers, "
                    f"trainer has {num_workers}"
                )
            self.group = mesh.group(axis)
            self.rows = local_worker_slice(mesh, axis)
        if self.group is not None:
            if overlap_avg:
                # the comm thread's collectives would race the round's
                # program order across ranks (JAX comm.py refuses alike)
                raise ValueError(
                    "overlap_avg needs a single-process runtime (the "
                    "cross-process program order must be deterministic); "
                    "use barriered compression instead"
                )
        self.local_workers = self.rows.stop - self.rows.start
        # bytes that reached this rank from the other ranks last round
        self.last_group_bytes = 0
        self.compress = compress
        self.metrics = metrics
        self.hierarchy = hierarchy
        self._two_tier = hierarchy is not None and not hierarchy.is_flat()
        # the schedule's round counter when round() gets no round_index
        self._auto_round = 0
        # each slice's processes, this process's rows of it and its group
        # (one across processes, created on every rank in slice order)
        self._slice_groups = None
        self._slice_index = None  # (local rows, gathered rows kept) a slice
        if self._two_tier:
            self._slice_groups = _mesh.slice_groups(
                mesh if self.group is not None else None, hierarchy.slices,
                axis)
        self._comm = None
        if compress != "none" or overlap_avg:
            self._comm = _comm.CommPlane(
                self._local, compress=compress, overlap=overlap_avg,
                metrics=metrics, group=self.group, rows=self.rows,
            )
        self._fused_payload_bytes: Optional[int] = None
        self._live_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        # the round's per-worker execute timer (--profile only)
        self._window_timer = None
        # an audit row of zeros, for a worker that sits out a boundary
        self._idle_packed = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """All workers start from identical weights (the initial broadcast,
        CifarApp.scala:92-97), stacked on axis 0."""
        return self.broadcast_state(self.solver.init_state(seed))

    def broadcast_state(self, st: TrainState) -> TrainState:
        """Place a single-replica TrainState on every worker slot (an
        init, or weights carried in) on the solver's device; resets the
        comm plane's carried state.  Across processes the slots are this
        process's own workers."""
        if self._comm is not None:
            self._comm.reset()
        n = self.local_workers

        def rep(x):
            x = torch.as_tensor(x)
            dev = None if x.dtype == torch.int64 else self.device
            return x.to(dev).unsqueeze(0).repeat((n,) + (1,) * x.dim())

        return TrainState(*(tree_map(rep, f) for f in st))

    # --- full job state (io/checkpoint extra_state) ----------------------
    def export_comm_state(self):
        """The comm plane's error-feedback residuals as a host jobstate
        fragment, or None on the fused round (no carried state)."""
        if self._comm is None:
            return None
        return self._comm.export_state()

    def restore_comm_state(self, exported) -> None:
        """Load residuals of ``export_comm_state`` — call AFTER
        ``broadcast_state`` (which resets the plane)."""
        if exported is None:
            return
        if self._comm is None:
            raise ValueError(
                "jobstate carries comm residuals but this trainer runs "
                "the fused round (compress/overlap off)"
            )
        self._comm.restore_state(exported)

    def export_job_state(self, state: TrainState, cursor) -> Dict:
        """The ``.jobstate.npz`` fragment a snapshot of ``state`` carries
        beside worker 0's consensus (``io/checkpoint.snapshot``'s
        ``extra_state``): the data ``cursor``, every worker's momentum,
        the loss window and, on the comm plane, its residuals.  Across
        processes every rank calls it (the momentum rows are gathered)."""
        hist_state = state
        if self.group is not None:
            # every worker's momentum: the ranks' rows gathered (a
            # collective, so every rank calls this; rank 0 writes)
            leaves, _ = _mesh.all_gather_leaves(tree_leaves(state.history),
                                                self.group)
            hist_state = state._replace(
                history=tree_unflatten(state.history, leaves))
        extra = {
            "cursor": cursor,
            "workers": export_worker_history(hist_state),
            "solver": {"loss_window": self.solver.export_loss_window()},
        }
        comm_state = self.export_comm_state()
        if comm_state is not None:
            extra["comm"] = comm_state
        return extra

    def resume_newest(self, prefix: str, tau: int, metrics=None):
        """Resume from the newest snapshot under ``prefix`` that verifies
        (``io/checkpoint.restore_newest_valid``: corrupt ones are
        quarantined).  Returns ``(state, start_round, state_path,
        job_state)``; state None when there is no snapshot."""
        from sparknet_tpu_torch.io import checkpoint

        try:
            st, used = checkpoint.restore_newest_valid(
                self.solver, prefix, metrics=metrics)
        except FileNotFoundError:
            return None, 0, None, {}
        state, start_round, js = self.resume_from(st, used, None, tau)
        return state, start_round, used, js

    def resume_from(self, st: TrainState, used: str, js, tau: int):
        """Broadcast a restored snapshot's consensus ``st``, then put back
        what ``export_job_state`` saved in its jobstate ``js`` (read from
        ``used`` when None).  Returns ``(state, start_round, job_state)``,
        start_round being ``iter // tau``."""
        from sparknet_tpu_torch.io import checkpoint

        state = self.broadcast_state(st)  # resets the comm plane
        if js is None:
            js = checkpoint.load_job_state(used)
        js = js or {}
        if "comm" in js:
            self.restore_comm_state(js["comm"])
        if "workers" in js:
            # the consensus snapshot carries worker 0's history only
            frag = js["workers"]
            if self.group is not None:  # every worker's: keep this rank's
                frag = {"history": {k: np.asarray(v)[self.rows]
                                    for k, v in frag["history"].items()}}
            state = restore_worker_history(state, frag)
        if "loss_window" in js.get("solver", {}):
            self.solver.restore_loss_window(js["solver"]["loss_window"])
        return state, int(st.iter) // max(1, tau), js

    def _place_live(self, live_mask) -> torch.Tensor:
        """The (W,) float32 live mask on the device, cached per value."""
        # sparknet: sync-ok(live_mask is a host 0/1 array, never a device value; placement cached per mask)
        live = np.asarray(live_mask, np.float32).reshape(-1)
        if live.shape[0] != self.num_workers:
            raise ValueError(
                f"live_mask has {live.shape[0]} entries, trainer has "
                f"{self.num_workers} workers"
            )
        key = live.tobytes()
        cached = self._live_cache.get(key)
        if cached is not None:
            self._live_cache.move_to_end(key)
            return cached
        placed = torch.from_numpy(live.copy()).to(self.device)
        while len(self._live_cache) >= self._LIVE_CACHE_MAX:
            self._live_cache.popitem(last=False)
        self._live_cache[key] = placed
        return placed

    def reset_comm_state(self) -> None:
        """Drop carried comm state (a fresh run on a reused trainer)."""
        if self._comm is not None:
            self._comm.reset()

    def _local(self, state: TrainState, batches: Dict[str, torch.Tensor],
                run=None):
        """Every worker's local steps, no averaging: ``batches[blob]`` is
        (W, steps, ...).  Returns ``(state, losses (W, steps), stats)``,
        ``stats`` the audit's tree (leaves (W, steps)) or None.  Worker
        ``w`` steps under ``fold_in(train_key(0), w)``, as the JAX round
        folds its worker index into ``default_train_key(0)``, so stacked
        workers draw independently.  ``run`` (W bools, None = all) names
        the workers whose windows run: the others keep their state, and
        their losses and audit rows read 0."""
        root = rngs.train_key(0)
        # --profile: a CUDA event pair around each worker's window (an
        # overlapped round runs each window in two pieces: one timer)
        timer = self._window_timer or _profile.worker_window_timer(
            self.device, self.local_workers)
        self._window_timer = timer
        with span("execute"):
            outs, losses, packed = [], [], []
            for i in range(self.local_workers):
                w = self.rows.start + i  # the global worker index
                if run is not None and not run[w]:
                    outs.append(worker_state(state, i))
                    losses.append(None)
                    packed.append(None)
                    continue
                if timer is not None:
                    timer.start(i)
                st, l, pk = self.solver._run_tau(
                    worker_state(state, i), {k: v[i] for k, v in batches.items()},
                    rngs.fold_in(root, w),
                )
                if timer is not None:
                    timer.stop(i)
                outs.append(st)
                losses.append(l)
                packed.append(pk)
            ran = next((i for i, l in enumerate(losses) if l is not None),
                       None)
            if ran is not None:
                zl = torch.zeros_like(losses[ran])
                if packed[ran] is not None:
                    self._idle_packed = torch.zeros_like(packed[ran])
            else:
                # across processes every worker of this rank may sit out
                # a boundary: its rows read 0, shaped like a window's
                tau = int(next(iter(batches.values())).shape[1])
                zl = torch.zeros((tau,), dtype=torch.float32,
                                 device=self.device)
            losses = [zl if l is None else l for l in losses]
            stats = None
            if self.solver.audit:
                zp = self._idle_packed
                if zp is None:
                    raise RuntimeError(
                        "no worker of this process has run a window yet: "
                        "the audit rows of the idle ones have no shape")
                packed = [zp if p is None else p for p in packed]
                stats = _health.unpack(torch.stack(packed),
                                       self.solver.audit_groups())
            return stack_states(outs), torch.stack(losses), stats

    def _mask(self, live: torch.Tensor, stats):
        """``(alive, bad)`` of this process's workers: the in-round mask
        folds each worker's non-finite verdict (a device tensor) into
        its rows of the (W,) ``live``; ``bad`` is None with the audit
        off."""
        live = live[self.rows]
        if not self.solver.audit:
            return live, None
        bad = _health.bad_workers(stats)
        ok = torch.where(bad, 0.0, 1.0).to(live.dtype)
        stats["masked"] = 1.0 - ok
        return live * ok, bad

    def _average(self, state: TrainState, alive: torch.Tensor,
                 bad=None) -> TrainState:
        """The fused round's epilogue: a masked mean of params and stats
        over alive workers, written to every slot; history stays local.
        With the audit on (``bad`` given) a round with no finite
        worker keeps each one's own params, and a masked worker that
        rejoins the mean gets its history zeroed.  Across processes
        ``alive`` and ``bad`` are this process's rows: the mean runs
        over the gathered stack and lands on them."""
        leaves = tree_leaves(state.params) + tree_leaves(state.stats)
        full = leaves
        if self.group is not None:
            alive = _mesh.all_gather_rows(alive, self.group)
            full, nbytes = _mesh.all_gather_leaves(leaves, self.group)
            self.last_group_bytes += nbytes
        denom0 = alive.sum()
        denom = torch.clamp_min(denom0, 1.0)

        def wmean(x_full, x):
            m = masked_mean(x_full, alive, denom)
            m = m.unsqueeze(0).expand_as(x)
            if bad is not None:
                return torch.where(denom0 > 0, m, x)
            return m.contiguous()

        out = [wmean(a, b) for a, b in zip(full, leaves)]
        n = len(tree_leaves(state.params))
        history = state.history
        if bad is not None:
            history = zero_rows(history, bad & (denom0 > 0))
        return TrainState(tree_unflatten(state.params, out[:n]),
                          tree_unflatten(state.stats, out[n:]), history,
                          state.iter)

    def _slice_average(self, state: TrainState, alive: torch.Tensor,
                       bad=None) -> TrainState:
        """The intra-slice epilogue: each slice's masked mean over its own
        alive workers, written to that slice's slots; a slice with no
        alive worker keeps its params (the JAX intra-slice program).
        ``alive`` and ``bad`` are this process's rows.  A slice whose
        workers span processes gathers its rows over its group (each
        process's rows of it, padded to the largest count so the shapes
        agree) and runs the same masked mean over the slice's rows in
        worker order, which gives the stacked run's bits;
        ``last_group_bytes`` counts what reached this rank."""
        dev = alive.device
        params = tree_leaves(state.params)
        leaves = params + tree_leaves(state.stats)
        out = [x.clone() for x in leaves]
        have = torch.zeros((self.local_workers,), dtype=torch.bool,
                           device=dev)
        for sg, (idx, keep) in zip(self._slice_groups,
                                   self._slice_places(dev)):
            if not sg.local:
                continue
            xs = [x.index_select(0, idx) for x in leaves]
            a = alive.index_select(0, idx)
            mine = xs
            if sg.group is not None:
                *xs, a = self._gather_slice(sg, keep, xs + [a])
            denom0 = a.sum()
            denom = torch.clamp_min(denom0, 1.0)
            for y, x, own in zip(out, xs, mine):
                m = masked_mean(x, a, denom).unsqueeze(0).expand_as(own)
                y.index_copy_(0, idx, torch.where(denom0 > 0, m, own))
            have.index_copy_(0, idx, (denom0 > 0).expand(len(sg.local)))
        history = state.history
        if bad is not None:
            history = zero_rows(history, bad & have)
        n = len(params)
        return TrainState(tree_unflatten(state.params, out[:n]),
                          tree_unflatten(state.stats, out[n:]), history,
                          state.iter)

    def _slice_places(self, dev):
        """``(local rows, gathered rows kept)`` for each slice: this
        process's rows of it, and which rows of its group's padded
        gather are real (None for a slice one process holds); placed
        once, so a round copies nothing."""
        if self._slice_index is None:
            self._slice_index = [
                (torch.tensor(sg.local, device=dev),
                 None if sg.group is None else torch.tensor(
                     [i * max(sg.counts) + j for i, c in enumerate(sg.counts)
                      for j in range(c)], device=dev))
                for sg in self._slice_groups]
        return self._slice_index

    def _gather_slice(self, sg, keep, xs):
        """The slice's rows of every process of its group, in worker
        order: ``xs`` (this rank's rows of each leaf) padded to the
        group's largest count, gathered as one buffer, then cut back to
        each process's own count (``keep``)."""
        pad = max(sg.counts) - len(sg.local)
        if pad:
            xs = [torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
                  for x in xs]
        full, nbytes = _mesh.all_gather_leaves(list(xs), sg.group)
        self.last_group_bytes += nbytes
        return [f.index_select(0, keep) for f in full]

    def round(
        self,
        state: TrainState,
        batches: Dict[str, torch.Tensor],
        live_mask=None,
        round_index: Optional[int] = None,
    ):
        """One averaging round: ``batches[blob]`` is (W, tau, ...) on the
        device, worker-major.  Returns ``(state, losses (W, tau))``, or
        ``(state, losses, stats)`` with the audit on (leaves (W, tau),
        plus ``masked`` (W,), the workers the in-round mask took out).

        ``live_mask`` (W,) of 0/1 marks the workers that survive this
        round: dead workers are excluded from the mean and receive it.
        ``round_index`` is the absolute round, which decides the two-tier
        schedule's tier (the trainer counts its own calls when none is
        given)."""
        r = self._auto_round if round_index is None else round_index
        self._auto_round = r + 1
        intra = self._two_tier and not self.hierarchy.is_cross_round(r)
        if live_mask is None:
            live_mask = np.ones((self.num_workers,), np.float32)
        stats = None
        self.last_group_bytes = 0
        with span("average"):
            live = self._place_live(live_mask)
            if intra:
                # an overlapped cross-slice average in flight lands at
                # this boundary, before the slice-local mean
                if self._comm is not None:
                    state = self._comm.finalize(state)
                state, losses, stats = self._local(state, batches)
                alive, bad = self._mask(live, stats)
                state = self._slice_average(state, alive, bad)
            elif self._comm is not None:
                state, losses, stats = self._comm.round(
                    state, batches, live, live_mask, self._mask)
            else:
                state, losses, stats = self._local(state, batches)
                alive, bad = self._mask(live, stats)
                state = self._average(state, alive, bad)
            if self.group is not None:
                # every rank reads every worker's losses and audit rows,
                # as the one-process run does
                losses = _mesh.all_gather_rows(losses, self.group)
                if stats is not None:
                    stats = gather_rows(stats, self.group)
            if self.metrics is not None and (intra or self._comm is None):
                self.metrics.collective_bytes.labels("none").inc(
                    self.last_group_bytes if self.group is not None
                    else self._payload_bytes(state)
                )
            if self.metrics is not None and self.hierarchy is not None:
                tier = "intra" if intra else "cross"
                payload = self._payload_bytes(state)
                if not intra and self._comm is not None:
                    payload = self._comm.payload_bytes_per_round or payload
                if self.group is not None:  # what crossed to this rank
                    payload = (self._comm.last_group_bytes
                               if not intra and self._comm is not None
                               else self.last_group_bytes)
                self.metrics.hierarchy_rounds.labels(tier).inc()
                self.metrics.hierarchy_bytes.labels(tier).inc(payload)
            # recorded lazily: smoothed_loss pulls the losses on read
            self.solver.note_losses(losses)
        if self.metrics is not None:
            self.metrics.rounds.inc()
            self.metrics.iters.inc(losses.shape[-1])
        self._observe_profile(losses, state)
        obs.report_healthy()
        if self.solver.audit:
            return state, losses, stats
        return state, losses

    def _observe_profile(self, losses, state) -> None:
        """--profile: the modeled work once, then the round's record
        (outside the average span, so the timer's wait never inflates
        it)."""
        timer, self._window_timer = self._window_timer, None
        prof = _profile.active()
        if prof is None:
            return
        _profile.note_trainer_work(prof, self, int(losses.shape[-1]), state)
        prof.observe_round(losses, worker_timer=timer, group=self.group)

    def _payload_bytes(self, state) -> int:
        if self._fused_payload_bytes is None:
            from sparknet_tpu_torch.parallel import comm as _comm

            self._fused_payload_bytes = _comm.fused_round_payload_bytes(state)
        return self._fused_payload_bytes

    def finalize(self, state: TrainState) -> TrainState:
        """Land any in-flight overlapped average into ``state``: call
        before an eval and at the end of training."""
        if self._comm is not None:
            return self._comm.finalize(state)
        return state

    @torch.no_grad()
    def test_and_store_result(self, state: TrainState,
                              batches: Dict[str, torch.Tensor],
                              counts=None) -> Dict[str, float]:
        """Distributed eval: ``batches[blob]`` is (W, nb, ...) — this
        process's workers' rows across processes; the scores summed over
        every worker's first ``counts[w]`` batches (the reference's
        per-partition full pass, CifarApp.scala:103-115).  ``counts``
        is (W,) or this process's rows of it; across processes every
        worker's scores are gathered and summed in worker order, as the
        one-process run sums them."""
        nb = next(iter(batches.values())).shape[1]
        if counts is None:
            counts = np.full((self.local_workers,), nb, np.int64)
        counts = np.asarray(counts)
        if counts.shape[0] == self.num_workers:
            counts = counts[self.rows]
        per_worker = []
        for i in range(self.local_workers):
            st = worker_state(state, i)
            per_worker.append(self.solver._forward_test(
                st.params, st.stats, {k: v[i] for k, v in batches.items()},
                count=int(counts[i]),
            ))
        if self.group is not None:
            keys = sorted(per_worker[0])
            rows = torch.stack([torch.stack([torch.as_tensor(
                s[k], dtype=torch.float32, device=self.device) for k in keys])
                for s in per_worker])
            rows = _mesh.all_gather_rows(rows, self.group)
            per_worker = [dict(zip(keys, r.unbind(0))) for r in rows.unbind(0)]
        total: Dict[str, torch.Tensor] = {}
        for scores in per_worker:
            for k, v in scores.items():
                total[k] = v if k not in total else total[k] + v
        return {k: float(v) for k, v in total.items()}

    @staticmethod
    def pad_partitions(parts):
        """Stack per-worker {blob: (nb_w, ...)} dicts of unequal nb_w into
        ({blob: (N, nb_max, ...)} zero-padded, counts (N,)) for
        ``test_and_store_result`` — the pad-and-mask layout."""
        keys = parts[0].keys()
        counts = np.array(
            [len(next(iter(p.values()))) for p in parts], np.int32
        )
        nb_max = int(counts.max())
        stacked = {}
        for k in keys:
            ref = parts[0][k]
            out = np.zeros((len(parts), nb_max) + ref.shape[1:], ref.dtype)
            for w, p in enumerate(parts):
                out[w, : len(p[k])] = p[k]
            stacked[k] = out
        return stacked, counts


def restore_newest_agreed(solver, prefix: str, group=None, metrics=None):
    """``(state, used)``: the newest snapshot under ``prefix`` that
    verifies (``io/checkpoint.restore_newest_valid``), chosen by the
    group's rank 0 alone — the scan quarantines corrupt files, so one
    rank makes it — and restored from that path on every other rank;
    ``FileNotFoundError`` on every rank when there is none."""
    from sparknet_tpu_torch.io import checkpoint

    held = {}

    def newest():
        held["state"], used = checkpoint.restore_newest_valid(
            solver, prefix, metrics=metrics)
        return used

    if group is None:
        used = newest()
    else:
        used = _mesh.on_rank0(newest, group)
    st = held.get("state")
    if st is None:
        st = checkpoint.restore(solver, used, metrics=metrics)
    return st, used


class AllReduceTrainer:
    """Synchronous gradient all-reduce data parallelism on the global batch
    (Caffe's P2PSync, ``caffe train --gpu=0,..,N-1``): the port of JAX
    ``AllReduceTrainer`` (``sparknet_tpu/parallel/trainers.py:944``).

    The JAX trainer jits the solver's window over a dp mesh with the
    batch sharded on its dim 1, so each step is the step of the global
    batch.  Here each process of the mesh's ``dp_axis`` group holds
    its block of the global batch's rows (``local_rows``): the solver's
    ``batch_shard`` (``utils/dp.py``) makes BatchNorm, dropout, the crop
    and mirror draws and every loss normalizer global, and its
    ``grad_groups`` sum the grads over the group each iteration, so
    every rank holds the same bits after every iteration.  In one
    process (no mesh, or a dp axis inside it) ``step`` is ``solver.step``
    on the whole global batch, which is what GSPMD computes; a group of
    one rank (NCCL at world size 1) sums over itself, to the bit.
    ``mp_axis`` (the tensor-parallel placement) is not yet ported.

    The trainer sets the solver's ``grad_groups`` and ``batch_shard``:
    the solver belongs to it from then on."""

    def __init__(self, solver: Solver, mesh=None, dp_axis: str = "dp",
                 mp_axis: Optional[str] = None):
        if mp_axis is not None:
            raise NotImplementedError(
                "AllReduceTrainer(mp_axis=...): the tensor-parallel placement "
                "(large blobs' output channels over mp, with activation "
                "collectives) is not yet ported to sparknet_tpu_torch")
        self.solver = solver
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.group = None
        self.parts, self.index = 1, 0
        if mesh is not None:
            if dp_axis not in mesh.shape:
                raise ValueError(f"dp_axis {dp_axis!r} is not a mesh axis "
                                 f"{mesh.axis_names}")
            self.group = mesh.group(dp_axis)
        if self.group is not None:
            import torch.distributed as dist

            n, me = dist.get_world_size(self.group), dist.get_rank(self.group)
            mine = mesh.coords[dp_axis]
            m = mine.stop - mine.start
            if n * m != mesh.shape[dp_axis] or mine.start != me * m:
                raise ValueError(
                    f"AllReduceTrainer: process {mesh.process_index} holds "
                    f"slots {mine.start}..{mine.stop - 1} of the "
                    f"{mesh.shape[dp_axis]}-way {dp_axis!r} axis, not an "
                    f"equal block in rank order of its {n}-process group")
            self.parts, self.index = n, me
            solver.grad_groups = (self.group,)
            solver.batch_shard = (dp.BatchShard(self.group, n, me) if n > 1
                                  else None)

    @property
    def is_root(self) -> bool:
        """Whether this rank writes for the group (snapshots, logs)."""
        return self.index == 0

    def local_rows(self, batches):
        """This rank's rows of a ``(tau, global_B, ...)`` window (the JAX
        trainer's ``batch_sharding``): the ``index``-th of ``parts``
        equal blocks of dim 1, views of numpy arrays or tensors."""
        if self.parts == 1:
            return batches
        out = {}
        for k, v in batches.items():
            g = v.shape[1]
            if g % self.parts:
                raise ValueError(
                    f"AllReduceTrainer: {k!r} has a global batch of {g}, "
                    f"not divisible over {self.parts} data-parallel ranks")
            b = g // self.parts
            out[k] = v[:, self.index * b:(self.index + 1) * b]
        return out

    def init_state(self, seed: int = 0) -> TrainState:
        """The solver's seeded init, the same on every rank (host draws),
        placed as ``shard_state`` places a state."""
        return self.shard_state(self.solver.init_state(seed))

    def shard_state(self, state: TrainState) -> TrainState:
        """A single-replica state on the solver's device, replicated from
        the group's rank 0 — the resume and warm-start entry
        (``Solver::Restore`` before ``P2PSync::Run``)."""
        dev = self.solver.device

        def place(x):
            x = torch.as_tensor(x)
            return x if x.dtype == torch.int64 else x.to(dev)

        state = TrainState(*(tree_map(place, f) for f in state))
        if self.group is None:
            return state
        leaves = tree_leaves(state)
        return tree_unflatten(state, _mesh.broadcast_leaves(leaves, self.group))

    def step(self, state: TrainState, batches, rng=None):
        """tau synchronous steps on the global batch (``batches[blob]``:
        ``(tau, global_B, ...)``); returns ``(state, losses)``, or
        ``(state, losses, stats)`` with the solver's audit on.  The
        losses (and the audit's stats) are the global batch's, the same
        bits on every rank."""
        return self.step_rows(state, self.local_rows(batches), rng)

    def step_rows(self, state: TrainState, rows, rng=None):
        """``step`` on a window already cut to this rank's rows
        (``local_rows``): the feed that copies only its own rows to the
        device calls this."""
        solver = self.solver
        rng = rngs.train_key(0) if rng is None else rng
        if solver.param.debug_info:
            solver.debug_info_pass(state, {k: v[0] for k, v in rows.items()},
                                   rng=rng)
        # --profile: this rank's window timed, one worker a rank
        timer = _profile.worker_window_timer(solver.device, 1)
        with span("execute"):
            if timer is not None:
                timer.start(0)
            out = solver._step_tau(state, solver._to_device(rows), rng)
            if timer is not None:
                timer.stop(0)
            solver.note_losses(out[1])
        tm = obs.training_metrics()
        if tm is not None:
            tm.rounds.inc()
            tm.iters.inc(int(out[1].shape[0]))
        prof = _profile.active()
        if prof is not None:
            # every rank's window time in one table (JAX trainers.py:1052)
            prof.observe_round(out[1], worker_timer=timer, group=self.group)
        obs.report_healthy()
        return out

    @property
    def rows_stepper(self):
        """An object whose ``step`` is ``step_rows``: what a window loop
        (or the sentry's ``guarded_step``) drives when its feed copies
        only this rank's rows."""
        return types.SimpleNamespace(step=self.step_rows)

    def restore_newest(self, prefix: str, metrics=None):
        """``(state, used)``: the newest snapshot under ``prefix`` that
        verifies, chosen by the group's rank 0 (the scan quarantines
        corrupt files, so one rank makes it), restored on every rank and
        replicated from rank 0; raises ``FileNotFoundError`` on every
        rank when there is none."""
        st, used = restore_newest_agreed(self.solver, prefix, self.group,
                                         metrics=metrics)
        return self.shard_state(st), used
