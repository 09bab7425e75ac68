"""SparkNet's parameter-averaging trainer, with the W workers on one device.

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
averages each slice's live workers only (a masked mean per slice
group, no comm kernel), a cross round is the global round above.
Data parallelism across cards over NCCL is not ported (ROADMAP).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.obs import health as _health
from sparknet_tpu_torch.obs import profile as _profile
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
from sparknet_tpu_torch.solver import Solver, TrainState
from sparknet_tpu_torch.utils import rngs
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
    ):
        """Params and stat blobs are averaged; ``metrics`` receives the
        training series (rounds, iters, collective bytes, the comm plane's
        kernel launches and quantization error, the hierarchy's tiers);
        None records nothing.  The solver's audit arms the in-round
        worker mask; ``hierarchy`` is the two-tier schedule (a flat spec
        is bit-identical to none)."""
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
        self.compress = compress
        self.metrics = metrics
        self.hierarchy = hierarchy
        self._two_tier = hierarchy is not None and not hierarchy.is_flat()
        # the schedule's round counter when round() gets no round_index
        self._auto_round = 0
        self._slice_index = None  # (per-slice indices, slice ids, inverse)
        self._comm = None
        if compress != "none" or overlap_avg:
            self._comm = _comm.CommPlane(
                self._local, compress=compress, overlap=overlap_avg,
                metrics=metrics,
            )
        self._fused_payload_bytes: Optional[int] = None
        self._live_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        # the round's per-worker execute timer (--profile only)
        self._window_timer = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """All workers start from identical weights (the initial broadcast,
        CifarApp.scala:92-97), stacked on axis 0."""
        return self.broadcast_state(self.solver.init_state(seed))

    def broadcast_state(self, st: TrainState) -> TrainState:
        """Place a single-replica TrainState on every worker slot (an
        init, or weights carried in) on the solver's device; resets the
        comm plane's carried state."""
        if self._comm is not None:
            self._comm.reset()
        n = self.num_workers

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
        the loss window and, on the comm plane, its residuals."""
        extra = {
            "cursor": cursor,
            "workers": export_worker_history(state),
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
            state = restore_worker_history(state, js["workers"])
        if "loss_window" in js.get("solver", {}):
            self.solver.restore_loss_window(js["solver"]["loss_window"])
        return state, int(st.iter) // max(1, tau), js

    def _place_live(self, live_mask) -> torch.Tensor:
        """The (W,) float32 live mask on the device, cached per value."""
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
            self.device, self.num_workers)
        self._window_timer = timer
        with span("execute"):
            outs, losses, packed = [], [], []
            for w in range(self.num_workers):
                if run is not None and not run[w]:
                    outs.append(worker_state(state, w))
                    losses.append(None)
                    packed.append(None)
                    continue
                if timer is not None:
                    timer.start(w)
                st, l, pk = self.solver._run_tau(
                    worker_state(state, w), {k: v[w] for k, v in batches.items()},
                    rngs.fold_in(root, w),
                )
                if timer is not None:
                    timer.stop(w)
                outs.append(st)
                losses.append(l)
                packed.append(pk)
            ran = next(i for i, l in enumerate(losses) if l is not None)
            losses = [torch.zeros_like(losses[ran]) if l is None else l
                      for l in losses]
            stats = None
            if self.solver.audit:
                packed = [torch.zeros_like(packed[ran]) if p is None else p
                          for p in packed]
                stats = _health.unpack(torch.stack(packed),
                                       self.solver.audit_groups())
            return stack_states(outs), torch.stack(losses), stats

    def _mask(self, live: torch.Tensor, stats):
        """``(alive, bad)``: the in-round mask folds each worker's
        non-finite verdict (a (W,) device tensor) into ``live``; ``bad``
        is None with the audit off."""
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
        rejoins the mean gets its history zeroed."""
        denom0 = alive.sum()
        denom = torch.clamp_min(denom0, 1.0)

        def wmean(x):
            m = masked_mean(x, alive, denom)
            m = m.unsqueeze(0).expand_as(x)
            if bad is not None:
                return torch.where(denom0 > 0, m, x)
            return m.contiguous()

        history = state.history
        if bad is not None:
            history = zero_rows(history, bad & (denom0 > 0))
        return TrainState(tree_map(wmean, state.params),
                          tree_map(wmean, state.stats), history, state.iter)

    def _slice_average(self, state: TrainState, alive: torch.Tensor,
                       bad=None) -> TrainState:
        """The intra-slice epilogue: each slice's masked mean over its own
        alive workers, written to that slice's slots; a slice with no
        alive worker keeps its params (the JAX intra-slice program)."""
        if self._slice_index is None:  # placed once: no copy a round
            dev = alive.device
            order = [w for members in self.hierarchy.slices for w in members]
            self._slice_index = (
                [torch.tensor(m, device=dev) for m in self.hierarchy.slices],
                torch.tensor(self.hierarchy.slice_ids(), device=dev),
                None if order == list(range(self.num_workers))
                else torch.tensor(np.argsort(order), device=dev),
            )
        slice_idx, sid, inv = self._slice_index
        groups, d0s = [], []
        for idx in slice_idx:
            a = alive.index_select(0, idx)
            denom0 = a.sum()
            groups.append((idx, a, denom0, torch.clamp_min(denom0, 1.0)))
            d0s.append(denom0)

        def smean(x):
            parts = []
            for idx, a, denom0, denom in groups:
                xs = x.index_select(0, idx)
                m = masked_mean(xs, a, denom).unsqueeze(0).expand_as(xs)
                parts.append(torch.where(denom0 > 0, m, xs))
            y = torch.cat(parts)
            return y if inv is None else y.index_select(0, inv)

        history = state.history
        if bad is not None:
            have = torch.stack(d0s).index_select(0, sid) > 0
            history = zero_rows(history, bad & have)
        return TrainState(tree_map(smean, state.params),
                          tree_map(smean, state.stats), history, state.iter)

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
        r = self._auto_round if round_index is None else int(round_index)
        self._auto_round = r + 1
        intra = self._two_tier and not self.hierarchy.is_cross_round(r)
        if live_mask is None:
            live_mask = np.ones((self.num_workers,), np.float32)
        stats = None
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
            if self.metrics is not None and (intra or self._comm is None):
                self.metrics.collective_bytes.labels("none").inc(
                    self._payload_bytes(state)
                )
            if self.metrics is not None and self.hierarchy is not None:
                tier = "intra" if intra else "cross"
                payload = self._payload_bytes(state)
                if not intra and self._comm is not None:
                    payload = self._comm.payload_bytes_per_round or payload
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
        prof.observe_round(losses, worker_timer=timer)

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
        """Distributed eval: ``batches[blob]`` is (W, nb, ...); the scores
        summed over every worker's first ``counts[w]`` batches (the
        reference's per-partition full pass, CifarApp.scala:103-115)."""
        nb = next(iter(batches.values())).shape[1]
        if counts is None:
            counts = np.full((self.num_workers,), nb, np.int64)
        total: Dict[str, torch.Tensor] = {}
        for w in range(self.num_workers):
            st = worker_state(state, w)
            scores = self.solver._forward_test(
                st.params, st.stats, {k: v[w] for k, v in batches.items()},
                count=int(counts[w]),
            )
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
