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
``overlap_avg`` engage the comm plane (``parallel/comm.py``).  Data
parallelism across cards over NCCL, the two-tier hierarchy and the
numerics audit are not ported here (ROADMAP).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.solver import Solver, TrainState
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def worker_state(state: TrainState, w: int) -> TrainState:
    """Worker ``w``'s slice of a worker-stacked state (views, no copy)."""
    return TrainState(*(tree_map(lambda x: x[w], f) for f in state))


def stack_states(states: List[TrainState]) -> TrainState:
    """The inverse of ``worker_state`` over all workers."""
    cols = [tree_leaves(s) for s in states]
    stacked = [torch.stack(xs) for xs in zip(*cols)]
    return tree_unflatten(states[0], stacked)


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
    ):
        """Params and stat blobs are averaged; ``metrics`` receives the
        training series (rounds, iters, collective bytes, the comm plane's
        kernel launches and quantization error); None records nothing."""
        from sparknet_tpu_torch.parallel import comm as _comm

        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if compress not in _comm.COMPRESS_MODES:
            raise ValueError(
                f"compress={compress!r}: expected one of {_comm.COMPRESS_MODES}"
            )
        self.solver = solver
        self.device = solver.device
        self.num_workers = int(num_workers)
        self.compress = compress
        self.metrics = metrics
        self._comm = None
        if compress != "none" or overlap_avg:
            self._comm = _comm.CommPlane(
                self._local, compress=compress, overlap=overlap_avg,
                metrics=metrics,
            )
        self._fused_payload_bytes: Optional[int] = None
        self._live_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()

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

    def _local(self, state: TrainState, batches: Dict[str, torch.Tensor]):
        """Every worker's local steps, no averaging: ``batches[blob]`` is
        (W, steps, ...).  Returns ``(state, losses (W, steps))``."""
        with span("execute"):
            outs, losses = [], []
            for w in range(self.num_workers):
                st, l = self.solver._step_tau(
                    worker_state(state, w), {k: v[w] for k, v in batches.items()}
                )
                outs.append(st)
                losses.append(l)
            return stack_states(outs), torch.stack(losses)

    def _average(self, state: TrainState, live: torch.Tensor) -> TrainState:
        """The fused round's epilogue: a masked mean of params and stats
        over live workers, written to every slot; history stays local."""
        denom0 = live.sum()
        denom = torch.clamp_min(denom0, 1.0)

        def wmean(x):
            m = masked_mean(x, live, denom)
            return m.unsqueeze(0).expand_as(x).contiguous()

        return TrainState(tree_map(wmean, state.params),
                          tree_map(wmean, state.stats), state.history, state.iter)

    def round(
        self,
        state: TrainState,
        batches: Dict[str, torch.Tensor],
        live_mask=None,
        round_index: Optional[int] = None,
    ):
        """One averaging round: ``batches[blob]`` is (W, tau, ...) on the
        device, worker-major.  Returns ``(state, losses (W, tau))``.

        ``live_mask`` (W,) of 0/1 marks the workers that survive this
        round: dead workers are excluded from the mean and receive it.
        ``round_index`` is accepted for the JAX signature (it drives the
        two-tier schedule there, which is not ported)."""
        del round_index
        if live_mask is None:
            live_mask = np.ones((self.num_workers,), np.float32)
        with span("average"):
            live = self._place_live(live_mask)
            if self._comm is not None:
                state, losses = self._comm.round(state, batches, live, live_mask)
            else:
                state, losses = self._local(state, batches)
                state = self._average(state, live)
                if self.metrics is not None:
                    self.metrics.collective_bytes.labels("none").inc(
                        self._payload_bytes(state)
                    )
            # recorded lazily: smoothed_loss pulls the losses on read
            self.solver.note_losses(losses)
        if self.metrics is not None:
            self.metrics.rounds.inc()
            self.metrics.iters.inc(losses.shape[-1])
        return state, losses

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
