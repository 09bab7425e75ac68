"""Communication-efficient parameter averaging: the comm plane.

The port of ``CommPlane`` (``sparknet_tpu/parallel/comm.py:158``), with
the workers stacked on one device:

1. **Delta quantization.**  Workers average bf16/int8-quantized deltas
   from the round-start params (``theta_end - theta_0``), with a
   per-worker error-feedback residual carrying the quantization error
   into the next round's delta (the EF-SGD contract).
2. **Chunked collectives.**  The param leaves (``jax.tree_util`` order:
   layers sorted by name) are split into ``DEFAULT_CHUNKS`` byte-balanced
   groups; encode, mean and apply run per chunk.
3. **Overlap with the next round's compute.**  With ``overlap=True``
   round r's chunk means are paced on a comm thread while the first
   ``DEFAULT_OVERLAP_STEPS`` local steps of round r+1 run; then every
   worker adds the correction ``mean(delta) - dequant(own delta)`` to
   its params and anchor.  The comm thread waits on a CUDA event where the JAX package
   calls ``block_until_ready``; it launches nothing.

The three epilogue programs per chunk — encode (K9), barriered apply
(K10), overlap correction (K11) — are the kernels of
``ops/cuda_comm.py``: CUDA tensors always take the kernels, CPU tensors
their plain versions.  The mean over workers is plain PyTorch, as it was
plain XLA.  Masking: a dead worker (``live == 0``) contributes exactly
zero to every chunk through ``where()``, its slot receives ``anchor +
mean``, and its residual resets; a round with a dead worker takes the
barriered apply even when overlap is on.

Bytes accounting (``sparknet_collective_bytes_total``): a ring all-reduce
moves about twice the payload per worker, so each round charges ``2 x``
the compressed payload (int8 = 1 B/elem + one f32 scale per tensor,
bf16 = 2 B/elem, fp32 = 4 B/elem).  With the workers on one card the
mean is a local reduction; the counter models what an interconnect
would carry.  ``SPARKNET_COMM_COST_MS_PER_MB`` adds a modeled wire time
(a sleep per chunk) for A/B runs.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.ops import cuda_comm
from sparknet_tpu_torch.solver import TrainState
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_unflatten

# CLI-facing compression modes; "fp32" is additionally accepted by the
# trainer for tests that want the comm-plane structure (chunked delta
# averaging) with an uncompressed payload
CLI_COMPRESS_MODES = ("none", "bf16", "int8")
COMPRESS_MODES = ("none", "fp32", "bf16", "int8")

DEFAULT_CHUNKS = 4
DEFAULT_OVERLAP_STEPS = 1

# The bit-accuracy band of the JAX package (parallel/comm.py:95): over
# the same-seed A/B protocol the final smoothed loss of a bf16/int8
# delta-averaged run lands within this absolute band of the fp32 run's.
LOSS_BAND = 0.08

_ELEM_NBYTES = {"fp32": 4, "none": 4, "bf16": 2, "int8": 1}
# ring all-reduce moves ~2x(N-1)/N x payload per worker; charge 2x
_RING_FACTOR = 2


def add_cli_args(parser) -> None:
    """``--compress {none,bf16,int8}`` / ``--overlap_avg``."""
    parser.add_argument(
        "--compress", choices=CLI_COMPRESS_MODES, default="none",
        help="delta-quantized parameter averaging: workers average "
        "bf16/int8 deltas from the round-start params (error-feedback "
        "residual carried per worker); 'none' keeps the fp32 averaging "
        "round",
    )
    parser.add_argument(
        "--overlap_avg", action="store_true",
        help="overlap the averaging with the next round's first local "
        "step (chunk means paced on a comm thread; the overlapped step "
        "runs one average stale)",
    )


def _cost_ms_per_mb_default() -> float:
    try:
        return float(os.environ.get("SPARKNET_COMM_COST_MS_PER_MB", "0"))
    except ValueError:
        return 0.0


def _per_worker_nbytes(leaf, mode: str) -> int:
    """Modeled payload bytes one worker contributes for a worker-stacked
    leaf: compressed elements plus int8's per-tensor f32 scale."""
    nb = int(np.prod(tuple(leaf.shape[1:]), dtype=np.int64)) * _ELEM_NBYTES[mode]
    if mode == "int8":
        nb += 4
    return nb


def fused_round_payload_bytes(state: TrainState) -> int:
    """Modeled per-round bytes of the fp32 averaging round (params +
    stats, ring factor applied)."""
    leaves = tree_leaves(state.params) + tree_leaves(state.stats)
    return _RING_FACTOR * sum(_per_worker_nbytes(x, "fp32") for x in leaves)


def _dequant(q, scale, mode: str):
    if mode == "int8":
        return q.to(torch.float32) * scale.reshape((-1,) + (1,) * (q.dim() - 1))
    if mode == "bf16":
        return q.to(torch.float32)
    return q


def _record_event(t: torch.Tensor) -> Optional["torch.cuda.Event"]:
    """An event after the work queued so far on ``t``'s stream (None on
    the CPU, where every op has finished when it returns)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class CommPlane:
    """The chunked, delta-quantized, optionally overlapped averaging
    engine behind ``ParameterAveragingTrainer``: params and stat blobs
    in ``DEFAULT_CHUNKS`` chunks, ``DEFAULT_OVERLAP_STEPS`` steps
    overlapped.  ``local`` is the trainer's per-worker step function
    ``(state, batches) -> (state, losses)``."""

    def __init__(
        self,
        local: Callable,
        compress: str = "fp32",
        overlap: bool = False,
        metrics: Optional[TrainingMetrics] = None,
    ):
        if compress not in COMPRESS_MODES:
            raise ValueError(
                f"compress={compress!r}: expected one of {COMPRESS_MODES}"
            )
        # "none" reaching the plane means overlap-only: fp32 payload
        self.compress = "fp32" if compress == "none" else compress
        self.overlap = bool(overlap)
        self.cost_ms_per_mb = _cost_ms_per_mb_default()
        self.metrics = metrics
        self._local = local
        # carried state (device, worker-stacked): the anchor deltas are
        # measured against, the error-feedback residuals, the chunking
        self._anchor: Optional[list] = None
        self._resid: Optional[list] = None
        self._template: Optional[TrainState] = None
        self._nparams = 0
        self._chunk_slices: Optional[List[slice]] = None
        self._modes: List[str] = []
        self._payload_bytes_per_round = 0
        self._pending: Optional[dict] = None  # in-flight overlapped round
        self._pending_err = None  # last round's quant-error readout
        # residuals of a restored job state, consumed by _setup when the
        # first round has not run yet (restore_state)
        self._resid_restore: Optional[list] = None

    # ------------------------------------------------------------------
    def _setup(self, state: TrainState) -> None:
        params_leaves = tree_leaves(state.params)
        stats_leaves = tree_leaves(state.stats)
        self._template = state
        self._nparams = len(params_leaves)
        self._modes = [self.compress] * len(params_leaves) + ["fp32"] * len(stats_leaves)
        leaves = params_leaves + stats_leaves
        # byte-balanced contiguous chunking of the comm leaves
        sizes = [_per_worker_nbytes(x, m) for x, m in zip(leaves, self._modes)]
        total = sum(sizes)
        k = min(DEFAULT_CHUNKS, len(leaves))
        target = total / k if k else total
        slices, start, acc = [], 0, 0
        for i, s in enumerate(sizes):
            acc += s
            if acc >= target and len(slices) < k - 1:
                slices.append(slice(start, i + 1))
                start, acc = i + 1, 0
        slices.append(slice(start, len(leaves)))
        self._chunk_slices = [s for s in slices if s.stop > s.start]
        self._payload_bytes_per_round = _RING_FACTOR * total
        self._resid = [torch.zeros_like(x) for x in leaves]
        if self._resid_restore is not None:
            restored, self._resid_restore = self._resid_restore, None
            self._load_resid(restored)

    @property
    def chunk_slices(self) -> List[slice]:
        return list(self._chunk_slices or ())

    def plan(self, state: TrainState):
        """``(leaves, chunk_slices)``: the comm leaves of ``state`` in
        averaging order and the chunks they are split into (set up on
        first use, as a round does)."""
        if self._chunk_slices is None:
            self._setup(state)
        return self._comm_leaves(state), self.chunk_slices

    @property
    def payload_bytes_per_round(self) -> int:
        return self._payload_bytes_per_round

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def _comm_leaves(self, state: TrainState) -> list:
        return tree_leaves(state.params) + tree_leaves(state.stats)

    def _rebuild(self, state: TrainState, leaves) -> TrainState:
        n = self._nparams
        return TrainState(
            tree_unflatten(self._template.params, leaves[:n]),
            tree_unflatten(self._template.stats, leaves[n:]),
            state.history, state.iter,
        )

    def _count_launches(self, stage: str, leaves) -> None:
        if self.metrics is not None and leaves[0].is_cuda:
            self.metrics.kernel_fused_chunks.labels(stage).inc(
                len(self._chunk_slices)
            )

    # ------------------------------------------------------------------
    # the three epilogue programs, one wrapper call per comm chunk (one
    # kernel launch per MAX_LEAVES leaves of it, ops/cuda_comm.py)
    def _encode_all(self, leaves, with_err: bool):
        qs, scales, new_resids, errs = [], [], [], []
        for sl in self._chunk_slices:
            q, sc, nr, err = cuda_comm.encode(
                leaves[sl], self._anchor[sl], self._resid[sl],
                self._modes[sl], with_err,
            )
            qs.extend(q)
            scales.extend(sc)
            new_resids.extend(nr)
            if with_err:
                errs.append(err)
        self._count_launches("encode", leaves)
        err_out = None
        if with_err:
            allv = torch.stack(errs)  # (chunks, workers, 3)
            err_out = torch.stack([allv[..., 0].amax(), allv[..., 1].sum(),
                                   allv[..., 2].sum()])
        return qs, scales, new_resids, err_out

    def _apply_barriered_all(self, leaves, means, alive, denom0):
        new_leaves, new_resids = [], []
        for sl in self._chunk_slices:
            nl, nr = cuda_comm.apply_barriered(
                leaves[sl], self._anchor[sl], means[sl], self._resid[sl],
                alive, denom0,
            )
            new_leaves.extend(nl)
            new_resids.extend(nr)
        self._count_launches("apply", leaves)
        return new_leaves, new_resids

    def _apply_correction_all(self, leaves, q, scales, means):
        new_leaves, new_anchors = [], []
        for sl in self._chunk_slices:
            nl, na = cuda_comm.apply_correction(
                leaves[sl], self._anchor[sl], q[sl], scales[sl], means[sl],
                self._modes[sl],
            )
            new_leaves.extend(nl)
            new_anchors.extend(na)
        self._count_launches("apply", leaves)
        return new_leaves, new_anchors

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop carried comm state (a restored or broadcast state has no
        valid anchor, residual or in-flight average)."""
        p = self._pending
        if p is not None:
            p["thread"].join()
        self._pending = None
        self._pending_err = None
        self._anchor = None
        self._resid_restore = None  # a stale pre-broadcast restore dies too
        if self._resid is not None:
            self._resid = [torch.zeros_like(r) for r in self._resid]

    def export_state(self) -> Optional[dict]:
        """Host copy of the carried error-feedback residuals — the
        comm-plane half of a full-job-state snapshot (``io/checkpoint``
        ``extra_state``); None before the first round.  A resumed run
        that does not restore them resets the EF bias correction and
        leaves the uninterrupted trajectory.  Call at a round boundary
        with no overlapped average in flight (``finalize()`` first)."""
        if self._resid is None:
            return None
        if self._pending is not None:
            raise RuntimeError(
                "export_state with an overlapped average in flight — "
                "finalize() the round first"
            )
        return {
            "compress": self.compress,
            "resid": {str(i): r.detach().cpu().numpy()
                      for i, r in enumerate(self._resid)},
        }

    def restore_state(self, exported: dict) -> None:
        """Load residuals exported by ``export_state``.  Call AFTER the
        restore path's ``reset()`` (``broadcast_state`` triggers it): place
        the snapshot params, then put the residuals back.  A compress-mode
        or shape mismatch fails loudly."""
        if exported.get("compress") != self.compress:
            raise ValueError(
                "jobstate residuals were recorded under compress=%r, "
                "this plane runs %r" % (exported.get("compress"), self.compress)
            )
        resid = exported["resid"]
        leaves = [np.asarray(resid[str(i)]) for i in range(len(resid))]
        if self._resid is not None:
            self._load_resid(leaves)
        else:
            # the first round has not run: _setup loads these instead of
            # zeros, shape-checked against the real comm leaves there
            self._resid_restore = leaves

    def _load_resid(self, leaves) -> None:
        if len(leaves) != len(self._resid):
            raise ValueError(
                f"jobstate has {len(leaves)} residual leaves, plane "
                f"carries {len(self._resid)}"
            )
        for got, want in zip(leaves, self._resid):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"residual shape {got.shape} != "
                                 f"{tuple(want.shape)}")
        self._resid = [torch.from_numpy(np.array(l, np.float32)).to(w.device)
                       for l, w in zip(leaves, self._resid)]

    def _join_pending(self) -> dict:
        """Wait for the paced chunk means; re-raise comm-thread errors."""
        p = self._pending
        p["thread"].join()
        holder = p["holder"]
        if holder.get("error") is not None:
            self._pending = None
            raise holder["error"]
        return holder

    def _sleep_cost(self, chunk_bytes: int) -> None:
        if self.cost_ms_per_mb > 0:
            time.sleep(self.cost_ms_per_mb * (chunk_bytes / (1 << 20)) / 1e3)

    def _allreduce(self, qs, scales, alive, modes):
        """Masked mean of the dequantized deltas over the worker axis —
        ``where()``, not a multiply, so a dead replica's NaN cannot leak
        through ``0 * NaN``."""
        denom0 = torch.where(alive > 0, 1.0, 0.0).sum()
        denom = torch.clamp_min(denom0, 1.0)
        means = []
        for q, scale, mode in zip(qs, scales, modes):
            dq = _dequant(q, scale, mode)
            am = alive.reshape((-1,) + (1,) * (q.dim() - 1))
            contrib = torch.where(am > 0, dq, torch.zeros_like(dq))
            means.append(contrib.sum(dim=0) / denom)
        return means, denom0

    def _dispatch_chunks(self, q, scales, alive):
        """Queue every chunk's mean from the calling thread, right behind
        this round's encode and before the next round's local steps; an
        event after each chunk lets the comm thread wait for it."""
        outs = []
        denom0 = None
        for sl in self._chunk_slices:
            nbytes = _RING_FACTOR * sum(
                _per_worker_nbytes(x, m)
                for x, m in zip(q[sl], self._modes[sl])
            )
            m, denom0 = self._allreduce(q[sl], scales[sl], alive, self._modes[sl])
            outs.append((sl, m, nbytes, _record_event(alive)))
        return outs, denom0

    def _pace_chunks(self, encoded, outs, denom0, holder) -> None:
        """Pace the modeled wire over the queued chunks (comm thread in
        overlap mode, inline when barriered): each chunk's span covers
        the cost-model sleep plus the wait for its mean."""
        try:
            if encoded is not None:
                encoded.synchronize()  # the wire cannot carry a delta before it exists
            means: list = [None] * sum(sl.stop - sl.start for sl, *_ in outs)
            for sl, m, nbytes, ev in outs:
                with span("allreduce", chunk=sl.start, nbytes=nbytes):
                    self._sleep_cost(nbytes)
                    if ev is not None:
                        ev.synchronize()
                means[sl] = list(m)
            holder["means"] = means
            holder["denom0"] = denom0
        except BaseException as e:  # re-raised at the next join
            holder["error"] = e

    def _apply_pending_correction(self, state: TrainState, stage: str):
        p = self._pending
        holder = p["holder"]
        with span("dequantize", stage=stage):
            leaves = self._comm_leaves(state)
            new_leaves, new_anchor = self._apply_correction_all(
                leaves, p["q"], p["scales"], holder["means"]
            )
            state = self._rebuild(state, new_leaves)
            self._anchor = new_anchor
        self._pending = None
        return state

    # ------------------------------------------------------------------
    def flush_quant_error(self) -> Optional[dict]:
        """Land the previous round's quantization-error readout into the
        gauges; returns it, or None when nothing is pending."""
        pending, self._pending_err = self._pending_err, None
        if pending is None:
            return None
        max_abs, delta_sq, err_sq = (float(v) for v in pending.tolist())
        if err_sq > 0:
            snr_db = 10.0 * float(np.log10(max(delta_sq, 1e-45) / err_sq))
        else:
            snr_db = 300.0  # error underflowed to exactly 0
        if self.metrics is not None:
            self.metrics.quant_error.labels(self.compress).set(max_abs)
            self.metrics.quant_snr_db.labels(self.compress).set(round(snr_db, 3))
        return {"compress": self.compress, "max_abs_err": max_abs,
                "snr_db": round(snr_db, 3)}

    def round(self, state: TrainState, batches: Dict[str, torch.Tensor],
              live: torch.Tensor, live_host):
        """One comm-plane averaging round; ``live`` is the placed (W,)
        mask, ``live_host`` its host value.  Returns ``(state, losses)``."""
        if self._chunk_slices is None:
            self._setup(state)
        self.flush_quant_error()
        tau = next(iter(batches.values())).shape[1]
        alive = live

        if self._pending is not None:
            # overlapped steady state: the first overlapped steps of THIS
            # round run while round r-1's means are in flight, then the
            # correction lands and the window finishes
            s = min(DEFAULT_OVERLAP_STEPS, tau)
            state, losses = self._local(state, {k: v[:, :s] for k, v in batches.items()})
            self._join_pending()
            state = self._apply_pending_correction(state, "correction")
            if tau - s > 0:
                state, l2 = self._local(
                    state, {k: v[:, s:] for k, v in batches.items()}
                )
                losses = torch.cat([losses, l2], dim=1)
        else:
            # first round, or barriered steady state: the round-entry
            # params are the broadcast anchor
            self._anchor = self._comm_leaves(state)
            state, losses = self._local(state, batches)

        leaves = self._comm_leaves(state)
        with_err = self.metrics is not None
        with span("quantize", compress=self.compress):
            q, scales, new_resid, err = self._encode_all(leaves, with_err)
        self._resid = new_resid
        if self.metrics is not None:
            self.metrics.collective_bytes.labels(self.compress).inc(
                self._payload_bytes_per_round
            )
            self._pending_err = err

        # overlap only when every worker is live: a dead worker forces the
        # strict barriered apply (consensus overwrite, residual reset)
        all_alive = bool(np.all(np.asarray(live_host) > 0))
        encoded = _record_event(leaves[0])
        outs, denom0 = self._dispatch_chunks(q, scales, alive)
        holder: dict = {}
        if self.overlap and all_alive:
            th = threading.Thread(
                target=self._pace_chunks, args=(encoded, outs, denom0, holder),
                name="comm-averaging", daemon=True,
            )
            self._pending = {"q": q, "scales": scales, "holder": holder,
                             "thread": th}
            # from here deltas are measured against the encode point
            self._anchor = leaves
            th.start()
        else:
            self._pace_chunks(encoded, outs, denom0, holder)
            if holder.get("error") is not None:
                raise holder["error"]
            with span("dequantize", stage="barriered"):
                new_leaves, self._resid = self._apply_barriered_all(
                    leaves, holder["means"], alive, holder["denom0"]
                )
                state = self._rebuild(state, new_leaves)
            self._anchor = None  # re-seeded from the next round's entry
        return state, losses

    def finalize(self, state: TrainState) -> TrainState:
        """Land the in-flight overlapped average into ``state``."""
        self.flush_quant_error()
        if self._pending is None:
            return state
        self._join_pending()
        return self._apply_pending_correction(state, "finalize")
