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
barriered apply even when overlap is on.  With the trainer's in-round
worker mask armed, a worker whose window went non-finite (``bad``)
folds into ``alive`` before K9/K10 the same way, its momentum history
is zeroed, and a round with such a worker takes K10 too: the overlap
decision reads one (W,) verdict a round, the JAX package's budget.

Bytes accounting (``sparknet_collective_bytes_total``): a ring all-reduce
moves about twice the payload per worker, so each round charges ``2 x``
the compressed payload (int8 = 1 B/elem + one f32 scale per tensor,
bf16 = 2 B/elem, fp32 = 4 B/elem).  With the workers on one card the
mean is a local reduction; the counter models what an interconnect
would carry.  ``SPARKNET_COMM_COST_MS_PER_MB`` adds a modeled wire time
(a sleep per chunk) for A/B runs.

Across processes (a trainer over a mesh whose dp axis spans processes:
``group`` and ``rows``, this process's workers): each rank runs K9 on
its own workers, the encoded payloads (bf16, or int8 plus the per-worker
scales; fp32 stats as they are) cross the group, the masked mean runs
over the gathered (W, ...) stack, and K10 applies it to the rank's own
rows — K10's arithmetic is per worker, reading the mean and the global
survivor count — so K9-K11 keep the bits of the stacked run.  There the
counter charges the bytes that actually reached this rank from the
others.  The overlapped round stays single-process (the trainer
refuses it).
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


def _join_stats(a, b):
    """An overlapped round's two audit segments as one window: leaves
    with a window axis ((W, s, ...)) concatenate along it."""
    if isinstance(a, dict):
        return {k: _join_stats(a[k], b[k]) for k in a}
    return torch.cat([a, b], dim=1)


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
    ``(state, batches) -> (state, losses, audit stats or None)``."""

    def __init__(
        self,
        local: Callable,
        compress: str = "fp32",
        overlap: bool = False,
        metrics: Optional[TrainingMetrics] = None,
        group=None,
        rows: Optional[slice] = None,
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
        # the dp group across processes and this process's workers
        self.group = group
        self.rows = rows
        self.last_group_bytes = 0
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
        if self.metrics is not None:
            # the epilogue runs K9-K11 on the card, their plain versions
            # on the CPU (ops/cuda_comm.py)
            self.metrics.kernel_path.labels("epilogue").set(
                1.0 if leaves[0].is_cuda else 0.0)
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

    def _apply_barriered_all(self, leaves, means, alive, bad, denom0):
        """K10 over every chunk.  ``bad`` is already folded into
        ``alive``, which is how the mask reaches K10; the argument is
        unused here and kept only so the signature matches the JAX
        package's (whose fused apply passes None for it too).  The
        caller does the masked worker's history reset
        (``_zero_bad_history``)."""
        del bad
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

    @staticmethod
    def _zero_bad_history(history, bad, denom0):
        """An audit-masked worker's momentum still holds the poisoned
        window: zero it when it rejoins the survivor mean (``bad`` false
        keeps the original bits)."""
        from sparknet_tpu_torch.parallel.trainers import zero_rows

        return zero_rows(history, bad & (denom0 > 0))

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
        # sparknet: join-ok(bounded by the in-flight chunk means: _pace_chunks always terminates, storing errors instead of raising)
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

    def _gather_payload(self, q, scales, alive):
        """Every rank's encoded rows, int8 scales and survivor mask, as
        the stacked run's (W, ...) tensors (the group's crossing)."""
        from sparknet_tpu_torch.parallel import mesh as _mesh

        int8 = [i for i, m in enumerate(self._modes) if m == "int8"]
        q_all, nq = _mesh.all_gather_leaves(list(q), self.group)
        sc, ns = _mesh.all_gather_leaves([scales[i] for i in int8], self.group)
        w = q_all[0].shape[0]
        zero = torch.zeros((w,), dtype=torch.float32, device=alive.device)
        scales_all = [zero] * len(scales)
        for i, t in zip(int8, sc):
            scales_all[i] = t
        alive_all = _mesh.all_gather_rows(alive, self.group)
        self.last_group_bytes = nq + ns
        return q_all, scales_all, alive_all

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
                # the wire cannot carry a delta before it exists
                # sparknet: sync-ok(the wire wait: the comm thread parks until the encode lands — overlapped in overlap mode, the deliberate barrier otherwise)
                encoded.synchronize()
            means: list = [None] * sum(sl.stop - sl.start for sl, *_ in outs)
            for sl, m, nbytes, ev in outs:
                with span("allreduce", chunk=sl.start, nbytes=nbytes):
                    self._sleep_cost(nbytes)
                    if ev is not None:
                        # sparknet: sync-ok(chunk landing: the span times the wire, not the dispatch — the comm thread's side of the overlap)
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
        # sparknet: sync-ok(3-scalar readout queued with LAST round's encode, one round late by design: ready by now, read without stalling the dispatch)
        max_abs, delta_sq, err_sq = pending.tolist()
        if err_sq > 0:
            # sparknet: sync-ok(host floats read above — pure host math)
            snr_db = 10.0 * float(np.log10(max(delta_sq, 1e-45) / err_sq))
        else:
            snr_db = 300.0  # error underflowed to exactly 0
        if self.metrics is not None:
            self.metrics.quant_error.labels(self.compress).set(max_abs)
            self.metrics.quant_snr_db.labels(self.compress).set(round(snr_db, 3))
        return {"compress": self.compress, "max_abs_err": max_abs,
                "snr_db": round(snr_db, 3)}

    def round(self, state: TrainState, batches: Dict[str, torch.Tensor],
              live: torch.Tensor, live_host, mask=None):
        """One comm-plane averaging round; ``live`` is the placed (W,)
        mask, ``live_host`` its host value, ``mask(live, stats) ->
        (alive, bad)`` the trainer's in-round worker mask.  Returns
        ``(state, losses, stats)``."""
        if self._chunk_slices is None:
            self._setup(state)
        self.flush_quant_error()
        tau = next(iter(batches.values())).shape[1]

        if self._pending is not None:
            # overlapped steady state: the first overlapped steps of THIS
            # round run while round r-1's means are in flight, then the
            # correction lands and the window finishes
            s = min(DEFAULT_OVERLAP_STEPS, tau)
            state, losses, stats = self._local(
                state, {k: v[:, :s] for k, v in batches.items()})
            self._join_pending()
            state = self._apply_pending_correction(state, "correction")
            if tau - s > 0:
                state, l2, st2 = self._local(
                    state, {k: v[:, s:] for k, v in batches.items()}
                )
                losses = torch.cat([losses, l2], dim=1)
                if stats is not None:
                    # per-iteration leaves join along the window
                    stats = _join_stats(stats, st2)
        else:
            # first round, or barriered steady state: the round-entry
            # params are the broadcast anchor
            self._anchor = self._comm_leaves(state)
            state, losses, stats = self._local(state, batches)
        if mask is not None:
            alive, bad = mask(live, stats)
        else:
            alive, bad = (live if self.rows is None else live[self.rows]), None

        leaves = self._comm_leaves(state)
        with_err = self.metrics is not None
        with span("quantize", compress=self.compress):
            q, scales, new_resid, err = self._encode_all(leaves, with_err)
        self._resid = new_resid
        alive_local = alive
        if self.group is not None:
            with span("allgather", compress=self.compress):
                q, scales, alive = self._gather_payload(q, scales, alive)
        if self.metrics is not None:
            self.metrics.collective_bytes.labels(self.compress).inc(
                self.last_group_bytes if self.group is not None
                else self._payload_bytes_per_round
            )
            self._pending_err = err

        # overlap only when every worker is live and finite: a dead or
        # masked worker forces the strict barriered apply (consensus
        # overwrite, residual reset, momentum zeroing).  The verdict is
        # one (W,) read a round, and only an overlapped plane reads it.
        # sparknet: sync-ok(live_host is the host-side mask, never a device tensor)
        all_alive = bool(np.all(np.asarray(live_host) > 0))
        if all_alive and bad is not None and self.overlap:
            # sparknet: sync-ok(one tiny (W,) audit-verdict read, overlap with the audit only — the per-round D2H budget the host sentry pays)
            all_alive = not bool(bad.any())
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
                    leaves, holder["means"], alive_local, bad,
                    holder["denom0"]
                )
                history = state.history
                if bad is not None:
                    history = self._zero_bad_history(history, bad,
                                                      holder["denom0"])
                state = self._rebuild(state._replace(history=history),
                                      new_leaves)
            self._anchor = None  # re-seeded from the next round's entry
        return state, losses, stats

    def finalize(self, state: TrainState) -> TrainState:
        """Land the in-flight overlapped average into ``state``."""
        self.flush_quant_error()
        if self._pending is None:
            return state
        self._join_pending()
        return self._apply_pending_correction(state, "finalize")
