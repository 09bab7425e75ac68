"""Round anatomy: live per-phase and per-worker time attribution.

The port of ``sparknet_tpu/obs/profile.py`` (``--profile``).
``RoundProfiler`` folds, per round and as rolling percentiles:

- **the phase breakdown**: assemble / h2d / execute / quantize /
  allreduce / dequantize / average / snapshot, from the span stream
  (``obs/trace.py``'s observer seam, which the request profiler of
  ``obs/reqtrace.py`` shares: one installed after the round profiler
  chains it);
- **measured hidden fractions**: how much of the feed's assemble + h2d
  time, and of the comm thread's ``allreduce`` spans, ran inside the
  device-busy window of the rounds around it;
- **per-worker skew and the straggler verdict**: per-worker seconds
  from the host hooks (``note_worker_phase``, ``worker_timer``,
  ``timed_worker_windows``: the apps' window draws and reader loops)
  and from the trainer's per-worker execute timer (``execute_probe``).
  The W workers run one after another on one device, so a host span
  around a worker's window would close when its kernels are queued,
  not when they finish: on the card each window is bracketed by a CUDA
  event pair, read once the round's last end event has completed (the
  same point the loop's smoothed-loss read waits for); on CPU tensors
  the host interval is the window's time;
- **achieved FLOP/s and MFU**: the analytic count of
  ``utils/flops.py`` over the measured round wall, against the card's
  published peak for the round's precision (``device_peak_flops``).

Inactive, every hook is one module-global read.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

PHASES = (
    "assemble", "h2d", "execute", "quantize", "allreduce", "dequantize",
    "average", "snapshot", "restore",
)

# where each phase's time goes when it dominates a round
PHASE_RESOURCE = {
    "assemble": "host",
    "h2d": "bandwidth",
    "quantize": "bandwidth",
    "allreduce": "bandwidth",
    "dequantize": "bandwidth",
    "execute": "compute",
    "average": "compute",
    "snapshot": "host",
    "restore": "host",
}

# NVIDIA's published dense peaks of the H100 SXM5 (80 GB HBM3), by the
# precision the round computes in: float32 off the tensor cores (the
# port keeps TF32 off) and bf16 on them.  Matched by device name; any
# other device has no entry, so its MFU is None.
_PEAKS = (
    ("H100 80GB HBM3", {torch.float32: 67e12, torch.bfloat16: 989e12}),
    ("H100 SXM", {torch.float32: 67e12, torch.bfloat16: 989e12}),
)


def device_peak_flops(device=None, dtype=torch.float32) -> float:
    """The card's peak FLOP/s for ``dtype``, or 0.0 when unknown (a CPU,
    another card)."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(dev)
    for key, peaks in _PEAKS:
        if key in name:
            return float(peaks.get(dtype, 0.0))
    return 0.0


def _overlap_s(interval, others) -> float:
    """Seconds of ``interval`` covered by ``others`` (pairwise sum
    clamped to the interval: the busy windows never overlap)."""
    t0, t1 = interval
    if t1 <= t0:
        return 0.0
    cov = 0.0
    for o0, o1 in others:
        lo, hi = max(t0, o0), min(t1, o1)
        if hi > lo:
            cov += hi - lo
    return min(cov, t1 - t0)


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class WorkerWindowTimer:
    """Each worker's execute time in one round: a CUDA event pair around
    every window the worker ran on the card (summed when a round runs a
    worker's window in pieces), the host interval on the CPU."""

    def __init__(self, device, num_workers: int):
        self.cuda = torch.device(device).type == "cuda"
        self.num_workers = int(num_workers)
        self._pairs: List[List] = [[] for _ in range(self.num_workers)]
        self._open: Dict[int, object] = {}
        self._last_end = None

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self, w: int) -> None:
        self._open[w] = self._mark()

    def stop(self, w: int) -> None:
        end = self._mark()
        self._pairs[w].append((self._open.pop(w), end))
        self._last_end = end

    def seconds(self) -> np.ndarray:
        """(W,) seconds; on the card waits for the last end event."""
        out = np.zeros((self.num_workers,), np.float64)
        if self.cuda and self._last_end is not None:
            self._last_end.synchronize()
        for w, pairs in enumerate(self._pairs):
            for s, e in pairs:
                out[w] += (s.elapsed_time(e) / 1e3 if self.cuda else e - s)
        return out


class RoundProfiler:
    """Folds the span stream and the per-worker hooks into per-round
    phase, overlap and skew records and rolling percentiles.  The feed
    marks the absolute round it hands over (``note_consumed_round``) and
    the trainer finalizes the record after each round
    (``observe_round``); without a feed the rounds count on."""

    def __init__(self, *, window: int = 128, skew_threshold: float = 1.75,
                 skew_floor_s: float = 0.02, probe_workers: bool = True):
        self.skew_threshold = float(skew_threshold)
        # a straggler must also be this many seconds past the median:
        # max/median explodes on microsecond noise
        self.skew_floor_s = float(skew_floor_s)
        self.probe_workers = bool(probe_workers)
        self._lock = threading.Lock()
        self._phase_acc: Dict[str, float] = {}
        # producer spans by the absolute round they built, and their bytes
        self._producer: Dict[int, List] = {}
        self._producer_bytes: Dict[int, float] = {}
        self._comm_pending: List = []
        self._comm_pending_bytes = 0.0
        # the round's consumer-span envelope (first t0, last t1)
        self._window_t0: Optional[float] = None
        self._window_t1: Optional[float] = None
        self._busy_intervals: deque = deque(maxlen=8)
        self._consumer_threads: set = set()
        self._worker_times: Dict[int, Dict[str, np.ndarray]] = {}
        self._consumed_round: Optional[int] = None
        self._auto_round = 0
        self._last_finalize_t: Optional[float] = None
        self.flops_per_round: Optional[float] = None
        self.comm_bytes_per_round: Optional[float] = None
        self.compress: str = "none"
        self.num_workers: Optional[int] = None
        self.rounds_profiled = 0
        self.straggler_rounds = 0
        self.last_straggler_worker: Optional[int] = None
        self.last_straggler_round: Optional[int] = None
        self._records: deque = deque(maxlen=int(window))
        # set from the trainer's device and precision (note_round_work)
        self._peak_flops = 0.0
        # the gauges' home: the trainer's metrics, else the installed ones
        self.metrics = None

    # ------------------------------------------------------------------
    def on_span(self, name, cat, t0, t1, thread, args) -> None:
        """The span observer (``obs/trace.set_span_observer``)."""
        if cat not in ("phase", "comm"):
            return
        a = args or {}
        with self._lock:
            if name in ("assemble", "h2d"):
                r = a.get("round")
                if r is None:
                    r = (self._consumed_round if self._consumed_round
                         is not None else self._auto_round)
                if len(self._producer) >= 64:  # a driver that never
                    # finalizes rounds must not grow this forever
                    for k in sorted(self._producer)[:32]:
                        self._producer.pop(k, None)
                        self._producer_bytes.pop(k, None)
                self._producer.setdefault(int(r), []).append((t0, t1))
                if name == "h2d" and "nbytes" in a:
                    self._producer_bytes[int(r)] = (
                        self._producer_bytes.get(int(r), 0.0)
                        + float(a["nbytes"]))
                self._phase_acc[name] = self._phase_acc.get(name, 0.0) + (t1 - t0)
                return
            self._phase_acc[name] = self._phase_acc.get(name, 0.0) + (t1 - t0)
            if name in ("execute", "average", "quantize", "dequantize"):
                if self._window_t0 is None or t0 < self._window_t0:
                    self._window_t0 = t0
                if self._window_t1 is None or t1 > self._window_t1:
                    self._window_t1 = t1
                if name in ("execute", "average"):
                    self._consumer_threads.add(thread)
            if name == "allreduce":
                if len(self._comm_pending) < 512:
                    self._comm_pending.append((t0, t1, thread))
                self._comm_pending_bytes += float(a.get("nbytes", 0.0))

    # ------------------------------------------------------------------
    def note_worker_phase(self, r: int, phase: str, seconds) -> None:
        """Per-worker seconds of ``phase`` in absolute round ``r``
        (indexable by worker)."""
        arr = np.asarray(seconds, np.float64).reshape(-1)
        with self._lock:
            if len(self._worker_times) >= 64:
                for k in sorted(self._worker_times)[:32]:
                    self._worker_times.pop(k, None)
            self._worker_times.setdefault(int(r), {})[phase] = arr

    def note_worker_time(self, r: int, phase: str, worker: int,
                         seconds: float, num_workers: int) -> None:
        """One worker's seconds (the ``worker_timer`` feeds this)."""
        with self._lock:
            bucket = self._worker_times.setdefault(int(r), {})
            arr = bucket.get(phase)
            if arr is None or arr.shape[0] < num_workers:
                new = np.zeros((num_workers,), np.float64)
                if arr is not None:
                    new[: arr.shape[0]] = arr
                arr = bucket[phase] = new
            arr[int(worker)] += float(seconds)

    def note_consumed_round(self, r: int) -> None:
        """The feed handed over absolute round ``r``: the next
        ``observe_round`` finalizes under this index."""
        self._consumed_round = int(r)

    def note_round_work(self, flops_per_round: Optional[float] = None,
                        comm_bytes_per_round: Optional[float] = None,
                        compress: Optional[str] = None,
                        num_workers: Optional[int] = None,
                        device=None, dtype=torch.float32) -> None:
        """Static per-round work sizes (the trainer's hook, set once);
        ``device`` and ``dtype`` pick the peak MFU is measured against."""
        if flops_per_round is not None:
            self.flops_per_round = float(flops_per_round)
        if comm_bytes_per_round is not None:
            self.comm_bytes_per_round = float(comm_bytes_per_round)
        if compress is not None:
            self.compress = compress
        if num_workers is not None:
            self.num_workers = int(num_workers)
        if device is not None:
            self._peak_flops = device_peak_flops(device, dtype)

    def observe_round(self, losses=None, worker_timer=None) -> Optional[dict]:
        """Finalize the round that just completed: fold the phases,
        compute the hidden fractions, read the per-worker execute timer
        and export the verdict.  The trainer calls this once a round."""
        probe = None
        if self.probe_workers and worker_timer is not None:
            probe = worker_timer.seconds()
        probe_end = time.perf_counter()
        r = self._consumed_round
        if r is None:
            r = self._auto_round
        with self._lock:
            self._auto_round = r + 1
            self._consumed_round = None
            phases = dict(self._phase_acc)
            self._phase_acc = {}
            # the round's device-busy window: first consumer span to the
            # timer's drain point (else the last consumer span's end)
            if self._window_t0 is not None:
                t1 = self._window_t1 or self._window_t0
                if probe is not None:
                    t1 = max(t1, probe_end)
                self._busy_intervals.append((self._window_t0, t1))
            self._window_t0 = self._window_t1 = None
            busy = list(self._busy_intervals)
            prod = self._producer.pop(r, [])
            for old in [k for k in self._producer if k < r - 8]:
                self._producer.pop(old, None)
                self._producer_bytes.pop(old, None)
            h2d_bytes = self._producer_bytes.pop(r, 0.0)
            prod_total = sum(b - a for a, b in prod)
            prod_hidden = sum(_overlap_s(iv, busy) for iv in prod)
            hidden_h2d = prod_hidden / prod_total if prod_total > 0 else None
            # allreduce spans off the consumer threads (the overlapped
            # plane's comm thread) can hide; on the consumer thread they
            # are the barriered collective, hidden fraction 0
            comm, self._comm_pending = self._comm_pending, []
            comm_bytes, self._comm_pending_bytes = self._comm_pending_bytes, 0.0
            comm_total = sum(b - a for a, b, _ in comm)
            off_thread = [(a, b) for a, b, thr in comm
                          if thr not in self._consumer_threads]
            comm_hidden = sum(_overlap_s(iv, busy) for iv in off_thread)
            hidden_comm = comm_hidden / comm_total if comm_total > 0 else None
            wt = self._worker_times.pop(r, {})
            for old in [k for k in self._worker_times if k < r - 8]:
                self._worker_times.pop(old, None)
            round_s = (probe_end - self._last_finalize_t
                       if self._last_finalize_t is not None else None)
            self._last_finalize_t = probe_end
        if probe is not None:
            wt = dict(wt, execute_probe=probe)
        worker = self._worker_verdict(r, wt)
        rec = {
            "round": int(r),
            "round_s": round_s,
            "phases_ms": {k: round(v * 1e3, 3) for k, v in sorted(phases.items())},
            "hidden_frac_h2d": hidden_h2d,
            "hidden_frac_comm": hidden_comm,
            "producer_ms": round(prod_total * 1e3, 3),
            "comm_ms": round(comm_total * 1e3, 3),
            "h2d_bytes": h2d_bytes,
            "comm_chunk_bytes": comm_bytes,
            "worker": worker,
        }
        if probe is not None:
            rec["execute_ms"] = [round(v * 1e3, 4) for v in probe]
        if self.flops_per_round and round_s:
            rec["achieved_flops_per_s"] = self.flops_per_round / round_s
            rec["mfu"] = (rec["achieved_flops_per_s"] / self._peak_flops
                          if self._peak_flops > 0 else None)
        with self._lock:
            self._records.append(rec)
            self.rounds_profiled += 1
        self._export(rec)
        return rec

    # ------------------------------------------------------------------
    def _worker_verdict(self, r: int, wt: Dict[str, np.ndarray]):
        """The skew and straggler verdict, judged per phase (max/median
        over workers plus an absolute floor past the median), so a worker
        straggling in one phase is not washed out by a uniformly large
        one."""
        if not wt:
            return None
        n = max(a.shape[0] for a in wt.values())
        total = np.zeros((n,), np.float64)
        per_phase = {}
        worst_phase = None
        for phase, arr in sorted(wt.items()):
            total[: arr.shape[0]] += arr
            if arr.shape[0] < 2:
                continue
            med = float(np.median(arr))
            mx = float(np.max(arr))
            skew = mx / med if med > 0 else float("inf") if mx > 0 else 1.0
            gap = mx - med
            flags = bool(skew > self.skew_threshold and gap > self.skew_floor_s)
            per_phase[phase] = {
                "skew": round(skew, 3) if np.isfinite(skew) else None,
                "worst_worker": int(np.argmax(arr)),
                "straggler": flags,
            }
            if flags and (worst_phase is None or gap > worst_phase[1]):
                worst_phase = (phase, gap)
        med = float(np.median(total))
        mx = float(np.max(total))
        skew = mx / med if med > 0 else float("inf") if mx > 0 else 1.0
        if worst_phase is not None:
            culprit = per_phase[worst_phase[0]]
            worst = culprit["worst_worker"]
            straggler = True
            straggler_phase = worst_phase[0]
            if culprit["skew"] is not None:
                skew = max(skew, culprit["skew"])
        else:
            worst = int(np.argmax(total))
            straggler = bool(skew > self.skew_threshold
                             and (mx - med) > self.skew_floor_s)
            straggler_phase = None
        if straggler:
            with self._lock:
                self.straggler_rounds += 1
                self.last_straggler_worker = worst
                self.last_straggler_round = int(r)
        return {
            "times_ms": [round(v * 1e3, 3) for v in total],
            "phases": sorted(wt),
            "per_phase": per_phase,
            "skew": round(skew, 3) if np.isfinite(skew) else None,
            "worst_worker": worst,
            "straggler": straggler,
            "straggler_phase": straggler_phase,
        }

    def _export(self, rec: dict) -> None:
        """One verdict a round to the installed metrics and the run log
        (``obs.instant``: the tracer and the flight ring)."""
        from sparknet_tpu_torch import obs as _obs

        tm = self.metrics if self.metrics is not None else _obs.training_metrics()
        if tm is not None:
            if rec["hidden_frac_h2d"] is not None:
                tm.hidden_fraction.labels("h2d").set(rec["hidden_frac_h2d"])
            if rec["hidden_frac_comm"] is not None:
                tm.hidden_fraction.labels("comm").set(rec["hidden_frac_comm"])
            w = rec["worker"]
            if w is not None and w["skew"] is not None:
                tm.worker_skew.set(w["skew"])
                tm.straggler_worker.set(w["worst_worker"] if w["straggler"] else -1)
                if w["straggler"]:
                    tm.straggler_rounds.inc()
            if rec.get("achieved_flops_per_s"):
                tm.achieved_flops.set(rec["achieved_flops_per_s"])
                if rec.get("mfu") is not None:
                    tm.mfu.set(rec["mfu"])
        args = {"round": rec["round"], "hidden_h2d": rec["hidden_frac_h2d"],
                "hidden_comm": rec["hidden_frac_comm"]}
        w = rec["worker"]
        if w is not None:
            args.update(skew=w["skew"], worst_worker=w["worst_worker"],
                        straggler=w["straggler"])
        _obs.instant("profile", cat="profile", **args)

    # ------------------------------------------------------------------
    def last(self) -> Optional[dict]:
        with self._lock:
            return self._records[-1] if self._records else None

    def summary(self) -> dict:
        """Rolling percentiles over the record window."""
        with self._lock:
            recs = list(self._records)
        phase_names = sorted({k for r in recs for k in r["phases_ms"]})
        phases = {}
        for name in phase_names:
            vals = sorted(r["phases_ms"][name] for r in recs
                          if name in r["phases_ms"])
            phases[name] = {
                "count": len(vals),
                "p50_ms": round(_pct(vals, 0.50), 3),
                "p90_ms": round(_pct(vals, 0.90), 3),
                "max_ms": round(vals[-1], 3) if vals else 0.0,
                "bound": PHASE_RESOURCE.get(name, "host"),
            }

        def frac_stats(key):
            vals = sorted(r[key] for r in recs if r.get(key) is not None)
            if not vals:
                return None
            return {"p50": round(_pct(vals, 0.5), 4),
                    "min": round(vals[0], 4), "max": round(vals[-1], 4)}

        skews = sorted(r["worker"]["skew"] for r in recs
                       if r.get("worker") and r["worker"]["skew"] is not None)
        rounds_s = sorted(r["round_s"] for r in recs if r.get("round_s") is not None)
        flops = self.flops_per_round
        payload = self.comm_bytes_per_round
        exe = [r["execute_ms"] for r in recs if r.get("execute_ms")]
        out = {
            "rounds": len(recs),
            "phases": phases,
            "hidden_frac_h2d": frac_stats("hidden_frac_h2d"),
            "hidden_frac_comm": frac_stats("hidden_frac_comm"),
            "round_ms": {
                "p50": round(_pct(rounds_s, 0.5) * 1e3, 2),
                "max": round(rounds_s[-1] * 1e3, 2),
            } if rounds_s else None,
            "worker_skew": {
                "p50": round(_pct(skews, 0.5), 3), "max": round(skews[-1], 3),
            } if skews else None,
            "straggler_rounds": self.straggler_rounds,
            # the window's own count (straggler_rounds is the lifetime one)
            "straggler_rounds_window": sum(
                1 for rr in recs if rr.get("worker") and rr["worker"]["straggler"]),
            "last_straggler_worker": self.last_straggler_worker,
            "last_straggler_round": self.last_straggler_round,
            "flops_per_round": flops,
            "payload_bytes_per_round": payload,
            "compress": self.compress,
            "peak_flops": self._peak_flops or None,
            # each worker's execute time (CUDA events on the card)
            "worker_execute_ms": {
                "p50": [round(_pct(sorted(col), 0.5), 4) for col in zip(*exe)],
                "max": [round(max(col), 4) for col in zip(*exe)],
            } if exe else None,
        }
        if flops and rounds_s:
            ach = flops / _pct(rounds_s, 0.5)
            out["achieved_flops_per_s"] = ach
            out["mfu"] = (round(ach / self._peak_flops, 6)
                          if self._peak_flops > 0 else None)
        if flops and payload:
            out["arithmetic_intensity_flops_per_byte"] = round(flops / payload, 3)
        return out

    def state_dict(self) -> dict:
        """The profile block a health endpoint exports."""
        last = self.last()
        w = last.get("worker") if last else None
        return {
            "rounds_profiled": self.rounds_profiled,
            "straggler_rounds": self.straggler_rounds,
            "last_straggler_worker": self.last_straggler_worker,
            "last_straggler_round": self.last_straggler_round,
            "last_skew": w["skew"] if w else None,
            "last_worst_worker": w["worst_worker"] if w else None,
            "last_hidden_frac_h2d": last.get("hidden_frac_h2d") if last else None,
            "last_hidden_frac_comm": last.get("hidden_frac_comm") if last else None,
        }


# ----------------------------------------------------------------------
# the module surface: hooks are near-free no-ops until one is installed

_active: Optional[RoundProfiler] = None


def install(profiler: RoundProfiler) -> RoundProfiler:
    """Make ``profiler`` the process's round profiler: span completions
    and the worker hooks feed it.  One at a time; a request profiler
    installed after it (``obs/reqtrace.install``) chains it, so both
    receive spans."""
    global _active
    from sparknet_tpu_torch.obs import trace as _trace

    _active = profiler
    _trace.set_span_observer(profiler.on_span)
    return profiler


def uninstall(profiler: Optional[RoundProfiler] = None) -> None:
    global _active
    if profiler is not None and profiler is not _active:
        return
    from sparknet_tpu_torch.obs import trace as _trace

    _active = None
    _trace.set_span_observer(None)


def active() -> Optional[RoundProfiler]:
    return _active


def note_consumed_round(r: int) -> None:
    p = _active
    if p is not None:
        p.note_consumed_round(r)


def note_worker_phase(r: int, phase: str, seconds) -> None:
    p = _active
    if p is not None:
        p.note_worker_phase(r, phase, seconds)


class _WorkerTimer:
    __slots__ = ("r", "phase", "worker", "num_workers", "_t0")

    def __init__(self, r, phase, worker, num_workers):
        self.r, self.phase = r, phase
        self.worker, self.num_workers = worker, num_workers

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        p = _active
        if p is not None:
            p.note_worker_time(self.r, self.phase, self.worker,
                               time.perf_counter() - self._t0, self.num_workers)
        return False


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


def worker_timer(r: int, worker: int, num_workers: int, phase: str = "assemble"):
    """Context manager attributing a block of host work to one worker of
    one absolute round (a no-op without a profiler)."""
    if _active is None:
        return _NULL_TIMER
    return _WorkerTimer(r, phase, worker, num_workers)


def timed_worker_windows(r: int, draws) -> list:
    """One window per worker from ``draws`` (zero-argument callables),
    each draw timed as round ``r``'s assemble attribution when a
    profiler is installed; otherwise the plain list comprehension."""
    if _active is None:
        return [d() for d in draws]
    times, out = [], []
    for d in draws:
        t0 = time.perf_counter()
        out.append(d())
        times.append(time.perf_counter() - t0)
    note_worker_phase(r, "assemble", times)
    return out


def worker_window_timer(device, num_workers: int) -> Optional[WorkerWindowTimer]:
    """The trainer's per-worker execute timer for this round, or None
    when no profiler (or one without the worker probe) is installed."""
    p = _active
    if p is None or not p.probe_workers:
        return None
    return WorkerWindowTimer(device, num_workers)


def observe_round_if_active(losses=None) -> None:
    """Finalize a profiled round (no-op without a profiler): the
    step-shaped paths (``Solver.step``) call this."""
    p = _active
    if p is not None:
        p.observe_round(losses)


def note_trainer_work(prof: RoundProfiler, trainer, tau: int, state) -> None:
    """Hand ``prof`` the trainer's modeled per-round work once: the
    analytic FLOPs (``utils/flops.train_flops``) of all workers' windows
    (None for a net that is not a prototxt ``TorchNet``),
    the collective payload bytes (the comm plane's, else the fused
    round's) and the device and dtype the peak is read for (the net's
    compute dtype: a bf16 round's MFU reads against the bf16 peak)."""
    noted = getattr(prof, "_work_noted_by", None)
    if noted is not None and noted[0]() is trainer and noted[1] == tau:
        return
    prof._work_noted_by = (weakref.ref(trainer), tau)
    if trainer.metrics is not None:
        prof.metrics = trainer.metrics
    from sparknet_tpu_torch.net import TorchNet
    from sparknet_tpu_torch.utils.flops import train_flops

    # a prototxt net has static blob shapes; the LM's net stays
    # unmodeled, as in the JAX package
    net = trainer.solver.net
    flops = (train_flops(net) * tau * trainer.num_workers
             if isinstance(net, TorchNet) else None)
    comm = trainer._comm
    if comm is not None:
        payload = comm.payload_bytes_per_round or None
        compress = comm.compress
    else:
        payload = trainer._payload_bytes(state)
        compress = "none"
    dtype = getattr(net, "compute_dtype", None) or torch.float32
    prof.note_round_work(flops_per_round=flops, comm_bytes_per_round=payload,
                         compress=compress, num_workers=trainer.num_workers,
                         device=trainer.device, dtype=dtype)


def state() -> Optional[dict]:
    """The active profiler's exported state, or None."""
    p = _active
    return None if p is None else p.state_dict()
