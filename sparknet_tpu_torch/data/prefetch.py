"""Async host-to-device prefetch with a stall watchdog.

The port of ``sparknet_tpu/data/prefetch.py``.  Reference:
``BasePrefetchingDataLayer`` keeps PREFETCH_COUNT=3 batches in flight on
an InternalThread with an async H2D push (``base_data_layer.cpp:
70-101``); ``BlockingQueue`` is the handshake.  Here the same double
buffering is a producer thread and a bounded queue.  The device push is
a copy to an explicit ``torch.device``: from pinned host memory,
``non_blocking``, on a side stream, with an event the consumer's
stream waits on before it reads the batch (``place_batch`` /
``consume``, shared with ``round_feed.py``).

Fault tolerance: ``stall_timeout_s`` arms a consumer-side watchdog.  If
the producer delivers nothing for that long (storage wedged past the
retry layer's budget, a dead pipeline thread), ``__next__`` raises
``PrefetchStall`` instead of hanging the training loop: it counts
``sparknet_feed_stalls_total``, tags the trace, reports the run
unhealthy and dumps the flight recorder.  The driver can then tear the
prefetcher down (``stop()`` is idempotent and reports whether the
thread died) and build a new one.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from sparknet_tpu_torch import obs

PREFETCH_COUNT = 3  # reference: data_layers.hpp PREFETCH_COUNT

_log = logging.getLogger(__name__)


class PrefetchStall(RuntimeError):
    """The producer went silent past ``stall_timeout_s``: the loop gets a
    diagnosable error instead of an unbounded ``queue.get`` hang."""


def place_batch(host: Dict[str, np.ndarray], device: torch.device,
                stream=None):
    """A host dict of numpy arrays as tensors on ``device``: ``(dev,
    event)``.  On a CUDA device each array is copied from pinned memory,
    ``non_blocking``, on ``stream`` (the current stream when None), and
    ``event`` marks the copies' end; on the CPU the tensors share the
    arrays' memory and ``event`` is None."""
    if device.type == "cpu":
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in host.items()}, None
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        dev = {
            k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .to(device, non_blocking=True)
            for k, v in host.items()
        }
        ev = torch.cuda.Event()
        ev.record(stream)
    return dev, ev


def consume(dev: Dict[str, torch.Tensor], ev, device: torch.device):
    """Make the consumer's stream wait for a ``place_batch`` copy before
    it reads ``dev`` (a no-op for CPU batches)."""
    if ev is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ev)
        for t in dev.values():
            t.record_stream(cur)  # allocated on the copy stream
    return dev


class Prefetcher:
    """Wraps a batch-producing callable in a background thread with a
    bounded queue (the InternalThread + BlockingQueue pair).
    ``produce()`` returns a dict of numpy arrays, or None at the end.
    With ``device`` each batch is copied there on the producer thread
    (``place_batch``) and handed over as tensors; without it the
    batches pass through as produced."""

    def __init__(
        self,
        produce: Callable[[], Optional[Dict[str, np.ndarray]]],
        depth: int = PREFETCH_COUNT,
        device: Optional[torch.device] = None,
        stall_timeout_s: Optional[float] = None,
    ):
        self._produce = produce
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._stopped = False
        self._thread_exited: Optional[bool] = None
        self._error: Optional[BaseException] = None
        self._device = None if device is None else torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None
                        and self._device.type == "cuda" else None)
        self._stall_timeout_s = stall_timeout_s
        # named so traced producer spans get a labelled track
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="prefetch-producer"
        )
        self._thread.start()

    def qsize(self) -> int:
        """Batches currently buffered (the feed-queue-depth gauge)."""
        return self._q.qsize()

    def _put_politely(self, item) -> bool:
        """Bounded-queue put that keeps checking the stop flag: the
        producer never blocks unkillably, not even on the final ``None``
        sentinel."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            while not self._stop.is_set():
                batch = self._produce()
                if batch is None:
                    self._put_politely(None)
                    return
                if self._device is not None:
                    batch = place_batch(batch, self._device, self._stream)
                self._put_politely(batch)
        except BaseException as e:  # surfaced on the next __next__
            self._error = e
            self._put_politely(None)

    def __iter__(self) -> Iterator:
        return self

    def _stall(self) -> PrefetchStall:
        msg = "prefetch producer delivered nothing for %.1fs (thread %s)" % (
            self._stall_timeout_s,
            "alive" if self._thread.is_alive() else "DEAD",
        )
        # the stall counter ticks, the trace gets a tagged instant, the
        # run reports unhealthy until its next round completes, and the
        # flight ring is dumped (a no-op unless a recorder is installed)
        tm = obs.training_metrics()
        if tm is not None:
            tm.feed_stalls.inc()
        obs.instant("prefetch_stall", cat="fault", msg=msg)
        obs.report_unhealthy("prefetch_stall: " + msg)
        obs.flight.dump_if_active("prefetch_stall", extra={"msg": msg})
        return PrefetchStall(msg)

    def __next__(self):
        if self._stopped:
            # stop() drained the queue and nothing more is coming: the
            # stream is over now, not after a watchdog window
            raise StopIteration
        if self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        if self._stall_timeout_s is None:
            item = self._q.get()
        else:
            try:
                item = self._q.get(timeout=self._stall_timeout_s)
            except queue.Empty:
                raise self._stall() from None
        if item is None:
            self._done = True  # sticky: keep raising after the end/error
            if self._error is not None:
                raise self._error
            raise StopIteration
        if self._device is not None:
            return consume(*item, self._device)
        return item

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the producer and reap its thread.  Idempotent; returns
        True iff the thread is dead (repeated calls return the recorded
        outcome, updated once a late thread has exited).  The queue is
        drained continuously while joining, so a producer blocked in
        ``put`` cannot refill it and outlive the join."""
        if self._stopped:
            if self._thread_exited is False and not self._thread.is_alive():
                self._thread_exited = True  # a late exit after the report
            return bool(self._thread_exited)
        self._stopped = True
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        self._thread_exited = not self._thread.is_alive()
        if not self._thread_exited:
            _log.warning(
                "Prefetcher.stop: producer thread still alive after %.1fs "
                "(blocked in produce()?)", timeout,
            )
        return self._thread_exited


def device_prefetch(iterator, depth: int = 2,
                    device: Optional[torch.device] = None,
                    stall_timeout_s: Optional[float] = None) -> Prefetcher:
    """Prefetch an existing host iterator of numpy batch dicts onto
    ``device`` (the JAX package's ``device_prefetch``)."""
    it = iter(iterator)

    def produce():
        try:
            return next(it)
        except StopIteration:
            return None

    return Prefetcher(produce, depth=depth, device=device,
                      stall_timeout_s=stall_timeout_s)
