"""The port's prefetcher and round feed: the stall watchdog, stop and
restart, on the CPU.

After the JAX package's ``tests/test_fault_tolerance.py`` (the
Prefetcher's watchdog, its idempotent ``stop()`` that reports whether
the thread died, no watchdog by default) and ``tests/test_round_feed.py``
(the feed's stall and ``restart(r)``, dict batches): the same behaviour
from ``sparknet_tpu_torch.data.prefetch`` and ``round_feed``, plus the
telemetry the JAX watchdog emits (``sparknet_feed_stalls_total``, the
unhealthy report, the flight-recorder dump) and the feed's
``sparknet_feed_queue_depth`` gauge.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.data import RoundFeed
from sparknet_tpu_torch.data.prefetch import (
    PREFETCH_COUNT,
    Prefetcher,
    PrefetchStall,
    consume,
    device_prefetch,
    place_batch,
)
from sparknet_tpu_torch.obs import flight
from sparknet_tpu_torch.obs.metrics import TrainingMetrics

CPU = torch.device("cpu")


@pytest.fixture()
def metrics():
    tm = TrainingMetrics()
    with obs.installed_metrics(tm):
        yield tm
    obs.report_healthy()


def test_prefetcher_stop_reaps_slow_producer():
    """A producer slow in produce() (not only blocked in put) is reaped:
    the queue is drained continuously while joining."""
    def produce():
        time.sleep(0.05)
        return {"x": np.zeros(2, np.float32)}

    pf = Prefetcher(produce, depth=1)
    next(pf)
    assert pf.stop(timeout=5.0) is True
    assert not pf._thread.is_alive()


def test_prefetcher_stop_is_idempotent():
    pf = Prefetcher(lambda: {"x": np.zeros(1, np.float32)}, depth=1)
    next(pf)
    assert pf.stop() is True
    assert pf.stop() is True  # the recorded outcome, no work


def test_prefetcher_stop_reports_wedged_thread():
    """A producer wedged past the stop timeout is reported (False), and
    a later stop() sees it exit."""
    release = threading.Event()

    def produce():
        release.wait(10.0)
        return None

    pf = Prefetcher(produce, depth=1)
    assert pf.stop(timeout=0.3) is False
    release.set()
    deadline = time.monotonic() + 5.0
    while pf._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert pf.stop() is True


def test_prefetcher_stall_watchdog_raises(metrics, tmp_path):
    """Past stall_timeout_s ``__next__`` raises PrefetchStall naming the
    thread state; the stall counter ticks, the run reports unhealthy and
    an installed flight recorder dumps a bundle."""
    hang = threading.Event()

    def produce():
        if hang.is_set():
            time.sleep(3.0)
        hang.set()
        return {"x": np.zeros(1, np.float32)}

    rec = flight.install(flight.FlightRecorder(str(tmp_path / "b.json")))
    try:
        pf = Prefetcher(produce, depth=1, stall_timeout_s=0.25)
        next(pf)
        with pytest.raises(PrefetchStall, match="delivered nothing"):
            while True:
                next(pf)
        pf.stop(timeout=5.0)
    finally:
        flight.uninstall(rec)
    assert metrics.feed_stalls.value == 1
    assert obs.health_reason().startswith("prefetch_stall")
    bundle = json.loads((tmp_path / "b.json").read_text())
    assert bundle["reason"] == "prefetch_stall"


def test_prefetcher_stopped_raises_stopiteration_immediately():
    """A stopped prefetcher with a watchdog armed ends the stream at
    once instead of waiting out the window and stalling."""
    def produce():
        time.sleep(0.02)
        return {"x": np.zeros(1, np.float32)}

    pf = Prefetcher(produce, depth=1, stall_timeout_s=5.0)
    next(pf)
    assert pf.stop() is True
    t0 = time.monotonic()
    with pytest.raises(StopIteration):
        next(pf)
    assert time.monotonic() - t0 < 1.0


def test_prefetcher_no_watchdog_by_default(metrics):
    """stall_timeout_s=None blocks as long as the producer takes (no
    spurious stall on a slow but healthy producer)."""
    def produce():
        time.sleep(0.3)
        return None

    pf = Prefetcher(produce, depth=1)
    with pytest.raises(StopIteration):
        next(pf)
    assert pf.stop() is True
    assert metrics.feed_stalls.value == 0


def test_prefetcher_surfaces_the_producer_error():
    def produce():
        raise RuntimeError("boom in produce")

    pf = Prefetcher(produce, depth=PREFETCH_COUNT)
    for _ in range(2):  # sticky after the first
        with pytest.raises(RuntimeError, match="boom in produce"):
            next(pf)
    assert pf.stop() is True


def test_device_prefetch_places_each_batch():
    """device_prefetch copies an iterator's numpy batches to the device
    (the CPU here: tensors sharing the arrays' values) in order."""
    batches = [{"x": np.full((2, 3), i, np.float32),
                "y": np.arange(2, dtype=np.int32) + i} for i in range(5)]
    pf = device_prefetch(iter(batches), depth=2, device=CPU)
    got = list(pf)
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device == CPU
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert b["y"].dtype == torch.int32 and b["y"].tolist() == [i, i + 1]
    assert pf.stop() is True


def test_place_batch_on_the_cpu_needs_no_event():
    host = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    dev, ev = place_batch(host, CPU)
    assert ev is None and torch.equal(dev["a"], torch.from_numpy(host["a"]))
    assert consume(dev, ev, CPU) is dev


def _rounds(feed, rounds):
    return [feed.next_round(r) for r in rounds]


def test_stall_raises_and_restart_recovers(metrics):
    """A producer wedged past stall_timeout_s surfaces PrefetchStall on
    the consumer; restart(r) reaps that producer and redelivers round r,
    and the rounds equal an unstalled feed's bit for bit."""
    stall_once = threading.Event()

    def assemble(r):
        if r == 1 and not stall_once.is_set():
            stall_once.set()
            time.sleep(1.0)
        return {"x": np.random.RandomState(r).randn(4, 3).astype(np.float32)}

    feed = RoundFeed(assemble, CPU, num_rounds=4, stall_timeout_s=0.2)
    clean = RoundFeed(assemble, CPU, num_rounds=4)
    try:
        got = [feed.next_round(0)]
        with pytest.raises(PrefetchStall):
            feed.next_round(1)
        assert metrics.feed_stalls.value == 1
        feed.restart(1)
        got += _rounds(feed, range(1, 4))
        want = _rounds(clean, range(4))
    finally:
        feed.stop()
        clean.stop()
    for g, w in zip(got, want):
        assert torch.equal(g["x"], w["x"])


def test_round_feed_dict_batches_stall_restart():
    """The respawned producer re-draws the same round: exactly-once
    hand-off to the consumer with token/target dicts."""
    calls = []

    def assemble(r):
        calls.append(r)
        if len(calls) == 2:  # wedge the producer on its second draw
            time.sleep(1.2)
        return {"tokens": np.full((1, 2), r, np.int32),
                "targets": np.full((1, 2), -r, np.int32)}

    feed = RoundFeed(assemble, CPU, num_rounds=4, stall_timeout_s=0.3)
    try:
        assert int(feed.next_round(0)["tokens"][0, 0]) == 0
        try:
            out1 = feed.next_round(1)
        except PrefetchStall:
            feed.restart(1)
            out1 = feed.next_round(1)
        assert int(out1["tokens"][0, 0]) == 1
        assert int(out1["targets"][0, 0]) == -1
        assert int(feed.next_round(2)["tokens"][0, 0]) == 2
    finally:
        feed.stop()


@pytest.mark.parametrize("pipelined", [True, False])
def test_round_feed_sets_the_queue_depth_gauge(metrics, pipelined):
    """Each round handed over sets sparknet_feed_queue_depth to the
    rounds still buffered: with a full queue of 2 one is left (two, once
    the producer has refilled it); without a producer thread, 0."""
    def assemble(r):
        return {"x": np.full((1,), r, np.float32)}

    feed = RoundFeed(assemble, CPU, num_rounds=3, pipelined=pipelined)
    try:
        if pipelined:  # let the producer fill its queue (depth 2)
            deadline = time.monotonic() + 5.0
            while feed._pf.qsize() < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        feed.next_round(0)
        want = (1, 2) if pipelined else (0,)
        assert metrics.feed_queue_depth.value in want
        _rounds(feed, (1, 2))
        with pytest.raises(StopIteration):
            feed.next_round(3)
    finally:
        feed.stop()
    assert "sparknet_feed_queue_depth" in metrics.registry.render()


def test_restart_rewinds_and_reports_the_old_thread():
    def assemble(r):
        return {"x": np.full((1,), r, np.float32)}

    feed = RoundFeed(assemble, CPU, num_rounds=5)
    try:
        _rounds(feed, range(3))
        assert feed.restart(1) is True
        assert [float(b["x"][0]) for b in _rounds(feed, range(1, 5))] == [
            1.0, 2.0, 3.0, 4.0]
        with pytest.raises(ValueError, match="restart"):
            feed.next_round(2)
    finally:
        assert feed.stop() is True
