"""Pipelined round feed: host batch assembly + H2D overlapped with the round.

The port of ``stack_windows`` and ``RoundFeed``
(``sparknet_tpu/data/round_feed.py:80,107``).  Round r+1's worker-stacked
tau-deep batch dict is assembled on a producer thread and copied to the
device from there — from pinned host memory, ``non_blocking``, on a
side stream — while round r trains; the consumer's stream waits on the
copy's event before it reads the batch.  ``pipelined=False`` assembles
and copies on the caller's thread with identical results.

Determinism contract: ``assemble`` is called exactly once per round, in
round order, from a single thread, so a stateful sampler draws the same
windows either way (and the same as the JAX package's feed for the
same seed: the samplers are numpy-seeded).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparknet_tpu_torch.obs.trace import span

Assemble = Callable[[int], Dict[str, np.ndarray]]


def stack_windows(windows, out=None):
    """Stack per-worker ``{blob: (tau, ...)}`` windows into the
    worker-major round layout ``{blob: (num_workers, tau, ...)}``; with
    ``out`` (same structure) the stack is written in place."""
    if out is None:
        return {k: np.stack([w[k] for w in windows]) for k in windows[0]}
    for k, buf in out.items():
        np.stack([w[k] for w in windows], out=buf)
    return out


class RoundFeed:
    """Per-round batch executor for the training loops.

    ``assemble(r)`` builds round ``r``'s host batch dict (numpy);
    ``next_round(r)`` returns it as tensors on ``device``.  Rounds are
    consumed consecutively from ``start_round`` (a resumed run's first
    absolute round), ``num_rounds`` of them; ``stop()`` ends the
    producer (idempotent)."""

    def __init__(
        self,
        assemble: Assemble,
        device: torch.device,
        pipelined: bool = True,
        num_rounds: Optional[int] = None,
        start_round: int = 0,
    ):
        self._assemble = assemble
        self._device = torch.device(device)
        self._pipelined = bool(pipelined)
        self._next_r = int(start_round)
        self._end = None if num_rounds is None else self._next_r + int(num_rounds)
        # two rounds in flight ahead of the consumer (PREFETCH_COUNT - 1
        # of the JAX feed)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._copy_stream = None
        if self._pipelined:
            if self._device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self._device)
            self._thread = threading.Thread(
                target=self._produce, args=(self._next_r,),
                name="round-feed", daemon=True,
            )
            self._thread.start()

    def _place(self, host: Dict[str, np.ndarray]):
        """Host dict -> (device dict, event the consumer must wait on)."""
        if self._device.type == "cpu":
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in host.items()}, None
        stream = self._copy_stream or torch.cuda.current_stream(self._device)
        with torch.cuda.stream(stream):
            dev = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(self._device, non_blocking=True)
                for k, v in host.items()
            }
            ev = torch.cuda.Event()
            ev.record(stream)
        return dev, ev

    def _produce_one(self, r: int):
        with span("assemble", round=r):
            host = self._assemble(r)
        nbytes = int(sum(v.nbytes for v in host.values()))
        with span("h2d", round=r, nbytes=nbytes):
            return self._place(host)

    def _produce(self, r: int) -> None:
        while not self._stop.is_set() and (self._end is None or r < self._end):
            try:
                item = ("ok", self._produce_one(r))
            except BaseException as e:  # handed to the consumer
                item = ("error", e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "error":
                return
            r += 1

    def next_round(self, r: int) -> Dict[str, torch.Tensor]:
        """The device batch for absolute round ``r`` (consecutive rounds
        only).  Raises ``StopIteration`` past ``num_rounds``."""
        if r != self._next_r:
            raise ValueError(
                f"RoundFeed is at round {self._next_r}, asked for {r} "
                "(rounds are consumed in order)"
            )
        if self._end is not None and r >= self._end:
            raise StopIteration
        if self._pipelined:
            kind, payload = self._q.get()
            if kind == "error":
                raise payload
            dev, ev = payload
        else:
            dev, ev = self._produce_one(r)
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            for t in dev.values():
                t.record_stream(cur)  # allocated on the copy stream
        self._next_r = r + 1
        return dev

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop and reap the producer; returns whether it exited."""
        self._stop.set()
        th = self._thread
        if th is None:
            return True
        while True:  # unblock a producer parked on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        th.join(timeout)
        return not th.is_alive()
