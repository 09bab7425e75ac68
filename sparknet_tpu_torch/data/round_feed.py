"""Pipelined round feed: host batch assembly + H2D overlapped with the round.

The port of ``stack_windows`` and ``RoundFeed``
(``sparknet_tpu/data/round_feed.py:80,107``).  Round r+1's worker-stacked
tau-deep batch dict is assembled on the ``Prefetcher``'s producer thread
(``data/prefetch.py``: its bounded queue and stall watchdog) and copied
to the device from there — from pinned host memory, ``non_blocking``, on
a side stream — while round r trains; the consumer's stream waits on the
copy's event before it reads the batch.  ``pipelined=False`` assembles
and copies on the caller's thread with identical results.

With ``stall_timeout_s`` a producer silent that long raises
``PrefetchStall`` on the consumer (``sparknet_feed_stalls_total`` counts
it); ``restart(r)`` reaps that producer and respawns one from round r,
the JAX package's recovery pattern.  Each round handed over sets
``sparknet_feed_queue_depth`` to the rounds still buffered and tells
the round profiler (``--profile``) which absolute round is consumed.

Determinism contract: ``assemble`` is called exactly once per round, in
round order, from a single thread (a restart calls it again from round
r on), so a stateful sampler draws the same windows either way (and the
same as the JAX package's feed for the same seed: the samplers are
numpy-seeded).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.obs import profile as obs_profile
from sparknet_tpu_torch.data.prefetch import (  # noqa: F401 (re-exported)
    PREFETCH_COUNT,
    Prefetcher,
    PrefetchStall,
    consume,
    place_batch,
)
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
    absolute round), ``num_rounds`` of them; on a ``PrefetchStall`` the
    consumer calls ``restart(r)`` and asks again; ``stop()`` ends the
    producer (idempotent, reports whether its thread died)."""

    def __init__(
        self,
        assemble: Assemble,
        device: torch.device,
        pipelined: bool = True,
        num_rounds: Optional[int] = None,
        start_round: int = 0,
        stall_timeout_s: Optional[float] = None,
    ):
        self._assemble = assemble
        self._device = torch.device(device)
        self._pipelined = bool(pipelined)
        self._next_r = int(start_round)
        self._end = None if num_rounds is None else self._next_r + int(num_rounds)
        self._stall_timeout_s = stall_timeout_s
        self._copy_stream = None
        self._pf: Optional[Prefetcher] = None
        if self._pipelined:
            if self._device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self._device)
            self._spawn(self._next_r)

    def _produce_one(self, r: int):
        with span("assemble", round=r):
            host = self._assemble(r)
        nbytes = sum(v.nbytes for v in host.values())
        with span("h2d", round=r, nbytes=nbytes):
            return place_batch(host, self._device, self._copy_stream)

    def _spawn(self, start_r: int) -> None:
        # the round cursor is local to this producer generation: a thread
        # that outlives stop() (wedged inside assemble past the reap
        # timeout) bumps its own cursor, never the respawned one's
        cur = [start_r]

        def produce():
            r = cur[0]
            if self._end is not None and r >= self._end:
                return None
            item = self._produce_one(r)
            cur[0] += 1
            return item

        # two rounds in flight ahead of the consumer (PREFETCH_COUNT - 1,
        # as the JAX feed)
        self._pf = Prefetcher(produce, depth=PREFETCH_COUNT - 1,
                              stall_timeout_s=self._stall_timeout_s)

    def next_round(self, r: int) -> Dict[str, torch.Tensor]:
        """The device batch for absolute round ``r`` (consecutive rounds
        only; ``restart`` rewinds).  Raises ``PrefetchStall`` when the
        producer goes silent past ``stall_timeout_s`` and
        ``StopIteration`` past ``num_rounds``."""
        if r != self._next_r:
            raise ValueError(
                f"RoundFeed is at round {self._next_r}, asked for {r} "
                "(rounds are consumed in order; use restart() to rewind)"
            )
        if self._end is not None and r >= self._end:
            raise StopIteration
        if self._pipelined:
            dev, ev = next(self._pf)
        else:
            dev, ev = self._produce_one(r)
        tm = obs.training_metrics()
        if tm is not None:
            tm.feed_queue_depth.set(
                self._pf.qsize() if self._pf is not None else 0)
        # the profiler keys its record by the absolute round the consumer
        # is about to train on (a resume's replay re-keys correctly)
        obs_profile.note_consumed_round(r)
        self._next_r = r + 1
        return consume(dev, ev, self._device)

    def restart(self, r: int) -> bool:
        """Reap the current producer and respawn one from absolute round
        ``r`` (the recovery after a ``PrefetchStall``).  Returns whether
        the old producer's thread died."""
        exited = True
        if self._pf is not None:
            exited = self._pf.stop()
        self._next_r = r
        if self._pipelined:
            self._spawn(r)
        return exited

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop and reap the producer; returns whether it exited."""
        if self._pf is None:
            return True
        return self._pf.stop(timeout)
