"""Per-round minibatch sampling with the reference's window semantics.

The port's own copy of ``sparknet_tpu/data/sampler.py``.

Reference: ``src/main/scala/libs/MinibatchSampler.scala:16-34`` — each
averaging round, a worker holding ``total_num_batches`` minibatches picks a
*contiguous random window* of ``num_sampled_batches`` and feeds exactly
those to the engine.  This preserves the tau-batches-per-round pull
contract while tolerating heterogeneous partition sizes across workers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class MinibatchSampler:
    """Samples a contiguous window of tau stacked minibatches per round."""

    def __init__(
        self,
        batches: Dict[str, np.ndarray],
        num_sampled_batches: int,
        seed: int = 0,
    ):
        sizes = {k: len(v) for k, v in batches.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"misaligned batch counts: {sizes}")
        self.batches = batches
        self.total = next(iter(sizes.values()))
        self.tau = num_sampled_batches
        if self.tau > self.total:
            raise ValueError(
                f"cannot sample {self.tau} batches from {self.total}"
            )
        self._rng = np.random.RandomState(seed)

    def next_window(self) -> Dict[str, np.ndarray]:
        """One round's worth: {blob: (tau, ...)} from a random contiguous
        window (MinibatchSampler.scala picks start uniformly)."""
        start = int(self._rng.randint(0, self.total - self.tau + 1))
        return {k: v[start : start + self.tau] for k, v in self.batches.items()}

    def full_pass(self) -> Dict[str, np.ndarray]:
        """All batches in order (the test path: sampler covers the whole
        partition, CifarApp.scala:104-106)."""
        return dict(self.batches)
