"""Cross-epoch shuffle-by-assignment: reshuffle WHO reads WHAT, not bytes.

The port's own copy of ``sparknet_tpu/data/shuffle.py`` (stdlib only;
the tables are the JAX package's, list for list).  SparkNet kept an RDD
of pre-built minibatches resident across iterations (PAPER.md L7); a
reshuffle between epochs was a Spark repartition, which moved lineage
metadata, not the cached partitions.  Streaming shards off object
stores, a naive reshuffle re-streams bytes: every worker downloads a
fresh partition each epoch, so a multi-epoch run costs workers x epochs
on the network.

This module is the metadata half of the fix (``chunk_cache.py`` is the
byte half): a seeded assignment that maps shards (or any item list) to
workers as a pure function of ``(seed, epoch)``.  A reshuffle moves
only this table; the shard bytes stay wherever the host-local chunk
cache already has them, so on one host every read after epoch 0 is a
cache hit whichever worker the shard moved to.

Determinism and resume: every function here is pure in its arguments,
with no RNG object to checkpoint.  A run resumed at absolute round r
recomputes ``epoch = r // rounds_per_epoch`` and gets the table the
interrupted run used.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Sequence, TypeVar

T = TypeVar("T")

__all__ = [
    "permutation",
    "assign",
    "ShuffleByAssignment",
]


def _rng(seed: int, epoch: int) -> random.Random:
    # platform-stable seeding: hash the (seed, epoch) pair through
    # sha256 so nearby seeds/epochs decorrelate fully (Random(seed+epoch)
    # would alias (0,1) with (1,0)) and the draw is identical across
    # interpreters/hosts — every worker derives the same table locally,
    # no broadcast needed
    digest = hashlib.sha256(
        f"sparknet-shuffle:{int(seed)}:{int(epoch)}".encode()
    ).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def permutation(n: int, seed: int, epoch: int) -> List[int]:
    """A seeded permutation of ``range(n)``, pure in ``(seed, epoch)``.
    Epoch boundaries re-deal the whole order; the same (seed, epoch)
    always yields the same table (resume-aware by construction)."""
    idx = list(range(int(n)))
    _rng(seed, epoch).shuffle(idx)
    return idx


def assign(
    items: Sequence[T], num_workers: int, seed: int = 0, epoch: int = 0
) -> List[List[T]]:
    """Deal a seeded permutation of ``items`` round-robin over
    ``num_workers`` — the per-epoch ownership table.  Matches the
    legacy ``shards[w::n]`` split in *shape* (worker partition sizes
    differ by at most one) while re-drawing *membership* each epoch."""
    if num_workers <= 0:
        raise ValueError(f"num_workers must be positive, got {num_workers}")
    order = [items[i] for i in permutation(len(items), seed, epoch)]
    return [order[w::num_workers] for w in range(num_workers)]


class ShuffleByAssignment:
    """The cross-epoch shuffle service over a fixed item list.

    Holds the (sorted, deterministic) item list once; every epoch's
    assignment is derived on demand — nothing to persist, nothing to
    broadcast.  ``moved(e0, e1)`` counts ownership changes between two
    epochs: that count (times ~bytes/shard) is the network cost a
    byte-moving reshuffle would have paid and the cache+assignment
    design does not."""

    def __init__(
        self, items: Sequence[T], num_workers: int, seed: int = 0
    ):
        if not items:
            raise ValueError("ShuffleByAssignment needs a non-empty item list")
        self.items: List[T] = list(items)
        self.num_workers = int(num_workers)
        self.seed = int(seed)
        if self.num_workers <= 0:
            raise ValueError(
                f"num_workers must be positive, got {num_workers}"
            )

    def assignment(self, epoch: int) -> List[List[T]]:
        """Per-worker item lists for ``epoch`` (pure in (seed, epoch))."""
        return assign(self.items, self.num_workers, self.seed, epoch)

    def worker_items(self, epoch: int, worker: int) -> List[T]:
        return self.assignment(epoch)[worker]

    def table(self, epoch: int) -> Dict[T, int]:
        """The ownership table ``item -> worker`` — the ONLY thing a
        global reshuffle moves."""
        out: Dict[T, int] = {}
        for w, part in enumerate(self.assignment(epoch)):
            for item in part:
                out[item] = w
        return out

    def moved(self, epoch_a: int, epoch_b: int) -> int:
        """How many items changed owner between two epochs (what a
        byte-moving reshuffle would re-stream; the assignment service
        moves only the table)."""
        ta, tb = self.table(epoch_a), self.table(epoch_b)
        return sum(1 for item, w in ta.items() if tb[item] != w)
