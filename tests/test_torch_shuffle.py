"""The port's cross-epoch shuffle against the JAX package's, on the CPU.

``data/shuffle.py`` is seeded through sha256 and ``random.Random``: the
port's permutations, ownership tables and moved counts must equal the
JAX package's exactly, as lists, for every seed, epoch, length and
worker count (tolerance: none).
"""

import pytest

from sparknet_tpu.data import shuffle as jshuffle
from sparknet_tpu_torch.data import shuffle as tshuffle

SEEDS = (0, 1, 7, 123456789, 2**40 + 3)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 97, 1000])
def test_permutation_equals_jax(n):
    for seed in SEEDS:
        for epoch in range(6):
            got = tshuffle.permutation(n, seed, epoch)
            assert got == jshuffle.permutation(n, seed, epoch)
            assert sorted(got) == list(range(n))


@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8])
def test_assign_equals_jax(workers):
    items = [f"train.{i:05d}.tar" for i in range(23)]
    for seed in SEEDS:
        for epoch in range(5):
            got = tshuffle.assign(items, workers, seed, epoch)
            assert got == jshuffle.assign(items, workers, seed, epoch)
            # the legacy split's shape: partition sizes differ by <= 1
            sizes = [len(p) for p in got]
            assert max(sizes) - min(sizes) <= 1 and sum(sizes) == len(items)


def test_epochs_and_seeds_redeal():
    """Nearby (seed, epoch) pairs decorrelate: (0, 1) and (1, 0) differ,
    as in the JAX package (sha256 of both, not seed + epoch)."""
    assert tshuffle.permutation(50, 0, 1) != tshuffle.permutation(50, 1, 0)
    assert tshuffle.permutation(50, 3, 0) != tshuffle.permutation(50, 3, 1)


@pytest.mark.parametrize("workers", [2, 5])
def test_shuffle_by_assignment_equals_jax(workers):
    items = list(range(40))
    t = tshuffle.ShuffleByAssignment(items, workers, seed=9)
    j = jshuffle.ShuffleByAssignment(items, workers, seed=9)
    for e in range(4):
        assert t.assignment(e) == j.assignment(e)
        assert t.table(e) == j.table(e)
        for w in range(workers):
            assert t.worker_items(e, w) == j.worker_items(e, w)
    assert t.moved(0, 1) == j.moved(0, 1) > 0
    assert t.moved(2, 2) == 0


def test_shuffle_refuses_bad_arguments():
    with pytest.raises(ValueError, match="positive"):
        tshuffle.assign([1, 2], 0)
    with pytest.raises(ValueError, match="non-empty"):
        tshuffle.ShuffleByAssignment([], 2)
    with pytest.raises(ValueError, match="positive"):
        tshuffle.ShuffleByAssignment([1], -1)
