"""The port's host data pipeline against the JAX package's.

Everything here is numpy-seeded, so the port must draw exactly what
the JAX package draws for the same seed: the synthesized CIFAR files,
the mean-subtracted minibatches, each worker's window sampler and the
worker-stacked round layout.  The pipelined round feed must hand over
the same batches as assembling them on the caller's thread.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.data import CifarLoader as JLoader
from sparknet_tpu.data import MinibatchSampler as JSampler
from sparknet_tpu.data import stack_windows as jstack
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu_torch.data import CifarLoader, MinibatchSampler, RoundFeed, stack_windows
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer


@pytest.fixture(scope="module")
def cifar_dirs(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_cifar")
    tdir = tmp_path_factory.mktemp("torch_cifar")
    JLoader.write_synthetic(str(jdir), num_train=500, num_test=120, seed=3)
    CifarLoader.write_synthetic(str(tdir), num_train=500, num_test=120, seed=3)
    return str(jdir), str(tdir)


def test_synthetic_files_and_minibatches_match(cifar_dirs):
    jdir, tdir = cifar_dirs
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        with open(f"{jdir}/{name}", "rb") as a, open(f"{tdir}/{name}", "rb") as b:
            assert a.read() == b.read()
    jl, tl = JLoader(jdir, seed=1), CifarLoader(tdir, seed=1)
    for train in (True, False):
        jx, jy = jl.minibatches(20, train=train)
        tx, ty = tl.minibatches(20, train=train)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_windows_and_round_layout_match(cifar_dirs):
    jdir, tdir = cifar_dirs
    x, y = CifarLoader(tdir, seed=0).minibatches(10)
    parts = list(zip(np.array_split(x, 3), np.array_split(y, 3)))
    js = [JSampler({"data": a, "label": b}, 4, seed=w) for w, (a, b) in enumerate(parts)]
    ts = [MinibatchSampler({"data": a, "label": b}, 4, seed=w)
          for w, (a, b) in enumerate(parts)]
    for _ in range(5):
        jr = jstack([s.next_window() for s in js])
        tr = stack_windows([s.next_window() for s in ts])
        assert set(jr) == set(tr) == {"data", "label"}
        for k in jr:
            np.testing.assert_array_equal(tr[k], jr[k])
            assert tr[k].shape[:2] == (3, 4)
    out = {k: np.empty_like(v) for k, v in tr.items()}
    again = stack_windows([s.next_window() for s in ts], out)
    assert again is out


def test_pad_partitions_match():
    rs = np.random.RandomState(0)
    parts = [{"data": rs.randn(n, 2).astype(np.float32),
              "label": rs.randint(0, 3, n).astype(np.float32)} for n in (3, 2, 3)]
    jb, jc = JTrainer.pad_partitions(parts)
    tb, tc = ParameterAveragingTrainer.pad_partitions(parts)
    np.testing.assert_array_equal(tc, jc)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("pipelined", [True, False])
def test_round_feed_hands_over_the_assembled_rounds(pipelined):
    calls = []

    def assemble(r):
        calls.append(r)
        return {"x": np.full((2, 3), r, np.float32)}

    feed = RoundFeed(assemble, torch.device("cpu"), pipelined=pipelined,
                     num_rounds=4)
    try:
        for r in range(4):
            got = feed.next_round(r)
            assert torch.equal(got["x"], torch.full((2, 3), float(r)))
        with pytest.raises(StopIteration):
            feed.next_round(4)
        with pytest.raises(ValueError, match="in order"):
            feed.next_round(7)
    finally:
        assert feed.stop()
    assert calls == [0, 1, 2, 3]


def test_round_feed_raises_the_producer_error():
    def assemble(r):
        raise KeyError("no such window")

    feed = RoundFeed(assemble, torch.device("cpu"), num_rounds=2)
    try:
        with pytest.raises(KeyError, match="no such window"):
            feed.next_round(0)
    finally:
        assert feed.stop()
