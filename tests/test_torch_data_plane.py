"""The port's training data plane over object-store roots, on the CPU.

Loopback ``http.server`` stubs only (no network).  Each case holds the
port against the JAX package, or an app over an HTTP root against the
same app on the local root, with the tolerance stated:

- ``ImageNetLoader.partitions(epoch=)`` over HTTP: the same shards, in
  the same order, per worker and epoch as the JAX loader's (equal
  bytes); through a chunk cache a second epoch fetches no shard bytes,
  and the ``sparknet_cache_*`` series count what the JAX package's count
  for the same reads (after JAX ``tests/test_chunk_cache.py:275,310``);
  evictions at a byte budget and retries tick their counters too;
- ``imagenet_run_db_app`` at the narrow CaffeNet of
  ``test_torch_db_apps.py`` from ``--db_dir http://... --cache_dir``
  (cold, then warm: no DB bytes fetched) equals the local run bit for
  bit, with ``--shuffle_epochs 2`` permuting which worker reads which DB
  as ``shuffle.permutation`` says, and resuming across the epoch
  boundary bit for bit; a remote ``--db_dir`` with snapshots and no
  stable location is refused (JAX ``tests/test_db_apps.py:84``);
- ``lm_app --corpus http://... --cache_dir``, ``cli train --data
  http://... --cache_dir --shuffle_epochs 2`` (its window order the JAX
  CLI's epoch draw) and ``imagenet_app --data http://... --cache_dir
  --shuffle_epochs 2`` equal their local runs bit for bit.
"""

import contextlib
import http.server
import json
import os
import shutil
import threading
import urllib.parse

import numpy as np
import pytest
import torch

from sparknet_tpu import obs as jobs
from sparknet_tpu.data import chunk_cache as jchunk_cache
from sparknet_tpu.data import imagenet as jimagenet
from sparknet_tpu.data import object_store as jobject_store
from sparknet_tpu.data import shuffle as jshuffle
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch import obs
from sparknet_tpu_torch.apps import imagenet_app, imagenet_create_db_app
from sparknet_tpu_torch.apps import imagenet_run_db_app, lm_app
from sparknet_tpu_torch.data import CifarLoader, chunk_cache, object_store
from sparknet_tpu_torch.data import imagenet as timagenet
from sparknet_tpu_torch.data.text import write_synthetic_corpus
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils import retry
from sparknet_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # narrow nets: threads only add overhead
    yield
    torch.set_num_threads(n)


class _Served:
    """A ThreadingHTTPServer on loopback over ``directory`` that counts
    GET requests and body bytes by path."""

    def __init__(self, directory):
        self.gets, self.bytes = {}, {}
        served = self

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=directory, **kw)

            def log_message(self, *a):
                pass

            def do_GET(self):
                name = urllib.parse.unquote(self.path.lstrip("/"))
                path = os.path.join(directory, name)
                served.gets[name] = served.gets.get(name, 0) + 1
                if os.path.isfile(path):
                    served.bytes[name] = (served.bytes.get(name, 0)
                                          + os.path.getsize(path))
                return super().do_GET()

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def fetched(self, suffix=""):
        return sum(n for k, n in self.bytes.items() if k.endswith(suffix))


@contextlib.contextmanager
def served(directory):
    s = _Served(directory)
    try:
        yield s
    finally:
        s.srv.shutdown()
        s.srv.server_close()


def _same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ----------------------------------------------------------------------
# the loader and the chunk cache


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shards"))
    timagenet.write_synthetic_imagenet(d, num_shards=5, images_per_shard=4,
                                       classes=3, seed=2)
    return d


@pytest.mark.parametrize("epoch", [None, 0, 1, 2])
def test_partitions_over_http_equal_the_jax_loader(shard_dir, epoch):
    """The same (bytes, label) stream per worker as the JAX loader's, for
    the legacy deal and each epoch's seeded assignment."""
    with served(shard_dir) as s:
        tl = timagenet.ImageNetLoader(s.url)
        jl = jimagenet.ImageNetLoader(s.url)
        assert tl.list_shards("train.") == jl.list_shards("train.")
        tparts = tl.partitions("train.", "train.txt", num_parts=2,
                               epoch=epoch, shuffle_seed=9)
        jparts = jl.partitions("train.", "train.txt", num_parts=2,
                               epoch=epoch, shuffle_seed=9)
        for tp, jp in zip(tparts, jparts):
            assert list(tp) == list(jp)


def test_second_epoch_fetches_nothing_and_counts_like_jax(shard_dir,
                                                          tmp_path):
    """Through the cache, epoch 1 under a re-dealt assignment streams no
    shard bytes; the cache series equal the JAX package's for the same
    two epochs, and the decoded minibatches equal the uncached ones."""
    conv = timagenet.ScaleAndConvert(3, 24, 24)

    def consume(loader, epoch):
        return [list(conv.make_minibatches(p)) for p in loader.partitions(
            "train.", "train.txt", num_parts=2, epoch=epoch, shuffle_seed=9)]

    tm = TrainingMetrics()
    with served(shard_dir) as s, obs.installed_metrics(tm):
        loader = timagenet.ImageNetLoader(s.url, cache_dir=str(tmp_path / "c"))
        e0 = consume(loader, 0)
        cold = s.fetched(".tar")
        assert cold == sum(os.path.getsize(os.path.join(shard_dir, n))
                           for n in os.listdir(shard_dir) if n.endswith(".tar"))
        e1 = consume(loader, 1)
        assert s.fetched(".tar") == cold  # the warm epoch streamed nothing
        direct = consume(timagenet.ImageNetLoader(s.url), 0)
        shards = loader.list_shards("train.")
    assert jshuffle.ShuffleByAssignment(shards, 2, seed=9).moved(0, 1) > 0
    for cached, plain in zip(e0, direct):
        assert len(cached) == len(plain)
        for (ci, cl), (di, dl) in zip(cached, plain):
            assert np.array_equal(ci, di) and np.array_equal(cl, dl)
    assert e1
    # the same reads through the JAX loader and its process-wide series
    jobs._reset_training_metrics_for_tests()
    try:
        jtm = jobs.enable_training_metrics()
        with served(shard_dir) as s:
            jl = jimagenet.ImageNetLoader(s.url, cache_dir=str(tmp_path / "j"))
            for e in (0, 1):
                for p in jl.partitions("train.", "train.txt", num_parts=2,
                                       epoch=e, shuffle_seed=9):
                    list(p)
        want = (jtm.cache_hits.value, jtm.cache_misses.value,
                jtm.cache_bytes.labels("hit").value,
                jtm.cache_bytes.labels("miss").value)
    finally:
        jobs._reset_training_metrics_for_tests()
    got = (tm.cache_hits.value, tm.cache_misses.value,
           tm.cache_bytes.labels("hit").value,
           tm.cache_bytes.labels("miss").value)
    assert got == want
    assert tm.cache_misses.value == 5 + 1  # five shards and train.txt
    assert tm.cache_bytes.labels("miss").value == cold + os.path.getsize(
        os.path.join(shard_dir, "train.txt"))
    text = tm.registry.render()
    assert 'sparknet_cache_bytes_total{src="hit"}' in text


def test_cache_counters_hit_miss_and_evictions_equal_jax(shard_dir, tmp_path):
    """JAX ``test_cache_obs_counters``, and LRU evictions at a byte
    budget of about two shards: every counter equals the JAX cache's
    over the same reads."""
    names = [f"train.{i:05d}.tar" for i in range(5)]
    budget = 2 * os.path.getsize(os.path.join(shard_dir, names[0])) + 100
    reads = names + names[:2] + names[3:]

    def run(cc_mod, store_mod, root, installed):
        store = store_mod.open_store(root)
        cache = cc_mod.ChunkCache(str(tmp_path / installed), byte_budget=budget)
        for n in reads:
            cache.get(store, n)
        return cache.stats

    tm = TrainingMetrics()
    with served(shard_dir) as s, obs.installed_metrics(tm):
        tstats = run(chunk_cache, object_store, s.url, "t")
    jobs._reset_training_metrics_for_tests()
    try:
        jtm = jobs.enable_training_metrics()
        with served(shard_dir) as s:
            jstats = run(jchunk_cache, jobject_store, s.url, "j")
        want = [jtm.cache_hits.value, jtm.cache_misses.value,
                jtm.cache_evictions.value]
    finally:
        jobs._reset_training_metrics_for_tests()
    assert tstats == jstats
    got = [tm.cache_hits.value, tm.cache_misses.value,
           tm.cache_evictions.value]
    assert got == want and tm.cache_evictions.value > 0


def test_retries_tick_the_io_retries_counter(monkeypatch):
    """A scheduled retry counts on sparknet_io_retries_total (JAX
    ``utils/retry.py``); none is counted without installed metrics."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionResetError("reset")
        return "ok"

    policy = retry.RetryPolicy(max_attempts=5, base_s=0.001, cap_s=0.002,
                               budget_s=1.0)
    retryable = lambda e: isinstance(e, ConnectionResetError)  # noqa: E731
    tm = TrainingMetrics()
    with obs.installed_metrics(tm):
        assert retry.retry_call(flaky, policy, retryable) == "ok"
    assert tm.retries.value == 2
    assert obs.training_metrics() is None
    calls["n"] = 0
    assert retry.retry_call(flaky, policy, retryable) == "ok"
    assert tm.retries.value == 2


# ----------------------------------------------------------------------
# imagenet_run_db_app over HTTP


WIDTHS = {"conv1": 8, "conv2": 16, "conv3": 24, "conv4": 24, "conv5": 16,
          "fc6": 32, "fc7": 32}


@pytest.fixture
def narrow_caffenet(monkeypatch):
    """The zoo serves CaffeNet's layer sequence at narrow widths with
    dropout 0 (as ``test_torch_db_apps.py``)."""
    load = tmodels.load_model

    def narrowed(name, **kw):
        netp = load(name, **kw)
        if name == "caffenet":
            for lp in netp.layer:
                if lp.name in WIDTHS:
                    p = lp.convolution_param or lp.inner_product_param
                    p.num_output = WIDTHS[lp.name]
                if lp.type == "Dropout":
                    lp.dropout_param.dropout_ratio = 0.0
        return netp

    monkeypatch.setattr(tmodels, "load_model", narrowed)


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dbs"))
    assert imagenet_create_db_app.main(["--out", d, "--workers", "2",
                                        "--seed", "3"]) == 0
    return d


def _db(db, *extra, result=None):
    r = {} if result is None else result
    assert imagenet_run_db_app.main(
        ["--db_dir", db, "--device", "cpu", "--tau", "2", "--test_every", "1",
         "--seed", "1", *extra], r) == 0
    return r


def _same_db_run(a, b):
    _same_state(a["state"], b["state"])
    assert np.array_equal(a["losses"], b["losses"])
    assert a["smoothed"] == b["smoothed"]
    assert a["accuracies"] == b["accuracies"]


def test_run_db_app_over_http_equals_local(db_dir, tmp_path, narrow_caffenet):
    """Cold cache, warm cache (no DB bytes fetched, every read a hit) and
    the local directory give the same run bit for bit, under
    --shuffle_epochs 2."""
    flags = ("--rounds", "2", "--shuffle_epochs", "2")
    local = _db(db_dir, *flags)
    cache = str(tmp_path / "cache")
    with served(db_dir) as s:
        cold = _db(s.url, "--cache_dir", cache, *flags)
        cold_bytes = s.fetched(".sndb")
        assert cold_bytes == sum(os.path.getsize(os.path.join(db_dir, n))
                                 for n in os.listdir(db_dir)
                                 if n.endswith(".sndb"))
        warm = _db(s.url, "--cache_dir", cache, *flags)
        assert s.fetched(".sndb") == cold_bytes  # the warm run fetched none
    for run in (cold, warm):
        _same_db_run(local, run)
    tm = warm["metrics"]
    assert tm.cache_bytes.labels("miss").value == 0
    assert tm.cache_hits.value == 2 * 2 + 2  # 4 DBs, the info, the mean
    assert cold["metrics"].cache_misses.value == 6


def test_run_db_shuffle_permutes_which_worker_reads_which_db(db_dir,
                                                             narrow_caffenet):
    """Seed 1 deals the two DBs [0, 1] in epoch 0 and [1, 0] in epoch 1
    (``shuffle.permutation``, the JAX table): round 1's first-iteration
    loss of worker w is the fixed-assignment run's of worker 1 - w (the
    workers start a round from one averaged state and dropout is 0)."""
    assert jshuffle.permutation(2, 1, 0) == [0, 1]
    assert jshuffle.permutation(2, 1, 1) == [1, 0]
    plain = _db(db_dir, "--rounds", "2")
    shuffled = _db(db_dir, "--rounds", "2", "--shuffle_epochs", "2")
    assert np.array_equal(plain["losses"][0], shuffled["losses"][0])
    assert shuffled["losses"][1, 0, 0] == plain["losses"][1, 1, 0]
    assert shuffled["losses"][1, 1, 0] == plain["losses"][1, 0, 0]


def test_run_db_resume_across_the_epoch_boundary(db_dir, tmp_path,
                                                 narrow_caffenet):
    """4 rounds in 2 epochs with --compress int8 and a snapshot every 2,
    over the cache; the round-2 snapshot resumed for rounds 2-3 (the
    epoch after the boundary) ends bit-identical, residuals included."""
    cache = str(tmp_path / "cache")
    c = ("--compress", "int8", "--shuffle_epochs", "2", "--cache_dir", cache)
    with served(db_dir) as s:
        straight = _db(s.url, "--rounds", "4", "--snapshot_every", "2",
                       "--snapshot_prefix", str(tmp_path / "a" / "s"), *c)
        # the run killed after its round-2 snapshot: that snapshot alone
        os.makedirs(tmp_path / "b")
        for n in os.listdir(tmp_path / "a"):
            if "_iter_4." in n:
                shutil.copy(tmp_path / "a" / n, tmp_path / "b" / n)
        resumed = _db(s.url, "--rounds", "2", "--snapshot_every", "2",
                      "--snapshot_prefix", str(tmp_path / "b" / "s"),
                      "--resume", *c)
    assert resumed["start_round"] == 2
    _same_state(straight["state"], resumed["state"])
    assert np.array_equal(straight["losses"][2:], resumed["losses"])
    ea = straight["trainer"].export_comm_state()
    er = resumed["trainer"].export_comm_state()
    for k in ea["resid"]:
        assert np.array_equal(ea["resid"][k], er["resid"][k])


@pytest.mark.parametrize("flag", [["--snapshot_every", "1"], ["--resume"]])
def test_remote_db_dir_needs_a_stable_location(flag):
    """JAX ``test_db_apps.py:84``: snapshots in a temporary cache would be
    unfindable on restart, so a remote --db_dir with --snapshot_every or
    --resume needs --cache_dir or --snapshot_prefix (refused before any
    request)."""
    with pytest.raises(SystemExit, match="stable --cache_dir"):
        imagenet_run_db_app.main(["--db_dir", "http://127.0.0.1:9/dbs",
                                  "--device", "cpu"] + flag)


# ----------------------------------------------------------------------
# lm_app, cli train and imagenet_app over HTTP

LM = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2",
      "--seq_len", "32", "--batch", "4", "--tau", "2", "--rounds", "2"]


def test_lm_app_corpus_over_http_equals_local(tmp_path):
    corpus = str(tmp_path / "corpus")
    write_synthetic_corpus(corpus, num_docs=4, seed=3)
    local, remote = {}, {}
    assert lm_app.main(LM + ["--corpus", corpus], local) == 0
    with served(corpus) as s:
        assert lm_app.main(LM + ["--corpus", s.url, "--cache_dir",
                                 str(tmp_path / "c"), "--cache_bytes", "1G"],
                           remote) == 0
        assert s.fetched(".txt") == sum(
            os.path.getsize(os.path.join(corpus, n)) for n in os.listdir(corpus))
    _same_state(local["state"], remote["state"])
    assert np.array_equal(local["losses"], remote["losses"])
    assert remote["metrics"].cache_misses.value == 4


CIFAR_NET = """
name: "toy"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 10 dim: 3 dim: 32 dim: 32 } shape { dim: 10 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""


def _cli_solver(tmp_path, name):
    net = tmp_path / "toy.prototxt"
    net.write_text(CIFAR_NET)
    p = tmp_path / f"{name}.prototxt"
    p.write_text(f'net: "{net}"\nbase_lr: 1e-5\nlr_policy: "fixed"\n'
                 f'momentum: 0.9\nsnapshot_prefix: "{tmp_path}/{name}/ck"\n')
    return str(p)


def test_cli_train_over_http_with_shuffled_epochs(tmp_path, monkeypatch):
    """``--data http://... --cache_dir --shuffle_epochs 2`` equals the
    local run bit for bit, and the windows are the JAX CLI's epoch draw:
    window r takes minibatches ``permutation(total, seed, e)[pos:pos +
    tau]`` of epoch ``e = r // (total // tau)``."""
    from sparknet_tpu_torch import solver as tsolver

    cifar = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(cifar, num_train=60, num_test=10, seed=4)
    seen = []
    step = tsolver.Solver.step

    def spy(self, state, batch, *a, **kw):
        seen.append(batch["label"].clone())
        return step(self, state, batch, *a, **kw)

    monkeypatch.setattr(tsolver.Solver, "step", spy)
    base = ["train", "--device=cpu", "--tau=2", "--max_iter=8",
            "--shuffle_epochs=2", "--seed=5"]
    local, remote = {}, {}
    assert cli.main(base + [f"--solver={_cli_solver(tmp_path, 'a')}",
                            f"--data={cifar}"], local) == 0
    local_windows, seen[:] = list(seen), []
    with served(cifar) as s:
        assert cli.main(base + [f"--solver={_cli_solver(tmp_path, 'b')}",
                                f"--data={s.url}",
                                f"--cache_dir={tmp_path / 'cache'}"],
                        remote) == 0
    _same_state(local["state"], remote["state"])
    assert all(torch.equal(a, b) for a, b in zip(local_windows, seen))
    # 6 minibatches of 10, tau 2: 3 windows an epoch, 4 windows in all
    _, y = CifarLoader(cifar).minibatches(10)
    for r, got in enumerate(seen):
        e, pos = r // 3, (r % 3) * 2
        idx = jshuffle.permutation(6, 5, e)[pos:pos + 2]
        assert np.array_equal(got.numpy(), y[idx])


def test_imagenet_app_over_http_with_shuffled_epochs(shard_dir, tmp_path):
    """``imagenet_app --data http://... --cache_dir --shuffle_epochs 2``
    equals the local run bit for bit (epoch 1's partitions reloaded on
    the feed's thread from the cache); the mean lands next to the cache."""
    argv = ["--device", "cpu", "--model", "caffenet", "--workers", "2",
            "--tau", "1", "--rounds", "2", "--test_every", "1",
            "--train_batch", "2", "--test_batch", "2", "--full_size", "72",
            "--crop", "67", "--classes", "3", "--shuffle_epochs", "2",
            "--train_prefix", "train.", "--test_prefix", "train.",
            "--test_labels", "train.txt"]
    with tmp_copy(shard_dir, tmp_path) as local_dir:
        local, remote = {}, {}
        assert imagenet_app.main(argv + ["--data", local_dir], local) == 0
    cache = str(tmp_path / "cache")
    with served(shard_dir) as s:
        assert imagenet_app.main(argv + ["--data", s.url, "--cache_dir", cache],
                                 remote) == 0
        assert s.fetched(".tar") == sum(
            os.path.getsize(os.path.join(shard_dir, n))
            for n in os.listdir(shard_dir) if n.endswith(".tar"))
    _same_state(local["state"], remote["state"])
    assert np.array_equal(local["losses"], remote["losses"])
    assert np.array_equal(local["mean"], remote["mean"])
    assert os.path.exists(os.path.join(cache, "mean.binaryproto"))
    assert remote["metrics"].cache_hits.value > 0


@contextlib.contextmanager
def tmp_copy(src, tmp_path):
    """A copy of ``src`` (the app writes its mean into a local root)."""
    dst = str(tmp_path / "local_copy")
    shutil.copytree(src, dst)
    yield dst


def test_imagenet_app_epoch_partitions_follow_the_jax_assignment(shard_dir,
                                                                 tmp_path):
    """``data_stage`` loads epoch 0's assignment under --shuffle_epochs and
    ``reload(e)`` epoch e's: the JAX loader's partitions, decoded."""
    with tmp_copy(shard_dir, tmp_path) as root:
        args = imagenet_app.parse_args([
            "--data", root, "--device", "cpu", "--train_batch", "2",
            "--test_batch", "2", "--full_size", "24", "--shuffle_epochs", "3",
            "--seed", "4", "--test_prefix", "train.", "--test_labels",
            "train.txt"])

        class _Log:
            def log(self, *a, **kw):
                pass

        train_parts, _, _, reload = imagenet_app.data_stage(
            args, 2, _Log(), root)
        conv = jimagenet.ScaleAndConvert(2, 24, 24)
        jl = jimagenet.ImageNetLoader(root)
        for e, parts in ((0, train_parts), (1, reload(1)), (2, reload(2))):
            jparts = jl.partitions("train.", "train.txt", num_parts=2,
                                   epoch=e, shuffle_seed=4)
            for (x, y), jp in zip(parts, jparts):
                mbs = list(conv.make_minibatches(jp))
                assert np.array_equal(x, np.stack([m[0] for m in mbs]))
                assert np.array_equal(y, np.stack([m[1] for m in mbs]))
