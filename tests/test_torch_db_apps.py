"""The port's two-phase ImageNet DB path and CIFAR DB app against the JAX
package's, on the CPU.

- ``imagenet_create_db_app``: on the same synthesized JPEG shards and
  seed, every file it writes (the per-worker train and val record DBs,
  the infoFile, the mean image) equals the JAX app's byte for byte.
- One warm-started round of ``imagenet_run_db_app`` (W=2, tau=2, train
  batch 8, full 64, crop 56, 4 classes: the JAX app's scaled-down
  defaults) against the JAX trainer fed by the JAX reader from the same
  DBs and warm-started from the same ``.caffemodel``: round losses and
  params within rtol 1e-5 / atol 1e-6 (the tolerance of
  ``test_torch_imagenet.py::test_trainer_round_matches_the_jax_trainer``),
  test scores within rtol 1e-5.  Both nets are CaffeNet's layer sequence
  at narrow widths (8/16/24/24/16 convolutions, fc 32; the JAX CaffeNet
  at full width takes ~20 s to set up here) with ``dropout_ratio`` 0 —
  training-step randomness is backend-dependent by design.
- Resume: 2 rounds with a snapshot every round, then ``--resume`` for 1,
  equal bit for bit to 3 rounds straight through (params, every
  worker's momentum, the comm residuals, every loss, the accuracies),
  with no compression and with ``--compress int8``; dropout on.  A
  corrupt newest snapshot is quarantined and the run falls back to the
  older one; a ``--tau`` other than the snapshot's is refused.
- ``cifar_db_app``: its DBs and mean image equal the JAX app's byte for
  byte, and its round on the CPU (cifar10_full, W=2, tau=2, batch 100)
  matches the JAX trainer's on the JAX reader's batches (losses and
  params rtol 1e-5 / atol 1e-6, test scores rtol 1e-5).
- Refusals: every flag of a later slice exits saying "not yet ported".
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu import runtime as jruntime
from sparknet_tpu.apps import cifar_db_app as jcifar_db_app
from sparknet_tpu.apps import imagenet_create_db_app as jcreate_db
from sparknet_tpu.io import caffemodel as jcaffemodel
from sparknet_tpu.io import checkpoint as jcheckpoint
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import first_worker as jfirst_worker
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.apps import cifar_db_app, imagenet_create_db_app
from sparknet_tpu_torch.apps import imagenet_run_db_app
from sparknet_tpu_torch.data import CifarLoader
from sparknet_tpu_torch.io import caffemodel as tcaffemodel
from sparknet_tpu_torch.io import checkpoint as tcheckpoint
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.utils.tree import tree_leaves

W, TAU = 2, 2
WIDTHS = {"conv1": 8, "conv2": 16, "conv3": 24, "conv4": 24, "conv5": 16,
          "fc6": 32, "fc7": 32}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The narrow nets' CPU convolutions are a few microseconds of work:
    under the parallel test run's load torch's 8 intra-op threads made
    this file ~40 times slower than one thread does (measured here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow(netp, dropout=None):
    """CaffeNet's layer sequence at the narrow WIDTHS (either package's
    NetParameter, in place); ``dropout`` sets every dropout ratio."""
    for lp in netp.layer:
        if lp.name in WIDTHS:
            p = lp.convolution_param or lp.inner_product_param
            p.num_output = WIDTHS[lp.name]
        if lp.type == "Dropout" and dropout is not None:
            lp.dropout_param.dropout_ratio = dropout
    return netp


@pytest.fixture
def narrow_caffenet(monkeypatch):
    """The port's zoo serves the narrow CaffeNet; returns a setter for
    its dropout ratio."""
    load = tmodels.load_model
    ratio = {"dropout": None}

    def narrowed(name, **kw):
        netp = load(name, **kw)
        return narrow(netp, ratio["dropout"]) if name == "caffenet" else netp

    monkeypatch.setattr(tmodels, "load_model", narrowed)
    return ratio


@pytest.fixture(scope="module")
def db_pair(tmp_path_factory):
    """The same synthesized shards through both create-DB apps."""
    jdir = str(tmp_path_factory.mktemp("jax_dbs"))
    tdir = str(tmp_path_factory.mktemp("port_dbs"))
    argv = ["--workers", str(W), "--seed", "3"]
    assert jcreate_db.main(["--out", jdir] + argv) == 0
    assert imagenet_create_db_app.main(["--out", tdir] + argv) == 0
    return jdir, tdir


def _files(d):
    return sorted(os.listdir(d))


def test_create_db_files_equal_the_jax_app(db_pair):
    jdir, tdir = db_pair
    names = _files(jdir)
    assert names == _files(tdir) == [
        "ilsvrc12_train_db_0.sndb", "ilsvrc12_train_db_1.sndb",
        "ilsvrc12_val_db_0.sndb", "ilsvrc12_val_db_1.sndb",
        "imagenet_db_info.json", "imagenet_mean.binaryproto"]
    for name in names:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(tdir, "imagenet_db_info.json")) as f:
        info = json.load(f)
    assert info["full_size"] == 64 and info["classes"] == 4
    assert info["train_batches"] == [6, 6] and min(info["test_batches"]) >= 1


def _warm_start_file(path, dropout=0.0):
    netp = narrow(tmodels.load_model("caffenet", classes=4, image=56), dropout)
    net = TorchNet(netp, "TRAIN", feed_shapes=None)
    params, stats = net.init(seed=11, device="cpu")
    tcaffemodel.save_weights(tcaffemodel.net_blobs(net, params, stats), path)
    return path


def _jax_pipes(db_dir, info, crop, seed):
    mean = jcaffemodel.load_mean_image(
        os.path.join(db_dir, "imagenet_mean.binaryproto"))
    full = int(info["full_size"])
    train = [jruntime.DataPipeline(
        os.path.join(db_dir, f"ilsvrc12_train_db_{w}.sndb"),
        batch_size=int(info["train_batch"]), shape=(3, full, full),
        crop=crop, mirror=True, train=True, mean=mean, seed=seed + w)
        for w in range(W)]
    test = [jruntime.DataPipeline(
        os.path.join(db_dir, f"ilsvrc12_val_db_{w}.sndb"),
        batch_size=int(info["test_batch"]), shape=(3, full, full),
        crop=crop, train=False, mean=mean, seed=seed)
        for w in range(W)]
    return train, test


def test_warm_started_round_matches_the_jax_trainer(db_pair, tmp_path,
                                                    narrow_caffenet):
    _, db_dir = db_pair
    narrow_caffenet["dropout"] = 0.0
    weights = _warm_start_file(str(tmp_path / "warm.caffemodel"))
    result = {}
    rc = imagenet_run_db_app.main(
        ["--db_dir", db_dir, "--device", "cpu", "--tau", str(TAU), "--rounds",
         "1", "--warm_start", weights, "--seed", "5"], result)
    assert rc == 0
    with open(os.path.join(db_dir, "imagenet_db_info.json")) as f:
        info = json.load(f)
    crop = 56
    # the JAX trainer on the JAX reader's batches, warm-started alike
    jnetp = narrow(jmodels.load_model("caffenet", classes=4), 0.0)
    jnetp = jconfig.replace_data_layers(
        jnetp, [(8, 3, crop, crop), (8,)], [(4, 3, crop, crop), (4,)])
    jsolver = JSolver(jmodels.load_model_solver("caffenet"), net_param=jnetp)
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jt = JTrainer(jsolver, mesh)
    jstate = jt.init_state(seed=5)
    jstate = jt.broadcast_state(jcheckpoint.load_weights_into_state(
        jsolver, jfirst_worker(jax.device_get(jstate)), weights))
    train, test = _jax_pipes(db_dir, info, crop, seed=5)
    try:
        windows = []
        for p in train:
            bs = [p.next() for _ in range(TAU)]
            windows.append({"data": np.stack([b[0] for b in bs]),
                            "label": np.stack([b[1] for b in bs])})
        counts = np.asarray(info["test_batches"], np.int32)
        tb = {"data": np.zeros((W, counts.max(), 4, 3, crop, crop), np.float32),
              "label": np.zeros((W, counts.max(), 4), np.float32)}
        for w, p in enumerate(test):
            for b in range(counts[w]):
                tb["data"][w, b], tb["label"][w, b] = p.next()
    finally:
        for p in train + test:
            p.close()
    batch = {k: np.stack([x[k] for x in windows]) for k in windows[0]}
    jstate, jl = jt.round(jstate, shard_leading(batch, mesh))
    np.testing.assert_allclose(result["losses"][0], np.asarray(jl), **TOL)
    tstate = result["state"]
    for k, blobs in tstate.params.items():
        for i, t in enumerate(blobs):
            np.testing.assert_allclose(t.numpy(), np.asarray(jstate.params[k][i]),
                                       err_msg=f"{k}[{i}]", **TOL)
    jscores = jt.test_and_store_result(jstate, shard_leading(tb, mesh),
                                       counts=counts)
    tscores = result["trainer"].test_and_store_result(
        tstate, {k: torch.from_numpy(v) for k, v in tb.items()}, counts=counts)
    for name in ("accuracy", "loss"):
        np.testing.assert_allclose(tscores[name], jscores[name], rtol=1e-5)
    assert result["accuracies"][-1] == pytest.approx(
        jscores["accuracy"] / counts.sum(), rel=1e-6)


def _run(db_dir, prefix, rounds, *extra):
    result = {}
    rc = imagenet_run_db_app.main(
        ["--db_dir", db_dir, "--device", "cpu", "--tau", str(TAU),
         "--test_every", "1", "--seed", "5", "--snapshot_prefix", prefix,
         "--snapshot_every", "1", "--rounds", str(rounds), *extra], result)
    assert rc == 0
    return result


def _same_state(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_resume_equals_the_uninterrupted_run(db_pair, tmp_path,
                                             narrow_caffenet, compress):
    _, db_dir = db_pair
    c = ["--compress", compress]
    straight = _run(db_dir, str(tmp_path / "a" / "s"), 3, *c)
    first = _run(db_dir, str(tmp_path / "b" / "s"), 2, *c)
    resumed = _run(db_dir, str(tmp_path / "b" / "s"), 1, "--resume", *c)
    assert resumed["start_round"] == 2
    _same_state(straight["state"], resumed["state"])  # every worker's history
    assert np.array_equal(straight["losses"],
                          np.concatenate([first["losses"], resumed["losses"]]))
    assert straight["smoothed"] == first["smoothed"] + resumed["smoothed"]
    # round-2 test, final test
    assert straight["accuracies"][2:] == resumed["accuracies"]
    ea = straight["trainer"].export_comm_state()
    er = resumed["trainer"].export_comm_state()
    assert (ea is None) == (er is None) == (compress == "none")
    if ea is not None:
        for k in ea["resid"]:
            assert np.array_equal(ea["resid"][k], er["resid"][k])


def test_corrupt_newest_snapshot_is_quarantined(db_pair, tmp_path,
                                                narrow_caffenet):
    _, db_dir = db_pair
    prefix = str(tmp_path / "snap" / "imagenet_db")
    straight = _run(db_dir, str(tmp_path / "a" / "s"), 3)
    _run(db_dir, prefix, 2)
    snaps = tcheckpoint.find_snapshots(prefix)
    assert [os.path.basename(s) for s in snaps] == [
        "imagenet_db_iter_2.solverstate.npz",
        "imagenet_db_iter_4.solverstate.npz"]
    with pytest.raises(SystemExit, match="resume with its --tau"):
        _run(db_dir, prefix, 1, "--resume", "--tau", "4")
    with open(snaps[-1], "r+b") as f:  # a preemption mid-write
        f.seek(40)
        f.write(b"\xff" * 16)
    resumed = _run(db_dir, prefix, 2, "--resume")
    assert resumed["start_round"] == 1
    assert resumed["resumed_from"] == snaps[0]  # fell back past the corrupt one
    assert os.path.exists(snaps[-1] + ".corrupt")
    _same_state(straight["state"], resumed["state"])
    with pytest.raises(SystemExit, match="no .*solverstate"):
        _run(db_dir, str(tmp_path / "none" / "s"), 1, "--resume")


# ----------------------------------------------------------------------
# cifar_db_app
# ----------------------------------------------------------------------
def test_cifar_db_app_matches_the_jax_app(tmp_path):
    data = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(data, num_train=1000, num_test=400)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jpaths, jtest, jmean = jcifar_db_app.create_dbs(data, jdir, W, seed=2)
    cifar_db_app.create_dbs(data, tdir, W, seed=2)
    assert _files(jdir) == _files(tdir) == [
        "mean.binaryproto", "test.sndb", "train_shard_0.sndb",
        "train_shard_1.sndb"]
    for name in _files(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    result = {}
    rc = cifar_db_app.main(["--device", "cpu", "--data", data, "--db_dir",
                            str(tmp_path / "t2"), "--workers", str(W),
                            "--rounds", "1", "--tau", str(TAU), "--seed", "2"],
                           result)
    assert rc == 0
    # the JAX app's round: its solver, init and reader
    mean = jcaffemodel.load_mean_image(jmean)
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jt = JTrainer(JSolver(jmodels.load_model_solver("cifar10_full")), mesh)
    jstate = jt.init_state(seed=2)
    pipes = [jruntime.DataPipeline(p, batch_size=100, shape=(3, 32, 32),
                                   mean=mean, train=True, seed=2 + w)
             for w, p in enumerate(jpaths)]
    pipes.append(jruntime.DataPipeline(jtest, batch_size=100,
                                       shape=(3, 32, 32), mean=mean,
                                       train=False))
    try:
        windows = []
        for p in pipes[:W]:
            bs = [p.next() for _ in range(TAU)]
            windows.append({"data": np.stack([b[0] for b in bs]),
                            "label": np.stack([b[1] for b in bs])})
        tb = [pipes[W].next() for _ in range(W * 2)]
    finally:
        for p in pipes:
            p.close()
    batch = {k: np.stack([x[k] for x in windows]) for k in windows[0]}
    jstate, jl = jt.round(jstate, shard_leading(batch, mesh))
    np.testing.assert_allclose(result["losses"][0], np.asarray(jl), **TOL)
    for k, blobs in result["state"].params.items():
        for i, t in enumerate(blobs):
            np.testing.assert_allclose(t.numpy(), np.asarray(jstate.params[k][i]),
                                       err_msg=f"{k}[{i}]", **TOL)
    test = {"data": np.stack([b[0] for b in tb]).reshape(W, 2, 100, 3, 32, 32),
            "label": np.stack([b[1] for b in tb]).reshape(W, 2, 100)}
    jscores = jt.test_and_store_result(jstate, shard_leading(test, mesh))
    for name in ("accuracy", "loss"):
        np.testing.assert_allclose(result["scores"][name], jscores[name],
                                   rtol=1e-5)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
@pytest.mark.parametrize("flag", [
    ["--trace_out", "/t"], ["--obs"], ["--obs_port", "1"], ["--slo"],
    ["--model", "googlenet"]])
def test_run_db_app_refuses_what_is_not_yet_ported(flag):
    """(The chunk cache, ``--shuffle_epochs`` and an object-store
    ``--db_dir`` run now: ``tests/test_torch_data_plane.py``.)"""
    with pytest.raises(SystemExit, match="not yet ported") as e:
        imagenet_run_db_app.main(["--db_dir", "/nonexistent", "--device",
                                  "cpu"] + flag)
    assert flag[0].lstrip("-").split("_")[0] in str(e.value)


@pytest.mark.parametrize("flag", [
    ["--trace_out", "/t"], ["--obs_port", "1"], ["--slo"], ["--obs"]])
def test_cifar_db_app_refuses_what_is_not_yet_ported(flag):
    with pytest.raises(SystemExit, match="not yet ported") as e:
        cifar_db_app.main(["--device", "cpu"] + flag)
    assert flag[0] in str(e.value)


@pytest.mark.parametrize("flag", [["--snapshot_every", "1"], ["--resume"]])
def test_run_db_app_refuses_overlap_with_snapshots(flag):
    """An overlapped average leaves the workers' params apart, and a
    snapshot keeps worker 0's: such a run could not resume to the bit."""
    with pytest.raises(SystemExit, match="--overlap_avg with"):
        imagenet_run_db_app.main(["--db_dir", "/nonexistent", "--device",
                                  "cpu", "--overlap_avg"] + flag)


def test_create_db_app_refuses_object_store_data():
    with pytest.raises(SystemExit, match="not yet ported"):
        imagenet_create_db_app.main(["--data", "gs://bucket/imagenet"])


# ----------------------------------------------------------------------
# --stale_bound and --profile / --profile_out
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def stale_and_sync(db_pair, tmp_path_factory):
    """The narrow CaffeNet DB run, 3 rounds, journaled: synchronous with
    ``--profile_out``, then ``--stale_bound 2`` with ``--profile``, then
    the stale run as 2 rounds + ``--resume`` for 1."""
    _, db_dir = db_pair
    d = tmp_path_factory.mktemp("stale")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        load = tmodels.load_model
        mp.setattr(tmodels, "load_model", lambda name, **kw: (
            narrow(load(name, **kw), 0.0) if name == "caffenet"
            else load(name, **kw)))
        out = {"profile_out": str(d / "p.json")}
        out["sync"] = _run(db_dir, str(d / "sync" / "s"), 3, "--journal",
                           "--profile_out", out["profile_out"])
        st = ["--stale_bound", "2", "--journal"]
        out["stale"] = _run(db_dir, str(d / "stale" / "s"), 3, *st, "--profile")
        out["first"] = _run(db_dir, str(d / "res" / "s"), 2, *st)
        out["resumed"] = _run(db_dir, str(d / "res" / "s"), 1, "--resume", *st)
        out["dir"] = d
    torch.set_num_threads(n)
    return out


def test_run_db_app_stale_bound_trains_as_the_jax_app(stale_and_sync):
    """Every worker arrives at every boundary (the app models no
    straggler), so the staleness-weighted mean is the synchronous mean
    up to rounding: allclose, not bitwise, as the JAX package pins."""
    from sparknet_tpu_torch.parallel.stale import BoundedStalenessTrainer

    sync, stale = stale_and_sync["sync"], stale_and_sync["stale"]
    tr = stale["trainer"]
    assert isinstance(tr, BoundedStalenessTrainer) and tr.stale_bound == 2
    assert list(tr.worker_rounds) == [3] * W
    assert tr.last_boundary["forced"] == [False] * W
    for a, b in zip(tree_leaves(sync["state"].params),
                    tree_leaves(stale["state"].params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_run_db_app_stale_journal_and_resume_carry_the_ledger(stale_and_sync):
    from sparknet_tpu_torch.io.journal import scan

    recs, torn = scan(str(stale_and_sync["dir"] / "stale" / "s_run.journal"))
    assert torn == 0 and recs
    assert all(r["worker_rounds"] and r["stale_bound"] == 2 for r in recs)
    assert [r["worker_rounds"] for r in recs if r["kind"] == "commit"] == \
        [[k] * W for k in (1, 2, 3)]
    sync_recs, _ = scan(str(stale_and_sync["dir"] / "sync" / "s_run.journal"))
    assert not any("worker_rounds" in r for r in sync_recs)
    # the snapshot's jobstate carries the ledger and every replica: the
    # resumed run continues the ledger and ends on the straight run's bits
    resumed = stale_and_sync["resumed"]
    assert resumed["start_round"] == 2
    assert list(resumed["trainer"].worker_rounds) == [3] * W
    _same_state(stale_and_sync["stale"]["state"], resumed["state"])


@pytest.mark.parametrize("which", ["profile", "profile_out"])
def test_run_db_app_profile_summarizes_the_rounds(stale_and_sync, which):
    """``--profile`` prints the round anatomy at the end; ``--profile_out``
    also writes it: every worker's DB pull timed (assemble), the feed's
    h2d, the trainer's execute and average, per-worker execute times."""
    import json

    if which == "profile_out":
        s = json.load(open(stale_and_sync["profile_out"]))
    else:
        s = stale_and_sync["stale"]["profile"]
    assert s["rounds"] == 3
    assert {"assemble", "h2d", "execute", "average"} <= set(s["phases"])
    assert len(s["worker_execute_ms"]["p50"]) == W
    assert s["flops_per_round"] > 0 and s["mfu"] is None


@pytest.mark.parametrize("flag", [["--stale_bound", "1"], ["--profile"],
                                  ["--profile_out"]])
def test_cifar_db_app_runs_stale_and_profile(tmp_path, flag):
    import json

    data = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(data, num_train=1000, num_test=400)
    base = ["--device", "cpu", "--data", data, "--db_dir", str(tmp_path / "t"),
            "--workers", str(W), "--rounds", "2", "--tau", str(TAU),
            "--seed", "2"]
    if flag == ["--profile_out"]:
        flag = flag + [str(tmp_path / "p.json")]
    sync, got = {}, {}
    assert cifar_db_app.main(base, sync) == 0
    assert cifar_db_app.main(base + flag, got) == 0
    if flag[0] == "--stale_bound":
        assert list(got["trainer"].worker_rounds) == [2] * W
        for a, b in zip(tree_leaves(sync["state"].params),
                        tree_leaves(got["state"].params)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-6)
    else:
        s = got["profile"]
        assert s["rounds"] == 2 and "assemble" in s["phases"]
        assert s["worker_skew"] is not None
        if flag[0] == "--profile_out":
            assert json.load(open(flag[1]))["rounds"] == 2
