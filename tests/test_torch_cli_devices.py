"""``cli train --devices N``: Caffe's own multi-GPU training across OS
processes, on the CPU over gloo.

The port of the JAX ``cli train --devices`` (``sparknet_tpu/tools/
cli.py:151-185``): the TRAIN data layers' batch scales by N, every rank
draws the same global window and keeps its rows, and the
``AllReduceTrainer`` steps on the global batch.

- The JAX refusal messages: no declared shapes, ``--compress``, too few
  devices without ``--backend gloo``; ``--profile`` with ``--devices`` is
  not yet ported.
- ``--devices 2 --backend gloo --device cpu`` on a CIFAR-format set, a
  BatchNorm + Dropout net: its snapshot at iteration 8 against the
  one-process ``--devices 1`` run on the scaled batch (the JAX test's
  tolerances: params rtol 2e-4, atol 2e-6); rank 0 alone writes (rank
  1's log says so); a run killed after iteration 4 (its snapshot alone
  on disk) and ``--resume``d ends on the uninterrupted run's bits.
- A SIGHUP sent to rank 1 alone: both ranks agree on the snapshot at the
  same window; a SIGINT to rank 1 then stops both, with a last snapshot,
  and neither hangs.
- The prototxt printer (``config.dumps``, which writes a zoo model's net
  into a solver file ``--devices`` reads): every zoo model round-trips.
"""

import glob
import os
import shutil
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu_torch import config, models
from sparknet_tpu_torch.data import CifarLoader
from sparknet_tpu_torch.io import checkpoint
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils import procs
from sparknet_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = """
name: "bnnet"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: @B@ dim: 3 dim: 32 dim: 32 }
                    shape { dim: @B@ } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 8 kernel_size: 5 stride: 3
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "bn" type: "BatchNorm" bottom: "conv" top: "conv" }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "drop" type: "Dropout" bottom: "conv" top: "conv"
  dropout_param { dropout_ratio: 0.3 } }
layer { name: "ip" type: "InnerProduct" bottom: "conv" top: "logits"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label"
  top: "loss" }
"""
B = 4  # a rank's batch


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cifar"))
    CifarLoader.write_synthetic(d, num_train=400, num_test=20)
    return d


def _solver_file(d, name, batch=B, data="HostData", snapshot=4):
    net = os.path.join(d, f"{name}.net.prototxt")
    text = NET.replace("@B@", str(batch))
    if data != "HostData":  # a source layer that declares no shapes
        text = text.replace(
            'type: "HostData" top: "data" top: "label"\n  java_data_param { '
            f'shape {{ dim: {batch} dim: 3 dim: 32 dim: 32 }}\n'
            f'                    shape {{ dim: {batch} }} }}',
            'type: "Data" top: "data" top: "label"\n  data_param { '
            'source: "x" batch_size: 4 }')
    with open(net, "w") as f:
        f.write(text)
    path = os.path.join(d, f"{name}.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{net}"\nbase_lr: 0.05\nlr_policy: "fixed"\n'
                f'momentum: 0.9\nsnapshot: {snapshot}\n'
                f'snapshot_prefix: "{d}/{name}/ck"\n')
    return path


def _devices(solver, cifar_dir, store, *extra, devices=2):
    return ["train", f"--solver={solver}", f"--data={cifar_dir}",
            "--device=cpu", "--tau=2", f"--devices={devices}",
            "--backend=gloo", f"--coordinator=file://{store}", *extra]


def _state_at(solver_file, it):
    """The snapshot a run of ``solver_file`` wrote at iteration ``it``."""
    sp = config.load_solver_prototxt(solver_file)
    return checkpoint.restore(Solver(sp, device="cpu"),
                              f"{sp.snapshot_prefix}_iter_{it}"
                              ".solverstate.npz")


def rank_main(argv):
    """Two ranks joined once run ``cli train --devices 2`` twice: A to
    iteration 8 (snapshots at 4 and 8), then B from what a kill after
    iteration 4 leaves on disk — A's snapshot at 4, copied under B's
    prefix by rank 0 — ``--resume``d to 8."""
    pid, address, a, b, data = (int(argv[0]), argv[1], argv[2], argv[3],
                                argv[4])
    from sparknet_tpu_torch.parallel import mesh

    mesh.initialize_distributed(address, 2, pid, device="cpu")
    common = [f"--data={data}", "--device=cpu", "--tau=2", "--devices=2",
              "--max_iter=8"]
    assert cli.main(["train", f"--solver={a}", *common]) == 0
    if pid == 0:
        dst = os.path.join(os.path.dirname(a), "b")
        os.makedirs(dst)
        for f in glob.glob(os.path.join(os.path.dirname(a), "a",
                                        "ck_iter_4.*")):
            shutil.copy(f, dst)
    assert cli.main(["train", f"--solver={b}", *common, "--resume"]) == 0
    mesh.shutdown()
    print(f"CLI_OK p{pid}", flush=True)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
    sys.exit(0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cifar_dir):
    """A and B over two joined ranks (``rank_main``); one process on the
    scaled batch to iteration 8."""
    d = str(tmp_path_factory.mktemp("devices"))
    logs = os.path.join(d, "logs")
    a, b = _solver_file(d, "a"), _solver_file(d, "b")
    with open(__file__) as f:
        src = f.read()
    procs.run_worker_processes(src, "CLI_OK", REPO, nprocs=2,
                               args=[a, b, cifar_dir], timeout=240,
                               workdir=d, env_extra={"SPARKNET_LOG_DIR": logs})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = os.environ.get("SPARKNET_LOG_DIR")
    os.environ["SPARKNET_LOG_DIR"] = logs
    try:
        one = {}
        rc = cli.main(["train", f"--solver={_solver_file(d, 'one', 2 * B)}",
                       f"--data={cifar_dir}", "--device=cpu", "--tau=2",
                       "--max_iter=8"], one)
    finally:
        torch.set_num_threads(threads)
        if saved is None:
            os.environ.pop("SPARKNET_LOG_DIR")
        else:
            os.environ["SPARKNET_LOG_DIR"] = saved
    return {"a": a, "b": b, "one": (rc, one),
            "logs": sorted(glob.glob(os.path.join(logs, "*.txt")))}


def test_devices_2_matches_one_process_on_the_scaled_batch(runs):
    got = _state_at(runs["a"], 8)
    rc1, one = runs["one"]
    assert rc1 == 0 and int(got.iter) == int(one["state"].iter) == 8
    for x, y in zip(tree_leaves(got.params), tree_leaves(one["state"].params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4, atol=2e-6)
    for x, y in zip(tree_leaves(got.stats), tree_leaves(one["state"].stats)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4, atol=2e-6)


def test_rank0_alone_writes_and_resume_is_bit_for_bit(runs):
    a, b = runs["a"], runs["b"]
    snaps = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(os.path.dirname(a), "a", "ck_iter_*.solverstate.npz")))
    assert snaps == ["ck_iter_4.solverstate.npz", "ck_iter_8.solverstate.npz"]
    rank1 = [p for p in runs["logs"] if p.endswith("_train_p1.txt")]
    assert len(rank1) == 2  # a, b
    text = "".join(open(p).read() for p in rank1)
    assert text.count("written by rank 0") == 3
    x, y = _state_at(a, 8), _state_at(b, 8)
    for u, v in zip(tree_leaves(x), tree_leaves(y)):
        assert np.array_equal(u.numpy(), v.numpy())


def test_devices_refusals(tmp_path, cifar_dir, capsys):
    s = _solver_file(str(tmp_path), "r")
    argv = ["train", f"--solver={s}", "--devices=2", "--tau=2"]
    assert cli.main(argv + ["--device=cuda"]) == 1
    assert "--devices=2 but torch sees" in capsys.readouterr().err
    assert cli.main(argv + ["--device=cpu", "--compress=int8"]) == 1
    assert "tau-round parameter averaging" in capsys.readouterr().err
    nodecl = _solver_file(str(tmp_path), "n", data="Data")
    assert cli.main(["train", f"--solver={nodecl}", "--devices=2",
                     "--device=cpu"]) == 1
    assert "needs data layers with declared shapes" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(argv + ["--device=cpu", "--profile"])


def _log_text(d, suffix):
    return "".join(open(p).read() for p in glob.glob(
        os.path.join(d, "logs", f"*_{suffix}.txt")))


def _wait_for(d, pattern, count, done, timeout=120.0):
    """Until rank 0's log holds ``pattern`` ``count`` times."""
    t0 = time.time()
    while time.time() - t0 < timeout and not done.is_set():
        if _log_text(d, "train").count(pattern) >= count:
            return
        time.sleep(0.02)
    raise AssertionError(f"no {pattern!r} in rank 0's log:\n"
                         + _log_text(d, "train")[-3000:])


def _rank_pid(store, process_id):
    """The pid of the spawned rank ``process_id`` joining through
    ``store`` (its command line names both)."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        args = [c.decode(errors="replace") for c in cmd]
        if f"--process_id={process_id}" in args and any(
                store in c for c in args):
            return int(entry)
    raise AssertionError(f"no rank {process_id} joining through {store}")


def test_sighup_to_one_rank_snapshots_on_both_and_stops_on_sigint(
        tmp_path, cifar_dir, monkeypatch):
    """``cli train --devices 2`` spawning its ranks (in a thread here); a
    SIGHUP to rank 1 alone snapshots at one window on both, a SIGINT to
    rank 1 stops both with a last snapshot; the spawner returns 0."""
    d = str(tmp_path)
    monkeypatch.setenv("SPARKNET_LOG_DIR", os.path.join(d, "logs"))
    store = f"{d}/store"
    s = _solver_file(d, "sig", snapshot=0)
    out, done = {}, threading.Event()

    def spawn():
        try:
            out["rc"] = cli.main(_devices(s, cifar_dir, store,
                                          "--max_iter=1000000"))
        finally:
            done.set()

    t = threading.Thread(target=spawn, daemon=True)
    t.start()
    try:
        _wait_for(d, "smoothed_loss", 1, done)
        os.kill(_rank_pid(store, 1), signal.SIGHUP)
        _wait_for(d, "snapshotted to", 1, done)
        os.kill(_rank_pid(store, 1), signal.SIGINT)
    finally:
        t.join(timeout=120)
    assert not t.is_alive() and out.get("rc") == 0, out
    rank0, rank1 = _log_text(d, "train"), _log_text(d, "train_p1")
    assert "snapshot agreed over 2 ranks" in rank0
    assert "stop agreed over 2 ranks" in rank0
    assert rank0.count("snapshotted to") == 2
    assert rank1.count("written by rank 0") == 2
    assert "stop agreed over 2 ranks" in rank1


@pytest.mark.parametrize("name", models.available_models())
def test_printed_zoo_nets_parse_back(name):
    netp = models.load_model(name)
    assert config.parse_net_prototxt(config.dumps(netp)) == netp
    if name in models.solver_models():
        sp = models.load_model_solver(name)
        assert config.parse_solver_prototxt(config.dumps(sp)) == sp
