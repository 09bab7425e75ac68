"""``cli train --solver`` of the port against the JAX package's, on the CPU.

- cifar10_full (batch 100) on synthesized CIFAR binaries: the port's
  ``cli train`` and the JAX ``cli train`` write snapshots at the same
  iteration whose params and momentum agree within a stated tolerance.
- Resume: a run stopped at a snapshot and resumed with ``--resume`` (or
  ``--snapshot F``) ends bit-identical to an uninterrupted run, in
  BINARYPROTO and HDF5, sync and ``--async_snapshot``; ``--resume``
  conflicts with ``--snapshot``/``--weights``, falls back past a corrupt
  snapshot, and fails cleanly with none.
- SIGHUP snapshots, SIGINT snapshots and stops; ``--weights`` warm-starts.
- The flags of later slices refuse, saying "not yet ported" (the chunk
  cache, ``--shuffle_epochs`` and object-store ``--data`` run now:
  ``tests/test_torch_data_plane.py``; ``--devices`` runs now, with
  ``--profile`` too: ``tests/test_torch_cli_devices.py`` and
  ``tests/test_torch_launch_slices.py``; ``HDF5Output`` with
  ``--devices`` refuses); the telemetry flags ``--trace_out``, ``--slo``
  and ``--obs`` run.
"""

import os
import signal

import numpy as np
import pytest
import torch

from sparknet_tpu.tools import cli as jcli
from sparknet_tpu_torch.data import CifarLoader
from sparknet_tpu_torch import solver as tsolver
from sparknet_tpu_torch.io import caffemodel, checkpoint
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils.tree import tree_leaves

TOY_NET = """
name: "toy"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 10 dim: 3 dim: 32 dim: 32 } shape { dim: 10 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# two windows of cifar10_full at batch 100 from its init (loss ~ ln 10,
# conv1 drawn at std 1e-4), float32 on the CPU on both sides: the
# first layers' gradients are sums of many large terms that cancel, so
# another summation order moves them ~1e-4-1e-3 of the blob's largest
# magnitude (measured: at most 1.05e-3, in conv2's weight momentum)
CIFAR_TOL = 2e-3


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cifar"))
    CifarLoader.write_synthetic(d, num_train=1000, num_test=100)
    return d


def _solver_file(tmp_path, name="solver", snapshot=2, extra="", net=None,
                 lr=1e-5):
    if net is None:
        net = tmp_path / "toy.prototxt"
        net.write_text(TOY_NET)
    p = tmp_path / f"{name}.prototxt"
    p.write_text(
        f'net: "{net}"\nbase_lr: {lr}\nlr_policy: "fixed"\nmomentum: 0.9\n'
        f'snapshot: {snapshot}\nsnapshot_prefix: "{tmp_path}/{name}/ck"\n'
        + extra
    )
    return str(p)


def _train(solver, *flags, result=None):
    return cli.main(["train", f"--solver={solver}", "--device=cpu", "--tau=2"]
                    + list(flags), result)


def _assert_same_state(a, b):
    assert np.array_equal(np.asarray(a.iter), np.asarray(b.iter))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# against the JAX cli train


def test_cifar10_full_cli_train_matches_jax(tmp_path, cifar_dir):
    """Two windows (tau 2) of cifar10_full on the same CIFAR binaries:
    the iteration-4 snapshots agree within CIFAR_TOL of each blob's
    largest magnitude."""
    out = {}
    for who, main, zoo in (
        ("port", cli.main, os.path.join(REPO, "sparknet_tpu_torch/models/zoo")),
        ("jax", jcli.main, os.path.join(REPO, "sparknet_tpu/models/zoo")),
    ):
        solver = _solver_file(tmp_path, who, snapshot=4, lr=0.001,
                              net=os.path.join(zoo, "cifar10_full_train_test.prototxt"))
        argv = ["train", f"--solver={solver}", f"--data={cifar_dir}", "--tau=2",
                "--max_iter=4"]
        assert main(argv + (["--device=cpu"] if who == "port" else [])) == 0
        snaps = checkpoint.find_snapshots(str(tmp_path / who / "ck"))
        assert [os.path.basename(s) for s in snaps] == ["ck_iter_4.solverstate.npz"]
        out[who] = snaps[0]
    port = caffemodel.load_weights(out["port"].replace(".solverstate.npz", ".caffemodel"))
    jax_ = caffemodel.load_weights(out["jax"].replace(".solverstate.npz", ".caffemodel"))
    assert list(port) == list(jax_) == ["conv1", "conv2", "conv3", "ip1"]
    for k in port:
        for x, y in zip(port[k], jax_[k]):
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=CIFAR_TOL * float(np.abs(y).max()))
    with np.load(out["port"]) as zp, np.load(out["jax"]) as zj:
        assert int(zp["iter"]) == int(zj["iter"]) == 4
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            y = zj[k]
            np.testing.assert_allclose(zp[k], y, rtol=0,
                                       atol=CIFAR_TOL * float(np.abs(y).max()))


def test_synthetic_batches_match_jax():
    from sparknet_tpu import config as jconfig
    from sparknet_tpu.data.source import synthetic_batches
    from sparknet_tpu.net import JaxNet
    from sparknet_tpu_torch import config as tconfig
    from sparknet_tpu_torch.data.source import synthetic_batches as tsynthetic
    from sparknet_tpu_torch.net import TorchNet

    # cli train's generator, shared with cli test (data/source.py)
    got = tsynthetic(TorchNet(tconfig.parse_net_prototxt(TOY_NET)), 3)
    want = synthetic_batches(JaxNet(jconfig.parse_net_prototxt(TOY_NET)), 3)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# resume, bit for bit


@pytest.mark.parametrize("mode", ["resume", "snapshot", "async", "hdf5",
                                  "no_data"])
def test_resume_ends_bit_identical(tmp_path, cifar_dir, mode):
    extra = 'snapshot_format: "HDF5"\n' if mode == "hdf5" else ""
    if mode == "hdf5":
        pytest.importorskip("h5py")
    flags = [] if mode == "no_data" else [f"--data={cifar_dir}"]
    if mode == "async":
        flags.append("--async_snapshot")
    a = _solver_file(tmp_path, "a", extra=extra)
    b = _solver_file(tmp_path, "b", extra=extra)
    ra, rb = {}, {}
    assert _train(a, "--max_iter=6", *flags, result=ra) == 0
    assert _train(b, "--max_iter=2", *flags) == 0
    ext = ".solverstate.h5" if mode == "hdf5" else ".solverstate.npz"
    how = (["--resume"] if mode != "snapshot"
           else [f"--snapshot={tmp_path}/b/ck_iter_2{ext}"])
    assert _train(b, "--max_iter=6", *how, *flags, result=rb) == 0
    _assert_same_state(ra["state"], rb["state"])
    assert ra["smoothed_loss"] == rb["smoothed_loss"]
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert f"ck_iter_6{ext}" in names and not [n for n in names if ".tmp-" in n]
    if mode != "hdf5":
        for n in names:
            if n.endswith(".caffemodel"):
                with open(tmp_path / "a" / n, "rb") as f, \
                        open(tmp_path / "b" / n, "rb") as g:
                    assert f.read() == g.read()


def test_resume_conflicts_with_snapshot_and_weights(tmp_path, capsys):
    s = _solver_file(tmp_path, "c")
    for flag in (f"--snapshot={tmp_path}/c/ck_iter_2.solverstate.npz",
                 f"--weights={tmp_path}/w.caffemodel"):
        assert _train(s, "--resume", flag) == 1
        assert "conflicts with --snapshot/--weights" in capsys.readouterr().err


def test_resume_falls_back_past_a_corrupt_snapshot(tmp_path, capsys):
    s = _solver_file(tmp_path, "d")
    assert _train(s, "--max_iter=4") == 0
    snaps = checkpoint.find_snapshots(str(tmp_path / "d" / "ck"))
    assert [os.path.basename(p) for p in snaps] == [
        "ck_iter_2.solverstate.npz", "ck_iter_4.solverstate.npz"]
    with open(snaps[-1], "r+b") as f:
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0x5A]))
    capsys.readouterr()
    r = {}
    assert _train(s, "--max_iter=6", "--resume", result=r) == 0
    assert "resumed from" in capsys.readouterr().out
    assert os.path.exists(snaps[-1] + ".corrupt")
    assert int(r["state"].iter) == 6 and r["metrics"].quarantined.value == 1


def test_resume_refuses_another_tau(tmp_path, capsys):
    """The snapshot's cursor ends window 1 at iter 2 (tau 2): another
    --tau would draw windows the uninterrupted run never drew."""
    s = _solver_file(tmp_path, "t")
    assert _train(s, "--max_iter=2") == 0
    capsys.readouterr()
    for tau in ("--tau=1", "--tau=4"):
        assert _train(s, "--max_iter=8", "--resume", tau) == 1
        assert "resume with its --tau" in capsys.readouterr().err
    assert _train(s, "--max_iter=4", "--resume") == 0


def test_train_runs_deterministic_and_restores_the_flags(tmp_path, monkeypatch):
    """cli train trains inside deterministic_algorithms() and leaves
    torch's flags as it found them."""
    seen = []
    real_step = tsolver.Solver.step

    def step(self, *a, **k):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return real_step(self, *a, **k)

    monkeypatch.setattr(tsolver.Solver, "step", step)
    assert not torch.are_deterministic_algorithms_enabled()
    assert _train(_solver_file(tmp_path, "f"), "--max_iter=4") == 0
    assert seen == [True, True]
    assert not torch.are_deterministic_algorithms_enabled()


def test_resume_without_snapshots_fails_cleanly(tmp_path, capsys):
    assert _train(_solver_file(tmp_path, "e"), "--resume") == 1
    assert "--resume" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# signals and warm start


@pytest.mark.parametrize("sig,stops", [(signal.SIGHUP, False),
                                       (signal.SIGINT, True)])
def test_signals_snapshot_and_stop(tmp_path, monkeypatch, sig, stops):
    from sparknet_tpu_torch.solver import Solver

    real_step, calls = Solver.step, []

    def step(self, state, batches, rng=None):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), sig)
        return real_step(self, state, batches, rng)

    monkeypatch.setattr(Solver, "step", step)
    s = _solver_file(tmp_path, "f", snapshot=0)
    r = {}
    assert _train(s, "--max_iter=8", result=r) == 0
    snaps = [os.path.basename(p)
             for p in checkpoint.find_snapshots(str(tmp_path / "f" / "ck"))]
    assert snaps == ["ck_iter_4.solverstate.npz"]
    assert int(r["state"].iter) == (4 if stops else 8)
    assert signal.getsignal(sig) is not None  # handlers put back


def test_weights_warm_start(tmp_path):
    s = _solver_file(tmp_path, "g")
    assert _train(s, "--max_iter=2") == 0
    w = str(tmp_path / "g" / "ck_iter_2.caffemodel")
    # at base_lr 0 the run keeps the weights it starts from
    s0 = _solver_file(tmp_path, "h", snapshot=0, lr=0.0)
    r = {}
    assert _train(s0, "--max_iter=2", f"--weights={w}", result=r) == 0
    assert int(r["state"].iter) == 2
    loaded = caffemodel.load_weights(w)["ip"]
    for got, want in zip(r["state"].params["ip"], loaded):
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# later slices


@pytest.mark.parametrize("flags,what", [
    # --profile with --devices runs now; HDF5Output with --devices stays
    (["--devices=2"], "--devices"),
    (["--trace_out=/tmp/t.json"], "--trace_out"),
    (["--slo"], "--slo"),
    (["--obs"], "--obs"),
])
def test_train_refuses_what_is_not_yet_ported(tmp_path, monkeypatch, flags,
                                              what):
    """``HDF5Output`` with ``--devices`` still refuses; the telemetry
    flags run now (``tests/test_torch_obs_apps.py`` ``flag_runs``)."""
    if "--devices=2" not in flags:
        from tests.test_torch_obs_apps import flag_runs

        argv = [a for f in flags for a in f.split("=", 1)]
        flag_runs(monkeypatch, tmp_path, cli.main,
                  ["train", f"--solver={_solver_file(tmp_path, 'n')}",
                   "--device=cpu", "--tau=2"] + argv)
        return
    net = tmp_path / "h5.prototxt"
    net.write_text(TOY_NET + 'layer { name: "out" type: "HDF5Output" '
                   'bottom: "logits" bottom: "label" '
                   'hdf5_output_param { file_name: "o.h5" } }\n')
    with pytest.raises(SystemExit, match="not yet ported") as e:
        _train(_solver_file(tmp_path, "n", net=net), *flags)
    assert what in str(e.value)


@pytest.mark.parametrize("flag", ["--profile", "--profile_out"])
def test_train_profile_profiles_each_window(tmp_path, capsys, flag):
    """``--profile`` / ``--profile_out``: each tau-window of the solver
    is a profiled round (``Solver.step`` marks it), the summary table
    prints at the end, and ``--profile_out`` writes it as JSON."""
    import json

    from sparknet_tpu_torch.obs import profile

    out = tmp_path / "p.json"
    flags = [flag] if flag == "--profile" else [flag, str(out)]
    r = {}
    assert _train(_solver_file(tmp_path, "p"), "--max_iter=6", *flags,
                  result=r) == 0
    assert profile.active() is None
    s = r["profile"]
    assert s["rounds"] == 3 and "execute" in s["phases"]
    assert s["phases"]["execute"]["count"] == 3
    assert "profile: round anatomy over 3 round(s)" in capsys.readouterr().out
    if flag == "--profile_out":
        assert json.loads(out.read_text())["rounds"] == 3


def test_train_refuses_the_comm_plane(tmp_path, capsys):
    assert _train(_solver_file(tmp_path, "m"), "--compress=int8") == 1
    assert "averaging apps" in capsys.readouterr().err
