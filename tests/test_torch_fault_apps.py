"""The fault-tolerance surface of the port's entry points.

- Every training entry point (``lm_app``, ``cifar_app``,
  ``cifar_db_app``, ``imagenet_app``, ``imagenet_run_db_app``, ``cli
  train``) takes every option string of the JAX package's parser for
  the same entry point and runs it (the telemetry flags too).
- ``lm_app`` and ``cli train`` resume through the run journal after a
  kill inside round 2, bit for bit against their own uninterrupted
  runs (the JAX package's app tests of this are red on jax 0.9).
- ``cifar_app --elastic --slices 2 --cross_slice_every 2`` walks
  leave, dead and rejoin on a SIGTERM, and ``--health`` runs the
  sentry; ``imagenet_run_db_app --elastic`` only logs.
"""

import argparse
import os
import signal

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.apps import (
    cifar_app,
    cifar_db_app,
    imagenet_app,
    imagenet_run_db_app,
    lm_app,
)
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils.tree import tree_leaves


class _Parsed(BaseException):
    pass


def _capture_parser(monkeypatch, main, argv):
    """The parser ``main(argv)`` builds, caught at its parse."""
    seen = {}

    def parse(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed()

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.undo()
    return seen["parser"]


def _options(parser, sub=None):
    if sub is not None:
        for a in parser._actions:
            if isinstance(a, argparse._SubParsersAction):
                parser = a.choices[sub]
    return {s for a in parser._actions for s in a.option_strings}


_APPS = {
    "lm_app": ("sparknet_tpu.apps.lm_app", lm_app._parser),
    "cifar_app": ("sparknet_tpu.apps.cifar_app", cifar_app._parser),
    "cifar_db_app": ("sparknet_tpu.apps.cifar_db_app", cifar_db_app._parser),
    "imagenet_app": ("sparknet_tpu.apps.imagenet_app", imagenet_app._parser),
    "imagenet_run_db_app": ("sparknet_tpu.apps.imagenet_run_db_app",
                            imagenet_run_db_app._parser),
}


@pytest.mark.parametrize("app", sorted(_APPS) + ["cli_train"])
def test_entry_point_takes_the_jax_flag_surface(monkeypatch, app):
    import importlib

    if app == "cli_train":
        from sparknet_tpu.tools import cli as jcli

        jax_opts = _options(_capture_parser(monkeypatch, jcli.main, ["train"]),
                            "train")
        port_opts = _options(_capture_parser(monkeypatch, cli.main, ["train"]),
                             "train")
    else:
        mod, port_parser = _APPS[app]
        jax_opts = _options(_capture_parser(
            monkeypatch, importlib.import_module(mod).main, []))
        port_opts = _options(port_parser())
    assert jax_opts - port_opts == set()
    for flag in ("--health", "--health_policy", "--flight_recorder",
                 "--journal", "--no_journal", "--journal_path",
                 "--journal_fsync"):
        assert flag in port_opts


def test_refusals_name_the_flag(tmp_path, monkeypatch):
    """The flags this test once saw refused (``--trace_out``, ``--obs``)
    run now: each entry point starts what they ask for (``tests/
    test_torch_obs_apps.py`` ``flag_runs``).  (``--stale_bound`` and
    ``--profile`` run too: ``test_stale_and_profile_flags_run``.)"""
    from tests.test_torch_obs_apps import flag_runs

    for main, argv in ((cifar_app.main, ["--device", "cpu", "--workers", "2",
                                         "--tau", "1", "--rounds", "1"]),
                       (lm_app.main, LM + ["--rounds", "1"])):
        for flag in (["--trace_out", "t.json"], ["--obs"]):
            flag_runs(monkeypatch, tmp_path, main, argv + flag)


def test_stale_and_profile_flags_run(tmp_path):
    """``lm_app --stale_bound 2 --stale_discount 0.25 --profile``: the
    bounded-staleness trainer with the JAX flags' values (every worker
    arrives, so the run stays within 1e-5 of the synchronous one), and
    the profiler's summary at the end."""
    from sparknet_tpu_torch.parallel.stale import BoundedStalenessTrainer

    # the comm plane assumes synchronous boundaries: uncompressed
    argv = [a if a != "int8" else "none" for a in LM] + ["--rounds", "2"]
    sync, stale = {}, {}
    assert lm_app.main(argv, result=sync) == 0
    assert lm_app.main(argv + ["--stale_bound", "2", "--stale_discount",
                               "0.25", "--profile"], result=stale) == 0
    tr = stale["trainer"]
    assert isinstance(tr, BoundedStalenessTrainer)
    assert (tr.stale_bound, tr.discount) == (2, 0.25)
    assert list(tr.worker_rounds) == [2] * tr.num_workers
    for a, b in zip(tree_leaves(sync["state"].params),
                    tree_leaves(stale["state"].params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
    assert stale["profile"]["rounds"] == 2


# ----------------------------------------------------------------------
# journal-guided resume after a kill, bit for bit
# ----------------------------------------------------------------------
class _Kill(BaseException):
    pass


def _kill_in_round(monkeypatch, target, method, at):
    """Make ``target.method``'s call number ``at`` (from 0) raise."""
    orig = getattr(target, method)
    calls = {"n": 0}

    def wrapped(self, *a, **k):
        n = calls["n"]
        calls["n"] += 1
        if n == at:
            raise _Kill()
        return orig(self, *a, **k)

    monkeypatch.setattr(target, method, wrapped)


LM = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2",
      "--seq_len", "32", "--batch", "2", "--tau", "2", "--workers", "2",
      "--compress", "int8", "--log_every", "100"]


@pytest.mark.parametrize("health", [False, True], ids=["", "health"])
def test_lm_app_journaled_resume_is_bit_identical(tmp_path, monkeypatch, health):
    extra = ["--health", "warn"] if health else []
    ctl, res = {}, {}
    assert lm_app.main(LM + extra + [
        "--rounds", "4", "--snapshot_prefix", str(tmp_path / "a" / "lm"),
        "--snapshot_every", "1", "--journal"], result=ctl) == 0
    prefix = str(tmp_path / "b" / "lm")
    argv = LM + extra + ["--snapshot_prefix", prefix, "--snapshot_every", "1",
                         "--journal"]
    _kill_in_round(monkeypatch, ParameterAveragingTrainer, "round", 2)
    with pytest.raises(_Kill):
        lm_app.main(argv + ["--rounds", "4"])
    monkeypatch.undo()
    assert lm_app.main(argv + ["--rounds", "4", "--resume"], result=res) == 0
    assert res["start_round"] == 2
    assert res["resume_info"]["in_flight_round"] == 2
    assert res["metrics"].recover_replayed.value == 1
    for a, b in zip(tree_leaves(tuple(ctl["state"])),
                    tree_leaves(tuple(res["state"]))):
        assert torch.equal(a, b)
    assert res["smoothed"][-1] == ctl["smoothed"][-1]
    if health:
        assert res["sentry"].export_state() == ctl["sentry"].export_state()


def _solver_file(tmp_path):
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.models import ZOO_DIR

    cifar = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(cifar, num_train=600, num_test=100)
    net = os.path.join(ZOO_DIR, "cifar10_quick_train_test.prototxt")
    path = str(tmp_path / "solver.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{net}"\nbase_lr: 0.001\nmomentum: 0.9\n'
                'lr_policy: "fixed"\ndisplay: 2\nsnapshot: 2\n'
                f'snapshot_prefix: "{tmp_path}/snap/q"\n')
    return path, cifar


def test_cli_train_journaled_resume_is_bit_identical(tmp_path, monkeypatch):
    solver, cifar = _solver_file(tmp_path)
    base = ["train", f"--solver={solver}", f"--data={cifar}", "--tau=2",
            "--max_iter=8", "--device=cpu", "--journal", "--health"]
    ctl = {}
    assert cli.main(base, result=ctl) == 0
    for f in os.listdir(tmp_path / "snap"):
        os.unlink(tmp_path / "snap" / f)
    _kill_in_round(monkeypatch, Solver, "step", 2)
    with pytest.raises(_Kill):
        cli.main(base)
    monkeypatch.undo()
    res = {}
    assert cli.main(base[:-2] + ["--resume", "--health"], result=res) == 0
    for a, b in zip(tree_leaves(tuple(ctl["state"])),
                    tree_leaves(tuple(res["state"]))):
        assert torch.equal(a, b)
    assert res["sentry"].export_state()["seen"] == 4
    assert res["metrics"].recover_replayed.value == 1


def test_cli_train_publish_to_carries_the_verdict(tmp_path):
    from sparknet_tpu_torch.io import checkpoint

    solver, cifar = _solver_file(tmp_path)
    res = {}
    assert cli.main(["train", f"--solver={solver}", f"--data={cifar}",
                     "--tau=2", "--max_iter=4", "--device=cpu",
                     f"--publish_to={tmp_path}/pub"], result=res) == 0
    model, state = res["published"]
    manifest = checkpoint.read_manifest(checkpoint.manifest_path_for(state))
    assert manifest["verdict"]["passing"] is True
    checkpoint.verify_snapshot(state)
    assert res["sentry"].rounds_observed == 2


# ----------------------------------------------------------------------
# cifar_app: elastic membership over slices, and the sentry
# ----------------------------------------------------------------------
def test_cifar_app_elastic_slices_walk_leave_dead_rejoin(monkeypatch):
    """A SIGTERM at round 1 marks slice 1 (the last) leaving; it dies,
    rejoins after 2 boundaries, and the masks follow the views."""
    orig = ParameterAveragingTrainer.round
    sent = {"done": False}

    def round_(self, state, batches, live_mask=None, round_index=None):
        if round_index == 1 and not sent["done"]:
            sent["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, state, batches, live_mask=live_mask,
                    round_index=round_index)

    monkeypatch.setattr(ParameterAveragingTrainer, "round", round_)
    prev = signal.getsignal(signal.SIGTERM)
    r = {}
    assert cifar_app.main(["--device", "cpu", "--workers", "4", "--tau", "1",
                           "--rounds", "7", "--batch", "20", "--test_every",
                           "100", "--slices", "2", "--cross_slice_every", "2",
                           "--elastic", "--rejoin_after", "2", "--compress",
                           "int8", "--health"], result=r) == 0
    assert signal.getsignal(signal.SIGTERM) == prev
    masks = [m.tolist() for m in r["masks"]]
    assert masks[:2] == [[1, 1, 1, 1]] * 2
    assert masks[2] == [1, 1, 0, 0] and masks[3] == [1, 1, 0, 0]
    assert masks[-1] == [1, 1, 1, 1]
    kinds = [k for _, _, k, _ in r["membership"].transitions]
    assert kinds == ["leave", "death", "join_request", "rejoin"]
    assert r["sentry"].rounds_observed == 7
    assert np.isfinite(r["smoothed_loss"])
    m = r["metrics"]
    assert m.hierarchy_rounds.labels("intra").value == 4
    assert m.hierarchy_rounds.labels("cross").value == 3


def test_run_db_app_elastic_only_logs(tmp_path):
    """``--elastic`` in the DB app logs that membership is wired in
    cifar_app and lm_app; the refusal checks run before the DB opens."""
    with pytest.raises(FileNotFoundError):
        imagenet_run_db_app.main(["--db_dir", str(tmp_path), "--device",
                                  "cpu", "--elastic", "--slices", "2"])
