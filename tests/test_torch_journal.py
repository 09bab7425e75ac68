"""The port's run journal (``io/journal.py``) and journal-guided restore
(``io/checkpoint.restore_newest_valid_journaled``) against the JAX
package's.

- Frames: the same records (``time`` fixed) give the same bytes, and
  each package scans the other's ledger, torn tail included.
- Torn and garbage tails: truncated on open, the last whole record
  rules.
- ``reconcile``: clean, in flight, and a snapshot ref that walks past
  progress-only commits, equal to the JAX journal's on the same ledger.
- The three journaled-restore cases of the JAX tests
  (``tests/test_journal.py``): an uncommitted snapshot ignored, a
  corrupt committed ref quarantined with a fall-back, no commits.
- ``journal_from_args``' auto rule and the CLI surface, flag for flag.
"""

import argparse
import os
import time

import numpy as np
import pytest
import torch

from sparknet_tpu.io import journal as jjournal
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch.io import checkpoint
from sparknet_tpu_torch.io import journal as tjournal
from sparknet_tpu_torch.io.journal import RunJournal
from sparknet_tpu_torch.solver import Solver

from tests.test_parallel import NET


def _solver():
    sp = tconfig.parse_solver_prototxt(
        'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9')
    return Solver(sp, net_param=tconfig.parse_net_prototxt(NET), device="cpu")


def _batches(tau, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(tau, 8, 6).astype(np.float32),
            "label": rng.randint(0, 4, (tau, 8)).astype(np.float32)}


def _write(mod, path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    with mod.RunJournal(path, fsync="never") as j:
        j.begin_round(0, iter=0, cursor={"text_iter": 0}, view_epoch=0)
        j.commit_round(0, iter=4, snapshot="p_iter_4.solverstate.npz")
        j.begin_round(1, iter=4, rng="default_train_key(0)")
        j.commit_round(1, iter=8, durable=False)


def test_frames_are_the_jax_packages(tmp_path, monkeypatch):
    tp, jp = str(tmp_path / "t.journal"), str(tmp_path / "j.journal")
    _write(tjournal, tp, monkeypatch)
    _write(jjournal, jp, monkeypatch)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_scans_the_others_ledger(tmp_path, monkeypatch, writer):
    path = str(tmp_path / "r.journal")
    _write(tjournal if writer == "port" else jjournal, path, monkeypatch)
    with open(path, "ab") as f:  # a torn tail: half a frame
        frame = tjournal.encode_frame({"kind": "intent", "round": 2})
        f.write(frame[: len(frame) // 2])
    trecs, ttorn = tjournal.scan(path)
    jrecs, jtorn = jjournal.scan(path)
    assert trecs == jrecs and ttorn == jtorn > 0
    assert [(r["kind"], r["round"]) for r in trecs] == [
        ("intent", 0), ("commit", 0), ("intent", 1), ("commit", 1)]
    other = jjournal.RunJournal if writer == "port" else RunJournal
    j = other(path, fsync="never")
    assert j.truncated_bytes == ttorn and len(j.records) == 4
    j.close()


def test_torn_tail_truncated_on_open(tmp_path):
    path = str(tmp_path / "r.journal")
    j = RunJournal(path)
    j.begin_round(0, iter=0)
    j.commit_round(0, iter=2)

    class Boom(BaseException):
        pass

    def boom():
        raise Boom()

    j.crash_hook = boom
    with pytest.raises(Boom):
        j.begin_round(1, iter=2)
    j.close()
    whole = os.path.getsize(path)
    recs, torn = tjournal.scan(path)
    assert len(recs) == 2 and torn > 0
    j = RunJournal(path)
    assert j.truncated_bytes == torn
    assert os.path.getsize(path) == whole - torn
    assert j.last_committed_round == 0 and j.in_flight_round is None
    j.begin_round(1, iter=2)  # appends extend a valid frame sequence
    j.close()
    assert [r["round"] for r in tjournal.scan(path)[0]] == [0, 0, 1]


def test_garbage_tail_is_unreachable_not_fatal(tmp_path):
    path = str(tmp_path / "r.journal")
    with RunJournal(path) as j:
        j.commit_round(0, iter=2)
    with open(path, "ab") as f:
        f.write(b"\x00garbage" * 5)
    recs, torn = tjournal.scan(path)
    assert len(recs) == 1 and torn == 40
    assert tjournal.scan(str(tmp_path / "missing"))[0] == []
    with pytest.raises(ValueError):
        RunJournal(str(tmp_path / "x"), fsync="sometimes")


def test_reconcile_matches_jax(tmp_path):
    path = str(tmp_path / "r.journal")
    with RunJournal(path) as j:
        assert j.reconcile()["resume_round"] == 0
        j.begin_round(0, iter=0)
        j.commit_round(0, iter=2, snapshot="s_iter_2.solverstate.npz")
        j.begin_round(1, iter=2)
        j.commit_round(1, iter=4, durable=False)
        j.begin_round(2, iter=4)
        info = j.reconcile()
    assert info["last_committed_round"] == 1 and info["in_flight_round"] == 2
    assert info["resume_round"] == 2 and info["commit_iter"] == 4
    assert info["snapshot"] == "s_iter_2.solverstate.npz"
    jj = jjournal.RunJournal(path)
    assert jj.reconcile() == info
    jj.close()


# ----------------------------------------------------------------------
# journal-guided restore: the three JAX cases
# ----------------------------------------------------------------------
def test_journaled_restore_ignores_uncommitted_snapshot(tmp_path):
    solver = _solver()
    state = solver.init_state(seed=0)
    prefix = str(tmp_path / "ck")
    j = RunJournal(str(tmp_path / "r.journal"))
    state, _ = solver.step(state, _batches(2, seed=0))
    _, sp0 = checkpoint.snapshot(solver, state, prefix,
                                 extra_state={"cursor": {"round": 1}})
    j.commit_round(0, iter=2, snapshot=os.path.basename(sp0))
    # round 1: its snapshot publishes, its commit never lands
    j.begin_round(1, iter=2)
    state, _ = solver.step(state, _batches(2, seed=1))
    checkpoint.snapshot(solver, state, prefix)
    st, used, js, info = checkpoint.restore_newest_valid_journaled(
        solver, prefix, j)
    assert os.path.basename(used) == os.path.basename(sp0)
    assert int(st.iter) == 2 and js == {"cursor": {"round": 1}}
    assert info["resume_round"] == 1 == info["in_flight_round"]
    j.close()


def test_journaled_restore_quarantines_corrupt_ref_and_falls_back(tmp_path):
    solver = _solver()
    state = solver.init_state(seed=0)
    prefix = str(tmp_path / "ck")
    j = RunJournal(str(tmp_path / "r.journal"))
    state, _ = solver.step(state, _batches(2, seed=0))
    _, sp0 = checkpoint.snapshot(solver, state, prefix)
    j.commit_round(0, iter=2, snapshot=os.path.basename(sp0))
    state, _ = solver.step(state, _batches(2, seed=1))
    _, sp1 = checkpoint.snapshot(solver, state, prefix)
    j.commit_round(1, iter=4, snapshot=os.path.basename(sp1))
    with open(sp1, "r+b") as f:
        f.seek(10)
        f.write(b"\xa5\xa5\xa5\xa5")
    st, used, js, info = checkpoint.restore_newest_valid_journaled(
        solver, prefix, j)
    assert os.path.basename(used) == os.path.basename(sp0)
    assert os.path.exists(sp1 + ".corrupt") and int(st.iter) == 2
    j.close()


def test_journaled_restore_no_commits_raises_filenotfound(tmp_path):
    solver = _solver()
    j = RunJournal(str(tmp_path / "r.journal"))
    j.begin_round(0, iter=0)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_newest_valid_journaled(solver, str(tmp_path / "ck"),
                                                  j)
    # commits that vouch for vanished snapshots are corruption-class
    j.commit_round(0, iter=2, snapshot="ck_iter_2.solverstate.npz")
    with pytest.raises(checkpoint.SnapshotCorrupt):
        checkpoint.restore_newest_valid_journaled(solver, str(tmp_path / "ck"),
                                                  j)
    j.close()


def test_port_restores_through_a_jax_ledger(tmp_path):
    """A ledger the JAX package wrote guides the port's restore."""
    solver = _solver()
    state = solver.init_state(seed=0)
    prefix = str(tmp_path / "ck")
    state, _ = solver.step(state, _batches(2))
    _, sp0 = checkpoint.snapshot(solver, state, prefix)
    with jjournal.RunJournal(str(tmp_path / "r.journal")) as jj:
        jj.commit_round(0, iter=2, snapshot=os.path.basename(sp0))
        jj.begin_round(1, iter=2)
    j = RunJournal(str(tmp_path / "r.journal"))
    st, used, _, info = checkpoint.restore_newest_valid_journaled(solver,
                                                                  prefix, j)
    assert used == sp0 and info["in_flight_round"] == 1
    for a, b in zip(torch.utils._pytree.tree_leaves(st.params),
                    torch.utils._pytree.tree_leaves(state.params)):
        assert torch.equal(a, b)
    j.close()


# ----------------------------------------------------------------------
# the CLI surface
# ----------------------------------------------------------------------
class _Args:
    def __init__(self, journal=None, journal_path=None, journal_fsync="commit"):
        self.journal = journal
        self.journal_path = journal_path
        self.journal_fsync = journal_fsync


def test_journal_from_args_auto_rule(tmp_path):
    path = str(tmp_path / "p_run.journal")
    assert tjournal.journal_from_args(_Args(journal=None), path) is None
    RunJournal(path).close()
    assert tjournal.journal_from_args(_Args(journal=False), path,
                                      resuming=True) is None
    j = tjournal.journal_from_args(_Args(journal=None), path, resuming=True)
    assert j is not None and j.path == path
    j.close()
    other = str(tmp_path / "other.journal")
    j = tjournal.journal_from_args(
        _Args(journal=True, journal_path=other, journal_fsync="never"), path)
    assert j.path == other and j.fsync == "never"
    j.close()
    assert tjournal.default_journal_path("/a/b") == \
        jjournal.default_journal_path("/a/b")


@pytest.mark.parametrize("argv", [[], ["--journal"], ["--no_journal"],
                                  ["--journal_path", "x", "--journal_fsync",
                                   "always"]])
def test_cli_args_match_jax(argv):
    tp, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    tjournal.add_cli_args(tp)
    jjournal.add_cli_args(jp)
    assert vars(tp.parse_args(argv)) == vars(jp.parse_args(argv))
    with pytest.raises(SystemExit):
        tp.parse_args(["--journal", "--no_journal"])
