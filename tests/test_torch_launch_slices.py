"""The launcher's slices of processes, their preemption and relaunch, and
what a fixed-size ``torch.distributed`` group does when a peer is hard
killed (``tools/launch.py``, ``utils/procs.Children``,
``parallel/mesh.PeerLost``).

- ``proc_slice_members`` against the JAX launcher's grouping.
- The lifecycle with a fake ``Popen``, as JAX ``tests/test_membership.py``
  drives it: every child's ``$SPARKNET_SLICE_ID``, the SIGTERM to the
  preempted slice alone, the escalation kill and reap of a victim that
  kept running, the relaunch with ``$SPARKNET_RELAUNCHED=1`` and the
  same ``--process_id``s, the relaunch skipped once the deadline has
  passed, and the rc rule (a preempted incarnation's kill code is not a
  failure; another child's is).
- The flags checked before any child spawns (a ``--preempt_slice`` out
  of range returns 2).
- A relaunched process refuses to re-enter the run, naming why; the
  survivors of a hard-killed peer stop in their next collective with
  ``PeerLost`` naming its rank, inside the group's timeout.
- ``cli train --devices 2 --profile --profile_out``: one summary, from
  rank 0, whose per-worker table has a row for each rank.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from sparknet_tpu.tools import launch as jlaunch
from sparknet_tpu_torch.tools import cli, launch
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,s", [(4, 2), (3, 2), (2, 1), (2, 5), (6, 3)])
def test_proc_slice_members_match_jax(n, s):
    assert launch.proc_slice_members(n, s) == jlaunch.proc_slice_members(n, s)


class FakeProc:
    """A child that runs ``life`` seconds and exits ``rc``; it takes a
    SIGTERM as a notice (an --elastic child keeps running)."""

    made: list = []

    def __init__(self, cmd, env, life=0.6, rc=0):
        self.cmd, self.env = cmd, env
        self.pid = 9000 + len(FakeProc.made)
        self.signals = []
        self.stdout = iter(())
        self._rc = None
        self._end = time.time() + life
        self._exit = rc

    def send_signal(self, sig):
        self.signals.append(sig)

    def poll(self):
        if self._rc is None and time.time() >= self._end:
            self._rc = self._exit
        return self._rc

    def wait(self, timeout=None):
        t_end = time.time() + (timeout if timeout else 60)
        while self.poll() is None:
            if time.time() >= t_end:
                raise subprocess.TimeoutExpired(self.cmd, timeout)
            time.sleep(0.01)
        return self._rc

    def kill(self):
        if self._rc is None:
            self._rc = -9

    @property
    def returncode(self):
        return self._rc


def _fake_popen(monkeypatch, life=0.6, rc_of=None):
    """Spawned children become FakeProcs (``rc_of(process_id)`` their
    exit code)."""
    FakeProc.made = []

    def popen(cmd, env=None, **kw):
        pid = int(next(a.split("=")[1] for a in cmd
                       if a.startswith("--process_id=")))
        p = FakeProc(cmd, env, life, rc_of(pid) if rc_of else 0)
        FakeProc.made.append(p)
        return p

    monkeypatch.setattr(procs.subprocess, "Popen", popen)
    return FakeProc.made


class _Args:
    app = "cifar"
    nprocs = 4
    devices_per_host = 1
    slices = 2
    preempt_slice = 1
    preempt_at = 0.05
    relaunch_after = 0.05
    timeout = 30
    coordinator = "file:///nonexistent/store"
    backend = None


def _ids(ps):
    return sorted(a.split("=")[1] for p in ps for a in p.cmd
                  if a.startswith("--process_id="))


def test_launcher_preempts_and_relaunches_a_slice(monkeypatch, capsys):
    spawned = _fake_popen(monkeypatch)
    assert launch.spawn_local(_Args(), ["--rounds=1"]) == 0
    out = capsys.readouterr().out
    assert len(spawned) == 6  # 4 originals and slice 1's 2, relaunched
    assert [p.env["SPARKNET_SLICE_ID"] for p in spawned[:4]] == [
        "0", "0", "1", "1"]
    # slice 1 got the notice, kept running, was killed and reaped
    assert all(signal.SIGTERM in p.signals for p in spawned[2:4])
    assert all(p.returncode == -9 for p in spawned[2:4])
    assert not any(p.signals for p in spawned[:2])
    relaunched = spawned[4:]
    assert [p.env["SPARKNET_SLICE_ID"] for p in relaunched] == ["1", "1"]
    assert all(p.env.get("SPARKNET_RELAUNCHED") == "1" for p in relaunched)
    assert not any("SPARKNET_RELAUNCHED" in p.env for p in spawned[:4])
    assert _ids(spawned[2:4]) == _ids(relaunched) == ["2", "3"]
    assert "launch: slice 1 preempted (SIGTERM to host(s) [2, 3])" in out
    assert "launch: slice 1 relaunched (host(s) [2, 3])" in out


def test_relaunch_skipped_after_the_deadline(monkeypatch, capsys):
    spawned = _fake_popen(monkeypatch, life=5.0)
    args = _Args()
    args.timeout, args.relaunch_after = 0.5, 1.0
    t0 = time.time()
    # the deadline kills every child: a killed run is a failure (rc 1)
    assert launch.spawn_local(args, []) == 1
    assert time.time() - t0 < 4
    time.sleep(1.0)  # the preemption thread wakes after the wait ended
    out = capsys.readouterr().out
    assert len(spawned) == 4
    assert "launch: slice 1 relaunch skipped" in out
    assert "after the 0.5 s timeout" in out


def test_rc_rule_forgives_only_the_preempted(monkeypatch):
    # the victims exit 143 on their SIGTERM-free run end: forgiven;
    # process 0 exits 3 on its own: the run's code
    _fake_popen(monkeypatch, life=0.3,
                rc_of=lambda pid: {0: 3, 2: 143, 3: 143}.get(pid, 0))
    args = _Args()
    args.relaunch_after = None  # a notice, no relaunch
    assert launch.spawn_local(args, []) == 3
    _fake_popen(monkeypatch, life=0.3,
                rc_of=lambda pid: {2: 143, 3: 143}.get(pid, 0))
    assert launch.spawn_local(args, []) == 0


@pytest.mark.parametrize("argv,expect", [
    (["--nprocs", "2", "--slices", "2", "--preempt_slice", "5", "cifar"],
     2),
    (["--preempt_slice", "0", "cifar"], "needs --nprocs"),
], ids=["preempt_slice_out_of_range", "preempt_without_nprocs"])
def test_launch_checks_slice_flags_before_any_spawn(monkeypatch, capsys, argv,
                                                   expect):
    def no_spawn(*a, **k):
        raise AssertionError("a child spawned")

    monkeypatch.setattr(procs.subprocess, "Popen", no_spawn)
    if isinstance(expect, int):
        assert launch.main(argv) == expect == launch.USAGE_RC
        assert "--preempt_slice=5 out of range (have 2 slice(s))" in \
            capsys.readouterr().err
    else:
        with pytest.raises(SystemExit, match=expect):
            launch.main(argv)


def test_a_relaunched_process_refuses_to_rejoin(monkeypatch):
    monkeypatch.setenv("SPARKNET_RELAUNCHED", "1")
    with pytest.raises(SystemExit, match="relaunched .*fixed world size 2 "
                       "takes no new member"):
        launch.run_app("cifar", ["--device", "cpu"], "file:///nonexistent",
                       2, 1)


# two ranks averaging; rank 1 is hard-killed before round 2
_KILLED_PEER = r"""
import os, signal, sys, time
import numpy as np
import torch
from sparknet_tpu_torch.parallel import mesh
from sparknet_tpu_torch.parallel.trainers import ParameterAveragingTrainer
from sparknet_tpu_torch.utils import procs

pid, address = int(sys.argv[1]), sys.argv[2]
dev = mesh.initialize_distributed(address, 2, pid, device="cpu")
m = mesh.make_mesh({"dp": 4}, workers_per_process=2)
spec = procs._spec({"workers": 4})
trainer = ParameterAveragingTrainer(procs.averaging_solver(spec, dev), 4,
                                    mesh=m)
state = trainer.init_state(seed=0)
for r in range(4):
    if pid == 1 and r == 2:
        os.kill(os.getpid(), signal.SIGKILL)
    batches = {k: torch.from_numpy(np.ascontiguousarray(v[trainer.rows]))
               for k, v in procs.averaging_batches(spec, r).items()}
    t0 = time.time()
    try:
        state, _ = trainer.round(state, batches)
    except mesh.PeerLost as e:
        print(f"PEER_LOST after {time.time() - t0:.3f} s: {e}", flush=True)
        sys.exit(7)
    print(f"round {r} done", flush=True)
print("FINISHED", flush=True)
"""


def test_survivors_of_a_hard_killed_peer_stop_naming_it(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_KILLED_PEER)
    store = "file://" + str(tmp_path / "store")
    env = procs.repo_env(REPO)
    t0 = time.time()
    # plain children: the harness's reaper would kill the survivor as
    # soon as its peer failed, and this test reads what the survivor does
    kids = [subprocess.Popen([sys.executable, str(script), str(p), store],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for p in range(2)]
    try:
        outs = [k.communicate(timeout=120)[0] for k in kids]
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
    assert time.time() - t0 < 60
    rc0, out0 = kids[0].returncode, outs[0]
    assert kids[1].returncode == -signal.SIGKILL
    assert rc0 == 7, out0
    assert "round 1 done" in out0 and "FINISHED" not in out0
    line = next(x for x in out0.splitlines() if x.startswith("PEER_LOST"))
    assert float(line.split()[2]) < 30  # inside the group's timeout
    assert "lost rank 1 (pid " in line and "of the 2-process group" in line


def test_cli_train_devices_profile_writes_one_summary(tmp_path, monkeypatch,
                                                      capfd):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    net = tmp_path / "toy.net.prototxt"
    net.write_text(procs.TOY_NET)
    solver = tmp_path / "toy.prototxt"
    solver.write_text(f'net: "{net}"\n{procs.TOY_SOLVER}\n'
                      f'snapshot_prefix: "{tmp_path}/ck"\n')
    out = tmp_path / "profile.json"
    assert cli.main(["train", f"--solver={solver}", "--device=cpu",
                     "--tau=2", "--max_iter=6", "--devices=2",
                     "--backend=gloo",
                     f"--coordinator=file://{tmp_path / 'store'}",
                     "--profile", f"--profile_out={out}"]) == 0
    text = capfd.readouterr().out
    assert text.count("profile: round anatomy over 3 round(s)") == 1
    assert "[host 0] profile: round anatomy" in text
    summary = json.loads(out.read_text())
    assert summary["rounds"] == 3
    assert len(summary["worker_execute_ms"]["p50"]) == 2  # one row a rank
