"""The port's journaled driver (``runtime/recover.py``): the kill-anywhere
sweep on the CPU.

One ``RecoverContext`` (cifar10_quick, W=2, tau=2, batch 8, int8, the
audit on) runs an uninterrupted 4-round control, then for each kill
point a run killed at round 2 (a raising kill) and its resume: the
resumed ``state_digest`` (params, stats, history, iter, EF residuals,
sentry EMA) equals the control's with at most one replayed round.  The
``--no_journal`` resume differs.  The jobstate carries the comm
residuals, the sentry and the membership view.  One subprocess is
SIGKILLed at ``execute:2`` and resumed.
"""

import json
import os
import subprocess
import sys

import pytest

from sparknet_tpu_torch.io import checkpoint
from sparknet_tpu_torch.io.journal import scan
from sparknet_tpu_torch.runtime import recover

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = [p for p in recover.KILL_POINTS if p != "stale_boundary"]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    return recover.RecoverContext(str(tmp_path_factory.mktemp("rc")),
                                  device="cpu")


@pytest.fixture(scope="module")
def control(ctx, tmp_path_factory):
    return recover.run_driver(ctx, 4,
                              run_dir=str(tmp_path_factory.mktemp("control")))


def _kill():
    raise recover.SimulatedKill()


@pytest.mark.parametrize("point", POINTS)
def test_each_kill_point_resumes_to_the_control(ctx, control, tmp_path, point):
    d = str(tmp_path / point)
    with pytest.raises(recover.SimulatedKill):
        recover.run_driver(ctx, 4, run_dir=d, kill_at=(point, 2), kill=_kill)
    res = recover.run_driver(ctx, 4, run_dir=d, resume=True)
    assert res["final_digest"] == control["final_digest"]
    assert res["start_round"] == 2 and res["rounds_executed"] == [2, 3]
    assert res["resume_info"]["in_flight_round"] == 2
    if point == "journal_mid_append":
        assert res["journal_truncated_bytes"] > 0
    if point == "snapshot_mid_write":
        assert not any(".tmp-" in f for f in os.listdir(d))
    assert res["sentry_ema"] == control["sentry_ema"]


def test_no_journal_resume_diverges(ctx, control, tmp_path):
    d = str(tmp_path / "nojr")
    with pytest.raises(recover.SimulatedKill):
        recover.run_driver(ctx, 4, run_dir=d, journal=False,
                           kill_at=("execute", 2), kill=_kill)
    res = recover.run_driver(ctx, 4, run_dir=d, journal=False, resume=True)
    assert res["rounds_executed"] == [2, 3]
    assert res["final_digest"] != control["final_digest"]


def test_jobstate_carries_comm_sentry_and_membership(ctx, tmp_path):
    d = str(tmp_path / "js")
    rec = recover.run_driver(ctx, 2, run_dir=d)
    used = checkpoint.find_snapshots(os.path.join(d, "recover_ckpt"))[-1]
    js = checkpoint.load_job_state(used)
    assert set(js) >= {"comm", "sentry", "membership", "workers", "cursor"}
    assert js["comm"]["compress"] == "int8"
    assert js["sentry"]["seen"] == 2 and js["membership"]["epoch"] == 0
    assert js["cursor"] == {"next_round": 2}
    recs, torn = scan(os.path.join(d, "recover_ckpt_run.journal"))
    assert torn == 0 and [r["kind"] for r in recs] == ["intent", "commit"] * 2
    assert rec["final_iter"] == 4


def test_stale_bound_is_not_yet_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        recover.RecoverContext(str(tmp_path), stale_bound=1, device="cpu")
    with pytest.raises(SystemExit, match="not yet ported"):
        recover.main(["--workdir", str(tmp_path), "--device", "cpu",
                      "--kill_at", "stale_boundary:1"])
    with pytest.raises(ValueError):
        recover.parse_kill_at("nowhere:1")


def test_subprocess_sigkill_and_resume(tmp_path, control):
    """A real SIGKILL at ``execute:2``, then ``--resume``: the resumed
    process's digest equals the in-process control's (same seeds)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "sparknet_tpu_torch.runtime.recover",
            "--workdir", str(tmp_path), "--rounds", "4", "--device", "cpu"]
    killed = subprocess.run(base + ["--kill_at", "execute:2"], env=env,
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    done = subprocess.run(base + ["--resume"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    rec = json.loads(done.stdout.strip().splitlines()[-1])
    assert rec["rounds_executed"] == [2, 3]
    assert rec["final_digest"] == control["final_digest"]
