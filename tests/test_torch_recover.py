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

The bounded-staleness leg (``--stale_bound 2``: the last worker never
arrives by itself) is killed at ``stale_boundary:2`` in process and at
``stale_boundary:1`` by a real SIGKILL; both resume to the stale
control's digest, and the journal carries ``worker_rounds`` on every
record.  The stale driver's ledger equals the JAX driver's rules for the
same schedule.
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
POINTS = list(recover.KILL_POINTS)


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    return recover.RecoverContext(str(tmp_path_factory.mktemp("rc")),
                                  device="cpu")


@pytest.fixture(scope="module")
def control(ctx, tmp_path_factory):
    return recover.run_driver(ctx, 4,
                              run_dir=str(tmp_path_factory.mktemp("control")))


@pytest.fixture(scope="module")
def stale_ctx(tmp_path_factory):
    return recover.RecoverContext(str(tmp_path_factory.mktemp("rcs")),
                                  stale_bound=2, device="cpu")


@pytest.fixture(scope="module")
def stale_control(stale_ctx, tmp_path_factory):
    return recover.run_driver(stale_ctx, 4,
                              run_dir=str(tmp_path_factory.mktemp("scontrol")))


def _kill():
    raise recover.SimulatedKill()


@pytest.mark.parametrize("point", POINTS)
def test_each_kill_point_resumes_to_the_control(ctx, control, stale_ctx,
                                                request, tmp_path, point):
    if point == "stale_boundary":  # the stale driver's own point
        ctx, control = stale_ctx, request.getfixturevalue("stale_control")
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


def test_stale_driver_ledger_and_journal(stale_ctx, stale_control, ctx,
                                         tmp_path):
    """The stale leg: the straggler (worker 1 of 2) folds in only when
    the bound forces it (every 2nd boundary), as the JAX driver's rules
    give; every record of the journal carries the worker-round vector
    (the intent the pre-fold one, the commit the post-fold one); the
    synchronous context refuses the stale point."""
    assert stale_ctx.trainer.stale_bound == 2 and stale_ctx.compress == "none"
    assert stale_control["worker_rounds"] == [4, 2]
    d = str(tmp_path / "sj")
    recover.run_driver(stale_ctx, 4, run_dir=d)
    recs, torn = scan(os.path.join(d, "recover_ckpt_run.journal"))
    assert torn == 0 and all("worker_rounds" in r for r in recs)
    commits = [r["worker_rounds"] for r in recs if r["kind"] == "commit"]
    intents = [r["worker_rounds"] for r in recs if r["kind"] == "intent"]
    assert commits == [[1, 0], [2, 0], [3, 1], [4, 2]]
    assert intents == [[0, 0]] + commits[:-1]
    # the JAX driver journals the same vectors for the same schedule
    from sparknet_tpu.io.journal import scan as jscan
    from sparknet_tpu.runtime import recover as jrecover

    jctx = jrecover.RecoverContext(str(tmp_path / "jrc"), stale_bound=2)
    jrec = jrecover.run_driver(jctx, 4, run_dir=str(tmp_path / "jsj"))
    jrecs, _ = jscan(str(tmp_path / "jsj" / "recover_ckpt_run.journal"))
    assert [(r["kind"], r["worker_rounds"]) for r in jrecs] == \
        [(r["kind"], r["worker_rounds"]) for r in recs]
    assert jrec["worker_rounds"] == stale_control["worker_rounds"]
    js = checkpoint.load_job_state(
        checkpoint.find_snapshots(os.path.join(d, "recover_ckpt"))[-1])
    assert set(js["stale"]) == {"ledger", "replicas"}
    with pytest.raises(ValueError):
        recover.run_driver(ctx, 2, run_dir=str(tmp_path / "x"),
                           kill_at=("stale_boundary", 1), kill=_kill)
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


def test_subprocess_sigkill_at_stale_boundary(tmp_path, stale_control):
    """The stale leg under a real SIGKILL at ``stale_boundary:1``: the
    resume replays round 1 from the journaled vector (at most the bound)
    and ends at the stale control's digest."""
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "sparknet_tpu_torch.runtime.recover",
            "--workdir", str(tmp_path), "--rounds", "4", "--device", "cpu",
            "--stale_bound", "2"]
    killed = subprocess.run(base + ["--kill_at", "stale_boundary:1"], env=env,
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    done = subprocess.run(base + ["--resume"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    rec = json.loads(done.stdout.strip().splitlines()[-1])
    assert rec["rounds_executed"] == [1, 2, 3]
    assert rec["resume_info"]["worker_rounds"] == [1, 0]
    assert rec["final_digest"] == stale_control["final_digest"]
