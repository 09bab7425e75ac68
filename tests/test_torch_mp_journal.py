"""``lm_app --journal`` across OS processes (``tools/launch.py --nprocs
2``, CPU ranks over gloo): rank 0 keeps the one ledger beside its
snapshots, and a ``--resume`` is decided on rank 0 from that ledger and
broadcast (``apps/lm_app.resume_lm_job``); the resumed run continues at
the committed round, appends its records there and ends on the smoothed
loss of the one-process run of the same W.  (The JAX processes
each open the same path: ROADMAP §C, Settled.)  At ``--sp`` > 1 across
processes the machinery's flags still refuse, each naming itself.
"""

import glob
import os
import re
import subprocess
import sys

import pytest

from sparknet_tpu_torch.io import journal
from sparknet_tpu_torch.tools import launch
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2",
      "--seq_len", "32", "--batch", "4", "--tau", "2", "--log_every", "1"]


# the uninterrupted run of the same W in one process, one thread as each
# rank runs; its smoothed loss exactly
_REFERENCE = (
    "import sys\n"
    "from sparknet_tpu_torch.apps import lm_app\n"
    "r = {}\n"
    "assert lm_app.main(sys.argv[1:], result=r) == 0\n"
    "print('SMOOTHED', repr(r['smoothed_loss']))\n")


def _launch(capsys, store, *argv):
    """``tools/launch`` in this process (its ranks are OS processes)."""
    code = launch.main(["--nprocs", "2", "--coordinator", store, *argv])
    out = capsys.readouterr().out
    assert code == 0, out
    return out


def _last(pattern, text):
    return re.findall(pattern, text)[-1]


def test_lm_journal_resume_is_decided_on_rank_zero(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prefix = str(tmp_path / "b" / "lm")
    # the reference runs beside the launches
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, *LM, "--workers", "2", "--rounds",
         "3"], env=procs.repo_env(REPO, {"SPARKNET_LOG_DIR": str(
             tmp_path / "ref_logs")}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path))
    try:
        _launch(capsys, f"file://{tmp_path}/store0", "lm", *LM, "--rounds",
                "2", "--journal", "--snapshot_prefix", prefix,
                "--snapshot_every", "1")
        recs, _ = journal.scan(prefix + "_run.journal")
        assert [r["kind"] for r in recs] == ["intent", "commit"] * 2
        resumed = _launch(capsys, f"file://{tmp_path}/store1", "lm", *LM,
                          "--rounds", "3", "--resume", "--snapshot_prefix",
                          prefix, "--snapshot_every", "1")
        out, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, out
    whole = float(_last(r"SMOOTHED (\S+)", out))
    assert "at round 2 (iter 4)" in resumed
    assert any("round 2: snapshot written by rank 0" in open(f).read()
               for f in glob.glob(str(tmp_path / "logs" / "*_lm_p1.txt")))
    assert float(_last(r"final smoothed_loss (\S+)", resumed)) == \
        pytest.approx(whole, abs=5e-5)
    recs, _ = journal.scan(prefix + "_run.journal")
    assert [(r["kind"], r["round"]) for r in recs][-2:] == [
        ("intent", 2), ("commit", 2)]


@pytest.mark.parametrize("flag,value", [
    ("stale_bound", 1), ("elastic", True), ("slices", 2), ("journal", True),
    ("profile", True), ("profile_out", "p.json")])
def test_lm_sp_ring_across_processes_refuses_the_machinery(monkeypatch, flag,
                                                           value):
    """At ``--sp`` > 1 across processes a worker's state spans an sp
    group, which the machinery does not yet span: each flag exits naming
    itself (ROADMAP §A item 2)."""
    import argparse

    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    args = argparse.Namespace(workers=0, overlap_avg=False, **{flag: value})
    with pytest.raises(SystemExit, match=f"--{flag} with --sp 2 across "
                       "processes .* not yet ported"):
        lm_app._process_mesh(args, 2)

