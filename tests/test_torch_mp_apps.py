"""``cifar_app`` takes the failure and straggler flags across OS
processes (``tools/launch.py --nprocs 2``, CPU ranks over gloo), and
the real entry point gives the one-process run's bits.

- ``launch --nprocs 2 --devices_per_host 2 cifar --slices 2
  --cross_slice_every 2 --compress int8 --elastic --journal
  --profile_out`` against ``cifar_app --workers 4`` in one process with
  the same flags, both observed (``utils/procs.observed_launch``: the
  real launcher, environment and app, each run's state saved): every
  rank's rows of the final params and stats, every round's losses and
  live masks, the smoothed loss and the accuracy, bit for bit, and the
  ledgers' records.
- The ledger written once (rank 0: one intent and one commit a round);
  one profile summary whose table has a row for each of the W workers.
- ``imagenet`` across ranks with the flags is in
  ``test_torch_mp_imagenet.py``, ``lm``'s journal-guided resume in
  ``test_torch_mp_journal.py`` (a file each: a launch of two ranks takes
  30-50 s when the suite's six workers load the cores).
"""

import concurrent.futures
import json
import os
import re

import numpy as np
import pytest

from sparknet_tpu_torch.io import journal
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGV = ["--device", "cpu", "--rounds", "2", "--tau", "1", "--workers", "4",
        "--test_every", "100", "--batch", "10", "--slices", "2",
        "--cross_slice_every", "2", "--compress", "int8", "--elastic",
        "--rejoin_after", "1", "--journal"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launched run (2 ranks x 2 workers) and the one-process run of
    W=4, each in a directory of its own (its ledger and profile)."""
    def run(name, launcher):
        d = dirs[name]
        if launcher:
            launcher += ["--coordinator", "file://" + str(d / "store")]
        done, ranks = procs.observed_launch(
            [*launcher, "cifar", *ARGV, "--profile_out", str(d / "p.json")],
            str(d / "observed"), REPO, {"SPARKNET_LOG_DIR": str(d / "logs")},
            timeout=300, cwd=str(d))
        assert done.returncode == 0, done.stdout + done.stderr
        return d, done.stdout, ranks

    # the two runs at once (each is its own processes); the directories
    # made first, as the factory is not thread-safe
    dirs = {name: tmp_path_factory.mktemp(name) for name in ("launched", "one")}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {name: pool.submit(run, name, launcher) for name, launcher in (
            ("launched", ["--nprocs", "2", "--devices_per_host", "2"]),
            ("one", []))}
        return {name: f.result() for name, f in runs.items()}


def _records(d):
    recs, _ = journal.scan(str(d / "cifar_run.journal"))
    return [{k: v for k, v in rec.items() if k != "t_s"} for rec in recs]


def test_cifar_takes_the_machinery_across_two_ranks(runs):
    d, text, ranks = runs["launched"]
    assert [r["rows"] for r in ranks] == [[0, 2], [2, 4]]
    assert [(r["kind"], r["round"]) for r in _records(d)] == [
        ("intent", 0), ("commit", 0), ("intent", 1), ("commit", 1)]
    assert "rank 0 writes it for all 2" in text
    summary = json.loads((d / "p.json").read_text())
    assert summary["rounds"] == 2
    assert len(summary["worker_execute_ms"]["p50"]) == 4
    assert text.count("obs: profile summary ->") == 1
    assert re.search(r"\[host 0\] .*final accuracy", text)


def test_launched_cifar_is_the_one_process_run_bit_for_bit(runs):
    d1, _, (one,) = runs["one"]
    d2, _, ranks = runs["launched"]
    assert one["rows"] == [0, 4] and len(one["leaves"]) > 0
    for r in ranks:
        lo, hi = r["rows"]
        for got, want in zip(r["leaves"], one["leaves"], strict=True):
            np.testing.assert_array_equal(got, want[lo:hi])
        np.testing.assert_array_equal(r["losses"], one["losses"])
        assert r["losses"].shape == (2, 4, 1)
        for key in ("masks", "smoothed_loss", "accuracy", "code"):
            assert r[key] == one[key], key
    assert np.isfinite(one["losses"]).all()
    assert _records(d2) == _records(d1)
