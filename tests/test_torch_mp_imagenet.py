"""``imagenet_app`` takes the failure and straggler flags across OS
processes (``tools/launch.py --nprocs 2``, CPU ranks over gloo):
``--slices 2 --cross_slice_every 2 --stale_bound 1 --profile`` trains
and profiles; the machinery's numbers are held to the stacked run in
``test_torch_mp_machinery.py``.
"""

import os
import re
import subprocess
import sys

from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(tmp_path, *argv):
    store = "file://" + str(tmp_path / f"store{len(os.listdir(tmp_path))}")
    out = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.launch", "--nprocs",
         "2", "--coordinator", store, *argv], capture_output=True, text=True,
        timeout=300, env=procs.repo_env(REPO, {"SPARKNET_LOG_DIR":
                                               str(tmp_path / "logs")}),
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_imagenet_takes_tiers_staleness_and_profile(tmp_path):
    argv = ["--device", "cpu", "--workers", "2", "--tau", "1", "--rounds",
            "2", "--full_size", "72", "--crop", "67", "--train_batch", "2",
            "--test_batch", "2", "--test_every", "100", "--slices", "2",
            "--cross_slice_every", "2", "--stale_bound", "1", "--profile"]
    text = _launch(tmp_path, "imagenet", *argv)
    assert "profile: round anatomy over 2 round(s)" in text
    assert re.search(r"\[host 0\] .*final accuracy", text)
