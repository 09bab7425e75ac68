"""The port's ``apps.cifar_app`` end to end on the CPU.

cifar10_full on synthesized CIFAR data at the prototxt's batch of 100,
2 workers, tau 2, 2 rounds, through the comm plane's plain versions.
The app draws its init from torch's generator, not JAX's PRNG, so its
losses are not compared with the JAX app's here; the trainer tests
(``test_torch_comm.py``) hold a cifar10_full round to the JAX trainer
from carried weights instead.
"""

import glob
import math
import os
import re

import pytest
import torch

from sparknet_tpu_torch.apps import cifar_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--workers", "2", "--tau", "2", "--rounds", "2"]


def _run(tmp_path, monkeypatch, argv):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path))
    root_logs = set(glob.glob(os.path.join(REPO, "training_log_*.txt")))
    result = {}
    assert cifar_app.main(["--device", "cpu"] + SMALL + argv, result) == 0
    assert set(glob.glob(os.path.join(REPO, "training_log_*.txt"))) == root_logs
    (log,) = glob.glob(os.path.join(str(tmp_path), "training_log_*_cifar.txt"))
    with open(log) as f:
        return f.read(), result


@pytest.mark.parametrize(
    "argv", [["--compress", "int8"], ["--compress", "bf16", "--overlap_avg"]],
    ids=["int8", "bf16_overlap"],
)
def test_cifar_app_trains_on_the_cpu(tmp_path, monkeypatch, argv):
    text, result = _run(tmp_path, monkeypatch, argv)
    accs = [float(m) for m in re.findall(r"accuracy (\d+\.\d+)", text)]
    losses = [float(m) for m in re.findall(r"smoothed_loss (\S+)", text)]
    assert len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)  # round 0 + final
    assert len(losses) == 2 and all(math.isfinite(l) for l in losses)
    assert "test output loss" in text and "num workers: 2" in text
    m = result["metrics"]
    assert m.rounds.value == 2 and m.iters.value == 4
    assert m.kernel_fused_chunks.labels("encode").value == 0  # CPU: no kernels
    trainer = result["trainer"]
    assert trainer._comm is not None and len(trainer._comm.chunk_slices) == 3
    for leaf in result["state"].params["conv1"]:
        assert leaf.shape[0] == 2 and torch.isfinite(leaf).all()
