"""``lm_app`` across OS processes: the LM's dp x sp mesh, on the CPU over
gloo.

Rank ``d * sp + s`` holds dp worker ``d``'s sequence shard ``s`` (the
JAX app's device order); the ring runs over the sp group (the flash
steps' plain versions here, K1/K3/K4 on the card), the Solver sums the
partial grads over it, and the average reduces over the dp group.  This
file is also its own rank script (``python test_torch_lm_multiprocess.py
<pid> <store> <nprocs> <out> <lm_app args...>``): each rank joins, runs
``lm_app.main`` and saves its losses and params.  The JAX package's sp
LM tests are red on this jax build (``tests/test_torch_lm_sp.py``), so
the reference is the port's one-process stacked run of the same dp x sp,
which those tests hold to the port's sp=1 run and the JAX ring.

- sp=2 over 2 ranks against the stacked run: losses and params within
  the ring's tolerance (5e-5, the JAX sp test's); the global loss
  bit-identical on both ranks, and the params.
- Snapshots across ranks: 4 rounds against 2 rounds and a ``--resume``
  to 4, bit for bit; rank 0 alone writes.
- ``tools/launch.py --nprocs 4 lm --sp 2 --workers 2`` (dp=2 x sp=2):
  rank 0 alone logs; its smoothed losses and its last snapshot's params
  within the ring's tolerance of the stacked run's.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank script
    sys.path.insert(0, REPO)

from sparknet_tpu_torch.apps import lm_app  # noqa: E402
from sparknet_tpu_torch.utils import procs  # noqa: E402
from sparknet_tpu_torch.utils.tree import tree_leaves  # noqa: E402

APP = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2",
       "--seq_len", "32", "--batch", "4", "--tau", "2", "--seed", "3"]
SP_TOL = 5e-5  # the JAX sp test's bound (test_lm.py:286)


def _summary(res):
    """What a run leaves to compare: its per-round losses and worker 0's
    params (every worker's are the consensus after a round)."""
    params = [x[0].numpy() for x in tree_leaves(res["state"].params)]
    return {"losses": res["losses"], **{f"p{i}": p for i, p in
                                        enumerate(params)}}


def rank_main(argv):
    pid, address, nprocs, out = int(argv[0]), argv[1], int(argv[2]), argv[3]
    legs = [leg.split() for leg in argv[4].split("|")]
    from sparknet_tpu_torch.parallel import mesh

    mesh.initialize_distributed(address, nprocs, pid, device="cpu")
    for i, leg in enumerate(legs):
        res = {}
        assert lm_app.main(APP + leg, result=res) == 0
        np.savez(f"{out}.{i}.npz", snapshots=np.array(len(res["snapshots"])),
                 **_summary(res))
    mesh.shutdown()
    print(f"LM_OK p{pid}", flush=True)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
    sys.exit(0)


def _ranks(tmp, nprocs, legs):
    with open(__file__) as f:
        src = f.read()
    outs = [os.path.join(str(tmp), f"rank{p}") for p in range(nprocs)]
    procs.run_worker_processes(
        src, "LM_OK", REPO, nprocs=nprocs,
        per_rank_args=[[str(nprocs), o, "|".join(" ".join(leg)
                                                  for leg in legs)]
                       for o in outs],
        timeout=240, workdir=str(tmp),
        env_extra={"SPARKNET_LOG_DIR": str(tmp)})
    return [[dict(np.load(f"{o}.{i}.npz")) for o in outs]
            for i in range(len(legs))]


def _stacked(argv):
    res = {}
    assert lm_app.main(APP + argv, result=res) == 0
    return _summary(res)


def _params(run):
    return [run[k] for k in sorted((k for k in run if k.startswith("p")),
                                   key=lambda k: int(k[1:]))]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm2")
    prefix = str(d / "snap" / "lm")
    snap = ["--snapshot_prefix", prefix, "--snapshot_every", "2"]
    return _ranks(d, 2, [
        ["--sp", "2", "--rounds", "2"] + snap,
        ["--sp", "2", "--rounds", "4", "--resume"] + snap,
        ["--sp", "2", "--rounds", "4", "--snapshot_prefix",
         str(d / "whole" / "lm"), "--snapshot_every", "4"],
    ])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This process's references on one thread, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ranks_follow_the_stacked_run(two, monkeypatch, tmp_path):
    """sp=2 over 2 ranks (2 rounds, snapshotting): each rank's global
    loss and params the same bits; both within the ring's tolerance of
    the stacked run."""
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path))
    ranks = two[0]
    want = _stacked(["--sp", "2", "--rounds", "2"])
    for r in ranks:
        assert r["losses"].shape == want["losses"].shape
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for a, b in zip(_params(r), _params(ranks[0])):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=SP_TOL, atol=SP_TOL)
    for a, b in zip(_params(ranks[0]), _params(want)):
        np.testing.assert_allclose(a, b, rtol=SP_TOL, atol=SP_TOL)


def test_snapshot_and_resume_across_ranks(two):
    first, resumed, whole = two
    for r in (0, 1):  # rank 0 alone writes
        assert int(whole[r]["snapshots"]) == (1 if r == 0 else 0)
        assert int(first[r]["snapshots"]) == (1 if r == 0 else 0)
        for a, b in zip(_params(resumed[r]), _params(whole[r])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(resumed[r]["losses"],
                                      whole[r]["losses"][2:])


def test_launch_four_ranks_dp2_sp2(tmp_path):
    """``launch --nprocs 4 lm --sp 2 --workers 2``: rank 0 alone logs;
    its smoothed losses and the consensus it snapshots at the end lie
    within the ring's tolerance of the stacked dp=2 x sp=2 run."""
    from sparknet_tpu_torch.io import caffemodel

    store = "file://" + str(tmp_path / "store")
    prefix = str(tmp_path / "snap" / "lm")
    argv = ["--sp", "2", "--workers", "2", "--rounds", "2", "--log_every",
            "1", "--snapshot_prefix", prefix, "--snapshot_every", "2"]
    out = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.launch", "--nprocs",
         "4", "--coordinator", store, "lm", *APP, *argv],
        capture_output=True, text=True, timeout=300,
        env=procs.repo_env(REPO, {"SPARKNET_LOG_DIR": str(tmp_path)}),
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    assert "[host 0] launch: 4 process(es) joined over gloo" in text
    assert "over the sp process group" in text
    assert not re.search(r"\[host [123]\] \d+\.\d+:", text)  # rank 0 logs
    got = [float(v) for v in re.findall(r"round \d+ smoothed_loss (\S+)",
                                        text)]
    res = {}
    assert lm_app.main(APP + argv[:-4], result=res) == 0
    np.testing.assert_allclose(got, res["smoothed"], atol=5e-4)
    blobs = caffemodel.load_weights(f"{prefix}_iter_4.caffemodel")
    want = res["state"].params
    for group in want:
        for a, b in zip(blobs[group], want[group]):
            np.testing.assert_allclose(a, b[0].numpy(), rtol=SP_TOL,
                                       atol=SP_TOL)
