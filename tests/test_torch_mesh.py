"""The port's process mesh (``parallel/mesh.py``) on the CPU.

- ``make_mesh``'s axis arithmetic against JAX ``make_mesh`` on the
  8-device CPU mesh: a ``-1`` absorbing the rest, the first devices
  taken, and the same divisibility and size errors.
- A two-rank gloo join through a ``file://`` store: the mesh's
  coordinates and groups on each rank, a rows gather and an object
  gather across the ranks.
- The backend rule: ranks sharing a card refuse without
  ``backend="gloo"``, NCCL refuses CPU ranks, a CUDA rank refuses where
  there is no card, and a join whose peer never arrives raises.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import make_mesh as j_make_mesh
from sparknet_tpu_torch.parallel import mesh
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("axes", [
    None, {"dp": -1}, {"dp": -1, "mp": 2}, {"dp": 2, "sp": -1},
    {"dp": 2, "sp": 2}, {"dp": 4}, {"dp": 1, "sp": 8},
])
def test_make_mesh_arithmetic_matches_jax(axes):
    jm = j_make_mesh(axes)
    tm = mesh.make_mesh(axes, devices=8, workers_per_process=8)
    assert tuple(tm.shape) == tuple(jm.axis_names)
    assert tuple(tm.shape.values()) == tuple(jm.devices.shape)
    assert tm.process_count == 1 and tm.size == jm.devices.size
    # one process holds every coordinate, and no axis crosses processes
    for axis, n in tm.shape.items():
        assert tm.coords[axis] == slice(0, n)
        assert mesh.local_worker_slice(tm, axis) == slice(0, n)
        assert tm.group(axis) is None


@pytest.mark.parametrize("axes", [{"dp": -1, "mp": 3}, {"dp": 16},
                                  {"dp": 4, "sp": 4}])
def test_make_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as je:
        j_make_mesh(axes)
    with pytest.raises(ValueError) as te:
        mesh.make_mesh(axes, devices=8, workers_per_process=8)
    assert str(te.value) == str(je.value)


_JOIN_WORKER = r"""
import sys

import torch

pid, address = int(sys.argv[1]), sys.argv[2]
from sparknet_tpu_torch.parallel import mesh

dev = mesh.initialize_distributed(address, 2, pid, device="cpu")
assert dev == torch.device("cpu") and mesh.joined_backend() == "gloo"
assert (mesh.process_count(), mesh.process_index()) == (2, pid)
m = mesh.make_mesh({"dp": -1}, workers_per_process=2)
assert m.shape == {"dp": 4} and m.workers_per_process == 2
assert mesh.local_worker_slice(m) == slice(2 * pid, 2 * pid + 2)
assert m.group("dp") is not None
rows = mesh.all_gather_rows(torch.full((2, 3), float(pid)), m.group("dp"))
assert rows[:, 0].tolist() == [0.0, 0.0, 1.0, 1.0], rows
assert mesh.all_gather_objects({"pid": pid}) == [{"pid": 0}, {"pid": 1}]
leaves, nbytes = mesh.all_gather_leaves(
    [torch.full((2, 2), float(pid)), torch.full((2,), pid, dtype=torch.int8)],
    m.group("dp"))
assert [tuple(x.shape) for x in leaves] == [(4, 2), (4,)]
assert leaves[1].tolist() == [0, 0, 1, 1] and nbytes == 2 * 2 * 4 + 2
# dp x sp: the sp axis stays inside each process, dp crosses them
m2 = mesh.make_mesh({"dp": 2, "sp": 2}, workers_per_process=2)
assert m2.coords == {"dp": slice(pid, pid + 1), "sp": slice(0, 2)}
assert m2.group("sp") is None and m2.group("dp") is not None
mesh.shutdown()
assert mesh.process_count() == 1
print(f"JOIN_OK p{pid}")
"""


def test_two_rank_gloo_join(tmp_path):
    outs = procs.run_worker_processes(_JOIN_WORKER, "JOIN_OK", REPO,
                                      nprocs=2, timeout=120,
                                      workdir=str(tmp_path))
    assert all("JOIN_OK" in o for o in outs)


def test_backend_rule():
    cuda0 = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="pass backend='gloo'"):
        mesh.choose_backend(cuda0, shared=True, backend=None)
    with pytest.raises(RuntimeError, match="pass backend='gloo'"):
        mesh.choose_backend(cuda0, shared=True, backend="nccl")
    assert mesh.choose_backend(cuda0, shared=True, backend="gloo") == "gloo"
    assert mesh.choose_backend(cuda0, shared=False, backend=None) == "nccl"
    assert mesh.choose_backend(torch.device("cpu"), False, None) == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        mesh.choose_backend(torch.device("cpu"), False, "nccl")
    with pytest.raises(ValueError, match="expected gloo or nccl"):
        mesh.choose_backend(torch.device("cpu"), False, "mpi")


def test_join_refuses_without_a_card_and_without_peers(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.initialize_distributed(
                "file://" + str(tmp_path / "s0"), 1, 0, device="cuda")
    # one rank of two: the store times out and the join raises
    code = (
        "import sys; from sparknet_tpu_torch.parallel import mesh\n"
        "mesh.JOIN_TIMEOUT_S = 2\n"
        "try:\n"
        f"    mesh.initialize_distributed('file://{tmp_path}/s1', 2, 0, "
        "device='cpu')\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__); sys.exit(0)\n"
        "sys.exit(1)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=procs.repo_env(REPO))
    assert out.returncode == 0 and "RAISED" in out.stdout, out.stdout + out.stderr
    assert mesh.process_count() == 1 and mesh.joined_device() is None


def test_app_mesh_refuses_single_process_flags(monkeypatch):
    import argparse

    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    args = argparse.Namespace(workers=3)
    with pytest.raises(SystemExit, match="--workers == all workers"):
        mesh.app_mesh(args, "cifar_app")
    for flag, value in (("stale_bound", 1), ("elastic", True), ("slices", 2),
                        ("journal", True), ("overlap_avg", True),
                        ("profile", True)):
        args = argparse.Namespace(workers=0, **{flag: value})
        with pytest.raises(SystemExit, match=f"--{flag} across processes is "
                           "not yet ported"):
            mesh.app_mesh(args, "cifar_app")
