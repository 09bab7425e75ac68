"""The multi-process harness: spawn, join, run an averaging round, reap.

The port of ``sparknet_tpu/utils/procs.py``, shared by the tests
(``tests/test_torch_multiprocess.py``) and ``chip_smoke.py``, so the
bring-up scaffolding — a file store, spawn, reap with every pipe
drained concurrently, clean-up — and the workers themselves have one
copy; the launcher (``tools/launch.py``) spawns its ranks through the
same ``reap_processes``.

A worker is a script run as ``python worker.py <pid> <address> [args]``:
``address`` is a ``file://`` store (no port to race for, which is what
parallel test workers need).
The averaging workers join through ``parallel.mesh.
initialize_distributed`` on ``--device`` (``cpu``, ``cuda`` or
``cuda:0`` — two ranks on one card join over gloo only when
``--backend gloo`` says so), run the port's ``ParameterAveragingTrainer``
over the mesh's dp group and print ``<marker> p<pid>``.
``run_averaging_spec`` is the round both sides run: a worker over its
process's block of workers, the caller over all W stacked on one device
— the reference a cross-process run is held to bit for bit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# a toy net: HostData -> InnerProduct -> SoftmaxWithLoss (4 x 6 -> 3)
TOY_NET = '''
name: "toy"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 4 dim: 6 } shape { dim: 4 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
  inner_product_param { num_output: 8 weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "logits"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits"
  bottom: "label" top: "loss" }
'''
TOY_SOLVER = 'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9'

# the averaging round a worker runs: see ``run_averaging_spec``
DEFAULT_SPEC = {
    "net": "toy",  # or "cifar10_full" (the zoo net and solver)
    "workers": 4,  # W, over every process
    "tau": 2,
    "rounds": 1,
    "batch": 4,  # cifar10_full only (the toy net's batch is 4)
    "compress": "none",
    "live": None,  # a (W,) 0/1 list, or None: every worker lives
    "poison": None,  # a worker whose batch turns NaN (arms the audit)
    "seed": 0,
    "deterministic": False,  # inside utils.devices.deterministic_algorithms
    "init": None,  # an .npz of {"<layer>/<i>": blob} weights to start from
}


def _spec(spec: Optional[dict]) -> dict:
    out = dict(DEFAULT_SPEC)
    out.update(spec or {})
    return out


def averaging_solver(spec: dict, device):
    """The spec's Solver on ``device`` (the audit on when a worker is
    poisoned, so the in-round mask is armed)."""
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.solver import Solver

    if spec["net"] == "toy":
        solver = Solver(config.parse_solver_prototxt(TOY_SOLVER),
                        net_param=config.parse_net_prototxt(TOY_NET),
                        device=device)
    elif spec["net"] == "cifar10_full":
        sp = models.load_model_solver("cifar10_full")
        sp.net_param = config.replace_data_layers(
            sp.net_param, [(spec["batch"], 3, 32, 32), (spec["batch"],)],
            [(spec["batch"], 3, 32, 32), (spec["batch"],)])
        solver = Solver(sp, device=device)
    else:
        raise ValueError(f"unknown spec net {spec['net']!r}")
    if spec["poison"] is not None:
        solver.audit = True
    return solver


def averaging_batches(spec: dict, r: int) -> Dict[str, np.ndarray]:
    """Round ``r``'s host batches of every worker, (W, tau, ...): seeded
    by (seed, r), the same in every process."""
    rng = np.random.RandomState(spec["seed"] * 1009 + r)
    w, tau = spec["workers"], spec["tau"]
    if spec["net"] == "toy":
        x = rng.randn(w, tau, 4, 6).astype(np.float32)
        y = rng.randint(0, 3, (w, tau, 4)).astype(np.float32)
        out = {"x": x, "label": y}
        key = "x"
    else:
        b = spec["batch"]
        x = rng.randn(w, tau, b, 3, 32, 32).astype(np.float32)
        y = rng.randint(0, 10, (w, tau, b)).astype(np.float32)
        out = {"data": x, "label": y}
        key = "data"
    if spec["poison"] is not None:
        out[key][spec["poison"], 0].flat[0] = np.nan
    return out


def run_averaging_spec(spec: Optional[dict], device, mesh=None) -> dict:
    """Run the spec's rounds over ``mesh`` (this process's block of the
    W workers; None: all W stacked here).  Returns the params of this
    process's first worker (the consensus; host numpy, in leaf order),
    every round's (W, tau) losses, the bytes that reached this rank
    from the others a round, the host-staging ms, the K9/K10 launches
    and the wall seconds of each round."""
    import torch

    from sparknet_tpu_torch.ops import cuda_comm
    from sparknet_tpu_torch.parallel import mesh as mesh_mod
    from sparknet_tpu_torch.parallel.trainers import ParameterAveragingTrainer
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves

    spec = _spec(spec)
    device = torch.device(device)
    out: dict = {"losses": [], "group_bytes": [], "round_s": []}
    with deterministic_algorithms(bool(spec["deterministic"])):
        solver = averaging_solver(spec, device)
        trainer = ParameterAveragingTrainer(
            solver, spec["workers"], compress=spec["compress"], mesh=mesh)
        rows = trainer.rows
        if spec["init"]:
            state = trainer.broadcast_state(_carried_state(spec["init"],
                                                           solver))
        else:
            state = trainer.init_state(seed=spec["seed"])
        cuda_comm.reset_launch_counts()
        mesh_mod.reset_staging()
        live = spec["live"]
        for r in range(spec["rounds"]):
            batches = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
                device) for k, v in averaging_batches(spec, r).items()}
            t0 = time.perf_counter()
            res = trainer.round(state, batches, live_mask=live)
            state, losses = res[0], res[1]
            loss_host = losses.detach().cpu().numpy()
            out["round_s"].append(time.perf_counter() - t0)
            out["losses"].append(loss_host)
            plane = trainer._comm
            out["group_bytes"].append(
                plane.last_group_bytes if plane is not None
                else trainer.last_group_bytes)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["params"] = [x[0].detach().cpu().numpy()
                         for x in tree_leaves(state.params)]
        out["all_rows"] = [x.detach().cpu().numpy()
                           for x in tree_leaves(state.params)]
        out["staging_ms"] = float(mesh_mod.STAGING["ms"])
        out["staging_bytes"] = int(mesh_mod.STAGING["bytes"])
        out["launches"] = dict(cuda_comm.LAUNCHES)
        out["chunks"] = (len(trainer._comm.chunk_slices)
                         if trainer._comm is not None else 0)
        out["rows"] = (rows.start, rows.stop)
    return out


def save_weights(path: str, params) -> None:
    """``{layer: [blob]}`` weights (any package's) as the ``init`` file of
    a spec."""
    np.savez(path, **{f"{k}/{i}": np.asarray(b) for k, v in params.items()
                      for i, b in enumerate(v)})


def _carried_state(path: str, solver):
    """A single-replica ``TrainState`` from ``save_weights``' file."""
    import torch

    from sparknet_tpu_torch.interop import net_params_from_jax
    from sparknet_tpu_torch.solver import TrainState, _init_history

    z = np.load(path)
    params: Dict[str, list] = {}
    for key in sorted(z.files, key=lambda k: (k.rsplit("/", 1)[0],
                                              int(k.rsplit("/", 1)[1]))):
        params.setdefault(key.rsplit("/", 1)[0], []).append(z[key])
    tparams, tstats = net_params_from_jax(params, solver.net,
                                          device=solver.device)
    return TrainState(tparams, tstats, _init_history(solver.method, tparams),
                      torch.tensor(0))


def save_result(path: str, res: dict) -> None:
    """A worker's ``run_averaging_spec`` result as one ``.npz``."""
    arrays = {f"param{i}": p for i, p in enumerate(res["params"])}
    arrays.update({f"rows{i}": p for i, p in enumerate(res["all_rows"])})
    arrays["losses"] = np.stack(res["losses"])
    meta = {k: res[k] for k in ("group_bytes", "round_s", "staging_ms",
                                "staging_bytes", "launches", "chunks", "rows")}
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def load_result(path: str) -> dict:
    z = np.load(path)
    n = sum(1 for k in z.files if k.startswith("param"))
    res = json.loads(bytes(z["meta"]).decode())
    res["params"] = [z[f"param{i}"] for i in range(n)]
    res["all_rows"] = [z[f"rows{i}"] for i in range(n)]
    res["losses"] = z["losses"]
    return res


# The averaging worker: joins, then for each spec of a JSON list builds
# the mesh over the spec's W workers, runs ``run_averaging_spec`` on its
# own block and saves the result to ``<out>.<i>.npz`` (argv: pid,
# address, the specs, the output prefix, --device, --backend).  With
# --stacked_first it first runs every spec with all W stacked and no
# group (``<out>.stacked.<i>.npz``): the reference a joined run is held
# to, made in a process like the ranks'.
_AVERAGING_WORKER = r"""
import argparse
import json
import sys

ap = argparse.ArgumentParser()
ap.add_argument("pid", type=int)
ap.add_argument("address")
ap.add_argument("spec")
ap.add_argument("out")
ap.add_argument("--device", default="cuda")
ap.add_argument("--backend", default=None)
ap.add_argument("--nprocs", type=int, default=2)
ap.add_argument("--stacked_first", action="store_true")
a = ap.parse_args()

from sparknet_tpu_torch.parallel import mesh
from sparknet_tpu_torch.utils import procs
from sparknet_tpu_torch.utils.devices import resolve_device

specs = [procs._spec(s) for s in json.loads(a.spec)]
if a.stacked_first:
    for i, spec in enumerate(specs):
        procs.save_result(f"{a.out}.stacked.{i}.npz", procs.run_averaging_spec(
            spec, resolve_device(a.device)))
dev = mesh.initialize_distributed(a.address, a.nprocs, a.pid,
                                  backend=a.backend, device=a.device)
print(f"joined rank {a.pid} of {a.nprocs} on {dev} over "
      f"{mesh.joined_backend()}", flush=True)
for i, spec in enumerate(specs):
    m = mesh.make_mesh({"dp": spec["workers"]},
                       workers_per_process=spec["workers"] // a.nprocs)
    res = procs.run_averaging_spec(spec, dev, mesh=m)
    procs.save_result(f"{a.out}.{i}.npz", res)
    print(f"spec {i}: rows={res['rows']} group_bytes={res['group_bytes']} "
          f"staging_ms={res['staging_ms']:.3f} launches={res['launches']}",
          flush=True)
mesh.shutdown()
print(f"@MARKER@ p{a.pid}", flush=True)
"""


def averaging_worker(marker: str) -> str:
    return _AVERAGING_WORKER.replace("@MARKER@", marker)


# The canonical two-process averaging worker of the JAX package: W=4
# over two processes (two workers stacked on each device), one round of
# the toy net; asserts finite losses of every worker and that this
# process's two rows agree after the average.
_TOY_AVERAGING_WORKER = r"""
import argparse

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("pid", type=int)
ap.add_argument("address")
ap.add_argument("--device", default="cuda")
ap.add_argument("--backend", default=None)
a = ap.parse_args()

from sparknet_tpu_torch.parallel import mesh
from sparknet_tpu_torch.utils import procs

dev = mesh.initialize_distributed(a.address, 2, a.pid, backend=a.backend,
                                  device=a.device)
assert mesh.process_count() == 2, mesh.process_count()
m = mesh.make_mesh({"dp": 4}, workers_per_process=2)
assert mesh.local_worker_slice(m) == slice(2 * a.pid, 2 * a.pid + 2)
res = procs.run_averaging_spec({"workers": 4}, dev, mesh=m)
assert res["losses"][0].shape == (4, 2), res["losses"][0].shape
assert np.isfinite(res["losses"][0]).all(), res["losses"]
for rows in res["all_rows"]:
    np.testing.assert_array_equal(rows[0], rows[1])
mesh.shutdown()
print(f"@MARKER@ p{a.pid} loss={float(res['losses'][0].mean()):.4f}")
"""


def toy_averaging_worker(marker: str) -> str:
    return _TOY_AVERAGING_WORKER.replace("@MARKER@", marker)


# Timed variant: the share of an averaging round the cross-process
# average takes, as the round's wall time minus the same workers' local
# steps alone (``trainer._local``), over ROUNDS rounds after a warm one.
_TIMED_AVERAGING_WORKER = r"""
import argparse
import time

import torch

ap = argparse.ArgumentParser()
ap.add_argument("pid", type=int)
ap.add_argument("address")
ap.add_argument("--device", default="cuda")
ap.add_argument("--backend", default=None)
a = ap.parse_args()

from sparknet_tpu_torch.parallel import mesh
from sparknet_tpu_torch.parallel.trainers import ParameterAveragingTrainer
from sparknet_tpu_torch.utils import procs

dev = mesh.initialize_distributed(a.address, 2, a.pid, backend=a.backend,
                                  device=a.device)
m = mesh.make_mesh({"dp": 4}, workers_per_process=2)
spec = procs._spec({"workers": 4, "tau": 10})
TAU, ROUNDS = spec["tau"], 10
solver = procs.averaging_solver(spec, dev)
trainer = ParameterAveragingTrainer(solver, 4, mesh=m)
state = trainer.init_state(seed=0)
batches = {k: torch.from_numpy(v[trainer.rows].copy()).to(dev)
           for k, v in procs.averaging_batches(spec, 0).items()}


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn):
    global state
    state = fn(state)  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        state = fn(state)
    sync()
    return (time.perf_counter() - t0) / ROUNDS


avg = timed(lambda s: trainer.round(s, batches)[0])
local = timed(lambda s: trainer._local(s, batches)[0])
coll_ms = max(0.0, (avg - local) * 1e3)
mesh.shutdown()
print(f"@MARKER@ p{a.pid} avg_ms={avg * 1e3:.3f} local_ms={local * 1e3:.3f} "
      f"collective_ms={coll_ms:.3f} tau={TAU}")
"""


def timed_averaging_worker(marker: str) -> str:
    return _TIMED_AVERAGING_WORKER.replace("@MARKER@", marker)


def fleet_ship_worker(marker: str) -> str:
    """The JAX package's fleet-shipping worker needs ``obs/ship.py``."""
    raise NotImplementedError(
        "fleet_ship_worker is not yet ported: the fleet plane "
        "(obs/ship.py, obs/fleet.py) comes with ROADMAP A.10"
    )


def free_port() -> int:
    """A loopback port free at the time of the probe."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def repo_env(repo_root: str, env_extra: Optional[Dict[str, str]] = None
             ) -> Dict[str, str]:
    """The environment of a spawned worker: the repo on ``PYTHONPATH``,
    one thread a rank (ranks share the host's cores)."""
    return {
        **os.environ,
        "PYTHONPATH": repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1"),
        **(env_extra or {}),
    }


def reap_processes(cmds: Sequence[Sequence[str]],
                   envs: Sequence[Dict[str, str]], timeout: float
                   ) -> Tuple[Dict[int, Tuple[int, str]], List[int], bool]:
    """Start one process per ``cmds[i]`` (environment ``envs[i]``, stdout
    and stderr together) and wait for them.  Returns ``(results, killed,
    timed_out)``: each rank's ``(exit code, output)``, the ranks this
    call killed, and whether the deadline passed.

    Each process is reaped on its own thread (its pipe drained as it
    runs, so a full pipe never stalls a rank inside a collective); a
    rank that fails ends the wait at once and its peers, which would sit
    in a collective until their timeout, are killed."""
    children = [subprocess.Popen(list(cmd), env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for cmd, env in zip(cmds, envs)]
    results: Dict[int, Tuple[int, str]] = {}

    def reap(pid: int, p: subprocess.Popen) -> None:
        out, _ = p.communicate()
        results[pid] = (p.returncode, out)

    threads = [threading.Thread(target=reap, args=(pid, p),
                                name=f"procs-reap-p{pid}", daemon=True)
               for pid, p in enumerate(children)]
    for t in threads:
        t.start()
    deadline = time.time() + timeout
    timed_out = True
    killed: List[int] = []
    try:
        while time.time() < deadline:
            if all(not t.is_alive() for t in threads):
                timed_out = False
                break
            if any(rc != 0 for rc, _ in list(results.values())):
                timed_out = False
                break  # a rank failed: do not wait out its peers
            time.sleep(0.05)
    finally:
        for pid, p in enumerate(children):
            if p.poll() is None:
                p.kill()
                killed.append(pid)
        for t in threads:
            t.join(timeout=30)
    return results, killed, timed_out


def _report(results: Dict[int, Tuple[int, str]]) -> str:
    return "".join(f"\n-- worker {pid} rc={rc}:\n{out}"
                   for pid, (rc, out) in sorted(results.items()))


def run_worker_processes(
    worker_src: str,
    marker: str,
    repo_root: str,
    nprocs: int = 2,
    args: Sequence[str] = (),
    per_rank_args: Optional[Sequence[Sequence[str]]] = None,
    timeout: int = 600,
    env_extra: Optional[Dict[str, str]] = None,
    workdir: Optional[str] = None,
) -> List[str]:
    """Spawn ``nprocs`` workers running ``worker_src`` (argv: pid,
    address, then ``args`` and the rank's ``per_rank_args``); assert all
    exit 0 and print ``<marker> p<pid>``; return the outputs in rank
    order.  The ranks join through a file store in a temporary
    directory (under ``workdir`` when given), so parallel callers never
    race for a port.  Reaped by ``reap_processes``: a failing worker
    ends the wait, and the error carries every output collected."""
    with tempfile.TemporaryDirectory(prefix="mp_round_", dir=workdir) as d:
        script = os.path.join(d, "worker.py")
        with open(script, "w") as f:
            f.write(worker_src)
        address = "file://" + os.path.join(d, "store")
        env = repo_env(repo_root, env_extra)
        cmds = [[sys.executable, script, str(pid), address, *args,
                 *(per_rank_args[pid] if per_rank_args else ())]
                for pid in range(nprocs)]
        results, _, timed_out = reap_processes(cmds, [env] * nprocs, timeout)
        if timed_out or len(results) < nprocs:
            raise TimeoutError(f"worker(s) did not finish within {timeout}s; "
                               "collected: " + _report(results))
        if any(rc != 0 for rc, _ in results.values()):
            raise AssertionError("worker failure:" + _report(results))
        for pid in range(nprocs):
            assert f"{marker} p{pid}" in results[pid][1], results[pid][1]
        return [results[pid][1] for pid in range(nprocs)]


def run_two_process_round(
    worker_src: str,
    marker: str,
    repo_root: str,
    devices_per_process: int = 2,
    timeout: int = 600,
    env_extra: Optional[Dict[str, str]] = None,
    args: Sequence[str] = ("--device", "cuda"),
    **kw,
) -> List[str]:
    """Two workers of ``worker_src`` (the JAX package's harness
    signature): each stacks ``devices_per_process`` workers
    (``$SPARKNET_LOCAL_WORKERS``) on the device ``args`` name, the card
    by default (``("--device", "cpu")`` for CPU ranks)."""
    env = {"SPARKNET_LOCAL_WORKERS": str(devices_per_process),
           **(env_extra or {})}
    return run_worker_processes(worker_src, marker, repo_root, nprocs=2,
                                args=args, timeout=timeout, env_extra=env,
                                **kw)


def run_averaging_processes(specs: Sequence[dict], repo_root: str,
                            nprocs: int = 2, device: str = "cuda",
                            backend: Optional[str] = None, timeout: int = 600,
                            workdir: Optional[str] = None,
                            env_extra: Optional[Dict[str, str]] = None,
                            stacked_first: bool = False):
    """Run each spec of ``specs`` in turn over ``nprocs`` processes joined
    once (``averaging_worker``) on ``device`` (the card by default).  Returns ``(joined, stacked, logs)``:
    per spec, each rank's ``run_averaging_spec`` result; with
    ``stacked_first``, per spec, rank 0's run of all W stacked before it
    joined (else None); and the ranks' outputs."""
    marker = "AVG_OK"
    with tempfile.TemporaryDirectory(prefix="mp_avg_", dir=workdir) as d:
        outs = [os.path.join(d, f"rank{pid}") for pid in range(nprocs)]
        args = [json.dumps([_spec(s) for s in specs])]
        tail = ["--device", device, "--nprocs", str(nprocs)]
        if backend:
            tail += ["--backend", backend]
        logs = run_worker_processes(
            averaging_worker(marker), marker, repo_root, nprocs=nprocs,
            args=args,
            per_rank_args=[[o] + tail + (["--stacked_first"]
                                         if stacked_first and pid == 0 else [])
                           for pid, o in enumerate(outs)],
            timeout=timeout, workdir=d, env_extra=env_extra)
        joined = [[load_result(f"{o}.{i}.npz") for o in outs]
                  for i in range(len(specs))]
        stacked = ([load_result(f"{outs[0]}.stacked.{i}.npz")
                    for i in range(len(specs))] if stacked_first else None)
        return joined, stacked, logs
