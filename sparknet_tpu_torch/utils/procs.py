"""The multi-process harness: spawn, join, run an averaging round, reap.

The port of ``sparknet_tpu/utils/procs.py``, shared by the tests
(``tests/test_torch_multiprocess.py``) and ``chip_smoke.py``, so the
bring-up scaffolding — a file store, spawn, reap with every pipe
drained concurrently, clean-up — and the workers themselves have one
copy; the launcher (``tools/launch.py``) spawns, preempts and relaunches
its ranks through the same ``Children``.

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
``observed_launch`` runs the real launcher and app, each process saving
what its ``cifar_app`` computed, so a launched run can be held to a
one-process run of the same flags.
"""

from __future__ import annotations

import hashlib
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
    # the averaging machinery, through the apps' RoundGuards (a spec
    # that sets any of these runs ``run_machinery_spec``)
    "slices": 1,  # --slices
    "cross_slice_every": 1,  # --cross_slice_every
    "stale_bound": 0,  # --stale_bound (every worker arrives each round)
    "elastic": False,  # --elastic --rejoin_after 1
    "preempt": None,  # [round, slice]: a SIGTERM notice at that boundary
    "journal": False,  # --journal (the records, rank 0's ledger)
    "profile": False,  # --profile --profile_out
}
_MACHINERY = ("slices", "cross_slice_every", "stale_bound", "elastic",
              "preempt", "journal", "profile")


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


def run_averaging_spec(spec: Optional[dict], device, mesh=None,
                       workdir: Optional[str] = None) -> dict:
    """Run the spec's rounds over ``mesh`` (this process's block of the
    W workers; None: all W stacked here).  Returns the params of this
    process's first worker (the consensus; host numpy, in leaf order),
    every round's (W, tau) losses, the bytes that reached this rank
    from the others a round, the host-staging ms, the K9/K10 launches
    and the wall seconds of each round.  A spec that asks for the
    averaging machinery runs ``run_machinery_spec`` (files under
    ``workdir``)."""
    import torch

    spec = _spec(spec)
    if any(spec[k] != DEFAULT_SPEC[k] for k in _MACHINERY):
        return run_machinery_spec(spec, device, mesh, workdir)

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


class _Log:
    """The ``log`` a ``RoundGuards`` writes to: lines kept, not printed."""

    def __init__(self):
        self.lines: List[str] = []

    def log(self, message: str, i: int = -1) -> None:
        self.lines.append(str(message))


def run_machinery_spec(spec: dict, device, mesh=None,
                       workdir: Optional[str] = None) -> dict:
    """The spec's rounds through the apps' round loop (``apps/guards.
    RoundGuards`` built from the flags the spec names, as ``cifar_app``
    builds it): the membership boundary, the journal's intent and
    commit, the trainer's round (two-tier, bounded-staleness or flat)
    and the profiler.  A ``preempt`` notice reaches the stacked run as
    ``note_preempt`` and a joined run as a SIGTERM that each process
    whose slice (that of its first worker, ``$SPARKNET_SLICE_ID``) is
    the preempted one sends itself.  Returns ``run_averaging_spec``'s
    keys plus each round's live mask, view epoch, roster and tier, the
    bytes that reached this rank by tier, the journal's records (rank 0
    of a joined run; ``t_s`` dropped), the profile's per-worker table
    and the K9/K10 launches."""
    import argparse
    import signal

    import torch

    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.io import journal as journal_mod
    from sparknet_tpu_torch.obs import profile as profile_mod
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.ops import cuda_comm
    from sparknet_tpu_torch.parallel import mesh as mesh_mod
    from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves

    device = torch.device(device)
    joined = mesh is not None and mesh.group("dp") is not None
    tag = f"p{mesh_mod.process_index()}" if joined else "stacked"
    workdir = workdir or tempfile.mkdtemp(prefix="machinery_")
    W = spec["workers"]
    args = argparse.Namespace(
        compress=spec["compress"], overlap_avg=False, slices=spec["slices"],
        cross_slice_every=spec["cross_slice_every"],
        stale_bound=spec["stale_bound"], stale_discount=0.5,
        elastic=bool(spec["elastic"]), rejoin_after=1,
        journal=True if spec["journal"] else None, journal_path=None,
        journal_fsync="never", profile=bool(spec["profile"]),
        profile_out=None)
    rows = slice(0, W) if mesh is None else mesh.coords["dp"]
    groups = HierarchySpec.grouped(W, max(1, spec["slices"])).slices
    my_slice = next(i for i, g in enumerate(groups) if rows.start in g)
    os.environ["SPARKNET_SLICE_ID"] = str(my_slice)
    out: dict = {"losses": [], "group_bytes": [], "round_s": [], "masks": [],
                 "epochs": [], "states": [], "tiers": [], "tier_bytes": []}
    # one ledger (and one profile file) a spec and a run of it
    key = hashlib.sha1(json.dumps(spec, sort_keys=True).encode()).hexdigest()
    tag = f"{tag}.{key[:12]}"
    jpath = os.path.join(workdir, f"run.{tag}.journal")
    if spec["profile"]:
        args.profile_out = os.path.join(workdir, f"profile.{tag}.json")
    log = _Log()
    metrics = TrainingMetrics()
    with deterministic_algorithms(bool(spec["deterministic"])):
        solver = averaging_solver(spec, device)
        guards = RoundGuards.from_args(
            args, solver, W, log=log, metrics=metrics,
            journal_path=jpath, mesh=mesh)
        trainer = guards.trainer
        if spec["init"]:
            state = trainer.broadcast_state(_carried_state(spec["init"],
                                                           solver))
        else:
            state = trainer.init_state(seed=spec["seed"])
        run_obs = obs.start_from_args(args, echo=log.log, tm=metrics)
        cuda_comm.reset_launch_counts()
        mesh_mod.reset_staging()
        hb = metrics.hierarchy_bytes
        try:
            with guards.signals():
                for r in range(spec["rounds"]):
                    host = averaging_batches(spec, r)
                    # each worker's window drawn (and timed) on its own
                    windows = profile_mod.timed_worker_windows(r, [
                        lambda w=w: {k: v[w] for k, v in host.items()}
                        for w in range(rows.start, rows.stop)])
                    batches = {k: torch.from_numpy(np.ascontiguousarray(
                        np.stack([win[k] for win in windows]))).to(device)
                        for k in host}
                    pre = spec["preempt"]
                    if pre is not None and pre[0] == r:
                        if not joined:
                            guards.membership.note_preempt(slice_index=pre[1])
                        elif my_slice == pre[1]:
                            os.kill(os.getpid(), signal.SIGTERM)
                    before = (hb.labels("intra").value,
                              hb.labels("cross").value)
                    t0 = time.perf_counter()
                    guards.begin(r, iter=r * spec["tau"], cursor=r)
                    state, mask = guards.boundary(state, r)
                    state, losses = guards.round(state, batches, mask, r)
                    out["losses"].append(losses.detach().cpu().numpy())
                    out["round_s"].append(time.perf_counter() - t0)
                    guards.commit(r, iter=(r + 1) * spec["tau"],
                                  durable=False)
                    intra = (trainer._two_tier
                             and not trainer.hierarchy.is_cross_round(r))
                    plane = trainer._comm
                    out["group_bytes"].append(
                        plane.last_group_bytes if plane is not None
                        and not intra else trainer.last_group_bytes)
                    out["masks"].append(None if mask is None
                                        else [float(v) for v in mask])
                    view = (guards.membership.view
                            if guards.membership is not None else None)
                    out["epochs"].append(None if view is None else view.epoch)
                    out["states"].append(None if view is None
                                         else list(view.states))
                    out["tiers"].append("intra" if intra else "cross")
                    out["tier_bytes"].append(
                        [hb.labels("intra").value - before[0],
                         hb.labels("cross").value - before[1]])
        finally:
            guards.close()
            run_obs.close()
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
        out["transitions"] = ([] if guards.membership is None else
                              [[e, r, k, list(ws)] for e, r, k, ws in
                               guards.membership.transitions])
        out["journal"] = None
        if spec["journal"] and os.path.exists(jpath):
            recs, _ = journal_mod.scan(jpath)
            out["journal"] = [{k: v for k, v in rec.items() if k != "t_s"}
                              for rec in recs]
        out["profile"] = None
        summary = run_obs.profile_summary
        if summary is not None:
            out["profile"] = {
                "rounds": summary["rounds"],
                "execute_ms_p50": summary["worker_execute_ms"]["p50"]
                if summary.get("worker_execute_ms") else None,
                "last_straggler_worker": summary["last_straggler_worker"],
                "flops_per_round": summary["flops_per_round"],
                "written": (args.profile_out is not None
                            and os.path.exists(args.profile_out)),
            }
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


# what ``run_machinery_spec`` adds to a result
_MACHINERY_KEYS = ("masks", "epochs", "states", "tiers", "tier_bytes",
                   "transitions", "journal", "profile")


def save_result(path: str, res: dict) -> None:
    """A worker's ``run_averaging_spec`` result as one ``.npz``."""
    arrays = {f"param{i}": p for i, p in enumerate(res["params"])}
    arrays.update({f"rows{i}": p for i, p in enumerate(res["all_rows"])})
    arrays["losses"] = np.stack(res["losses"])
    meta = {k: res[k] for k in ("group_bytes", "round_s", "staging_ms",
                                "staging_bytes", "launches", "chunks", "rows")}
    meta.update({k: res[k] for k in _MACHINERY_KEYS if k in res})
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
import os
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
            spec, resolve_device(a.device), workdir=os.path.dirname(a.out)))
dev = mesh.initialize_distributed(a.address, a.nprocs, a.pid,
                                  backend=a.backend, device=a.device)
print(f"joined rank {a.pid} of {a.nprocs} on {dev} over "
      f"{mesh.joined_backend()}", flush=True)
for i, spec in enumerate(specs):
    m = mesh.make_mesh({"dp": spec["workers"]},
                       workers_per_process=spec["workers"] // a.nprocs)
    res = procs.run_averaging_spec(spec, dev, mesh=m,
                                   workdir=os.path.dirname(a.out))
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
run_obs = procs.ship_from_env(a.pid)
m = mesh.make_mesh({"dp": 4}, workers_per_process=2)
assert mesh.local_worker_slice(m) == slice(2 * a.pid, 2 * a.pid + 2)
res = procs.run_averaging_spec({"workers": 4}, dev, mesh=m)
assert res["losses"][0].shape == (4, 2), res["losses"][0].shape
assert np.isfinite(res["losses"][0]).all(), res["losses"]
for rows in res["all_rows"]:
    np.testing.assert_array_equal(rows[0], rows[1])
run_obs.close()  # the final flush ships the run's tail
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
run_obs = procs.ship_from_env(a.pid)
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
run_obs.close()
mesh.shutdown()
print(f"@MARKER@ p{a.pid} avg_ms={avg * 1e3:.3f} local_ms={local * 1e3:.3f} "
      f"collective_ms={coll_ms:.3f} tau={TAU}")
"""


def timed_averaging_worker(marker: str) -> str:
    return _TIMED_AVERAGING_WORKER.replace("@MARKER@", marker)


def ship_from_env(pid: int):
    """The fleet-plane wiring of the averaging workers: with
    ``$SPARKNET_SHIP_TO`` set, each process ships its metric deltas and
    round spans there as ``$SPARKNET_HOST_ID`` (default ``proc<pid>``);
    returns the ``ObsRun`` to close (an empty one otherwise)."""
    from sparknet_tpu_torch import obs

    if not os.environ.get("SPARKNET_SHIP_TO"):
        return obs.ObsRun()
    return obs.start(ship_to=os.environ["SPARKNET_SHIP_TO"],
                     host_id=os.environ.get("SPARKNET_HOST_ID", f"proc{pid}"),
                     echo=None)


# The fleet-shipping worker: a single process (no collectives, so no
# joined world) that steps the toy solver ``$SPARKNET_FLEET_ROUNDS``
# rounds, each an ``execute`` span with ``round=r``, shipping to
# ``$SPARKNET_SHIP_TO`` as ``$SPARKNET_HOST_ID``.  Seams:
# ``$SPARKNET_FLEET_ROUND_S`` (the round's sleep), ``..._STRAGGLE_FROM``
# and ``..._STRAGGLE_S`` (a straggler from that round on),
# ``..._LINGER_S`` (keep heartbeating after the loop, a finished but
# live host), and ``$SPARKNET_SHIP_CLOCK_SKEW_S`` (a skewed host clock
# the collector's alignment must recover).
_FLEET_SHIP_WORKER = r"""
import os
import sys
import time

import numpy as np

pid = int(sys.argv[1])

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.utils import procs

rounds = int(os.environ.get("SPARKNET_FLEET_ROUNDS", "5"))
round_s = float(os.environ.get("SPARKNET_FLEET_ROUND_S", "0.02"))
straggle_from = int(os.environ.get("SPARKNET_FLEET_STRAGGLE_FROM", "-1"))
straggle_s = float(os.environ.get("SPARKNET_FLEET_STRAGGLE_S", "0"))
linger_s = float(os.environ.get("SPARKNET_FLEET_LINGER_S", "0"))

run = obs.start(
    ship_to=os.environ["SPARKNET_SHIP_TO"],
    host_id=os.environ.get("SPARKNET_HOST_ID", f"host{pid}"),
    echo=None,
)
solver = procs.averaging_solver(procs._spec({"tau": 1}), "cpu")
state = solver.init_state(seed=pid)
rng = np.random.RandomState(pid)


def window():
    return {
        "x": rng.randn(1, 4, 6).astype(np.float32),
        "label": rng.randint(0, 3, (1, 4)).astype(np.float32),
    }


for r in range(rounds):
    with obs.span("execute", round=r):
        state, losses = solver.step(state, window())
    run.shipper.note_round(r)
    time.sleep(round_s + (straggle_s if 0 <= straggle_from <= r else 0.0))
print(f"@MARKER@ p{pid} rounds={rounds} loss={solver.smoothed_loss:.4f}")
sys.stdout.flush()
if linger_s:
    # the loop is done; keep heartbeating (a finished but live host)
    # until the harness kills the process or the linger runs out
    time.sleep(linger_s)
run.close()
"""


def fleet_ship_worker(marker: str) -> str:
    return _FLEET_SHIP_WORKER.replace("@MARKER@", marker)


# The observed launch: ``python observer.py OUT <launch argv>`` runs
# ``tools/launch.main`` on the argv as given.  Each process the launcher
# spawns runs this same script on the launcher's own child argv, so the
# launcher, the children's environment, the join and the app are the
# real ones; only the interpreter's entry differs.  Each ``cifar_app``
# run saves to ``OUT/rank<r>.npz``: its rows of the final params and
# stats, every round's losses (all W workers), and the live masks,
# smoothed loss, accuracy and K9/K10 launches (exact, as JSON).  The app runs under
# ``deterministic_algorithms`` so that two runs can be held bit for bit.
_OBSERVED_LAUNCH = r"""
import json
import os
import sys

import numpy as np

from sparknet_tpu_torch.apps import cifar_app, guards
from sparknet_tpu_torch.ops import cuda_comm
from sparknet_tpu_torch.tools import launch
from sparknet_tpu_torch.utils import procs
from sparknet_tpu_torch.utils.devices import deterministic_algorithms
from sparknet_tpu_torch.utils.tree import tree_leaves

out, argv = sys.argv[1], sys.argv[2:]
spawn, app_main = procs.Children.spawn, cifar_app.main
guarded_round = guards.RoundGuards.round
losses = []


def observed_spawn(self, pid, cmd, env):
    i = cmd.index("-m")  # [python, -m, sparknet_tpu_torch.tools.launch, ...]
    return spawn(self, pid, [*cmd[:i], os.path.abspath(__file__), out,
                             *cmd[i + 2:]], env)


def observed_round(self, *a, **k):
    res = guarded_round(self, *a, **k)
    losses.append(res[1].detach().cpu().numpy())
    return res


def observed_main(app_argv, result=None):
    from sparknet_tpu_torch.parallel import mesh

    r = {}
    with deterministic_algorithms():
        code = app_main(app_argv, result=r)
    state, rows = r["state"], r["trainer"].rows
    leaves = tree_leaves(state.params) + tree_leaves(state.stats)
    meta = {"rows": [rows.start, rows.stop], "code": code,
            "launches": dict(cuda_comm.LAUNCHES),
            "smoothed_loss": float(r["smoothed_loss"]),
            "accuracy": float(r["accuracy"]),
            "masks": [None if m is None else [float(v) for v in m]
                      for m in r["masks"]]}
    np.savez(os.path.join(out, f"rank{mesh.process_index()}.npz"),
             losses=np.stack(losses),
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **{f"leaf{i}": x.detach().cpu().numpy()
                for i, x in enumerate(leaves)})
    return code


procs.Children.spawn = observed_spawn
guards.RoundGuards.round = observed_round
cifar_app.main = observed_main
raise SystemExit(launch.main(argv))
"""


def observed_launch(launch_argv: Sequence[str], out_dir: str, repo_root: str,
                    env_extra: Optional[Dict[str, str]] = None,
                    timeout: float = 600.0, cwd: Optional[str] = None):
    """Run ``tools/launch`` on ``launch_argv`` (``cifar`` and its
    arguments, after ``--nprocs N`` and the launcher's other flags for a
    joined run; without them one process) with every ``cifar_app`` run
    observed.  Returns the finished process (stdout and stderr) and each
    rank's saved run in rank order: ``rows``, ``losses`` (rounds, W,
    tau), ``leaves`` (this rank's rows of every param and stat leaf),
    ``masks``, ``smoothed_loss``, ``accuracy``, ``code``, ``launches``
    (``ops.cuda_comm.LAUNCHES``)."""
    os.makedirs(out_dir, exist_ok=True)
    script = os.path.join(out_dir, "observer.py")
    with open(script, "w") as f:
        f.write(_OBSERVED_LAUNCH)
    done = subprocess.run(
        [sys.executable, script, out_dir, *launch_argv], capture_output=True,
        text=True, timeout=timeout, env=repo_env(repo_root, env_extra),
        cwd=cwd or out_dir)
    ranks = []
    for r in range(len(os.listdir(out_dir))):
        path = os.path.join(out_dir, f"rank{r}.npz")
        if not os.path.exists(path):
            break
        z = np.load(path)
        run = json.loads(bytes(z["meta"]).decode())
        run["losses"] = z["losses"]
        run["leaves"] = [z[f"leaf{i}"] for i in
                         range(sum(k.startswith("leaf") for k in z.files))]
        ranks.append(run)
    return done, ranks


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


class Children:
    """Spawned processes whose pipes are drained as they run (stdout and
    stderr together, each on its own thread, so a full pipe never stalls
    a rank inside a collective).  The list may grow while it is waited
    on (a relaunched slice); ``forgiven`` holds the children whose
    nonzero exit was the caller's doing (a deliberate preemption)."""

    def __init__(self):
        self.entries: List[dict] = []  # pid, proc, buf, thread
        self.forgiven: set = set()  # id() of each forgiven Popen
        self.killed: set = set()  # id() of each Popen this object killed
        self._lock = threading.Lock()

    def spawn(self, pid: int, cmd: Sequence[str], env: Dict[str, str]):
        p = subprocess.Popen(list(cmd), env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        buf: List[str] = []
        t = threading.Thread(target=lambda: buf.extend(p.stdout),
                             name=f"procs-drain-p{pid}", daemon=True)
        t.start()
        with self._lock:
            self.entries.append({"pid": pid, "proc": p, "buf": buf,
                                 "thread": t})
        return p

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.entries)

    def failed(self) -> List[dict]:
        """The children that exited nonzero and were not forgiven."""
        return [e for e in self.snapshot()
                if e["proc"].poll() not in (None, 0)
                and id(e["proc"]) not in self.forgiven]

    def running(self) -> List[dict]:
        return [e for e in self.snapshot() if e["proc"].poll() is None]

    def wait(self, deadline: float, busy=lambda: False) -> Tuple[List[int], bool]:
        """Wait until every child has exited and ``busy()`` is false (a
        lifecycle thread that may still spawn), a child fails (not
        forgiven: its peers would sit in a collective, so they are
        killed), or ``deadline`` passes (everything left is killed).
        Returns ``(killed pids, timed_out)``."""
        timed_out = True
        try:
            while time.time() < deadline:
                if self.failed():
                    timed_out = False
                    break  # a rank failed: do not wait out its peers
                if not self.running() and not busy():
                    timed_out = False
                    break
                time.sleep(0.05)
        finally:
            killed = self.kill_all()
            for e in self.snapshot():
                e["thread"].join(timeout=30)
        return killed, timed_out

    def kill_all(self) -> List[int]:
        killed = []
        for e in self.snapshot():
            if e["proc"].poll() is None:
                e["proc"].kill()
                self.killed.add(id(e["proc"]))
                killed.append(e["pid"])
        for e in self.snapshot():
            try:
                e["proc"].wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        return killed

    def output(self, e: dict) -> str:
        return "".join(e["buf"])


def reap_processes(cmds: Sequence[Sequence[str]],
                   envs: Sequence[Dict[str, str]], timeout: float
                   ) -> Tuple[Dict[int, Tuple[int, str]], List[int], bool]:
    """Start one process per ``cmds[i]`` (environment ``envs[i]``, stdout
    and stderr together) and wait for them.  Returns ``(results, killed,
    timed_out)``: each rank's ``(exit code, output)``, the ranks this
    call killed, and whether the deadline passed.

    Each process is reaped on its own thread (``Children``: its pipe
    drained as it runs); a rank that fails ends the wait at once and its
    peers, which would sit in a collective until their timeout, are
    killed."""
    kids = Children()
    for pid, (cmd, env) in enumerate(zip(cmds, envs)):
        kids.spawn(pid, cmd, env)
    killed, timed_out = kids.wait(time.time() + timeout)
    results = {e["pid"]: (e["proc"].returncode, kids.output(e))
               for e in kids.snapshot()}
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
