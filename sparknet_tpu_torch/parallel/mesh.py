"""The process mesh: OS processes joined over ``torch.distributed``.

The port of ``sparknet_tpu/parallel/mesh.py``.  The JAX package lays
mesh axes over ``jax.devices()``, and ``jax.distributed.initialize``
makes that list span hosts.  Here each process owns one device and
stacks its workers on it (``parallel/trainers.py``), so a mesh is laid
over *slots*: ``process_count()`` processes times the workers each
stacks, in row-major order, slot ``s`` living in process ``s //
workers_per_process``.  ``make_mesh`` keeps the JAX axis arithmetic (a
``-1`` size absorbs the remaining slots, with the same divisibility and
size errors) and gives each axis whose slots span processes a
``torch.distributed`` group.

``initialize_distributed`` joins the processes.  Each rank takes
``cuda:<local rank>``; two ranks share one card only when the caller
pins them to it (``device="cuda:0"``).  The backend rule, with no
fallback:

- ``nccl`` when every rank has a card of its own;
- ``gloo`` for CPU ranks;
- ranks that share a card raise unless ``backend="gloo"`` is passed:
  NCCL refuses two ranks on one device, and the choice of the slower
  transport is the caller's to make.

A gloo group has no CUDA ``all_gather`` and no CUDA send/recv, so the
collectives below move a CUDA payload through explicit host copies
when the group's backend is gloo (``STAGING`` counts their bytes and
milliseconds); under NCCL the payload stays on the card.  A failed join
raises (a store timeout), it never continues as one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import inspect
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# seconds a join, or a collective, waits for its peers before it raises
JOIN_TIMEOUT_S = 300.0

# what this process joined with: device, backend, shared card
_JOINED: Dict[str, object] = {}

# host staging of gloo collectives on CUDA payloads: bytes copied each
# way and the milliseconds the copies took (reset by the caller)
STAGING = {"bytes": 0, "ms": 0.0, "calls": 0}


def reset_staging() -> None:
    STAGING.update(bytes=0, ms=0.0, calls=0)


def process_count() -> int:
    """Processes in the joined runtime (1 before a join)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 before a join)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count() -> int:
    """Workers this process stacks on its device when an app is given no
    ``--workers``: ``$SPARKNET_LOCAL_WORKERS`` (the launcher's
    ``--devices_per_host``), else 1 — the JAX package's
    ``jax.local_device_count()`` per simulated host."""
    return max(1, int(os.environ.get("SPARKNET_LOCAL_WORKERS", "1")))


def refuse_multiprocess(app: str, also: Optional[str] = None) -> None:
    """Exit, naming ``app``, when this process has joined a world of more
    than one: the entry points whose JAX counterparts run in one
    process only."""
    p = process_count()
    if p > 1:
        raise SystemExit(
            f"{app}: a run across {p} processes is not yet ported to "
            "sparknet_tpu_torch (its JAX counterpart runs in one process"
            + (f"; {also} among it" if also else "") + ")"
        )


# the flags of an averaging app that stay single-process: (attribute,
# is it on, the flag as the message names it)
_SINGLE_PROCESS_FLAGS = (
    ("stale_bound", lambda v: bool(v), "--stale_bound"),
    ("elastic", lambda v: bool(v), "--elastic"),
    ("slices", lambda v: (v or 1) > 1, "--slices"),
    ("journal", lambda v: v is True, "--journal"),
    ("overlap_avg", lambda v: bool(v), "--overlap_avg"),
    ("profile", lambda v: bool(v), "--profile"),
    ("profile_out", lambda v: bool(v), "--profile_out"),
)


def app_device(requested, app: str) -> torch.device:
    """The device of a joined rank for an app's ``--device``: the one it
    joined with; a ``--device`` of another type exits."""
    dev = joined_device()
    want = torch.device(requested or "cuda")
    if dev is None or dev.type != want.type:
        raise SystemExit(f"{app}: --device {want} but this rank joined on "
                         f"{dev}")
    return dev


def app_mesh(args, app: str) -> Tuple[int, "ProcessMesh"]:
    """``(W, mesh)`` of an averaging app in a joined world: ``--workers``
    must be the global worker count (processes x the workers each
    stacks, ``local_device_count()``), and the flags that stay
    single-process exit naming themselves."""
    p = process_count()
    per = local_device_count()
    n = getattr(args, "workers", 0) or p * per
    if n != p * per:
        raise SystemExit(
            f"{app}: multi-process runs must use --workers == all workers "
            f"({p} processes x {per} each = {p * per}; the launcher's "
            "--devices_per_host sets the second)"
        )
    refuse_single_process_flags(args, app)
    return n, make_mesh({"dp": n}, workers_per_process=per)


def refuse_single_process_flags(args, app: str) -> None:
    """Exit naming the first of ``_SINGLE_PROCESS_FLAGS`` that ``args``
    turns on."""
    for attr, on, flag in _SINGLE_PROCESS_FLAGS:
        if on(getattr(args, attr, None)):
            raise SystemExit(f"{app}: {flag} across processes is not yet "
                             "ported to sparknet_tpu_torch")


def joined_device() -> Optional[torch.device]:
    """The device this rank joined with, None before a join."""
    return _JOINED.get("device")


def joined_backend() -> Optional[str]:
    return _JOINED.get("backend")


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError(
                "initialize_distributed: no coordinator_address and no "
                "MASTER_ADDR/MASTER_PORT in the environment"
            )
        return f"tcp://{addr}:{port}"
    if coordinator_address.startswith(("tcp://", "file://", "env://")):
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _rank_device(device: Union[str, torch.device], local_rank: int,
                 local_world: int) -> Tuple[torch.device, bool]:
    """``(device, shared)``: the device this rank takes and whether more
    ranks on this host than it has cards share one."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, False
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: expected cuda or cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device=cpu "
            "on the CLI) to run the ranks on the CPU"
        )
    if dev.index is None:
        if local_rank >= n:
            raise RuntimeError(
                f"rank {local_rank} of this host has no card of its own "
                f"({n} card(s) for {local_world} rank(s)); pin the ranks to "
                "one card with device='cuda:0' and backend='gloo' to share it"
            )
        return torch.device("cuda", local_rank), False
    if dev.index >= n:
        raise RuntimeError(f"device {dev}: this host has {n} card(s)")
    return dev, local_world > n


def choose_backend(device: torch.device, shared: bool,
                   backend: Optional[str]) -> str:
    """The backend rule (module docstring); raises where it refuses."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend={backend!r}: expected gloo or nccl")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' needs a CUDA device a rank")
        return "gloo"
    if shared:
        if backend != "gloo":
            raise RuntimeError(
                "ranks share one card: NCCL refuses two ranks on one device, "
                "so pass backend='gloo' (--backend gloo) to join them over "
                "gloo with host-staged payloads"
            )
        return "gloo"
    return backend or "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.device:
    """Join this process to the others and return its device.

    ``coordinator_address`` is ``host:port`` of process 0 (or a
    ``tcp://`` / ``file://`` URL; a file store lets tests join without a
    port); without it ``MASTER_ADDR``/``MASTER_PORT`` name it.
    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` /
    ``RANK``.  The local rank (``LOCAL_RANK``, else ``process_id``)
    picks the card; ``LOCAL_WORLD_SIZE`` (else ``num_processes``) says
    how many ranks this host runs.  Raises on a refused backend, a rank
    with no card, or peers that do not arrive within
    ``JOIN_TIMEOUT_S``."""
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: this process has joined "
                           "already")
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", "0"))
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside 0..{world - 1}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev, shared = _rank_device(device, local_rank, local_world)
    chosen = choose_backend(dev, shared, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if chosen == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        kwargs["device_id"] = dev  # binds the communicator to this card
    dist.init_process_group(
        chosen, init_method=_init_method(coordinator_address),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S), **kwargs,
    )
    _JOINED.update(device=dev, backend=chosen, shared=shared)
    return dev


def shutdown() -> None:
    """Leave the joined runtime (a no-op when not joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _JOINED.clear()


# ----------------------------------------------------------------------
# the mesh
@dataclasses.dataclass
class ProcessMesh:
    """Axes laid over ``process_count() x workers_per_process`` slots.

    ``shape`` maps each axis to its size; ``coords`` is the coordinate
    range this process holds on each axis (a slice); ``groups`` holds a
    ``torch.distributed`` group for each axis whose slots span
    processes, None for an axis inside one process."""

    shape: Dict[str, int]
    process_count: int
    process_index: int
    workers_per_process: int
    coords: Dict[str, slice]
    groups: Dict[str, Optional[object]]
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        return self.groups.get(axis)


def mesh_shape(axes: Optional[Dict[str, int]], n_slots: int) -> Dict[str, int]:
    """The JAX ``make_mesh`` arithmetic over ``n_slots`` slots: a ``-1``
    size absorbs what the fixed axes leave; raises as JAX does."""
    axes = dict(axes or {"dp": n_slots})
    sizes = list(axes.values())
    n_fixed = int(np.prod([s for s in sizes if s > 0])) or 1
    if any(s == -1 for s in sizes):
        if n_slots % n_fixed:
            raise ValueError(
                f"{n_slots} devices not divisible by fixed axes {axes}"
            )
        sizes = [s if s > 0 else n_slots // n_fixed for s in sizes]
    total = int(np.prod(sizes))
    if total > n_slots:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n_slots}")
    return dict(zip(axes.keys(), sizes))


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Union[None, int, Sequence] = None,
              workers_per_process: Optional[int] = None,
              device: Optional[torch.device] = None) -> ProcessMesh:
    """Build the mesh from an ``{axis: size}`` dict (``{"dp": -1,
    "mp": 2}``: ``-1`` absorbs the remaining slots).

    ``devices`` is the slot count (or a sequence whose length is), by
    default ``process_count() x workers_per_process``; the mesh uses
    the first ``prod(sizes)`` slots, as JAX uses the first devices, and
    every process must own the same number of them.
    ``workers_per_process`` defaults to ``local_device_count()``;
    ``device`` to the joined device (the CPU before a join).  Every
    process of the runtime must call this with the same arguments: each
    cross-process group is created collectively."""
    p, me = process_count(), process_index()
    wpp = int(workers_per_process or local_device_count())
    if devices is None:
        n_slots = p * wpp
    elif isinstance(devices, int):
        n_slots = devices
    else:
        n_slots = len(devices)
    shape = mesh_shape(axes, n_slots)
    total = int(np.prod(list(shape.values())))
    if total % p:
        raise ValueError(
            f"mesh {shape} has {total} slots, not divisible over {p} processes"
        )
    wpp = total // p
    owner = (np.arange(total) // wpp).reshape(list(shape.values()))
    coords, groups = {}, {}
    for ax_i, axis in enumerate(shape):
        lines = np.moveaxis(owner, ax_i, -1).reshape(-1, shape[axis])
        mine = np.nonzero((owner == me).any(
            axis=tuple(i for i in range(owner.ndim) if i != ax_i)))[0]
        coords[axis] = slice(int(mine[0]), int(mine[-1]) + 1)
        sets: List[Tuple[int, ...]] = []
        for line in lines:
            s = tuple(sorted(set(int(r) for r in line)))
            if s not in sets:
                sets.append(s)
        groups[axis] = _axis_group(sets, me, p)
    if device is None:
        device = joined_device() or torch.device("cpu")
    return ProcessMesh(shape, p, me, wpp, coords, groups, device)


def _axis_group(sets: List[Tuple[int, ...]], me: int, p: int):
    """The group of this process along an axis whose lines cover
    ``sets`` of processes; WORLD when one set holds every process (also
    at world size 1 once joined), None without a join or when the axis
    stays inside each process."""
    if not dist.is_initialized():
        return None
    if p == 1:
        return dist.group.WORLD
    crossing = [s for s in sets if len(s) > 1]
    if not crossing:
        return None
    if len(crossing) == 1 and len(crossing[0]) == p:
        return dist.group.WORLD
    mine = None
    for s in crossing:  # every rank creates every group, in one order
        g = dist.new_group(list(s))
        if me in s:
            mine = g
    return mine


def local_worker_slice(mesh: ProcessMesh, axis: str = "dp") -> slice:
    """This process's contiguous block of ``axis`` (the workers whose
    slots it owns): each process loads and feeds only these — the
    Spark-partitions-per-executor analog."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return mesh.coords[axis]


# ----------------------------------------------------------------------
# collectives over a group, host-staged under gloo
# torch 2.13 renamed all_gather_into_tensor; older builds have only that
_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def group_backend(group) -> str:
    return dist.get_backend(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and group_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    h = t.detach().to("cpu")
    STAGING["ms"] += (time.perf_counter() - t0) * 1e3
    STAGING["bytes"] += h.numel() * h.element_size()
    STAGING["calls"] += 1
    return h


def _to_device(h: torch.Tensor, dev: torch.device) -> torch.Tensor:
    t0 = time.perf_counter()
    out = h.to(dev)
    torch.cuda.synchronize(dev)
    STAGING["ms"] += (time.perf_counter() - t0) * 1e3
    STAGING["bytes"] += h.numel() * h.element_size()
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (R, ...) of equal shape, concatenated in rank
    order along axis 0: (group size x R, ...), on ``t``'s device."""
    n = dist.get_world_size(group)
    src = _to_host(t) if _staged(t, group) else t.contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _GATHER(out, src, group=group)
    return _to_device(out, t.device) if src.device != t.device else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` IN PLACE and returned (on ``t``'s
    device); a CUDA payload under gloo crosses through a host copy.
    ``all_reduce(SUM)`` leaves the same bits on every rank, under NCCL
    and gloo alike: each element is reduced once and handed round."""
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        t.copy_(_to_device(h, t.device))
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _object_device(group) -> torch.device:
    """The device an object collective stages through: the card under
    NCCL (it moves CUDA tensors only), the CPU under gloo."""
    if group_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj, group=None, src: int = 0):
    """Rank ``src``'s picklable ``obj`` (of ``group``, WORLD by
    default) on every rank: the decisions one rank makes for all, such
    as the snapshot a resume restores."""
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group or dist.group.WORLD, src),
        group=group, device=_object_device(group or dist.group.WORLD))
    return box[0]


def on_rank0(fn, group=None):
    """``fn()`` run on the group's rank 0 alone, its value (or the
    exception it raised) on every rank, so no rank waits in a
    collective for one that failed.  The value must be picklable and
    small (a path, a dict of host numbers)."""
    g = group or dist.group.WORLD
    out = None
    if dist.get_rank(g) == 0:
        try:
            out = (True, fn())
        except Exception as e:  # handed to every rank, raised there
            out = (False, e)
    ok, value = broadcast_object(out, g)
    if not ok:
        raise value
    return value


def broadcast_leaves(leaves: Sequence[torch.Tensor], group, src: int = 0
                     ) -> List[torch.Tensor]:
    """The group rank ``src``'s values of ``leaves`` (same shapes on every
    rank), each on its own leaf's device: the leaves of one dtype and
    device cross as one flat buffer, host-staged under gloo."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    groups: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
    for i, x in enumerate(leaves):
        groups.setdefault((x.dtype, x.device), []).append(i)
    root = dist.get_global_rank(group, src)
    for (_, dev), idx in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        if _staged(flat, group):
            h = _to_host(flat)
            dist.broadcast(h, src=root, group=group)
            flat = _to_device(h, dev)
        elif dev.type == "cpu" and group_backend(group) == "nccl":
            # NCCL moves CUDA tensors only (the iteration counter)
            d = flat.to(_object_device(group))
            dist.broadcast(d, src=root, group=group)
            flat = d.cpu()
        else:
            dist.broadcast(flat, src=root, group=group)
        off = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = flat[off:off + k].view_as(leaves[i])
            off += k
    return out


def agree_max(values: Sequence[int], group=None) -> List[int]:
    """The elementwise max over ``group``'s ranks of a few small ints
    (the signal flags every rank acts on together)."""
    g = group or dist.group.WORLD
    t = torch.tensor(list(values), dtype=torch.int64,
                     device=_object_device(g))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return [int(v) for v in t.tolist()]


def all_gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order (host values only:
    counts, partition sizes)."""
    n = dist.get_world_size(group)
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def gathered_nbytes(t: torch.Tensor, group) -> int:
    """Bytes that reach this rank from the others in ``all_gather_rows(t)``."""
    return (dist.get_world_size(group) - 1) * t.numel() * t.element_size()


def all_gather_leaves(leaves: Sequence[torch.Tensor], group
                      ) -> Tuple[List[torch.Tensor], int]:
    """Every rank's rows of each (R, ...) leaf as contiguous (group size
    x R, ...) stacks, and the bytes that reached this rank from the
    others: the leaves of one dtype cross the group as one flat buffer
    a rank."""
    if not leaves:
        return [], 0
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    nbytes = 0
    for idx in by_dtype.values():
        r = leaves[idx[0]].shape[0]
        flat = torch.cat([leaves[i].reshape(r, -1) for i in idx], dim=1)
        nbytes += gathered_nbytes(flat, group)
        full = all_gather_rows(flat, group)
        off = 0
        for i in idx:
            k = leaves[i][0].numel()
            out[i] = full[:, off:off + k].reshape(
                (-1,) + tuple(leaves[i].shape[1:])).contiguous()
            off += k
    return out, nbytes
