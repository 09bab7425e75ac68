"""Checkpoint/resume for the full TrainState.

The port's own copy of ``sparknet_tpu/io/checkpoint.py`` (reference
semantics: ``solver.cpp:446-519``, ``sgd_solver.cpp:242-290``): a
snapshot is the model weights (.caffemodel) plus SolverState (iter,
history blobs); ``restore`` resumes training exactly.  Both reference
snapshot formats are supported, chosen by
``SolverParameter.snapshot_format`` (``solver.cpp:459-476``):

- BINARYPROTO (default): ``{prefix}_iter_{N}.caffemodel`` (binary-
  compatible with the reference wire format) +
  ``{prefix}_iter_{N}.solverstate.npz`` (int64 ``iter`` + the history
  leaves ``h0``, ``h1``, ... in ``jax.tree_util`` order,
  ``utils/tree.py``),
- HDF5: ``{prefix}_iter_{N}.caffemodel.h5`` +
  ``{prefix}_iter_{N}.solverstate.h5`` (``io/hdf5.py``; needs h5py).

The files are the JAX package's: a snapshot either package writes, the
other restores.  They hold host arrays only, so a snapshot written on
the card restores on the CPU and back.

Integrity and recovery: every snapshot also publishes
``{prefix}_iter_{N}.manifest.json`` — last, after every file it lists —
with the CRC32 and size of each file.  ``restore()`` verifies it and
raises ``SnapshotCorrupt`` on mismatch; ``restore_newest_valid()`` walks
snapshots newest-first, quarantines corrupt or truncated ones (renamed
with a ``.corrupt`` suffix) and falls back to the newest that verifies.
Only evidence of corruption is quarantined: a solver mismatch or an
I/O error leaves the files as they are.

Full job state: ``snapshot(..., extra_state=...)`` writes the training loop's
state the TrainState never carried (comm-plane residuals, per-worker
momentum, data cursors) as ``{prefix}_iter_{N}.jobstate.npz`` under the
same manifest; ``load_job_state`` reads it back.  The journal-guided
resume (``restore_newest_valid_journaled``) needs the run journal
(``io/journal.py``), which is not yet ported.

The port keeps no process-wide metrics object: the functions that
count (``snapshot``, ``restore``, ``restore_newest_valid``,
``AsyncCheckpointer``) take ``metrics`` (an ``obs.metrics.
TrainingMetrics``, None records nothing), and the ``snapshot``,
``restore`` and ``verify`` spans go through ``obs/trace.py``.
"""

from __future__ import annotations

import atexit
import glob as _glob
import json
import logging
import os
import threading
import zipfile
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from sparknet_tpu_torch.io import caffemodel
from sparknet_tpu_torch.obs.trace import instant, span
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_unflatten

_log = logging.getLogger(__name__)

_STATE_SUFFIXES = (".solverstate.npz", ".solverstate.h5")
_JOBSTATE_SUFFIX = ".jobstate.npz"


class SnapshotCorrupt(RuntimeError):
    """A snapshot failed CRC/size verification or could not be decoded."""


# test seam: called with the DESTINATION path after the temp file is
# fully written but before the atomic publish rename — the window a
# preemption mid-write lands in
_CRASH_HOOK = None


def set_crash_hook(hook) -> None:
    global _CRASH_HOOK
    _CRASH_HOOK = hook


def _atomic(write_fn, path: str) -> None:
    """Write through a temp file + rename so a kill mid-write never
    leaves a file ``restore()`` would accept."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write_fn(tmp)
        if _CRASH_HOOK is not None:
            _CRASH_HOOK(path)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def crc32_bytes(data: bytes) -> int:
    """The framework's one checksum convention (manifest ``crc32``
    fields, chunk-cache sidecars): masked ``zlib.crc32``."""
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_file(path: str) -> Tuple[int, int]:
    """Streaming (crc32, size) of a file: the manifest's masked
    ``zlib.crc32``."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc & 0xFFFFFFFF, size
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)


def manifest_path_for(path: str) -> str:
    """``.../p_iter_N.<anything>`` -> ``.../p_iter_N.manifest.json``."""
    base = path
    for suf in _STATE_SUFFIXES + (
        _JOBSTATE_SUFFIX, ".caffemodel.h5", ".caffemodel"
    ):
        if base.endswith(suf):
            base = base[: -len(suf)]
            break
    return base + ".manifest.json"


def _base_of(state_path: str) -> str:
    for suf in _STATE_SUFFIXES:
        if state_path.endswith(suf):
            return state_path[: -len(suf)]
    return os.path.splitext(state_path)[0]


def jobstate_path_for(state_path: str) -> str:
    """``.../p_iter_N.solverstate.*`` -> ``.../p_iter_N.jobstate.npz``."""
    return _base_of(state_path) + _JOBSTATE_SUFFIX


def _write_manifest(it: int, fmt: str, paths) -> str:
    """CRC/size manifest over every published snapshot file (model,
    state, and — when present — the jobstate companion)."""
    mpath = manifest_path_for(paths[1])
    entries = {}
    for p in paths:
        crc, size = crc32_file(p)
        entries[os.path.basename(p)] = {"crc32": crc, "size": size}

    def _dump(tmp):
        with open(tmp, "w") as f:
            json.dump({"iter": int(it), "format": fmt, "files": entries}, f)

    _atomic(_dump, mpath)
    return mpath


def read_manifest(mpath: str) -> dict:
    """Decode a snapshot manifest, raising ``SnapshotCorrupt`` on garbage.
    OSError propagates as-is: only a manifest that does not decode is
    evidence of corruption."""
    with open(mpath, "rb") as f:
        raw = f.read()
    return parse_manifest(raw, label=mpath)


def parse_manifest(raw, label: str = "<manifest>") -> dict:
    """Manifest bytes/text -> dict, raising ``SnapshotCorrupt`` on
    garbage (the delivery watcher feeds this bytes fetched through an
    object store / chunk cache rather than a local path)."""
    try:
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        manifest = json.loads(raw)
        if not isinstance(manifest["files"], dict):
            raise TypeError("'files' is not a mapping")
    except (ValueError, KeyError, TypeError) as e:
        raise SnapshotCorrupt(f"{label}: unreadable manifest: {e}") from e
    return manifest


def verify_file_entry(path: str, want: dict) -> None:
    """CRC32/size-check ONE on-disk file against its manifest entry."""
    if not os.path.exists(path):
        raise SnapshotCorrupt(f"{path}: listed in manifest but missing")
    crc, size = crc32_file(path)
    if size != int(want["size"]):
        raise SnapshotCorrupt(
            f"{path}: truncated ({size} bytes, manifest says "
            f"{want['size']})"
        )
    if crc != int(want["crc32"]):
        raise SnapshotCorrupt(
            f"{path}: CRC32 mismatch ({crc:#x} vs manifest "
            f"{int(want['crc32']):#x})"
        )


def verify_bytes_entry(name: str, data: bytes, manifest: dict) -> None:
    """CRC32/size-check fetched BYTES against the manifest's entry for
    ``name`` — the delivery watcher's verify, where the file arrived
    through an object store and never touched the local disk under its
    published name."""
    want = manifest["files"].get(os.path.basename(name))
    if want is None:
        raise SnapshotCorrupt(f"{name}: not listed in the manifest")
    if len(data) != int(want["size"]):
        raise SnapshotCorrupt(
            f"{name}: truncated ({len(data)} bytes, manifest says "
            f"{want['size']})"
        )
    crc = crc32_bytes(data)
    if crc != int(want["crc32"]):
        raise SnapshotCorrupt(
            f"{name}: CRC32 mismatch ({crc:#x} vs manifest "
            f"{int(want['crc32']):#x})"
        )


def verify_manifest(mpath: str) -> Optional[dict]:
    """Verify every file a manifest lists; the decoded manifest, or None
    when there is no manifest (pre-manifest snapshots pass).  Raises
    ``SnapshotCorrupt`` on truncation/mismatch/missing files."""
    if not os.path.exists(mpath):
        return None
    manifest = read_manifest(mpath)
    d = os.path.dirname(mpath)
    for name, want in manifest["files"].items():
        verify_file_entry(os.path.join(d, name), want)
    return manifest


def verify_snapshot(state_path: str) -> None:
    """CRC32/size-check every file the snapshot's manifest lists; a
    snapshot with NO manifest passes (decode errors are still caught by
    ``restore_newest_valid``)."""
    verify_manifest(manifest_path_for(state_path))


# ----------------------------------------------------------------------
# full job state: a NESTED dict whose leaves are arrays (npz entries
# keyed "a:" + their "/"-joined path) or JSON-able scalars/lists (one
# __json__ entry)


def _flatten_job_state(d: dict, prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten_job_state(v, key + "/")
        else:
            yield key, v


def _unflatten_job_state(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _dump_job_state(path: str, extra_state: dict) -> None:
    arrays = {}
    scalars = {}
    for key, v in _flatten_job_state(extra_state):
        if isinstance(v, torch.Tensor):
            arrays[f"a:{key}"] = v.detach().cpu().numpy()
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            arrays[f"a:{key}"] = np.asarray(v)
        else:
            scalars[key] = v

    def _savez(p):
        with open(p, "wb") as f:
            np.savez(
                f,
                __json__=np.frombuffer(
                    json.dumps(scalars).encode("utf-8"), np.uint8
                ),
                **arrays,
            )

    _atomic(_savez, path)


def load_job_state(state_path: str):
    """The jobstate companion of a snapshot (pass the solverstate
    path), or None when the snapshot has none.  Read-only; the manifest
    check happens in ``restore()``/``verify_snapshot``."""
    jpath = jobstate_path_for(state_path)
    if not os.path.exists(jpath):
        return None
    flat: dict = {}
    with np.load(jpath) as z:
        for name in z.files:
            if name == "__json__":
                flat.update(json.loads(bytes(z[name].tobytes()).decode("utf-8")))
            elif name.startswith("a:"):
                flat[name[2:]] = z[name]
    return _unflatten_job_state(flat)


def _write_snapshot(fmt: str, prefix: str, it: int, blobs, leaves,
                    net_name: str, extra_state=None, metrics=None
                    ) -> Tuple[str, str]:
    """Host-side file writes of one snapshot (shared by the sync path
    and the AsyncCheckpointer worker); all files publish atomically."""
    with span("snapshot", iter=int(it), fmt=fmt):
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        if fmt == "HDF5":
            from sparknet_tpu_torch.io import hdf5

            model_path = f"{prefix}_iter_{it}.caffemodel.h5"
            state_path = f"{prefix}_iter_{it}.solverstate.h5"
            _atomic(lambda p: hdf5.save_weights_hdf5(blobs, p), model_path)
            _atomic(lambda p: hdf5.save_state_hdf5(p, it, leaves), state_path)
        else:
            model_path = f"{prefix}_iter_{it}.caffemodel"
            state_path = f"{prefix}_iter_{it}.solverstate.npz"
            _atomic(
                lambda p: caffemodel.save_weights(blobs, p, net_name=net_name),
                model_path,
            )

            def _savez(p):
                with open(p, "wb") as f:
                    np.savez(f, iter=np.asarray(it, np.int64),
                             **{f"h{i}": l for i, l in enumerate(leaves)})

            _atomic(_savez, state_path)
        paths = (model_path, state_path)
        if extra_state:
            jpath = jobstate_path_for(state_path)
            _dump_job_state(jpath, extra_state)
            paths = paths + (jpath,)
        # the manifest publishes LAST: a kill before it leaves a
        # manifest-less snapshot, never a manifest that vouches for
        # half-written data
        _write_manifest(it, fmt, paths)
    if metrics is not None:
        metrics.snapshots.inc()
    return model_path, state_path


def _host_snapshot_args(solver, state, fmt: Optional[str]):
    """(fmt, iter, blobs, history leaves), every array copied to the
    host on the caller's thread."""
    fmt = (fmt or solver.param.snapshot_format or "BINARYPROTO").upper()
    it = int(state.iter)
    blobs = caffemodel.net_blobs(solver.net, state.params, state.stats)
    leaves = [l.detach().cpu().numpy() for l in tree_leaves(state.history)]
    return fmt, it, blobs, leaves


def snapshot(solver, state, prefix: str, fmt: Optional[str] = None,
             extra_state=None, metrics=None) -> Tuple[str, str]:
    """Write model + solver state of a single-replica ``state``; returns
    (model_path, state_path).  ``fmt`` overrides
    ``solver.param.snapshot_format``.  ``extra_state`` (a nested dict of
    arrays / JSON-ables) publishes as the ``.jobstate.npz`` companion
    under the same CRC manifest."""
    fmt, it, blobs, leaves = _host_snapshot_args(solver, state, fmt)
    return _write_snapshot(fmt, prefix, it, blobs, leaves,
                           solver.net.name or "net", extra_state, metrics)


class AsyncCheckpointer:
    """Background snapshots: ``save()`` copies the state to the host on
    the caller's thread (the only part that must see the live tensors;
    training continues at once, since updates never modify a state in
    place), then serializes and writes on a worker thread.  Files
    publish atomically, one snapshot is in flight at a time (a new
    ``save`` waits for the previous write), and worker errors re-raise
    on the next ``save()``/``wait()``.

    A bounded drain of the in-flight write is registered at exit; a
    write still wedged past ``drain_timeout_s`` is abandoned, the
    previous snapshot staying the newest valid restore point.  (The JAX
    package also drains on a SIGTERM hook, which only its unported
    membership and chaos runtimes install.)"""

    def __init__(self, drain_timeout_s: float = 30.0, metrics=None) -> None:
        self._thread = None
        self._exc: Optional[BaseException] = None
        self._last_paths: Optional[Tuple[str, str]] = None
        self.drain_timeout_s = float(drain_timeout_s)
        self.metrics = metrics
        atexit.register(self._drain)

    def save(self, solver, state, prefix: str, fmt: Optional[str] = None,
             extra_state=None) -> None:
        self.wait()
        fmt, it, blobs, leaves = _host_snapshot_args(solver, state, fmt)
        net_name = solver.net.name or "net"

        def work():
            try:
                self._last_paths = _write_snapshot(
                    fmt, prefix, it, blobs, leaves, net_name, extra_state,
                    self.metrics,
                )
            except BaseException as e:  # noqa: BLE001 — re-raised on wait
                self._exc = e

        self._thread = threading.Thread(
            target=work, name="sparknet-async-ckpt", daemon=True
        )
        self._thread.start()

    def wait(self) -> Optional[Tuple[str, str]]:
        """Block until the in-flight snapshot (if any) is published;
        returns its (model_path, state_path)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        return self._last_paths

    @property
    def last_paths(self) -> Optional[Tuple[str, str]]:
        """Paths of the newest PUBLISHED snapshot (None until the first
        write completes)."""
        return self._last_paths

    def _drain(self) -> None:
        """Bounded flush of the in-flight write; never raises (errors
        surface on the next explicit ``wait()``)."""
        t = self._thread
        if t is None:
            return
        try:
            t.join(timeout=self.drain_timeout_s)
            if not t.is_alive():
                self._thread = None
        except Exception:  # noqa: BLE001 — teardown context
            pass

    def close(self) -> None:
        """Flush and detach the exit hook (idempotent)."""
        self._drain()
        atexit.unregister(self._drain)


def _load_model_blobs(model_path: str):
    if model_path.endswith(".h5"):
        from sparknet_tpu_torch.io import hdf5

        return hdf5.load_weights_hdf5(model_path)
    return caffemodel.load_weights(model_path)


def restore(solver, prefix_or_state_path: str, seed: int = 0,
            verify: bool = True, metrics=None):
    """Rebuild a single-replica TrainState on the solver's device from a
    snapshot (``Solver::Restore``).  Accepts a ``.solverstate.npz`` or
    ``.solverstate.h5`` path.  When the snapshot carries a manifest, its
    CRC32s are checked first (``verify=False`` opts out)."""
    with span("restore", path=os.path.basename(prefix_or_state_path)):
        state = _restore_impl(solver, prefix_or_state_path, seed, verify)
    if metrics is not None:
        metrics.restores.inc()
    return state


def _restore_impl(solver, state_path: str, seed: int, verify: bool):
    from sparknet_tpu_torch.solver import TrainState

    if verify:
        with span("verify", path=os.path.basename(state_path)):
            verify_snapshot(state_path)
    fresh = solver.init_state(seed)
    cur = tree_leaves(fresh.history)
    if state_path.endswith(".solverstate.h5"):
        from sparknet_tpu_torch.io import hdf5

        model_path = state_path[: -len(".solverstate.h5")] + ".caffemodel.h5"
        it, _step, new_leaves = hdf5.load_state_hdf5(state_path)
        if len(new_leaves) != len(cur):
            raise ValueError(
                f"{state_path}: {len(new_leaves)} history blobs, solver "
                f"has {len(cur)}"
            )
    elif state_path.endswith(".solverstate.npz"):
        model_path = state_path[: -len(".solverstate.npz")] + ".caffemodel"
        with np.load(state_path) as z:
            it = int(z["iter"])
            new_leaves = [z[f"h{i}"] for i in range(len(cur))]
    else:
        raise ValueError("pass a .solverstate.npz or .solverstate.h5 path")
    for got, want in zip(new_leaves, cur):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"{state_path}: history blob shape {tuple(got.shape)}, "
                f"solver has {tuple(want.shape)}"
            )
    loaded = _load_model_blobs(model_path)
    params, stats = caffemodel.apply_blobs(
        solver.net, fresh.params, fresh.stats, loaded
    )
    history = tree_unflatten(fresh.history, [
        torch.from_numpy(np.array(l, np.float32)).to(w.device)
        for l, w in zip(new_leaves, cur)
    ])
    return TrainState(params, stats, history,
                      torch.tensor(it, dtype=torch.int64))


def find_snapshots(prefix: str) -> List[str]:
    """All non-quarantined solverstate paths for ``prefix``, sorted by
    iteration ascending (the resume scan)."""
    out = [
        p for p in _glob.glob(prefix + "_iter_*.solverstate*")
        if p.endswith(_STATE_SUFFIXES)
    ]
    return sorted(out, key=_snapshot_iter)


def _snapshot_iter(state_path: str) -> int:
    return int(state_path.split("_iter_")[-1].split(".")[0])


def _quarantine(state_path: str, metrics=None) -> List[str]:
    """Rename every file of a corrupt snapshot (model, state, jobstate,
    manifest) with a ``.corrupt`` suffix so resume scans skip it but
    forensics can still read it."""
    base = _base_of(state_path)
    moved = []
    for p in (state_path, base + ".caffemodel", base + ".caffemodel.h5",
              base + _JOBSTATE_SUFFIX, manifest_path_for(state_path)):
        if os.path.exists(p):
            os.replace(p, p + ".corrupt")
            moved.append(p + ".corrupt")
    if metrics is not None:
        metrics.quarantined.inc()
    instant("quarantine", cat="fault", snapshot=os.path.basename(state_path))
    return moved


def restore_newest_valid(solver, prefix: str, seed: int = 0,
                         quarantine: bool = True, metrics=None):
    """Resume from the newest snapshot that VERIFIES — the fault-
    tolerant ``--resume`` path.  Walks ``find_snapshots(prefix)`` newest
    first; a snapshot that fails its manifest check or cannot be decoded
    is quarantined and the scan falls back to the next-older one.
    Returns ``(state, state_path)``; raises ``FileNotFoundError`` when no
    snapshots exist at all and ``SnapshotCorrupt`` when every candidate
    is bad."""
    candidates = find_snapshots(prefix)
    if not candidates:
        raise FileNotFoundError(f"no {prefix}_iter_*.solverstate* snapshots")
    failures = []
    for state_path in reversed(candidates):
        try:
            return restore(solver, state_path, seed=seed,
                           metrics=metrics), state_path
        except ImportError:
            raise  # missing h5py: an environment problem, not corruption
        except Exception as e:  # noqa: BLE001 — classified below
            failures.append(f"{state_path}: {e}")
            # only evidence of file corruption quarantines: a failed
            # manifest check, or (manifest-less snapshots) a truncated
            # or garbage container.  A solver mismatch or transient I/O
            # leaves the snapshot intact.
            is_corrupt = isinstance(
                e, (SnapshotCorrupt, zipfile.BadZipFile, EOFError)
            )
            _log.warning(
                "restore_newest_valid: skipping %s (%s)%s", state_path, e,
                "; quarantining" if (quarantine and is_corrupt)
                else "; left intact",
            )
            if quarantine and is_corrupt:
                _quarantine(state_path, metrics)
    raise SnapshotCorrupt(
        "restore_newest_valid: no valid snapshot under prefix %r; all %d "
        "candidates failed:\n%s"
        % (prefix, len(candidates), "\n".join(failures))
    )


def restore_newest_valid_journaled(solver, prefix: str, journal, seed: int = 0,
                                   quarantine: bool = True):
    """The journal-guided resume of the JAX package: it needs the run
    journal (``io/journal.py``), which is not yet ported."""
    raise NotImplementedError(
        "restore_newest_valid_journaled needs the run journal (io/journal.py), "
        "which is not yet ported to sparknet_tpu_torch; use "
        "restore_newest_valid"
    )


def load_weights_into_state(solver, state, model_path: str):
    """Warm start from a .caffemodel or .caffemodel.h5 only (the
    ``--weights=`` path, Net.scala:238-240): history and iter keep their
    current values."""
    params, stats = caffemodel.apply_blobs(
        solver.net, state.params, state.stats, _load_model_blobs(model_path)
    )
    return state._replace(params=params, stats=stats)
