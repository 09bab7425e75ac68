"""Crash-consistent run journal: the write-ahead round ledger.

The port's own copy of ``sparknet_tpu/io/journal.py``; the frames are
byte for byte the JAX package's, so each package reads the other's
ledger.  ``RunJournal`` is an append-only, CRC-framed record file the
training loop writes around every round:

- ``begin_round(r, ...)`` appends an **intent** before any of round
  ``r``'s work (round index, view epoch, cursor, iter),
- ``commit_round(r, ...)`` appends a **commit** only after the round's
  effects are durable (the snapshot published for the boundary rides
  along as a ref).

On restart the last whole record decides: a commit for ``r`` resumes at
``r + 1`` (a committed round never re-executes); an intent for ``r``
rewinds to the last committed boundary and executes ``r`` again (an
uncommitted round is never skipped); a torn tail (a kill mid-append)
fails its CRC and is truncated on open.

Frame format (little-endian): ``b"SNJ1" | len:u32 | crc32:u32 |
payload``, the payload one JSON object.  Each append is one ``os.write``
on an ``O_APPEND`` descriptor; ``fsync`` is ``"always"`` (every record),
``"commit"`` (commit records only, the default) or ``"never"``.
``io/checkpoint.restore_newest_valid_journaled`` reconciles the ledger
with the snapshots on disk; ``runtime/recover.py`` is the journaled
driver the kill-anywhere sweep runs.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

MAGIC = b"SNJ1"
_HEADER = struct.Struct("<II")  # payload length, payload crc32
FSYNC_POLICIES = ("always", "commit", "never")

INTENT = "intent"
COMMIT = "commit"


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def encode_frame(rec: Dict) -> bytes:
    """One record's frame."""
    body = json.dumps(rec, default=str).encode("utf-8")
    return MAGIC + _HEADER.pack(len(body), _crc(body)) + body


def scan(path: str) -> Tuple[List[Dict], int]:
    """Read-only frame scan: ``(records, torn_bytes)``, ``torn_bytes``
    the size of the unparseable tail (0 for a clean ledger).  The scan
    stops at the first bad magic, length or CRC."""
    records: List[Dict] = []
    if not os.path.exists(path):
        return records, 0
    with open(path, "rb") as f:
        blob = f.read()
    off, n = 0, len(blob)
    while off < n:
        frame_start = off
        if blob[off:off + 4] != MAGIC or n - off < 4 + _HEADER.size:
            return records, n - frame_start
        length, crc = _HEADER.unpack_from(blob, off + 4)
        body_start = off + 4 + _HEADER.size
        body = blob[body_start:body_start + length]
        if len(body) < length or _crc(body) != crc:
            return records, n - frame_start
        try:
            rec = json.loads(body.decode("utf-8"))
        except ValueError:
            return records, n - frame_start
        records.append(rec)
        off = body_start + length
    return records, 0


class RunJournal:
    """Append-only CRC-framed round ledger (open-or-create).

    Opening an existing ledger scans it and truncates a torn tail, so
    this run's appends extend a valid frame sequence.  ``crash_hook`` is
    the chaos seam: when set, the next append writes half its frame,
    fsyncs and calls the hook (a SIGKILL in the kill sweep, a raise in
    in-process tests).  ``metrics`` (a ``TrainingMetrics``) counts
    records and truncations."""

    def __init__(self, path: str, fsync: str = "commit", metrics=None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync={fsync!r}: expected one of {FSYNC_POLICIES}")
        self.path = path
        self.fsync = fsync
        self.metrics = metrics
        self.crash_hook: Optional[Callable[[], None]] = None
        self.records, torn = scan(path)
        self.truncated_bytes = torn
        if torn:
            good = os.path.getsize(path) - torn
            with open(path, "r+b") as f:
                f.truncate(good)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        if metrics is not None and torn:
            metrics.journal_truncated.inc()

    # ------------------------------------------------------------------
    def append(self, kind: str, **fields) -> Dict:
        """Append one record (one ``os.write``; fsync per policy)."""
        rec = {"kind": kind, "t_s": time.time(), **fields}
        frame = encode_frame(rec)
        if self.crash_hook is not None:
            # half a frame lands durably, then the process "dies"
            hook, self.crash_hook = self.crash_hook, None
            os.write(self._fd, frame[:max(5, len(frame) // 2)])
            os.fsync(self._fd)
            hook()
            raise RuntimeError("journal crash_hook returned instead of dying")
        os.write(self._fd, frame)
        if self.fsync == "always" or (self.fsync == "commit" and kind == COMMIT):
            os.fsync(self._fd)
        self.records.append(rec)
        if self.metrics is not None:
            self.metrics.journal_records.labels(kind).inc()
        return rec

    def begin_round(self, round_index: int, **meta) -> Dict:
        """The round's write-ahead intent, before any of its work."""
        return self.append(INTENT, round=int(round_index), **meta)

    def commit_round(self, round_index: int, **meta) -> Dict:
        """The round's commit, only after its effects are durable (pass
        ``snapshot=<state-file basename>`` when the boundary published
        one, ``durable=False`` for a progress-only mark)."""
        return self.append(COMMIT, round=int(round_index), **meta)

    # ------------------------------------------------------------------
    @property
    def last_committed_round(self) -> Optional[int]:
        for rec in reversed(self.records):
            if rec.get("kind") == COMMIT:
                return int(rec["round"])
        return None

    @property
    def in_flight_round(self) -> Optional[int]:
        """The intent round with no matching commit (None = clean)."""
        for rec in reversed(self.records):
            kind = rec.get("kind")
            if kind == COMMIT:
                return None
            if kind == INTENT:
                return int(rec["round"])
        return None

    def last_commit(self) -> Optional[Dict]:
        for rec in reversed(self.records):
            if rec.get("kind") == COMMIT:
                return rec
        return None

    def reconcile(self) -> Dict:
        """The restart decision: ``resume_round`` (the first round to
        execute: last commit + 1, or 0), ``snapshot`` (the newest
        committed snapshot ref), ``commit_iter`` (the committed
        boundary's iter; snapshots beyond it are ignored),
        ``worker_rounds`` (bounded-staleness ledgers; None here) and the
        in-flight round."""
        last = self.last_committed_round
        snapshot = commit_iter = worker_rounds = None
        for rec in reversed(self.records):
            if rec.get("kind") != COMMIT:
                continue
            if commit_iter is None and "iter" in rec:
                commit_iter = int(rec["iter"])
            if worker_rounds is None and rec.get("worker_rounds"):
                worker_rounds = [int(v) for v in rec["worker_rounds"]]
            if rec.get("snapshot"):
                snapshot = str(rec["snapshot"])
                break
        return {
            "last_committed_round": last,
            "in_flight_round": self.in_flight_round,
            "resume_round": 0 if last is None else last + 1,
            "snapshot": snapshot,
            "commit_iter": commit_iter,
            "worker_rounds": worker_rounds,
            "records": len(self.records),
            "truncated_bytes": self.truncated_bytes,
        }

    def close(self) -> None:
        if self._fd is not None:
            fd, self._fd = self._fd, None
            try:
                if self.fsync != "never":
                    os.fsync(fd)
            except OSError:  # the descriptor is already gone
                pass
            os.close(fd)

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


# ----------------------------------------------------------------------
# CLI surface (cli train and the averaging apps)


def default_journal_path(prefix: str) -> str:
    """The ledger that rides a snapshot prefix."""
    return prefix + "_run.journal"


def add_cli_args(parser) -> None:
    """``--journal`` / ``--no_journal`` / ``--journal_path`` /
    ``--journal_fsync``, the JAX parser's flags."""
    g = parser.add_mutually_exclusive_group()
    g.add_argument(
        "--journal", dest="journal", action="store_true", default=None,
        help="journal round intent/commit records to a CRC-framed "
        "write-ahead ledger beside the snapshots (<prefix>_run.journal): "
        "a restart knows which round was in flight, never re-executes a "
        "committed round, never skips an uncommitted one.  Default: off "
        "for fresh runs; a resume that finds a ledger consumes it",
    )
    g.add_argument(
        "--no_journal", dest="journal", action="store_false",
        help="no run journal, even on resume",
    )
    parser.add_argument(
        "--journal_path", default=None,
        help="the ledger's path (default <prefix>_run.journal)",
    )
    parser.add_argument(
        "--journal_fsync", choices=FSYNC_POLICIES, default="commit",
        help="journal durability: fsync every record / commit records "
        "only (default) / never",
    )


def journal_from_args(args, default_path: str, resuming: bool = False,
                      metrics=None) -> Optional[RunJournal]:
    """The run journal the CLI args ask for, or None.  The auto rule
    (neither ``--journal`` nor ``--no_journal``): a resume that finds a
    ledger consumes it; a fresh run stays unjournaled."""
    want = getattr(args, "journal", None)
    path = getattr(args, "journal_path", None) or default_path
    if want is False:
        return None
    if want is None and not (resuming and os.path.exists(path)):
        return None
    return RunJournal(path, fsync=getattr(args, "journal_fsync", "commit"),
                      metrics=metrics)
