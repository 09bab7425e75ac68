"""The record runtime of the port: the SNDB1 record DB and its readers.

The port's own copy of ``sparknet_tpu/runtime/__init__.py``'s record DB
and data pipeline (reference: caffe's ``db::DB`` over LevelDB/LMDB,
``DataReader``'s reader thread and ``DataTransformer``; the shim's
``create_db``/``write_to_db``/``commit_db_txn``):

- ``RecordDB``: the SNDB1 file (8-byte magic, then ``[u32 key_len][key]
  [u32 val_len][val]`` records), with buffered puts that reach the file
  at ``commit`` (the reference's CreateDB commits every 1000), and
  indexed reads;
- ``write_datum_db``: uint8 images + labels as Datum-style records
  (a 1-byte label, or 2 little-endian bytes when a label exceeds 255);
- ``DataPipeline``: DB -> transformed batches (crop, mirror, mean,
  scale), in order, prefetched.

``DataPipeline`` reads with the native reader (``csrc/runtime.cpp``:
one reader thread and ``workers`` transform threads), built with the
host compiler at its first use (``runtime/_build.py``); a failed build
raises.  ``native=False`` reads in Python (one thread), giving the same
bytes and floats.  Both draw each record's crop and mirror from a
splitmix64 stream keyed on (seed, the record's sequence number), so the
output does not depend on the thread count, and ``start`` opens the
pipeline at any sequence number without transforming what it skips.
The JAX package's recovery, membership and chaos runtimes
(``runtime/recover.py``, ``membership.py``, ``chaos.py``) are not yet
ported.
"""

from __future__ import annotations

import ctypes
import mmap
import queue as _queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"SNDB1\x00\x00\x00"


# ---------------------------------------------------------------------------
# RecordDB
# ---------------------------------------------------------------------------


def _scan_offsets(buf, path: str) -> List[int]:
    """Offsets of every record, each bounded by the file's size (a
    truncated record raises, as the native reader's index does)."""
    if len(buf) < len(MAGIC) or buf[: len(MAGIC)] != MAGIC:
        raise IOError(f"bad magic in {path}")
    size, pos, offsets = len(buf), len(MAGIC), []
    while pos < size:
        if pos + 4 > size:
            raise IOError(f"truncated record in {path}")
        klen = int.from_bytes(buf[pos: pos + 4], "little")
        if pos + 8 + klen > size:
            raise IOError(f"truncated record in {path}")
        vlen = int.from_bytes(buf[pos + 4 + klen: pos + 8 + klen], "little")
        if pos + 8 + klen + vlen > size:
            raise IOError(f"truncated record in {path}")
        offsets.append(pos)
        pos += 8 + klen + vlen
    return offsets


class RecordDB:
    """The SNDB1 record store, ``mode`` ``"r"`` or ``"w"`` (truncates)."""

    MAGIC = MAGIC

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: expected 'r' or 'w'")
        self.path = path
        self.mode = mode
        self._pending: List[Tuple[bytes, bytes]] = []
        self._out = None
        self._file = None
        self._map = None
        self._offsets: List[int] = []
        if mode == "w":
            self._out = open(path, "wb")
            self._out.write(MAGIC)
            return
        self._file = open(path, "rb")
        data = self._file.read(len(MAGIC) + 1)
        if len(data) > len(MAGIC):
            self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._offsets = _scan_offsets(self._map, path)
        else:
            _scan_offsets(data, path)  # the magic alone: an empty DB

    def put(self, key: bytes, value: bytes) -> None:
        self._pending.append((bytes(key), bytes(value)))

    def commit(self) -> None:
        """Write the buffered puts (a transaction commit)."""
        for key, value in self._pending:
            self._out.write(len(key).to_bytes(4, "little"))
            self._out.write(key)
            self._out.write(len(value).to_bytes(4, "little"))
            self._out.write(value)
        self._pending.clear()
        self._out.flush()

    def __len__(self) -> int:
        return len(self._offsets)

    def read(self, idx: int) -> Tuple[bytes, bytes]:
        """``(key, value)`` of record ``idx``."""
        if not 0 <= idx < len(self._offsets):
            raise IndexError("record index out of range")
        m, pos = self._map, self._offsets[idx]
        klen = int.from_bytes(m[pos: pos + 4], "little")
        key = m[pos + 4: pos + 4 + klen]
        vlen = int.from_bytes(m[pos + 4 + klen: pos + 8 + klen], "little")
        return key, m[pos + 8 + klen: pos + 8 + klen + vlen]

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None
        for f in (self._file, self._out):
            if f is not None:
                f.close()
        self._file = self._out = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_datum_db(
    path: str,
    images: np.ndarray,
    labels: np.ndarray,
    commit_every: int = 1000,
) -> None:
    """Write (N, C, H, W) uint8 images + labels as Datum-style records
    (label + pixel bytes, keys ``%08d``), committing every
    ``commit_every`` puts like the reference's CreateDB.  The label is
    1 byte when every label fits (CIFAR-scale) or 2 little-endian bytes
    otherwise (1000-class ImageNet); readers infer the width from the
    record's length and the known image size."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    labels = np.asarray(labels)
    if len(labels) and not (
        0 <= int(labels.min()) and int(labels.max()) <= 0xFFFF
    ):
        raise ValueError(
            f"labels outside [0, 65535]: min {labels.min()}, "
            f"max {labels.max()}"
        )
    width = 1 if (len(labels) == 0 or int(labels.max()) <= 0xFF) else 2
    with RecordDB(path, "w") as db:
        for i in range(len(labels)):
            value = int(labels[i]).to_bytes(width, "little") + images[i].tobytes()
            db.put(b"%08d" % i, value)
            if (i + 1) % commit_every == 0:
                db.commit()
        db.commit()


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def _record_rng_stream(seed: int, seq: int):
    """The counter-based splitmix64 stream each record draws its crop and
    mirror from (``csrc/runtime.cpp`` ``splitmix64``), keyed on (seed,
    the record's sequence number)."""
    s = ((seed * 0x9E3779B97F4A7C15) ^ (seq * 0xBF58476D1CE4E5B9)) & _U64

    def next_u64():
        nonlocal s
        s = (s + 0x9E3779B97F4A7C15) & _U64
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        return z ^ (z >> 31)

    return next_u64


class DataPipeline:
    """DB -> transformed batches, in record order, ``prefetch`` batches
    ahead of the caller.

    Two output modes:

    - float (default): DataTransformer semantics on the host —
      ``next()`` returns ``(data f32 (B,C,oh,ow), labels f32 (B,))``;
      crops are random in ``train`` (and mirrored with ``mirror``),
      centred otherwise; ``mean`` is a full (C*H*W) image indexed by the
      crop window or one value a channel;
    - ``u8_output=True``: the crop geometry only — ``next()`` returns
      ``(data u8, labels, h_offs i32, w_offs i32, flips u8)`` for the
      device to finish (mean, scale, mirror).

    ``start`` is the sequence number of the first record (record
    ``start mod n``): the pipeline delivers what one opened at 0 delivers
    after ``start`` records.  ``native`` (default) reads with the native
    reader and ``workers`` transform threads (0 = cores - 1); False
    reads in Python on one thread.  ``close()`` stops every thread.
    """

    def __init__(
        self,
        db_path: str,
        batch_size: int,
        shape: Sequence[int],  # (C, H, W) of stored records
        crop: int = 0,
        mirror: bool = False,
        train: bool = True,
        scale: float = 1.0,
        mean: Optional[np.ndarray] = None,
        seed: int = 0,
        prefetch: int = 3,
        workers: int = 0,
        u8_output: bool = False,
        start: int = 0,
        native: bool = True,
    ):
        self.batch_size = int(batch_size)
        c, h, w = (int(x) for x in shape)
        self.c, self.h, self.w = c, h, w
        self.out_h = crop if crop else h
        self.out_w = crop if crop else w
        self.u8_output = bool(u8_output)
        self.native = bool(native)
        if seed < 0 or start < 0:
            raise ValueError(f"seed {seed} and start {start} must be >= 0")
        mean_arr = (
            np.ascontiguousarray(mean, dtype=np.float32).reshape(-1)
            if mean is not None else None
        )
        self._handle = None
        self._thread = None
        # a native next() in flight finishes before close() frees the
        # pipeline (a reader of another thread may be in it)
        self._native_lock = threading.Lock()
        if self.native:
            from sparknet_tpu_torch.runtime import _build

            self._lib = _build.load()
            mean_ptr = (
                mean_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                if mean_arr is not None else None
            )
            self._handle = self._lib.snpipe_create(
                db_path.encode(), self.batch_size, c, h, w, int(crop),
                int(mirror), int(train), float(scale), mean_ptr,
                0 if mean_arr is None else mean_arr.size, int(seed),
                int(prefetch), int(workers), int(self.u8_output), int(start),
            )
            if not self._handle:
                raise IOError(f"snpipe_create failed: {self._error()}")
        else:
            if crop and (crop > h or crop > w):
                raise IOError("crop exceeds input")
            self._py_start(db_path, int(crop), bool(mirror), bool(train),
                           float(scale), mean_arr, int(seed), int(prefetch),
                           int(start))

    def _error(self) -> str:
        return self._lib.sn_last_error().decode("utf-8", "replace")

    # -- the Python reader ----------------------------------------------
    def _py_start(self, db_path, crop, mirror, train, scale, mean, seed,
                  prefetch, start):
        db = RecordDB(db_path, "r")
        if len(db) == 0:
            db.close()
            raise IOError("empty db")
        record_bytes = 1 + self.c * self.h * self.w
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._failed: Optional[Exception] = None
        u8, c, h, w = self.u8_output, self.c, self.h, self.w
        oh, ow, bsz = self.out_h, self.out_w, self.batch_size
        full_mean = mean is not None and mean.size == c * h * w
        chan_mean = mean is not None and mean.size == c
        m_img = mean.reshape(c, h, w) if full_mean else None
        m_chan = mean.reshape(c, 1, 1) if chan_mean else None

        def batch_at(seq):
            data = np.empty((bsz, c, oh, ow), np.uint8 if u8 else np.float32)
            labels = np.empty(bsz, np.float32)
            h_offs = np.zeros(bsz, np.int32)
            w_offs = np.zeros(bsz, np.int32)
            flips = np.zeros(bsz, np.uint8)
            for i in range(bsz):
                _, value = db.read((seq + i) % len(db))
                if len(value) not in (record_bytes, record_bytes + 1):
                    raise IOError(
                        f"record size mismatch: got {len(value)}, "
                        f"want {record_bytes} or {record_bytes + 1}"
                    )
                lw = len(value) - (record_bytes - 1)  # label width, 1 or 2
                labels[i] = int.from_bytes(value[:lw], "little")
                img = np.frombuffer(value, np.uint8, offset=lw).reshape(c, h, w)
                draw = _record_rng_stream(seed, seq + i)
                ho = wo = 0
                if crop and train:
                    ho = draw() % (h - crop + 1)
                    wo = draw() % (w - crop + 1)
                elif crop:
                    ho, wo = (h - crop) // 2, (w - crop) // 2
                flip = bool(mirror and train and (draw() & 1))
                window = img[:, ho: ho + oh, wo: wo + ow]
                if u8:
                    data[i] = window
                    h_offs[i], w_offs[i], flips[i] = ho, wo, flip
                    continue
                out = window.astype(np.float32)
                if m_img is not None:
                    out = out - m_img[:, ho: ho + oh, wo: wo + ow]
                elif m_chan is not None:
                    out = out - m_chan
                if flip:
                    out = out[:, :, ::-1]
                data[i] = out * np.float32(scale)
            return (data, labels, h_offs, w_offs, flips) if u8 else (data, labels)

        def run():
            seq = start
            try:
                while not self._stop.is_set():
                    item = batch_at(seq)
                    seq += bsz
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
            except Exception as e:  # handed to the caller's next()
                self._q.put(e)
            finally:
                db.close()

        self._thread = threading.Thread(target=run, name="snpipe-reader",
                                        daemon=True)
        self._thread.start()

    def next(self):
        """float mode: ``(data f32, labels)``; u8 mode: ``(data u8,
        labels, h_offs, w_offs, flips)``."""
        if not self.native:
            if self._thread is None:
                raise IOError("pipeline closed")
            if self._failed is not None:
                raise self._failed
            item = self._q.get()
            if isinstance(item, Exception):
                self._failed = item  # the reader has stopped
                raise item
            return item
        b = self.batch_size
        data = np.empty((b, self.c, self.out_h, self.out_w),
                        np.uint8 if self.u8_output else np.float32)
        labels = np.empty(b, np.float32)
        geom = ((np.empty(b, np.int32), np.empty(b, np.int32),
                 np.empty(b, np.uint8)) if self.u8_output else ())
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        with self._native_lock:
            if self._handle is None:
                raise IOError("pipeline closed")
            rc = self._lib.snpipe_next(
                self._handle, ptr(data), ptr(labels),
                *([ptr(g) for g in geom] if geom else [None] * 3))
        if rc:
            raise IOError(self._error())
        return (data, labels) + geom

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.next()

    def close(self) -> None:
        """Stop and join every reader thread (idempotent; also after
        ``next()`` raised)."""
        with self._native_lock:
            if self._handle is not None:
                self._lib.snpipe_destroy(self._handle)
                self._handle = None
        th, self._thread = self._thread, None
        if th is not None:
            self._stop.set()
            while th.is_alive():
                try:  # unblock a reader parked on a full queue
                    self._q.get_nowait()
                except _queue.Empty:
                    th.join(timeout=0.05)
