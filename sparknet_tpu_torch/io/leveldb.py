"""Pure-Python LevelDB reader (+ minimal writer) for Caffe datasets.

The port's own copy of ``sparknet_tpu/io/leveldb.py``: it reads and
writes the same files, and ``leveldb_to_record_db`` writes the same
record DB.

Import-parity role: Caffe's *default* DB backend is LevelDB
(``DataParameter.backend`` enum value 0; reference
``caffe/src/caffe/util/db_leveldb.cpp``, ``convert_imageset.cpp``), so
reference-created LevelDB datasets must load exactly like LMDB ones
(``io/lmdb.py``).  This module reads a LevelDB directory directly — no
libleveldb/snappy dependency — and exposes the same import surface:
``is_leveldb`` / ``read_datum_leveldb`` / ``leveldb_to_record_db``.

On-disk formats implemented (public, from leveldb's ``doc/impl.md``,
``db/log_format.h``, ``table/format.cc``):

- ``CURRENT`` names the live ``MANIFEST-NNNNNN``; the manifest is a log
  of ``VersionEdit`` records (tagged varint fields: comparator 1,
  log_number 2, next_file 3, last_sequence 4, compact_pointer 5,
  deleted_file 6, new_file 7, prev_log_number 9) whose accumulation
  yields the live table files per level plus the live write-ahead log;
- log files: 32 KiB blocks of fragments ``crc32c u32 | length u16 |
  type u8`` (FULL/FIRST/MIDDLE/LAST), records are WriteBatch reps
  ``seq u64 | count u32 | (kTypeValue key value | kTypeDeletion key)*``;
- table files (``.ldb``/``.sst``): 48-byte footer (metaindex + index
  BlockHandles, magic 0xdb4775248b80fb57); each block is
  ``content | type u8 | crc32c u32`` with type 1 = snappy (decoder
  included, pure Python); block content is shared-prefix key-delta
  entries with a u32 restart-array trailer; table keys are *internal*
  keys ``user_key | (seq<<8 | type) u64le``.

Reads merge all live tables and the replayed log newest-sequence-first
and hide deletions — the same visibility LevelDB's own iterator gives a
Caffe ``LevelDB::Cursor``.  The writer emits one level-0 table (plus an
optional tail of log entries) so tests can build fixture databases and
users can export to the interchange format; compaction, filters and
multi-level trees are read-side only.
"""

from __future__ import annotations

import heapq
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sparknet_tpu_torch.io import wire
from sparknet_tpu_torch.io.lmdb import decode_datum, encode_datum

BLOCK_SIZE = 32768  # log file block size
TABLE_MAGIC = 0xDB4775248B80FB57
FULL, FIRST, MIDDLE, LAST = 1, 2, 3, 4
TYPE_DELETION, TYPE_VALUE = 0, 1
MASK_DELTA = 0xA282EAD8


class LevelDBError(IOError):
    pass


# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven, with leveldb's rotation mask
# ---------------------------------------------------------------------------

def _make_crc_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc_mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) & 0xFFFFFFFF


def crc_unmask(masked: int) -> int:
    rot = (masked - MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# snappy block decompression (format_description.txt) + a literal-only
# compressor (any snappy stream may consist solely of literals — used by
# tests to exercise the decode path without libsnappy)
# ---------------------------------------------------------------------------

def snappy_decompress(buf: bytes) -> bytes:
    view = memoryview(buf)
    n, pos = wire.decode_varint(view, 0)
    out = bytearray()
    end = len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(buf[pos:pos + extra], "little") + 1
                pos += extra
            out += view[pos:pos + length]
            pos += length
        else:
            if kind == 1:  # copy, 1-byte offset, 3-bit length
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos:pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise LevelDBError("snappy: bad copy offset")
            # overlapping copies are legal and must copy byte-at-a-time
            start = len(out) - offset
            for i in range(length):
                out.append(out[start + i])
    if len(out) != n:
        raise LevelDBError(
            f"snappy: expected {n} decompressed bytes, got {len(out)}"
        )
    return bytes(out)


def snappy_compress_literal(buf: bytes) -> bytes:
    """Valid (uncompressing) snappy stream: preamble + literal runs."""
    out = bytearray(wire.encode_varint(len(buf)))
    pos = 0
    while pos < len(buf):
        run = min(len(buf) - pos, 65536)
        if run <= 60:
            out.append(((run - 1) << 2) | 0)
        else:
            nbytes = (max(run - 1, 1).bit_length() + 7) // 8
            out.append(((59 + nbytes) << 2) | 0)
            out += (run - 1).to_bytes(nbytes, "little")
        out += buf[pos:pos + run]
        pos += run
    return bytes(out)


# ---------------------------------------------------------------------------
# log files (write-ahead log and MANIFEST share the format)
# ---------------------------------------------------------------------------

def read_log_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Join FULL/FIRST..LAST fragments into logical records."""
    with open(path, "rb") as f:
        data = f.read()
    pos, pending = 0, bytearray()
    in_fragment = False
    while pos + 7 <= len(data):
        block_left = BLOCK_SIZE - (pos % BLOCK_SIZE)
        if block_left < 7:
            pos += block_left  # zeroed trailer
            continue
        masked, length, ftype = struct.unpack_from("<IHB", data, pos)
        if masked == 0 and length == 0 and ftype == 0:
            break  # preallocated zero tail
        frag = data[pos + 7:pos + 7 + length]
        if len(frag) < length:
            raise LevelDBError(f"{path}: truncated log fragment")
        if verify_crc:
            want = crc_unmask(masked)
            got = crc32c(bytes([ftype]) + frag)
            if want != got:
                raise LevelDBError(f"{path}: log fragment crc mismatch")
        pos += 7 + length
        if ftype == FULL:
            if in_fragment:
                raise LevelDBError(f"{path}: FULL inside fragment chain")
            yield frag
        elif ftype == FIRST:
            pending = bytearray(frag)
            in_fragment = True
        elif ftype == MIDDLE:
            if not in_fragment:
                raise LevelDBError(f"{path}: MIDDLE without FIRST")
            pending += frag
        elif ftype == LAST:
            if not in_fragment:
                raise LevelDBError(f"{path}: LAST without FIRST")
            pending += frag
            yield bytes(pending)
            in_fragment = False
        else:
            raise LevelDBError(f"{path}: unknown fragment type {ftype}")


class LogWriter:
    """Fragmenting log writer (shared by the WAL and MANIFEST)."""

    def __init__(self, f):
        self.f = f
        self.offset = 0

    def add_record(self, rec: bytes) -> None:
        pos, first = 0, True
        while True:
            left = BLOCK_SIZE - (self.offset % BLOCK_SIZE)
            if left < 7:
                self.f.write(b"\x00" * left)
                self.offset += left
                left = BLOCK_SIZE
            avail = left - 7
            n = min(avail, len(rec) - pos)
            end = pos + n >= len(rec)
            ftype = (
                FULL if first and end
                else FIRST if first
                else LAST if end
                else MIDDLE
            )
            frag = rec[pos:pos + n]
            crc = crc_mask(crc32c(bytes([ftype]) + frag))
            self.f.write(struct.pack("<IHB", crc, n, ftype) + frag)
            self.offset += 7 + n
            pos += n
            first = False
            if end:
                break


def batch_records(
    items: List[Tuple[bytes, Optional[bytes]]], base_seq: int
) -> bytes:
    """WriteBatch rep: value=None entries are deletion markers."""
    out = bytearray(struct.pack("<QI", base_seq, len(items)))
    for key, value in items:
        if value is None:
            out += bytes([TYPE_DELETION])
            out += wire.encode_varint(len(key)) + key
        else:
            out += bytes([TYPE_VALUE])
            out += wire.encode_varint(len(key)) + key
            out += wire.encode_varint(len(value)) + value
    return bytes(out)


def iter_batch(rec: bytes) -> Iterator[Tuple[bytes, int, int, bytes]]:
    """(user_key, seq, type, value) entries of one WriteBatch rep."""
    seq, count = struct.unpack_from("<QI", rec, 0)
    view, pos = memoryview(rec), 12
    for i in range(count):
        vtype = rec[pos]
        pos += 1
        klen, pos = wire.decode_varint(view, pos)
        key = rec[pos:pos + klen]
        pos += klen
        value = b""
        if vtype == TYPE_VALUE:
            vlen, pos = wire.decode_varint(view, pos)
            value = rec[pos:pos + vlen]
            pos += vlen
        elif vtype != TYPE_DELETION:
            raise LevelDBError(f"bad WriteBatch entry type {vtype}")
        yield key, seq + i, vtype, value


# ---------------------------------------------------------------------------
# MANIFEST / VersionEdit
# ---------------------------------------------------------------------------

K_COMPARATOR = 1
K_LOG_NUMBER = 2
K_NEXT_FILE = 3
K_LAST_SEQ = 4
K_COMPACT_POINTER = 5
K_DELETED_FILE = 6
K_NEW_FILE = 7
K_PREV_LOG = 9


def _get_length_prefixed(view, rec, pos):
    n, pos = wire.decode_varint(view, pos)
    return rec[pos:pos + n], pos + n


def read_manifest(path: str) -> dict:
    """Accumulate VersionEdits into the live state: table files
    {(level, number): (size, smallest, largest)}, log_number, last_seq."""
    state = {
        "comparator": None,
        "log_number": 0,
        "prev_log_number": 0,
        "last_sequence": 0,
        "files": {},
    }
    for rec in read_log_records(path):
        view, pos = memoryview(rec), 0
        while pos < len(rec):
            tag, pos = wire.decode_varint(view, pos)
            if tag == K_COMPARATOR:
                name, pos = _get_length_prefixed(view, rec, pos)
                state["comparator"] = name.decode("ascii", "replace")
            elif tag == K_LOG_NUMBER:
                state["log_number"], pos = wire.decode_varint(view, pos)
            elif tag == K_PREV_LOG:
                state["prev_log_number"], pos = wire.decode_varint(view, pos)
            elif tag == K_NEXT_FILE:
                _, pos = wire.decode_varint(view, pos)
            elif tag == K_LAST_SEQ:
                state["last_sequence"], pos = wire.decode_varint(view, pos)
            elif tag == K_COMPACT_POINTER:
                _, pos = wire.decode_varint(view, pos)  # level
                _, pos = _get_length_prefixed(view, rec, pos)
            elif tag == K_DELETED_FILE:
                level, pos = wire.decode_varint(view, pos)
                number, pos = wire.decode_varint(view, pos)
                state["files"].pop((level, number), None)
            elif tag == K_NEW_FILE:
                level, pos = wire.decode_varint(view, pos)
                number, pos = wire.decode_varint(view, pos)
                size, pos = wire.decode_varint(view, pos)
                smallest, pos = _get_length_prefixed(view, rec, pos)
                largest, pos = _get_length_prefixed(view, rec, pos)
                state["files"][(level, number)] = (size, smallest, largest)
            else:
                raise LevelDBError(f"{path}: unknown VersionEdit tag {tag}")
    return state


def version_edit(
    comparator: Optional[str] = None,
    log_number: Optional[int] = None,
    next_file: Optional[int] = None,
    last_sequence: Optional[int] = None,
    new_files: Optional[List[Tuple[int, int, int, bytes, bytes]]] = None,
) -> bytes:
    out = bytearray()
    if comparator is not None:
        name = comparator.encode("ascii")
        out += wire.encode_varint(K_COMPARATOR)
        out += wire.encode_varint(len(name)) + name
    if log_number is not None:
        out += wire.encode_varint(K_LOG_NUMBER) + wire.encode_varint(log_number)
    if next_file is not None:
        out += wire.encode_varint(K_NEXT_FILE) + wire.encode_varint(next_file)
    if last_sequence is not None:
        out += wire.encode_varint(K_LAST_SEQ) + wire.encode_varint(
            last_sequence
        )
    for level, number, size, smallest, largest in new_files or []:
        out += wire.encode_varint(K_NEW_FILE)
        out += wire.encode_varint(level) + wire.encode_varint(number)
        out += wire.encode_varint(size)
        out += wire.encode_varint(len(smallest)) + smallest
        out += wire.encode_varint(len(largest)) + largest
    return bytes(out)


# ---------------------------------------------------------------------------
# SSTable
# ---------------------------------------------------------------------------

def pack_internal_key(user_key: bytes, seq: int, vtype: int) -> bytes:
    return user_key + struct.pack("<Q", (seq << 8) | vtype)


def unpack_internal_key(ikey: bytes) -> Tuple[bytes, int, int]:
    if len(ikey) < 8:
        raise LevelDBError("internal key shorter than 8 bytes")
    packed = struct.unpack_from("<Q", ikey, len(ikey) - 8)[0]
    return ikey[:-8], packed >> 8, packed & 0xFF


def _decode_block(content: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Iterate (key, value) of one block, restoring shared prefixes."""
    if len(content) < 4:
        raise LevelDBError("block too small for restart trailer")
    num_restarts = struct.unpack_from("<I", content, len(content) - 4)[0]
    data_end = len(content) - 4 * (num_restarts + 1)
    if data_end < 0:
        raise LevelDBError("block restart array overruns content")
    view, pos, key = memoryview(content), 0, b""
    while pos < data_end:
        shared, pos = wire.decode_varint(view, pos)
        non_shared, pos = wire.decode_varint(view, pos)
        vlen, pos = wire.decode_varint(view, pos)
        if shared > len(key):
            raise LevelDBError("block entry shares more key than exists")
        key = key[:shared] + bytes(content[pos:pos + non_shared])
        pos += non_shared
        yield key, bytes(content[pos:pos + vlen])
        pos += vlen


class Table:
    """Read-only block-based table (.ldb / .sst)."""

    def __init__(self, path: str):
        import mmap

        self.path = path
        # mmap, not read(): real reference datasets are hundreds of GB
        # (same rule as io/lmdb.py) and a reader may hold many tables open
        with open(path, "rb") as f:
            self.data = memoryview(
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            )
        if len(self.data) < 48:
            raise LevelDBError(f"{path}: shorter than a table footer")
        footer = self.data[-48:]
        magic = struct.unpack_from("<Q", footer, 40)[0]
        if magic != TABLE_MAGIC:
            raise LevelDBError(f"{path}: bad table magic {magic:#x}")
        view = memoryview(footer)
        off, pos = wire.decode_varint(view, 0)
        size, pos = wire.decode_varint(view, pos)  # metaindex (unused)
        ioff, pos = wire.decode_varint(view, pos)
        isize, pos = wire.decode_varint(view, pos)
        self.index = list(_decode_block(self._block(ioff, isize)))

    def _block(self, offset: int, size: int) -> bytes:
        raw = self.data[offset:offset + size]
        if len(raw) < size or offset + size + 5 > len(self.data):
            raise LevelDBError(f"{self.path}: truncated block")
        btype = self.data[offset + size]
        masked = struct.unpack_from("<I", self.data, offset + size + 1)[0]
        got = crc32c(self.data[offset:offset + size + 1])
        if crc_unmask(masked) != got:
            raise LevelDBError(f"{self.path}: block crc mismatch")
        if btype == 0:
            return raw
        if btype == 1:
            return snappy_decompress(raw)
        raise LevelDBError(f"{self.path}: unknown block compression {btype}")

    def __iter__(self) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """(user_key, seq, type, value) in internal-key order."""
        for _sep, handle in self.index:
            hview = memoryview(handle)
            off, hpos = wire.decode_varint(hview, 0)
            size, _ = wire.decode_varint(hview, hpos)
            for ikey, value in _decode_block(self._block(off, size)):
                user_key, seq, vtype = unpack_internal_key(ikey)
                yield user_key, seq, vtype, value


class TableWriter:
    """Block-based table writer: sorted internal keys in, .ldb out."""

    def __init__(self, path: str, block_size: int = 4096,
                 restart_interval: int = 16, snappy_literal: bool = False):
        self.f = open(path, "wb")
        self.block_size = block_size
        self.restart_interval = restart_interval
        self.snappy_literal = snappy_literal
        self.offset = 0
        self.index: List[Tuple[bytes, bytes]] = []  # (last_ikey, handle)
        self._reset_block()
        self.last_ikey: Optional[bytes] = None

    def _reset_block(self):
        self.block = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.block_last_key = b""

    def add(self, ikey: bytes, value: bytes) -> None:
        if self.last_ikey is not None and ikey <= self.last_ikey:
            raise LevelDBError("table keys must be strictly increasing")
        self.last_ikey = ikey
        if self.counter >= self.restart_interval:
            self.restarts.append(len(self.block))
            self.counter = 0
            self.block_last_key = b""
        shared = 0
        maxs = min(len(ikey), len(self.block_last_key))
        while shared < maxs and ikey[shared] == self.block_last_key[shared]:
            shared += 1
        self.block += wire.encode_varint(shared)
        self.block += wire.encode_varint(len(ikey) - shared)
        self.block += wire.encode_varint(len(value))
        self.block += ikey[shared:] + value
        self.block_last_key = ikey
        self.counter += 1
        if len(self.block) >= self.block_size:
            self._flush_block()

    def _write_raw_block(self, content: bytes) -> bytes:
        """Write content + trailer, return its BlockHandle."""
        btype = 0
        if self.snappy_literal:
            compressed = snappy_compress_literal(content)
            content, btype = compressed, 1
        crc = crc_mask(crc32c(content + bytes([btype])))
        handle = wire.encode_varint(self.offset) + wire.encode_varint(
            len(content)
        )
        self.f.write(content + bytes([btype]) + struct.pack("<I", crc))
        self.offset += len(content) + 5
        return handle

    def _block_content(self) -> bytes:
        trailer = b"".join(struct.pack("<I", r) for r in self.restarts)
        return bytes(self.block) + trailer + struct.pack(
            "<I", len(self.restarts)
        )

    def _flush_block(self):
        if not self.block:
            return
        handle = self._write_raw_block(self._block_content())
        self.index.append((self.block_last_key, handle))
        self._reset_block()

    def finish(self) -> int:
        self._flush_block()
        # empty metaindex block (one restart point, zero entries)
        meta_handle = self._write_raw_block(struct.pack("<II", 0, 1))
        # index block built with the same entry encoder, restart every entry
        index = bytearray()
        restarts = []
        for key, handle in self.index:
            restarts.append(len(index))
            index += wire.encode_varint(0)
            index += wire.encode_varint(len(key))
            index += wire.encode_varint(len(handle))
            index += key + handle
        index += b"".join(struct.pack("<I", r) for r in restarts or [0])
        index += struct.pack("<I", len(restarts) or 1)
        index_handle = self._write_raw_block(bytes(index))
        footer = meta_handle + index_handle
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", TABLE_MAGIC)
        self.f.write(footer)
        self.offset += 48
        self.f.close()
        return self.offset


# ---------------------------------------------------------------------------
# database-level read / write
# ---------------------------------------------------------------------------

def is_leveldb(path: str) -> bool:
    """True when ``path`` is a LevelDB directory (CURRENT -> MANIFEST)."""
    current = os.path.join(path, "CURRENT")
    if not os.path.isdir(path) or not os.path.isfile(current):
        return False
    with open(current, "rb") as f:
        name = f.read(64).strip()
    return name.startswith(b"MANIFEST-") and os.path.isfile(
        os.path.join(path, name.decode("ascii", "replace"))
    )


class LevelDBReader:
    """Merged, latest-visible, key-ordered scan of a LevelDB directory —
    the view Caffe's ``LevelDBCursor`` (SeekToFirst/Next) iterates."""

    def __init__(self, path: str):
        if not is_leveldb(path):
            raise LevelDBError(f"{path} is not a LevelDB directory")
        self.path = path
        with open(os.path.join(path, "CURRENT"), "rb") as f:
            manifest = f.read().strip().decode("ascii")
        self.state = read_manifest(os.path.join(path, manifest))
        self.tables: List[Table] = []
        for (_level, number), _meta in sorted(self.state["files"].items()):
            for ext in (".ldb", ".sst"):
                tpath = os.path.join(path, f"{number:06d}{ext}")
                if os.path.isfile(tpath):
                    self.tables.append(Table(tpath))
                    break
            else:
                raise LevelDBError(f"{path}: live table {number:06d} missing")
        # replay live write-ahead logs into a memtable
        self.memtable: Dict[bytes, Tuple[int, int, bytes]] = {}
        live = {self.state["log_number"], self.state["prev_log_number"]}
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".log"):
                continue
            number = int(fname.split(".")[0])
            if number and (number in live or number > self.state["log_number"]):
                for rec in read_log_records(os.path.join(path, fname)):
                    for key, seq, vtype, value in iter_batch(rec):
                        cur = self.memtable.get(key)
                        if cur is None or seq >= cur[0]:
                            self.memtable[key] = (seq, vtype, value)

    def _sources(self) -> List[Iterator[Tuple[bytes, int, int, bytes]]]:
        sources = [iter(t) for t in self.tables]
        mem = sorted(
            (k, s, t, v) for k, (s, t, v) in self.memtable.items()
        )
        sources.append(iter(mem))
        return sources

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        merged = heapq.merge(
            *self._sources(), key=lambda e: (e[0], -e[1])
        )
        current: Optional[bytes] = None
        for key, _seq, vtype, value in merged:
            if key == current:
                continue  # older sequence shadowed by the one emitted
            current = key
            if vtype == TYPE_VALUE:
                yield key, value

    def __len__(self) -> int:
        return sum(1 for _ in self)


def write_leveldb(
    path: str,
    items: List[Tuple[bytes, bytes]],
    log_items: Optional[List[Tuple[bytes, Optional[bytes]]]] = None,
    block_size: int = 4096,
    snappy_literal: bool = False,
) -> None:
    """Fixture/export writer: one level-0 table of ``items`` (sorted by
    key, sequences 1..N) plus an optional tail of WAL entries
    (``log_items``; value ``None`` = deletion) at higher sequences —
    enough structure to exercise every read path."""
    os.makedirs(path, exist_ok=True)
    items = sorted(items)
    for (k1, _), (k2, _) in zip(items, items[1:]):
        if k1 == k2:
            # duplicate user keys need seq-desc ordering inside the table,
            # which byte-ordered internal keys cannot express here; the
            # overwrite path is log_items (newer sequences win on read)
            raise LevelDBError(
                f"duplicate key {k1!r}: pass overwrites via log_items"
            )
    table_no, log_no, manifest_no = 5, 3, 2
    seq = 0
    tw = TableWriter(
        os.path.join(path, f"{table_no:06d}.ldb"),
        block_size=block_size,
        snappy_literal=snappy_literal,
    )
    smallest = largest = b""
    for key, value in items:
        seq += 1
        ikey = pack_internal_key(key, seq, TYPE_VALUE)
        if not smallest:
            smallest = ikey
        largest = ikey
        tw.add(ikey, value)
    size = tw.finish()
    with open(os.path.join(path, f"{log_no:06d}.log"), "wb") as f:
        if log_items:
            LogWriter(f).add_record(batch_records(log_items, seq + 1))
            seq += len(log_items)
    edit = version_edit(
        comparator="leveldb.BytewiseComparator",
        log_number=log_no,
        next_file=table_no + 1,
        last_sequence=seq,
        new_files=(
            [(0, table_no, size, smallest, largest)] if items else []
        ),
    )
    with open(os.path.join(path, f"MANIFEST-{manifest_no:06d}"), "wb") as f:
        LogWriter(f).add_record(edit)
    with open(os.path.join(path, "CURRENT"), "wb") as f:
        f.write(f"MANIFEST-{manifest_no:06d}\n".encode("ascii"))


# ---------------------------------------------------------------------------
# Caffe Datum convenience surface (parallel to io/lmdb.py)
# ---------------------------------------------------------------------------

def read_datum_leveldb(path: str):
    """Iterate (uint8 image (C,H,W), label) pairs of a Caffe LevelDB."""
    for _key, value in LevelDBReader(path):
        yield decode_datum(value)


def write_datum_leveldb(path: str, images: np.ndarray, labels) -> None:
    """``convert_imageset --backend leveldb`` analog: (N,C,H,W) uint8 +
    labels -> LevelDB of Datums with zero-padded decimal keys."""
    items = [
        (b"%08d" % i, encode_datum(images[i], int(labels[i])))
        for i in range(len(labels))
    ]
    write_leveldb(path, items)


def leveldb_to_record_db(source: str, out: Optional[str] = None) -> str:
    """One-time import into the native record format (same contract and
    caching rule as ``lmdb.lmdb_to_record_db``)."""
    from sparknet_tpu_torch import runtime
    from sparknet_tpu_torch.io.lmdb import LMDBError as _LE  # shared label rule

    out = out or source.rstrip("/\\") + ".sndb"
    with open(os.path.join(source, "CURRENT"), "rb") as f:
        manifest = f.read().strip().decode("ascii")
    src_mtime = max(
        os.path.getmtime(os.path.join(source, n))
        for n in os.listdir(source)
        if n == manifest or n.endswith((".ldb", ".sst", ".log"))
    )
    if os.path.exists(out) and os.path.getmtime(out) >= src_mtime:
        return out
    tmp = out + ".tmp"
    with runtime.RecordDB(tmp, "w") as db:
        for i, (image, label) in enumerate(read_datum_leveldb(source)):
            if not 0 <= int(label) <= 0xFFFF:
                raise _LE(f"label {label} exceeds 2-byte range")
            value = int(label).to_bytes(2, "little") + np.ascontiguousarray(
                image, np.uint8
            ).tobytes()
            db.put(b"%08d" % i, value)
            if (i + 1) % 1000 == 0:
                db.commit()
        db.commit()
    os.replace(tmp, out)
    return out
