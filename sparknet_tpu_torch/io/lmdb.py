"""Pure-Python LMDB reader (+ minimal writer) and Caffe ``Datum`` codec.

The port's own copy of ``sparknet_tpu/io/lmdb.py``: it reads and writes
the same files, and ``lmdb_to_record_db`` writes the same record DB.

Import-parity role: the universal Caffe dataset format is an LMDB (or
LevelDB) of serialized ``Datum`` protos (reference:
``caffe/src/caffe/util/db_lmdb.cpp``, ``data_layer.cpp``,
``convert_imageset.cpp``).  The runtime's own record format
(``runtime.RecordDB``) is the framework's fast path, but existing
reference-created datasets must load too — this module reads the LMDB
on-disk B-tree directly, with no liblmdb dependency.

File format (public, from liblmdb's ``mdb.c`` structures; 64-bit
little-endian layout, MDB_DATA_VERSION=1, magic 0xBEEFC0DE):

- page header (16 bytes): pgno u64 | pad u16 | flags u16 | lower u16 |
  upper u16 (overflow pages reuse lower/upper as a u32 page count);
- meta pages 0 and 1 hold ``MDB_meta`` right after the header: magic,
  version, address, mapsize, two ``MDB_db`` records (FREE_DBI, whose
  ``md_pad`` doubles as the page size, and MAIN_DBI), last_pg, txnid —
  readers pick the meta with the larger txnid;
- ``MDB_db`` (48 bytes): pad u32 | flags u16 | depth u16 |
  branch/leaf/overflow page counts u64 | entries u64 | root u64;
- node: lo u16 | hi u16 | flags u16 | ksize u16 | key bytes | payload.
  Leaf data size = lo | hi<<16; F_BIGDATA (0x01) payload is the u64
  pgno of an overflow chain.  Branch child pgno = lo | hi<<16 |
  flags<<32.  The per-page node-pointer array (u16 offsets, key order)
  starts at byte 16; its length is (lower-16)/2.

The writer emits the same structures (sorted keys, values in overflow
chains, a root branch when one leaf page is not enough) — it exists so
tests can build fixture databases and users can export to the
interchange format without liblmdb.  Sub-databases, DUPSORT and LEAF2
pages are out of scope (Caffe datasets use none of them).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sparknet_tpu_torch.io import wire

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf, entries, root
_NODE = struct.Struct("<HHHH")  # lo, hi, flags, ksize


class LMDBError(IOError):
    pass


class LMDBReader:
    """Iterate (key, value) pairs of an LMDB main database in key order.

    ``path`` may be the data file itself or an LMDB directory
    (``data.mdb`` inside — the reference's ``source:`` convention)."""

    def __init__(self, path: str):
        import mmap
        import os

        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        # mmap, not read(): real reference datasets are hundreds of GB
        # and the B-tree walk touches pages on demand
        self._file = open(path, "rb")
        try:
            self._buf = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )
        except ValueError:
            self._buf = b""  # zero-length file
        if len(self._buf) < 2 * PAGEHDRSZ + _META.size:
            raise LMDBError(f"{path}: too small for an LMDB file")
        metas = []
        # psize unknown until a meta parses; metas live at 0 and psize,
        # but page 1 can only start at one of the standard page sizes
        meta0 = self._parse_meta(0)
        if meta0 is None:
            raise LMDBError(f"{path}: no LMDB meta at page 0 (bad magic)")
        metas.append(meta0)
        psize = meta0["psize"]
        meta1 = self._parse_meta(psize)
        if meta1 is not None:
            metas.append(meta1)
        self._meta = max(metas, key=lambda m: m["txnid"])
        self._psize = self._meta["psize"]
        self.entries = self._meta["main"]["entries"]

    def _parse_meta(self, off: int) -> Optional[dict]:
        magic, version, _addr, mapsize = _META.unpack_from(
            self._buf, off + PAGEHDRSZ
        )
        if magic != MAGIC or version != DATA_VERSION:
            return None
        p = off + PAGEHDRSZ + _META.size
        dbs = []
        for _ in range(2):
            pad, flags, depth, br, lf, ovf, entries, root = _DB.unpack_from(
                self._buf, p
            )
            dbs.append(
                dict(pad=pad, flags=flags, depth=depth, entries=entries,
                     root=root)
            )
            p += _DB.size
        last_pg, txnid = struct.unpack_from("<QQ", self._buf, p)
        return dict(
            psize=dbs[0]["pad"], main=dbs[1], txnid=txnid, last_pg=last_pg
        )

    # -- page access ----------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int, memoryview]:
        off = pgno * self._psize
        if off + PAGEHDRSZ > len(self._buf):
            raise LMDBError(f"page {pgno} beyond end of file")
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        return off, flags, memoryview(self._buf)

    def _node_ptrs(self, off: int) -> List[int]:
        lower = struct.unpack_from("<H", self._buf, off + 12)[0]
        n = (lower - PAGEHDRSZ) // 2
        return [
            struct.unpack_from("<H", self._buf, off + PAGEHDRSZ + 2 * i)[0]
            for i in range(n)
        ]

    def _overflow(self, pgno: int, size: int) -> bytes:
        off = pgno * self._psize
        return bytes(self._buf[off + PAGEHDRSZ : off + PAGEHDRSZ + size])

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off, flags, _ = self._page(pgno)
        if flags & P_LEAF2:
            raise LMDBError("LEAF2 (dupfixed) databases are not supported")
        ptrs = self._node_ptrs(off)
        if flags & P_BRANCH:
            for p in ptrs:
                lo, hi, nflags, ksize = _NODE.unpack_from(self._buf, off + p)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        elif flags & P_LEAF:
            for p in ptrs:
                lo, hi, nflags, ksize = _NODE.unpack_from(self._buf, off + p)
                kstart = off + p + _NODE.size
                key = bytes(self._buf[kstart : kstart + ksize])
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    ovf_pgno = struct.unpack_from(
                        "<Q", self._buf, kstart + ksize
                    )[0]
                    value = self._overflow(ovf_pgno, dsize)
                else:
                    value = bytes(
                        self._buf[kstart + ksize : kstart + ksize + dsize]
                    )
                yield key, value
        else:
            raise LMDBError(f"page {pgno}: unexpected flags 0x{flags:x}")

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        root = self._meta["main"]["root"]
        if root == P_INVALID:
            return
        yield from self._walk(root)

    def __len__(self) -> int:
        return int(self.entries)


# ---------------------------------------------------------------------------
# Minimal writer (fixtures / export)
# ---------------------------------------------------------------------------


def write_lmdb(path: str, items: List[Tuple[bytes, bytes]],
               psize: int = 4096) -> None:
    """Write (key, value) pairs as a single-version LMDB data file.

    Values larger than a quarter page go to overflow chains (liblmdb
    moves data out of the leaf at ~1/2 fill; any threshold below that
    yields files every reader accepts).  ``path`` may be a directory
    (the file becomes ``data.mdb`` inside, liblmdb's default layout)."""
    import os

    if os.path.isdir(path) or path.endswith(os.sep) or "." not in os.path.basename(path):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    items = sorted(items, key=lambda kv: kv[0])
    pages: Dict[int, bytes] = {}
    next_pg = 2  # 0, 1 are meta
    ovf_pages = 0

    def alloc(n: int) -> int:
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    big_cut = psize // 4

    # place big values in overflow chains first
    payloads = []
    for key, value in items:
        if len(value) > big_cut:
            npg = -(-(len(value) + PAGEHDRSZ) // psize)
            pg = alloc(npg)
            ovf_pages += npg
            chain = bytearray(npg * psize)
            struct.pack_into("<QHHI", chain, 0, pg, 0, P_OVERFLOW, npg)
            chain[PAGEHDRSZ : PAGEHDRSZ + len(value)] = value
            for i in range(npg):
                pages[pg + i] = bytes(chain[i * psize : (i + 1) * psize])
            payloads.append((key, struct.pack("<Q", pg), F_BIGDATA, len(value)))
        else:
            payloads.append((key, value, 0, len(value)))

    # pack leaves
    def build_page(nodes: List[bytes], flags: int, pgno: int) -> bytes:
        page = bytearray(psize)
        upper = psize
        ptrs = []
        for node in nodes:
            upper -= len(node)
            if upper % 2:
                upper -= 1  # nodes are 2-byte aligned
            page[upper : upper + len(node)] = node
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(ptrs)
        if lower > upper:
            raise LMDBError("page overflow while packing nodes")
        struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, p)
        return bytes(page)

    def node_bytes(key: bytes, payload: bytes, nflags: int, dsize: int) -> bytes:
        return _NODE.pack(dsize & 0xFFFF, dsize >> 16, nflags, len(key)) + key + payload

    leaves: List[Tuple[int, bytes, List[bytes]]] = []  # (pgno, first_key, nodes)
    cur_nodes: List[bytes] = []
    cur_first: Optional[bytes] = None
    cur_fill = 0
    cap = psize - PAGEHDRSZ

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_fill
        if cur_nodes:
            pg = alloc(1)
            leaves.append((pg, cur_first, cur_nodes))
            cur_nodes, cur_first, cur_fill = [], None, 0

    for key, payload, nflags, dsize in payloads:
        nb = node_bytes(key, payload, nflags, dsize)
        need = len(nb) + (len(nb) % 2) + 2  # node + align + ptr slot
        if cur_nodes and cur_fill + need > cap:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(nb)
        cur_fill += need
    flush_leaf()

    for pg, _, nodes in leaves:
        pages[pg] = build_page(nodes, P_LEAF, pg)

    depth = 1
    if not leaves:
        root = P_INVALID
    elif len(leaves) == 1:
        root = leaves[0][0]
    else:
        # one branch level is enough for fixture-scale databases
        depth = 2
        root = alloc(1)
        bnodes = []
        for i, (pg, first_key, _) in enumerate(leaves):
            key = b"" if i == 0 else first_key  # leftmost branch key is empty
            bnodes.append(
                _NODE.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF, (pg >> 32) & 0xFFFF, len(key))
                + key
            )
        pages[root] = build_page(bnodes, P_BRANCH, root)

    # metas
    def meta_page(pgno: int, txnid: int) -> bytes:
        page = bytearray(psize)
        struct.pack_into("<QHHHH", page, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        _META.pack_into(page, off, MAGIC, DATA_VERSION, 0, next_pg * psize)
        off += _META.size
        # FREE_DBI: empty; md_pad carries psize
        _DB.pack_into(page, off, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        off += _DB.size
        nbranch = 1 if depth == 2 else 0
        _DB.pack_into(
            page, off, 0, 0, depth if leaves else 0, nbranch, len(leaves),
            ovf_pages, len(items), root,
        )
        off += _DB.size
        struct.pack_into("<QQ", page, off, next_pg - 1, txnid)
        return bytes(page)

    with open(path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for pg in range(2, next_pg):
            f.write(pages[pg])


# ---------------------------------------------------------------------------
# Caffe Datum codec (caffe.proto:30-41)
# ---------------------------------------------------------------------------

# Datum fields: 1 channels, 2 height, 3 width, 4 data (bytes),
# 5 label, 6 float_data (repeated float), 7 encoded (bool)


def encode_datum(image: np.ndarray, label: int, encoded: bool = False) -> bytes:
    """uint8 (C, H, W) image + label -> serialized Datum."""
    c, h, w = image.shape
    return (
        wire.field_varint(1, c)
        + wire.field_varint(2, h)
        + wire.field_varint(3, w)
        + wire.field_bytes(4, np.ascontiguousarray(image, np.uint8).tobytes())
        + wire.field_varint(5, int(label))
        + (wire.field_varint(7, 1) if encoded else b"")
    )


def decode_datum(buf: bytes) -> Tuple[np.ndarray, int]:
    """Serialized Datum -> (uint8 (C, H, W) image, label).  Encoded
    (JPEG/PNG) datums are decoded through PIL like the reference's
    DecodeDatum (``io.cpp``)."""
    c = h = w = label = 0
    data = b""
    floats: Optional[np.ndarray] = None
    encoded = False
    for field, wt, value in wire.iter_fields(buf):
        if field == 1:
            c = int(value)
        elif field == 2:
            h = int(value)
        elif field == 3:
            w = int(value)
        elif field == 4:
            data = bytes(value)
        elif field == 5:
            label = int(value)
        elif field == 6:
            floats = wire.packed_floats(value, wt)
        elif field == 7:
            encoded = bool(value)
    if encoded:
        import io as _io

        from PIL import Image

        img = Image.open(_io.BytesIO(data)).convert("RGB")
        arr = np.asarray(img, np.uint8)  # (H, W, 3)
        return np.ascontiguousarray(arr.transpose(2, 0, 1)), label
    if data:
        return np.frombuffer(data, np.uint8).reshape(c, h, w).copy(), label
    if floats is not None:
        # float_data datums (e.g. extracted features); surfaced as float32
        return floats.reshape(c, h, w), label  # type: ignore[return-value]
    raise LMDBError("Datum has neither data nor float_data")


def read_datum_lmdb(path: str):
    """Iterate (uint8 image (C,H,W), label) pairs of a Caffe LMDB."""
    for _key, value in LMDBReader(path):
        yield decode_datum(value)


def is_lmdb(path: str) -> bool:
    """True when ``path`` is an LMDB directory or data file."""
    import os

    if os.path.isdir(path):
        path = os.path.join(path, "data.mdb")
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        head = f.read(PAGEHDRSZ + 8)
    return (
        len(head) >= PAGEHDRSZ + 8
        and struct.unpack_from("<I", head, PAGEHDRSZ)[0] == MAGIC
    )


def lmdb_to_record_db(source: str, out: Optional[str] = None) -> str:
    """One-time import of a Caffe LMDB into the native record format so
    the full native data pipeline (reader thread + transformer) applies;
    cached beside the source, rebuilt when the LMDB is newer."""
    import os

    from sparknet_tpu_torch import runtime

    out = out or source.rstrip("/\\") + ".sndb"
    src_file = (
        os.path.join(source, "data.mdb") if os.path.isdir(source) else source
    )
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(
        src_file
    ):
        return out
    # build at a temp path and publish atomically — an interrupted
    # import must not leave a truncated file the cache check accepts
    tmp = out + ".tmp"
    with runtime.RecordDB(tmp, "w") as db:
        for i, (image, label) in enumerate(read_datum_lmdb(source)):
            # 2-byte labels: single streaming pass, and Caffe LMDBs are
            # routinely 1000-class (readers infer the width from record
            # length)
            if not 0 <= int(label) <= 0xFFFF:
                raise LMDBError(f"label {label} exceeds 2-byte range")
            value = int(label).to_bytes(2, "little") + np.ascontiguousarray(
                image, np.uint8
            ).tobytes()
            db.put(b"%08d" % i, value)
            if (i + 1) % 1000 == 0:
                db.commit()
        db.commit()
    os.replace(tmp, out)
    return out


def write_datum_lmdb(path: str, images: np.ndarray, labels) -> None:
    """The ``convert_imageset``-style export: (N,C,H,W) uint8 + labels
    -> LMDB of Datums with the reference's zero-padded decimal keys."""
    items = [
        (b"%08d" % i, encode_datum(images[i], int(labels[i])))
        for i in range(len(labels))
    ]
    write_lmdb(path, items)
