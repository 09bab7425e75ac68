"""The port's record runtime against the JAX package's, on the CPU.

- Record DBs: files written by the port's ``write_datum_db`` equal the
  JAX package's byte for byte, with 1-byte and 2-byte labels, and each
  package reads the other's.
- Readers: the port's Python and native ``DataPipeline`` (1 and 3
  transform threads) and the JAX ``runtime.DataPipeline`` (its native
  reader where ``make -C native`` built it, else its Python fallback,
  which gives the same bits) give identical batches, bit for bit,
  in float and ``u8_output`` mode, for train (random crop + mirror) and
  test (centre crop), with a full and a per-channel mean, across a wrap
  of the DB (13 records, 6 batches of 5).
- ``start = k`` gives the tail of a pipeline opened at 0 after k
  records, in both readers.
- Faults: a truncated or empty DB and a record of the wrong size raise
  in both readers, and ``close`` works after ``next`` raised.  The
  native reader is built into the git-ignored build directory keyed by
  its source; a failed build raises with the compiler's output, and the
  pipeline never falls back to the Python reader.

Every pipeline is closed in a ``finally``: a stray reader thread could
hold up the test run.
"""

import contextlib
import os

import numpy as np
import pytest

from sparknet_tpu import runtime as jruntime
from sparknet_tpu_torch import runtime as truntime
from sparknet_tpu_torch.runtime import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C, H, W = 13, 3, 11, 9
CROP, BATCH, BATCHES = 7, 5, 6


def _images(seed=0, n=N):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n, C, H, W)).astype(np.uint8), rs


@contextlib.contextmanager
def _pipes(*pipes_or_factories):
    """Open pipelines (factories called in order) and close them all."""
    opened = []
    try:
        for f in pipes_or_factories:
            opened.append(f())
        yield opened
    finally:
        for p in opened:
            p.close()


def _read(pipe, n=BATCHES):
    return [pipe.next() for _ in range(n)]


def _same(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert len(x) == len(y), what
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape, what
            assert np.array_equal(u, v), what


# ----------------------------------------------------------------------
# the record DB
# ----------------------------------------------------------------------
@pytest.mark.parametrize("classes,width", [(10, 1), (1000, 2)])
def test_record_db_bytes_equal_jax(tmp_path, classes, width):
    imgs, rs = _images()
    labels = rs.randint(0, classes, N)
    labels[0] = classes - 1
    jp, tp = str(tmp_path / "j.sndb"), str(tmp_path / "t.sndb")
    jruntime.write_datum_db(jp, imgs, labels, commit_every=4)
    truntime.write_datum_db(tp, imgs, labels, commit_every=4)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file
    with truntime.RecordDB(jp) as tdb, jruntime.RecordDB(tp) as jdb:
        assert len(tdb) == len(jdb) == N
        for i in (0, 6, N - 1):
            key, value = tdb.read(i)
            assert (key, value) == jdb.read(i)
            assert key == b"%08d" % i and len(value) == width + C * H * W
            assert int.from_bytes(value[:width], "little") == labels[i]
            assert value[width:] == imgs[i].tobytes()
    with pytest.raises(IndexError):
        truntime.RecordDB(jp).read(N)


def test_record_db_put_commit_and_refusals(tmp_path):
    path = str(tmp_path / "r.sndb")
    with truntime.RecordDB(path, "w") as db:
        db.put(b"a", b"xyz")
        assert os.path.getsize(path) <= 8  # the put waits for the commit
        db.commit()
        db.put(b"bb", b"")
        db.commit()
    with truntime.RecordDB(path) as db:
        assert [db.read(i) for i in range(len(db))] == [(b"a", b"xyz"),
                                                         (b"bb", b"")]
    with open(path, "rb") as f:
        good = f.read()
    for bad, match in ((good[:-2] + b"\x05\x00", "truncated"),
                       (b"SNDB2\x00\x00\x00" + good[8:], "bad magic")):
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(IOError, match=match):
            truntime.RecordDB(path)
    with pytest.raises(ValueError, match="outside"):
        truntime.write_datum_db(path, np.zeros((1, 1, 1, 1), np.uint8), [70000])


# ----------------------------------------------------------------------
# the readers
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def db(tmp_path_factory):
    imgs, rs = _images(seed=1)
    path = str(tmp_path_factory.mktemp("db") / "d.sndb")
    truntime.write_datum_db(path, imgs, rs.randint(0, 1000, N))
    mean = (rs.rand(C, H, W) * 255).astype(np.float32)
    return path, mean


@pytest.mark.parametrize("u8", [False, True], ids=["float", "u8"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("mean_kind", ["full", "channel"])
def test_readers_equal_the_jax_reader(db, u8, train, mean_kind):
    path, mean = db
    if mean_kind == "channel":
        mean = mean.mean(axis=(1, 2))
    kw = dict(batch_size=BATCH, shape=(C, H, W), crop=CROP, mirror=True,
              train=train, mean=mean, seed=3, scale=0.5, u8_output=u8)
    with _pipes(lambda: jruntime.DataPipeline(path, **kw),
                lambda: truntime.DataPipeline(path, native=False, **kw),
                lambda: truntime.DataPipeline(path, workers=1, **kw),
                lambda: truntime.DataPipeline(path, workers=3, **kw)) as ps:
        want = _read(ps[0])
        for p, what in zip(ps[1:], ("python", "native x1", "native x3")):
            _same(_read(p), want, what)
    data = want[0][0]
    assert data.dtype == (np.uint8 if u8 else np.float32)
    assert data.shape == (BATCH, C, CROP, CROP)
    if train and u8:  # the crops and mirrors vary from record to record
        geom = np.concatenate([np.stack(b[2:]) for b in want], axis=1)
        assert len({tuple(g) for g in geom.T}) > 1


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("u8", [False, True], ids=["float", "u8"])
def test_start_equals_skipping(db, native, u8):
    """A pipeline opened at record sequence k delivers what one opened at
    0 delivers after k records (k past a wrap of the DB, and not a
    multiple of the batch)."""
    path, mean = db
    kw = dict(batch_size=BATCH, shape=(C, H, W), crop=CROP, mirror=True,
              train=True, mean=mean, seed=7, u8_output=u8, native=native)
    k = 17
    with _pipes(lambda: truntime.DataPipeline(path, **kw),
                lambda: truntime.DataPipeline(path, start=k, **kw)) as (a, b):
        full = _read(a, 8)
        tail = _read(b, 4)
    for i in range(len(full[0])):
        whole = np.concatenate([x[i] for x in full])
        assert np.array_equal(np.concatenate([x[i] for x in tail]),
                              whole[k: k + 4 * BATCH])


def test_no_crop_and_no_mean_is_the_identity(db):
    path, _ = db
    imgs, rs = _images(seed=1)
    labels = rs.randint(0, 1000, N)
    kw = dict(batch_size=N, shape=(C, H, W))
    with _pipes(lambda: truntime.DataPipeline(path, **kw),
                lambda: truntime.DataPipeline(path, native=False, **kw)) as ps:
        for p in ps:
            x, y = p.next()
            assert np.array_equal(x, imgs.astype(np.float32))
            assert np.array_equal(y, labels.astype(np.float32))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_reader_faults_raise_and_close(tmp_path, native):
    empty = str(tmp_path / "empty.sndb")
    truntime.write_datum_db(empty, np.zeros((0, C, H, W), np.uint8), [])
    with pytest.raises(IOError, match="empty db"):
        truntime.DataPipeline(empty, 2, (C, H, W), native=native)
    imgs, _ = _images()
    path = str(tmp_path / "d.sndb")
    truntime.write_datum_db(path, imgs, np.arange(N))
    with pytest.raises(IOError, match="crop exceeds"):
        truntime.DataPipeline(path, 2, (C, H, W), crop=H + 1, native=native)
    # the DB's records are 3x11x9: read as 3x11x8 every record mismatches
    pipe = truntime.DataPipeline(path, 2, (C, H, W - 1), native=native)
    try:
        with pytest.raises(IOError, match="record size mismatch"):
            pipe.next()
        with pytest.raises(IOError):
            pipe.next()  # the reader stays stopped
    finally:
        pipe.close()
    pipe.close()  # idempotent
    with pytest.raises(IOError, match="closed"):
        pipe.next()


def test_close_stops_readers_parked_on_a_full_queue(db):
    import threading

    path, mean = db
    before = threading.active_count()
    pipes = [truntime.DataPipeline(path, 2, (C, H, W), mean=mean,
                                   native=False, prefetch=1) for _ in range(3)]
    try:
        for p in pipes:
            p.next()
    finally:
        for p in pipes:
            p.close()
    assert threading.active_count() == before


def test_native_reader_builds_from_its_source_and_never_falls_back(
        tmp_path, monkeypatch, db):
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("libsparknet_runtime-")
    assert os.path.relpath(_build.SRC, REPO) == os.path.join(
        "sparknet_tpu_torch", "runtime", "csrc", "runtime.cpp")
    assert "-march=x86-64-v2" in _build.CXX_FLAGS
    # a failing compiler raises with its output, and leaves no library
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the native record reader"):
        _build.build()
    assert not (tmp_path / "lib.so").exists()

    # a reader that cannot load its library raises: no quiet Python path
    def broken():
        raise RuntimeError("no library")

    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="no library"):
        truntime.DataPipeline(db[0], 2, (C, H, W))
    with _pipes(lambda: truntime.DataPipeline(db[0], 2, (C, H, W),
                                              native=False)) as (pipe,):
        assert not pipe.native and pipe.next()[0].shape == (2, C, H, W)
