"""The port's object store, chunk cache and retry layer, on the CPU.

``data/object_store.py``, ``data/chunk_cache.py`` and ``utils/retry.py``
of ``sparknet_tpu_torch`` against local ``http.server`` stubs and
``file://`` roots (loopback only — no network), mirroring the JAX
package's ``tests/test_object_store.py``, ``tests/test_chunk_cache.py``
and ``tests/test_retry.py``; plus parity with the JAX package: the same
retry classification and backoff schedule from the same seed, and the
same cache keys and sidecar manifests for the same bytes.  (The object
store carries the delivery watcher's reads; the loader's object-store
roots and the shuffle plan come with the data plane.)
"""

import http.server
import json
import os
import random
import socket
import threading
import urllib.error
import urllib.parse

import pytest

from sparknet_tpu.data import chunk_cache as jax_chunk_cache
from sparknet_tpu.data import object_store as jax_object_store
from sparknet_tpu.utils import retry as jax_retry
from sparknet_tpu_torch.data import chunk_cache, object_store
from sparknet_tpu_torch.data.chunk_cache import CachingStore, ChunkCache
from sparknet_tpu_torch.data.imagenet import write_synthetic_imagenet
from sparknet_tpu_torch.utils import retry


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("objstore"))
    write_synthetic_imagenet(
        d, num_shards=4, images_per_shard=6, classes=3, seed=5
    )
    return d


@pytest.fixture()
def http_root(shard_dir):
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=shard_dir, **kw
    )
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()


def _serve(handler_cls):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


# ----------------------------------------------------------------------
# object stores (tests/test_object_store.py)


def test_http_store_lists_and_streams(http_root, shard_dir):
    """HTTPStore's auto-index listing and streamed reads (the JAX test
    drives them through ImageNetLoader; here the store alone)."""
    store = object_store.open_store(http_root)
    shards = [n for n in store.list("train.") if n.endswith(".tar")]
    assert shards == ["train.00000.tar", "train.00001.tar",
                      "train.00002.tar", "train.00003.tar"]
    with open(os.path.join(shard_dir, shards[0]), "rb") as f:
        want = f.read()
    with store.open(shards[0]) as r:
        assert r.read() == want
    assert len(store.read("train.txt").splitlines()) == 24


def test_http_store_index_txt_overrides_autoindex(shard_dir, http_root):
    with open(os.path.join(shard_dir, "index.txt"), "w") as f:
        f.write("train.00000.tar\n")
    try:
        store = object_store.open_store(http_root)
        assert store.list("train.") == ["train.00000.tar"]
    finally:
        os.remove(os.path.join(shard_dir, "index.txt"))


def test_s3_list_unescapes_xml_keys_and_paginates():
    """S3 satellites: ListObjectsV2 bodies are XML — keys containing
    ``&``/``<`` arrive entity-escaped (``&amp;``/``&lt;``) and big
    listings paginate via NextContinuationToken.  Names must unescape
    (else the later GET 404s), strip the root prefix, and accumulate
    across 2+ pages in globally sorted order."""
    from html import escape

    objects = {
        "pre/a&b shard.tar": b"AB",
        "pre/c<d.tar": b"CD",
        "pre/plain.tar": b"PL",
        "pre/z&last.tar": b"ZL",
    }
    keys = sorted(objects)
    tokens_seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(parsed.query)
            if "list-type" in q:
                token = q.get("continuation-token", [""])[0]
                tokens_seen.append(token)
                start = 2 if token else 0  # 2 keys per page
                page = keys[start : start + 2]
                nct = (
                    "<NextContinuationToken>tok&amp;2</"
                    "NextContinuationToken>"
                    if start + 2 < len(keys)
                    else ""
                )
                body = (
                    "<?xml version='1.0'?><ListBucketResult>"
                    + "".join(
                        f"<Key>{escape(k)}</Key>" for k in page
                    )
                    + nct
                    + "</ListBucketResult>"
                ).encode()
            else:
                key = urllib.parse.unquote(parsed.path.lstrip("/"))
                if key not in objects:
                    self.send_error(404)
                    return
                body = objects[key]
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv, root = _serve(Handler)
    try:
        store = object_store.S3Store("s3://bucket/pre", endpoint=root)
        names = store.list("")
        # unescaped, prefix-stripped, sorted — across both pages
        assert names == sorted(
            ["a&b shard.tar", "c<d.tar", "plain.tar", "z&last.tar"]
        )
        # the continuation token itself was unescaped before reuse
        assert tokens_seen == ["", "tok&2"]
        # and the unescaped name actually FETCHES (the regression: an
        # escaped name 404s)
        assert store.read("a&b shard.tar") == b"AB"
    finally:
        srv.shutdown()


def test_gcs_list_pagination_two_pages(shard_dir):
    """GCS satellite: the ``pageToken`` loop (object_store.py) had no
    multi-page coverage — force 2 pages and assert order + root-prefix
    stripping."""
    names_all = sorted(os.listdir(shard_dir))
    pages_seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            assert parsed.path == "/storage/v1/b/mybucket/o"
            q = urllib.parse.parse_qs(parsed.query)
            token = q.get("pageToken", [""])[0]
            pages_seen.append(token)
            start = int(token) if token else 0
            page = names_all[start : start + 2]
            body = {
                "items": [{"name": "imagenet/" + n} for n in page]
            }
            if start + 2 < len(names_all):
                body["nextPageToken"] = str(start + 2)
            raw = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    srv, root = _serve(Handler)
    try:
        store = object_store.GCSStore("gs://mybucket/imagenet", endpoint=root)
        assert store.list("") == names_all  # every page, prefix stripped
        assert len(pages_seen) >= 2 and pages_seen[0] == ""
        assert pages_seen[1:] == ["2", "4"][: len(pages_seen) - 1]
    finally:
        srv.shutdown()


def test_read_refetches_after_midstream_truncation():
    """Mid-stream satellite: a 200 whose body dies halfway (connection
    reset / short body after Content-Length) must re-fetch the whole
    object under the retry budget instead of propagating — ``open()``
    alone retrying was not enough."""
    payload = bytes(range(256)) * 64
    attempts = {"n": 0}

    class Flaky(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            attempts["n"] += 1
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("ETag", '"v1-abc"')
            self.end_headers()
            if attempts["n"] == 1:
                # half the body, then drop the connection: the client's
                # read() sees IncompleteRead/ConnectionReset AFTER a
                # successful open
                self.wfile.write(payload[: len(payload) // 2])
                self.wfile.flush()
                self.connection.close()
            else:
                self.wfile.write(payload)

    srv, root = _serve(Flaky)
    try:
        store = object_store.HTTPStore(root)
        data, etag = store.read_with_info("blob.bin")
        assert data == payload
        assert attempts["n"] == 2  # one failed stream + one clean refetch
        assert etag == "v1-abc"  # fetch-time ETag rides along, unquoted
    finally:
        srv.shutdown()


def test_base_read_retries_midstream_reset_via_fake_store():
    """The chaos-hook-style unit variant: any ObjectStore whose open()
    succeeds but whose stream dies mid-read re-fetches through the SAME
    retry classification; non-retryable errors still fail fast."""
    import io as _io

    class FlakyStream:
        def __init__(self):
            self.closed = False

        def read(self):
            raise ConnectionResetError("chaos: reset mid-body")

        def close(self):
            self.closed = True

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self.close()

    class FlakyStore(object_store.ObjectStore):
        url = "fake://flaky"

        def __init__(self):
            self.opens = 0

        def open(self, name):
            self.opens += 1
            if self.opens == 1:
                return FlakyStream()
            return _io.BytesIO(b"the payload")

    st = FlakyStore()
    assert st.read("x") == b"the payload"
    assert st.opens == 2

    class NotFoundStore(object_store.ObjectStore):
        url = "fake://404"

        def __init__(self):
            self.opens = 0

        def open(self, name):
            self.opens += 1
            raise FileNotFoundError(name)  # permanent: no retry

    nf = NotFoundStore()
    with pytest.raises(FileNotFoundError):
        nf.read("x")
    assert nf.opens == 1

    # an open() that exhausted ITS retry budget propagates immediately —
    # the mid-stream loop must not multiply the two budgets by
    # re-entering open()'s backoff schedule
    from sparknet_tpu_torch.utils.retry import RetryBudgetExceeded

    class ExhaustedStore(object_store.ObjectStore):
        url = "fake://exhausted"

        def __init__(self):
            self.opens = 0

        def open(self, name):
            self.opens += 1
            raise RetryBudgetExceeded("gave up inside open()")

    ex = ExhaustedStore()
    with pytest.raises(RetryBudgetExceeded):
        ex.read("x")
    assert ex.opens == 1


def test_gcs_store_against_emulator(shard_dir):
    """GCSStore's JSON-list + alt=media fetch, against a minimal local
    emulation of the two endpoints."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/storage/v1/b/mybucket/o":
                q = urllib.parse.parse_qs(parsed.query)
                prefix = q.get("prefix", [""])[0]
                names = sorted(
                    f
                    for f in os.listdir(shard_dir)
                    if ("imagenet/" + f).startswith(prefix)
                )
                body = json.dumps(
                    {"items": [{"name": "imagenet/" + n} for n in names]}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif parsed.path.startswith("/storage/v1/b/mybucket/o/"):
                key = urllib.parse.unquote(
                    parsed.path.rsplit("/", 1)[-1]
                )  # imagenet/<name>
                fn = os.path.join(shard_dir, key.split("/", 1)[1])
                with open(fn, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        store = object_store.GCSStore(
            "gs://mybucket/imagenet",
            endpoint=f"http://127.0.0.1:{srv.server_address[1]}",
        )
        shards = [n for n in store.list("train.") if n.endswith(".tar")]
        assert len(shards) == 4
        data = store.read("train.txt")
        assert len(data.splitlines()) == 24
    finally:
        srv.shutdown()


def test_local_store_file_url_roundtrip(shard_dir):
    """file:// roots ride the same ObjectStore surface (the delivery
    watcher's local publish directories)."""
    assert object_store.is_object_store_url("file:///tmp/x")
    store = object_store.open_store("file://" + shard_dir)
    names = store.list("train.")
    assert [n for n in names if n.endswith(".tar")] == [
        "train.00000.tar", "train.00001.tar", "train.00002.tar",
        "train.00003.tar",
    ]
    with open(os.path.join(shard_dir, "train.txt"), "rb") as f:
        assert store.read("train.txt") == f.read()
    with pytest.raises(ValueError):
        object_store.open_store("/no/scheme")


# ----------------------------------------------------------------------
# chunk cache (tests/test_chunk_cache.py)


@pytest.fixture()
def counting_http(shard_dir):
    """A local HTTP store whose per-object GET counts are visible —
    the fetch-counting transport every I/O-flat assertion uses."""
    fetches = {}

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=shard_dir, **kw)

        def log_message(self, *a):
            pass

        def do_GET(self):
            name = urllib.parse.unquote(self.path.lstrip("/"))
            fetches[name] = fetches.get(name, 0) + 1
            return super().do_GET()

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", fetches
    finally:
        srv.shutdown()


def _tar_fetches(fetches):
    return sum(n for name, n in fetches.items() if name.endswith(".tar"))


def test_fetch_through_miss_then_hit(tmp_path, counting_http):
    root, fetches = counting_http
    store = object_store.open_store(root)
    cache = ChunkCache(str(tmp_path / "cache"))
    name = "train.00000.tar"
    a = cache.get(store, name)
    assert _tar_fetches(fetches) == 1 and cache.stats["misses"] == 1
    b = cache.get(store, name)
    assert _tar_fetches(fetches) == 1  # served locally, no network
    assert cache.stats["hits"] == 1
    assert a == b == store.read(name)  # byte identity, both paths
    # the entry's CRC manifest is on disk, checkpoint-style
    key = ChunkCache.key_for(store.url, name)
    with open(os.path.join(cache.root, "objects", key + ".meta.json")) as f:
        meta = json.load(f)
    assert meta["size"] == len(a)
    import zlib

    assert meta["crc32"] == zlib.crc32(a) & 0xFFFFFFFF
    assert meta["name"] == name and meta["url"] == store.url


def test_corrupt_entry_quarantined_and_refetched(tmp_path, counting_http):
    """The cache_corruption contract: a byte-flipped published entry
    (size unchanged — only the CRC can tell) is quarantined to
    ``*.corrupt`` and transparently refetched byte-identical."""
    root, fetches = counting_http
    store = object_store.open_store(root)
    cache = ChunkCache(str(tmp_path / "cache"))
    name = "train.00001.tar"
    clean = cache.get(store, name)
    entry = cache.entry_path(store.url, name)
    with open(entry, "r+b") as f:
        f.seek(len(clean) // 2)
        orig = f.read(8)
        f.seek(len(clean) // 2)
        f.write(bytes(b ^ 0xFF for b in orig))
    n_before = _tar_fetches(fetches)
    again = cache.get(store, name)
    assert again == clean  # the caller never sees the corruption
    assert _tar_fetches(fetches) == n_before + 1  # one refetch
    assert cache.stats["quarantined"] == 1
    corrupt = [
        f for f in os.listdir(os.path.join(cache.root, "objects"))
        if f.endswith(".corrupt")
    ]
    assert corrupt, "quarantined evidence must stay on disk"
    # and the refreshed entry verifies again
    assert cache.get(store, name) == clean
    assert cache.stats["quarantined"] == 1  # no second quarantine


def test_truncated_entry_detected_by_size(tmp_path, counting_http):
    root, fetches = counting_http
    store = object_store.open_store(root)
    cache = ChunkCache(str(tmp_path / "cache"))
    name = "train.00002.tar"
    clean = cache.get(store, name)
    entry = cache.entry_path(store.url, name)
    with open(entry, "r+b") as f:
        f.truncate(len(clean) // 2)
    assert cache.get(store, name) == clean
    assert cache.stats["quarantined"] == 1


def test_manifestless_chunk_is_a_miss_not_corruption(
    tmp_path, counting_http
):
    """Atomic-publish crash semantics: a kill between the chunk write
    and the manifest leaves a manifest-less chunk — the next read
    treats it as a plain miss (refetch + republish), never serves
    unverifiable bytes, and does not count a quarantine."""
    root, fetches = counting_http
    store = object_store.open_store(root)
    cache = ChunkCache(str(tmp_path / "cache"))
    name = "train.00003.tar"
    clean = cache.get(store, name)
    key = ChunkCache.key_for(store.url, name)
    os.unlink(os.path.join(cache.root, "objects", key + ".meta.json"))
    assert cache.get(store, name) == clean
    assert cache.stats["misses"] == 2  # refetched
    assert cache.stats["quarantined"] == 0
    # fully republished: the manifest is back
    assert os.path.exists(
        os.path.join(cache.root, "objects", key + ".meta.json")
    )


def test_lru_eviction_at_byte_budget(tmp_path, counting_http):
    root, fetches = counting_http
    store = object_store.open_store(root)
    shards = [n for n in store.list("") if n.endswith(".tar")]
    sizes = {n: len(store.read(n)) for n in shards}
    # budget fits two largest chunks + slack, not three
    budget = sizes[shards[0]] + sizes[shards[1]] + 16
    cache = ChunkCache(str(tmp_path / "cache"), byte_budget=budget)
    cache.get(store, shards[0])
    import time as _time

    _time.sleep(0.02)  # mtime resolution: make LRU order unambiguous
    cache.get(store, shards[1])
    _time.sleep(0.02)
    cache.get(store, shards[2])
    assert cache.stats["evictions"] >= 1
    assert cache.total_bytes() <= budget
    # the OLDEST entry went; the newest stayed
    assert cache.entry_path(store.url, shards[0]) is None
    assert cache.entry_path(store.url, shards[2]) is not None
    # re-reading the evicted shard is a clean miss
    n_before = _tar_fetches(fetches)
    cache.get(store, shards[0])
    assert _tar_fetches(fetches) == n_before + 1


def test_local_path_pins_entry_against_eviction(tmp_path, counting_http):
    """A path handed out by local_path() is held by a live consumer (DB
    reader, staged view symlink) — the LRU budget sweep must evict
    around it, never unlink it."""
    root, fetches = counting_http
    store = object_store.open_store(root)
    shards = [n for n in store.list("") if n.endswith(".tar")]
    sizes = {n: len(store.read(n)) for n in shards}
    # budget fits barely more than one chunk: every later publish
    # forces an eviction sweep
    budget = sizes[shards[0]] + 16
    cache = ChunkCache(str(tmp_path / "cache"), byte_budget=budget)
    pinned_path = cache.local_path(store, shards[0])
    import time as _time

    for s in shards[1:]:
        _time.sleep(0.02)
        cache.get(store, s)
    # the pinned entry (the LRU-oldest!) is still on disk and verifies
    assert os.path.exists(pinned_path)
    assert cache.get(store, shards[0]) == open(pinned_path, "rb").read()
    assert cache.stats["evictions"] >= 1  # others did evict


def test_caching_store_open_streams_without_pinning(
    tmp_path, counting_http
):
    """CachingStore.open() is the tar-streaming hot path: it must serve
    from memory, NOT pin the entry like local_path does — otherwise a
    whole-dataset stream pins everything and the --cache_bytes budget
    is inert."""
    import time as _time

    root, fetches = counting_http
    inner = object_store.open_store(root)
    shards = [n for n in inner.list("") if n.endswith(".tar")]
    sizes = {n: len(inner.read(n)) for n in shards}
    budget = sizes[shards[0]] + 16
    cache = ChunkCache(str(tmp_path / "cache"), byte_budget=budget)
    store = CachingStore(inner, cache)
    for s in shards:
        with store.open(s) as f:
            assert f.read() == inner.read(s)
        _time.sleep(0.02)
    # the budget stayed effective across the full stream
    assert cache.stats["evictions"] >= 1
    assert cache.total_bytes() <= budget


def test_stale_etag_and_size_invalidate(tmp_path):
    class VersionedStore:
        url = "fake://versioned"

        def __init__(self):
            self.version = "v1"
            self.reads = 0

        def read_with_info(self, name):
            self.reads += 1
            return f"payload-{self.version}".encode(), self.version

    st = VersionedStore()
    cache = ChunkCache(str(tmp_path / "cache"))
    assert cache.get(st, "obj") == b"payload-v1"
    # matching etag: still a hit
    assert cache.get(st, "obj", etag="v1") == b"payload-v1"
    assert st.reads == 1
    # upstream changed: a mismatched expected etag forces a refetch
    st.version = "v2"
    assert cache.get(st, "obj", etag="v2") == b"payload-v2"
    assert st.reads == 2
    # size mismatch invalidates the same way
    st.version = "v3-longer"
    assert cache.get(st, "obj", size=len(b"payload-v3-longer")) == (
        b"payload-v3-longer"
    )
    assert st.reads == 3


def test_caching_store_open_read_and_local_path(tmp_path, counting_http):
    root, fetches = counting_http
    inner = object_store.open_store(root)
    cache = ChunkCache(str(tmp_path / "cache"))
    store = CachingStore(inner, cache)
    assert store.list("train.") == inner.list("train.")
    name = "train.txt"
    direct_bytes = inner.read(name)  # uncached reference fetch
    n0 = fetches.get(name, 0)
    with store.open(name) as f:
        via_open = f.read()
    assert via_open == direct_bytes == store.read(name)
    p = store.local_path(name)
    assert os.path.exists(p) and open(p, "rb").read() == via_open
    # one network fetch total across open/read/local_path
    assert fetches.get(name, 0) == n0 + 1


def test_parse_bytes_units():
    pb = chunk_cache.parse_bytes
    assert pb(None) == 0 and pb("") == 0 and pb(0) == 0
    assert pb("1024") == 1024 and pb(2048) == 2048
    assert pb("512k") == 512 << 10
    assert pb("1.5M") == int(1.5 * (1 << 20))
    assert pb("8G") == 8 << 30
    assert pb("2GiB") == 2 << 30


# ----------------------------------------------------------------------
# retry (tests/test_retry.py)


def _http_error(code, headers=None):
    import email.message

    msg = email.message.Message()
    for k, v in (headers or {}).items():
        msg[k] = v
    return urllib.error.HTTPError("http://x/y", code, "boom", msg, None)


@pytest.mark.parametrize(
    "exc,expected",
    [
        (_http_error(500), True),
        (_http_error(502), True),
        (_http_error(503), True),
        (_http_error(429), True),
        (_http_error(408), True),
        (_http_error(404), False),
        (_http_error(403), False),
        (_http_error(400), False),
        (ConnectionResetError(), True),
        (ConnectionRefusedError(), True),
        (socket.timeout(), True),
        (TimeoutError(), True),
        (urllib.error.URLError(ConnectionResetError()), True),
        (urllib.error.URLError(socket.timeout()), True),
        (urllib.error.URLError("temporary failure in name resolution"), True),
        # DNS: EAI_AGAIN is the transient resolver failure urllib
        # actually produces; NXDOMAIN-class errors are permanent
        (
            urllib.error.URLError(
                socket.gaierror(socket.EAI_AGAIN, "try again")
            ),
            True,
        ),
        (socket.gaierror(socket.EAI_AGAIN, "try again"), True),
        (socket.gaierror(socket.EAI_NONAME, "not known"), False),
        (FileNotFoundError(2, "no such file"), False),
        (ValueError("nope"), False),
        (KeyError("nope"), False),
    ],
)
def test_is_retryable_classification(exc, expected):
    assert retry.is_retryable(exc) is expected


def test_retry_after_hint_parses_numeric_headers():
    assert retry.retry_after_hint(_http_error(429, {"Retry-After": "3"})) == 3.0
    assert retry.retry_after_hint(_http_error(503, {})) is None
    assert retry.retry_after_hint(ConnectionResetError()) is None
    # unparseable values are ignored, not fatal
    assert (
        retry.retry_after_hint(
            _http_error(429, {"Retry-After": "Fri, 01 Jan"})
        )
        is None
    )


def test_full_jitter_bounds():
    """Every delay is uniform in [0, min(cap, base*2^k)] — never above
    the exponential envelope, never negative."""
    policy = retry.RetryPolicy(base_s=0.1, cap_s=1.0)
    rng = random.Random(0)
    for attempt in range(12):
        env = min(1.0, 0.1 * 2 ** attempt)
        for _ in range(50):
            d = retry.backoff_s(attempt, policy, rng)
            assert 0.0 <= d <= env


def test_retry_call_transient_then_success():
    calls = {"n": 0}
    slept = []

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionResetError("flaky")
        return "ok"

    retries = []
    out = retry.retry_call(
        fn,
        policy=retry.RetryPolicy(max_attempts=5, base_s=0.01, cap_s=0.1),
        on_retry=lambda e, a, d: retries.append((type(e).__name__, a)),
        rng=random.Random(7),
        sleep=slept.append,
    )
    assert out == "ok" and calls["n"] == 3
    assert retries == [("ConnectionResetError", 0), ("ConnectionResetError", 1)]
    assert len(slept) == 2 and all(s >= 0 for s in slept)


def test_retry_call_permanent_error_propagates_immediately():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise FileNotFoundError(2, "gone")

    with pytest.raises(FileNotFoundError):
        retry.retry_call(fn, sleep=lambda s: None)
    assert calls["n"] == 1  # no second attempt for a permanent error


def test_retry_call_budget_exhaustion_raises_with_cause():
    def fn():
        raise ConnectionResetError("always")

    with pytest.raises(retry.RetryBudgetExceeded) as ei:
        retry.retry_call(
            fn,
            policy=retry.RetryPolicy(max_attempts=4, base_s=0.001),
            rng=random.Random(0),
            sleep=lambda s: None,
        )
    assert isinstance(ei.value.__cause__, ConnectionResetError)


def test_retry_call_sleep_budget_cuts_attempts_short():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise ConnectionResetError("always")

    # every backoff would exceed the (zero) sleep budget: exactly one
    # attempt runs, then the budget stops the schedule
    with pytest.raises(retry.RetryBudgetExceeded) as ei:
        retry.retry_call(
            fn,
            policy=retry.RetryPolicy(
                max_attempts=10, base_s=1.0, cap_s=1.0, budget_s=0.0
            ),
            rng=random.Random(1),
            sleep=lambda s: pytest.fail("must not sleep past the budget"),
        )
    assert calls["n"] == 1
    # the message reports attempts actually MADE, not the allowance
    assert "after 1 of 10 allowed attempts" in str(ei.value)


def test_retry_after_header_floors_the_backoff():
    calls = {"n": 0}
    slept = []

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise _http_error(429, {"Retry-After": "0.05"})
        return "ok"

    out = retry.retry_call(
        fn,
        policy=retry.RetryPolicy(max_attempts=3, base_s=1e-9, cap_s=1.0),
        rng=random.Random(0),
        sleep=slept.append,
    )
    assert out == "ok"
    assert slept and slept[0] >= 0.05  # the header, not the tiny jitter


class _StubHandler(http.server.BaseHTTPRequestHandler):
    failures = 0  # set per-test on the class
    requests = None

    def log_message(self, *a):
        pass

    def do_GET(self):
        cls = type(self)
        cls.requests.append(self.path)
        if cls.failures > 0:
            cls.failures -= 1
            self.send_response(503)
            self.send_header("Retry-After", "0")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if self.path.endswith("/missing"):
            body = b"not here"
            self.send_response(404)
        else:
            body = b"payload"
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


_FAST = retry.RetryPolicy(max_attempts=5, base_s=0.001, cap_s=0.01)


@pytest.fixture()
def stub_server():
    class Handler(_StubHandler):
        requests = []

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", Handler
    finally:
        srv.shutdown()


def test_get_heals_after_n_failures(stub_server):
    root, handler = stub_server
    handler.failures = 2
    with object_store._get(root + "/obj", policy=_FAST) as r:
        assert r.read() == b"payload"
    assert len(handler.requests) == 3  # 2 x 503 + the success


def test_get_permanent_4xx_fails_fast_and_closes_response(stub_server):
    root, handler = stub_server
    with pytest.raises(urllib.error.HTTPError) as ei:
        object_store._get(root + "/missing", policy=_FAST)
    assert ei.value.code == 404
    assert len(handler.requests) == 1  # no retry on a permanent error
    # the error IS the response object; _get must have closed it (the
    # response-leak fix: no half-open socket per failed attempt)
    assert ei.value.closed


def test_get_budget_exhaustion_on_persistent_5xx(stub_server):
    root, handler = stub_server
    handler.failures = 99
    with pytest.raises(retry.RetryBudgetExceeded) as ei:
        object_store._get(root + "/obj", policy=_FAST)
    assert isinstance(ei.value.__cause__, urllib.error.HTTPError)
    assert len(handler.requests) == _FAST.max_attempts


def test_fault_hook_faults_are_healed_by_the_retry_layer(stub_server):
    """The chaos harness's storage-fault seam: hook-raised transient
    errors retry exactly like real ones, and the hook sees every
    attempt."""
    root, handler = stub_server
    seen = []
    state = {"n": 2}

    def hook(url):
        seen.append(url)
        if state["n"] > 0:
            state["n"] -= 1
            raise ConnectionResetError("chaos says no")

    object_store.set_fault_hook(hook)
    try:
        with object_store._get(root + "/obj", policy=_FAST) as r:
            assert r.read() == b"payload"
    finally:
        object_store.set_fault_hook(None)
    assert len(seen) == 3  # 2 injected faults + the healed attempt
    assert len(handler.requests) == 1  # faults fired before the socket


def test_http_store_list_rides_the_retry_layer(stub_server, tmp_path):
    """HTTPStore.open goes through the retried _get: a store-level read
    survives transient 503s without the caller doing anything."""
    root, handler = stub_server
    handler.failures = 1
    store = object_store.HTTPStore(root)
    # monkeypatch-free: open() -> _get uses the env-default policy; the
    # stub recovers after one failure, well inside the default budget
    assert store.read("obj") == b"payload"
    assert handler.requests.count("/obj") >= 2


# ----------------------------------------------------------------------
# parity with the JAX package


def test_retry_schedule_and_classification_match_the_jax_package():
    """The same policy and seed give the JAX package's backoff schedule,
    delay for delay, and the same retryable/permanent verdicts."""
    for mod in (retry, jax_retry):
        assert mod.RetryPolicy().max_attempts == retry.RetryPolicy().max_attempts
    pol, jpol = (m.RetryPolicy(base_s=0.02, cap_s=0.5) for m in (retry, jax_retry))
    ours, theirs = random.Random(11), random.Random(11)
    got = [retry.backoff_s(a, pol, ours) for a in range(10)]
    want = [jax_retry.backoff_s(a, jpol, theirs) for a in range(10)]
    assert got == want
    errs = [_http_error(503), _http_error(404), ConnectionResetError(),
            FileNotFoundError(2, "x"), socket.timeout(),
            _http_error(429, {"Retry-After": "2"})]
    assert [retry.is_retryable(e) for e in errs] == [
        jax_retry.is_retryable(e) for e in errs]
    assert [retry.retry_after_hint(e) for e in errs] == [
        jax_retry.retry_after_hint(e) for e in errs]


def test_chunk_cache_entries_match_the_jax_package(tmp_path, counting_http):
    """Both packages' caches file the same object under the same key,
    with the same bytes and the same sidecar manifest (so one cache
    directory serves either), and both parse byte budgets alike."""
    root, _fetches = counting_http
    name = "train.00002.tar"
    ours = ChunkCache(str(tmp_path / "ours"))
    theirs = jax_chunk_cache.ChunkCache(str(tmp_path / "theirs"))
    a = ours.get(object_store.open_store(root), name)
    b = theirs.get(jax_object_store.open_store(root), name)
    assert a == b
    key = ChunkCache.key_for(root, name)
    assert key == jax_chunk_cache.ChunkCache.key_for(root, name)
    metas = []
    for c in (ours, theirs):
        with open(os.path.join(c.root, "objects", key + ".meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]
    # the port's cache reads the JAX package's directory as a hit
    again = ChunkCache(str(tmp_path / "theirs"))
    assert again.get(object_store.open_store(root), name) == b
    assert again.stats["hits"] == 1 and again.stats["misses"] == 0
    for spec in (None, "", 0, "1024", "512k", "1.5M", "8G", "2GiB"):
        assert chunk_cache.parse_bytes(spec) == jax_chunk_cache.parse_bytes(spec)
