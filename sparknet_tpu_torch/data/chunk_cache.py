"""Host-local content-addressed chunk cache in front of the object stores.

The port of ``sparknet_tpu/data/chunk_cache.py`` (stdlib only).  The
training data plane reads object-store roots through it (the ImageNet
loader, the DB app's staged DB files, text corpora, ``cli train``'s
staged CIFAR directory), and the serving delivery watcher stages
verified snapshots through it.

SparkNet kept minibatch RDDs **resident** across iterations (PAPER.md
L7) so an epoch cost one pass over the network, ever.  The framework
deliberately streams tar shards "with no staging"
(``data/object_store.py``) — correct for a single pass, but a
multi-epoch run re-downloads every worker's partition every epoch:
network cost O(workers x epochs) where the reference paid O(1).
This module is the byte half of the fix (``data/shuffle.py`` is the
metadata half): a bounded, host-local,
content-addressed cache that fronts any ``ObjectStore``, so epoch 2+
reads the local disk and the network cost of a run is flat in epochs.

Design (deliberately the ``io/checkpoint.py`` integrity recipe, applied
to data):

- **content addressing**: an entry is keyed by
  ``sha1(store_url + name)``; the entry's sidecar manifest records the
  fetch-time ``etag``/``size`` so a changed upstream object (different
  etag or size, when the caller knows them) invalidates the entry
  instead of serving stale bytes.
- **CRC32 manifest, verified on every read**: each entry publishes
  ``<key>.meta.json`` with the chunk's CRC32 + size (exactly like
  snapshot manifests); every hit re-checksums the chunk before serving.
- **atomic publish, manifest last**: chunk bytes land via
  temp-file + ``os.replace``; the manifest publishes after — a crash
  mid-write can never leave a manifest vouching for half-written data.
- **quarantine + transparent refetch**: a hit that fails its CRC/size
  check (bit-rot, a torn write from a killed process) is renamed
  ``*.corrupt`` (forensics keep the evidence; the scan skips it) and
  the chunk is re-fetched from the backing store — the caller just
  sees bytes, one fetch slower (chaos-proved: ``runtime/chaos.py``
  ``cache_corruption``).
- **LRU eviction at a byte budget**: after each publish, oldest-read
  entries evict until the cache fits ``byte_budget`` (0 = unbounded);
  hits touch mtime so recency is on-disk state, shared across
  processes on the host.

Bit-identity contract: cached bytes are the exact bytes the store
streamed (tested), so ``RoundFeed``-fed training trajectories are
byte-identical with the cache on or off.

Telemetry: ``sparknet_cache_{hits,misses,evictions,bytes}_total``
through the TrainingMetrics the app installed (``obs.training_metrics``),
the per-cache ``stats`` counters, ``cache_read``/``cache_fetch`` spans
(cat ``cache``) on the tracer, and a ``cache_quarantine`` instant per
corrupt entry.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import List, Optional, Tuple

from sparknet_tpu_torch import obs
# ONE checksum convention across the framework: the cache's sidecar
# manifests use the same masked-CRC32 helper the snapshot manifests and
# the serving delivery watcher verify with.
from sparknet_tpu_torch.io.checkpoint import crc32_bytes

__all__ = [
    "ChunkCache", "CachingStore", "parse_bytes", "atomic_write_bytes",
]

_CHUNK_SUFFIX = ".chunk"
_META_SUFFIX = ".meta.json"

_UNITS = {
    "k": 1 << 10, "kb": 1 << 10, "kib": 1 << 10,
    "m": 1 << 20, "mb": 1 << 20, "mib": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30, "gib": 1 << 30,
    "t": 1 << 40, "tb": 1 << 40, "tib": 1 << 40,
}


def parse_bytes(spec) -> int:
    """``"512M"``/``"8g"``/``"1073741824"`` -> bytes (0 = unbounded).
    CLI-flag helper for ``--cache_bytes``."""
    if spec is None:
        return 0
    if isinstance(spec, (int, float)):
        return int(spec)
    s = str(spec).strip().lower()
    if not s:
        return 0
    for unit in sorted(_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * _UNITS[unit])
    return int(float(s))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Publish ``data`` at ``path`` via temp-file + ``os.replace``: a
    kill mid-write never leaves a partial file under the final name
    (the ``io/checkpoint._atomic`` semantics, shared by the cache's
    chunk/manifest publishes and the chaos harness's chunk store)."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class CacheCorrupt(RuntimeError):
    """Internal: a cache entry failed its CRC/size verification."""


class ChunkCache:
    """Bounded content-addressed byte cache rooted at a directory.

    ``get(store, name)`` is the fetch-through read: serve verified
    local bytes on a hit, else fetch via ``store.read_with_info`` (the
    retry-hardened object-store path), publish atomically, and serve.
    ``local_path`` additionally pins a verified on-disk path (for
    consumers that need a *file*, e.g. record-DB readers).
    Thread-safe; cross-process safe by construction (atomic renames;
    a double-fetch race publishes identical content twice)."""

    def __init__(self, root: str, byte_budget: int = 0):
        self.root = os.path.abspath(root)
        self.byte_budget = int(byte_budget)
        self._dir = os.path.join(self.root, "objects")
        os.makedirs(self._dir, exist_ok=True)
        # the instance lock guards bookkeeping (stats, pin set, key-lock
        # table, eviction scans) — never a network fetch.  Per-KEY locks
        # serialize work on one entry, so a slow miss on chunk A never
        # blocks a local-disk hit on chunk B.
        self._lock = threading.Lock()
        self._key_locks: dict = {}
        # keys whose on-disk path was handed out via local_path():
        # consumers hold the real file, so LRU eviction must not unlink
        # it from under them (pinned for this instance's lifetime)
        self._pinned: set = set()
        # per-instance accounting (the obs counters are process-wide;
        # benches/tests read these)
        self.stats = {
            "hits": 0, "misses": 0, "evictions": 0, "quarantined": 0,
            "bytes_from_cache": 0, "bytes_fetched": 0,
        }
        # advisory running byte total: publishes add, the (authoritative,
        # rescanning) eviction sweep resyncs it — so a budgeted cold fill
        # scans the objects dir only when actually over budget instead of
        # once per publish (O(N), not O(N^2), in stat calls).  Drift is
        # only ever upward (republish over an existing key), which costs
        # a spurious scan, never a missed eviction.
        self._approx_bytes = self.total_bytes() if self.byte_budget else 0

    def _count(self, stat: str, n: int = 1) -> None:
        with self._lock:
            self.stats[stat] += n

    def _key_lock(self, key: str) -> threading.Lock:
        with self._lock:
            return self._key_locks.setdefault(key, threading.Lock())

    # -- keying ---------------------------------------------------------
    @staticmethod
    def key_for(url: str, name: str) -> str:
        return hashlib.sha1(
            f"{url}\n{name}".encode("utf-8", "surrogatepass")
        ).hexdigest()

    def _paths(self, key: str) -> Tuple[str, str]:
        return (
            os.path.join(self._dir, key + _CHUNK_SUFFIX),
            os.path.join(self._dir, key + _META_SUFFIX),
        )

    def entry_path(self, url: str, name: str) -> Optional[str]:
        """The published chunk path for (url, name) if cached (chaos /
        forensics seam — not a verified read)."""
        p, _ = self._paths(self.key_for(url, name))
        return p if os.path.exists(p) else None

    # -- verified local read -------------------------------------------
    def _verify(self, chunk_path: str, meta_path: str) -> bytes:
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            want_crc = int(meta["crc32"])
            want_size = int(meta["size"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise CacheCorrupt(f"{meta_path}: unreadable manifest: {e}")
        try:
            with open(chunk_path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise CacheCorrupt(f"{chunk_path}: unreadable chunk: {e}")
        if len(data) != want_size:
            raise CacheCorrupt(
                f"{chunk_path}: truncated ({len(data)} bytes, manifest "
                f"says {want_size})"
            )
        crc = crc32_bytes(data)
        if crc != want_crc:
            raise CacheCorrupt(
                f"{chunk_path}: CRC32 mismatch ({crc:#x} vs manifest "
                f"{want_crc:#x})"
            )
        return data

    def _meta(self, key: str) -> Optional[dict]:
        _, meta_path = self._paths(key)
        try:
            with open(meta_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _quarantine(self, key: str, name: str) -> None:
        """Rename a corrupt entry's files ``*.corrupt`` (evidence kept,
        scan skipped) and count it — the snapshot-quarantine contract,
        applied to data chunks."""
        chunk_path = self._paths(key)[0]
        try:
            gone = os.path.getsize(chunk_path)
        except OSError:
            gone = 0
        for p in self._paths(key):
            if os.path.exists(p):
                os.replace(p, p + ".corrupt")
        with self._lock:
            self._approx_bytes = max(0, self._approx_bytes - gone)
        self._count("quarantined")
        obs.instant("cache_quarantine", cat="fault", chunk=name)

    # -- publish --------------------------------------------------------
    def _publish(self, key: str, name: str, url: str, data: bytes,
                 etag: Optional[str]) -> str:
        chunk_path, meta_path = self._paths(key)
        atomic_write_bytes(chunk_path, data)
        # manifest last: a kill between the chunk and here leaves a
        # manifest-less chunk the next read treats as a miss, never a
        # manifest vouching for torn bytes
        meta = {
            "url": url, "name": name, "etag": etag, "size": len(data),
            "crc32": crc32_bytes(data),
        }
        atomic_write_bytes(meta_path, json.dumps(meta).encode())
        with self._lock:
            self._approx_bytes += len(data)
        self._evict_to_budget(keep=key)
        return chunk_path

    # -- eviction -------------------------------------------------------
    def _entries(self) -> List[Tuple[float, int, str]]:
        """(mtime, chunk_bytes, key) per published entry."""
        out = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return out
        for fname in names:
            if not fname.endswith(_CHUNK_SUFFIX):
                continue
            key = fname[: -len(_CHUNK_SUFFIX)]
            try:
                st = os.stat(os.path.join(self._dir, fname))
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, key))
        return out

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def _evict_to_budget(self, keep: Optional[str] = None) -> None:
        if self.byte_budget <= 0:
            return
        tm = obs.training_metrics()
        with self._lock:
            if self._approx_bytes <= self.byte_budget:
                return  # cheap common case: no directory scan
            pinned = set(self._pinned)
        entries = sorted(self._entries())  # oldest-read first (LRU)
        total = sum(size for _, size, _ in entries)
        for _, size, key in entries:
            if total <= self.byte_budget:
                break
            if key == keep or key in pinned:
                # never evict the entry being served, nor one whose
                # on-disk path local_path() handed to a consumer (a DB
                # reader / staged view holds the real file)
                continue
            for p in self._paths(key):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            total -= size
            self._count("evictions")
            if tm is not None:
                tm.cache_evictions.inc()
        with self._lock:
            self._approx_bytes = total  # resync to the authoritative scan

    def clear(self) -> int:
        """Drop every published entry (the cold-cache chaos fault /
        operator reset); quarantined ``*.corrupt`` files stay for
        forensics.  Returns the number of entries dropped."""
        dropped = 0
        for _, _, key in self._entries():
            for p in self._paths(key):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            dropped += 1
        with self._lock:
            self._approx_bytes = 0
        return dropped

    # -- the fetch-through read ----------------------------------------
    def _fetch(self, store, name: str, url: str,
               key: str) -> Tuple[bytes, str]:
        with obs.span("cache_fetch", cat="cache", chunk=name):
            data, etag = _read_with_info(store, name)
        self._count("bytes_fetched", len(data))
        path = self._publish(key, name, url, data, etag)
        return data, path

    def get(
        self,
        store,
        name: str,
        url: Optional[str] = None,
        etag: Optional[str] = None,
        size: Optional[int] = None,
    ) -> bytes:
        """Fetch-through read: verified cached bytes, or fetch+publish.
        ``etag``/``size``, when the caller knows them, invalidate a
        stale entry (upstream object changed) before it is served."""
        data, _ = self._get_impl(store, name, url, etag, size)
        return data

    def local_path(
        self,
        store,
        name: str,
        url: Optional[str] = None,
        etag: Optional[str] = None,
        size: Optional[int] = None,
    ) -> str:
        """Like ``get`` but returns the verified on-disk chunk path
        (for consumers that need a file: DB readers, mmap).  The entry
        is PINNED against LRU eviction for this cache instance's
        lifetime — the consumer holds the real file, so the budget
        sweep must not unlink it from under them.  Streaming readers
        should use ``get`` (or ``CachingStore.open``) instead: those
        never pin, so the byte budget stays effective."""
        _, path = self._get_impl(store, name, url, etag, size, pin=True)
        return path

    def _get_impl(self, store, name, url, etag, size, pin=False):
        url = url if url is not None else getattr(store, "url", "")
        key = self.key_for(url, name)
        chunk_path, _meta_path = self._paths(key)
        tm = obs.training_metrics()
        # per-KEY serialization: two readers of the same chunk never
        # double-fetch in-process, while a miss on one chunk (network-
        # bound, possibly seconds) never blocks a hit on another.  A
        # pin lands INSIDE this section: between serve and pin no
        # publish-triggered eviction can unlink the served path.
        with obs.span("cache_read", cat="cache", chunk=name):
            with self._key_lock(key):
                if pin:
                    with self._lock:
                        self._pinned.add(key)
                meta = self._meta(key)
                stale = meta is not None and (
                    (etag is not None and meta.get("etag") not in (None, etag))
                    or (size is not None and int(meta.get("size", -1)) != size)
                )
                if meta is not None and not stale:
                    try:
                        data = self._verify(chunk_path, _meta_path)
                        self._count("hits")
                        self._count("bytes_from_cache", len(data))
                        if tm is not None:
                            tm.cache_hits.inc()
                            tm.cache_bytes.labels("hit").inc(len(data))
                        try:  # LRU recency rides the filesystem mtime
                            os.utime(chunk_path)
                        except OSError:
                            pass
                        return data, chunk_path
                    except CacheCorrupt:
                        # quarantine the evidence, then fall through to
                        # a transparent refetch — the caller never sees
                        # the corruption
                        self._quarantine(key, name)
                self._count("misses")
                if tm is not None:
                    tm.cache_misses.inc()
                data, path = self._fetch(store, name, url, key)
                if tm is not None:
                    tm.cache_bytes.labels("miss").inc(len(data))
                return data, path


def _read_with_info(store, name: str):
    """(bytes, etag) through the store's hardened read path.  Stores
    exposing ``read_with_info`` (the HTTP-backed ones) return the
    fetch-time ETag for the entry manifest; anything else degrades to
    ``read`` with no etag."""
    fn = getattr(store, "read_with_info", None)
    if fn is not None:
        return fn(name)
    return store.read(name), None


class CachingStore:
    """An ``ObjectStore`` wrapper that serves ``open``/``read`` through
    a ``ChunkCache``.  Listings stay live (cheap, freshness matters);
    object bytes are cached.  Drop-in: same duck-typed surface
    ``ImageNetLoader`` consumes."""

    def __init__(self, inner, cache: ChunkCache):
        self.inner = inner
        self.cache = cache
        self.url = getattr(inner, "url", "")

    def list(self, prefix: str = ""):
        return self.inner.list(prefix)

    def open(self, name: str):
        """A binary stream over the verified cached bytes.  Served from
        memory (``get``), NOT from a pinned file path: the tar-
        streaming hot path must leave the LRU byte budget effective —
        ``local_path`` pins, ``open`` must not."""
        import io as _io

        return _io.BytesIO(self.read(name))

    def read(self, name: str) -> bytes:
        return self.cache.get(self.inner, name, url=self.url)

    def read_with_info(self, name: str):
        data = self.read(name)
        meta = self.cache._meta(self.cache.key_for(self.url, name)) or {}
        return data, meta.get("etag")

    def local_path(self, name: str) -> str:
        return self.cache.local_path(self.inner, name, url=self.url)
