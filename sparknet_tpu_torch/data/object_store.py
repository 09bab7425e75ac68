"""Object-store ingestion: list and stream bucket objects over HTTP.

The port of ``sparknet_tpu/data/object_store.py`` (stdlib only).

Reference: ``ImageNetLoader.scala:25-54`` lists S3 objects under a prefix
and streams tar shards straight off the network (no staging).  This
module gives ``ImageNetLoader`` the same capability for ``gs://``,
``s3://`` and plain ``http(s)://`` roots using nothing but the standard
library:

- **GCS** (``gs://bucket/prefix``): JSON listing API
  (``storage.googleapis.com/storage/v1/b/<bucket>/o``) + media download.
  Anonymous access — works for public buckets; private buckets need a
  fronting proxy or a mounted path.
- **S3** (``s3://bucket/prefix``): ListObjectsV2 XML + virtual-hosted
  GETs, likewise anonymous.
- **HTTP** (``http(s)://host/path``): objects fetched relative to the
  root; listing comes from an ``index.txt`` (one name per line) when
  present, else from parsing the server's HTML auto-index (what
  ``python -m http.server``, nginx ``autoindex`` and friends emit) —
  which is also how the offline test fixture works.

Objects stream: ``open()`` returns the socket-backed file object, so tar
shards decode as bytes arrive (``tarfile`` mode ``r|*``) — nothing is
staged on disk, matching the reference's
``TarArchiveInputStream(s3Object.getObjectContent)``.
"""

from __future__ import annotations

import html.parser
import io
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Optional, Tuple

from sparknet_tpu_torch.utils import retry as _retry

# Chaos/test seam: when set, called with the URL at the START of every
# fetch attempt (including retries) and may raise to simulate a storage
# fault — the retry layer then heals it exactly as it would a real one.
# Installed by ``runtime/chaos.py`` storage-fault injection.
_fault_hook: Optional[Callable[[str], None]] = None


def set_fault_hook(hook: Optional[Callable[[str], None]]) -> None:
    global _fault_hook
    _fault_hook = hook


def is_object_store_url(root: str) -> bool:
    return root.startswith(("gs://", "s3://", "http://", "https://", "file://"))


def open_store(root: str) -> "ObjectStore":
    if root.startswith("gs://"):
        return GCSStore(root)
    if root.startswith("s3://"):
        return S3Store(root)
    if root.startswith(("http://", "https://")):
        return HTTPStore(root)
    if root.startswith("file://"):
        return LocalStore(root)
    raise ValueError(f"not an object-store url: {root!r}")


class _MidStreamFailure(Exception):
    """Internal: the body read died AFTER a successful open() (reset /
    short body).  Tagging it lets ``read_with_info``'s retry loop
    re-fetch the object without re-entering ``open()``'s own retry
    budget for plain connection failures."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def _midstream_retryable(exc: BaseException) -> bool:
    return isinstance(exc, _MidStreamFailure) and _retry.is_retryable(
        exc.cause
    )


class ObjectStore:
    """list(prefix) -> relative object names; open(name) -> streaming
    binary file object; read(name) -> bytes.  Subclasses set ``url``
    (the root the store was opened with) — the chunk cache's content-
    address key (``data/chunk_cache.py``)."""

    url: str = ""

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def open(self, name: str):
        raise NotImplementedError

    def read(self, name: str) -> bytes:
        """Whole-object bytes, surviving MID-STREAM failures: ``open()``
        retries the connection, but a reset/truncation during the body
        read after a 200 used to propagate.  Here the whole
        open-and-drain attempt sits under one retry budget with the
        shared transient/permanent classification (``utils/retry.py``)
        — a connection that dies mid-body re-fetches the object."""
        return self.read_with_info(name)[0]

    def read_with_info(self, name: str) -> "Tuple[bytes, Optional[str]]":
        """(bytes, etag-or-None) with the same mid-stream retry
        contract as ``read`` — the chunk cache records the fetch-time
        ETag in its entry manifest.

        Retry layering: connection-level failures are ``open()``'s job
        (the HTTP stores' ``_get`` runs its own backoff loop); the loop
        HERE retries only failures of the body read after a successful
        open.  An open() failure propagates as-is — re-entering it from
        this loop would multiply the two retry budgets."""

        def attempt():
            f = self.open(name)  # its own retry budget; failures propagate
            try:
                with f:
                    data = f.read()
            except Exception as e:
                raise _MidStreamFailure(e) from e
            headers = getattr(f, "headers", None)
            etag = headers.get("ETag") if headers is not None else None
            return data, etag.strip('"') if etag else None

        try:
            return _retry.retry_call(
                attempt, retryable=_midstream_retryable
            )
        except _MidStreamFailure as e:
            raise e.cause  # non-retryable mid-stream error, unwrapped


def _get(
    url: str,
    timeout: float = 60.0,
    policy: Optional[_retry.RetryPolicy] = None,
):
    """GET with retry/backoff (``utils/retry.py``): 5xx/429/timeouts/
    connection-resets retry under the policy's budget; other 4xx
    propagate immediately.  An ``HTTPError`` is itself a live response
    object — it is drained and closed before classification so a failed
    attempt never leaks a half-open socket into the next one."""

    def attempt():
        if _fault_hook is not None:
            _fault_hook(url)
        req = urllib.request.Request(
            url, headers={"User-Agent": "sparknet-tpu"}
        )
        try:
            return urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            # the error IS the response: drain its (small) body and
            # close the socket so a failed attempt leaks nothing
            try:
                e.read()
            except OSError:
                pass
            e.close()
            raise

    return _retry.retry_call(attempt, policy=policy)


class _SplitUrl:
    def __init__(self, root: str, scheme: str):
        rest = root[len(scheme) :]
        self.bucket, _, self.prefix = rest.partition("/")
        self.prefix = self.prefix.rstrip("/")

    def full_key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name


class GCSStore(ObjectStore):
    def __init__(self, root: str, endpoint: str = None):
        import os

        self.url = root
        self._u = _SplitUrl(root, "gs://")
        # SPARKNET_GCS_ENDPOINT supports emulators/proxies (and tests)
        self._ep = endpoint or os.environ.get(
            "SPARKNET_GCS_ENDPOINT", "https://storage.googleapis.com"
        )

    def list(self, prefix: str = "") -> List[str]:
        full = self._u.full_key(prefix)
        out: List[str] = []
        page = ""
        while True:
            q = {"prefix": full}
            if page:
                q["pageToken"] = page
            url = (
                f"{self._ep}/storage/v1/b/{self._u.bucket}/o?"
                + urllib.parse.urlencode(q)
            )
            with _get(url) as r:
                body = json.load(r)
            for item in body.get("items", []):
                name = item["name"]
                if self._u.prefix:
                    name = name[len(self._u.prefix) + 1 :]
                out.append(name)
            page = body.get("nextPageToken", "")
            if not page:
                return sorted(out)

    def open(self, name: str):
        key = urllib.parse.quote(self._u.full_key(name), safe="")
        return _get(
            f"{self._ep}/storage/v1/b/{self._u.bucket}/o/{key}?alt=media"
        )


class S3Store(ObjectStore):
    def __init__(self, root: str, endpoint: str = None):
        import os

        self.url = root
        self._u = _SplitUrl(root, "s3://")
        self._ep = endpoint or os.environ.get(
            "SPARKNET_S3_ENDPOINT",
            f"https://{self._u.bucket}.s3.amazonaws.com",
        )

    def list(self, prefix: str = "") -> List[str]:
        import html
        import re

        full = self._u.full_key(prefix)
        out: List[str] = []
        token = ""
        while True:
            q = {"list-type": "2", "prefix": full}
            if token:
                q["continuation-token"] = token
            with _get(f"{self._ep}/?{urllib.parse.urlencode(q)}") as r:
                body = r.read().decode("utf-8", "replace")
            for key in re.findall(r"<Key>([^<]+)</Key>", body):
                # ListObjectsV2 bodies are XML: keys containing &, <,
                # quotes (or, with encoding-type=url nowhere in play,
                # any &#NN; reference) arrive ESCAPED — served verbatim
                # they 404 on fetch.  html.unescape covers the XML
                # predefined entities plus numeric references.
                name = html.unescape(key)
                if self._u.prefix:
                    name = name[len(self._u.prefix) + 1 :]
                out.append(name)
            m = re.search(
                r"<NextContinuationToken>([^<]+)</NextContinuationToken>", body
            )
            if not m:
                return sorted(out)
            # continuation tokens are XML text too (base64-ish but AWS
            # documents no alphabet — unescape defensively)
            token = html.unescape(m.group(1))

    def open(self, name: str):
        key = urllib.parse.quote(self._u.full_key(name))
        return _get(f"{self._ep}/{key}")


class _HrefParser(html.parser.HTMLParser):
    def __init__(self):
        super().__init__()
        self.hrefs: List[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            for k, v in attrs:
                if k == "href" and v and not v.startswith(("?", "#", "/")):
                    self.hrefs.append(urllib.parse.unquote(v))


class HTTPStore(ObjectStore):
    def __init__(self, root: str):
        self.url = root
        self._root = root.rstrip("/")

    def list(self, prefix: str = "") -> List[str]:
        # explicit manifest wins; else the server's HTML auto-index
        try:
            with _get(self._root + "/index.txt") as r:
                names = [
                    ln.strip()
                    for ln in r.read().decode().splitlines()
                    if ln.strip()
                ]
        except OSError:
            with _get(self._root + "/") as r:
                p = _HrefParser()
                p.feed(r.read().decode("utf-8", "replace"))
            names = [n for n in p.hrefs if not n.endswith("/")]
        return sorted(n for n in names if n.startswith(prefix))

    def open(self, name: str):
        return _get(f"{self._root}/{urllib.parse.quote(name)}")


class LocalStore(ObjectStore):
    """``file://`` roots behind the same ObjectStore surface — local
    fixtures (the chaos harness's chunk store) and mounted datasets get
    the uniform list/open/read API, including the cache front."""

    def __init__(self, root: str):
        import os

        self.url = root
        path = root[len("file://"):] if root.startswith("file://") else root
        self._root = os.path.abspath(path)

    def list(self, prefix: str = "") -> List[str]:
        import os

        out: List[str] = []
        for dirpath, _, files in os.walk(self._root):
            for fname in files:
                rel = os.path.relpath(
                    os.path.join(dirpath, fname), self._root
                )
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def open(self, name: str):
        import os

        return open(os.path.join(self._root, name), "rb")
