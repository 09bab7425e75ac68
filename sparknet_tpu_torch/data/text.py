"""Text data plane for the transformer LM: tokenizer, corpus, windows.

The port's own copy of ``sparknet_tpu/data/text.py`` (pure numpy and
hashlib there too):

- **ByteTokenizer** — byte-level tokenization (vocab = 256, the
  tokenizer IS the identity over utf-8 bytes).
- **write_synthetic_corpus / load_corpus** — a seeded synthetic corpus
  of ``doc_NNNN.txt`` files, and the documents (name-sorted) of a local
  directory or of an object-store URL, fetched through the chunk
  cache.
- **TextWindowSampler** — windows drawn as a pure function of ``(seed,
  worker, absolute iter)`` via sha256-stable seeding, so the cursor IS
  the absolute iteration index; the windows are bit-identical to the
  JAX sampler's for the same corpus and arguments.
"""

from __future__ import annotations

import copy
import hashlib
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

DOC_SEP = b"\n"

class ByteTokenizer:
    """Byte-level tokenizer: token ids ARE byte values (vocab 256)."""

    vocab_size = 256

    @staticmethod
    def encode(text: Union[str, bytes]) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return np.frombuffer(data, dtype=np.uint8).copy()

    @staticmethod
    def decode(ids) -> str:
        arr = np.asarray(ids)
        return bytes(arr.astype(np.uint8).tolist()).decode(
            "utf-8", errors="replace"
        )


# a tiny closed vocabulary with strong short-range structure: a byte LM
# reduces loss fast on it, and the seeded draw makes every corpus
# reproducible byte for byte
_SYNTH_WORDS = (
    "the", "spark", "net", "tensor", "worker", "round", "average",
    "gradient", "ring", "shard", "token", "stream", "cache", "journal",
)


def write_synthetic_corpus(
    out_dir: str, num_docs: int = 8, words_per_doc: int = 400,
    seed: int = 0,
) -> List[str]:
    """Write a seeded synthetic text corpus as ``doc_NNNN.txt`` files;
    returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for d in range(int(num_docs)):
        words = [
            _SYNTH_WORDS[int(rng.randint(len(_SYNTH_WORDS)))]
            for _ in range(int(words_per_doc))
        ]
        path = os.path.join(out_dir, f"doc_{d:04d}.txt")
        with open(path, "w") as f:
            f.write(" ".join(words) + "\n")
        paths.append(path)
    return paths


def load_corpus(root: str, cache_dir: Optional[str] = None, cache_bytes=0,
                suffix: str = ".txt") -> List[bytes]:
    """Documents (as bytes, name-sorted) under ``root``.

    An object-store URL (gs:// s3:// http(s):// file://) lists through
    ``object_store.open_store`` and fetches every document through a
    ``ChunkCache``: CRC-verified local entries, refetched only when
    missing, evicted or corrupt.  A stable ``cache_dir`` makes re-runs
    I/O-free after the first pass; the default is a fresh temporary
    directory (verified fetches, no reuse across runs).  A local path
    reads the files directly."""
    from sparknet_tpu_torch.data import object_store

    if object_store.is_object_store_url(root):
        from sparknet_tpu_torch.data import chunk_cache

        store = object_store.open_store(root)
        cache = chunk_cache.ChunkCache(
            cache_dir or tempfile.mkdtemp(prefix="sparknet_text_cache_"),
            byte_budget=chunk_cache.parse_bytes(cache_bytes),
        )
        names = sorted(n for n in store.list("") if n.endswith(suffix))
        if not names:
            raise FileNotFoundError(f"no {suffix} objects under {root!r}")
        return [cache.get(store, n) for n in names]
    names = sorted(n for n in os.listdir(root) if n.endswith(suffix))
    if not names:
        raise FileNotFoundError(f"no {suffix} files under {root!r}")
    docs = []
    for n in names:
        with open(os.path.join(root, n), "rb") as f:
            docs.append(f.read())
    return docs


def _draw(seed: int, worker: int, it: int, bound: int, count: int) -> np.ndarray:
    """``count`` ints in [0, bound), pure in (seed, worker, it): nearby
    (worker, iter) pairs decorrelate fully and every host derives the
    same windows locally."""
    digest = hashlib.sha256(
        f"sparknet-text:{int(seed)}:{int(worker)}:{int(it)}".encode()
    ).digest()
    rng = np.random.RandomState(int.from_bytes(digest[:4], "big"))
    return rng.randint(0, bound, size=int(count))


class TextWindowSampler:
    """Seeded document->window sampler with ABSOLUTE-ITER cursors.

    ``window_at(it)`` is a pure function: ``batch_size`` window starts
    drawn from the separator-joined byte stream, each giving ``tokens =
    stream[p : p+T]`` / ``targets = stream[p+1 : p+T+1]`` (next-token
    supervision)."""

    def __init__(
        self,
        docs: Sequence[bytes],
        seq_len: int,
        batch_size: int,
        seed: int = 0,
        worker: int = 0,
        sep: bytes = DOC_SEP,
    ):
        if not docs:
            raise ValueError("empty corpus")
        stream = sep.join(bytes(d) for d in docs) + sep
        self.stream = np.frombuffer(stream, dtype=np.uint8)
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.worker = int(worker)
        self.num_docs = len(docs)
        if len(self.stream) < self.seq_len + 1:
            raise ValueError(
                f"corpus has {len(self.stream)} bytes, need at least "
                f"seq_len+1 = {self.seq_len + 1} for one window"
            )

    def for_worker(self, worker: int) -> "TextWindowSampler":
        """A sibling sampler drawing ``worker``'s windows off the SAME
        byte stream (one corpus copy, N cursors)."""
        sib = copy.copy(self)  # shares self.stream (read-only)
        sib.worker = int(worker)
        return sib

    @property
    def num_positions(self) -> int:
        return len(self.stream) - self.seq_len

    def window_at(self, it: int) -> Dict[str, np.ndarray]:
        """One iteration's batch ``{tokens, targets}`` (B, T) int32 at
        absolute iter ``it``."""
        starts = _draw(
            self.seed, self.worker, it, self.num_positions, self.batch_size
        )
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None, :]
        win = self.stream[idx].astype(np.int32)
        return {"tokens": win[:, :-1], "targets": win[:, 1:]}

    def window_for_round(self, r: int, tau: int) -> Dict[str, np.ndarray]:
        """One round's tau-deep window ``{blob: (tau, B, T)}`` covering
        absolute iters ``r*tau .. r*tau+tau-1`` (stack per worker with
        ``stack_windows``)."""
        its = [self.window_at(r * tau + t) for t in range(int(tau))]
        return {
            k: np.stack([w[k] for w in its]) for k in ("tokens", "targets")
        }

    def cursor_for_iter(self, it: int) -> Dict[str, int]:
        """The text cursor at absolute iter ``it``, with the corpus
        geometry a restore checks."""
        return {
            "text_iter": int(it),
            "stream_bytes": int(len(self.stream)),
            "num_docs": int(self.num_docs),
            "seq_len": int(self.seq_len),
            "batch_size": int(self.batch_size),
            "seed": int(self.seed),
        }

    def verify_cursor(self, cursor: Dict) -> None:
        """Fail loudly when a cursor disagrees with this sampler's
        geometry — another corpus or window shape would re-deal windows
        silently."""
        mine = self.cursor_for_iter(int(cursor.get("text_iter", 0)))
        for k in ("stream_bytes", "num_docs", "seq_len", "batch_size",
                  "seed"):
            if k in cursor and int(cursor[k]) != mine[k]:
                raise ValueError(
                    f"text cursor mismatch on {k!r}: the cursor has "
                    f"{int(cursor[k])}, this corpus/sampler has "
                    f"{mine[k]} — not the same job"
                )
