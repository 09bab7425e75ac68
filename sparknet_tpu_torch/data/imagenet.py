"""ImageNet ingestion: shard listing, label map, tar streaming, JPEG
decode and force-resize with corrupt-image dropping, minibatch packing,
and the streaming mean image.

The port's own copy of ``sparknet_tpu/data/imagenet.py`` (numpy, tarfile
and PIL only; reference: ``ImageNetLoader.scala:25-86``,
``ScaleAndConvert.scala:16-91``, ``ComputeMean.scala:40-76``).  The root
is a local directory or an object-store URL (``gs://``, ``s3://``,
``http(s)://``, ``file://``, ``data/object_store.py``); with
``cache_dir`` the store is fronted by the host-local chunk cache
(``data/chunk_cache.py``), so epoch 1 fills it and later epochs read
local disk.  ``partitions(epoch=...)`` deals the shards through the
cross-epoch shuffle (``data/shuffle.py``).

Minibatches stay uint8 at full size; the crop, mirror and mean
subtraction run on the device (``data/transforms.py``).  PIL is imported
only inside the JPEG decode and the synthetic writer.
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ImageNetLoader",
    "ScaleAndConvert",
    "compute_mean",
    "reduce_mean_sums",
    "write_synthetic_imagenet",
]

class ImageNetLoader:
    """Lists the data shards under a root (a directory or an object-store
    URL) and streams ``(jpeg_bytes, label)`` pairs out of tar shards or
    loose image files; ``prefix`` filtering matches the reference's
    ListObjects-with-prefix (``ImageNetApp.scala:60-63``).  With
    ``cache_dir`` an object store's bytes are read through a
    ``ChunkCache`` of ``cache_bytes`` (0 = unbounded), ``self.cache``."""

    IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, cache_dir: Optional[str] = None,
                 cache_bytes: int = 0):
        from sparknet_tpu_torch.data import chunk_cache, object_store

        self.root = root
        self._store = (object_store.open_store(root)
                       if object_store.is_object_store_url(root) else None)
        self.cache = None
        if self._store is not None and cache_dir:
            self.cache = chunk_cache.ChunkCache(cache_dir,
                                                byte_budget=cache_bytes)
            self._store = chunk_cache.CachingStore(self._store, self.cache)

    def list_shards(self, prefix: str = "") -> List[str]:
        """All tar shards (or loose images) whose path relative to root
        starts with ``prefix``, sorted."""
        if self._store is not None:
            return [n for n in self._store.list(prefix)
                    if n.endswith(".tar") or n.lower().endswith(self.IMAGE_EXTS)]
        out: List[str] = []
        for dirpath, _, files in os.walk(self.root):
            for fname in files:
                full = os.path.join(dirpath, fname)
                if not os.path.relpath(full, self.root).startswith(prefix):
                    continue
                if fname.endswith(".tar") or fname.lower().endswith(
                    self.IMAGE_EXTS
                ):
                    out.append(full)
        return sorted(out)

    def load_labels(self, labels_path: str) -> Dict[str, int]:
        """``train.txt``-format lines ("<path> <label>") as a
        basename -> label map (ImageNetLoader.scala:41-54)."""
        if self._store is not None:
            lines = self._store.read(labels_path).decode().splitlines()
        else:
            with open(os.path.join(self.root, labels_path), "r") as f:
                lines = f.read().splitlines()
        labels: Dict[str, int] = {}
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            labels[os.path.basename(parts[0])] = int(parts[-1])
        return labels

    def iter_shard(
        self, shard_path: str, labels: Dict[str, int]
    ) -> Iterator[Tuple[bytes, int]]:
        """Stream ``(image_bytes, label)`` out of one shard, keyed into the
        label map by basename; files absent from the map are dropped.  An
        object store's tar shard is decoded as a stream
        (``TarArchiveInputStream(getObjectContent)``)."""
        if shard_path.endswith(".tar"):
            if self._store is not None:
                stream = self._store.open(shard_path)
                tar = tarfile.open(fileobj=stream, mode="r|*")
            else:
                stream = None
                tar = tarfile.open(shard_path, "r")
            with tar:
                for entry in tar:
                    if not entry.isfile():
                        continue
                    name = os.path.basename(entry.name)
                    if name not in labels:
                        continue
                    f = tar.extractfile(entry)
                    if f is None:
                        continue
                    yield f.read(), labels[name]
            if stream is not None:
                stream.close()
        else:
            name = os.path.basename(shard_path)
            if name in labels:
                if self._store is not None:
                    yield self._store.read(shard_path), labels[name]
                else:
                    with open(shard_path, "rb") as f:
                        yield f.read(), labels[name]

    def partitions(
        self,
        prefix: str,
        labels_path: str,
        num_parts: Optional[int] = None,
        epoch: Optional[int] = None,
        shuffle_seed: int = 0,
    ) -> List[Iterator[Tuple[bytes, int]]]:
        """Shards dealt into ``num_parts`` lazy partitions (default one
        per shard): round-robin (``shards[worker::n]``) with
        ``epoch=None``, else the seeded assignment of
        ``shuffle.assign(shards, n, shuffle_seed, epoch)``, pure in
        ``(shuffle_seed, epoch)``: a reshuffle between epochs moves only
        the table, and through a chunk cache repeat reads stay local."""
        shards = self.list_shards(prefix)
        if not shards:
            raise FileNotFoundError(
                f"no shards under {self.root!r} matching prefix {prefix!r}"
            )
        labels = self.load_labels(labels_path)
        n = num_parts or len(shards)
        if epoch is None:
            assignment = [shards[w::n] for w in range(n)]
        else:
            from sparknet_tpu_torch.data import shuffle

            assignment = shuffle.assign(shards, n, seed=shuffle_seed,
                                        epoch=epoch)

        def part(worker: int) -> Iterator[Tuple[bytes, int]]:
            for shard in assignment[worker]:
                yield from self.iter_shard(shard, labels)

        return [part(w) for w in range(n)]


class ScaleAndConvert:
    """JPEG decode + force-resize + minibatch packing
    (ScaleAndConvert.scala:16-70): images force-resized to (width,
    height) bilinearly, undecodable ones dropped, each partition packed
    into fixed-size batches with the ragged tail dropped."""

    def __init__(self, batch_size: int, height: int, width: int):
        self.batch_size = batch_size
        self.height = height
        self.width = width

    def convert_image(self, data: bytes) -> Optional[np.ndarray]:
        """(3, H, W) uint8 planar RGB, or None for an image that cannot be
        decoded."""
        try:
            from PIL import Image

            with Image.open(io.BytesIO(data)) as im:
                im = im.convert("RGB").resize(
                    (self.width, self.height), Image.BILINEAR
                )
                arr = np.asarray(im, dtype=np.uint8)  # (H, W, 3)
        except Exception:  # the corrupt-drop contract: any decode failure
            return None
        return np.ascontiguousarray(arr.transpose(2, 0, 1))

    def make_minibatches(
        self, pairs: Iterable[Tuple[bytes, int]]
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """A partition's ``(bytes, label)`` stream as ``((B, 3, H, W)
        uint8, (B,) int32)`` minibatches."""
        images: List[np.ndarray] = []
        labels: List[int] = []
        for data, label in pairs:
            arr = self.convert_image(data)
            if arr is None:
                continue
            images.append(arr)
            labels.append(label)
            if len(images) == self.batch_size:
                yield np.stack(images), np.asarray(labels, np.int32)
                images, labels = [], []


def compute_mean(
    minibatches: Iterable[Tuple[np.ndarray, np.ndarray]],
    return_sum: bool = False,
):
    """The mean image over uint8 minibatches with an int64 accumulator
    (ComputeMean.scala:42-49): ``(mean float32 (3, H, W), count)``, or
    with ``return_sum`` the raw ``(sum int64, count)`` for a reduction."""
    total: Optional[np.ndarray] = None
    count = 0
    for images, _ in minibatches:
        s = images.astype(np.int64).sum(axis=0)
        total = s if total is None else total + s
        count += len(images)
    if total is None:
        raise ValueError("no minibatches given")
    if return_sum:
        return total, count
    return (total.astype(np.float64) / count).astype(np.float32), count


def reduce_mean_sums(
    partials: Sequence[Tuple[np.ndarray, int]]
) -> np.ndarray:
    """Combine per-partition ``(sum, count)`` pairs: the elementwise add
    and divide of ComputeMean.scala:51-57."""
    total = sum(s.astype(np.int64) for s, _ in partials)
    count = sum(c for _, c in partials)
    if count == 0:
        raise ValueError("no data in any partition")
    return (total.astype(np.float64) / count).astype(np.float32)


def write_synthetic_imagenet(
    root: str,
    num_shards: int = 2,
    images_per_shard: int = 24,
    classes: int = 4,
    size_range: Tuple[int, int] = (40, 96),
    labels_file: str = "train.txt",
    shard_prefix: str = "train.",
    corrupt_every: int = 0,
    seed: int = 0,
) -> None:
    """Tar shards of real JPEGs and their label file, as the JAX
    package's writer makes them from the same seed: class-dependent
    channel shifts, random sizes (exercising the force-resize), and with
    ``corrupt_every`` > 0 truncated entries (exercising the drop)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines: List[str] = []
    idx = 0
    for s in range(num_shards):
        shard_path = os.path.join(root, f"{shard_prefix}{s:05d}.tar")
        with tarfile.open(shard_path, "w") as tar:
            for i in range(images_per_shard):
                label = int(rng.randint(classes))
                h = int(rng.randint(*size_range))
                w = int(rng.randint(*size_range))
                arr = rng.randint(0, 100, (h, w, 3)).astype(np.uint8)
                arr[..., label % 3] += np.uint8(60 + 20 * (label // 3))
                name = f"img_{idx:06d}.jpg"
                idx += 1
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=90)
                payload = buf.getvalue()
                if corrupt_every and (i + 1) % corrupt_every == 0:
                    payload = payload[: len(payload) // 2]  # truncated JPEG
                info = tarfile.TarInfo(name=name)
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
                lines.append(f"{name} {label}")
    with open(os.path.join(root, labels_file), "w") as f:
        f.write("\n".join(lines) + "\n")
