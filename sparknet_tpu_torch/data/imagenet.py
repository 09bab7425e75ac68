"""ImageNet ingestion: shard listing, label map, tar streaming, JPEG
decode and force-resize with corrupt-image dropping, minibatch packing,
and the streaming mean image.

The port's own copy of ``sparknet_tpu/data/imagenet.py`` (numpy, tarfile
and PIL only; reference: ``ImageNetLoader.scala:25-86``,
``ScaleAndConvert.scala:16-91``, ``ComputeMean.scala:40-76``), cut to a
local root: an object-store URL (``gs://``, ``s3://``, ``http(s)://``,
``file://``) and its chunk cache, and the cross-epoch shuffle
(``partitions(epoch=...)``), are not yet ported and raise saying so.

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

_URL_SCHEMES = ("gs://", "s3://", "http://", "https://", "file://")


class ImageNetLoader:
    """Lists the data shards under a local root and streams
    ``(jpeg_bytes, label)`` pairs out of tar shards or loose image files;
    ``prefix`` filtering matches the reference's ListObjects-with-prefix
    (``ImageNetApp.scala:60-63``)."""

    IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str):
        if root.startswith(_URL_SCHEMES):
            raise NotImplementedError(
                f"ImageNetLoader: object-store roots ({root!r}) are not yet "
                "ported to sparknet_tpu_torch; give a local directory"
            )
        self.root = root

    def list_shards(self, prefix: str = "") -> List[str]:
        """All tar shards (or loose images) whose path relative to root
        starts with ``prefix``, sorted."""
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
        label map by basename; files absent from the map are dropped."""
        if shard_path.endswith(".tar"):
            with tarfile.open(shard_path, "r") as tar:
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
        else:
            name = os.path.basename(shard_path)
            if name in labels:
                with open(shard_path, "rb") as f:
                    yield f.read(), labels[name]

    def partitions(
        self,
        prefix: str,
        labels_path: str,
        num_parts: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> List[Iterator[Tuple[bytes, int]]]:
        """Shards dealt round-robin (``shards[worker::n]``) into
        ``num_parts`` lazy partitions (default one per shard)."""
        if epoch is not None:
            raise NotImplementedError(
                "ImageNetLoader.partitions: the cross-epoch shuffle "
                "(epoch=) is not yet ported to sparknet_tpu_torch"
            )
        shards = self.list_shards(prefix)
        if not shards:
            raise FileNotFoundError(
                f"no shards under {self.root!r} matching prefix {prefix!r}"
            )
        labels = self.load_labels(labels_path)
        n = num_parts or len(shards)
        assignment = [shards[w::n] for w in range(n)]

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
