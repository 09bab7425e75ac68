"""Dataset preparation — the ``put_imagenet_on_s3.py`` role.

The port's own copy of ``sparknet_tpu/tools/prepare_imagenet.py``.

Reference: ``scripts/put_imagenet_on_s3.py:1-116`` — split the label
file into shuffled chunks, resize every JPEG, re-tar the chunks as
``train.XXXXX.tar`` / ``val.XXX.tar``, upload together with
``train.txt``/``val.txt``.  This tool produces exactly the layout the
read side consumes (``data/object_store.py ImageNetLoader`` +
SETUP.md §3): shards + label files + an ``index.txt`` manifest (the
listing used by plain-HTTP roots), written locally and optionally
synced to a bucket with ``gsutil``/``aws`` (``--dry-run`` prints the
exact command instead).

Inputs, either form per split:

- ``--train_dir DIR``: a ``<class>/<image>`` tree (labels derived from
  sorted class-folder order, or supplied via ``--train_labels``);
- ``--train_tar FILE``: the ILSVRC-style nested tar (a tar of per-class
  sub-tars), as the reference consumed.

Chunking matches the reference: shuffle the label lines once (seeded),
deal them round-robin into N chunks, one output shard per chunk.
"""

from __future__ import annotations

import argparse
import io
import os
import random
import shlex
import subprocess
import sys
import tarfile
from typing import Callable, Dict, Iterable, List, Optional, Tuple


def split_label_lines(
    pairs: List[Tuple[str, int]], num_chunks: int, seed: int = 0
) -> List[List[Tuple[str, int]]]:
    """Shuffle once, deal round-robin (put_imagenet_on_s3.py
    split_label_file)."""
    pairs = list(pairs)
    random.Random(seed).shuffle(pairs)
    chunks: List[List[Tuple[str, int]]] = [[] for _ in range(num_chunks)]
    for i, p in enumerate(pairs):
        chunks[i % num_chunks].append(p)
    return [c for c in chunks if c]


def resize_jpeg(data: bytes, size: Optional[Tuple[int, int]]) -> bytes:
    """Decode/resize/re-encode one image (ANTIALIAS resize + JPEG
    re-save, like resize_and_add_image).  ``size=None`` passes the
    original bytes through untouched — no decode cost and no
    re-encode generation loss for a byte-identity operation."""
    if size is None:
        return data
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    img = img.resize(size, Image.LANCZOS)
    out = io.BytesIO()
    img.save(out, format="JPEG")
    return out.getvalue()


def labels_from_dir(root: str) -> List[Tuple[str, int]]:
    """``<class>/<image>`` tree -> (relative name, label) with labels
    assigned by sorted class-folder order (the caffe_ilsvrc12 synset
    ordering convention)."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    )
    pairs = []
    for label, cls in enumerate(classes):
        for name in sorted(os.listdir(os.path.join(root, cls))):
            pairs.append((f"{cls}/{name}", label))
    return pairs


def read_label_file(path: str) -> List[Tuple[str, int]]:
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                name, label = line.rsplit(None, 1)
                pairs.append((name, int(label)))
    return pairs


def dir_image_reader(root: str) -> Callable[[str], bytes]:
    def read(name: str) -> bytes:
        with open(os.path.join(root, name), "rb") as f:
            return f.read()

    return read


def build_tar_index(path: str) -> Dict[str, Tuple[int, int]]:
    """Index an ILSVRC-style tar-of-subtars: ``<subtar-stem>/<image>`` ->
    (absolute byte offset of the member data in the OUTER file, size).
    Both tars are uncompressed, so a member's bytes live at
    ``outer_member.offset_data + inner_member.offset_data`` and can be
    served by plain seek+read on one file handle.  The index is ints
    only — picklable and compact — so the parent builds it ONCE and
    ships it to pool workers; having every worker re-run getmembers()
    would re-read the whole (138 GB) train tar and hold a TarInfo per
    image per process (ADVICE r4)."""
    index: Dict[str, Tuple[int, int]] = {}
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic in (b"\x1f\x8b", b"BZ", b"\xfd7"):  # gz / bz2 / xz
        raise ValueError(
            f"{path}: compressed tars are not seekable by raw offset — "
            "decompress the outer tar first (ILSVRC ships uncompressed)"
        )
    with tarfile.open(path) as outer:
        for member in outer.getmembers():
            # real tars carry directory entries / stray non-tar files
            # next to the class sub-tars; only regular .tar members are
            # sub-tars
            if not member.isfile() or not member.name.endswith(".tar"):
                continue
            stem = os.path.splitext(os.path.basename(member.name))[0]
            base = member.offset_data
            with tarfile.open(fileobj=outer.extractfile(member)) as sub:
                for m in sub.getmembers():
                    if not m.isfile():
                        continue
                    index[f"{stem}/{m.name}"] = (base + m.offset_data, m.size)
    return index


def nested_tar_reader(
    path: str, index: Optional[Dict[str, Tuple[int, int]]] = None
) -> Callable[[str], bytes]:
    """Fetch members of a tar-of-subtars by ``<subtar-stem>/<image>``
    via the offset index (built here if not supplied); bytes are read
    on demand through one kept-open descriptor, so memory stays flat.

    Reads use ``os.pread`` on a stored fd: the offset rides in the call
    (no shared seek cursor), so one reader is safe to share across
    threads — a seek+read pair on a shared handle interleaves under
    concurrency and returns bytes from the wrong member.  The fd is
    closed by a finalizer on the returned callable (no leak when the
    reader is dropped)."""
    import weakref

    if index is None:
        index = build_tar_index(path)
    by_basename = {os.path.basename(k): k for k in index}
    fd = os.open(path, os.O_RDONLY)

    def read(name: str) -> bytes:
        entry = index.get(name)
        if entry is None:
            # reference train.txt keys are sometimes bare file names
            key = by_basename.get(os.path.basename(name))
            if key is None:
                raise KeyError(name)
            entry = index[key]
        off, size = entry
        buf = os.pread(fd, size, off)  # atomic at-offset read
        if len(buf) != size:
            raise IOError(
                f"{path}: short read for {name!r} "
                f"({len(buf)}/{size} bytes at {off})"
            )
        return buf

    weakref.finalize(read, os.close, fd)
    return read


# reader spec -> reader, rebuilt once per worker process (open handles
# are not picklable; the tar OFFSET INDEX is, and rides in the spec so
# workers skip the full-tar re-index)
ReaderSpec = tuple  # ("dir", path) | ("tar", path, offset_index)
_WORKER_READER: Optional[Callable[[str], bytes]] = None


def _make_reader(spec: ReaderSpec) -> Callable[[str], bytes]:
    if spec[0] == "dir":
        return dir_image_reader(spec[1])
    return nested_tar_reader(spec[1], spec[2] if len(spec) > 2 else None)


def _init_worker(spec: ReaderSpec) -> None:
    global _WORKER_READER
    _WORKER_READER = _make_reader(spec)


def _write_one_shard(job) -> str:
    out_path, chunk, size = job
    with tarfile.open(out_path, "w") as tf:
        for name, _label in chunk:
            data = resize_jpeg(_WORKER_READER(name), size)
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return os.path.basename(out_path)


def write_shards(
    out_dir: str,
    prefix: str,
    chunks: List[List[Tuple[str, int]]],
    reader_spec: ReaderSpec,
    size: Optional[Tuple[int, int]],
    zfill: int,
    workers: int = 1,
) -> List[str]:
    """One output shard per chunk; with ``workers > 1`` chunks are
    written by a process pool (they are independent — the decode/resize/
    re-encode of the full 1.28M-image ImageNet is CPU-bound; each worker
    re-opens the source via ``reader_spec``)."""
    jobs = [
        (
            os.path.join(out_dir, f"{prefix}.{str(i).zfill(zfill)}.tar"),
            chunk,
            size,
        )
        for i, chunk in enumerate(chunks)
    ]
    if workers <= 1:
        _init_worker(reader_spec)
        return [_write_one_shard(j) for j in jobs]
    import multiprocessing as mp

    with mp.Pool(workers, initializer=_init_worker,
                 initargs=(reader_spec,)) as pool:
        return list(pool.map(_write_one_shard, jobs))


def upload_command(out_dir: str, dest: str) -> List[str]:
    """The sync command for a bucket destination (the upload_file role;
    gsutil for gs://, aws for s3://)."""
    if dest.startswith("gs://"):
        return ["gsutil", "-m", "rsync", "-r", out_dir, dest]
    if dest.startswith("s3://"):
        return ["aws", "s3", "sync", out_dir, dest]
    raise ValueError(f"unsupported destination {dest!r} (gs:// or s3://)")


def _prepare_split(
    split: str, src_dir, src_tar, labels_path, out_dir, num_chunks,
    size, seed, zfill, workers=1,
) -> List[str]:
    if src_dir:
        pairs = (
            read_label_file(labels_path) if labels_path
            else labels_from_dir(src_dir)
        )
        reader_spec: ReaderSpec = ("dir", src_dir)
    else:
        if not labels_path:
            raise SystemExit(
                f"--{split}_labels is required with --{split}_tar "
                "(nested tars carry no label information)"
            )
        pairs = read_label_file(labels_path)
        # index once in the parent; workers get the picklable offsets
        reader_spec = ("tar", src_tar, build_tar_index(src_tar))
    # the read side keys labels by BASENAME (ImageNetLoader.scala:41-54
    # semantics) — colliding basenames would silently corrupt labels, so
    # the producer refuses them
    seen: Dict[str, str] = {}
    for name, _ in pairs:
        base = os.path.basename(name)
        if base in seen and seen[base] != name:
            raise SystemExit(
                f"{split}: duplicate image basename {base!r} "
                f"({seen[base]!r} vs {name!r}) — the reader keys labels "
                "by basename, so names must be globally unique "
                "(rename, e.g. prefix the class)"
            )
        seen[base] = name
    with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
        for name, label in pairs:
            f.write(f"{name} {label}\n")
    chunks = split_label_lines(pairs, num_chunks, seed)
    shards = write_shards(
        out_dir, split, chunks, reader_spec, size, zfill, workers=workers
    )
    print(f"{split}: {len(pairs)} images -> {len(shards)} shards")
    return shards + [f"{split}.txt"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("out_dir")
    p.add_argument("--train_dir")
    p.add_argument("--train_tar")
    p.add_argument("--train_labels")
    p.add_argument("--val_dir")
    p.add_argument("--val_tar")
    p.add_argument("--val_labels")
    p.add_argument("--num_train_chunks", type=int, default=1000)
    p.add_argument("--num_val_chunks", type=int, default=50)
    p.add_argument("--resize", type=int, nargs=2, metavar=("W", "H"),
                   default=None, help="resize every image to WxH (the "
                   "reference default workflow uses 256 256)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=1,
                   help="process pool size for the decode/resize/re-tar "
                   "stage (chunks are independent)")
    p.add_argument("--upload", default=None,
                   help="gs://bucket/path or s3://bucket/path")
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   help="with --upload: print the sync command only")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    size = tuple(args.resize) if args.resize else None
    files: List[str] = []
    if args.train_dir or args.train_tar:
        files += _prepare_split(
            "train", args.train_dir, args.train_tar, args.train_labels,
            args.out_dir, args.num_train_chunks, size, args.seed, 5,
            workers=args.workers,
        )
    if args.val_dir or args.val_tar:
        files += _prepare_split(
            "val", args.val_dir, args.val_tar, args.val_labels,
            args.out_dir, args.num_val_chunks, size, args.seed + 1, 3,
            workers=args.workers,
        )
    if not files:
        print("nothing to do: give --train_dir/--train_tar and/or "
              "--val_dir/--val_tar", file=sys.stderr)
        return 2
    # manifest for plain-HTTP roots (object_store.py lists index.txt)
    with open(os.path.join(args.out_dir, "index.txt"), "w") as f:
        for name in sorted(files):
            f.write(name + "\n")

    if args.upload:
        cmd = upload_command(args.out_dir, args.upload)
        if args.dry_run:
            print(shlex.join(cmd))
            return 0
        print("+ " + shlex.join(cmd), file=sys.stderr)
        return subprocess.call(cmd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
