"""ImageNetCreateDBApp — phase 1 of the two-phase ImageNet DB path.

The port of ``sparknet_tpu/apps/imagenet_create_db_app.py`` (reference:
``ImageNetCreateDBApp.scala:60-133``): load the tar shards, force-resize
them to full-size uint8 minibatches, deal them round-robin over the
workers, write one train and one test record DB a worker
(``ilsvrc12_{train,val}_db_{w}.sndb``, ``runtime.write_datum_db``), the
infoFile (``imagenet_db_info.json``: every worker's batch counts and the
shapes phase 2 needs) and the mean image (``imagenet_mean.binaryproto``).
It does no device work; every file it writes is the JAX app's byte for
byte.

Run::

    python -m sparknet_tpu_torch.apps.imagenet_create_db_app --data DIR \\
        --out DB_DIR --workers 2

JPEG tar shards are synthesized (the JAX app's scaled-down defaults:
full 64, batch 8 / test 4, at most 4 classes) when ``--data`` is
omitted; phase 2 is ``apps/imagenet_run_db_app.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

FULL_SIZE = 256  # fullHeight/fullWidth (ImageNetCreateDBApp.scala:26-27)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sparknet_tpu_torch.apps.imagenet_create_db_app")
    p.add_argument("--data", default=None,
                   help="local dir with tar shards + train.txt/val.txt")
    p.add_argument("--out", default=None, help="output DB dir")
    p.add_argument("--train_prefix", default="train.")
    p.add_argument("--test_prefix", default="val.")
    p.add_argument("--train_labels", default="train.txt")
    p.add_argument("--test_labels", default="val.txt")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--train_batch", type=int, default=0)
    p.add_argument("--test_batch", type=int, default=0)
    p.add_argument("--full_size", type=int, default=0)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    return p


def write_dbs(out_dir: str, train_parts, test_parts, info: dict, log) -> None:
    """Write the per-worker record DBs, the infoFile and the mean image
    from uint8 partitions (``imagenet_app.load_partitions``'s
    ``(images (nb, B, 3, H, W), labels (nb, B))``, one a worker)."""
    from sparknet_tpu_torch import runtime
    from sparknet_tpu_torch.data import compute_mean, reduce_mean_sums
    from sparknet_tpu_torch.io import save_mean_image

    if any(len(x) == 0 for x, _ in train_parts):
        raise SystemExit(
            "imagenet_create_db: every worker needs >= 1 train minibatch; "
            f"partition sizes {[len(x) for x, _ in train_parts]}"
        )
    for split, parts in (("train", train_parts), ("val", test_parts)):
        log.log(f"write {'test' if split == 'val' else split} data to DB")
        for w, (x, y) in enumerate(parts):
            runtime.write_datum_db(
                os.path.join(out_dir, f"ilsvrc12_{split}_db_{w}.sndb"),
                x.reshape((-1,) + x.shape[2:]), y.reshape(-1),
            )
    # infoFile (imagenet_num_test_batches.txt role): per-worker batch
    # counts + the shapes phase 2 needs
    info = dict(info, train_batches=[len(x) for x, _ in train_parts],
                test_batches=[len(x) for x, _ in test_parts])
    info_path = os.path.join(out_dir, "imagenet_db_info.json")
    with open(info_path, "w") as f:
        json.dump(info, f, indent=1)
    log.log(f"infoFile -> {info_path}")
    log.log("computing mean image")
    mean = reduce_mean_sums([compute_mean(zip(x, y), return_sum=True)
                             for x, y in train_parts])
    mean_path = os.path.join(out_dir, "imagenet_mean.binaryproto")
    save_mean_image(mean, mean_path)
    log.log(f"mean image -> {mean_path}")


def main(argv: Optional[List[str]] = None) -> int:
    """Synthesize (without ``--data``) and load the shards, then write
    the DB directory; prints its path and returns the exit code."""
    args = _parser().parse_args(argv)

    from sparknet_tpu_torch.apps.imagenet_app import load_partitions
    from sparknet_tpu_torch.data import ImageNetLoader, write_synthetic_imagenet
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    with tempfile.TemporaryDirectory(prefix="imagenet_synth_") as synth, \
            TrainingLog(tag="imagenet_create_db") as log:
        if args.data is None:
            args.train_batch = args.train_batch or 8
            args.test_batch = args.test_batch or 4
            args.full_size = args.full_size or 64
            args.classes = min(args.classes, 4)
            data_dir = synth
            write_synthetic_imagenet(
                data_dir, num_shards=max(2, args.workers),
                images_per_shard=args.train_batch * 6, classes=args.classes,
                seed=args.seed,
            )
            write_synthetic_imagenet(
                data_dir, num_shards=max(2, args.workers),
                images_per_shard=args.test_batch * 2, classes=args.classes,
                labels_file="val.txt", shard_prefix="val.",
                seed=args.seed + 1,
            )
            log.log(f"synthesized JPEG tar shards in {data_dir}")
        else:
            if "://" in args.data:
                raise SystemExit(
                    "imagenet_create_db: object-store --data is not yet "
                    "ported to sparknet_tpu_torch; give a local directory"
                )
            args.train_batch = args.train_batch or 256
            args.test_batch = args.test_batch or 50
            args.full_size = args.full_size or FULL_SIZE
            data_dir = args.data
        out_dir = args.out or tempfile.mkdtemp(prefix="imagenet_dbs_")
        os.makedirs(out_dir, exist_ok=True)

        loader = ImageNetLoader(data_dir)
        log.log("processing train data")
        train_parts = load_partitions(
            loader, args.train_prefix, args.train_labels, args.workers,
            args.train_batch, args.full_size)
        log.log(f"numTrainMinibatches = {sum(len(x) for x, _ in train_parts)}")
        log.log("processing test data")
        test_parts = load_partitions(
            loader, args.test_prefix, args.test_labels, args.workers,
            args.test_batch, args.full_size)
        log.log(f"numTestMinibatches = {sum(len(x) for x, _ in test_parts)}")
        log.log(f"trainPartitionSizes = {[len(x) for x, _ in train_parts]}")
        log.log(f"testPartitionSizes = {[len(x) for x, _ in test_parts]}")
        write_dbs(out_dir, train_parts, test_parts, {
            "workers": args.workers,
            "full_size": args.full_size,
            "classes": args.classes,
            "train_batch": args.train_batch,
            "test_batch": args.test_batch,
        }, log)
        log.log("finished creating databases")
    print(out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
