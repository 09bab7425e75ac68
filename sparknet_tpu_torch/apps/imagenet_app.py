"""ImageNetApp — the distributed ImageNet training driver.

The port of ``sparknet_tpu/apps/imagenet_app.py`` (reference:
``ImageNetApp.scala``): load tar shards, force-resize to the full size,
compute and save the mean image, then rounds of tau local steps and a
parameter average, testing every ``--test_every`` rounds, with the
per-image random crop + mirror (train) and centre crop (test) and the
mean subtraction run on the device (``data/transforms.py``).  The W
workers are stacked on one device (``parallel/trainers.py``).

``--model`` is any zoo or builder name (``models.available_models()``):
AlexNet and CaffeNet, GoogLeNet and ResNet-50 (the builders take
``--classes``; each model trains under its zoo solver, poly for
GoogLeNet, multistep from lr 0.1 for ResNet-50; ``train`` also takes
another ``SolverParameter``, e.g. one whose rate suits a batch cut from
the recipe's).
On the card every ACROSS_CHANNELS LRN forward runs K5 and every LRN
backward K6 (``ops/cuda_lrn.py``); with ``SPARKNET_FUSION=1`` a training net's
``LRN -> Pooling`` sandwiches on odd inputs run the fused K7/K8 instead
(``ops/cuda_plp.py``; at crop 227 AlexNet's LRN inputs are 55x55 and
27x27, GoogLeNet's ``conv2/norm2`` input 57x57).  GoogLeNet's Inception
branches run through the horizontal-conv fusion (``net.py``, off under
``SPARKNET_HFUSE=0``); ResNet-50's BatchNorm stat blobs are averaged
with the parameters every round.

Run (on the card; ``--device cpu`` runs the kernels' plain versions)::

    python -m sparknet_tpu_torch.apps.imagenet_app --model alexnet \\
        --workers 2 --tau 4 --train_batch 32 --test_batch 16 \\
        --full_size 256 --crop 227 [--data DIR]

``DIR`` holds tar shards and ``train.txt``/``val.txt``: a directory or
an object-store URL (``gs://``, ``s3://``, ``http(s)://``, ``file://``).
``--cache_dir`` fronts the store with the host-local chunk cache
(``--cache_bytes`` its LRU budget): epoch 1 fills it, later epochs read
local disk, and the mean image is written next to it.
``--shuffle_epochs N`` splits ``--rounds`` into N epochs and re-deals
shard ownership between them (``data/shuffle.py``, pure in the seed and
the epoch); each epoch's partitions are reloaded on the feed's producer
thread and its samplers re-seeded by the epoch.  JPEG shards are
synthesized when ``--data`` is omitted, with the JAX app's scaled-down
defaults (full 64, crop 56, at most 4 classes unless given).
``train(...)`` is the training half on in-memory uint8 partitions,
which ``main`` calls after the data stage.  ``--health`` (this app
keeps no snapshots, so rollback degrades to halt), ``--flight_recorder``,
``--journal`` (progress-only commits, ``durable=False``), ``--slices`` /
``--cross_slice_every`` are the JAX app's; ``--elastic`` only logs that
membership is wired in ``cifar_app`` and ``lm_app``.
``--stale_bound`` / ``--stale_discount`` and ``--profile`` /
``--profile_out`` (the window draws timed per worker) are the JAX
app's.  ``--obs`` is not yet ported and exits saying so.

Across processes (``tools/launch.py``, or a caller joined through
``parallel.mesh.initialize_distributed``) the app runs the JAX app's
multi-process mode: ``--workers`` is the global worker count, each
process materializes only its own workers' partitions (the other
partitions stay unread), the minibatch counts, the mean image's
per-partition sums and the per-worker test counts are gathered over
the process group (``all_gather``), each process's samplers are seeded
by global worker index, the average reduces over the dp group, and only
rank 0 echoes its log.  ``--stale_bound``, ``--slices`` /
``--cross_slice_every``, ``--journal`` (rank 0 writes the ledger) and
``--profile`` / ``--profile_out`` (every rank's workers in one table,
written by rank 0) run across processes as in one; ``--overlap_avg``
stays single-process (refused, as in JAX).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

TAU = 50  # reference: syncInterval = 50, ImageNetApp.scala:155
FULL_SIZE = 256  # fullHeight/fullWidth, ImageNetApp.scala:23-24
CROP_SIZE = 227  # croppedHeight/croppedWidth, ImageNetApp.scala:25-26

# one worker's partition: (images (nb, B, 3, H, W) uint8, labels (nb, B))
Partition = Tuple[np.ndarray, np.ndarray]


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.io import journal
    from sparknet_tpu_torch.parallel import comm, hierarchy

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.imagenet_app")
    p.add_argument("--data", default=None,
                   help="tar shards + train.txt/val.txt: a directory or a "
                   "gs://|s3://|http(s)://|file:// url")
    p.add_argument("--train_prefix", default="train.")
    p.add_argument("--test_prefix", default="val.")
    p.add_argument("--train_labels", default="train.txt")
    p.add_argument("--test_labels", default="val.txt")
    p.add_argument("--model", default="alexnet",
                   help="alexnet | caffenet | googlenet | resnet50 (any "
                   "models.available_models() name)")
    p.add_argument("--workers", type=int, default=0,
                   help="0 = the device count")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--tau", type=int, default=0, help="0 = reference (50)")
    p.add_argument("--test_every", type=int, default=10)
    p.add_argument("--train_batch", type=int, default=0)
    p.add_argument("--test_batch", type=int, default=0)
    p.add_argument("--full_size", type=int, default=0)
    p.add_argument("--crop", type=int, default=0)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--no_mirror", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serial_feed", action="store_true",
                   help="assemble and copy each round's batch on the "
                   "training thread instead of the producer thread")
    p.add_argument("--cache_dir", default=None,
                   help="front an object-store --data with the host-local "
                   "content-addressed chunk cache rooted here: epoch 1 fills "
                   "it, later epochs read local disk")
    p.add_argument("--cache_bytes", default="0",
                   help="chunk-cache LRU byte budget, e.g. 512M / 8G "
                   "(0 = unbounded)")
    p.add_argument("--shuffle_epochs", type=int, default=0,
                   help="split --rounds into N epochs and reshuffle "
                   "shard->worker ownership between them (seeded "
                   "shuffle-by-assignment; with --cache_dir the repeat reads "
                   "hit the local cache); 0/1 = one fixed assignment")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or "
                   "cpu (the kernels' plain versions)")
    obs.add_cli_args(p)  # --health / --flight_recorder (+ refused ones)
    comm.add_cli_args(p)  # --compress / --overlap_avg
    hierarchy.add_cli_args(p)  # --slices / --cross_slice_every / --elastic
    journal.add_cli_args(p)  # --journal / --no_journal / ...
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The app's arguments with the defaults filled in: the JAX app's
    scaled-down synthetic defaults when ``--data`` is omitted, the
    reference constants otherwise."""
    args = _parser().parse_args(argv)
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.models import available_models

    obs.check_args(args, "imagenet_app")

    if args.model not in available_models():
        raise SystemExit(
            f"imagenet_app: unknown --model {args.model} (have "
            f"{', '.join(available_models())})"
        )
    if args.data is None:  # scaled-down defaults so the demo fits one host
        args.train_batch = args.train_batch or 8
        args.test_batch = args.test_batch or 4
        args.tau = args.tau or 4
        args.full_size = args.full_size or 64
        args.crop = args.crop or 56
        args.classes = min(args.classes, 4)
    else:  # reference constants (ImageNetApp.scala:20-26)
        args.train_batch = args.train_batch or 256
        args.test_batch = args.test_batch or 50
        args.tau = args.tau or TAU
        args.full_size = args.full_size or FULL_SIZE
        args.crop = args.crop or CROP_SIZE
    return args


def load_partitions(loader, prefix: str, labels_file: str, n_workers: int,
                    batch: int, size: int, epoch: Optional[int] = None,
                    shuffle_seed: int = 0,
                    keep: Optional[slice] = None) -> List[Partition]:
    """Deal the shards over the workers (round-robin, or epoch
    ``epoch``'s seeded assignment) and pack each partition into uint8
    minibatches at ``size`` x ``size``; ``keep`` (a block of workers)
    materializes only those partitions."""
    from sparknet_tpu_torch.data import ScaleAndConvert

    conv = ScaleAndConvert(batch, size, size)
    out = []
    parts = loader.partitions(prefix, labels_file, num_parts=n_workers,
                              epoch=epoch, shuffle_seed=shuffle_seed)
    for part in (parts if keep is None else parts[keep]):
        mbs = list(conv.make_minibatches(part))
        if not mbs:
            out.append((np.zeros((0, batch, 3, size, size), np.uint8),
                        np.zeros((0, batch), np.int32)))
            continue
        out.append((np.stack([m[0] for m in mbs]), np.stack([m[1] for m in mbs])))
    return out


def data_stage(args, n_workers: int, log, data_dir: str,
               keep: Optional[slice] = None):
    """Load and partition the train and test shards (the train shards
    as epoch 0 deals them under ``--shuffle_epochs``), compute the mean
    image over the train partitions and save it as ``mean.binaryproto``
    in ``data_dir`` (next to the chunk cache, or in a temporary
    directory, when ``data_dir`` is an object store).  Returns
    ``(train_parts, test_parts, mean, reload)``: ``reload(epoch)`` loads
    that epoch's train partitions.  ``keep`` (across processes: this
    process's block of workers) materializes only those partitions; the
    counts and the mean's per-partition sums are gathered over the
    processes, so every process logs and saves what one process would."""
    from sparknet_tpu_torch.data import (
        ImageNetLoader,
        compute_mean,
        object_store,
        reduce_mean_sums,
    )
    from sparknet_tpu_torch.data.chunk_cache import parse_bytes
    from sparknet_tpu_torch.io import save_mean_image

    loader = ImageNetLoader(data_dir, cache_dir=args.cache_dir,
                            cache_bytes=parse_bytes(args.cache_bytes))
    if loader.cache is not None:
        log.log(f"chunk cache at {loader.cache.root} "
                f"(budget {loader.cache.byte_budget or 'unbounded'} bytes)")

    def reload(epoch):
        return load_partitions(loader, args.train_prefix, args.train_labels,
                               n_workers, args.train_batch, args.full_size,
                               epoch=epoch, shuffle_seed=args.seed, keep=keep)

    def gathered(local: list) -> list:
        """Every process's per-partition values, in worker order."""
        if keep is None:
            return local
        from sparknet_tpu_torch.parallel import mesh

        return [v for part in mesh.all_gather_objects(local) for v in part]

    log.log("loading train data")
    train_parts = reload(0 if args.shuffle_epochs > 1 else None)
    log.log("loading test data")
    test_parts = load_partitions(loader, args.test_prefix, args.test_labels,
                                 n_workers, args.test_batch, args.full_size,
                                 keep=keep)
    log.log("numTrainMinibatches = "
            f"{sum(gathered([len(x) for x, _ in train_parts]))}")
    log.log("numTestMinibatches = "
            f"{sum(gathered([len(x) for x, _ in test_parts]))}")
    log.log("computing mean image")
    # the cross-process ComputeMean reduce: every partition's (sum,
    # count), gathered in worker order, reduced as one process would
    mean = reduce_mean_sums([
        sc for sc in gathered([
            compute_mean(zip(x, y), return_sum=True) if len(x) else None
            for x, y in train_parts])
        if sc is not None
    ])
    mean_dir = data_dir
    if object_store.is_object_store_url(data_dir):
        # a bucket or HTTP root is not writable from here
        mean_dir = (loader.cache.root if loader.cache is not None
                    else tempfile.mkdtemp(prefix="imagenet_mean_"))
    mean_path = os.path.join(mean_dir, "mean.binaryproto")
    save_mean_image(mean, mean_path)
    log.log(f"mean image -> {mean_path}")
    return train_parts, test_parts, mean, reload


def build_solver(args, mean: np.ndarray, device, solver_param=None):
    """The model's solver at the cropped batch shapes
    (``replaceDataLayers``, ImageNetApp.scala:103-104), with the train and
    test transforms on ``device``; ``solver_param`` (default: the model's
    zoo solver) sets the schedule."""
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.data import transforms
    from sparknet_tpu_torch.models.builders import BUILDERS
    from sparknet_tpu_torch.solver import Solver

    netp = (models.load_model(args.model, classes=args.classes)
            if args.model in BUILDERS  # prototxt models take no overrides
            else models.load_model(args.model))
    netp = config.replace_data_layers(
        netp,
        [(args.train_batch, 3, args.crop, args.crop), (args.train_batch,)],
        [(args.test_batch, 3, args.crop, args.crop), (args.test_batch,)],
    )
    if solver_param is None:
        solver_param = models.load_model_solver(args.model)
    return Solver(
        solver_param, net_param=netp, device=device,
        train_transform=transforms.train_transform(
            mean, args.crop, mirror=not args.no_mirror),
        test_transform=transforms.test_transform(mean, args.crop),
    )


def train(args, train_parts: Sequence[Partition],
          test_parts: Sequence[Partition], mean: np.ndarray, device, log,
          result: Optional[dict] = None, solver_param=None,
          reload=None, metrics=None, mesh=None) -> float:
    """The averaging loop on in-memory uint8 partitions (one per worker):
    test-then-train every ``--test_every`` rounds (ImageNetApp.scala:118),
    ``--rounds`` rounds of tau local steps and an average, then the final
    test, under ``solver_param`` (default: the model's zoo solver).
    Under ``--shuffle_epochs`` > 1, ``reload(epoch)`` gives each later
    epoch's partitions (``data_stage``), loaded on the feed's producer
    thread at the epoch's first round; each epoch's samplers are seeded
    ``seed + worker + 7919 * epoch``, as in the JAX app.
    Returns the final accuracy; a sentry halt raises ``SentryHalt``.
    ``result`` receives the state, the trainer, the metrics, the sentry,
    the per-round losses (``losses``: (rounds, W, tau)), each round's
    wall seconds and the accuracies.  With ``mesh`` (across processes)
    the partitions are this process's block of the mesh's workers."""
    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.apps.scores import primary_accuracy
    from sparknet_tpu_torch.data import MinibatchSampler, RoundFeed, stack_windows
    from sparknet_tpu_torch.obs import profile
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    n_workers = len(train_parts) if mesh is None else mesh.shape["dp"]
    first = 0 if mesh is None else mesh.coords["dp"].start
    if min(len(x) for x, _ in train_parts) < args.tau:
        raise SystemExit(
            f"every worker needs >= tau={args.tau} train minibatches; "
            f"partition sizes {[len(x) for x, _ in train_parts]}"
        )
    if min(len(x) for x, _ in test_parts) == 0:
        raise SystemExit(
            f"every worker needs >= 1 test minibatch; partition sizes "
            f"{[len(x) for x, _ in test_parts]} (fewer val shards than "
            "workers? reduce --workers or add shards)"
        )
    # per-worker samplers: a contiguous random window of tau per round,
    # seeded by the worker and (a reshuffled epoch draws afresh) the epoch
    def build_samplers(parts, epoch=0):
        return [
            MinibatchSampler({"data": x, "label": y.astype(np.float32)},
                             num_sampled_batches=args.tau,
                             seed=args.seed + first + w + 7919 * epoch)
            for w, (x, y) in enumerate(parts)
        ]

    shuffle = args.shuffle_epochs > 1
    if shuffle and reload is None:
        raise ValueError("imagenet_app.train: --shuffle_epochs needs reload")
    rounds_per_epoch = -(-args.rounds // args.shuffle_epochs) if shuffle else 0
    epoch_state = {"epoch": 0, "samplers": build_samplers(train_parts)}
    test_batches, test_counts = ParameterAveragingTrainer.pad_partitions(
        [{"data": x, "label": y.astype(np.float32)} for x, y in test_parts]
    )
    if mesh is not None:
        from sparknet_tpu_torch.parallel import mesh as mesh_mod

        test_counts = np.concatenate(mesh_mod.all_gather_objects(
            np.asarray(test_counts)))
    num_test = int(np.asarray(test_counts).sum())
    solver = build_solver(args, mean, device, solver_param)
    if metrics is None:
        metrics = TrainingMetrics()
    # no snapshots: rollback degrades to halt, commits are progress marks
    guards = RoundGuards.from_args(
        args, solver, n_workers, app="imagenet_app", log=log, metrics=metrics,
        journal_path="imagenet_run.journal", wire_membership=False,
        mesh=mesh)
    trainer = guards.trainer
    state = trainer.init_state(seed=args.seed)
    test_on_dev = {k: torch.from_numpy(v).to(device)
                   for k, v in test_batches.items()}
    log.log(f"finished setting up nets and weights ({args.model}, "
            f"{n_workers} workers on {device}, "
            f"{len(solver.net.hconv_groups)} hconv groups)")

    def evaluate(r=-1) -> float:
        scores = trainer.test_and_store_result(state, test_on_dev,
                                               counts=test_counts)
        for name in sorted(scores):
            log.log(f"test output {name} = {scores[name] / max(1, num_test):.4f}",
                    i=r)
        return primary_accuracy(scores) / max(1, num_test)

    def draw_windows(r):
        # on the feed's producer thread, once a round in order: at an
        # epoch's first round the shard assignment re-deals and the
        # partitions reload (through the chunk cache, local reads)
        if shuffle:
            e = min(r // rounds_per_epoch, args.shuffle_epochs - 1)
            if e != epoch_state["epoch"]:
                parts = reload(e)
                if min(len(x) for x, _ in parts) < args.tau:
                    raise RuntimeError(
                        f"epoch {e}: a worker's reshuffled partition has "
                        f"fewer than tau={args.tau} minibatches; sizes "
                        f"{[len(x) for x, _ in parts]}")
                epoch_state.update(epoch=e, samplers=build_samplers(parts, e))
                log.log(f"epoch {e}: shard ownership reshuffled "
                        "(shuffle-by-assignment)", i=r)
        # --profile: each worker's window draw timed
        return stack_windows(profile.timed_worker_windows(
            r, [s.next_window for s in epoch_state["samplers"]]))

    feed = RoundFeed(draw_windows, device, pipelined=not args.serial_feed,
                     num_rounds=args.rounds)
    round_seconds, round_losses, accuracies = [], [], []
    try:
        for r in range(args.rounds):
            if r % args.test_every == 0:  # test-then-train
                state = trainer.finalize(state)
                accuracies.append(evaluate(r))
                log.log(f"{accuracies[-1] * 100:.2f}% accuracy", i=r)
            log.log("training", i=r)
            t0 = time.perf_counter()
            guards.begin(r, iter=r * args.tau, cursor=r)
            state, losses = guards.round(state, feed.next_round(r), None, r)
            round_losses.append(losses.detach().cpu().numpy())
            round_seconds.append(time.perf_counter() - t0)
            log.log(f"trained, smoothed_loss {solver.smoothed_loss:.4f}", i=r)
            guards.commit(r, iter=(r + 1) * args.tau, durable=False)
        state = trainer.finalize(state)  # the last round's average lands
        acc = evaluate()
        accuracies.append(acc)
        log.log(f"final accuracy {acc * 100:.2f}%")
    finally:
        feed.stop()
        guards.close()
    if result is not None:
        result.update(state=state, trainer=trainer, metrics=metrics,
                      sentry=guards.sentry, losses=np.stack(round_losses),
                      profile=guards.profile_summary,
                      round_seconds=round_seconds,
                      accuracies=accuracies, smoothed_loss=solver.smoothed_loss)
    return acc


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Synthesize (without ``--data``) and load the shards, compute the
    mean, then ``train``; returns the exit code (1 when the sentry
    halts).  ``result`` receives
    what ``train`` puts there and the mean image."""
    args = parse_args(argv)

    from sparknet_tpu_torch.data import write_synthetic_imagenet
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics

    from sparknet_tpu_torch.parallel import mesh as mesh_mod

    if mesh_mod.process_count() > 1:
        device = mesh_mod.app_device(args.device, "imagenet_app")
        n_workers, mesh = mesh_mod.app_mesh(args, "imagenet_app")
        keep = mesh_mod.local_worker_slice(mesh)
    else:
        device = resolve_device(args.device)
        n_workers = args.workers or (
            torch.cuda.device_count() if device.type == "cuda" else 1
        )
        mesh = keep = None
    rank = mesh_mod.process_index()
    metrics = TrainingMetrics()
    with tempfile.TemporaryDirectory(prefix="imagenet_synth_") as synth, \
            obs.installed_metrics(metrics), \
            TrainingLog(tag="imagenet" if rank == 0 else f"imagenet_p{rank}",
                        echo=rank == 0) as log:
        data_dir = args.data
        if data_dir is None:
            data_dir = synth
            n_shards = max(2, n_workers)
            write_synthetic_imagenet(
                data_dir, num_shards=n_shards,
                images_per_shard=args.train_batch * (args.tau + 1),
                classes=args.classes, seed=args.seed,
            )
            write_synthetic_imagenet(
                data_dir, num_shards=n_shards,
                images_per_shard=args.test_batch * 2, classes=args.classes,
                labels_file="val.txt", shard_prefix="val.", seed=args.seed + 1,
            )
            log.log(f"synthesized JPEG tar shards in {data_dir}")
        log.log(f"num workers: {n_workers}")
        train_parts, test_parts, mean, reload = data_stage(
            args, n_workers, log, data_dir, keep=keep)
        try:
            acc = train(args, train_parts, test_parts, mean, device, log,
                        result, reload=reload, metrics=metrics, mesh=mesh)
        except SentryHalt as e:
            log.log(f"training halted by the health sentry: {e}")
            return 1
        if rank == 0:
            print(f"final accuracy {acc * 100:.2f}%")
    if result is not None:
        result["mean"] = mean
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
