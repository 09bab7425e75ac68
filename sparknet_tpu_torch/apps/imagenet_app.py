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

``DIR`` holds tar shards and ``train.txt``/``val.txt``; JPEG shards are
synthesized when ``--data`` is omitted, with the JAX app's scaled-down
defaults (full 64, crop 56, at most 4 classes unless given).
``train(...)`` is the training half on in-memory uint8 partitions,
which ``main`` calls after the data stage.  ``--health`` (this app
keeps no snapshots, so rollback degrades to halt), ``--flight_recorder``,
``--journal`` (progress-only commits, ``durable=False``), ``--slices`` /
``--cross_slice_every`` are the JAX app's; ``--elastic`` only logs that
membership is wired in ``cifar_app`` and ``lm_app``.  Object-store data,
``--cache_dir``/``--cache_bytes``, ``--shuffle_epochs``, multi-host,
``--stale_bound`` > 0 and ``--obs``/``--profile`` are not yet ported
and exit saying so.
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

# flags of the JAX app that later slices bring: (flag, takes a value)
_NOT_YET_PORTED = (
    ("--cache_dir", True), ("--cache_bytes", True), ("--shuffle_epochs", True),
)

# one worker's partition: (images (nb, B, 3, H, W) uint8, labels (nb, B))
Partition = Tuple[np.ndarray, np.ndarray]


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.io import journal
    from sparknet_tpu_torch.parallel import comm, hierarchy

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.imagenet_app")
    p.add_argument("--data", default=None,
                   help="local dir with tar shards + train.txt/val.txt")
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or "
                   "cpu (the kernels' plain versions)")
    obs.add_cli_args(p)  # --health / --flight_recorder (+ refused ones)
    comm.add_cli_args(p)  # --compress / --overlap_avg
    hierarchy.add_cli_args(p)  # --slices / --cross_slice_every / --elastic
    journal.add_cli_args(p)  # --journal / --no_journal / ...
    for flag, takes_value in _NOT_YET_PORTED:
        if takes_value:
            p.add_argument(flag, default=None, help="not yet ported")
        else:
            p.add_argument(flag, action="store_true", help="not yet ported")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The app's arguments with the defaults filled in: the JAX app's
    scaled-down synthetic defaults when ``--data`` is omitted, the
    reference constants otherwise."""
    args = _parser().parse_args(argv)
    for flag, _ in _NOT_YET_PORTED:
        if getattr(args, flag.lstrip("-")) not in (None, False):
            raise SystemExit(
                f"imagenet_app: {flag} is not yet ported to sparknet_tpu_torch"
            )
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.models import available_models
    from sparknet_tpu_torch.parallel import hierarchy

    obs.check_args(args, "imagenet_app")
    hierarchy.check_args(args, "imagenet_app")

    if args.model not in available_models():
        raise SystemExit(
            f"imagenet_app: unknown --model {args.model} (have "
            f"{', '.join(available_models())})"
        )
    if args.data is not None and "://" in args.data:
        raise SystemExit(
            "imagenet_app: object-store --data is not yet ported to "
            "sparknet_tpu_torch; give a local directory"
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
                    batch: int, size: int) -> List[Partition]:
    """Deal the shards round-robin over the workers and pack each
    partition into uint8 minibatches at ``size`` x ``size``."""
    from sparknet_tpu_torch.data import ScaleAndConvert

    conv = ScaleAndConvert(batch, size, size)
    out = []
    for part in loader.partitions(prefix, labels_file, num_parts=n_workers):
        mbs = list(conv.make_minibatches(part))
        if not mbs:
            out.append((np.zeros((0, batch, 3, size, size), np.uint8),
                        np.zeros((0, batch), np.int32)))
            continue
        out.append((np.stack([m[0] for m in mbs]), np.stack([m[1] for m in mbs])))
    return out


def data_stage(args, n_workers: int, log, data_dir: str):
    """Load and partition the train and test shards, compute the mean
    image over the train partitions and save it as ``mean.binaryproto``
    in ``data_dir``.  Returns ``(train_parts, test_parts, mean)``."""
    from sparknet_tpu_torch.data import (
        ImageNetLoader,
        compute_mean,
        reduce_mean_sums,
    )
    from sparknet_tpu_torch.io import save_mean_image

    loader = ImageNetLoader(data_dir)
    log.log("loading train data")
    train_parts = load_partitions(loader, args.train_prefix, args.train_labels,
                                  n_workers, args.train_batch, args.full_size)
    log.log("loading test data")
    test_parts = load_partitions(loader, args.test_prefix, args.test_labels,
                                 n_workers, args.test_batch, args.full_size)
    log.log(f"numTrainMinibatches = {sum(len(x) for x, _ in train_parts)}")
    log.log(f"numTestMinibatches = {sum(len(x) for x, _ in test_parts)}")
    log.log("computing mean image")
    mean = reduce_mean_sums([
        compute_mean(zip(x, y), return_sum=True) for x, y in train_parts
        if len(x)
    ])
    mean_path = os.path.join(data_dir, "mean.binaryproto")
    save_mean_image(mean, mean_path)
    log.log(f"mean image -> {mean_path}")
    return train_parts, test_parts, mean


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
          result: Optional[dict] = None, solver_param=None) -> float:
    """The averaging loop on in-memory uint8 partitions (one per worker):
    test-then-train every ``--test_every`` rounds (ImageNetApp.scala:118),
    ``--rounds`` rounds of tau local steps and an average, then the final
    test, under ``solver_param`` (default: the model's zoo solver).
    Returns the final accuracy; a sentry halt raises ``SentryHalt``.
    ``result`` receives the state, the trainer, the metrics, the sentry,
    the per-round losses (``losses``: (rounds, W, tau)), each round's
    wall seconds and the accuracies."""
    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.apps.scores import primary_accuracy
    from sparknet_tpu_torch.data import MinibatchSampler, RoundFeed, stack_windows
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    n_workers = len(train_parts)
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
    # per-worker samplers: a contiguous random window of tau per round
    samplers = [
        MinibatchSampler({"data": x, "label": y.astype(np.float32)},
                         num_sampled_batches=args.tau, seed=args.seed + w)
        for w, (x, y) in enumerate(train_parts)
    ]
    test_batches, test_counts = ParameterAveragingTrainer.pad_partitions(
        [{"data": x, "label": y.astype(np.float32)} for x, y in test_parts]
    )
    num_test = int(np.asarray(test_counts).sum())
    solver = build_solver(args, mean, device, solver_param)
    metrics = TrainingMetrics()
    # no snapshots: rollback degrades to halt, commits are progress marks
    guards = RoundGuards.from_args(
        args, solver, n_workers, app="imagenet_app", log=log, metrics=metrics,
        journal_path="imagenet_run.journal", wire_membership=False)
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

    feed = RoundFeed(
        lambda r: stack_windows([s.next_window() for s in samplers]),
        device, pipelined=not args.serial_feed, num_rounds=args.rounds,
    )
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

    device = resolve_device(args.device)
    n_workers = args.workers or (
        torch.cuda.device_count() if device.type == "cuda" else 1
    )
    with tempfile.TemporaryDirectory(prefix="imagenet_synth_") as synth, \
            TrainingLog(tag="imagenet") as log:
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
        train_parts, test_parts, mean = data_stage(args, n_workers, log,
                                                   data_dir)
        try:
            acc = train(args, train_parts, test_parts, mean, device, log,
                        result)
        except SentryHalt as e:
            log.log(f"training halted by the health sentry: {e}")
            return 1
        print(f"final accuracy {acc * 100:.2f}%")
    if result is not None:
        result["mean"] = mean
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
