"""CifarApp — distributed CIFAR-10 training driver (cifar10_full).

The port of ``sparknet_tpu/apps/cifar_app.py`` (reference:
``CifarApp.scala``): load + partition the data across workers, then
rounds of broadcast -> tau local steps -> average, testing every
``test_every`` rounds, all phase-logged.  The W workers are stacked on
one device (``parallel/trainers.py``); ``--compress``/``--overlap_avg``
route the average through the comm plane and its CUDA epilogue kernels.

Run (on the card; ``--device cpu`` runs the plain versions on the CPU)::

    python -m sparknet_tpu_torch.apps.cifar_app --workers 4 --tau 10 \\
        --compress int8 [--data DIR] [--rounds 50]

CIFAR-format data is synthesized (5,000 train / 1,000 test) when
``--data`` is omitted.  ``--elastic``, ``--slices`` /
``--cross_slice_every``, ``--stale_bound``, ``--health``, ``--journal``
and ``--obs`` / ``--profile`` are not yet ported and exit saying so.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

TAU = 10  # reference: syncInterval = 10, CifarApp.scala:119

# flags of the JAX app that later slices bring: (flag, takes a value)
_NOT_YET_PORTED = (
    ("--elastic", False), ("--slices", True), ("--cross_slice_every", True),
    ("--stale_bound", True), ("--health", False), ("--journal", False),
    ("--obs", False), ("--profile", False),
)


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch.parallel import comm

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.cifar_app")
    p.add_argument("--data", default=None, help="CIFAR binary dir")
    p.add_argument("--workers", type=int, default=0,
                   help="0 = the device count")
    p.add_argument("--rounds", type=int, default=50)
    p.add_argument("--tau", type=int, default=TAU)
    p.add_argument("--test_every", type=int, default=10)  # CifarApp.scala:101
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serial_feed", action="store_true",
                   help="assemble and copy each round's batch on the "
                   "training thread instead of the producer thread")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or "
                   "cpu (the kernels' plain versions)")
    comm.add_cli_args(p)  # --compress / --overlap_avg
    for flag, takes_value in _NOT_YET_PORTED:
        if takes_value:
            p.add_argument(flag, default=None, help="not yet ported")
        else:
            p.add_argument(flag, action="store_true", help="not yet ported")
    return p


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Train; returns the exit code.  ``result``, when given, receives the
    final state, the trainer, the metrics, the last accuracy and smoothed
    loss, and each round's wall seconds (from the round's start to its
    losses on the host) — for in-process callers that check the run."""
    args = _parser().parse_args(argv)
    for flag, _ in _NOT_YET_PORTED:
        if getattr(args, flag.lstrip("-")) not in (None, False):
            raise SystemExit(
                f"cifar_app: {flag} is not yet ported to sparknet_tpu_torch"
            )

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps.scores import primary_accuracy
    from sparknet_tpu_torch.data import (
        CifarLoader,
        MinibatchSampler,
        RoundFeed,
        stack_windows,
    )
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    device = resolve_device(args.device)
    n_workers = args.workers or (
        torch.cuda.device_count() if device.type == "cuda" else 1
    )
    with tempfile.TemporaryDirectory(prefix="cifar_synth_") as synth, \
            TrainingLog(tag="cifar") as log:
        data_dir = args.data
        if data_dir is None:
            data_dir = synth
            CifarLoader.write_synthetic(data_dir, num_train=5000, num_test=1000)
            log.log(f"synthesized CIFAR-format data in {data_dir}")
        log.log(f"num workers: {n_workers} on {device}")
        loader = CifarLoader(data_dir, seed=args.seed)
        log.log("loaded data")

        x, y = loader.minibatches(args.batch, train=True)
        if len(x) < n_workers * args.tau:
            raise SystemExit(
                f"need >= {n_workers * args.tau} minibatches, have {len(x)}"
            )
        # contiguous near-equal partitions; each worker's window sampler
        # draws tau from its own partition
        samplers = [
            MinibatchSampler({"data": xs, "label": ys},
                             num_sampled_batches=args.tau, seed=args.seed + w)
            for w, (xs, ys) in enumerate(
                zip(np.array_split(x, n_workers), np.array_split(y, n_workers))
            )
        ]
        xt, yt = loader.minibatches(args.batch, train=False)
        test_parts = [
            {"data": xs, "label": ys}
            for xs, ys in zip(np.array_split(xt, n_workers),
                              np.array_split(yt, n_workers))
        ]
        num_test_batches = len(xt)

        solver = Solver(models.load_model_solver("cifar10_full"), device=device)
        metrics = TrainingMetrics()
        trainer = ParameterAveragingTrainer(
            solver, n_workers, compress=args.compress,
            overlap_avg=args.overlap_avg, metrics=metrics,
        )
        state = trainer.init_state(seed=args.seed)
        test_batches, test_counts = ParameterAveragingTrainer.pad_partitions(
            test_parts
        )
        test_on_dev = {k: torch.from_numpy(v).to(device)
                       for k, v in test_batches.items()}
        log.log("finished setting up nets and weights")

        def evaluate() -> float:
            scores = trainer.test_and_store_result(
                state, test_on_dev, counts=test_counts
            )
            for name in sorted(scores):
                log.log(f"test output {name} = {scores[name] / num_test_batches:.4f}")
            return primary_accuracy(scores) / num_test_batches

        feed = RoundFeed(
            lambda r: stack_windows([s.next_window() for s in samplers]),
            device, pipelined=not args.serial_feed, num_rounds=args.rounds,
        )
        round_seconds = []
        try:
            for r in range(args.rounds):
                if r % args.test_every == 0:  # test before train, CifarApp.scala:101
                    # land any in-flight overlapped average before scoring
                    state = trainer.finalize(state)
                    log.log(f"round {r}, accuracy {evaluate():.4f}")
                t0 = time.perf_counter()
                state, _ = trainer.round(state, feed.next_round(r), round_index=r)
                # reading the smoothed loss waits for the round's losses
                loss = solver.smoothed_loss
                round_seconds.append(time.perf_counter() - t0)
                log.log(f"round {r} trained, smoothed_loss {loss:.4f}")
            state = trainer.finalize(state)  # the last round's average lands
            acc = evaluate()
            log.log(f"final accuracy {acc:.4f}")
        finally:
            feed.stop()
        if result is not None:
            result.update(state=state, trainer=trainer, accuracy=acc,
                          smoothed_loss=solver.smoothed_loss, metrics=metrics,
                          round_seconds=round_seconds)
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
