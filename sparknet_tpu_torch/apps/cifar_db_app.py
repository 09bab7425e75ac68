"""CifarDBApp — the DB-path training app for cifar10_full.

The port of ``sparknet_tpu/apps/cifar_db_app.py`` (reference:
``CifarDBApp.scala``): phase 1 (``create_dbs``) shards the train set
into one record DB a worker and writes the test DB and the mean image
(CreateDB + ComputeMean; the files are the JAX app's byte for byte);
phase 2 feeds the tau-averaging loop of cifar10_full from
``runtime.DataPipeline`` readers (mean subtracted on the host), the W
workers stacked on one device, and scores the final state on two test
batches a worker.  It keeps no snapshots, as in the JAX package.

Run (on the card; ``--device cpu`` runs the plain versions on the CPU)::

    python -m sparknet_tpu_torch.apps.cifar_db_app --workers 2 --rounds 6

CIFAR-format data is synthesized (4,000 train / 500 test) when
``--data`` is omitted.  ``--health`` (rollback degrades to halt: no
snapshots), ``--flight_recorder``, ``--journal`` (progress-only
commits), ``--slices`` / ``--cross_slice_every`` are the JAX app's;
``--elastic`` only logs that membership is wired in ``cifar_app`` and
``lm_app``.  ``--stale_bound`` / ``--stale_discount`` (the
bounded-staleness trainer) and ``--profile`` / ``--profile_out`` (each
worker's DB pull timed) are the JAX app's; ``--obs`` is not yet ported
and exits saying so.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

def create_dbs(data_dir: str, out_dir: str, n_workers: int, seed: int = 0):
    """Phase 1: the train set dealt into per-worker DBs, the test DB and
    the mean image (CreateDB + ComputeMean).  Returns ``(train paths,
    test path, mean path)``."""
    from sparknet_tpu_torch import runtime
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.io import save_mean_image

    loader = CifarLoader(data_dir, seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for w in range(n_workers):
        path = os.path.join(out_dir, f"train_shard_{w}.sndb")
        runtime.write_datum_db(path, loader.train_images[w::n_workers],
                               loader.train_labels[w::n_workers])
        paths.append(path)
    test_path = os.path.join(out_dir, "test.sndb")
    runtime.write_datum_db(test_path, loader.test_images, loader.test_labels)
    mean_path = os.path.join(out_dir, "mean.binaryproto")
    save_mean_image(loader.mean_image, mean_path)
    return paths, test_path, mean_path


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.io import journal
    from sparknet_tpu_torch.parallel import comm, hierarchy

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.cifar_db_app")
    p.add_argument("--data", default=None, help="CIFAR binary dir")
    p.add_argument("--db_dir", default=None,
                   help="where the DBs go (default: a temporary directory)")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--tau", type=int, default=10)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serial_feed", action="store_true",
                   help="assemble and copy each round's batch on the "
                   "training thread instead of the producer thread")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or "
                   "cpu (the kernels' plain versions)")
    obs.add_cli_args(p)  # --obs / --trace_out / --slo / --health / ...
    comm.add_cli_args(p)  # --compress / --overlap_avg
    hierarchy.add_cli_args(p)  # --slices / --cross_slice_every / --elastic
    journal.add_cli_args(p)  # --journal / --no_journal / ...
    return p


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Create the DBs and train; returns the exit code (1 when the sentry
    halts).  ``result``, when given, receives the final state, the
    trainer, the sentry, each round's
    per-worker losses (``losses``: (rounds, W, tau)), the smoothed loss
    after each round (``smoothed``), the test scores and the accuracy."""
    args = _parser().parse_args(argv)
    from sparknet_tpu_torch import models, obs, runtime
    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.data import CifarLoader, RoundFeed, stack_windows
    from sparknet_tpu_torch.obs import profile
    from sparknet_tpu_torch.io import load_mean_image
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="cifar_db_") as tmp, \
            TrainingLog(tag="cifar_db") as log:
        data_dir = args.data
        if data_dir is None:
            data_dir = os.path.join(tmp, "cifar")
            CifarLoader.write_synthetic(data_dir, num_train=4000, num_test=500)
            log.log(f"synthesized CIFAR data in {data_dir}")
        db_dir = args.db_dir or os.path.join(tmp, "dbs")
        shard_paths, test_path, mean_path = create_dbs(
            data_dir, db_dir, args.workers, args.seed)
        log.log(f"created {len(shard_paths)} train DBs + test DB in {db_dir}")

        mean = load_mean_image(mean_path)
        common = dict(batch_size=args.batch, shape=(3, 32, 32), mean=mean)
        pipes, feed, guards, run_obs = [], None, None, obs.ObsRun()
        code, scores, acc, state, trainer = 0, {}, float("nan"), None, None
        round_losses, smoothed = [], []
        try:
            for w, p in enumerate(shard_paths):
                pipes.append(runtime.DataPipeline(p, train=True,
                                                  seed=args.seed + w, **common))
            pipes.append(runtime.DataPipeline(test_path, train=False, **common))
            *train_pipes, test_pipe = pipes

            solver = Solver(models.load_model_solver("cifar10_full"),
                            device=device)
            metrics = TrainingMetrics()
            # no snapshots: rollback degrades to halt, commits are
            # progress marks
            guards = RoundGuards.from_args(
                args, solver, args.workers, log=log,
                metrics=metrics, journal_path="cifar_db_run.journal",
                wire_membership=False)
            trainer = guards.trainer
            state = trainer.init_state(seed=args.seed)
            log.log(f"nets ready ({args.workers} workers on {device})")
            run_obs = obs.start_from_args(args, echo=log.log, tm=metrics)

            def assemble(r):
                # the reader threads' batches + the worker stack, on the
                # feed's producer: round r+1's reads overlap round r
                # (--profile: each worker's DB pull timed)
                windows = []
                for w, p in enumerate(train_pipes):
                    with profile.worker_timer(r, w, len(train_pipes)):
                        batches = [p.next() for _ in range(args.tau)]
                    windows.append({
                        "data": np.stack([b[0] for b in batches]),
                        "label": np.stack([b[1] for b in batches]),
                    })
                return stack_windows(windows)

            feed = RoundFeed(assemble, device, pipelined=not args.serial_feed,
                             num_rounds=args.rounds)
            for r in range(args.rounds):
                guards.begin(r, iter=r * args.tau, cursor=r)
                state, losses = guards.round(state, feed.next_round(r), None, r)
                round_losses.append(losses.detach().cpu().numpy())
                smoothed.append(solver.smoothed_loss)
                log.log(f"round {r} trained, smoothed_loss {smoothed[-1]:.4f}")
                guards.commit(r, iter=(r + 1) * args.tau, durable=False)
            state = trainer.finalize(state)  # the last round's average lands
            # eval from the test DB: two batches a worker
            nb = 2
            tb = [test_pipe.next() for _ in range(args.workers * nb)]
            test = {
                "data": np.stack([b[0] for b in tb]).reshape(
                    args.workers, nb, args.batch, 3, 32, 32),
                "label": np.stack([b[1] for b in tb]).reshape(
                    args.workers, nb, args.batch),
            }
            scores = trainer.test_and_store_result(
                state, {k: torch.from_numpy(v).to(device)
                        for k, v in test.items()})
            acc = scores.get("accuracy", 0.0) / (args.workers * nb)
            log.log(f"final accuracy {acc:.4f}")
        except SentryHalt as e:
            log.log(f"training halted by the health sentry: {e}")
            code = 1
        finally:
            if feed is not None:
                feed.stop()
            for p in pipes:
                p.close()
            if guards is not None:
                guards.close()
            run_obs.close()
    if result is not None:
        result.update(
            state=state, trainer=trainer, metrics=metrics, scores=scores,
            sentry=guards.sentry, profile=run_obs.profile_summary,
            accuracy=acc, smoothed=smoothed,
            losses=(np.stack(round_losses) if round_losses
                    else np.zeros((0, args.workers, args.tau), np.float32)),
        )
    return code


if __name__ == "__main__":
    raise SystemExit(main())
