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
``--data`` is omitted.  ``--health`` (this app keeps no snapshots, so
``rollback`` degrades to ``halt``), ``--flight_recorder``, ``--journal``
(progress-only commits, ``durable=False``), ``--slices`` /
``--cross_slice_every`` and ``--elastic --rejoin_after N`` (the
membership controller: a SIGTERM marks this process's slice,
``$SPARKNET_SLICE_ID`` or the last, leaving; a departed slice rejoins
from the survivor consensus with its momentum zeroed) are the JAX app's.
``--stale_bound B --stale_discount D`` averages through the
bounded-staleness trainer (``parallel/stale.py``; this app feeds every
worker each round, so every boundary sees the full arrival set) and
``--profile`` / ``--profile_out`` install the round profiler (the
window draws are timed per worker).  ``--obs`` is not yet ported and
exits saying so.

Across processes (``tools/launch.py``, or any caller that joined through
``parallel.mesh.initialize_distributed`` first) the app runs the JAX
app's multi-process mode: ``--workers`` must equal the global worker
count (processes x the workers each stacks), every process computes the
same partitioning and keeps only its own block of workers (its
partitions, its samplers seeded by global worker index, its test rows),
the average reduces over the dp group, and only rank 0 echoes its log.
The failure and straggler machinery runs there too: ``--slices`` /
``--cross_slice_every`` (a slice whose workers span ranks averages over
a group of its own), ``--elastic`` (each rank's SIGTERM marks
``$SPARKNET_SLICE_ID``, the launcher's slice of the process; the ranks
agree on the events at every boundary, so they share one view),
``--stale_bound``, ``--journal`` (rank 0 writes the one ledger) and
``--profile`` / ``--profile_out`` (every rank's workers gathered into one
table, written by rank 0).  ``--overlap_avg`` stays single-process
(refused, as in JAX).
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

TAU = 10  # reference: syncInterval = 10, CifarApp.scala:119

def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.io import journal
    from sparknet_tpu_torch.parallel import comm, hierarchy

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
    obs.add_cli_args(p)  # --obs / --trace_out / --slo / --health / ...
    comm.add_cli_args(p)  # --compress / --overlap_avg
    hierarchy.add_cli_args(p)  # --slices / --cross_slice_every / --elastic
    journal.add_cli_args(p)  # --journal / --no_journal / ...
    return p


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Train; returns the exit code (1 when the sentry halts).
    ``result``, when given, receives the final state, the trainer, the
    metrics, the sentry and the membership controller, the last accuracy
    and smoothed loss, each round's wall seconds (from the round's start
    to its losses on the host) and live mask (``masks``, None without
    ``--elastic``) — for in-process callers that check the run."""
    args = _parser().parse_args(argv)
    from sparknet_tpu_torch import models, obs
    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.apps.scores import primary_accuracy
    from sparknet_tpu_torch.data import (
        CifarLoader,
        MinibatchSampler,
        RoundFeed,
        stack_windows,
    )
    from sparknet_tpu_torch.obs import profile
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    from sparknet_tpu_torch.parallel import mesh as mesh_mod

    distributed = mesh_mod.process_count() > 1
    if distributed:
        device = mesh_mod.app_device(args.device, "cifar_app")
        n_workers, mesh = mesh_mod.app_mesh(args, "cifar_app")
        mine = mesh_mod.local_worker_slice(mesh)
    else:
        device = resolve_device(args.device)
        n_workers = args.workers or (
            torch.cuda.device_count() if device.type == "cuda" else 1
        )
        mesh, mine = None, slice(0, n_workers)
    rank = mesh_mod.process_index()
    with tempfile.TemporaryDirectory(prefix="cifar_synth_") as synth, \
            TrainingLog(tag="cifar" if rank == 0 else f"cifar_p{rank}",
                        echo=rank == 0) as log:
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
        # (across processes: this process's block of them)
        samplers = [
            MinibatchSampler({"data": xs, "label": ys},
                             num_sampled_batches=args.tau, seed=args.seed + w)
            for w, (xs, ys) in enumerate(
                zip(np.array_split(x, n_workers), np.array_split(y, n_workers))
            )
            if mine.start <= w < mine.stop
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
        # this app keeps no snapshots: rollback degrades to halt, and the
        # journal's commits mark in-memory progress only
        guards = RoundGuards.from_args(
            args, solver, n_workers, log=log,
            metrics=metrics, journal_path="cifar_run.journal", mesh=mesh)
        trainer = guards.trainer
        state = trainer.init_state(seed=args.seed)
        test_batches, test_counts = ParameterAveragingTrainer.pad_partitions(
            test_parts
        )
        test_on_dev = {k: torch.from_numpy(v[mine]).to(device)
                       for k, v in test_batches.items()}
        log.log("finished setting up nets and weights")

        def evaluate() -> float:
            scores = trainer.test_and_store_result(
                state, test_on_dev, counts=test_counts
            )
            at = log.elapsed()  # one stamp: one parse_log test row
            for name in sorted(scores):
                log.log(f"test output {name} = {scores[name] / num_test_batches:.4f}",
                        elapsed=at)
            return primary_accuracy(scores) / num_test_batches

        # the run's telemetry (--obs, --trace_out, --slo, --ship_to,
        # --fleet_collector, --profile, --flight_recorder)
        run_obs = obs.start_from_args(args, echo=log.log, tm=metrics)
        # --profile: each worker's window draw timed (the straggler
        # verdict's assemble attribution); a plain list otherwise
        feed = RoundFeed(
            lambda r: stack_windows(profile.timed_worker_windows(
                r, [s.next_window for s in samplers])),
            device, pipelined=not args.serial_feed, num_rounds=args.rounds,
        )
        round_seconds, masks = [], []
        code, acc = 0, float("nan")
        try:
            with guards.signals():
                for r in range(args.rounds):
                    if r % args.test_every == 0:  # test before train, CifarApp.scala:101
                        # land any in-flight overlapped average before scoring
                        state = trainer.finalize(state)
                        log.log(f"round {r}, accuracy {evaluate():.4f}")
                    t0 = time.perf_counter()
                    guards.begin(r, iter=r * args.tau, cursor=r)
                    state, mask = guards.boundary(state, r)
                    masks.append(mask)
                    if mask is not None and not mask.any():
                        log.log(f"round {r}: no live workers in the membership "
                                "view; stopping")
                        break
                    state, _ = guards.round(state, feed.next_round(r), mask, r)
                    # reading the smoothed loss waits for the round's losses
                    loss = solver.smoothed_loss
                    round_seconds.append(time.perf_counter() - t0)
                    log.log(f"round {r} trained, smoothed_loss {loss:.4f}")
                    guards.commit(r, iter=(r + 1) * args.tau, durable=False)
            state = trainer.finalize(state)  # the last round's average lands
            acc = evaluate()
            log.log(f"final accuracy {acc:.4f}")
        except SentryHalt as e:
            log.log(f"training halted by the health sentry: {e}")
            code = 1
        finally:
            feed.stop()
            guards.close()
            run_obs.close()
        if result is not None:
            result.update(state=state, trainer=trainer, accuracy=acc,
                          smoothed_loss=solver.smoothed_loss, metrics=metrics,
                          round_seconds=round_seconds, sentry=guards.sentry,
                          membership=guards.membership, masks=masks,
                          profile=run_obs.profile_summary)
        return code


if __name__ == "__main__":
    raise SystemExit(main())
