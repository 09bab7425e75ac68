"""ImageNetRunDBApp — phase 2 of the two-phase ImageNet DB path.

The port of ``sparknet_tpu/apps/imagenet_run_db_app.py`` (reference:
``ImageNetRunDBApp.scala:40-117``): read the infoFile and the mean image
that ``imagenet_create_db_app`` wrote, feed each worker from its record
DB through ``runtime.DataPipeline`` (random crop + mirror and the mean
subtracted on the host for training, centre crop for testing), optionally
warm-start from a ``.caffemodel`` (``net.loadWeightsFromFile``,
``:72-77``), then the tau-averaging loop with the W workers stacked on
one device, testing every ``--test_every`` rounds on the padded and
masked test partitions.  On the card every LRN forward runs K5 and
every LRN backward K6 (``ops/cuda_lrn.py``); ``--compress`` routes the
average through K9/K10 (``ops/cuda_comm.py``).

Snapshots: ``--snapshot_every k`` publishes worker 0's consensus every
k rounds (``{prefix}_iter_N.caffemodel`` / ``.solverstate.npz``, the
JAX package's files) with a ``.jobstate.npz`` (every worker's momentum,
the comm residuals, the loss window and the cursor ``{"round": r}``).
``--resume`` restarts from the newest snapshot that verifies (corrupt
ones are quarantined) at round ``iter // tau`` and continues bit for
bit (``--overlap_avg`` is refused with snapshots: it leaves the workers'
params apart, where the JAX app snapshots worker 0's all the same): each train pipeline opens at the record the uninterrupted run
would read next (``start = round * tau * train_batch``), where the JAX
app reopens them at record 0.  Every run trains inside
``utils.devices.deterministic_algorithms``, so an uninterrupted and a
resumed run on the card take the same algorithms.  ``--rounds`` is the
number of rounds this invocation runs, as in the JAX app.

Run (on the card; ``--device cpu`` runs the kernels' plain versions)::

    python -m sparknet_tpu_torch.apps.imagenet_run_db_app --db_dir DB_DIR \\
        --rounds 20 [--warm_start weights.caffemodel]

Training health and crash consistency, as in the JAX app: ``--health``
(the audit, the in-round worker mask and the sentry; rollback restores
through the snapshot prefix), ``--flight_recorder``, ``--journal`` (the
round ledger ``{prefix}_run.journal``: each ``--snapshot_every``
boundary commits with its snapshot ref, and a ``--resume`` that finds
the ledger rewinds to the last committed boundary, replaying only the
round in flight), ``--slices`` / ``--cross_slice_every`` (the two-tier
schedule).  ``--elastic`` only logs that membership is wired in
``cifar_app`` and ``lm_app``, as the JAX app does.  The jobstate
carries the sentry's state.

``--db_dir`` may be an object-store URL (``gs://``, ``s3://``,
``http(s)://``, ``file://``): the DB files are staged through the chunk
cache (``--cache_dir``, ``--cache_bytes``) to verified local paths, so a
restarted run re-verifies local bytes instead of downloading them again.
As in the JAX app, a remote ``--db_dir`` with ``--snapshot_every`` or
``--resume`` needs a stable ``--cache_dir`` or ``--snapshot_prefix``.
``--shuffle_epochs N`` splits ``--rounds`` into N epochs and permutes
which worker reads which train DB between them
(``shuffle.permutation(W, seed, epoch)``, keyed by the absolute round);
each DB is still read tau batches a round, so a resumed run's readers
open where the uninterrupted run's would be.  ``--stale_bound`` /
``--stale_discount`` run the bounded-staleness trainer (its snapshots
carry the ledger and every worker's replica, its journal records
``worker_rounds``) and ``--profile`` / ``--profile_out`` the round
profiler (each worker's DB pull timed); ``--obs`` is not yet ported
and exits saying so.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

TAU = 50  # syncInterval, ImageNetRunDBApp.scala:104
_MODELS = ("caffenet", "alexnet")


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.io import journal
    from sparknet_tpu_torch.parallel import comm, hierarchy

    p = argparse.ArgumentParser(
        prog="sparknet_tpu_torch.apps.imagenet_run_db_app")
    p.add_argument("--db_dir", required=True,
                   help="what imagenet_create_db_app wrote: a directory or "
                   "a gs://|s3://|http(s)://|file:// url")
    p.add_argument("--model", default="caffenet", help="caffenet | alexnet")
    p.add_argument("--rounds", type=int, default=10,
                   help="rounds this invocation runs")
    p.add_argument("--tau", type=int, default=0, help="0 = reference (50)")
    p.add_argument("--test_every", type=int, default=10)
    p.add_argument("--crop", type=int, default=0,
                   help="0 = 227 from 256, else 7/8 of the full size")
    p.add_argument("--no_mirror", action="store_true")
    p.add_argument("--warm_start", default=None,
                   help=".caffemodel[.h5] to load weights from")
    p.add_argument("--snapshot_every", type=int, default=0,
                   help="snapshot every N rounds")
    p.add_argument("--snapshot_prefix", default=None,
                   help="default: DB_DIR/imagenet_db")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest valid snapshot")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shuffle_epochs", type=int, default=0,
                   help="split --rounds into N epochs and re-permute which "
                   "worker reads which train DB between them (seeded "
                   "shuffle-by-assignment; no bytes move); 0/1 = fixed")
    p.add_argument("--cache_dir", default=None,
                   help="when --db_dir is an object-store url, stage the DB "
                   "files through the chunk cache rooted here (default: a "
                   "temporary directory)")
    p.add_argument("--cache_bytes", default="0",
                   help="chunk-cache LRU byte budget, e.g. 512M / 8G "
                   "(0 = unbounded)")
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
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The app's arguments, refusing what is not yet ported."""
    from sparknet_tpu_torch.data import object_store

    args = _parser().parse_args(argv)
    if (object_store.is_object_store_url(args.db_dir)
            and args.cache_dir is None and args.snapshot_prefix is None
            and (args.resume or args.snapshot_every)):
        # snapshots would land in a fresh temporary cache directory that
        # the next invocation cannot find
        raise SystemExit(
            "imagenet_run_db: a remote --db_dir with --snapshot_every/"
            "--resume needs a stable --cache_dir or an explicit "
            "--snapshot_prefix (snapshots in a temp-dir cache would be "
            "unfindable on restart)")
    if args.model not in _MODELS:
        raise SystemExit(
            f"imagenet_run_db: --model {args.model} is not yet ported to "
            f"sparknet_tpu_torch (have {', '.join(_MODELS)})"
        )
    if args.overlap_avg and (args.snapshot_every or args.resume):
        # after an overlapped average the workers' params are not one
        # consensus, and a snapshot keeps worker 0's (as lm_app refuses)
        raise SystemExit(
            "imagenet_run_db: --overlap_avg with --snapshot_every/--resume: "
            "a snapshot keeps worker 0's params, and an overlapped average "
            "leaves the workers apart, so a resumed run could not repeat "
            "the uninterrupted one"
        )
    args.tau = args.tau or TAU
    return args


def build_solver(model: str, info: dict, crop: int, device):
    """The model's solver at the DB's batch shapes, cropped
    (``replaceDataLayers``); the host pipelines transform the batches."""
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.solver import Solver

    netp = (models.load_model(model, classes=int(info["classes"]))
            if model == "caffenet" else models.load_model(model))
    tb, vb = int(info["train_batch"]), int(info["test_batch"])
    netp = config.replace_data_layers(
        netp, [(tb, 3, crop, crop), (tb,)], [(vb, 3, crop, crop), (vb,)])
    return Solver(models.load_model_solver(model), net_param=netp,
                  device=device)


def db_files(db_dir: str, cache_dir: Optional[str] = None, cache_bytes=0,
             log=None):
    """``name -> local path`` of the DB directory's files.  An object
    store's files are staged through a ``ChunkCache`` rooted at
    ``cache_dir`` (a temporary directory when None): CRC-verified,
    pinned local paths.  Returns ``(path_of, cache root or None)``."""
    from sparknet_tpu_torch.data import chunk_cache, object_store

    if not object_store.is_object_store_url(db_dir):
        return (lambda name: os.path.join(db_dir, name)), None
    root = cache_dir or tempfile.mkdtemp(prefix="sparknet_db_cache_")
    store = object_store.open_store(db_dir)
    cache = chunk_cache.ChunkCache(
        root, byte_budget=chunk_cache.parse_bytes(cache_bytes))
    if log is not None:
        log.log(f"staging {db_dir} through chunk cache {root}")
    return (lambda name: cache.local_path(store, name)), root


def open_pipes(db_dir: str, info: dict, crop: int, mirror: bool, seed: int,
               start: int = 0, native: bool = True, path_of=None):
    """Per-worker train pipelines (random crop + mirror, seeded
    ``seed + w``, opened at record sequence ``start``) and test pipelines
    (centre crop, seeded ``seed``) over the DB directory (its files found
    through ``path_of``, ``db_files``'s, when given)."""
    from sparknet_tpu_torch import runtime
    from sparknet_tpu_torch.io import load_mean_image

    path_of = path_of or db_files(db_dir)[0]
    full = int(info["full_size"])
    mean = load_mean_image(path_of("imagenet_mean.binaryproto"))
    common = dict(shape=(3, full, full), crop=crop, mean=mean, native=native)
    pipes, test_pipes = [], []
    try:
        for w in range(int(info["workers"])):
            pipes.append(runtime.DataPipeline(
                path_of(f"ilsvrc12_train_db_{w}.sndb"),
                batch_size=int(info["train_batch"]), mirror=mirror,
                train=True, seed=seed + w, start=start, **common))
            test_pipes.append(runtime.DataPipeline(
                path_of(f"ilsvrc12_val_db_{w}.sndb"),
                batch_size=int(info["test_batch"]), train=False, seed=seed,
                **common))
    except BaseException:
        for p in pipes + test_pipes:
            p.close()
        raise
    return pipes, test_pipes


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Train; returns the exit code.  ``result``, when given, receives the
    final state, the trainer, the metrics, the first round this run
    trained (``start_round``), each round's per-worker losses
    (``losses``: (rounds, W, tau)), smoothed loss (``smoothed``) and wall
    seconds, the accuracies (``accuracies``, the final last), the
    snapshot a resumed run started from (``resumed_from``) and the
    snapshots written (solverstate paths)."""
    args = parse_args(argv)
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.data import object_store
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics

    obs.check_args(args, "imagenet_run_db")

    from sparknet_tpu_torch.utils.devices import (
        deterministic_algorithms,
        resolve_device,
    )

    device = resolve_device(args.device)
    metrics = TrainingMetrics()
    # on every run, before the first CUDA op: an uninterrupted and a
    # resumed run take the same (deterministic) algorithms
    with deterministic_algorithms(), obs.installed_metrics(metrics):
        return _train(args, device, metrics, result)


def _train(args, device, metrics, result) -> int:
    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.apps.scores import primary_accuracy
    from sparknet_tpu_torch.data import RoundFeed, shuffle, stack_windows
    from sparknet_tpu_torch.obs import profile
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.io.journal import default_journal_path
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.parallel import first_worker
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    code = 0
    with TrainingLog(tag="imagenet_run_db") as log:
        # an object-store --db_dir stages its files through the chunk
        # cache to verified local paths, and its default snapshot prefix
        # lies in the cache
        path_of, cache_root = db_files(args.db_dir, args.cache_dir,
                                       args.cache_bytes, log)
        prefix = args.snapshot_prefix or os.path.join(
            cache_root or args.db_dir, "imagenet_db")
        if args.resume and not checkpoint.find_snapshots(prefix):
            raise SystemExit(f"--resume: no {prefix}_iter_*.solverstate*")
        with open(path_of("imagenet_db_info.json")) as f:
            info = json.load(f)
        n_workers = int(info["workers"])
        full = int(info["full_size"])
        crop = args.crop or (227 if full >= 256 else (full * 7) // 8)
        train_batch = int(info["train_batch"])
        counts = np.asarray(info["test_batches"], np.int32)
        num_test_mbs = int(counts.sum())
        log.log(f"testPartitionSizes = {info['test_batches']}")
        solver = build_solver(args.model, info, crop, device)
        guards = RoundGuards.from_args(
            args, solver, n_workers, app="imagenet_run_db", log=log,
            metrics=metrics, journal_path=default_journal_path(prefix),
            resuming=args.resume, wire_membership=False, restore_prefix=prefix)
        trainer, jr = guards.trainer, guards.journal
        state, start_round, used, replayed = None, 0, None, None
        if args.resume:
            # CRC-verified, newest-valid-wins: a corrupt newest snapshot
            # is quarantined and the scan falls back to an older one; with
            # a ledger, snapshots past the last commit are ignored
            try:
                if jr is not None and jr.last_committed_round is not None:
                    st, used, js, jinfo = \
                        checkpoint.restore_newest_valid_journaled(
                            solver, prefix, jr, metrics=metrics)
                    state, start_round, js = trainer.resume_from(
                        st, used, js, args.tau)
                    replayed = jinfo["in_flight_round"]
                    if replayed is not None:
                        metrics.recover_replayed.inc()
                        log.log("journal: round %d was in flight at the crash "
                                "— re-executing it" % replayed)
                else:
                    state, start_round, used, js = trainer.resume_newest(
                        prefix, args.tau, metrics=metrics)
            except checkpoint.SnapshotCorrupt as e:
                raise SystemExit(f"--resume: {e}")
            guards.restore_job(js)
            cursor = js.get("cursor") or {}
            if "round" in cursor and (
                    int(cursor["round"]) != start_round
                    or start_round * args.tau != int(state.iter[0])):
                raise SystemExit(
                    f"imagenet_run_db: the snapshot ends round "
                    f"{int(cursor['round'])} at iter {int(state.iter[0])}; "
                    f"--tau {args.tau} would draw rounds the uninterrupted "
                    "run never drew — resume with its --tau"
                )
            log.log(f"resumed from {used} at round {start_round}")
        else:
            state = trainer.init_state(seed=args.seed)
            if args.warm_start:
                # ImageNetRunDBApp.scala:75 loadWeightsFromFile
                state = trainer.broadcast_state(
                    checkpoint.load_weights_into_state(
                        solver, first_worker(state), args.warm_start))
                log.log(f"warm start from {args.warm_start}")
        log.log(f"initialize nets on {n_workers} workers on {device}")

        # every train pipe opens at the record the uninterrupted run reads
        # next: the rounds before start_round consumed tau batches each
        pipes, test_pipes = open_pipes(
            args.db_dir, info, crop, not args.no_mirror, args.seed,
            start=start_round * args.tau * train_batch, path_of=path_of)
        feed = None
        round_seconds, round_losses, smoothed = [], [], []
        accuracies, snapshots = [], []
        try:
            # pad-and-mask the heterogeneous test partitions (infoFile)
            nb_max = int(counts.max())
            tb = int(info["test_batch"])
            test = {"data": np.zeros((n_workers, nb_max, tb, 3, crop, crop),
                                     np.float32),
                    "label": np.zeros((n_workers, nb_max, tb), np.float32)}
            for w, pipe in enumerate(test_pipes):
                for b in range(int(counts[w])):
                    test["data"][w, b], test["label"][w, b] = pipe.next()
            for p in test_pipes:
                p.close()
            test_on_dev = {k: torch.from_numpy(v).to(device)
                           for k, v in test.items()}
            del test

            def evaluate() -> float:
                scores = trainer.test_and_store_result(state, test_on_dev,
                                                       counts=counts)
                return primary_accuracy(scores) / max(1, num_test_mbs)

            # --shuffle_epochs: worker w reads train DB order[w] in the
            # epoch, a seeded permutation keyed by the absolute round, so a
            # resumed run re-derives the table; every DB still yields tau
            # batches a round
            shuffled = args.shuffle_epochs > 1
            rounds_per_epoch = (-(-args.rounds // args.shuffle_epochs)
                                if shuffled else 0)

            def pipe_order(r):
                if not shuffled:
                    return range(n_workers)
                e = min(r // rounds_per_epoch, args.shuffle_epochs - 1)
                return shuffle.permutation(n_workers, args.seed, e)

            def assemble(r):
                # (--profile: each worker's DB pull timed)
                windows = []
                for w, p in enumerate(pipe_order(r)):
                    pipe = pipes[p]
                    with profile.worker_timer(r, w, n_workers):
                        batches = [pipe.next() for _ in range(args.tau)]
                    windows.append({
                        "data": np.stack([b[0] for b in batches]),
                        "label": np.stack([b[1] for b in batches]),
                    })
                return stack_windows(windows)

            feed = RoundFeed(assemble, device, pipelined=not args.serial_feed,
                             num_rounds=args.rounds, start_round=start_round)
            for r in range(start_round, start_round + args.rounds):
                if r % args.test_every == 0:
                    # land any in-flight overlapped average before scoring
                    state = trainer.finalize(state)
                    accuracies.append(evaluate())
                    log.log(f"{accuracies[-1] * 100:.2f}% accuracy", i=r)
                log.log("training", i=r)
                t0 = time.perf_counter()
                # write-ahead intent: a restart knows round r was in flight
                guards.begin(r, iter=r * args.tau, cursor=r)
                state, losses = guards.round(state, feed.next_round(r), None, r)
                round_losses.append(losses.detach().cpu().numpy())
                round_seconds.append(time.perf_counter() - t0)
                smoothed.append(solver.smoothed_loss)
                log.log(f"trained, smoothed_loss {smoothed[-1]:.4f}", i=r)
                if args.snapshot_every and (r + 1) % args.snapshot_every == 0:
                    extra = trainer.export_job_state(state, {"round": r + 1})
                    extra.update(guards.job_extra())
                    model_path, state_path = checkpoint.snapshot(
                        solver, first_worker(state), prefix,
                        fmt="BINARYPROTO", metrics=metrics, extra_state=extra,
                    )
                    snapshots.append(state_path)
                    # the durable boundary: the commit carries the snapshot
                    guards.commit(r, iter=(r + 1) * args.tau,
                                  snapshot=os.path.basename(state_path))
                    log.log(f"snapshot -> {model_path}", i=r)
            state = trainer.finalize(state)  # the last round's average lands
            acc = evaluate()
            accuracies.append(acc)
            log.log(f"final accuracy {acc * 100:.2f}%")
            print(f"final accuracy {acc * 100:.2f}%")
        except SentryHalt as e:
            # no snapshot of the condemned weights: the newest one on
            # disk predates the anomaly and stays the restore point
            log.log(f"training halted by the health sentry: {e}")
            code = 1
        finally:
            if feed is not None:
                feed.stop()
            for p in pipes + test_pipes:
                p.close()
            guards.close()
    if result is not None:
        result.update(
            state=state, trainer=trainer, metrics=metrics,
            profile=guards.profile_summary,
            sentry=guards.sentry, start_round=start_round, resumed_from=used,
            replayed_round=replayed, smoothed=smoothed,
            losses=(np.stack(round_losses) if round_losses
                    else np.zeros((0, n_workers, args.tau), np.float32)),
            round_seconds=round_seconds, accuracies=accuracies,
            snapshots=snapshots,
        )
    return code


if __name__ == "__main__":
    raise SystemExit(main())
