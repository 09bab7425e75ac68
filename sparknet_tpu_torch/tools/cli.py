"""Command-line entry point of the port: ``serve``, ``train``, ``test``.

The port of the ``serve``, ``train`` and ``test`` subcommands of
``sparknet_tpu/tools/cli.py``, with the same flags and defaults plus
``--device`` (default ``cuda``; ``--device=cpu`` runs the plain versions
of the kernels on the CPU)::

    python -m sparknet_tpu_torch.tools.cli serve --net caffenet \
        [--weights W.caffemodel] [--buckets 1,4,16,64] [--dtype bfloat16] \
        [--replicas N] [--watch PUBLISH_DIR] [--port 8361]
    python -m sparknet_tpu_torch.tools.cli serve --generate [--port 8361] \
        [--weights LM.caffemodel] [--replicas N]
    python -m sparknet_tpu_torch.tools.cli train --solver S.prototxt \
        [--data CIFAR_DIR] [--snapshot F.solverstate.npz | --resume | \
         --weights F.caffemodel] [--tau 10] [--max_iter N]
    python -m sparknet_tpu_torch.tools.cli train --lm [--dim 256 ...]
    python -m sparknet_tpu_torch.tools.cli test --model NET.prototxt \
        [--weights F.caffemodel] [--data DIR|LMDB|LEVELDB|DB] [--iterations 50]

``serve`` answers ``POST /predict`` on a deploy net (a zoo name or a
prototxt; a train/test net is taken to its deploy view), or ``POST
/generate`` with ``--generate``; ``--replicas`` serves a fleet behind a
load-shedding router, ``--watch`` canaries, promotes or rolls back the
snapshots published into a directory (``serve/publish.py``).
``train --lm`` hands the rest of the line to ``apps/lm_app.py``.
``test`` is ``caffe test``: a zero-rate solver over the prototxt, the
weights loaded, the TEST net scored over ``--iterations`` batches that
``data/source.py`` resolves (a CIFAR directory, an LMDB, a LevelDB, a
record DB or the net's ``Data`` source), one ``name = value`` line an
output.
``train --solver`` snapshots every ``snapshot`` iterations of the
solver (``{snapshot_prefix}_iter_N.*``, ``io/checkpoint.py``), on
SIGHUP and on SIGINT (then stops), and runs deterministic algorithms
so that a resumed run repeats the uninterrupted one bit for bit.
``train``'s ``--devices`` > 1, ``--journal``, ``--health``,
``--publish_to`` (which implies ``--health``), ``--obs``, the chunk
cache, ``--shuffle_epochs`` > 1 and an object-store ``--data``, and the
other subcommands (``classify``, ``time``, ``device_query``, the
converters, ...), come with later slices; the flags raise "not yet
ported" here.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def cmd_serve(args) -> int:
    """``serve --net D.prototxt|zoo-name [--weights W] [--buckets
    1,4,16,64] [--max_wait_ms 2] [--queue 256] [--dtype bfloat16]
    [--replicas N] [--watch PUBLISH_DIR]``: the ``/predict`` front end
    (``serve/``) — a deploy net run at fixed batch buckets, dynamic
    micro-batching, ``/healthz`` and ``/metrics``, SIGTERM drain.
    ``--replicas N`` serves a fleet (``serve/fleet.py``): N
    shared-nothing replicas behind a load-shedding router; ``--watch``
    adds the delivery controller (``serve/delivery.py``), which canaries
    the snapshots published there and promotes or rolls them back with
    no restart.  ``--generate`` serves a TransformerLM instead: greedy
    decode over a paged KV arena with continuous batching, tokens
    streamed on chunked-NDJSON ``POST /generate``; the fleet and delivery
    flags compose with it.  On the card unless ``--device=cpu``."""
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.serve import (
        DeliveryController,
        GenerationEngine,
        InferenceEngine,
        ReplicaPool,
        Router,
        ServeServer,
    )
    from sparknet_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)  # no card: raises, before any build
    if args.generate:
        from sparknet_tpu_torch.models.transformer_lm import TransformerLM

        gen_buckets = [
            int(b) for b in args.prefill_buckets.split(",") if b.strip()
        ]

        def make_engine(weights=None, device=device):
            # a module of its own per engine: the engine loads its
            # weights into the module, so replicas share nothing
            lm = TransformerLM(
                dim=args.lm_dim, depth=args.lm_depth, heads=args.lm_heads,
                seq_len=args.lm_seq_len,
            )
            return GenerationEngine(
                lm,
                weights=weights if weights is not None else args.weights,
                prefill_buckets=gen_buckets,
                max_streams=args.max_streams,
                kv_blocks=args.kv_blocks,
                kv_block_size=args.kv_block_size,
                device=device,
            )

    else:
        if not args.net:
            print("serve: --net is required without --generate",
                  file=sys.stderr)
            return 2
        netp = (
            config.load_net_prototxt(args.net)
            if args.net.endswith(".prototxt")
            else models.load_model(args.net)
        )
        buckets = [int(b) for b in args.buckets.split(",") if b.strip()]

        def make_engine(weights=None, device=device):
            return InferenceEngine(
                netp,
                weights=weights if weights is not None else args.weights,
                buckets=buckets,
                output_blob=args.output_blob,
                compute_dtype=args.dtype or None,
                device=device,
            )

    delivery = None
    if args.replicas > 1 or args.watch:
        pool = ReplicaPool(
            make_engine,
            replicas=args.replicas,
            max_queue=args.queue,
            max_wait_ms=args.max_wait_ms,
            stream=args.generate,
        )
        router = Router(
            pool, max_inflight=args.queue, canary_frac=args.canary_frac,
        )
        if args.generate:
            print(
                "serve: generation fleet of %d replica(s) warmed on %s "
                "(prefill buckets %s, %d decode slots, %d x %d KV blocks "
                "each) — POST /generate streams NDJSON"
                % (
                    len(pool.replicas), device, gen_buckets,
                    args.max_streams, args.kv_blocks, args.kv_block_size,
                )
            )
        else:
            print(
                "serve: fleet of %d replica(s) warmed on %s (%d bucket "
                "shapes each: %s), input %s"
                % (
                    len(pool.replicas), device, len(buckets), buckets,
                    pool.item_shape,
                )
            )
        if args.watch:
            delivery = DeliveryController(
                pool, router, args.watch,
                cache_dir=args.cache_dir,
                decision_requests=args.decision_requests,
                divergence_max=args.divergence_max,
                echo=print,
            ).start()
            print(f"serve: delivery watcher on {args.watch}")
        server = ServeServer(
            router=router,
            delivery=delivery,
            host=args.host,
            port=args.port,
            verbose=args.verbose,
        )
    else:
        engine = make_engine()
        n = engine.warmup()
        if args.generate:
            print(
                "serve: warmed %d shapes (prefill buckets %s + decode + "
                "score) on %s, %d decode slots, %d x %d KV blocks — POST "
                "/generate streams NDJSON"
                % (
                    n, engine.buckets, engine.device, args.max_streams,
                    args.kv_blocks, args.kv_block_size,
                )
            )
        else:
            print(
                f"serve: warmed {n} bucket shapes {engine.buckets} on "
                f"{engine.device} for input {engine.item_shape}, output "
                f"blob {engine.output_blob!r}"
            )
        server = ServeServer(
            engine,
            host=args.host,
            port=args.port,
            max_queue=args.queue,
            max_wait_ms=args.max_wait_ms,
            verbose=args.verbose,
        )
    if args.result is not None:
        # in-process callers (tests, chip_smoke) drive the server
        # themselves: start() / shutdown() instead of the signal loop
        args.result.update(server=server, delivery=delivery)
        return 0
    return server.run()


# train flags of the JAX CLI that later slices bring: (flag, refused when)
_TRAIN_NOT_YET_PORTED = (
    ("--devices", lambda a: a.devices > 1, " > 1 (allreduce data parallelism)"),
    ("--cache_dir", lambda a: a.cache_dir or a.cache_bytes != "0",
     " / --cache_bytes (the chunk cache)"),
    ("--shuffle_epochs", lambda a: a.shuffle_epochs > 1, " > 1"),
    ("--data", lambda a: a.data and "://" in a.data, " from an object store"),
)


def cmd_train(args) -> int:
    """``train --solver``: one solver steps tau iterations a window,
    with snapshots every ``solver_param.snapshot`` iterations, on SIGHUP
    and on a STOP signal (the JAX ``cli train``, one device).
    ``--journal`` brackets each window with the round ledger (a commit
    rides each published snapshot; a resume that finds the ledger is
    journal-guided), ``--health`` guards each window with the sentry,
    and ``--publish_to DIR`` (implying ``--health warn``) publishes the
    final state with the sentry's verdict (``serve/publish.py``)."""
    if args.solver is None:
        raise SystemExit("train: --solver is required without --lm")
    from sparknet_tpu_torch import obs

    obs.check_args(args, "train")
    for flag, refused, what in _TRAIN_NOT_YET_PORTED:
        if refused(args):
            raise SystemExit(
                f"train: {flag}{what} is not yet ported to sparknet_tpu_torch"
            )
    # a publish carries the sentry's verdict: an unaudited run has none
    if args.publish_to and not args.health and not args.health_policy:
        args.health = "warn"
    # pure argument conflicts fail BEFORE any model/device setup
    if args.resume and (args.snapshot or args.weights):
        print(
            "train: --resume scans the solver's snapshot_prefix and "
            "conflicts with --snapshot/--weights — pass one or the other",
            file=sys.stderr,
        )
        return 1
    if args.compress != "none" or args.overlap_avg:
        print(
            "train: --compress/--overlap_avg apply to tau-round parameter "
            "averaging — use the averaging apps (apps.cifar_app, "
            "apps.imagenet_app, apps.lm_app)",
            file=sys.stderr,
        )
        return 1

    from sparknet_tpu_torch.utils.devices import (
        deterministic_algorithms,
        resolve_device,
    )

    device = resolve_device(args.device)
    # on every run, resumed or not, before the first CUDA op: both take
    # the same algorithms
    with deterministic_algorithms():
        return _train_solver(args, device)


def _train_solver(args, device) -> int:
    from sparknet_tpu_torch import config, obs
    from sparknet_tpu_torch.io import journal as journal_mod
    from sparknet_tpu_torch.obs import flight
    from sparknet_tpu_torch.obs import health as health_mod
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.solver import Solver

    solver_param = config.load_solver_prototxt(args.solver)
    solver = Solver(solver_param, device=device)
    metrics = TrainingMetrics()
    # one prefix rule for writing snapshots and for --resume's scan
    prefix = solver_param.snapshot_prefix or "snapshot"
    # the round ledger beside the snapshots; a --resume that finds one
    # consumes it (the auto rule)
    jr = journal_mod.journal_from_args(
        args, journal_mod.default_journal_path(prefix), resuming=args.resume,
        metrics=metrics)
    if jr is not None:
        print(f"run journal: {jr.path} (fsync={jr.fsync})")
    # the sentry turns the solver's audit on and guards every window;
    # rollback restores through the same prefix
    sentry = health_mod.sentry_from_args(args, solver, echo=print,
                                         metrics=metrics)
    if sentry is not None:
        sentry.restore_fn = health_mod.make_restore_fn(solver, prefix,
                                                       metrics=metrics)
    recorder = obs.flight_from_args(args, metrics=metrics)
    try:
        return _train_loop(args, solver, solver_param, metrics, prefix, jr,
                           sentry)
    finally:
        if jr is not None:
            jr.close()
        if recorder is not None:
            flight.uninstall(recorder)
        if sentry is not None:
            obs.set_sentry(None)


def _train_loop(args, solver, solver_param, metrics, prefix, jr, sentry) -> int:
    from sparknet_tpu_torch.data import CifarLoader, MinibatchSampler, RoundFeed
    from sparknet_tpu_torch.data.source import synthetic_batches
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    job_state = None
    if args.resume:
        # newest CRC-valid snapshot; corrupt ones are quarantined and the
        # scan falls back (io/checkpoint.restore_newest_valid).  With a
        # ledger: the last COMMITTED boundary (snapshots past it belong
        # to rounds that re-execute)
        try:
            if jr is not None and jr.last_committed_round is not None:
                state, used, job_state, jinfo = \
                    checkpoint.restore_newest_valid_journaled(
                        solver, prefix, jr, metrics=metrics)
                if jinfo["in_flight_round"] is not None:
                    metrics.recover_replayed.inc()
                    print("journal: round %d was in flight at the crash — "
                          "it re-executes" % jinfo["in_flight_round"])
            else:
                state, used = checkpoint.restore_newest_valid(
                    solver, prefix, metrics=metrics)
                job_state = checkpoint.load_job_state(used)
        except (FileNotFoundError, checkpoint.SnapshotCorrupt) as e:
            print(f"train: --resume: {e}", file=sys.stderr)
            return 1
        if job_state and sentry is not None and "sentry" in job_state:
            sentry.load_state(job_state["sentry"])
        print(f"resumed from {used} at iter {int(state.iter)}")
    elif args.snapshot:
        state = checkpoint.restore(solver, args.snapshot, metrics=metrics)
        job_state = checkpoint.load_job_state(args.snapshot)
        print(f"resumed from {args.snapshot} at iter {int(state.iter)}")
    else:
        state = solver.init_state(seed=args.seed)
        if args.weights:
            state = checkpoint.load_weights_into_state(solver, state,
                                                       args.weights)
            print(f"warm-started weights from {args.weights}")
    if job_state and "loss_window" in job_state.get("solver", {}):
        solver.restore_loss_window(job_state["solver"]["loss_window"])

    it = int(state.iter)
    # the windows a run drew before its snapshot: a resumed run draws
    # the uninterrupted run's next window, not the seed's first
    rounds_done = it // args.tau
    cursor = (job_state or {}).get("cursor")
    if cursor is not None:
        rounds_done = int(cursor["round"])
        if int(cursor["iter"]) != it or rounds_done * args.tau != it:
            print(
                f"train: the snapshot ends window {rounds_done} at iter "
                f"{int(cursor['iter'])}; --tau {args.tau} would draw windows "
                "the uninterrupted run never drew — resume with its --tau",
                file=sys.stderr,
            )
            return 1
    sampler = None
    if args.data:
        loader = CifarLoader(args.data)
        x, y = loader.minibatches(
            solver.net.blob_shapes[solver.net.feed_blobs[0]][0]
        )
        sampler = MinibatchSampler({"data": x, "label": y},
                                   num_sampled_batches=args.tau, seed=args.seed)
        for _ in range(rounds_done):
            sampler.next_window()

    effects = {"stop": SolverAction.STOP, "snapshot": SolverAction.SNAPSHOT,
               "none": SolverAction.NONE}
    max_iter = args.max_iter or solver_param.max_iter or 1000
    snap_every = solver_param.snapshot
    ckpt = (checkpoint.AsyncCheckpointer(metrics=metrics)
            if args.async_snapshot else None)

    def assemble(r):
        return (sampler.next_window() if sampler
                else synthetic_batches(solver.net, args.tau))

    def job_extra():
        # loop state a TrainState restore would reset
        extra = {"cursor": {"iter": it, "round": it // args.tau},
                 "solver": {"loss_window": solver.export_loss_window()}}
        if sentry is not None:
            extra["sentry"] = sentry.export_state()
        return extra

    # a journaled async boundary commits once its publish is confirmed
    # (the next save/wait joins the writer): (round, iter) awaiting it
    async_pending = None

    def commit_async_published():
        nonlocal async_pending
        if jr is None or async_pending is None or ckpt is None:
            return
        done = ckpt.last_paths
        if done:
            pr, pit = async_pending
            async_pending = None
            jr.commit_round(pr, iter=pit, snapshot=os.path.basename(done[1]))

    def snapshot(abs_r):
        nonlocal async_pending
        if ckpt is not None:
            # publish and commit the previous write BEFORE the next save
            ckpt.wait()
            commit_async_published()
            ckpt.save(solver, state, prefix, extra_state=job_extra())
            async_pending = (abs_r, it)
            log.log(f"async snapshot started at iter {it}")
        else:
            paths = checkpoint.snapshot(solver, state, prefix,
                                        extra_state=job_extra(),
                                        metrics=metrics)
            if jr is not None:
                # the durable boundary: the commit carries the snapshot
                jr.commit_round(abs_r, iter=it,
                                snapshot=os.path.basename(paths[1]))
            log.log(f"snapshotted to {paths[0]}")

    feed = RoundFeed(assemble, solver.device, pipelined=not args.serial_feed,
                     num_rounds=max(0, -(-(max_iter - it) // args.tau)))
    r = 0
    with TrainingLog(tag="train") as log, SignalHandler(
        sigint_effect=effects[args.sigint_effect],
        sighup_effect=effects[args.sighup_effect],
    ) as handler:
        try:
            while it < max_iter:
                abs_r = it // args.tau
                if jr is not None:
                    # write-ahead intent: restart knows this window was
                    # in flight whatever happens next
                    jr.begin_round(abs_r, iter=it, cursor=abs_r)
                if sentry is not None:
                    state, _ = sentry.guarded_step(
                        solver, state, feed.next_round(r), round_index=abs_r)
                else:
                    state, _ = solver.step(state, feed.next_round(r))
                r += 1
                it += args.tau
                # SolverParameter.display: reading smoothed_loss waits for
                # the card, so once per display interval
                disp = solver_param.display or args.tau
                if it % disp < args.tau:
                    log.log(f"iter {it} smoothed_loss {solver.smoothed_loss:.4f}")
                action = handler.get_action()
                if action == SolverAction.SNAPSHOT or (
                    snap_every and it % snap_every < args.tau
                    and it >= snap_every
                ):
                    snapshot(abs_r)
                if action == SolverAction.STOP:
                    log.log("stop requested; snapshotting and exiting")
                    snapshot(abs_r)
                    break
        except SentryHalt as e:
            # no snapshot of the weights the sentry just condemned
            log.log(f"training halted by the health sentry: {e}")
            return 1
        finally:
            feed.stop()
            if ckpt is not None:
                paths = ckpt.wait()
                commit_async_published()
                ckpt.close()
                if paths:
                    log.log(f"final async snapshot: {paths[0]}")
    published = None
    if args.publish_to:
        # train-to-serve delivery: the final state publishes only with a
        # passing sentry verdict on its CRC manifest
        from sparknet_tpu_torch.serve import publish as publish_mod

        verdict = publish_mod.verdict_from_sentry(sentry)
        try:
            published = publish_mod.publish_snapshot(
                solver, state, args.publish_to, verdict)
        except publish_mod.PublishRefused as e:
            print(f"train: {e}", file=sys.stderr)
            return 1
        print(f"published verified snapshot {published[0]} -> "
              f"{args.publish_to} (verdict: {verdict['reason']})")
    if args.result is not None:
        args.result.update(state=state, solver=solver, metrics=metrics,
                           smoothed_loss=solver.smoothed_loss, sentry=sentry,
                           published=published)
    return 0


def cmd_test(args) -> int:
    """``test``: score the TEST net of ``--model`` (a prototxt) with
    ``--weights`` over ``--iterations`` real batches, on the card unless
    ``--device=cpu``; prints each output's mean over the batches."""
    import torch

    from sparknet_tpu_torch import config
    from sparknet_tpu_torch.data.source import resolve_batches
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    netp = config.load_net_prototxt(args.model)
    solver = Solver(
        config.parse_solver_prototxt('base_lr: 0.0 lr_policy: "fixed"'),
        net_param=netp, device=device,
    )
    state = solver.init_state(0)
    if args.weights:
        state = checkpoint.load_weights_into_state(solver, state, args.weights)
    # real data: --data or the net's own Data layer source;
    # --allow_synthetic is an explicit smoke-test escape
    batches = resolve_batches(
        solver.test_net, netp, args.data, args.iterations, phase="TEST",
        allow_synthetic=args.allow_synthetic,
    )
    scores = solver.test_and_store_result(state, {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batches.items()})
    for name, total in scores.items():
        print(f"{name} = {total / args.iterations:.4f}")
    if args.result is not None:
        args.result.update(scores=scores, iterations=args.iterations)
    return 0


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Run one subcommand; returns its exit code.  ``result``, when given,
    receives ``train --solver``'s final state, solver and metrics."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["train"] and "--lm" in argv:
        # the transformer-LM workload: the rest of the line goes to
        # apps/lm_app.py, whose parser carries the LM's surface
        from sparknet_tpu_torch.apps import lm_app

        return lm_app.main([a for a in argv[1:] if a != "--lm"])
    parser = argparse.ArgumentParser(prog="sparknet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train")
    p.add_argument("--lm", action="store_true",
                   help="train the transformer LM: the rest of the line "
                   "goes to apps/lm_app.py (--dim/--depth/--heads/--seq_len, "
                   "--workers, --rounds, --tau, --batch, --corpus DIR, "
                   "--dense_attention, --compress, --device)")
    p.add_argument("--solver", default=None,
                   help="prototxt solver: one solver trains tau iterations "
                   "a window on --data (or seeded random batches)")
    p.add_argument("--snapshot", default=None,
                   help="continue from this .solverstate.npz / .h5")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest CRC-valid snapshot under "
                   "the solver's snapshot_prefix (corrupt ones are "
                   "quarantined and skipped)")
    p.add_argument("--weights", default=None,
                   help="warm start from a .caffemodel / .caffemodel.h5")
    p.add_argument("--data", default=None, help="CIFAR binary directory")
    p.add_argument("--tau", type=int, default=10)
    p.add_argument("--max_iter", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--async_snapshot", action="store_true",
                   help="write snapshots on a background thread")
    p.add_argument("--serial_feed", action="store_true",
                   help="assemble and copy each window on the training "
                   "thread instead of the producer thread")
    p.add_argument("--sigint_effect", choices=["stop", "snapshot", "none"],
                   default="stop")
    p.add_argument("--sighup_effect", choices=["stop", "snapshot", "none"],
                   default="snapshot")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    from sparknet_tpu_torch.parallel import comm as _comm

    _comm.add_cli_args(p)  # --compress / --overlap_avg (refused here)
    from sparknet_tpu_torch import obs as _obs
    from sparknet_tpu_torch.io import journal as _journal

    _obs.add_cli_args(p)  # --health / --flight_recorder (+ refused ones)
    _journal.add_cli_args(p)  # --journal / --no_journal / ...
    p.add_argument("--publish_to", default=None, metavar="DIR",
                   help="publish the final state with the sentry's verdict "
                   "on its CRC manifest (implies --health warn); cli serve "
                   "--watch DIR delivers it")
    p.add_argument("--devices", type=int, default=1, help="not yet ported")
    p.add_argument("--cache_dir", default=None, help="not yet ported")
    p.add_argument("--cache_bytes", default="0", help="not yet ported")
    p.add_argument("--shuffle_epochs", type=int, default=0,
                   help="not yet ported")
    p.set_defaults(fn=cmd_train, result=None)

    p = sub.add_parser("test")
    p.add_argument("--model", required=True, help="net prototxt")
    p.add_argument("--weights", default=None,
                   help=".caffemodel / .caffemodel.h5 (omitted: the seeded "
                   "init)")
    p.add_argument("--data", default=None,
                   help="CIFAR binary dir, Caffe LMDB or LevelDB, or record-DB "
                   "file (omitted: the net's Data layer source)")
    p.add_argument("--allow_synthetic", action="store_true",
                   help="smoke-test only: score random batches")
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    p.set_defaults(fn=cmd_test, result=None)

    p = sub.add_parser("serve")
    p.add_argument("--net", default=None,
                   help="deploy prototxt or zoo model name (required "
                   "unless --generate)")
    p.add_argument("--weights", default=None,
                   help=".caffemodel / .caffemodel.h5 (snapshot output ok; "
                   "--generate: the LM's, an lm_app snapshot's model "
                   "file); omitted = the seeded init")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8361)
    p.add_argument("--buckets", default="1,4,16,64",
                   help="comma-separated batch-size buckets, each run "
                   "once at warm-up")
    p.add_argument("--max_wait_ms", type=float, default=2.0,
                   help="micro-batch coalescing deadline")
    p.add_argument("--queue", type=int, default=256,
                   help="admission queue bound (overflow -> 429)")
    p.add_argument("--output_blob", default=None,
                   help="blob to serve (default: prob, else last top)")
    p.add_argument("--dtype", default=None,
                   help="compute dtype, e.g. bfloat16 (default f32)")
    p.add_argument("--verbose", action="store_true",
                   help="log each HTTP request")
    p.add_argument("--replicas", type=int, default=1,
                   help="N>1: a serving FLEET (serve/fleet.py) — N "
                   "shared-nothing engine replicas behind a router "
                   "that load-balances by in-flight depth and sheds "
                   "(429) at a fleet-wide admission bound (--queue)")
    p.add_argument("--watch", default=None, metavar="PUBLISH_DIR",
                   help="watch this publish location (local dir or "
                   "object-store url) for published snapshots: "
                   "CRC+verdict verify, warm a standby off-path, canary "
                   "live traffic, promote or roll back with no restart "
                   "(serve/delivery.py)")
    p.add_argument("--canary_frac", type=float, default=0.125,
                   help="fraction of live traffic mirrored to a canary "
                   "during a delivery decision window")
    p.add_argument("--decision_requests", type=int, default=32,
                   help="mirrored requests per canary decision window")
    p.add_argument("--divergence_max", type=float, default=0.25,
                   help="max |canary - incumbent| output divergence "
                   "before the canary rolls back")
    p.add_argument("--cache_dir", default=None,
                   help="chunk-cache root for the delivery watcher's "
                   "verified snapshot staging (default: a temp dir)")
    p.add_argument("--generate", action="store_true",
                   help="serve a TransformerLM for token streaming: "
                   "chunked-NDJSON POST /generate, continuous batching "
                   "over a paged KV arena; composes with "
                   "--replicas/--watch")
    p.add_argument("--lm_dim", type=int, default=256,
                   help="--generate: TransformerLM embedding dim")
    p.add_argument("--lm_depth", type=int, default=4,
                   help="--generate: TransformerLM layers")
    p.add_argument("--lm_heads", type=int, default=4,
                   help="--generate: TransformerLM attention heads")
    p.add_argument("--lm_seq_len", type=int, default=256,
                   help="--generate: model context length")
    p.add_argument("--prefill_buckets", default="16,32,64,128",
                   help="--generate: prompt-length buckets (longer "
                   "prompts -> 400)")
    p.add_argument("--max_streams", type=int, default=8,
                   help="--generate: decode slots (the fixed decode "
                   "batch width)")
    p.add_argument("--kv_blocks", type=int, default=64,
                   help="--generate: paged KV arena blocks (worst-case "
                   "reservation at admission; overflow -> 429)")
    p.add_argument("--kv_block_size", type=int, default=16,
                   help="--generate: positions per KV block")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) "
                   "or cpu (the plain kernel versions)")
    p.set_defaults(fn=cmd_serve, result=None)

    args = parser.parse_args(argv)
    if result is not None:
        args.result = result
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
