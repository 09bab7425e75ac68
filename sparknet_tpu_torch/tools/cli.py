"""Command-line entry point of the port: ``serve``, ``train``, ``test``,
``time``.

The port of the ``serve``, ``train``, ``test`` and ``time`` subcommands of
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
    python -m sparknet_tpu_torch.tools.cli time --model caffenet \
        [--iterations 10] [--batch 32]

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
so that a resumed run repeats the uninterrupted one bit for bit.  Its
``--data`` is a CIFAR directory or an object-store URL (``gs://``,
``s3://``, ``http(s)://``, ``file://``) whose ``*.bin`` files are staged
through the chunk cache (``--cache_dir``, ``--cache_bytes``);
``--shuffle_epochs`` >= 2 draws the windows as epoch passes whose
minibatch order re-permutes each epoch; the net's ``HDF5Output`` layers
write their files after the last window; ``--profile`` /
``--profile_out`` profile each window as a round (``obs/profile.py``).
``time --model M --iterations N [--batch B]`` prints ``caffe time``'s
per-layer table (``utils/profiler.py``).  ``train --devices N`` is
Caffe's own multi-GPU training (``caffe train --gpu=0,..,N-1``):
synchronous gradient all-reduce on the global batch
(``parallel.AllReduceTrainer``), the TRAIN data layers' batch scaled by
N, one rank a card; outside a joined world it spawns the N ranks
through ``tools/launch.py`` (``--backend gloo`` lets them share fewer
cards, or run on the CPU), and only rank 0 logs, writes snapshots,
commits the journal, publishes and writes the ``--profile`` summary
(each rank profiles its own windows).  ``--obs`` and the other subcommands
(``classify``, ``device_query``, the converters, ...) come with later
slices; the flags raise "not yet ported" here.
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
    flags compose with it.  The telemetry flags (``--obs``, ``--slo``,
    ``--trace_out``, ``--ship_to``, ...) start on the server's registry,
    so the sidecar, the SLO evaluator and the shipper read the engine's
    and the fleet's series.  On the card unless ``--device=cpu``."""
    from sparknet_tpu_torch import config, models, obs
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
    run_obs = obs.start_from_args(args, registry=server.metrics)
    if args.result is not None:
        # in-process callers (tests, chip_smoke) drive the server
        # themselves: start() / shutdown() instead of the signal loop,
        # then close the telemetry (``obs``)
        args.result.update(server=server, delivery=delivery, obs=run_obs)
        return 0
    try:
        return server.run()
    finally:
        run_obs.close()


def _stage_cached_dir(url: str, cache_dir, cache_bytes) -> str:
    """An object-store root as a local directory view whose files are
    chunk-cache entries (verified, refetched when corrupt): every
    ``*.bin`` object is pulled through the cache and its verified path
    symlinked under ``<cache>/views/<key>/``, so the CIFAR loader reads
    ordinary local files and the network is touched once."""
    import tempfile

    from sparknet_tpu_torch.data import chunk_cache, object_store

    store = object_store.open_store(url)
    cache = chunk_cache.ChunkCache(
        cache_dir or tempfile.mkdtemp(prefix="sparknet_cache_"),
        byte_budget=chunk_cache.parse_bytes(cache_bytes),
    )
    view = os.path.join(cache.root, "views",
                        chunk_cache.ChunkCache.key_for(store.url, ""))
    os.makedirs(view, exist_ok=True)
    names = [n for n in store.list("") if n.endswith(".bin")]
    if not names:
        raise SystemExit(f"train: no *.bin objects under {url!r}")
    for name in names:
        path = cache.local_path(store, name)
        link = os.path.join(view, name)
        # object names may carry path separators (recursive listings)
        os.makedirs(os.path.dirname(link) or view, exist_ok=True)
        if os.path.islink(link) or os.path.exists(link):
            os.unlink(link)
        os.symlink(path, link)
    return view


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

    from sparknet_tpu_torch.parallel import mesh as mesh_mod
    from sparknet_tpu_torch.utils.devices import (
        deterministic_algorithms,
        resolve_device,
    )

    if args.devices > 1:
        if mesh_mod.process_count() == 1:
            return _spawn_devices(args)
        if mesh_mod.process_count() != args.devices:
            print(f"train: --devices={args.devices} inside a joined world of "
                  f"{mesh_mod.process_count()} processes: they must be equal",
                  file=sys.stderr)
            return 1
        device = mesh_mod.app_device(args.device, "train")
    else:
        device = resolve_device(args.device)
    # on every run, resumed or not, before the first CUDA op: both take
    # the same algorithms
    with deterministic_algorithms():
        return _train_solver(args, device)


def _allreduce_net(args):
    """The net of ``train --devices N`` (JAX ``tools/cli.py:151-185``):
    the TRAIN data layers' declared batch scaled by N, the TEST view's
    kept (caffe's ``--gpu`` multiplies the training batch only,
    docs/multigpu.md); None, with the JAX message, when the TRAIN view
    declares no shapes or the net writes HDF5Output files."""
    from sparknet_tpu_torch import config

    n = args.devices
    netp0 = config.resolve_solver_net(config.load_solver_prototxt(args.solver))
    train_shapes = _declared_feed_shapes(netp0, "TRAIN")
    test_shapes = _declared_feed_shapes(netp0, "TEST") or train_shapes
    if train_shapes is None:
        print("train: --devices needs data layers with declared shapes "
              "(HostData/Input/MemoryData)", file=sys.stderr)
        return None
    if any(lp.type == "HDF5Output" for lp in netp0.layer):
        raise SystemExit("train: HDF5Output with --devices > 1 (each rank "
                         "holds its rows) is not yet ported to "
                         "sparknet_tpu_torch")
    scaled = [(s[0] * n,) + tuple(s[1:]) for s in train_shapes]
    return config.replace_data_layers(netp0, scaled, test_shapes)


def _declared_feed_shapes(netp, phase):
    """Declared data-layer shapes of one phase view, from the config (no
    net build): the first host-fed layer that states its shapes, or
    None (JAX ``tools/cli.py`` ``_declared_feed_shapes``)."""
    from sparknet_tpu_torch.config.schema import NetState
    from sparknet_tpu_torch.graph import filter_net
    from sparknet_tpu_torch.ops import data_layers as dl
    from sparknet_tpu_torch.ops.base import create_layer

    for lp in filter_net(netp, NetState(phase=phase)).layer:
        try:
            layer = create_layer(lp, phase)
        except Exception:
            continue
        if isinstance(layer, dl._HostFed):
            shapes = layer.declared_shapes()
            if shapes:
                return [tuple(s) for s in shapes]
    return None


def _spawn_devices(args) -> int:
    """``train --devices N`` outside a joined world: N local ranks through
    ``tools/launch.py``'s ``spawn_local``, rank i on ``cuda:i``.  With
    fewer cards than N it exits, as the JAX CLI does when jax sees too
    few devices, unless ``--backend gloo`` is passed: the ranks then
    share ``cuda:0`` over gloo, and say so.  CPU ranks join over gloo."""
    import argparse as _argparse

    import torch

    from sparknet_tpu_torch.tools import launch

    n = args.devices
    argv = list(args.argv)
    on_cards = torch.device(args.device).type == "cuda"
    cards = torch.cuda.device_count() if on_cards else n
    if cards < n and args.backend != "gloo":
        print(f"train: --devices={n} but torch sees {cards} device(s) "
              "(--backend gloo shares them)", file=sys.stderr)
        return 1
    if _allreduce_net(args) is None:
        return 1
    if cards < n:
        argv += ["--device", "cuda:0"]  # the last --device wins
        print(f"train: {n} ranks share cuda:0 over gloo (--backend gloo)")
    print(f"train: spawning {n} ranks (allreduce data parallelism)")
    sys.stdout.flush()
    # no deadline: the ranks train until they end (a rank that fails
    # still ends the wait, its peers killed)
    return launch.spawn_local(_argparse.Namespace(
        app="train", nprocs=n, coordinator=args.coordinator,
        devices_per_host=1, backend=args.backend, timeout=float("inf"),
    ), argv)


def _train_solver(args, device) -> int:
    from sparknet_tpu_torch import config, obs
    from sparknet_tpu_torch.io import journal as journal_mod
    from sparknet_tpu_torch.obs import health as health_mod
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.solver import Solver

    solver_param = config.load_solver_prototxt(args.solver)
    trainer = None
    if args.devices > 1:
        from sparknet_tpu_torch.parallel import AllReduceTrainer, make_mesh

        netp = _allreduce_net(args)
        if netp is None:
            return 1
        solver = Solver(solver_param, net_param=netp, device=device)
        trainer = AllReduceTrainer(
            solver, make_mesh({"dp": args.devices}, workers_per_process=1))
    else:
        solver = Solver(solver_param, device=device)
    root = trainer is None or trainer.is_root
    say = print if root else (lambda *a, **k: None)
    if trainer is not None:
        from sparknet_tpu_torch.parallel import mesh as mesh_mod

        say(f"allreduce data-parallel over {args.devices} devices "
            f"({mesh_mod.joined_backend()}, {device} a rank)")
    metrics = TrainingMetrics()
    # one prefix rule for writing snapshots and for --resume's scan
    prefix = solver_param.snapshot_prefix or "snapshot"
    # the round ledger beside the snapshots (rank 0's); a --resume that
    # finds one consumes it (the auto rule)
    jr = journal_mod.journal_from_args(
        args, journal_mod.default_journal_path(prefix), resuming=args.resume,
        metrics=metrics) if root else None
    if jr is not None:
        say(f"run journal: {jr.path} (fsync={jr.fsync})")
    # the sentry turns the solver's audit on and guards every window;
    # rollback restores through the same prefix (every rank: the verdict
    # reads the global loss and grad norm, so they roll back together)
    sentry = health_mod.sentry_from_args(args, solver, echo=say,
                                         metrics=metrics)
    if sentry is not None:
        sentry.restore_fn = health_mod.make_restore_fn(
            solver, prefix, trainer=trainer, metrics=metrics)
    # the run's telemetry, before the loop so restore spans are covered;
    # under --devices every rank starts its own (its own trace file, its
    # own sidecar port: pass --obs_port 0) and profiles its own steps
    # (Solver.step and AllReduceTrainer.step mark each window a round),
    # rank 0 alone printing and writing the profile summary
    run_obs = obs.start_from_args(args, echo=say, tm=metrics)
    try:
        with obs.installed_metrics(metrics):  # the data plane counts too
            return _train_loop(args, solver, solver_param, metrics, prefix,
                               jr, sentry, trainer, say)
    finally:
        run_obs.close()
        if args.result is not None and run_obs.profiler is not None:
            args.result.update(profile=run_obs.profile_summary)
        if jr is not None:
            jr.close()
        if sentry is not None:
            obs.set_sentry(None)


def _train_loop(args, solver, solver_param, metrics, prefix, jr, sentry,
                trainer=None, say=print) -> int:
    from sparknet_tpu_torch.data import CifarLoader, MinibatchSampler, RoundFeed
    from sparknet_tpu_torch.data.source import synthetic_batches
    from sparknet_tpu_torch.io import checkpoint, hdf5
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.parallel import mesh as mesh_mod
    from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    group = None if trainer is None else trainer.group
    job_state = None
    if args.resume:
        # newest CRC-valid snapshot; corrupt ones are quarantined and the
        # scan falls back (io/checkpoint.restore_newest_valid).  With a
        # ledger: the last COMMITTED boundary (snapshots past it belong
        # to rounds that re-execute).  Across ranks rank 0 chooses (it
        # holds the ledger) and every rank restores its choice
        held = {}

        def newest():
            if jr is not None and jr.last_committed_round is not None:
                st, used, js, jinfo = \
                    checkpoint.restore_newest_valid_journaled(
                        solver, prefix, jr, metrics=metrics)
                if jinfo["in_flight_round"] is not None:
                    metrics.recover_replayed.inc()
                    print("journal: round %d was in flight at the crash — "
                          "it re-executes" % jinfo["in_flight_round"])
            else:
                st, used = checkpoint.restore_newest_valid(
                    solver, prefix, metrics=metrics)
                js = checkpoint.load_job_state(used)
            held["state"] = st
            return used, js

        try:
            used, job_state = (newest() if group is None
                               else mesh_mod.on_rank0(newest, group))
            state = held.get("state")
            if state is None:
                state = checkpoint.restore(solver, used, metrics=metrics)
        except (FileNotFoundError, checkpoint.SnapshotCorrupt) as e:
            print(f"train: --resume: {e}", file=sys.stderr)
            return 1
        if job_state and sentry is not None and "sentry" in job_state:
            sentry.load_state(job_state["sentry"])
        say(f"resumed from {used} at iter {int(state.iter)}")
    elif args.snapshot:
        state = checkpoint.restore(solver, args.snapshot, metrics=metrics)
        job_state = checkpoint.load_job_state(args.snapshot)
        say(f"resumed from {args.snapshot} at iter {int(state.iter)}")
    else:
        state = solver.init_state(seed=args.seed)
        if args.weights:
            state = checkpoint.load_weights_into_state(solver, state,
                                                       args.weights)
            say(f"warm-started weights from {args.weights}")
    if trainer is not None:
        # rank 0's state on every rank (the resume / warm-start entry)
        state = trainer.shard_state(state)
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
        from sparknet_tpu_torch.data import object_store

        data_dir = args.data
        if object_store.is_object_store_url(args.data):
            # the CIFAR binaries staged through the chunk cache: verified
            # local files, refetched only when missing or corrupt
            data_dir = _stage_cached_dir(args.data, args.cache_dir,
                                         args.cache_bytes)
            say(f"staged {args.data} -> {data_dir} (chunk cache)")
        loader = CifarLoader(data_dir)
        x, y = loader.minibatches(
            solver.net.blob_shapes[solver.net.feed_blobs[0]][0]
        )
        sampler = MinibatchSampler({"data": x, "label": y},
                                   num_sampled_batches=args.tau, seed=args.seed)
        if args.shuffle_epochs <= 1:
            for _ in range(rounds_done):
                sampler.next_window()

    # --shuffle_epochs: the windows are epoch passes over the minibatches
    # whose order re-permutes each epoch (shuffle-by-assignment over
    # indices), keyed by the absolute window, so a resumed run continues
    # the uninterrupted run's schedule mid-epoch
    epoch_draw = None
    if sampler is not None and args.shuffle_epochs > 1:
        from sparknet_tpu_torch.data import shuffle

        windows_per_epoch = max(1, sampler.total // args.tau)
        perm_memo = {}

        def epoch_draw(r):
            abs_r = rounds_done + r
            e = abs_r // windows_per_epoch
            if e not in perm_memo:
                perm_memo.clear()  # one epoch's table at a time
                perm_memo[e] = shuffle.permutation(sampler.total, args.seed, e)
            pos = (abs_r % windows_per_epoch) * args.tau
            idx = perm_memo[e][pos:pos + args.tau]
            return {k: v[idx] for k, v in sampler.batches.items()}

    effects = {"stop": SolverAction.STOP, "snapshot": SolverAction.SNAPSHOT,
               "none": SolverAction.NONE}
    max_iter = args.max_iter or solver_param.max_iter or 1000
    snap_every = solver_param.snapshot
    ckpt = (checkpoint.AsyncCheckpointer(metrics=metrics)
            if args.async_snapshot and (trainer is None or trainer.is_root)
            else None)

    def assemble(r):
        # every rank draws the same global window (one seed); under
        # --devices each copies only its own rows to its device
        if epoch_draw is not None:
            window = epoch_draw(r)
        else:
            window = (sampler.next_window() if sampler
                      else synthetic_batches(solver.net, args.tau))
        return window if trainer is None else trainer.local_rows(window)

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
        if not (trainer is None or trainer.is_root):
            # every rank holds the same bits: rank 0 writes them
            log.log(f"snapshot at iter {it} written by rank 0")
            return
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
    # the window's stepper: the solver, or the trainer on this rank's rows
    stepper = solver if trainer is None else trainer.rows_stepper
    rank = mesh_mod.process_index()
    r = 0
    with TrainingLog(tag="train" if rank == 0 else f"train_p{rank}",
                     echo=rank == 0) as log, SignalHandler(
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
                        stepper, state, feed.next_round(r), round_index=abs_r)
                else:
                    state, _ = stepper.step(state, feed.next_round(r))
                r += 1
                it += args.tau
                # SolverParameter.display: reading smoothed_loss waits for
                # the card, so once per display interval
                disp = solver_param.display or args.tau
                if it % disp < args.tau:
                    log.log(f"iter {it} smoothed_loss {solver.smoothed_loss:.4f}")
                action = handler.get_action()
                if group is not None:
                    # a signal to any rank is acted on by all, at the same
                    # window: no rank leaves a collective early
                    stop, snap = mesh_mod.agree_max(
                        [action == SolverAction.STOP,
                         action == SolverAction.SNAPSHOT], group)
                    action = (SolverAction.STOP if stop else
                              SolverAction.SNAPSHOT if snap
                              else SolverAction.NONE)
                    if action != SolverAction.NONE:
                        log.log(f"iter {it}: {action.name.lower()} agreed "
                                f"over {trainer.parts} ranks")
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
    # HDF5Output layers: the bottoms of the last forward, one file a layer
    hdf5_outputs = hdf5.write_net_outputs(solver.net)
    for path in hdf5_outputs:
        print(f"HDF5Output -> {path}")
    published = None
    if args.publish_to and (trainer is None or trainer.is_root):
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
                           published=published, hdf5_outputs=hdf5_outputs,
                           trainer=trainer)
    return 0


def cmd_time(args) -> int:
    """``time --model M --iterations N``: ``caffe time``'s table for the
    TRAIN net of a prototxt or zoo name (seeded weights, random batches
    of the net's feed shapes; ``--batch`` resizes them), on the card
    unless ``--device=cpu`` (``utils/profiler.py``)."""
    import torch

    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.data.source import synthetic_batches
    from sparknet_tpu_torch.net import TorchNet
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.profiler import format_profile, profile_net

    device = resolve_device(args.device)
    netp = (config.load_net_prototxt(args.model) if os.path.exists(args.model)
            else models.load_model(args.model))
    net = TorchNet(netp, phase="TRAIN")
    if args.batch:
        shapes = [(args.batch,) + tuple(net.blob_shapes[b][1:])
                  for b in net.feed_blobs]
        net = TorchNet(config.replace_data_layers(netp, shapes, shapes),
                       phase="TRAIN")
    params, stats = net.init(0, device=device)
    batch = {k: torch.from_numpy(v[0]).to(device)
             for k, v in synthetic_batches(net, 1).items()}
    result = profile_net(net, params, stats, batch, iterations=args.iterations)
    print(format_profile(result))
    if args.result is not None:
        args.result.update(profile=result, net=net)
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
    p.add_argument("--data", default=None,
                   help="CIFAR binary dir, or a gs://|s3://|http(s)://|file:// "
                   "url staged through the chunk cache")
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

    _obs.add_cli_args(p)  # --obs / --trace_out / --slo / --health / ...
    _journal.add_cli_args(p)  # --journal / --no_journal / ...
    p.add_argument("--publish_to", default=None, metavar="DIR",
                   help="publish the final state with the sentry's verdict "
                   "on its CRC manifest (implies --health warn); cli serve "
                   "--watch DIR delivers it")
    p.add_argument("--devices", type=int, default=1,
                   help="N > 1: synchronous gradient all-reduce on the "
                   "global batch over N ranks, one card each (caffe train "
                   "--gpu=0,..,N-1); the TRAIN batch scales by N.  Spawns "
                   "the ranks unless this process is one of a joined world")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="--devices: the ranks' collective backend (default "
                   "NCCL on cards, gloo on the CPU); gloo lets N ranks share "
                   "fewer cards")
    p.add_argument("--coordinator", default=None,
                   help="--devices: host:port or file:// store the spawned "
                   "ranks join through (default: a probed loopback port)")
    p.add_argument("--cache_dir", default=None,
                   help="chunk-cache root for an object-store --data "
                   "(default: a temp dir)")
    p.add_argument("--cache_bytes", default="0",
                   help="chunk-cache LRU byte budget, e.g. 512M / 8G "
                   "(0 = unbounded)")
    p.add_argument("--shuffle_epochs", type=int, default=0,
                   help="with a value >= 2, draw training windows as "
                   "deterministic epoch passes whose minibatch ORDER "
                   "re-permutes each epoch (seeded shuffle-by-assignment); "
                   "resume-aware via the absolute window.  0/1 = the random "
                   "windows.  Unlike the apps, the value does not split the "
                   "run: an epoch here is one data pass (total/tau windows)")
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

    p = sub.add_parser("time")
    p.add_argument("--model", required=True,
                   help="net prototxt or zoo model name")
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--batch", type=int, default=0,
                   help="the feed blobs' batch size (0 = the net's own)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    p.set_defaults(fn=cmd_time, result=None)

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
    _obs.add_cli_args(p)  # --obs / --slo / --ship_to: on the server's registry
    p.set_defaults(fn=cmd_serve, result=None)

    args = parser.parse_args(argv)
    args.argv = argv[1:]  # the subcommand's own arguments
    if result is not None:
        args.result = result
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
