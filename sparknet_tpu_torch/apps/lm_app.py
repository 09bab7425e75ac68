"""LMApp — the byte-level transformer LM trained on the averaging stack.

The port of ``sparknet_tpu/apps/lm_app.py``: a decoder-only transformer
(``models/transformer_lm.py``) trained by the same
``ParameterAveragingTrainer`` and ``RoundFeed`` as ``cifar_app``, the W
dp workers stacked on one device.  Every attention forward runs the
flash kernel (K1) and every attention backward the dq and dk/dv kernels
(K3, K4); ``--dense_attention`` trains with ``mha_reference`` instead.
``--sp N`` cuts each worker's sequence into N shards and runs every
layer's attention through the sequence ring stacked on the worker's
device (``parallel/ring_attention.py``: N^2 partial steps a layer at
absolute offsets, merged online); the trajectory follows the sp=1 run
up to float associativity, as in the JAX app, and
``sparknet_lm_ring_hop_bytes_total`` counts the modeled ring bytes.
Windows are drawn per worker by absolute iteration (``data/text.py``).

Run (on the card; ``--device cpu`` runs the plain versions on the CPU)::

    python -m sparknet_tpu_torch.apps.lm_app --dim 256 --depth 4 \\
        --heads 4 --seq_len 256 [--corpus DIR] [--rounds 40]

``--corpus`` is a directory or an object-store URL (``gs://``,
``s3://``, ``http(s)://``, ``file://``) whose ``*.txt`` documents are
fetched through the chunk cache (``--cache_dir``, ``--cache_bytes``; a
temporary cache by default).  When it is omitted a seeded synthetic
corpus is written to a temporary directory and read back through the
cache over ``file://``, as the JAX app does: the LM's data path is the
verified-fetch path.

Snapshots: with ``--snapshot_prefix P --snapshot_every k`` every k-th
round boundary publishes worker 0's consensus params and momentum
(``P_iter_N.caffemodel`` / ``.solverstate.npz``, the JAX package's
files) and a ``.jobstate.npz`` with every worker's momentum, the comm
plane's residuals, the loss window and the text cursor, under one CRC
manifest (``io/checkpoint.py``).  ``--resume`` restarts from the newest
snapshot that verifies at round ``iter // tau`` and continues bit for
bit.  Every run trains inside ``utils.devices.deterministic_algorithms``,
so an uninterrupted and a resumed run on the card take the same
algorithms; torch's flags come back when ``main`` returns.

Training health and crash consistency, as in the JAX app: ``--health
[warn|halt|rollback]`` (the numerics audit, the in-round worker mask and
the divergence sentry; rollback restores through the snapshot prefix),
``--flight_recorder``, ``--journal`` (the round ledger beside the
snapshots: a journal-guided ``--resume`` rewinds to the last committed
boundary and replays only the round that was in flight), ``--slices``
/ ``--cross_slice_every`` (the two-tier schedule) and ``--elastic
--rejoin_after N`` (membership views drive the live mask; a SIGTERM
marks this process's slice leaving).  The jobstate carries the sentry
and the membership view too.

``--stale_bound`` / ``--stale_discount`` (the bounded-staleness
trainer) and ``--profile`` / ``--profile_out`` (the window draws timed
per worker) are the JAX app's.  ``--obs`` is not yet ported and exits
saying so.

Across processes (``tools/launch.py ... lm``, or any caller that joined
through ``parallel.mesh.initialize_distributed`` first) the mesh is
``{"dp": W, "sp": sp}`` in the JAX app's device order: rank ``d * sp +
s`` holds dp worker ``d``'s sequence shard ``s`` (one slot a rank; at
sp=1 each rank stacks ``--devices_per_host`` workers, as ``cifar_app``
does).  Each rank draws its workers' windows and keeps its shard's
positions (JAX ``lm_batch_spec``, ``P("dp", None, None, "sp")``); the
sequence ring runs over the sp group (K1/K3/K4 at absolute offsets), the
Solver sums the partial grads over it (``grad_groups``), and the average
reduces over the dp group.  Only rank 0 echoes its log and writes
snapshots; ``--resume`` restores on every rank the snapshot rank 0
chose.  At sp=1 the averaging machinery runs across processes as in one:
``--stale_bound``, ``--elastic`` (the membership events agreed over the
dp group each boundary), ``--slices`` / ``--cross_slice_every`` (a
group a slice that spans ranks), ``--journal`` (rank 0 writes the one
ledger, and a journal-guided ``--resume`` is decided there) and
``--profile`` / ``--profile_out`` (every rank's workers in one table,
written by rank 0).  ``--overlap_avg`` exits saying it stays
single-process (as in JAX), and so does ``--compress`` with snapshots;
at ``--sp`` > 1 across processes the averaging flags above exit too.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

TAU = 4


def add_lm_model_args(parser) -> None:
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--base_lr", type=float, default=0.1)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument(
        "--dense_attention", action="store_true",
        help="train with the dense mha_reference attention instead of the "
        "flash kernels (the default)",
    )


def build_lm_solver(args, device, sp: int = 1, sp_group=None):
    """(TransformerLMNet, Solver) from parsed args, on ``device``, at
    ring width ``sp`` (over the process group ``sp_group`` when given:
    the Solver then sums its grads over that group)."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.config import parse_solver_prototxt
    from sparknet_tpu_torch.solver import Solver

    lm = models.build_transformer_lm(
        dim=args.dim, depth=args.depth, heads=args.heads,
        seq_len=args.seq_len, sp_size=sp, sp_group=sp_group,
        attention="dense" if args.dense_attention else "auto",
    )
    solver_param = parse_solver_prototxt(
        f"base_lr: {args.base_lr} "
        'lr_policy: "fixed" '
        f"momentum: {args.momentum} "
        f"weight_decay: {args.weight_decay} "
        "average_loss: 20"
    )
    return lm, Solver(solver_param, net=lm, device=device,
                      grad_groups=() if sp_group is None else (sp_group,))


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.io import journal
    from sparknet_tpu_torch.parallel import comm, hierarchy

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.lm_app")
    p.add_argument("--corpus", default=None,
                   help="text corpus root: a directory or an object-store "
                   "URL (gs:// s3:// http(s):// file://) of *.txt documents, "
                   "fetched through the chunk cache; omitted = a seeded "
                   "synthetic corpus read through a file:// cache")
    p.add_argument("--cache_dir", default=None,
                   help="chunk-cache root for the corpus; a STABLE path makes "
                   "re-runs I/O-free (default: a temporary directory)")
    p.add_argument("--cache_bytes", default="0",
                   help="chunk-cache LRU byte budget, e.g. 512M / 8G "
                   "(0 = unbounded)")
    p.add_argument("--workers", type=int, default=0,
                   help="dp workers stacked on the device (0 = the device "
                   "count)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ring width: each dp worker's "
                   "sequence cuts into --sp shards and attention runs the "
                   "ring construction stacked on the worker's device "
                   "(parallel/ring_attention.py); seq_len %% sp == 0")
    p.add_argument("--rounds", type=int, default=40)
    p.add_argument("--tau", type=int, default=TAU)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--serial_feed", action="store_true",
                   help="assemble and copy each round's batch on the "
                   "training thread instead of the producer thread")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or "
                   "cpu (the kernels' plain versions)")
    p.add_argument("--snapshot_prefix", default=None,
                   help="snapshot path prefix; with --snapshot_every, every "
                   "k-th round boundary publishes a full-job-state snapshot "
                   "(worker 0's params and momentum, every worker's momentum, "
                   "the comm residuals, the sentry, the membership view, the "
                   "loss window and the text cursor) that the journal's "
                   "commit references")
    p.add_argument("--snapshot_every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from --snapshot_prefix (journal-guided when a "
                   "ledger is there): rewind to the last committed round, "
                   "restore the full job state and continue bit for bit "
                   "(windows never skip or replay)")
    add_lm_model_args(p)
    obs.add_cli_args(p)  # --obs / --trace_out / --slo / --health / ...
    comm.add_cli_args(p)  # --compress / --overlap_avg
    hierarchy.add_cli_args(p)  # --slices / --cross_slice_every / --elastic
    journal.add_cli_args(p)  # --journal / --no_journal / ...
    return p


def resume_lm_job(solver, trainer, prefix, jr, sampler=None, tau: int = TAU,
                  metrics=None, group=None):
    """The journal-guided full-job-state resume (``runtime/recover.py``'s
    recipe): rewind to the last COMMITTED boundary, broadcast its
    consensus, put back every worker's momentum, the comm residuals and
    the loss window, and check the text cursor against the corpus.
    Without a journal the newest valid snapshot is the target; with a
    process ``group`` its rank 0 chooses it and every rank restores it.
    Returns
    ``(state, start_round, job_state, info, used)``; state None means
    nothing to restore (a ledger with no commit starts at round 0)."""
    from sparknet_tpu_torch.io import checkpoint

    info, js = None, None
    if group is not None:
        # across processes: rank 0's choice (it holds the ledger),
        # restored on every rank
        from sparknet_tpu_torch.parallel import mesh as _mesh

        held = {}

        def choose():
            if jr is not None:
                if jr.last_committed_round is None:
                    return None, jr.reconcile()
                held["state"], used, held["js"], info = \
                    checkpoint.restore_newest_valid_journaled(
                        solver, prefix, jr, metrics=metrics)
                return used, info
            held["state"], used = checkpoint.restore_newest_valid(
                solver, prefix, metrics=metrics)
            return used, None

        try:
            used, info = _mesh.on_rank0(choose, group)
        except FileNotFoundError:
            return None, 0, None, None, None
        if used is None:
            return None, 0, None, info, None
        st, js = held.get("state"), held.get("js")
        if st is None:
            st = checkpoint.restore(solver, used, metrics=metrics)
    elif jr is not None:
        if jr.last_committed_round is None:
            # never consume a snapshot the ledger does not vouch for
            return None, 0, None, jr.reconcile(), None
        st, used, js, info = checkpoint.restore_newest_valid_journaled(
            solver, prefix, jr, metrics=metrics)
    else:
        try:
            st, used = checkpoint.restore_newest_valid(solver, prefix,
                                                       metrics=metrics)
        except FileNotFoundError:
            return None, 0, None, None, None
    state, start_round, js = trainer.resume_from(st, used, js, tau)
    if info is not None:
        start_round = info["resume_round"]
    cursor = js.get("cursor")
    if sampler is not None and isinstance(cursor, dict) and "text_iter" in cursor:
        sampler.verify_cursor(cursor)
    return state, start_round, js, info, used


# the averaging flags an sp ring across processes still refuses: each
# rank holds one shard of one worker, so a worker's state spans an sp
# group, which the membership, tiers and profiler do not yet span
_SP_PROCESS_REFUSED = (
    ("stale_bound", lambda v: bool(v), "--stale_bound"),
    ("elastic", lambda v: bool(v), "--elastic"),
    ("slices", lambda v: (v or 1) > 1, "--slices"),
    ("journal", lambda v: v is True, "--journal"),
    ("profile", lambda v: bool(v), "--profile"),
    ("profile_out", lambda v: bool(v), "--profile_out"),
)


def _process_mesh(args, sp: int):
    """The mesh of a joined world: ``{"dp": W}`` stacking
    ``local_device_count()`` workers a rank at sp=1 (``mesh.app_mesh``),
    else ``{"dp": W, "sp": sp}`` one slot a rank, rank ``d * sp + s``
    holding worker ``d``'s shard ``s``.  The flags that stay
    single-process exit naming themselves."""
    from sparknet_tpu_torch.parallel import mesh as mesh_mod

    if sp == 1:
        return mesh_mod.app_mesh(args, "lm_app")[1]
    mesh_mod.refuse_single_process_flags(args, "lm_app")
    for attr, on, flag in _SP_PROCESS_REFUSED:
        if on(getattr(args, attr, None)):
            raise SystemExit(
                f"lm_app: {flag} with --sp {sp} across processes (one "
                "sequence shard a rank) is not yet ported to "
                "sparknet_tpu_torch")
    p = mesh_mod.process_count()
    per = mesh_mod.local_device_count()
    if per != 1:
        raise SystemExit(
            f"lm_app: --sp {sp} across processes holds one sequence shard a "
            f"rank; stacking {per} slots a rank (--devices_per_host) is not "
            "yet ported to sparknet_tpu_torch")
    w = args.workers or p // sp
    if w * sp != p:
        raise SystemExit(
            f"lm_app: --sp {sp} across {p} processes (one shard a rank) "
            f"needs --workers x --sp = {p}, got {w} x {sp}")
    return mesh_mod.make_mesh({"dp": w, "sp": sp}, workers_per_process=1)


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Train; returns the exit code (1 when the sentry halts).
    ``result``, when given, receives the LM, the final state, the
    trainer, the metrics, the sentry and the membership controller, the
    smoothed loss, the first round this run trained (``start_round``),
    each of its rounds' per-worker losses (``losses``: (rounds, W, tau)),
    smoothed loss after the round (``smoothed``) and wall seconds (from
    the round's start to its losses on the host), the snapshots it wrote
    (``snapshots``, solverstate paths) and the journal's reconcile
    decision on a resume (``resume_info``)."""
    args = _parser().parse_args(argv)
    from sparknet_tpu_torch.parallel import mesh as mesh_mod

    sp = max(1, args.sp)
    if args.seq_len % sp:
        raise SystemExit(
            f"lm: --seq_len {args.seq_len} must divide by --sp {sp} "
            "(the ring rotates equal sequence shards)"
        )
    distributed = mesh_mod.process_count() > 1
    mesh = None
    if distributed:
        mesh = _process_mesh(args, sp)
        if args.compress != "none" and args.snapshot_prefix and \
                args.snapshot_every:
            raise SystemExit(
                "lm_app: --compress with snapshots across processes is not "
                "yet ported to sparknet_tpu_torch (the residuals would need "
                "gathering)")
    from sparknet_tpu_torch import obs

    if args.resume and not args.snapshot_prefix:
        raise SystemExit("lm_app: --resume needs --snapshot_prefix")
    if args.overlap_avg and args.snapshot_prefix and args.snapshot_every:
        raise SystemExit(
            "lm_app: --overlap_avg with --snapshot_every: a snapshot needs a "
            "round boundary with no average in flight"
        )

    from sparknet_tpu_torch.utils.devices import (
        deterministic_algorithms,
        resolve_device,
    )

    device = (mesh_mod.app_device(args.device, "lm_app") if distributed
              else resolve_device(args.device))
    rank = mesh_mod.process_index()

    from sparknet_tpu_torch.apps.guards import RoundGuards
    from sparknet_tpu_torch.data import (
        RoundFeed,
        TextWindowSampler,
        load_corpus,
        stack_windows,
        write_synthetic_corpus,
    )
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.io.journal import default_journal_path
    from sparknet_tpu_torch.obs import profile
    from sparknet_tpu_torch.obs.health import SentryHalt
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.obs.trace import span
    from sparknet_tpu_torch.parallel import first_worker
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    if mesh is not None:
        n_workers = mesh.shape["dp"]
        mine = mesh.coords["dp"]
    else:
        n_workers = args.workers or (
            torch.cuda.device_count() if device.type == "cuda" else 1
        )
        mine = slice(0, n_workers)
    prefix = args.snapshot_prefix
    # across processes rank 0 alone opens it (RoundGuards)
    journal_path = args.journal_path or (
        default_journal_path(prefix) if prefix else "lm_run.journal")
    def nothing_to_resume():
        return not checkpoint.find_snapshots(prefix) and not (
            journal_path and args.journal is not False
            and os.path.exists(journal_path))

    # across processes rank 0 looks (it wrote the snapshots; another rank
    # may start this run before its last write lands)
    if args.resume and (mesh_mod.on_rank0(nothing_to_resume) if distributed
                        else nothing_to_resume()):
        # a typo'd prefix must not silently retrain the whole run
        raise SystemExit(f"lm_app: --resume found no ledger and no snapshots "
                         f"under {prefix!r}")
    # on every run, before the first CUDA op: an uninterrupted and a
    # resumed run take the same (deterministic) algorithms
    metrics = TrainingMetrics()
    with deterministic_algorithms(), obs.installed_metrics(metrics), \
            tempfile.TemporaryDirectory(prefix="lm_synth_corpus_") as synth, \
            TrainingLog(tag="lm" if rank == 0 else f"lm_p{rank}",
                        echo=rank == 0) as log:
        corpus = args.corpus
        if corpus is None:
            write_synthetic_corpus(synth, seed=args.seed)
            # even the synthetic corpus goes through the object store and
            # the chunk cache: the LM's data path is the verified fetch
            corpus = "file://" + os.path.abspath(synth)
            log.log(f"synthesized corpus at {corpus}")
        docs = load_corpus(
            corpus, cache_dir=args.cache_dir or os.path.join(synth, ".cache"),
            cache_bytes=args.cache_bytes)
        log.log(f"corpus: {len(docs)} documents, "
                f"{sum(len(d) for d in docs)} bytes")
        sp_group = mesh.group("sp") if mesh is not None and sp > 1 else None
        lm, solver = build_lm_solver(args, device, sp, sp_group)
        if mesh is not None:
            log.log(f"mesh: dp={n_workers} sp={sp} over "
                    f"{mesh.process_count} processes (rank {rank}: dp "
                    f"worker(s) {mine.start}..{mine.stop - 1}, sequence "
                    f"shard {mesh.coords.get('sp', slice(0, 1)).start} of "
                    f"{sp}) over {mesh_mod.joined_backend()}")
        else:
            log.log(f"mesh: dp={n_workers} sp={sp} ({n_workers} worker(s) "
                    f"stacked on {device}, each ring of {sp} shard(s) on "
                    "its worker's device)")
        log.log(
            f"model: dim={args.dim} depth={args.depth} heads={args.heads} "
            f"seq_len={args.seq_len} ({lm.num_params()} params), attention "
            f"{lm.attention}; {n_workers} workers on {device}"
        )
        if sp > 1:
            path = (f"the {sp}-shard sequence ring"
                    + (" over the sp process group: " if sp_group is not None
                       else ": ")
                    + ("flash kernels (K1 forward, K3/K4 backward) each step"
                       if lm.on_kernel and torch.device(device).type == "cuda"
                       else "plain versions of the flash kernels each step"
                       if lm.on_kernel else "the dense recurrence"))
        elif not lm.on_kernel:
            path = "dense mha_reference (--dense_attention)"
        elif torch.device(device).type == "cuda":
            path = "flash kernels (K1 forward, K3/K4 backward)"
        else:
            path = "plain versions of the flash kernels (CPU tensors)"
        log.log(f"attention path: {path}")
        metrics.kernel_path.labels("attention").set(1.0 if lm.on_kernel else 0.0)
        guards = RoundGuards.from_args(
            args, solver, n_workers, log=log, metrics=metrics,
            journal_path=journal_path, resuming=args.resume,
            restore_prefix=prefix, mesh=mesh)
        trainer, jr = guards.trainer, guards.journal

        # one joined corpus stream, one cursor per dp worker (across
        # processes: this rank's workers)
        base = TextWindowSampler(docs, args.seq_len, args.batch,
                                 seed=args.seed, worker=0)
        samplers = [base.for_worker(w) for w in range(mine.start, mine.stop)]
        # this rank's sequence shard of every window (P("dp", None, None,
        # "sp")); the whole sequence when the ring stays in the process
        seq = slice(None)
        if sp_group is not None:
            t_local = args.seq_len // sp
            s_idx = mesh.coords["sp"].start
            seq = slice(s_idx * t_local, (s_idx + 1) * t_local)
        tokens_per_round = n_workers * args.tau * args.batch * args.seq_len
        ring_bytes_per_round = (
            lm.ring_hop_bytes_per_iter(args.batch) * args.tau * n_workers)

        state, start_round, info = None, 0, None
        if args.resume:
            state, start_round, js, info, used = resume_lm_job(
                solver, trainer, prefix, jr, sampler=base,
                tau=args.tau, metrics=metrics,
                group=dist.group.WORLD if distributed else None)
            if state is not None:
                guards.restore_job(js)
                log.log(f"resumed from {used} at round {start_round} "
                        f"(iter {start_round * args.tau})")
                if info is not None and info.get("in_flight_round") is not None:
                    metrics.recover_replayed.inc()
                    log.log("journal: round %d was in flight at the crash — "
                            "it re-executes" % info["in_flight_round"])
            else:
                log.log("journal: no committed round — starting fresh at "
                        "round 0")
        if state is None:
            trainer.reset_comm_state()
            state = trainer.init_state(seed=args.seed)

        def assemble(r):
            with span("sample_text", cat="data", round=r):
                # (--profile: each worker's draw timed)
                windows = profile.timed_worker_windows(
                    r, [lambda s=s: s.window_for_round(r, args.tau)
                        for s in samplers])
            stacked = stack_windows(windows)
            return {k: np.ascontiguousarray(v[..., seq])
                    for k, v in stacked.items()}

        def snapshot(r):
            """Publish the round-``r`` boundary: worker 0's consensus plus
            the job state a resume puts back (every rank gathers it, rank
            0 writes it)."""
            extra = trainer.export_job_state(
                state, base.cursor_for_iter((r + 1) * args.tau))
            extra.update(guards.job_extra())
            if rank != 0:
                log.log(f"round {r}: snapshot written by rank 0")
                return None
            _, state_path = checkpoint.snapshot(
                solver, first_worker(state), prefix, fmt="BINARYPROTO",
                extra_state=extra, metrics=metrics,
            )
            snapshots.append(state_path)
            log.log(f"snapshotted round {r} to {state_path}")
            return state_path

        n_rounds = max(0, args.rounds - start_round)
        # the run's telemetry (--obs, --trace_out, --slo, --ship_to, ...)
        run_obs = obs.start_from_args(args, echo=log.log, tm=metrics)
        feed = RoundFeed(assemble, device, pipelined=not args.serial_feed,
                         num_rounds=n_rounds, start_round=start_round)
        round_seconds, round_losses, smoothed, snapshots = [], [], [], []
        code, loss = 0, float("nan")
        try:
            with guards.signals():
                for r in range(start_round, args.rounds):
                    t0 = time.perf_counter()
                    guards.begin(r, iter=r * args.tau,
                                 cursor=base.cursor_for_iter(r * args.tau))
                    state, mask = guards.boundary(state, r)
                    if mask is not None and not mask.any():
                        log.log(f"round {r}: no live workers in the membership "
                                "view; stopping")
                        break
                    state, losses = guards.round(state, feed.next_round(r),
                                                 mask, r)
                    round_losses.append(losses.detach().cpu().numpy())
                    round_seconds.append(time.perf_counter() - t0)
                    # a departed worker trains no tokens this round
                    frac = 1.0 if mask is None else float(mask.sum()) / n_workers
                    metrics.lm_tokens.inc(int(tokens_per_round * frac))
                    if ring_bytes_per_round:
                        metrics.lm_ring_bytes.inc(
                            int(ring_bytes_per_round * frac))
                    smoothed.append(solver.smoothed_loss)
                    if r % max(1, args.log_every) == 0 or r == args.rounds - 1:
                        log.log(f"round {r} smoothed_loss {smoothed[-1]:.4f}")
                    if prefix and args.snapshot_every and \
                            (r + 1) % args.snapshot_every == 0:
                        state_path = snapshot(r)
                        if state_path is not None:
                            guards.commit(r, iter=(r + 1) * args.tau,
                                          snapshot=os.path.basename(
                                              state_path))
                    elif not prefix:
                        # progress-only ledger: with a prefix, a round
                        # without a snapshot stays uncommitted, so a
                        # resume re-executes it instead of skipping it
                        guards.commit(r, iter=(r + 1) * args.tau,
                                      durable=False)
            state = trainer.finalize(state)  # the last round's average lands
            loss = solver.smoothed_loss
            log.log(f"final smoothed_loss {loss:.4f}")
        except SentryHalt as e:
            log.log(f"training halted by the health sentry: {e}")
            code = 1
        finally:
            feed.stop()
            guards.close()
            run_obs.close()
        if result is not None:
            W = n_workers
            result.update(
                lm=lm, state=state, trainer=trainer, metrics=metrics,
                sentry=guards.sentry, membership=guards.membership,
                profile=run_obs.profile_summary, smoothed_loss=loss,
                start_round=start_round,
                losses=(np.stack(round_losses) if round_losses
                        else np.zeros((0, W, args.tau), np.float32)),
                smoothed=smoothed, round_seconds=round_seconds,
                tokens_per_round=tokens_per_round, snapshots=snapshots,
                resume_info=info,
            )
        return code


if __name__ == "__main__":
    raise SystemExit(main())
