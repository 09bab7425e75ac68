"""LMApp — the byte-level transformer LM trained on the averaging stack.

The port of ``sparknet_tpu/apps/lm_app.py`` at sp=1: a decoder-only
transformer (``models/transformer_lm.py``) trained by the same
``ParameterAveragingTrainer`` and ``RoundFeed`` as ``cifar_app``, the W
dp workers stacked on one device.  Every attention forward runs the
flash kernel (K1) and every attention backward the dq and dk/dv kernels
(K3, K4); ``--dense_attention`` trains with ``mha_reference`` instead.
Windows are drawn per worker by absolute iteration (``data/text.py``).

Run (on the card; ``--device cpu`` runs the plain versions on the CPU)::

    python -m sparknet_tpu_torch.apps.lm_app --dim 256 --depth 4 \\
        --heads 4 --seq_len 256 [--corpus DIR] [--rounds 40]

A seeded synthetic corpus is written to a temporary directory when
``--corpus`` is omitted.

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

``--sp`` > 1, ``--cache_dir``, ``--cache_bytes``, ``--elastic``,
``--slices``, ``--health``, ``--journal``, ``--obs`` and ``--profile``
are not yet ported and exit saying so.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

TAU = 4

# flags of the JAX app that later slices bring: (flag, takes a value)
_NOT_YET_PORTED = (
    ("--cache_dir", True), ("--cache_bytes", True),
    ("--elastic", False), ("--slices", True), ("--health", False),
    ("--journal", False), ("--obs", False), ("--profile", False),
)
_REFUSAL_DETAIL = {
    "--journal": (" (the run ledger that guides --resume and commits each "
                  "--snapshot_prefix/--snapshot_every boundary; they work "
                  "without it)"),
}


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


def build_lm_solver(args, device):
    """(TransformerLMNet, Solver) from parsed args, on ``device``."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.config import parse_solver_prototxt
    from sparknet_tpu_torch.solver import Solver

    lm = models.build_transformer_lm(
        dim=args.dim, depth=args.depth, heads=args.heads,
        seq_len=args.seq_len,
        attention="dense" if args.dense_attention else "auto",
    )
    solver_param = parse_solver_prototxt(
        f"base_lr: {args.base_lr} "
        'lr_policy: "fixed" '
        f"momentum: {args.momentum} "
        f"weight_decay: {args.weight_decay} "
        "average_loss: 20"
    )
    return lm, Solver(solver_param, net=lm, device=device)


def _parser() -> argparse.ArgumentParser:
    from sparknet_tpu_torch.parallel import comm

    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.lm_app")
    p.add_argument("--corpus", default=None,
                   help="local directory of *.txt documents; omitted = a "
                   "seeded synthetic corpus")
    p.add_argument("--workers", type=int, default=0,
                   help="dp workers stacked on the device (0 = the device "
                   "count)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ring width (only 1 is ported)")
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
                   "the comm residuals, the loss window and the text cursor)")
    p.add_argument("--snapshot_every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid snapshot under "
                   "--snapshot_prefix and continue bit for bit (windows "
                   "never skip or replay)")
    add_lm_model_args(p)
    comm.add_cli_args(p)  # --compress / --overlap_avg
    for flag, takes_value in _NOT_YET_PORTED:
        if takes_value:
            p.add_argument(flag, default=None, help="not yet ported")
        else:
            p.add_argument(flag, action="store_true", help="not yet ported")
    return p


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Train; returns the exit code.  ``result``, when given, receives the
    LM, the final state, the trainer, the metrics, the smoothed loss,
    the first round this run trained (``start_round``), each of its
    rounds' per-worker losses (``losses``: (rounds, W, tau)), smoothed
    loss after the round (``smoothed``) and wall seconds (from the
    round's start to its losses on the host), and the snapshots it wrote
    (``snapshots``, solverstate paths)."""
    args = _parser().parse_args(argv)
    if args.sp > 1:
        raise SystemExit(
            "lm_app: --sp > 1 (the sequence-parallel ring) is not yet "
            "ported to sparknet_tpu_torch"
        )
    for flag, _ in _NOT_YET_PORTED:
        if getattr(args, flag.lstrip("-")) not in (None, False):
            what = _REFUSAL_DETAIL.get(flag, "")
            raise SystemExit(
                f"lm_app: {flag}{what} is not yet ported to sparknet_tpu_torch"
            )
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

    device = resolve_device(args.device)

    from sparknet_tpu_torch.data import (
        RoundFeed,
        TextWindowSampler,
        load_corpus,
        stack_windows,
        write_synthetic_corpus,
    )
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.obs.trace import span
    from sparknet_tpu_torch.parallel import (
        ParameterAveragingTrainer,
        first_worker,
    )
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    n_workers = args.workers or (
        torch.cuda.device_count() if device.type == "cuda" else 1
    )
    prefix = args.snapshot_prefix
    if args.resume and not checkpoint.find_snapshots(prefix):
        # a typo'd prefix must not silently retrain the whole run
        raise SystemExit(f"lm_app: --resume found no snapshots under {prefix!r}")
    # on every run, before the first CUDA op: an uninterrupted and a
    # resumed run take the same (deterministic) algorithms
    with deterministic_algorithms(), \
            tempfile.TemporaryDirectory(prefix="lm_synth_corpus_") as synth, \
            TrainingLog(tag="lm") as log:
        corpus = args.corpus
        if corpus is None:
            corpus = synth
            write_synthetic_corpus(corpus, seed=args.seed)
            log.log(f"synthesized corpus in {corpus}")
        docs = load_corpus(corpus)
        log.log(f"corpus: {len(docs)} documents, "
                f"{sum(len(d) for d in docs)} bytes")
        lm, solver = build_lm_solver(args, device)
        log.log(
            f"model: dim={args.dim} depth={args.depth} heads={args.heads} "
            f"seq_len={args.seq_len} ({lm.num_params()} params), attention "
            f"{lm.attention}; {n_workers} workers on {device}"
        )
        if not lm.on_kernel:
            path = "dense mha_reference (--dense_attention)"
        elif torch.device(device).type == "cuda":
            path = "flash kernels (K1 forward, K3/K4 backward)"
        else:
            path = "plain versions of the flash kernels (CPU tensors)"
        log.log(f"attention path: {path}")
        metrics = TrainingMetrics()
        metrics.kernel_path.labels("attention").set(1.0 if lm.on_kernel else 0.0)
        trainer = ParameterAveragingTrainer(
            solver, n_workers, compress=args.compress,
            overlap_avg=args.overlap_avg, metrics=metrics,
        )

        # one joined corpus stream, one cursor per dp worker
        base = TextWindowSampler(docs, args.seq_len, args.batch,
                                 seed=args.seed, worker=0)
        samplers = [base.for_worker(w) for w in range(n_workers)]
        tokens_per_round = n_workers * args.tau * args.batch * args.seq_len

        state, start_round = None, 0
        if args.resume:
            # the newest snapshot that verifies, with its job state put
            # back; the text cursor must fit this corpus
            state, start_round, used, js = trainer.resume_newest(
                prefix, args.tau, metrics=metrics)
            cursor = js.get("cursor")
            if isinstance(cursor, dict) and "text_iter" in cursor:
                samplers[0].verify_cursor(cursor)
            log.log(f"resumed from {used} at round {start_round} "
                    f"(iter {start_round * args.tau})")
        if state is None:
            state = trainer.init_state(seed=args.seed)

        def assemble(r):
            with span("sample_text", cat="data", round=r):
                windows = [s.window_for_round(r, args.tau) for s in samplers]
            return stack_windows(windows)

        def snapshot(r):
            """Publish the round-``r`` boundary: worker 0's consensus plus
            the job state a resume puts back."""
            extra = trainer.export_job_state(
                state, samplers[0].cursor_for_iter((r + 1) * args.tau))
            _, state_path = checkpoint.snapshot(
                solver, first_worker(state), prefix, fmt="BINARYPROTO",
                extra_state=extra, metrics=metrics,
            )
            snapshots.append(state_path)
            log.log(f"snapshotted round {r} to {state_path}")

        n_rounds = max(0, args.rounds - start_round)
        feed = RoundFeed(assemble, device, pipelined=not args.serial_feed,
                         num_rounds=n_rounds, start_round=start_round)
        round_seconds, round_losses, smoothed, snapshots = [], [], [], []
        try:
            for r in range(start_round, args.rounds):
                t0 = time.perf_counter()
                state, losses = trainer.round(state, feed.next_round(r),
                                              round_index=r)
                round_losses.append(losses.detach().cpu().numpy())
                round_seconds.append(time.perf_counter() - t0)
                metrics.lm_tokens.inc(tokens_per_round)
                smoothed.append(solver.smoothed_loss)
                if r % max(1, args.log_every) == 0 or r == args.rounds - 1:
                    log.log(f"round {r} smoothed_loss {smoothed[-1]:.4f}")
                if prefix and args.snapshot_every and \
                        (r + 1) % args.snapshot_every == 0:
                    snapshot(r)
            state = trainer.finalize(state)  # the last round's average lands
            loss = solver.smoothed_loss
            log.log(f"final smoothed_loss {loss:.4f}")
        finally:
            feed.stop()
        if result is not None:
            W = n_workers
            result.update(
                lm=lm, state=state, trainer=trainer, metrics=metrics,
                smoothed_loss=loss, start_round=start_round,
                losses=(np.stack(round_losses) if round_losses
                        else np.zeros((0, W, args.tau), np.float32)),
                smoothed=smoothed, round_seconds=round_seconds,
                tokens_per_round=tokens_per_round, snapshots=snapshots,
            )
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
