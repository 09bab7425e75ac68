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
``--corpus`` is omitted.  ``--sp`` > 1, ``--snapshot_prefix``,
``--snapshot_every``, ``--resume``, ``--cache_dir``, ``--cache_bytes``,
``--elastic``, ``--slices``, ``--health``, ``--journal``, ``--obs`` and
``--profile`` are not yet ported and exit saying so.
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
    ("--snapshot_prefix", True), ("--snapshot_every", True),
    ("--resume", False), ("--cache_dir", True), ("--cache_bytes", True),
    ("--elastic", False), ("--slices", True), ("--health", False),
    ("--journal", False), ("--obs", False), ("--profile", False),
)


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
    each round's per-worker losses (``losses``: (rounds, W, tau)) and each
    round's wall seconds (from the round's start to its losses on the
    host)."""
    args = _parser().parse_args(argv)
    if args.sp > 1:
        raise SystemExit(
            "lm_app: --sp > 1 (the sequence-parallel ring) is not yet "
            "ported to sparknet_tpu_torch"
        )
    for flag, _ in _NOT_YET_PORTED:
        if getattr(args, flag.lstrip("-")) not in (None, False):
            raise SystemExit(
                f"lm_app: {flag} is not yet ported to sparknet_tpu_torch"
            )

    from sparknet_tpu_torch.data import (
        RoundFeed,
        TextWindowSampler,
        load_corpus,
        stack_windows,
        write_synthetic_corpus,
    )
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.obs.trace import span
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.trainlog import TrainingLog

    device = resolve_device(args.device)
    n_workers = args.workers or (
        torch.cuda.device_count() if device.type == "cuda" else 1
    )
    with tempfile.TemporaryDirectory(prefix="lm_synth_corpus_") as synth, \
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
        state = trainer.init_state(seed=args.seed)

        # one joined corpus stream, one cursor per dp worker
        base = TextWindowSampler(docs, args.seq_len, args.batch,
                                 seed=args.seed, worker=0)
        samplers = [base.for_worker(w) for w in range(n_workers)]
        tokens_per_round = n_workers * args.tau * args.batch * args.seq_len

        def assemble(r):
            with span("sample_text", cat="data", round=r):
                windows = [s.window_for_round(r, args.tau) for s in samplers]
            return stack_windows(windows)

        feed = RoundFeed(assemble, device, pipelined=not args.serial_feed,
                         num_rounds=args.rounds)
        round_seconds, round_losses = [], []
        try:
            for r in range(args.rounds):
                t0 = time.perf_counter()
                state, losses = trainer.round(state, feed.next_round(r),
                                              round_index=r)
                round_losses.append(losses.detach().cpu().numpy())
                round_seconds.append(time.perf_counter() - t0)
                metrics.lm_tokens.inc(tokens_per_round)
                if r % max(1, args.log_every) == 0 or r == args.rounds - 1:
                    log.log(f"round {r} smoothed_loss {solver.smoothed_loss:.4f}")
            state = trainer.finalize(state)  # the last round's average lands
            loss = solver.smoothed_loss
            log.log(f"final smoothed_loss {loss:.4f}")
        finally:
            feed.stop()
        if result is not None:
            result.update(lm=lm, state=state, trainer=trainer, metrics=metrics,
                          smoothed_loss=loss, losses=np.stack(round_losses),
                          round_seconds=round_seconds,
                          tokens_per_round=tokens_per_round)
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
