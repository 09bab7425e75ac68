"""Command-line entry point of the port: ``serve --generate``, ``train --lm``.

The port of the ``serve --generate`` subcommand of
``sparknet_tpu/tools/cli.py``, with the same flags and defaults plus
``--device`` (default ``cuda``; ``--device=cpu`` runs the plain
attention versions on the CPU), and of ``train --lm``, which hands the
rest of the line to ``apps/lm_app.py``::

    python -m sparknet_tpu_torch.tools.cli serve --generate [--port 8361]
    python -m sparknet_tpu_torch.tools.cli train --lm [--dim 256 ...]

The other subcommands, ``train`` with a prototxt ``--solver``, ``serve``
without ``--generate`` (``/predict``), ``--weights``, ``--replicas`` and
``--watch`` come with later slices and raise "not yet ported" here.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _not_yet_ported(what: str):
    raise SystemExit(f"serve: {what} is not yet ported to sparknet_tpu_torch")


def cmd_serve(args) -> int:
    """``serve --generate``: a TransformerLM served with prefill/decode
    split greedy decoding over a paged KV arena, continuous batching
    and chunked-NDJSON ``POST /generate``, on the card unless
    ``--device=cpu``."""
    if not args.generate:
        _not_yet_ported("serve without --generate (/predict)")
    if args.weights:
        _not_yet_ported("--weights (.caffemodel / snapshot I/O)")
    if args.replicas > 1:
        _not_yet_ported("--replicas (the serving fleet)")
    if args.watch:
        _not_yet_ported("--watch (train-to-serve delivery)")

    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.serve import GenerationEngine, ServeServer

    lm = TransformerLM(
        dim=args.lm_dim, depth=args.lm_depth, heads=args.lm_heads,
        seq_len=args.lm_seq_len,
    )
    gen_buckets = [
        int(b) for b in args.prefill_buckets.split(",") if b.strip()
    ]
    engine = GenerationEngine(
        lm,
        prefill_buckets=gen_buckets,
        max_streams=args.max_streams,
        kv_blocks=args.kv_blocks,
        kv_block_size=args.kv_block_size,
        device=args.device,
    )
    n = engine.warmup()
    print(
        "serve: warmed %d shapes (prefill buckets %s + decode + score) "
        "on %s, %d decode slots, %d x %d KV blocks — POST /generate "
        "streams NDJSON"
        % (
            n, engine.buckets, engine.device, args.max_streams,
            args.kv_blocks, args.kv_block_size,
        )
    )
    server = ServeServer(
        engine,
        host=args.host,
        port=args.port,
        max_queue=args.queue,
        verbose=args.verbose,
    )
    return server.run()


def cmd_train(args) -> int:
    """``train`` without ``--lm``: the prototxt solver path."""
    raise SystemExit(
        "train: a prototxt --solver is not yet ported to "
        "sparknet_tpu_torch (train --lm trains the transformer LM)"
    )


def main(argv: Optional[List[str]] = None) -> int:
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
                   help="prototxt solver (not yet ported)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("serve")
    p.add_argument("--net", default=None,
                   help="deploy prototxt or zoo model name (the /predict "
                   "engine; not yet ported)")
    p.add_argument("--weights", default=None,
                   help=".caffemodel / .caffemodel.h5 (not yet ported)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8361)
    p.add_argument("--queue", type=int, default=256,
                   help="admission queue bound (overflow -> 429)")
    p.add_argument("--verbose", action="store_true",
                   help="log each HTTP request")
    p.add_argument("--replicas", type=int, default=1,
                   help="N>1: a serving fleet (not yet ported)")
    p.add_argument("--watch", default=None, metavar="PUBLISH_DIR",
                   help="train-to-serve delivery watcher (not yet ported)")
    p.add_argument("--generate", action="store_true",
                   help="serve a TransformerLM for token streaming: "
                   "chunked-NDJSON POST /generate, continuous batching "
                   "over a paged KV arena")
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
                   "or cpu (the plain attention versions)")
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
