"""The hot-path registry: which scopes the sync checker polices.

"Hot path" means code that runs once per round (or per request) in
steady state, where one implicit host<->device sync stalls the host
until the card drains its queue and erases the overlap the round is
built on — the trainer round/step bodies, the RoundFeed/Prefetcher
producer machinery, the comm plane's dispatch/pace/apply path, the
serving forward loop, and the span fast path.  Setup code (solver
construction, checkpoint restore, dataset staging) deliberately is NOT
here: syncing at build time is free.

Two sources make a scope hot:

1. this explicit registry — ``module-relative path -> qualnames``
   (``Class.method`` or bare function names);
2. any function passed as ``target=`` to ``threading.Thread`` in a
   scanned module (producer/comm/watchdog threads are hot by
   construction — that is where a stray sync silently serializes the
   overlap).

The registry names the counterparts of ``sparknet_tpu/analysis/
hotpaths.py``'s scopes, module for module.  Where the port's name
differs:

- ``RoundFeed._default_place`` (``jax.device_put`` of the round's host
  batch) is ``data/prefetch.py``'s ``place_batch`` (the pinned,
  ``non_blocking`` copy on the producer's side stream) and ``consume``
  (the consumer stream's wait on its event), which the feed and the
  ``Prefetcher`` share.
- ``RoundProfiler.probe_execute`` (polling each dp shard's readiness)
  is ``WorkerWindowTimer.seconds`` (each worker's execute window read
  from CUDA events): the profiler's per-round read of device timing.

A JAX scope with no port counterpart:

- ``CommPlane._local_call`` (the ``execute`` span around the jitted
  local steps): the port calls its local steps inline in
  ``CommPlane.round``, which is registered itself.

Port scopes with no JAX counterpart, registered because they run once a
round (or once a forward) on the host where the JAX package runs traced
code, in which no sync can happen: ``CommPlane._gather_payload`` (the
cross-process payload gather), ``CommPlane._allreduce`` (the reduce of a
chunk on the comm thread), and ``ops/losses.py``'s
``SoftmaxWithLoss.apply`` and ``_normalizer`` (the loss's count and
normalizer constants, which a ``torch.tensor(x, device=...)`` would copy
from pageable host memory each forward, a sync the card showed).

Extending: when a new module grows a per-round loop, add its qualnames
here — ``python -m sparknet_tpu_torch.tools.lint --check`` then polices
it, and any deliberate sync it keeps must carry a ``# sparknet:
sync-ok(<reason>)`` marker.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

HOT_PATHS: Dict[str, FrozenSet[str]] = {
    "solver.py": frozenset({
        "Solver.step",
        "Solver.note_losses",
    }),
    "data/round_feed.py": frozenset({
        "RoundFeed._produce_one",
        "RoundFeed.next_round",
        "stack_windows",
    }),
    "data/prefetch.py": frozenset({
        "Prefetcher._run",
        "Prefetcher._put_politely",
        "Prefetcher.__next__",
        "place_batch",
        "consume",
    }),
    "parallel/trainers.py": frozenset({
        "ParameterAveragingTrainer.round",
        "ParameterAveragingTrainer._place_live",
        "AllReduceTrainer.step",
    }),
    "parallel/comm.py": frozenset({
        "CommPlane.round",
        "CommPlane._dispatch_chunks",
        "CommPlane._pace_chunks",
        "CommPlane._apply_pending_correction",
        "CommPlane._join_pending",
        "CommPlane.flush_quant_error",
        "CommPlane._gather_payload",
        "CommPlane._allreduce",
    }),
    "serve/engine.py": frozenset({
        "InferenceEngine.run_padded",
        "InferenceEngine.infer",
    }),
    "serve/batcher.py": frozenset({
        "MicroBatcher._take_batch",
        "MicroBatcher._loop",
        "MicroBatcher.submit",
    }),
    "serve/fleet.py": frozenset({
        "Router.submit",
        "Router._pick",
        "Router._maybe_mirror",
    }),
    "ops/losses.py": frozenset({
        "SoftmaxWithLoss.apply",
        "_normalizer",
    }),
    "obs/trace.py": frozenset({
        "_Span.__exit__",
        "span",
        "instant",
    }),
    "obs/profile.py": frozenset({
        "WorkerWindowTimer.seconds",
        "RoundProfiler.observe_round",
    }),
    "utils/timers.py": frozenset({
        "Timer.stop",
    }),
}


def hot_scopes_for(relpath: str) -> FrozenSet[str]:
    return HOT_PATHS.get(relpath, frozenset())
