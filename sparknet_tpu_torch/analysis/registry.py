"""The canonical trace/metrics name registry of the port.

One authoritative inventory of every ``sparknet_*`` metric the port
emits (``obs/__init__.py`` TrainingMetrics and the serving, fleet,
tsdb and SLO registries) and every ``span(...)`` name by category — the
sets the folding side consumes: the round profiler (``obs/profile.py``),
the PERF.md telemetry reference, and the ``/metrics`` scrapers people
build dashboards on.  It is the JAX package's
``sparknet_tpu/analysis/registry.py`` with two differences, each a
fact of the port:

- ``sparknet_jit_cache_size`` is absent: the port compiles no XLA
  programs, so it has no jit cache to report (``DOCUMENTED_ABSENT``
  keeps the name legal in the docs the two packages share);
- the phase set has ``allgather``: the cross-process gather of the comm
  plane's payload (``CommPlane._gather_payload``), which the JAX
  package runs inside its jitted collective and so never spans.

``analysis/registry_audit.py`` cross-checks this module against the
code, both directions: an emitter whose name is missing here fails the
lint, and an entry here that nothing emits fails too (documentation of
a ghost).  This module stays stdlib-only.
"""

from __future__ import annotations

# metric name -> label names (() = unlabeled).  Only sparknet_* series
# are canonical here; the serving stack's serve_* series live with the
# serving code (a separate registry instance per server).
CANONICAL_METRICS = {
    "sparknet_uptime_seconds": (),
    "sparknet_rounds_total": (),
    "sparknet_iters_total": (),
    "sparknet_phase_latency_seconds": ("phase",),
    "sparknet_feed_queue_depth": (),
    "sparknet_feed_stalls_total": (),
    "sparknet_io_retries_total": (),
    "sparknet_snapshots_total": (),
    "sparknet_restores_total": (),
    "sparknet_snapshots_quarantined_total": (),
    "sparknet_faults_total": ("kind",),
    "sparknet_cache_hits_total": (),
    "sparknet_cache_misses_total": (),
    "sparknet_cache_evictions_total": (),
    "sparknet_cache_bytes_total": ("src",),
    "sparknet_collective_bytes_total": ("compress",),
    "sparknet_quant_error_max_abs": ("compress",),
    "sparknet_quant_snr_db": ("compress",),
    # kernel routing (ops/cuda_*.py): which hot paths ride the
    # hand-written kernels, and how many fused epilogue kernel launches
    # the comm plane issued
    "sparknet_kernel_path": ("kernel",),
    "sparknet_kernel_fused_chunks_total": ("stage",),
    "sparknet_hidden_fraction": ("kind",),
    "sparknet_worker_skew": (),
    "sparknet_straggler_worker": (),
    "sparknet_straggler_rounds_total": (),
    "sparknet_achieved_flops": (),
    "sparknet_mfu": (),
    "sparknet_device_bytes": (),
    "sparknet_host_rss_bytes": (),
    "sparknet_grad_norm": (),
    "sparknet_nonfinite_total": (),
    "sparknet_update_ratio": ("group",),
    "sparknet_health_anomalies_total": ("kind",),
    "sparknet_health_rollbacks_total": (),
    # elastic membership (runtime/membership.py, --elastic) — the
    # epoch-numbered worker-roster views driving the round's live_mask
    "sparknet_membership_epoch": (),
    "sparknet_membership_workers": ("state",),
    "sparknet_membership_transitions_total": ("kind",),
    # two-tier hierarchical averaging (parallel/hierarchy.py,
    # --slices/--cross_slice_every) — tier-split round/byte accounting
    "sparknet_hierarchy_rounds_total": ("tier",),
    "sparknet_hierarchy_bytes_total": ("tier",),
    # fleet shipper (obs/ship.py, --ship_to) — per-host push side
    "sparknet_ship_events_total": (),
    "sparknet_ship_dropped_total": (),
    "sparknet_ship_pushes_total": (),
    "sparknet_ship_push_failures_total": (),
    # serving fleet (serve/fleet.py, cli serve --replicas) — per-replica
    # rotation state + fleet lifecycle counters on the pool's registry
    # (an obs-enabled serve run registers them on the shared training
    # registry so the shipper ships them unchanged)
    "sparknet_serve_replica_state": ("replica",),
    "sparknet_serve_replica_inflight": ("replica",),
    "sparknet_serve_replica_requests_total": ("replica",),
    "sparknet_serve_replica_errors_total": ("replica",),
    "sparknet_serve_replica_ejections_total": (),
    "sparknet_serve_replica_respawns_total": (),
    "sparknet_serve_replica_engine_swaps_total": (),
    # train-to-serve delivery (serve/delivery.py, cli serve --watch)
    "sparknet_delivery_phase": (),
    "sparknet_delivery_publishes_seen_total": (),
    "sparknet_delivery_rejected_total": (),
    "sparknet_delivery_canary_mirrors_total": (),
    "sparknet_delivery_promotions_total": (),
    "sparknet_delivery_rollbacks_total": (),
    "sparknet_delivery_divergence": (),
    # run journal + crash recovery (io/journal.py, --journal;
    # runtime/recover.py journaled resume)
    "sparknet_journal_records_total": ("kind",),
    "sparknet_journal_truncated_total": (),
    "sparknet_recover_replayed_rounds_total": (),
    # transformer-LM workload (apps/lm_app.py, --sp sequence
    # parallelism over parallel/ring_attention.py)
    "sparknet_lm_tokens_total": (),
    "sparknet_lm_ring_hop_bytes_total": (),
    # autoregressive generation serving (serve/generate.py KV arena +
    # serve/batcher.py StreamBatcher + serve/fleet.py stream routing)
    "sparknet_kv_blocks_total": (),
    "sparknet_kv_blocks_used": (),
    "sparknet_kv_alloc_total": (),
    "sparknet_kv_free_total": (),
    "sparknet_gen_streams_total": (),
    "sparknet_gen_streams_shed_total": ("cause",),
    "sparknet_gen_stream_errors_total": (),
    "sparknet_gen_tokens_total": (),
    "sparknet_gen_active_streams": (),
    "sparknet_gen_ttft_seconds": (),
    "sparknet_gen_intertoken_seconds": (),
    "sparknet_gen_decode_batch_occupancy": (),
    "sparknet_gen_jit_cache_size": (),
    "sparknet_gen_resumes_total": (),
    # request anatomy (obs/reqtrace.py RequestProfiler) — per-stage
    # latency folds + the window's bound-stage / slow-replica verdicts
    "sparknet_req_stage_seconds": ("stage",),
    "sparknet_req_bound_stage": (),
    "sparknet_req_replica_skew": (),
    "sparknet_req_slow_replica": (),
    "sparknet_req_completed_total": (),
    # bounded-staleness averaging (parallel/stale.py, --stale_bound) —
    # per-worker lag/arrival accounting at each averaging boundary
    "sparknet_staleness": ("worker",),
    "sparknet_stale_arrivals_total": ("worker",),
    "sparknet_stale_skipped_total": ("worker",),
    "sparknet_stale_forced_waits_total": (),
    "sparknet_stale_boundaries_skipped_total": (),
    # fleet collector (obs/fleet.py, --fleet_collector) — the merged
    # cross-host families on the collector's own /metrics
    "sparknet_fleet_hosts": ("state",),
    "sparknet_fleet_round": ("host",),
    "sparknet_fleet_round_skew": (),
    "sparknet_fleet_clock_offset_seconds": ("host",),
    "sparknet_fleet_events_total": ("host",),
    "sparknet_fleet_dropped_events_total": ("host",),
    "sparknet_fleet_lost_events_total": ("host",),
    "sparknet_fleet_pushes_total": ("host",),
    "sparknet_fleet_resets_total": ("host",),
    # time-series plane (obs/tsdb.py) — the embedded rollup store's
    # self-accounting, exported wherever a TSDB is armed (--slo or the
    # fleet collector)
    "sparknet_tsdb_resident_bytes": (),
    "sparknet_tsdb_series": (),
    "sparknet_tsdb_samples_total": (),
    "sparknet_tsdb_dropped_series_total": (),
    # burn-rate SLO plane (obs/slo.py) — objective health + alert
    # counters from the multi-window multi-burn-rate evaluator
    "sparknet_slo_burn_rate": ("slo", "window"),
    "sparknet_slo_error_budget_remaining": ("slo",),
    "sparknet_slo_status": ("slo",),
    "sparknet_slo_alerts_total": ("slo", "severity"),
    # scaling signals (obs/slo.py signals()) — the /signals feed an
    # autoscaler consumes
    "sparknet_signal_admission_pressure": (),
    "sparknet_signal_queue_depth_slope": (),
    "sparknet_signal_p99_trend": (),
    "sparknet_signal_round_rate": ("host",),
    "sparknet_signal_error_budget_min": (),
}

# span names by category.  "phase" spans additionally feed the
# sparknet_phase_latency_seconds{phase=...} histogram, so this set IS
# that family's label vocabulary.
CANONICAL_SPANS = {
    "phase": frozenset({
        "assemble", "h2d", "execute", "average",
        "quantize", "allreduce", "dequantize", "allgather",
        "snapshot", "restore", "verify",
    }),
    "cache": frozenset({"cache_read", "cache_fetch"}),
    # the LM data plane's host-side window sampling (apps/lm_app.py —
    # nests under the producer thread's assemble span in traces)
    "data": frozenset({"sample_text"}),
    # generation serving (serve/generate.py): the two steps of the
    # prefill/decode disaggregation
    "gen": frozenset({"prefill", "decode_step"}),
    # request anatomy (obs/reqtrace.py + serve instrumentation): the
    # per-request lifecycle spans the RequestProfiler folds — a
    # "request" lifetime envelope around queue_wait -> kv_reserve ->
    # (gen) prefill/decode_step -> stream_write per chunk
    "req": frozenset({
        "request", "queue_wait", "kv_reserve", "stream_write",
    }),
}

# JAX-canonical metrics the port does not emit, with the reason: a doc
# token naming one is not a stale name (PERF.md and README.md describe
# both packages)
DOCUMENTED_ABSENT = {
    "sparknet_jit_cache_size": "the port compiles no XLA programs",
}

# the comm-plane span triple the round profiler folds into its
# bandwidth phases (kept here so the folder and the emitters cannot
# drift apart)
COMM_SPANS = ("quantize", "allreduce", "dequantize")

# doc tokens that look like metric names but aren't (the package
# itself, the native runtime library)
DOC_IGNORED_PREFIXES = ("sparknet_tpu", "sparknet_runtime")
