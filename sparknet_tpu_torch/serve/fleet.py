"""Serving fleet: replicated engines behind a load-shedding router.

The port of ``sparknet_tpu/serve/fleet.py``.  A ``ReplicaPool`` owns N
shared-nothing replicas — each one its own engine (its own weights on
its device, its own shape count) behind its own ``MicroBatcher`` worker
thread (``StreamBatcher`` for a generation fleet), optionally pinned to
its own ``torch.device`` — and a ``Router`` spreads requests over the
live ones by in-flight depth.  On one card every replica sits on
``cuda:0`` with its own copy of the weights, and the replicas' worker
threads share the card.

Contracts:

- **Bounded admission, fleet-wide.**  The router sheds with the same
  ``QueueFull`` -> HTTP 429 + Retry-After contract the single-replica
  batcher established, but the bound is on TOTAL in-flight requests
  across the fleet, not per replica: at a fixed offered load past
  saturation the number of 429s is invariant in the replica count, so
  adding replicas never silently loosens the admission contract.
- **Eject + retry, never drop.**  A replica whose worker died is
  ejected from rotation on the first failed submit and the request
  retries on a live replica — inference is idempotent, so a replica
  death costs latency, not errors.  ``respawn()`` rebuilds an ejected
  replica from the pool's engine factory (warmed off-path) and returns
  it to rotation.
- **Hot engine swap.**  ``Replica.swap_engine`` atomically replaces the
  engine between batches: the in-flight batch finishes on the old
  engine (the batcher captures its engine per batch), the next batch
  runs the new one.  ``ReplicaPool.promote`` builds + warms one fresh
  engine per replica OFF the serving path and swaps them in — zero
  dropped in-flight requests across a promote.
- **Canary mirroring.**  With a canary installed (``serve/delivery.py``)
  the router duplicates every k-th request to the canary engine from a
  dedicated mirror thread, through the canary's own batcher (and so its
  own engine lock): the client is always answered by an incumbent,
  while the canary's error rate, latency and output divergence
  accumulate into the decision-window stats.

Per-replica state/in-flight/request series and the fleet sums render
through one shared ``obs.metrics`` registry (``sparknet_serve_replica_*``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from sparknet_tpu_torch.obs import reqtrace as _reqtrace
from sparknet_tpu_torch.obs.metrics import MetricsRegistry
from sparknet_tpu_torch.serve.batcher import MicroBatcher, QueueFull, StreamBatcher
from sparknet_tpu_torch.serve.engine import InferenceEngine

# replica states (the /healthz vocabulary)
LIVE = "live"
DRAINING = "draining"
EJECTED = "ejected"
_STATE_CODE = {LIVE: 0, DRAINING: 1, EJECTED: 2}


class FleetUnservable(RuntimeError):
    """No live replica can take the request — the WHOLE fleet is out
    (HTTP 503); one draining/ejected replica is not this."""


class Replica:
    """One shared-nothing serving replica: an engine + its private
    micro-batcher worker.  State transitions are the pool's job; the
    replica only knows how to serve, drain, die, and swap engines."""

    def __init__(
        self,
        index: int,
        engine: InferenceEngine,
        max_queue: int = 256,
        max_wait_ms: float = 2.0,
        stream: bool = False,
    ):
        self.index = index
        self.state = LIVE
        self.max_queue = int(max_queue)
        self.max_wait_ms = float(max_wait_ms)
        self.stream = bool(stream)
        # stream replicas run continuous batching over a GenerationEngine
        # (serve/generate.py); everything the pool/router touch —
        # queue_depth, drain, stop, _running/_worker, engine attribute —
        # is the shared batcher surface, so the fleet contracts compose
        self.batcher = (
            # replica=index tags every request span this batcher opens,
            # so the request profiler can name the slow replica
            StreamBatcher(engine, max_queue=max_queue, replica=index)
            if self.stream
            else MicroBatcher(
                engine, max_queue=max_queue, max_wait_ms=max_wait_ms
            )
        )

    @property
    def engine(self) -> InferenceEngine:
        return self.batcher.engine

    def swap_engine(self, engine: InferenceEngine) -> InferenceEngine:
        """Atomically point the batcher at ``engine`` (a plain attribute
        store): the in-flight batch completes on the old engine — the
        batcher reads its engine once per batch — and every later batch
        runs the new one.  Returns the previous engine."""
        old, self.batcher.engine = self.batcher.engine, engine
        return old

    @property
    def healthy(self) -> bool:
        """Worker thread alive and accepting — the router's routing
        predicate (a killed replica reads False immediately)."""
        return (
            self.state == LIVE
            and self.batcher._running
            and self.batcher._worker.is_alive()
        )

    def kill(self) -> None:
        """Hard-stop the worker WITHOUT draining (the chaos
        ``replica_death`` fault): queued requests error out and the
        router retries them on live replicas."""
        self.batcher.stop(drain=False, timeout=1.0)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.batcher.stop(drain=drain, timeout=timeout)


class _CanaryRound:
    """One canary engine under evaluation + its decision-window stats.

    The canary gets its OWN batcher (shared-nothing like any replica);
    mirrored requests flow to it from the router's mirror thread, and
    every observation lands here under one lock."""

    def __init__(self, engine: InferenceEngine, publish_id: str,
                 max_wait_ms: float = 2.0, stream: bool = False):
        self.engine = engine
        self.publish_id = publish_id
        self.stream = bool(stream)
        # a generation canary is scored, not batch-served: the mirror
        # thread teacher-forces the incumbent's tokens through
        # ``engine.score_tokens`` directly, so no batcher exists
        self.batcher = (
            None
            if self.stream
            else MicroBatcher(engine, max_queue=64, max_wait_ms=max_wait_ms)
        )
        self._lock = threading.Lock()
        self.mirrored = 0
        self.errors = 0
        self.nonfinite = False
        self.max_divergence = 0.0
        self.canary_lat_s: List[float] = []
        self.incumbent_lat_s: List[float] = []

    def note(self, divergence: Optional[float], canary_s: float,
             incumbent_s: float, error: bool, nonfinite: bool) -> None:
        with self._lock:
            self.mirrored += 1
            if error:
                self.errors += 1
            if nonfinite:
                self.nonfinite = True
            if divergence is not None:
                self.max_divergence = max(self.max_divergence, divergence)
            if len(self.canary_lat_s) < 4096:
                self.canary_lat_s.append(canary_s)
                self.incumbent_lat_s.append(incumbent_s)

    def stats(self) -> Dict:
        with self._lock:
            c = sorted(self.canary_lat_s)
            i = sorted(self.incumbent_lat_s)

            def q(v, p):
                return v[min(len(v) - 1, int(p * len(v)))] if v else None

            return {
                "publish_id": self.publish_id,
                "mirrored": self.mirrored,
                "errors": self.errors,
                "nonfinite": self.nonfinite,
                "max_divergence": self.max_divergence,
                "canary_p50_ms": (
                    q(c, 0.5) * 1e3 if c else None
                ),
                "canary_p95_ms": (
                    q(c, 0.95) * 1e3 if c else None
                ),
                "incumbent_p50_ms": (
                    q(i, 0.5) * 1e3 if i else None
                ),
                "incumbent_p95_ms": (
                    q(i, 0.95) * 1e3 if i else None
                ),
            }

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.stop(drain=False, timeout=5.0)


class ReplicaPool:
    """N shared-nothing replicas built from one engine factory, plus the
    shared fleet metrics registry.

    ``make_engine(weights=None) -> InferenceEngine`` builds an UNWARMED
    engine; the pool warms every engine it builds before the engine sees
    traffic (construction, ``respawn``, ``promote`` — all off the
    serving path).  ``devices`` optionally pins replica i to
    ``devices[i % len(devices)]``, a ``torch.device`` handed to the
    factory as ``make_engine(weights=..., device=...)`` (per-device
    fleet; on a one-card host every replica shares the card and the
    threads contend)."""

    def __init__(
        self,
        make_engine: Callable[..., InferenceEngine],
        replicas: int = 2,
        max_queue: int = 256,
        max_wait_ms: float = 2.0,
        registry: Optional[MetricsRegistry] = None,
        devices: Optional[Sequence] = None,
        stream: bool = False,
    ):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.make_engine = make_engine
        self.devices = list(devices) if devices else None
        self.max_queue = int(max_queue)
        self.max_wait_ms = float(max_wait_ms)
        # stream=True: the factory builds GenerationEngines and every
        # replica runs a StreamBatcher (continuous batching) — the
        # eject/respawn/hot-swap/canary contracts compose unchanged
        self.stream = bool(stream)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self.incumbent_id: Optional[str] = None
        # respawns and promotes must agree on which weights are current:
        # None serves the factory's boot weights until the first promote
        self._incumbent_weights: Optional[str] = None

        r = self.registry
        self.m_state = r.gauge(
            "sparknet_serve_replica_state",
            "replica rotation state (0=live, 1=draining, 2=ejected)",
            labels=("replica",),
        )
        self.m_inflight = r.gauge(
            "sparknet_serve_replica_inflight",
            "requests currently admitted to this replica (queued + "
            "executing)",
            labels=("replica",),
        )
        self.m_requests = r.counter(
            "sparknet_serve_replica_requests_total",
            "requests served to completion by this replica",
            labels=("replica",),
        )
        self.m_errors = r.counter(
            "sparknet_serve_replica_errors_total",
            "requests that errored on this replica (before any retry on "
            "a live sibling)",
            labels=("replica",),
        )
        self.m_ejections = r.counter(
            "sparknet_serve_replica_ejections_total",
            "replicas ejected from rotation (dead worker / poisoned "
            "engine)",
        )
        self.m_respawns = r.counter(
            "sparknet_serve_replica_respawns_total",
            "ejected replicas rebuilt from the engine factory and "
            "returned to rotation",
        )
        self.m_swaps = r.counter(
            "sparknet_serve_replica_engine_swaps_total",
            "hot engine swaps (promotes/rollbacks) applied to replicas",
        )

        self.replicas: List[Replica] = []
        for i in range(replicas):
            self.replicas.append(self._build_replica(i))

    # ------------------------------------------------------------------
    def _device_for(self, index: int):
        if not self.devices:
            return None
        return self.devices[index % len(self.devices)]

    def _new_engine(self, index: int, weights: Optional[str] = None
                    ) -> InferenceEngine:
        """Build + warm one engine for replica ``index`` — always off
        the serving path (construction, respawn, promote)."""
        dev = self._device_for(index)
        if dev is not None:
            eng = self.make_engine(weights=weights, device=dev)
        else:
            eng = self.make_engine(weights=weights)
        eng.warmup()
        return eng

    def _build_replica(self, index: int,
                       weights: Optional[str] = None) -> Replica:
        rep = Replica(
            index,
            self._new_engine(index, weights=weights),
            max_queue=self.max_queue,
            max_wait_ms=self.max_wait_ms,
            stream=self.stream,
        )
        self._set_state(rep, LIVE)
        return rep

    def _set_state(self, rep: Replica, state: str) -> None:
        rep.state = state
        self.m_state.labels(str(rep.index)).set(_STATE_CODE[state])

    # ------------------------------------------------------------------
    @property
    def item_shape(self):
        return self.replicas[0].engine.item_shape

    def live_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy]

    def states(self) -> List[Dict]:
        """Per-replica state rows for /healthz."""
        return [
            {
                "replica": r.index,
                "state": r.state,
                "worker_alive": bool(r.batcher._worker.is_alive()),
                "queue_depth": r.batcher.queue_depth(),
            }
            for r in self.replicas
        ]

    # ------------------------------------------------------------------
    def eject(self, index: int) -> None:
        """Take a replica out of rotation and let its queue die: the
        router retries its failed requests on live siblings."""
        rep = self.replicas[index]
        if rep.state == EJECTED:
            return
        self._set_state(rep, EJECTED)
        self.m_ejections.inc()
        rep.kill()

    def drain(self, index: int) -> None:
        """Stop admitting to one replica; queued work still completes
        (the graceful half of ejection — /healthz stays 200 as long as
        a live sibling remains)."""
        rep = self.replicas[index]
        if rep.state == LIVE:
            self._set_state(rep, DRAINING)
            rep.batcher.drain()

    def respawn(self, index: int) -> Replica:
        """Rebuild an ejected replica from the engine factory (warmed
        off-path, serving the pool's current incumbent weights) and
        return it to rotation."""
        with self._lock:
            old = self.replicas[index]
            rep = Replica(
                index,
                self._new_engine(index, weights=self._incumbent_weights),
                max_queue=self.max_queue,
                max_wait_ms=self.max_wait_ms,
                stream=self.stream,
            )
            self.replicas[index] = rep
        old.stop(drain=False, timeout=1.0)
        self._set_state(rep, LIVE)
        self.m_respawns.inc()
        return rep

    def promote(
        self,
        weights: Optional[str],
        publish_id: Optional[str] = None,
        first_engine: Optional[InferenceEngine] = None,
    ) -> int:
        """Hot-reload every non-ejected replica onto ``weights``: one
        fresh engine per replica is built + WARMED off the serving path
        (``first_engine`` — typically the already-warm canary — is
        reused for the first replica), then swapped in atomically.
        In-flight requests complete on the engine that admitted them;
        nothing is dropped.  Returns the number of replicas swapped."""
        swapped = 0
        spare = first_engine
        for rep in self.replicas:
            if rep.state == EJECTED:
                continue
            eng = spare if spare is not None else self._new_engine(
                rep.index, weights=weights
            )
            spare = None
            rep.swap_engine(eng)
            self.m_swaps.inc()
            swapped += 1
        self._incumbent_weights = weights
        if publish_id is not None:
            self.incumbent_id = publish_id
        return swapped

    def close(self) -> None:
        for rep in self.replicas:
            rep.stop(drain=True, timeout=10.0)


class Router:
    """Load balancer over a ``ReplicaPool``: min-in-flight routing,
    fleet-wide bounded admission (429 shed), eject-and-retry on dead
    replicas, and canary mirroring for ``serve/delivery.py``."""

    def __init__(
        self,
        pool: ReplicaPool,
        max_inflight: int = 256,
        canary_frac: float = 0.125,
    ):
        self.pool = pool
        self.max_inflight = int(max_inflight)
        self.canary_frac = float(canary_frac)
        # every k-th request mirrors while a canary is installed
        # (deterministic sampling — testable, no RNG on the hot path)
        self._canary_every = (
            max(1, int(round(1.0 / self.canary_frac)))
            if self.canary_frac > 0 else 0
        )
        self._lock = threading.Lock()
        self._inflight: Dict[int, int] = {
            r.index: 0 for r in pool.replicas
        }
        self._total_inflight = 0
        self._rr = 0
        self._submitted = 0
        self._draining = False
        self._canary: Optional[_CanaryRound] = None
        # canary mirrors ride a bounded queue to a dedicated worker so
        # the client-facing path never waits on the canary; a full
        # queue drops the mirror (counted), never the request
        self._mirror_q: "queue.Queue" = queue.Queue(maxsize=64)
        self._mirror_dropped = 0
        self._mirror_thread: Optional[threading.Thread] = None

        reg = pool.registry
        self.m_requests = reg.counter(
            "serve_requests_total", "requests admitted fleet-wide"
        )
        self.m_shed = reg.counter(
            "serve_requests_shed_total",
            "requests shed at the fleet admission bound (HTTP 429)",
        )
        self.m_latency = reg.histogram(
            "serve_request_latency_seconds",
            "submit-to-result latency per request, fleet-wide",
        )
        self.m_unservable = reg.counter(
            "serve_unservable_total",
            "requests refused because no live replica existed (HTTP 503)",
        )
        self.m_retries = reg.counter(
            "serve_replica_retries_total",
            "requests retried on a sibling after a replica-level failure",
        )
        self.m_canary_mirrors = reg.counter(
            "sparknet_delivery_canary_mirrors_total",
            "requests mirrored to the canary engine during a decision "
            "window (the client is always answered by an incumbent)",
        )
        self.m_resumes = reg.counter(
            "sparknet_gen_resumes_total",
            "streams resumed on a sibling replica via re-prefill after "
            "a mid-stream replica death (greedy decode is deterministic "
            "— the continuation is exact)",
        )

    # ------------------------------------------------------------------
    @property
    def item_shape(self):
        return self.pool.item_shape

    @property
    def draining(self) -> bool:
        return self._draining

    def initiate_drain(self) -> None:
        self._draining = True
        for rep in self.pool.replicas:
            if rep.state == LIVE:
                rep.batcher.drain()

    def queue_depth(self) -> int:
        return sum(r.batcher.queue_depth() for r in self.pool.replicas)

    def inflight(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._inflight)

    # ------------------------------------------------------------------
    def _pick(self) -> Replica:
        """The live replica with the fewest in-flight requests (round-
        robin on ties).  Raises ``FleetUnservable`` when none is live —
        the only condition that 503s the whole fleet."""
        # eject-on-sight: a nominally-LIVE replica whose worker died
        # (killed thread, poisoned engine) leaves rotation HERE, not
        # just implicitly — states, metrics and /healthz stay truthful
        for r in self.pool.replicas:
            if r.state == LIVE and not r.healthy:
                self.pool.eject(r.index)
        with self._lock:
            live = [r for r in self.pool.replicas if r.healthy]
            if not live:
                self.m_unservable.inc()
                raise FleetUnservable("no live replica in the fleet")
            self._rr += 1
            best = min(
                live,
                key=lambda r: (
                    self._inflight.get(r.index, 0),
                    (r.index - self._rr) % (len(self.pool.replicas) + 1),
                ),
            )
            return best

    def _admit(self, rid: Optional[str] = None) -> None:
        with self._lock:
            if self._draining:
                _reqtrace.note_shed("draining", rid=rid)
                raise RuntimeError("router is draining")
            if self._total_inflight >= self.max_inflight:
                self.m_shed.inc()
                _reqtrace.note_shed("queue_full", rid=rid)
                raise QueueFull(
                    "fleet admission bound reached "
                    f"({self.max_inflight} in flight)"
                )
            self._total_inflight += 1

    def submit(self, x: np.ndarray, timeout: Optional[float] = 60.0):
        """Route one request: fleet-bounded admission, min-in-flight
        replica choice, eject-and-retry on replica-level failure, and
        (with a canary installed) every k-th request mirrored."""
        self._admit()
        t0 = time.perf_counter()
        try:
            attempts = 0
            while True:
                rep = self._pick()
                with self._lock:
                    self._inflight[rep.index] = (
                        self._inflight.get(rep.index, 0) + 1
                    )
                    self.m_inflight_set(rep.index)
                try:
                    out = rep.batcher.submit(x, timeout=timeout)
                except QueueFull:
                    # a per-replica bound fired under the fleet bound
                    # (misconfiguration more than saturation) — still
                    # the shed contract, still 429 upstream
                    self.m_shed.inc()
                    raise
                except TimeoutError:
                    raise
                except Exception:
                    self.pool.m_errors.labels(str(rep.index)).inc()
                    if rep.healthy:
                        raise  # engine-level error on a live replica
                    # replica-level death: eject and retry on a sibling
                    self.pool.eject(rep.index)
                    attempts += 1
                    self.m_retries.inc()
                    if attempts > len(self.pool.replicas):
                        raise
                    continue
                finally:
                    with self._lock:
                        self._inflight[rep.index] = max(
                            0, self._inflight.get(rep.index, 0) - 1
                        )
                        self.m_inflight_set(rep.index)
                self.pool.m_requests.labels(str(rep.index)).inc()
                self.m_requests.inc()
                lat = time.perf_counter() - t0
                self.m_latency.observe(lat)
                self._maybe_mirror(x, out, lat)
                return out
        finally:
            with self._lock:
                self._total_inflight -= 1

    def m_inflight_set(self, index: int) -> None:
        # caller holds self._lock; gauge children have their own lock
        self.pool.m_inflight.labels(str(index)).set(
            self._inflight.get(index, 0)
        )

    # ------------------------------------------------------------------
    # streaming generation (stream=True pools)
    def submit_stream(self, prompt, max_new: int, timeout: float = 120.0,
                      rid: Optional[str] = None):
        """Route one generation stream; yields token events and exactly
        one terminal event (``done``/``stopped``/``error``).

        Same contracts as ``submit``, extended to streams: fleet-wide
        bounded admission (``QueueFull`` -> 429 raised before the first
        event), min-in-flight pick, and — the stream-specific one —
        RESUME on a mid-stream replica death: the dead replica is
        ejected and the stream re-prefills prompt + tokens-so-far on a
        sibling.  Greedy decode is deterministic, so the sibling
        continues the IDENTICAL sequence; token indices keep counting
        and the client never sees the seam (``decode_replica_kill``
        chaos fault).  Finished streams canary-mirror every k-th via
        per-token logprob scoring."""
        rid = _reqtrace.maybe_rid(rid)
        self._admit(rid)
        t0 = time.perf_counter()
        try:
            prompt = [int(t) for t in prompt]
            max_new = int(max_new)
            tokens: List[int] = []
            logprobs: List[float] = []
            attempts = 0
            while True:
                if tokens and len(tokens) >= max_new:
                    # the kill landed between the last token and its
                    # done event — nothing left to decode; finish here
                    yield {
                        "event": "done",
                        "tokens": list(tokens),
                        "text": StreamBatcher._text(tokens),
                        "finish_reason": "length",
                    }
                    return
                rep = self._pick()
                with self._lock:
                    self._inflight[rep.index] = (
                        self._inflight.get(rep.index, 0) + 1
                    )
                    self.m_inflight_set(rep.index)
                err = None
                try:
                    try:
                        # the resume path reuses the SAME rid: the
                        # re-prefill on a sibling folds into one request
                        st = rep.batcher.submit_stream(
                            prompt + tokens, max_new - len(tokens),
                            rid=rid,
                        )
                    except QueueFull:
                        self.m_shed.inc()
                        raise
                    except ValueError:
                        # bad geometry: a FRESH stream propagates (400
                        # upstream); a resume that outgrew the bucket
                        # ends with a clean error event instead
                        if not tokens:
                            raise
                        err = "resume exceeds engine geometry"
                    except (RuntimeError, OSError) as e:
                        # replica refused outright (stopped batcher) —
                        # the eject-and-retry path below
                        err = f"submit failed: {e}"
                    if err is None:
                        base = len(tokens)
                        for ev in st.iter_events(timeout=timeout):
                            kind = ev["event"]
                            if kind == "token":
                                tokens.append(int(ev["token"]))
                                logprobs.append(float(ev["logprob"]))
                                yield {
                                    "event": "token",
                                    "token": tokens[-1],
                                    "logprob": logprobs[-1],
                                    "index": base + int(ev["index"]),
                                }
                            elif kind == "done":
                                self.pool.m_requests.labels(
                                    str(rep.index)
                                ).inc()
                                self.m_requests.inc()
                                lat = time.perf_counter() - t0
                                self.m_latency.observe(lat)
                                self._maybe_mirror_stream(
                                    prompt, tokens, logprobs, lat
                                )
                                yield {
                                    "event": "done",
                                    "tokens": list(tokens),
                                    "text": StreamBatcher._text(tokens),
                                    "finish_reason": ev.get(
                                        "finish_reason", "length"
                                    ),
                                }
                                return
                            elif kind == "stopped":
                                yield {
                                    "event": "stopped",
                                    "tokens": list(tokens),
                                    "text": StreamBatcher._text(tokens),
                                    "finish_reason": "stopped",
                                }
                                return
                            else:  # error — maybe resumable
                                err = ev.get("error", "stream failed")
                                break
                finally:
                    with self._lock:
                        self._inflight[rep.index] = max(
                            0, self._inflight.get(rep.index, 0) - 1
                        )
                        self.m_inflight_set(rep.index)
                # error leg: eject a dead replica and resume on a
                # sibling, or end with a clean error event — NEVER a
                # silent hang
                self.pool.m_errors.labels(str(rep.index)).inc()
                if rep.healthy:
                    yield {"event": "error", "error": err}
                    return
                self.pool.eject(rep.index)
                attempts += 1
                self.m_retries.inc()
                if attempts > len(self.pool.replicas):
                    yield {
                        "event": "error",
                        "error": (
                            f"stream failed on {attempts} replicas: {err}"
                        ),
                    }
                    return
                if tokens:
                    self.m_resumes.inc()
        finally:
            with self._lock:
                self._total_inflight -= 1

    # ------------------------------------------------------------------
    # canary plumbing (driven by serve/delivery.py)
    def install_canary(self, engine: InferenceEngine,
                       publish_id: str) -> _CanaryRound:
        """Start mirroring every k-th request (k from ``canary_frac``)
        to ``engine``; returns the stats accumulator the delivery
        controller decides on."""
        if self._canary is not None:
            raise RuntimeError(
                f"canary {self._canary.publish_id!r} already installed"
            )
        round_ = _CanaryRound(
            engine,
            publish_id,
            max_wait_ms=self.pool.max_wait_ms,
            stream=getattr(self.pool, "stream", False),
        )
        self._canary = round_
        self._mirror_thread = threading.Thread(
            target=self._mirror_loop, name="canary-mirror", daemon=True
        )
        self._mirror_thread.start()
        return round_

    def clear_canary(self) -> Optional[_CanaryRound]:
        """Stop mirroring and tear the canary's batcher down; returns
        the finished round (its engine may be reused by a promote)."""
        round_, self._canary = self._canary, None
        t = self._mirror_thread
        self._mirror_thread = None
        if t is not None:
            self._mirror_q.put(None)  # sentinel unblocks the worker
            t.join(timeout=10.0)
        if round_ is not None:
            round_.close()
        return round_

    @property
    def canary(self) -> Optional[_CanaryRound]:
        return self._canary

    def _maybe_mirror(self, x: np.ndarray, incumbent_out: np.ndarray,
                      incumbent_s: float) -> None:
        round_ = self._canary
        if round_ is None or not self._canary_every:
            return
        with self._lock:
            self._submitted += 1
            take = (self._submitted % self._canary_every) == 0
        if not take:
            return
        try:
            self._mirror_q.put_nowait(("predict", round_, x, incumbent_out,
                                       incumbent_s))
        except queue.Full:
            with self._lock:
                self._mirror_dropped += 1

    def _maybe_mirror_stream(self, prompt, tokens, logprobs,
                             incumbent_s: float) -> None:
        """Every k-th FINISHED stream mirrors to a generation canary:
        the incumbent's tokens are teacher-force scored on the canary
        and the divergence is the max per-token |delta logprob| —
        token-level disagreement shows up as a large logprob delta at
        the first divergent position."""
        round_ = self._canary
        if round_ is None or not self._canary_every or not tokens:
            return
        with self._lock:
            self._submitted += 1
            take = (self._submitted % self._canary_every) == 0
        if not take:
            return
        try:
            self._mirror_q.put_nowait((
                "stream", round_, list(prompt), list(tokens),
                np.asarray(logprobs, np.float64), incumbent_s,
            ))
        except queue.Full:
            with self._lock:
                self._mirror_dropped += 1

    def _mirror_loop(self) -> None:
        """Mirror worker: replays sampled requests on the canary and
        folds divergence/latency/error into the decision window.  Runs
        on its own thread so the client path never waits on the
        canary."""
        while True:
            item = self._mirror_q.get()
            if item is None:
                return
            kind, round_ = item[0], item[1]
            if round_ is not self._canary:
                continue  # a stale mirror from a cleared round
            t0 = time.perf_counter()
            error = nonfinite = False
            divergence = None
            incumbent_s = item[-1]
            try:
                if kind == "stream":
                    # generation canary: teacher-force the incumbent's
                    # tokens through the canary engine and compare
                    # per-token logprobs — deterministic, no sampling
                    _, _, prompt, toks, inc_lps, incumbent_s = item
                    lps = round_.engine.score_tokens(prompt, toks)
                    if not np.isfinite(lps).all():
                        nonfinite = True
                        divergence = float("inf")
                    else:
                        # sparknet: sync-ok(host numpy divergence reduction over already-materialized logprobs)
                        divergence = float(np.max(np.abs(
                            lps.astype(np.float64) - inc_lps
                        )))
                else:
                    _, _, x, incumbent_out, incumbent_s = item
                    out = round_.batcher.submit(x, timeout=60.0)
                    # both sides are host numpy arrays (serving
                    # responses are materialized by contract); the
                    # reductions below never touch a device buffer
                    # sparknet: sync-ok(host numpy divergence reduction over already-materialized serving outputs)
                    delta = float(np.max(np.abs(
                        out.astype(np.float64)
                        - incumbent_out.astype(np.float64)
                    )))
                    if not np.isfinite(out).all():
                        nonfinite = True
                        divergence = float("inf")
                    else:
                        divergence = delta
            except Exception:
                error = True
            round_.note(
                divergence
                if divergence is None or np.isfinite(divergence)
                else 1e30,
                time.perf_counter() - t0,
                incumbent_s,
                error,
                nonfinite,
            )
            self.m_canary_mirrors.inc()

    # ------------------------------------------------------------------
    def close(self) -> None:
        self.clear_canary()
        self.pool.close()
