"""Continuous delivery: watch -> verify -> warm -> canary -> promote.

The port of ``sparknet_tpu/serve/delivery.py``: the serve half of
train-to-serve.  A
``DeliveryController`` watches the trainer's publish location through
the object-store + chunk-cache data plane, and walks each new publish
through the gauntlet:

1. **verify** — the manifest must decode, carry a PASSING health
   verdict (``serve/publish.py``), and the model bytes fetched through
   the ``ChunkCache`` must match the manifest's CRC32/size
   (``io/checkpoint.py`` read-only helpers — no solver is constructed).
   A corrupt or unverdicted publish is REJECTED here and quarantined
   (``*.corrupt``, the ``restore_newest_valid`` convention) — it never
   sees a canary.
2. **warm** — a standby ``InferenceEngine`` is built from the verified
   local bytes and fully warmed OFF the serving path: every bucket
   shape runs once on the delivery thread, so the serving replicas
   never meet a new shape.
3. **canary** — the router mirrors a configurable fraction of LIVE
   traffic to the standby (clients are always answered by an
   incumbent); over the decision window the canary's error rate,
   latency and output divergence vs the incumbent accumulate.
4. **decide** — promote (``ReplicaPool.promote``: per-replica warmed
   engines hot-swapped, zero dropped in-flight requests) or roll back
   (canary discarded, the condemned snapshot quarantined on disk so
   the watcher — and any ``restore_newest_valid`` resume — never
   trusts it again).

Every transition lands on the shared registry
(``sparknet_delivery_*``), the run log (``instant(cat="delivery")``),
and the ``/healthz`` ``delivery`` block (phase, incumbent, canary,
window progress).
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.data import chunk_cache as chunk_cache_mod
from sparknet_tpu_torch.data import object_store
from sparknet_tpu_torch.io import checkpoint
from sparknet_tpu_torch.serve.fleet import ReplicaPool, Router

_MANIFEST_RE = re.compile(r"(.*_iter_(\d+))\.manifest\.json$")

IDLE = "idle"
VERIFYING = "verifying"
WARMING = "warming"
CANARY = "canary"
DECIDING = "deciding"
_PHASE_CODE = {IDLE: 0, VERIFYING: 1, WARMING: 2, CANARY: 3, DECIDING: 4}


class DeliveryRejected(RuntimeError):
    """A publish failed verification (CRC, verdict) — never canaried."""


class DeliveryController:
    """Drives the publish->promote loop for one ``ReplicaPool``/
    ``Router`` pair.

    ``poll_once()`` is the whole state machine advanced one step —
    tests, chaos and bench drive it synchronously; ``start()`` runs it
    on a ``delivery-watcher`` thread every ``interval_s``.
    """

    def __init__(
        self,
        pool: ReplicaPool,
        router: Router,
        publish_url: str,
        cache_dir: Optional[str] = None,
        decision_requests: int = 24,
        divergence_max: float = 0.25,
        max_canary_errors: int = 0,
        latency_ratio_max: Optional[float] = None,
        window_timeout_s: float = 120.0,
        interval_s: float = 0.5,
        quarantine: bool = True,
        echo: Optional[Callable[[str], None]] = None,
    ):
        self.pool = pool
        self.router = router
        if "://" not in publish_url:
            publish_url = "file://" + os.path.abspath(publish_url)
        self.store = object_store.open_store(publish_url)
        self.cache = chunk_cache_mod.ChunkCache(
            cache_dir or tempfile.mkdtemp(prefix="sparknet_delivery_")
        )
        self.decision_requests = int(decision_requests)
        self.divergence_max = float(divergence_max)
        self.max_canary_errors = int(max_canary_errors)
        self.latency_ratio_max = latency_ratio_max
        self.window_timeout_s = float(window_timeout_s)
        self.interval_s = float(interval_s)
        self.quarantine = bool(quarantine)
        self._echo = echo
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._processed: set = set()
        self._phase = IDLE
        self._staged_weights: Optional[str] = None
        self._canary_engine = None
        self._canary_id: Optional[str] = None
        # the FULL store-relative manifest name of the canaried publish
        # (rollback must quarantine at the publish's real location,
        # subdirectories included)
        self._canary_manifest: Optional[str] = None
        self._window_t0: Optional[float] = None
        self.last_decision: Optional[Dict] = None
        self.history: List[Dict] = []

        # get-or-create: a REPLACED watcher on the same pool (restart
        # in-process, chaos sub-scenarios) keeps counting on the
        # existing series — Prometheus counters are process-cumulative
        reg = pool.registry
        self.m_phase = reg.get("sparknet_delivery_phase") or reg.gauge(
            "sparknet_delivery_phase",
            "delivery state machine phase (0=idle, 1=verifying, "
            "2=warming, 3=canary, 4=deciding)",
        )
        self.m_seen = reg.get(
            "sparknet_delivery_publishes_seen_total"
        ) or reg.counter(
            "sparknet_delivery_publishes_seen_total",
            "published snapshots the watcher picked up",
        )
        self.m_rejected = reg.get(
            "sparknet_delivery_rejected_total"
        ) or reg.counter(
            "sparknet_delivery_rejected_total",
            "publishes rejected at verify (CRC mismatch, missing or "
            "failing health verdict) — never canaried",
        )
        self.m_promotions = reg.get(
            "sparknet_delivery_promotions_total"
        ) or reg.counter(
            "sparknet_delivery_promotions_total",
            "canaries promoted to incumbent across the fleet",
        )
        self.m_rollbacks = reg.get(
            "sparknet_delivery_rollbacks_total"
        ) or reg.counter(
            "sparknet_delivery_rollbacks_total",
            "canaries rolled back (divergence/errors in the decision "
            "window); the condemned snapshot is quarantined",
        )
        self.m_divergence = reg.get(
            "sparknet_delivery_divergence"
        ) or reg.gauge(
            "sparknet_delivery_divergence",
            "max |canary - incumbent| output divergence observed over "
            "the last decision window (clamped at 1e30 for non-finite "
            "canary outputs)",
        )

    # ------------------------------------------------------------------
    def _say(self, msg: str) -> None:
        if self._echo is not None:
            self._echo("delivery: " + msg)

    def _set_phase(self, phase: str) -> None:
        self._phase = phase
        self.m_phase.set(_PHASE_CODE[phase])

    @property
    def phase(self) -> str:
        return self._phase

    @property
    def rejected(self) -> int:
        return int(self.m_rejected.value)

    @property
    def promotions(self) -> int:
        return int(self.m_promotions.value)

    @property
    def rollbacks(self) -> int:
        return int(self.m_rollbacks.value)

    def status(self) -> Dict:
        """The /healthz ``delivery`` block."""
        canary = self.router.canary
        window = None
        if canary is not None:
            st = canary.stats()
            window = {
                "mirrored": st["mirrored"],
                "decision_requests": self.decision_requests,
                "max_divergence": st["max_divergence"],
                "errors": st["errors"],
            }
        return {
            "phase": self._phase,
            "incumbent": self.pool.incumbent_id,
            "canary": self._canary_id,
            "window": window,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "rejected": self.rejected,
            "last_decision": self.last_decision,
        }

    # ------------------------------------------------------------------
    # publish discovery + verification
    def _list_manifests(self) -> List:
        """(iter, manifest_name) pairs visible at the publish location,
        newest first, quarantined ones excluded."""
        out = []
        for name in self.store.list(""):
            if name.endswith(".corrupt"):
                continue
            # dot-prefixed path components are publisher staging dirs
            # (serve/publish.py): a publish is visible only once its
            # verdict-carrying manifest renames into the root
            if any(part.startswith(".") for part in name.split("/")):
                continue
            m = _MANIFEST_RE.match(os.path.basename(name))
            if m:
                out.append((int(m.group(2)), name))
        out.sort(reverse=True)
        return out

    def _verify_and_stage(self, it: int, manifest_name: str) -> str:
        """Verify one publish end to end; returns the staged LOCAL
        weights path (a pinned chunk-cache entry).  Raises
        ``DeliveryRejected`` on any failure — verdict first (cheap),
        then CRC of the model bytes fetched through the cache."""
        manifest = checkpoint.parse_manifest(
            self.store.read(manifest_name), label=manifest_name
        )
        verdict = manifest.get("verdict")
        if not (isinstance(verdict, dict) and verdict.get("passing")):
            raise DeliveryRejected(
                f"{manifest_name}: no passing health verdict attached "
                f"({(verdict or {}).get('reason', 'verdict missing')})"
            )
        model_name = None
        for fname in manifest["files"]:
            if fname.endswith((".caffemodel", ".caffemodel.h5")):
                model_name = fname
        if model_name is None:
            raise DeliveryRejected(
                f"{manifest_name}: manifest lists no model file"
            )
        rel = os.path.join(os.path.dirname(manifest_name), model_name)
        want_size = int(manifest["files"][model_name]["size"])
        try:
            # the manifest's size invalidates a stale cache entry from
            # an earlier publish under the same name; a same-size stale
            # entry is caught by the CRC check and refreshed below
            data = self.cache.get(self.store, rel, size=want_size)
            try:
                checkpoint.verify_bytes_entry(model_name, data, manifest)
            except checkpoint.SnapshotCorrupt:
                # cached bytes disagree with the manifest — distinguish
                # "stale cache" (republished name; the STORE's bytes
                # verify) from "corrupt publish" (they don't): drop the
                # stale entry, refetch fresh, and re-verify.  A truly
                # corrupt publish fails again on the fresh bytes.
                self.cache._quarantine(
                    self.cache.key_for(self.store.url, rel), rel
                )
                data = self.cache.get(self.store, rel, size=want_size)
                checkpoint.verify_bytes_entry(model_name, data, manifest)
            # serve the engine build from the verified, PINNED local
            # entry (eviction can't unlink it while replicas reload)
            local = self.cache.local_path(self.store, rel, size=want_size)
        except checkpoint.SnapshotCorrupt as e:
            raise DeliveryRejected(str(e)) from e
        # the engine's weight loader dispatches on the EXTENSION
        # (.caffemodel vs .caffemodel.h5); the cache's content-addressed
        # chunk path has none, so hand out an extension-preserving
        # symlink view onto the pinned entry
        view = os.path.join(self.cache.root, "views")
        os.makedirs(view, exist_ok=True)
        link = os.path.join(view, model_name)
        if os.path.islink(link) or os.path.exists(link):
            os.unlink(link)
        os.symlink(local, link)
        return link

    def _quarantine_publish(self, manifest_name: str, why: str) -> List[str]:
        """Quarantine a condemned/corrupt publish on disk (local stores
        only — the ``restore_newest_valid`` rename convention, applied
        at the publish location so neither this watcher nor a resume
        scan ever trusts it again)."""
        root = getattr(self.store, "_root", None)  # LocalStore only
        if not self.quarantine or not root or not os.path.isdir(root):
            return []
        m = _MANIFEST_RE.match(os.path.basename(manifest_name))
        base = os.path.join(
            os.path.dirname(os.path.join(root, manifest_name)),
            os.path.basename(m.group(1)) if m else manifest_name,
        )
        moved = []
        for suffix in (
            ".manifest.json", ".caffemodel", ".caffemodel.h5",
            ".solverstate.npz", ".solverstate.h5",
        ):
            p = base + suffix
            if os.path.exists(p):
                os.replace(p, p + ".corrupt")
                moved.append(p + ".corrupt")
        obs.instant(
            "quarantine", cat="fault",
            snapshot=os.path.basename(manifest_name), why=why,
        )
        return moved

    # ------------------------------------------------------------------
    # the state machine, one step per call
    def poll_once(self) -> Optional[str]:
        """Advance the delivery state machine one step; returns a short
        action tag (None = nothing to do).  Exactly the loop body the
        ``delivery-watcher`` thread runs."""
        if self._phase in (CANARY, DECIDING):
            return self._advance_canary()
        for it, manifest_name in self._list_manifests():
            if manifest_name in self._processed:
                break  # newest already handled; older are history
            return self._take_publish(it, manifest_name)
        return None

    def _take_publish(self, it: int, manifest_name: str) -> str:
        self._processed.add(manifest_name)
        publish_id = os.path.basename(manifest_name)[: -len(
            ".manifest.json"
        )]
        self.m_seen.inc()
        self._set_phase(VERIFYING)
        self._say(f"publish {publish_id} (iter {it}): verifying")
        try:
            with obs.span("verify", path=publish_id):
                local = self._verify_and_stage(it, manifest_name)
        except (DeliveryRejected, checkpoint.SnapshotCorrupt) as e:
            self.m_rejected.inc()
            self._set_phase(IDLE)
            moved = self._quarantine_publish(manifest_name, str(e))
            self.last_decision = {
                "publish_id": publish_id, "action": "rejected",
                "why": str(e), "quarantined": moved,
            }
            self.history.append(self.last_decision)
            obs.instant(
                "delivery_rejected", cat="delivery",
                publish=publish_id, why=str(e),
            )
            self._say(f"publish {publish_id} REJECTED at verify: {e}")
            return "rejected"
        self._set_phase(WARMING)
        self._say(f"publish {publish_id}: warming standby engine off-path")
        # the standby runs every bucket HERE, on the delivery thread —
        # the serving replicas never meet a new shape
        try:
            engine = self.pool.make_engine(weights=local)
            engine.warmup()
        except Exception as e:  # noqa: BLE001 — an incompatible publish
            # verified bytes that cannot build THIS fleet's engine
            # (layer-shape mismatch, wrong net): reject — without
            # quarantine, the files are intact for a compatible fleet —
            # and return to idle instead of wedging in "warming"
            self.m_rejected.inc()
            self._set_phase(IDLE)
            self.last_decision = {
                "publish_id": publish_id, "action": "rejected",
                "why": f"standby engine build failed: {e!r}",
                "quarantined": [],
            }
            self.history.append(self.last_decision)
            obs.instant(
                "delivery_rejected", cat="delivery",
                publish=publish_id, why=repr(e),
            )
            self._say(
                f"publish {publish_id} REJECTED: standby engine build "
                f"failed ({e!r})"
            )
            return "rejected"
        self._staged_weights = local
        self._canary_engine = engine
        self._canary_id = publish_id
        self._canary_manifest = manifest_name
        self._window_t0 = time.monotonic()
        self.router.install_canary(engine, publish_id)
        self._set_phase(CANARY)
        obs.instant("canary_start", cat="delivery", publish=publish_id)
        self._say(
            "publish %s: canary live (every ~1/%.3f of traffic "
            "mirrored; window %d requests)"
            % (publish_id, self.router.canary_frac, self.decision_requests)
        )
        return "canary"

    def _advance_canary(self) -> Optional[str]:
        canary = self.router.canary
        if canary is None:  # cleared externally
            self._set_phase(IDLE)
            return None
        st = canary.stats()
        timed_out = (
            self._window_t0 is not None
            and time.monotonic() - self._window_t0 > self.window_timeout_s
        )
        # fail FAST on hard evidence; otherwise wait out the window
        hard_bad = st["nonfinite"] or (
            st["errors"] > self.max_canary_errors
        ) or st["max_divergence"] > self.divergence_max
        if (
            st["mirrored"] < self.decision_requests
            and not hard_bad
            and not timed_out
        ):
            return None
        self._set_phase(DECIDING)
        return self._decide(st, timed_out=timed_out)

    def _decide(self, st: Dict, timed_out: bool = False) -> str:
        publish_id = self._canary_id
        why = []
        if st["nonfinite"]:
            why.append("non-finite canary outputs")
        if st["errors"] > self.max_canary_errors:
            why.append(
                f"{st['errors']} canary error(s) > {self.max_canary_errors}"
            )
        if st["max_divergence"] > self.divergence_max:
            why.append(
                "output divergence %.4g > %.4g"
                % (st["max_divergence"], self.divergence_max)
            )
        if self.latency_ratio_max and st["canary_p95_ms"] and (
            st["incumbent_p95_ms"]
        ):
            if st["canary_p95_ms"] > (
                self.latency_ratio_max * st["incumbent_p95_ms"]
            ):
                why.append(
                    "canary p95 %.1fms > %.1fx incumbent p95 %.1fms"
                    % (
                        st["canary_p95_ms"], self.latency_ratio_max,
                        st["incumbent_p95_ms"],
                    )
                )
        # hard evidence (errors/divergence/non-finite) CONDEMNS the
        # snapshot; a bare window timeout is merely inconclusive — the
        # canary comes down either way, but only condemned publishes
        # are quarantined (an idle server must never destroy a good
        # publish it simply couldn't gather evidence on)
        condemned = bool(why)
        if timed_out and st["mirrored"] < self.decision_requests:
            why.append(
                "window timed out at %d/%d mirrored requests "
                "(inconclusive — not promoted, snapshot left intact)"
                % (st["mirrored"], self.decision_requests)
            )
        self.m_divergence.set(min(st["max_divergence"], 1e30))
        if why:
            return self._rollback(
                publish_id, st, "; ".join(why), condemn=condemned
            )
        return self._promote(publish_id, st)

    def _promote(self, publish_id: str, st: Dict) -> str:
        round_ = self.router.clear_canary()
        # the canary's already-warm engine serves the first replica; the
        # rest get fresh warmed engines from the verified local bytes
        swapped = self.pool.promote(
            self._staged_weights,
            publish_id=publish_id,
            first_engine=round_.engine if round_ is not None else None,
        )
        self.m_promotions.inc()
        self.last_decision = {
            "publish_id": publish_id, "action": "promoted",
            "replicas_swapped": swapped, "window": st,
        }
        self.history.append(self.last_decision)
        self._reset_round()
        obs.instant(
            "promote", cat="delivery", publish=publish_id,
            replicas=swapped,
        )
        self._say(
            f"publish {publish_id} PROMOTED to {swapped} replica(s) "
            "(max divergence %.4g over %d mirrored)"
            % (st["max_divergence"], st["mirrored"])
        )
        return "promoted"

    def _rollback(self, publish_id: str, st: Dict, why: str,
                  condemn: bool = True) -> str:
        self.router.clear_canary()
        moved = []
        if condemn:
            # quarantine at the publish's REAL location (the full
            # store-relative manifest name — subdirectories included)
            moved = self._quarantine_publish(
                self._canary_manifest or (publish_id + ".manifest.json"),
                why,
            )
        self.m_rollbacks.inc()
        self.last_decision = {
            "publish_id": publish_id, "action": "rolled_back",
            "why": why, "quarantined": moved, "window": st,
        }
        self.history.append(self.last_decision)
        self._reset_round()
        obs.instant(
            "rollback", cat="delivery", publish=publish_id, why=why,
        )
        self._say(f"publish {publish_id} ROLLED BACK: {why}")
        return "rolled_back"

    def _reset_round(self) -> None:
        self._canary_engine = None
        self._canary_id = None
        self._canary_manifest = None
        self._staged_weights = None
        self._window_t0 = None
        self._set_phase(IDLE)

    # ------------------------------------------------------------------
    # the watcher thread
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — watcher must survive
                # a transient store/listing error must not kill the
                # watcher; record it and keep polling
                self._say(f"poll error (will retry): {e!r}")
                obs.instant("delivery_poll_error", cat="delivery",
                            error=repr(e))
            self._stop.wait(self.interval_s)

    def start(self) -> "DeliveryController":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="delivery-watcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=30.0)
