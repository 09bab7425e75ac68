"""Deterministic chaos harness: the fault-tolerance layer, end to end.

The port of ``sparknet_tpu/runtime/chaos.py``.  A seeded ``FaultPlan``
injects the failure modes of a training fleet into a small
cifar10_quick run (W=4 workers stacked on one device, two-slice
``HierarchySpec``), and each injected fault must be survived:

- **storage**: transient connection resets in the round's fetch, healed
  by ``utils/retry``;
- **stall**: the producer wedges past the ``RoundFeed`` watchdog; the
  feed is stopped and rebuilt from the stalled round;
- **preemption**: a real SIGHUP, a snapshot, a simulated process death
  and a resume (the newest snapshot corrupted first: the resume
  quarantines it and falls back to the newest valid one);
- **dead worker**: a worker leaves the average from a seeded round;
- **NaN injection**: one worker's batch is NaN at a seeded round; the
  audit flags exactly that round and the in-round mask keeps the worker
  out of the average;
- **straggler injection**: one worker's assembly sleeps at a seeded
  round; the round profiler (``obs/profile.py``) must name exactly that
  worker;
- **cache corruption** and **cache cold**: the chunk cache's entry of a
  round's chunk is byte-flipped (quarantined and refetched identical) or
  the cache wiped (the read misses and refetches);
- **replica death**, **decode replica kill** and **published snapshot
  corrupt** against the serving fleet (``serve/fleet.py``): a replica is
  killed mid-traffic, a generation replica mid-stream (the resumed token
  sequence must equal an undisturbed run's), and a corrupt publish must
  never reach a canary;
- **slice preemption**: a real SIGTERM marks a slice leaving; it trains
  masked and rejoins through a consensus snapshot;
- **driver kill**: the journaled recover driver (``runtime/recover.py``)
  is crashed mid-commit and resumed to its control's digest;
- **slow slice**: a synchronous control against ``stale_bound=4``
  (``parallel/stale.py``) under a slice that runs slow for a few
  rounds: the stale leg pays no forced wait and names a slow member as
  the laggiest worker;
- **collector outage**: the fleet collector (``obs/fleet.py``) goes down
  for a span of rounds; this process's shipper (``obs/ship.py``) keeps
  training unblocked, buffers what it cannot push and replays it when
  the collector returns (0 events lost, 0 dropped).

``run_kill_sweep`` is the real-SIGKILL sweep over every kill point of
``python -m sparknet_tpu_torch.runtime.recover``, with its
``--no_journal`` and journal-off controls and the stale leg.

``run_chaos`` and ``run_kill_sweep`` take an explicit ``device``
(``"cuda"`` on the card, ``"cpu"`` in the tests).
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal as _signal
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sparknet_tpu_torch import obs as _obs
from sparknet_tpu_torch.obs import profile as _profile
from sparknet_tpu_torch.utils import retry as _retry

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic schedule of faults (the JAX plan, field
    for field).  Rounds are 0-indexed and absolute: a round replayed
    after a resume keeps its index, so a per-round fault fires once."""

    seed: int = 7
    workers: int = 4
    rounds: int = 6
    tau: int = 2
    batch: int = 8
    # round -> transient storage errors before that round's fetch succeeds
    storage_faults: Tuple[Tuple[int, int], ...] = ((1, 2), (4, 1))
    # rounds whose fetch stalls past the feed watchdog (once each)
    stall_rounds: Tuple[int, ...] = (0,)
    stall_s: float = 4.0
    stall_timeout_s: float = 1.0
    # SIGHUP preemption at the end of this round (None = none)
    preempt_round: Optional[int] = 3
    corrupt_newest: bool = True  # corrupt the newest snapshot before resume
    # this worker leaves the average from this round on
    dead_worker: Optional[int] = 2
    dead_from_round: int = 4
    snapshot_every: int = 2
    # these workers' batches are NaN at this round
    nan_round: Optional[int] = 2
    nan_workers: Tuple[int, ...] = (1,)
    # this worker's assembly sleeps straggler_s at this round
    straggler_round: Optional[int] = 1
    straggler_worker: int = 3
    straggler_s: float = 0.4
    # byte-flip the cache entry of this round's chunk before the read
    cache_corrupt_round: Optional[int] = 2
    # wipe the cache before this round's read
    cache_cold_round: Optional[int] = 5
    # the fleet collector goes down at the end of this round and comes
    # back collector_outage_rounds rounds later
    collector_outage_round: Optional[int] = 1
    collector_outage_rounds: int = 2
    # a serving replica is killed mid-traffic at the end of this round
    replica_death_round: Optional[int] = 4
    # a generation replica is killed with a stream in flight
    decode_replica_kill_round: Optional[int] = 4
    # a published snapshot is byte-flipped at the end of this round
    publish_corrupt_round: Optional[int] = 5
    # a SIGTERM marks slice slice_preempt_slice leaving at the end of
    # this round; it rejoins slice_relaunch_delta rounds later
    slice_preempt_round: Optional[int] = 2
    slice_preempt_slice: int = 0
    slice_relaunch_delta: int = 1
    membership_slices: int = 2
    cross_slice_every: int = 2
    # the journaled driver is crashed mid-commit at the end of this round
    driver_kill_round: Optional[int] = 5
    # a slice runs +slow_slice_s a round for slow_slice_rounds rounds:
    # the synchronous control against stale_bound slow_slice_stale_bound
    slow_slice_round: Optional[int] = 4
    slow_slice_slice: int = 1
    slow_slice_s: float = 0.5
    slow_slice_rounds: int = 3
    slow_slice_stale_bound: int = 4

    @classmethod
    def default(cls) -> "FaultPlan":
        return cls()

    def no_fault_view(self) -> "FaultPlan":
        """The same run shape with every fault removed (the baseline)."""
        return dataclasses.replace(
            self,
            storage_faults=(),
            stall_rounds=(),
            preempt_round=None,
            corrupt_newest=False,
            dead_worker=None,
            nan_round=None,
            straggler_round=None,
            cache_corrupt_round=None,
            cache_cold_round=None,
            collector_outage_round=None,
            replica_death_round=None,
            decode_replica_kill_round=None,
            publish_corrupt_round=None,
            slice_preempt_round=None,
            driver_kill_round=None,
            slow_slice_round=None,
        )


def storage_fault_hook(plan: FaultPlan, counters: Dict[str, int]):
    """A ``data/object_store.set_fault_hook`` injector: raises
    ``ConnectionResetError`` for the first N fetch attempts of each
    planned slot, the slots taken in call order; a slot retires on the
    call after its faults (that fetch succeeds), so slots never bleed
    into one fetch's retry loop."""
    remaining = {r: n for r, n in plan.storage_faults}
    order = sorted(remaining)
    slot = {"i": 0}

    def hook(url: str) -> None:
        if slot["i"] >= len(order):
            return None
        r = order[slot["i"]]
        if remaining[r] > 0:
            remaining[r] -= 1
            counters["storage_injected"] = counters.get("storage_injected", 0) + 1
            raise ConnectionResetError(
                f"chaos: injected storage fault (slot {r}) for {url}")
        slot["i"] += 1
        return None

    return hook


def chunk_name(r: int) -> str:
    """The chunk-store object name of round ``r``'s window."""
    return f"round_{r:04d}.npz"


def write_round_chunks(plan: FaultPlan, xs, ys, chunk_dir: str) -> None:
    """Every round's clean window (``_Feed``'s index math) as an npz
    chunk in a local store directory, the objects the chunk cache fronts
    in the chaos run.  Idempotent; files publish atomically."""
    import io as _io

    from sparknet_tpu_torch.data.chunk_cache import atomic_write_bytes

    os.makedirs(chunk_dir, exist_ok=True)
    W, tau, B, n = plan.workers, plan.tau, plan.batch, len(xs)
    for r in range(plan.rounds):
        path = os.path.join(chunk_dir, chunk_name(r))
        if os.path.exists(path):
            continue
        data = np.empty((W, tau) + xs[0].shape, np.float32)
        label = np.empty((W, tau, B), np.float32)
        for w in range(W):
            for t in range(tau):
                i = (r * W * tau + w * tau + t) % n
                data[w, t] = xs[i]
                label[w, t] = ys[i]
        buf = _io.BytesIO()
        np.savez(buf, data=data, label=label)
        atomic_write_bytes(path, buf.getvalue())


def corrupt_file(path: str, seed: int = 0) -> None:
    """Flip a run of bytes in the middle of ``path``, size unchanged
    (only a checksum catches it)."""
    size = os.path.getsize(path)
    rng = random.Random(seed)
    with open(path, "r+b") as f:
        off = max(0, size // 2 - 8)
        f.seek(off)
        orig = f.read(16)
        f.seek(off)
        f.write(bytes((b ^ 0xA5) for b in orig) or bytes([rng.randrange(256)]))


# the longest a collector outage waits for its first failed push
OUTAGE_BITE_TIMEOUT_S = 10.0


class _CollectorOutage:
    """The collector_outage fault: a live fleet collector and this
    process's shipper, with the collector taken down for a planned span
    of rounds.  ``on_round_end`` pauses and resumes it by absolute round
    (once each: a replayed round cannot trip it again); ``finalize``
    stops the shipper (its final flush) and judges survival: the
    collector missed pushes while down, yet ended with every enqueued
    event delivered (0 lost, 0 dropped) and some replayed after it came
    back.  The pause holds until a push has failed (at most
    ``OUTAGE_BITE_TIMEOUT_S``).  ``close`` puts back the ship hook a surrounding ``--ship_to``
    run had installed."""

    def __init__(self, plan: FaultPlan, counters: Dict, note):
        from sparknet_tpu_torch.obs import trace as _trace
        from sparknet_tpu_torch.obs.fleet import FleetCollector
        from sparknet_tpu_torch.obs.ship import Shipper

        self.plan = plan
        self.counters = counters
        self.note = note
        self.collector = FleetCollector(port=0).start()
        self.shipper = Shipper(self.collector.url, host="chaos-host",
                               interval_s=0.1).start()
        self._prev_ship = _trace._ship
        _obs.set_ship(self.shipper)
        self._down_at: Optional[int] = plan.collector_outage_round
        self._up_at = plan.collector_outage_round + plan.collector_outage_rounds
        self._received_at_pause: Optional[int] = None
        self.summary: Optional[Dict] = None

    def _host_state(self) -> Dict:
        return self.collector.fleet_view()["hosts"].get("chaos-host", {})

    def on_round_end(self, r: int) -> None:
        if self._down_at is not None and r == self._down_at:
            self._down_at = None
            self._received_at_pause = self._host_state().get(
                "received_events", 0)
            failures = self.shipper.push_failures_total
            self.collector.pause()
            self.counters["collector_outage_injected"] = 1
            _obs.fault("collector_outage", round=r,
                       down_rounds=self.plan.collector_outage_rounds)
            self.note("round %d: fleet collector DOWN for %d round(s) — "
                      "shipper must buffer and replay"
                      % (r, self.plan.collector_outage_rounds))
            # the outage lasts until a push has failed (bounded): rounds
            # on a card can outrun the shipper's flush interval, and an
            # outage no push met would test nothing
            deadline = time.monotonic() + OUTAGE_BITE_TIMEOUT_S
            while (self.shipper.push_failures_total == failures
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        elif self._up_at is not None and r >= self._up_at:
            self._up_at = None
            self.collector.resume()
            self.note(f"round {r}: fleet collector back up")

    def finalize(self) -> Dict:
        if self._up_at is not None:  # the run ended while it was down
            self._up_at = None
            self.collector.resume()
        failures = self.shipper.push_failures_total
        self.shipper.stop()  # the final flush ships the buffered tail
        st = self._host_state()
        received = st.get("received_events", 0)
        replayed = received - (self._received_at_pause or 0)
        lost = st.get("lost_events", 0)
        dropped = st.get("reported_dropped_total", 0)
        if (self.counters.get("collector_outage_injected")
                and failures > 0  # the outage really made pushes fail
                and lost == 0 and dropped == 0 and replayed > 0):
            self.counters["collector_outage_survived"] = 1
            self.note("collector outage survived: %d push failure(s) while "
                      "down, %d event(s) replayed after resume, 0 lost / 0 "
                      "dropped" % (failures, replayed))
            _obs.instant("recovered", kind="collector_outage",
                         replayed=replayed)
        self.summary = {
            "push_failures": failures,
            "events_replayed_after_resume": replayed,
            "events_received": received,
            "events_lost": lost,
            "events_dropped": dropped,
        }
        return self.summary

    def close(self) -> None:
        from sparknet_tpu_torch.obs import trace as _trace

        if _trace._ship is self.shipper:
            _obs.set_ship(self._prev_ship)
        if self.shipper.alive:
            self.shipper.stop()
        self.collector.close()


_SERVE_TOY_DEPLOY = """
name: "chaos_toy"
input: "data"
input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "logits" top: "prob" }
"""


class _ServeFaults:
    """The serving-fleet faults, run as bounded sub-scenarios at seeded
    round ends (once each, by absolute round): ``replica_death`` against
    a 2-replica toy-net fleet, ``decode_replica_kill`` against a
    2-replica generation fleet (a small TransformerLM under continuous
    batching) and ``published_snapshot_corrupt``, which publishes the
    chaos run's own state and corrupts it.  Both fleets are built on
    ``device`` at first use."""

    def __init__(self, plan: FaultPlan, counters: Dict, note, workdir: str,
                 device):
        self.plan = plan
        self.counters = counters
        self.note = note
        self.workdir = workdir
        self.device = device
        self._death_at = plan.replica_death_round
        self._corrupt_at = plan.publish_corrupt_round
        self._decode_kill_at = plan.decode_replica_kill_round
        self._pool = self._router = None
        self._gen_pool = self._gen_router = None
        self._x = np.random.RandomState(plan.seed).randn(1, 3, 8, 8).astype(
            np.float32)
        self.decode_tokens: Optional[Dict] = None

    def _fleet(self):
        if self._pool is None:
            from sparknet_tpu_torch import config as _cfg
            from sparknet_tpu_torch.serve import InferenceEngine, ReplicaPool, Router

            netp = _cfg.parse_net_prototxt(_SERVE_TOY_DEPLOY)

            def make_engine(weights=None, device=None):
                return InferenceEngine(netp, weights=weights, buckets=(1, 2),
                                       device=device)

            self._pool = ReplicaPool(make_engine, replicas=2, max_queue=32,
                                     devices=[self.device])
            self._router = Router(self._pool, max_inflight=16)
        return self._pool, self._router

    def _gen_fleet(self):
        if self._gen_pool is None:
            from sparknet_tpu_torch.models.transformer_lm import TransformerLM
            from sparknet_tpu_torch.serve import ReplicaPool, Router
            from sparknet_tpu_torch.serve.generate import GenerationEngine

            def make_engine(weights=None, device=None):
                lm = TransformerLM(dim=32, depth=2, heads=2, seq_len=64, vocab=64)
                return GenerationEngine(
                    lm, weights=weights, prefill_buckets=(16, 64),
                    max_streams=4, kv_blocks=48, kv_block_size=8,
                    seed=self.plan.seed, device=device)

            self._gen_pool = ReplicaPool(make_engine, replicas=2, max_queue=16,
                                         stream=True, devices=[self.device])
            self._gen_router = Router(self._gen_pool, max_inflight=16)
        return self._gen_pool, self._gen_router

    def on_round_end(self, r: int, solver, consensus_fn) -> None:
        if self._death_at is not None and r == self._death_at:
            self._death_at = None
            self._replica_death(r)
        if self._decode_kill_at is not None and r == self._decode_kill_at:
            self._decode_kill_at = None
            self._decode_replica_kill(r)
        if self._corrupt_at is not None and r == self._corrupt_at:
            self._corrupt_at = None
            self._publish_corrupt(r, solver, consensus_fn)

    def _replica_death(self, r: int) -> None:
        pool, router = self._fleet()
        router.submit(self._x)  # serving before the kill
        self.counters["replica_death_injected"] = 1
        _obs.fault("replica_death", round=r, replica=0)
        self.note(f"round {r}: serving replica 0 hard-killed mid-traffic")
        pool.replicas[0].kill()
        served = 0
        for _ in range(4):
            out = router.submit(self._x)  # eject-and-retry: no errors
            served += int(out.shape[0] == 1)
        ejected = pool.replicas[0].state == "ejected"
        pool.respawn(0)
        rejoined = pool.replicas[0].state == "live"
        router.submit(self._x)
        if served == 4 and ejected and rejoined:
            self.counters["replica_death_survived"] = 1
            self.note(f"round {r}: router ejected the dead replica, served "
                      "every request on the survivor, and the respawned "
                      "replica rejoined rotation")
            _obs.instant("recovered", kind="replica_death", round=r)

    def _decode_replica_kill(self, r: int) -> None:
        pool, router = self._gen_fleet()
        prompt = [5, 9, 2, 7]
        max_new = 40
        # greedy decode is deterministic: an undisturbed run on either
        # replica (the same seeded weights) is the expected sequence
        expect = list(router.submit_stream(prompt, max_new))[-1]
        self.counters["decode_kill_injected"] = 1
        _obs.fault("decode_replica_kill", round=r)
        gen = router.submit_stream(prompt, max_new, timeout=30.0)
        first = next(gen)  # admitted, first token delivered
        victim = None
        for rep in pool.replicas:
            if rep.batcher.active_count() > 0:
                victim = rep
                break
        self.note(f"round {r}: generation replica "
                  f"{victim.index if victim else '?'} hard-killed with a "
                  "token stream in flight")
        if victim is not None:
            victim.kill()
        events = [first] + list(gen)  # bounded by the timeout: never hangs
        final = events[-1]
        ejected = victim is not None and victim.state == "ejected"
        if victim is not None and ejected:
            pool.respawn(victim.index)
        # respawn replaces the Replica object: read it from the pool
        rejoined = (victim is not None
                    and pool.replicas[victim.index].state == "live")
        after = list(router.submit_stream(prompt, max_new))[-1]
        self.decode_tokens = {"expected": expect.get("tokens"),
                              "resumed": final.get("tokens"),
                              "after": after.get("tokens")}
        if (expect["event"] == "done" and final["event"] == "done"
                and final["tokens"] == expect["tokens"] and ejected
                and rejoined and after["event"] == "done"
                and after["tokens"] == expect["tokens"]):
            self.counters["decode_kill_survived"] = 1
            self.note(f"round {r}: stream resumed on the sibling via "
                      "re-prefill — token sequence identical to the "
                      "undisturbed run, dead replica respawned into rotation")
            _obs.instant("recovered", kind="decode_replica_kill", round=r)

    def _publish_corrupt(self, r: int, solver, consensus_fn) -> None:
        from sparknet_tpu_torch.serve import DeliveryController
        from sparknet_tpu_torch.serve import publish as publish_mod

        pub = os.path.join(self.workdir, "publish")
        # BINARYPROTO: the solver's default (HDF5) needs h5py
        paths = publish_mod.publish_snapshot(
            solver, consensus_fn(), pub,
            {"passing": True, "reason": "chaos seeded publish"},
            fmt="BINARYPROTO")
        corrupt_file(paths[0], seed=self.plan.seed)
        self.counters["publish_corrupt_injected"] = 1
        _obs.fault("published_snapshot_corrupt", round=r,
                   snapshot=os.path.basename(paths[0]))
        self.note(f"round {r}: published snapshot "
                  f"{os.path.basename(paths[0])} byte-flipped on disk")
        pool, router = self._fleet()
        ctl = DeliveryController(
            pool, router, pub,
            cache_dir=os.path.join(self.workdir, "delivery_cache"),
            decision_requests=2, echo=None)
        act = ctl.poll_once()
        quarantined = (ctl.last_decision or {}).get("quarantined", [])
        if (act == "rejected" and ctl.rejected == 1
                and router.canary is None  # it never reached a canary
                and any(q.endswith(".corrupt") for q in quarantined)):
            self.counters["publish_corrupt_survived"] = 1
            self.note(f"round {r}: delivery watcher rejected the corrupt "
                      "publish at CRC verify and quarantined it (never "
                      "canaried)")
            _obs.instant("recovered", kind="published_snapshot_corrupt", round=r)

    def close(self) -> None:
        if self._router is not None:
            self._router.close()
            self._router = self._pool = None
        if self._gen_router is not None:
            self._gen_router.close()
            self._gen_router = self._gen_pool = None


def _driver_kill_scenario(plan: FaultPlan, counters: Dict, note, workdir,
                          device):
    """The driver_kill fault: crash the journaled recover driver
    mid-commit (a raising kill, in process) and resume it to its
    uninterrupted control's digest, all three runs under deterministic
    algorithms (as the driver's own entry point runs);
    ``run_kill_sweep`` is the real-SIGKILL version."""
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    with deterministic_algorithms():
        return _driver_kill_runs(plan, counters, note, workdir, device)


def _driver_kill_runs(plan, counters, note, workdir, device):
    from sparknet_tpu_torch.runtime import recover as recover_mod

    base = os.path.join(workdir, "driver_kill")
    ctx = recover_mod.RecoverContext(base, workers=2, tau=1, batch=8,
                                     seed=plan.seed, device=device)
    kill_rounds = 3
    kill_at = ("journal_mid_append", 1)

    def boom():
        raise recover_mod.SimulatedKill("driver_kill")

    control = recover_mod.run_driver(ctx, kill_rounds,
                                     run_dir=os.path.join(base, "control"))
    counters["driver_kill_injected"] = 1
    _obs.fault("driver_kill", kill_at="%s:%d" % kill_at, rounds=kill_rounds)
    note("driver_kill: journaled driver crashed mid-commit-append at round "
         "%d (half a frame durable on disk)" % kill_at[1])
    fault_dir = os.path.join(base, "fault")
    crashed = False
    try:
        recover_mod.run_driver(ctx, kill_rounds, kill_at=kill_at, kill=boom,
                               run_dir=fault_dir)
    except recover_mod.SimulatedKill:
        crashed = True
    resumed = recover_mod.run_driver(ctx, kill_rounds, resume=True,
                                     run_dir=fault_dir)
    replayed = len([r for r in resumed["rounds_executed"] if r <= kill_at[1]])
    bit_identical = resumed["final_digest"] == control["final_digest"]
    survived = bool(crashed and resumed["journal_truncated_bytes"] > 0
                    and replayed <= 1 and bit_identical)
    if survived:
        counters["driver_kill_survived"] = 1
        note("driver_kill survived: torn tail truncated (%d bytes), resumed "
             "at round %d replaying %d round(s), final state digest "
             "bit-identical to the uninterrupted control"
             % (resumed["journal_truncated_bytes"], resumed["start_round"],
                replayed))
        _obs.instant("recovered", kind="driver_kill", replayed=replayed)
    return {
        "kill_at": "%s:%d" % kill_at,
        "crashed": crashed,
        "journal_truncated_bytes": resumed["journal_truncated_bytes"],
        "resumed_start_round": resumed["start_round"],
        "replayed_rounds": replayed,
        "bit_identical": bit_identical,
        "control_digest": control["final_digest"],
        "resumed_digest": resumed["final_digest"],
        "recovery_latency_s": resumed["restore_s"],
    }


def _slow_slice_scenario(plan: FaultPlan, counters: Dict, note, workdir,
                         device):
    """The slow_slice fault: one slice runs ``+slow_slice_s`` a round for
    ``slow_slice_rounds`` rounds.  The synchronous control waits for it
    at every boundary (the tail lands on the critical path); the stale
    leg (bound > the slow rounds) takes whoever arrived and folds the
    slice in after the tail, sleeping only when the bound forces a
    still-slow worker.  Survived: zero forced waits, most of the tail
    saved, a slow member named the laggiest worker every slow round, and
    the two final losses within the band."""
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
    from sparknet_tpu_torch.parallel.stale import (
        BoundedStalenessTrainer,
        stale_window,
    )
    from sparknet_tpu_torch.runtime import recover as recover_mod

    base = os.path.join(workdir, "slow_slice")
    ctx = recover_mod.RecoverContext(base, workers=plan.workers, tau=1,
                                     batch=plan.batch, seed=plan.seed,
                                     compress="none", device=device)
    spec = HierarchySpec.grouped(plan.workers, plan.membership_slices,
                                 cross_slice_every=plan.cross_slice_every)
    slow_members = tuple(spec.slices[plan.slow_slice_slice])
    K, slow_s = plan.slow_slice_rounds, plan.slow_slice_s
    B = plan.slow_slice_stale_bound
    rounds = max(6, K + 3)
    slow_rounds = set(range(1, 1 + K))

    counters["slow_slice_injected"] = 1
    _obs.fault("slow_slice", slice=plan.slow_slice_slice,
               workers=list(slow_members), tail_s=slow_s, rounds=K)
    note("slow_slice: slice %d (workers %s) +%.2fs/round for rounds %s — "
         "sync control vs stale_bound=%d A/B"
         % (plan.slow_slice_slice, list(slow_members), slow_s,
            sorted(slow_rounds), B))

    def place(host):
        return {k: torch.from_numpy(v).to(ctx.device) for k, v in host.items()}

    def leg(stale_bound: int) -> Dict:
        if stale_bound > 0:
            trainer = BoundedStalenessTrainer(ctx.solver, plan.workers,
                                              stale_bound=stale_bound,
                                              hierarchy=spec)
        else:
            trainer = ParameterAveragingTrainer(ctx.solver, plan.workers,
                                                hierarchy=spec)
        state = trainer.init_state(seed=ctx.seed)
        tail_paid_s = 0.0
        forced_waits = 0
        laggiest = []
        last_losses = None
        compute_s = []  # each round's wall minus its sleeps
        slept_s = 0.0
        for r in range(rounds):
            slow_now = r in slow_rounds
            slept_before = tail_paid_s
            t0 = time.perf_counter()
            if stale_bound > 0:
                arrived = np.ones((plan.workers,), bool)
                if slow_now:
                    arrived[list(slow_members)] = False
                    lag = trainer.lags(r)
                    if int(lag[list(slow_members)].max()) >= stale_bound:
                        # the bound forces a still-slow worker: the tail
                        # is back on the critical path
                        forced_waits += 1
                        tail_paid_s += slow_s
                        time.sleep(slow_s)
                out = trainer.round(
                    state, place(stale_window(ctx.batch_for,
                                              trainer.worker_rounds)),
                    arrived=arrived, round_index=r)
                if slow_now:
                    laggiest.append(int(np.argmax(trainer.lags(r + 1))))
            else:
                if slow_now:
                    # the synchronous boundary waits for the slow slice
                    tail_paid_s += slow_s
                    time.sleep(slow_s)
                out = trainer.round(state, place(ctx.batch_for(r)),
                                    round_index=r)
            state, losses = out[0], out[1].detach().cpu().numpy()
            if r > 0:  # round 0 carries the warm-up
                round_slept = tail_paid_s - slept_before
                compute_s.append(time.perf_counter() - t0 - round_slept)
                slept_s += round_slept
            last_losses = losses
        # one shared host can put a one-off spike on a single round: trim
        # each leg's worst compute round (both legs alike), add the
        # sleeps back exactly
        trimmed = sorted(compute_s)[:-1] if len(compute_s) > 1 else compute_s
        finite = last_losses[np.isfinite(last_losses)]
        return {
            "elapsed_s": round(sum(trimmed) + slept_s, 3),
            "tail_paid_s": round(tail_paid_s, 3),
            "forced_waits": forced_waits,
            "final_loss": round(float(np.mean(finite)), 4),
            "laggiest_by_slow_round": laggiest,
        }

    sync = leg(0)
    stale = leg(B)
    tail_injected_s = K * slow_s
    saved_s = sync["elapsed_s"] - stale["elapsed_s"]
    named_ok = bool(stale["laggiest_by_slow_round"]) and all(
        w in slow_members for w in stale["laggiest_by_slow_round"])
    band = max(0.5, 0.5 * abs(sync["final_loss"]))
    loss_band_ok = abs(stale["final_loss"] - sync["final_loss"]) <= band
    survived = bool(stale["forced_waits"] == 0
                    and sync["tail_paid_s"] >= tail_injected_s - 1e-9
                    and saved_s >= 0.6 * tail_injected_s
                    and named_ok and loss_band_ok)
    if survived:
        counters["slow_slice_survived"] = 1
        note("slow_slice survived: stale leg paid 0 forced waits and saved "
             "%.2fs of the %.2fs injected tail (sync control ate all of it); "
             "laggiest worker named in %s every slow round; final losses "
             "%.4f vs %.4f within band %.4f"
             % (saved_s, tail_injected_s, list(slow_members),
                stale["final_loss"], sync["final_loss"], band))
        _obs.instant("stale_absorbed_tail", kind="slow_slice",
                     saved_s=round(saved_s, 3))
    return {
        "slice": plan.slow_slice_slice,
        "workers": list(slow_members),
        "tail_s_per_round": slow_s,
        "slow_rounds": sorted(slow_rounds),
        "stale_bound": B,
        "rounds": rounds,
        "tail_injected_s": round(tail_injected_s, 3),
        "sync": sync,
        "stale": stale,
        "wallclock_saved_s": round(saved_s, 3),
        "straggler_named_ok": named_ok,
        "loss_band": round(band, 4),
        "loss_band_ok": loss_band_ok,
        "survived": survived,
    }


def run_kill_sweep(workdir: Optional[str] = None, rounds: int = 4,
                   kill_round: int = 2, workers: int = 2, tau: int = 2,
                   batch: int = 8, seed: int = 7,
                   kill_points: Optional[Tuple[str, ...]] = None,
                   timeout_s: float = 900.0, echo=None,
                   device: str = "cuda", stale: bool = True,
                   jobs: int = 1) -> Dict:
    """The kill-anywhere sweep: for every kill point of the journaled
    driver (``runtime/recover.py``) a subprocess is SIGKILLed at that
    point of round ``kill_round`` and relaunched with ``--resume``; the
    resumed digest must equal an uninterrupted control's, with at most
    one replayed round.  Two controls keep the proof honest: a
    ``--no_journal`` kill and resume must diverge, and a journal-off
    uninterrupted run must equal the control (the ledger never perturbs
    the math; its round walls are the overhead baseline).  The stale leg
    (``stale=True``) kills a ``--stale_bound 2`` driver at
    ``stale_boundary:kill_round`` and resumes it to the stale control,
    replaying at most the bound.  The children run on ``device``,
    ``jobs`` of them at a time (each kill before its resume)."""
    import json as _json
    import subprocess
    import sys as _sys

    from sparknet_tpu_torch.runtime import recover as recover_mod

    # stale_boundary exists on a --stale_bound > 0 driver only: the stale
    # leg below kills it under the right flags
    kill_points = tuple(kp for kp in (kill_points or recover_mod.KILL_POINTS)
                        if kp != "stale_boundary")
    workdir = workdir or tempfile.mkdtemp(prefix="recover_sweep_")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    base_args = ["--rounds", str(rounds), "--workers", str(workers),
                 "--tau", str(tau), "--batch", str(batch), "--seed", str(seed),
                 "--device", str(device)]

    def say(msg: str) -> None:
        if echo is not None:
            echo("recover: " + msg)

    def child(wd: str, *extra: str):
        cmd = ([_sys.executable, "-m", "sparknet_tpu_torch.runtime.recover",
                "--workdir", wd] + base_args + list(extra))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=timeout_s)
        rec = None
        if proc.returncode == 0:
            for line in reversed(proc.stdout.strip().splitlines()):
                line = line.strip()
                if line.startswith("{"):
                    rec = _json.loads(line)
                    break
            if rec is None:
                raise RuntimeError("recover child printed no JSON:\n%s\n%s"
                                   % (proc.stdout[-2000:], proc.stderr[-2000:]))
        elif proc.returncode != -_signal.SIGKILL:
            raise RuntimeError("recover child failed (rc %d):\n%s"
                               % (proc.returncode, proc.stderr[-4000:]))
        return proc.returncode, rec, time.perf_counter() - t0

    def kill_pair(wd: str, kill_at: str, *extra: str):
        rc1, _, _ = child(wd, *extra, "--kill_at", kill_at)
        rc2, rec, _ = child(wd, *extra, "--resume")
        return rc1, rc2, rec

    # every run below is independent of the others: ``jobs`` of them at
    # a time (each kill and its resume stay in order)
    from concurrent.futures import ThreadPoolExecutor

    stale_bound = 2
    stale_args = ("--stale_bound", str(stale_bound))
    with ThreadPoolExecutor(max_workers=max(1, int(jobs))) as ex:
        say("control run (journal on, no kill) and the journal-off control")
        f_control = ex.submit(child, os.path.join(workdir, "control"))
        f_nojournal = ex.submit(child, os.path.join(workdir, "nojournal_full"),
                                "--no_journal")
        f_points = [ex.submit(kill_pair, os.path.join(workdir, "kill_" + kp),
                              f"{kp}:{kill_round}") for kp in kill_points]
        # the same kill without the journal must diverge (a plain newest-
        # snapshot resume resets the residuals and per-worker momentum)
        f_nj = ex.submit(kill_pair, os.path.join(workdir, "nojournal_kill"),
                         f"average:{kill_round}", "--no_journal")
        if stale:
            f_stale_control = ex.submit(
                child, os.path.join(workdir, "stale_control"), *stale_args)
            f_stale = ex.submit(kill_pair,
                                os.path.join(workdir, "kill_stale_boundary"),
                                f"stale_boundary:{kill_round}", *stale_args)
        _, control, _ = f_control.result()
        _, nojournal_full, _ = f_nojournal.result()
        results = []
        for kp, fut in zip(kill_points, f_points):
            rc1, rc2, rec = fut.result()
            # rounds the killed run had executed: the kill fires before
            # the round for assemble/h2d, after it otherwise
            executed_before = kill_round + (0 if kp in ("assemble", "h2d") else 1)
            row = {
                "kill_at": f"{kp}:{kill_round}",
                "killed": rc1 == -_signal.SIGKILL,
                "resumed_rc": rc2,
                "bit_identical": bool(rec and rec["final_digest"]
                                      == control["final_digest"]),
                "replayed_rounds": (len([r for r in rec["rounds_executed"]
                                         if r < executed_before])
                                    if rec else None),
                "rounds_executed": rec["rounds_executed"] if rec else None,
                "recovery_latency_s": rec["restore_s"] if rec else None,
                "resumed_from": rec["resumed_from"] if rec else None,
                "start_round": rec["start_round"] if rec else None,
                "journal_truncated_bytes": (rec["journal_truncated_bytes"]
                                            if rec else None),
            }
            row["survived"] = bool(row["killed"] and rc2 == 0
                                   and row["bit_identical"]
                                   and row["replayed_rounds"] is not None
                                   and row["replayed_rounds"] <= 1)
            say("%s: %s (replayed %s, latency %ss)"
                % (row["kill_at"], "SURVIVED bit-identical" if row["survived"]
                   else "FAILED " + _json.dumps(row), row["replayed_rounds"],
                   row["recovery_latency_s"]))
            results.append(row)
        rc1, rc2, njrec = f_nj.result()
        no_journal_diverged = bool(rc1 == -_signal.SIGKILL and rc2 == 0
                                   and njrec and njrec["final_digest"]
                                   != control["final_digest"])
        say("no-journal resume %s the control"
            % ("diverged from" if no_journal_diverged
               else "unexpectedly matched"))
        stale_row = stale_control = None
        if stale:
            # resume must rewind to the journaled worker-round vector and
            # replay at most stale_bound rounds, bit for bit
            _, stale_control, _ = f_stale_control.result()
            rc1, rc2, srec = f_stale.result()
            stale_replayed = (len([r for r in srec["rounds_executed"]
                                   if r <= kill_round]) if srec else None)
            stale_row = {
                "kill_at": f"stale_boundary:{kill_round}",
                "stale_bound": stale_bound,
                "killed": rc1 == -_signal.SIGKILL,
                "resumed_rc": rc2,
                "bit_identical": bool(srec and srec["final_digest"]
                                      == stale_control["final_digest"]),
                "replayed_rounds": stale_replayed,
                "recovery_latency_s": srec["restore_s"] if srec else None,
                "start_round": srec["start_round"] if srec else None,
                "journal_truncated_bytes": (srec["journal_truncated_bytes"]
                                            if srec else None),
                "resumed_worker_rounds": ((srec.get("resume_info") or {})
                                          .get("worker_rounds")
                                          if srec else None),
                "final_worker_rounds": (srec.get("worker_rounds")
                                        if srec else None),
            }
            stale_row["survived"] = bool(stale_row["killed"] and rc2 == 0
                                         and stale_row["bit_identical"]
                                         and stale_replayed is not None
                                         and stale_replayed <= stale_bound)
            say("stale_boundary:%d %s (replayed %s <= bound %d, latency %ss)"
                % (kill_round, "SURVIVED bit-identical" if stale_row["survived"]
                   else "FAILED " + _json.dumps(stale_row),
                   stale_row["replayed_rounds"], stale_bound,
                   stale_row["recovery_latency_s"]))

    def p50(xs):
        s = sorted(xs)
        return s[len(s) // 2] if s else None

    # steady rounds only: round 0 carries the warm-up
    j_ms = p50(control["round_ms"][1:])
    nj_ms = p50(nojournal_full["round_ms"][1:])
    overhead_pct = 100.0 * (j_ms - nj_ms) / nj_ms if j_ms and nj_ms else None
    return {
        "rounds": rounds,
        "workers": workers,
        "tau": tau,
        "batch": batch,
        "seed": seed,
        "device": str(device),
        "kill_round": kill_round,
        "killpoints_total": len(results),
        "killpoints_survived": sum(1 for r in results if r["survived"]),
        "killpoints": results,
        "bit_identical_all": all(r["bit_identical"] for r in results),
        "max_replayed_rounds": max((r["replayed_rounds"] for r in results
                                    if r["replayed_rounds"] is not None),
                                   default=None),
        "control_digest": control["final_digest"],
        "control_round_ms": control["round_ms"],
        "stale": stale_row,
        "stale_control_digest": (stale_control["final_digest"]
                                 if stale_control else None),
        "no_journal_diverged": no_journal_diverged,
        "no_journal_digest": njrec["final_digest"] if njrec else None,
        "journal_bit_neutral": bool(nojournal_full["final_digest"]
                                    == control["final_digest"]),
        "journal_round_ms_p50": round(j_ms, 2) if j_ms else None,
        "nojournal_round_ms_p50": round(nj_ms, 2) if nj_ms else None,
        "journal_overhead_pct": (round(overhead_pct, 2)
                                 if overhead_pct is not None else None),
        "workdir": workdir,
    }


# ----------------------------------------------------------------------
# the chaos training run


class _Feed:
    """The per-round window builder behind a pipelined ``RoundFeed``
    (assembly and the copy to ``device`` on the producer thread, as the
    apps run it), with the plan's storage faults (healed by retry),
    stalls (past the watchdog), NaN and straggler injections and, with a
    ``chunk_source`` ``(store, cache)``, the windows read as npz chunks
    through the chunk cache (the cache faults' target)."""

    def __init__(self, plan: FaultPlan, xs, ys, counters, events, device,
                 fault_state=None, chunk_source=None):
        self.plan = plan
        self.xs, self.ys = xs, ys
        self.counters = counters
        self.events = events
        self.device = torch.device(device)
        self._store, self._cache = chunk_source or (None, None)
        # shared across feed rebuilds: a resume replays rounds by
        # absolute index and a per-round fault fires once
        fault_state = fault_state if fault_state is not None else {}
        fault_state.setdefault("faults", {r: n for r, n in plan.storage_faults})
        fault_state.setdefault("stalls", set(plan.stall_rounds))
        fault_state.setdefault(
            "nans", set() if plan.nan_round is None else {plan.nan_round})
        fault_state.setdefault(
            "stragglers",
            set() if plan.straggler_round is None else {plan.straggler_round})
        fault_state.setdefault(
            "cache_corrupts", set() if plan.cache_corrupt_round is None
            else {plan.cache_corrupt_round})
        fault_state.setdefault(
            "cache_colds", set() if plan.cache_cold_round is None
            else {plan.cache_cold_round})
        self._faults = fault_state["faults"]
        self._stalls = fault_state["stalls"]
        self._nans = fault_state["nans"]
        self._stragglers = fault_state["stragglers"]
        self._cache_corrupts = fault_state["cache_corrupts"]
        self._cache_colds = fault_state["cache_colds"]
        self._rf = None
        self._policy = _retry.RetryPolicy(max_attempts=6, base_s=0.005,
                                          cap_s=0.02, budget_s=2.0)

    def _bump(self, key: str) -> None:
        self.counters[key] = self.counters.get(key, 0) + 1

    def _chunk_arrays(self, r: int):
        """Round ``r``'s clean window read through the chunk cache, the
        seeded cache faults applied first.  The corruption counts as
        survived when the entry was quarantined, refetched, and the bytes
        equal a direct store read."""
        import io as _io

        name = chunk_name(r)
        if r in self._cache_corrupts:
            self._cache_corrupts.discard(r)
            # publish the entry, then flip bytes in it (size unchanged:
            # only the entry's CRC32 catches it)
            self._cache.get(self._store, name)
            entry = self._cache.entry_path(self._store.url, name)
            corrupt_file(entry, seed=self.plan.seed)
            self._bump("cache_corrupt_injected")
            self.events.append(f"round {r}: cache entry for {name} "
                               "byte-flipped on disk")
            _obs.fault("cache_corruption", round=r, chunk=name)
            q_before = self._cache.stats["quarantined"]
            blob = self._cache.get(self._store, name)
            direct = self._store.read(name)
            if self._cache.stats["quarantined"] == q_before + 1 and blob == direct:
                self._bump("cache_corrupt_survived")
                self.events.append(f"round {r}: cache quarantined the corrupt "
                                   "entry (*.corrupt) and refetched "
                                   "byte-identical data")
                _obs.instant("recovered", kind="cache_corruption", round=r)
        elif r in self._cache_colds:
            self._cache_colds.discard(r)
            dropped = self._cache.clear()
            self._bump("cache_cold_injected")
            self.events.append(f"round {r}: cache wiped cold ({dropped} "
                               "entries dropped)")
            _obs.fault("cache_cold", round=r, entries_dropped=dropped)
            m_before = self._cache.stats["misses"]
            blob = self._cache.get(self._store, name)
            if self._cache.stats["misses"] == m_before + 1:
                self._bump("cache_cold_survived")
                self.events.append(f"round {r}: cold read missed and "
                                   "refetched from the backing store")
                _obs.instant("recovered", kind="cache_cold", round=r)
        else:
            blob = self._cache.get(self._store, name)
        with np.load(_io.BytesIO(blob)) as z:
            return z["data"], z["label"]

    def _build(self, r: int):
        W, tau, B = self.plan.workers, self.plan.tau, self.plan.batch
        n = len(self.xs)
        src = self._chunk_arrays(r) if self._cache is not None else None
        straggle = None
        if r in self._stragglers:
            # the planned worker's assembly sleeps; the per-worker timing
            # below attributes it and the profiler must name this worker
            self._stragglers.discard(r)
            straggle = self.plan.straggler_worker
            self._bump("straggler_injected")
            self.events.append("round %d: worker %d straggles %.2fs in assembly"
                               % (r, straggle, self.plan.straggler_s))
            _obs.fault("straggler_injection", round=r, worker=straggle,
                       straggler_s=self.plan.straggler_s)
        data = np.empty((W, tau) + self.xs[0].shape, np.float32)
        label = np.empty((W, tau, B), np.float32)
        worker_s = []
        for w in range(W):
            t0 = time.perf_counter()
            if straggle == w:
                time.sleep(self.plan.straggler_s)
            if src is not None:
                data[w] = src[0][w]
                label[w] = src[1][w]
            else:
                for t in range(tau):
                    i = (r * W * tau + w * tau + t) % n
                    data[w, t] = self.xs[i]
                    label[w, t] = self.ys[i]
            worker_s.append(time.perf_counter() - t0)
        _profile.note_worker_phase(r, "assemble", worker_s)
        if r in self._nans:
            self._nans.discard(r)
            for w in self.plan.nan_workers:
                data[w] = np.nan
            self._bump("nan_injected")
            self.events.append("round %d: NaN injected into worker(s) %s batch"
                               % (r, list(self.plan.nan_workers)))
            _obs.fault("nan_injection", round=r,
                       workers=list(self.plan.nan_workers))
        return {"data": data, "label": label}

    def _produce_round(self, r: int):
        def attempt():
            if self._faults.get(r, 0) > 0:
                self._faults[r] -= 1
                self.counters["storage_injected"] += 1
                _obs.fault("storage", round=r)
                raise ConnectionResetError(f"chaos: storage fault in round {r} fetch")
            if r in self._stalls:
                self._stalls.discard(r)
                self.counters["stalls_injected"] += 1
                self.events.append(f"round {r}: producer stalled {self.plan.stall_s}s")
                _obs.fault("stall", round=r, stall_s=self.plan.stall_s)
                time.sleep(self.plan.stall_s)
            return self._build(r)

        injected_before = self.counters["storage_injected"]
        out = _retry.retry_call(attempt, policy=self._policy,
                                rng=random.Random(self.plan.seed * 1000 + r))
        healed = self.counters["storage_injected"] - injected_before
        if healed:
            self.counters["storage_survived"] += healed
            self.events.append(f"round {r}: retry layer healed {healed} "
                               "storage fault(s)")
            _obs.instant("recovered", kind="storage", round=r, healed=healed)
        return out

    def _spawn(self, start_r: int):
        from sparknet_tpu_torch.data.round_feed import RoundFeed

        self._rf = RoundFeed(self._produce_round, self.device,
                             stall_timeout_s=self.plan.stall_timeout_s,
                             start_round=start_r)

    def next_round(self, r: int):
        """Round ``r``'s (workers, tau, ...) batch on the device, through
        stalls (the feed restarts from ``r``).  A stall counts as
        survived once its round is delivered."""
        from sparknet_tpu_torch.data.round_feed import PrefetchStall

        if self._rf is None:
            self._spawn(r)
        while True:
            try:
                out = self._rf.next_round(r)
                break
            except PrefetchStall:
                exited = self._rf.restart(r)
                self._bump("watchdog_fires")
                self.events.append("round %d: watchdog fired; round feed "
                                   "stopped (thread exited: %s); rebuilding"
                                   % (r, exited))
        if r in self.plan.stall_rounds and r not in self._stalls:
            if self.counters["stalls_survived"] < self.counters["stalls_injected"]:
                self.counters["stalls_survived"] += 1
        return out

    def close(self):
        if self._rf is not None:
            self._rf.stop()
            self._rf = None


_FAULT_KINDS = {
    "storage": ("storage_injected", "storage_survived"),
    "stall": ("stalls_injected", "stalls_survived"),
    "preemption": ("preempt_injected", "preempt_survived"),
    "snapshot_corruption": ("corruption_injected", "corruption_survived"),
    "dead_worker": ("dead_worker_injected", "dead_worker_survived"),
    "nan_injection": ("nan_injected", "nan_survived"),
    "straggler_injection": ("straggler_injected", "straggler_survived"),
    "cache_corruption": ("cache_corrupt_injected", "cache_corrupt_survived"),
    "cache_cold": ("cache_cold_injected", "cache_cold_survived"),
    "collector_outage": ("collector_outage_injected",
                         "collector_outage_survived"),
    "replica_death": ("replica_death_injected", "replica_death_survived"),
    "decode_replica_kill": ("decode_kill_injected", "decode_kill_survived"),
    "published_snapshot_corrupt": ("publish_corrupt_injected",
                                   "publish_corrupt_survived"),
    "slice_preemption": ("slice_preempt_injected", "slice_preempt_survived"),
    "driver_kill": ("driver_kill_injected", "driver_kill_survived"),
    "slow_slice": ("slow_slice_injected", "slow_slice_survived"),
}


def run_chaos(plan: Optional[FaultPlan] = None, workdir: Optional[str] = None,
              verbose: bool = False, device: str = "cuda") -> Dict:
    """Run the chaos scenario on ``device``; returns the report.

    One cifar10_quick ``ParameterAveragingTrainer`` (W = ``plan.workers``
    stacked, the two-tier spec), the no-fault baseline first (same data,
    same seed), then the faulted run: train, faults, SIGHUP preemption,
    snapshot, simulated death, corrupt newest snapshot, verified resume
    with fallback, survivor-masked rounds, the final loss against the
    baseline's band."""
    from sparknet_tpu_torch import config as cfg, models
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.data import chunk_cache as _chunk_cache
    from sparknet_tpu_torch.data import object_store as _object_store
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer, first_worker
    from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
    from sparknet_tpu_torch.runtime import membership as membership_mod
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import resolve_device
    from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction

    plan = plan or FaultPlan.default()
    device = resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_")
    os.makedirs(workdir, exist_ok=True)

    events: List[str] = []

    def note(msg: str) -> None:
        events.append(msg)
        if verbose:
            print(f"chaos: {msg}")

    data_dir = os.path.join(workdir, "data")
    if not os.path.isdir(data_dir):
        CifarLoader.write_synthetic(data_dir, num_train=512, num_test=64,
                                    seed=plan.seed)
    xs, ys = CifarLoader(data_dir).minibatches(plan.batch, train=True)

    # each round's clean window is an npz chunk in a local store, read
    # through the chunk cache every round (both legs)
    chunk_dir = os.path.join(workdir, "chunk_store")
    write_round_chunks(plan, xs, ys, chunk_dir)
    chunk_source = (
        _object_store.LocalStore("file://" + chunk_dir),
        _chunk_cache.ChunkCache(os.path.join(workdir, "chunk_cache")),
    )

    netp = cfg.replace_data_layers(
        models.load_model("cifar10_quick"),
        [(plan.batch, 3, 32, 32), (plan.batch,)],
        [(plan.batch, 3, 32, 32), (plan.batch,)])
    # the NaN fault exercises the audit and the in-round mask
    audit = plan.nan_round is not None
    solver = Solver(models.load_model_solver("cifar10_quick"), net_param=netp,
                    audit=audit, device=device)
    # the slice preemption runs the whole scenario on the two-tier
    # schedule (both legs, so the loss comparison stays like for like)
    spec = membership_ctl = None
    if plan.slice_preempt_round is not None:
        spec = HierarchySpec.grouped(plan.workers, plan.membership_slices,
                                     plan.cross_slice_every)
        membership_ctl = membership_mod.MembershipController(spec, echo=note)
    trainer = ParameterAveragingTrainer(solver, plan.workers, hierarchy=spec)
    sentry = None
    if audit:
        from sparknet_tpu_torch.obs.health import HealthSentry

        sentry = HealthSentry(policy="warn", echo=note)

    def final_round_loss(losses) -> float:
        return float(losses.double().mean())

    # ---------------- baseline: the same run shape, no faults
    base_plan = plan.no_fault_view()
    base_counters = {"storage_injected": 0, "storage_survived": 0,
                     "stalls_injected": 0, "stalls_survived": 0}
    feed = _Feed(base_plan, xs, ys, base_counters, events, device,
                 chunk_source=chunk_source)
    state = trainer.init_state(seed=plan.seed)
    losses = None
    try:
        for r in range(plan.rounds):
            out = trainer.round(state, feed.next_round(r), round_index=r)
            state, losses = out[0], out[1]
    finally:
        feed.close()
    baseline_loss = final_round_loss(losses)
    note(f"baseline (no faults): final-round loss {baseline_loss:.4f}")
    # the report's cache stats are the faulted run's own
    cache_stats_before = dict(chunk_source[1].stats)

    # ---------------- the faulted run
    counters = {"storage_injected": 0, "storage_survived": 0,
                "stalls_injected": 0, "stalls_survived": 0}
    fault_state: Dict = {}
    feed = _Feed(plan, xs, ys, counters, events, device, fault_state,
                 chunk_source=chunk_source)
    prefix = os.path.join(workdir, "chaos_ckpt")
    trainer.reset_comm_state()
    state = trainer.init_state(seed=plan.seed)
    losses = None
    preempted_at: Optional[int] = None
    last_mask: Dict = {"m": None}  # the combined mask the round used

    def consensus():
        if membership_ctl is not None:
            # a departed slice's slots can hold stale params between
            # cross rounds: the first live worker's replica
            return membership_mod.consensus_state(
                state, last_mask["m"] if last_mask["m"] is not None
                else np.ones((plan.workers,), np.float32))
        return first_worker(state)

    def take_snapshot(r: int):
        paths = checkpoint.snapshot(solver, consensus(), prefix,
                                    fmt="BINARYPROTO")
        note(f"round {r}: snapshot -> {os.path.basename(paths[1])}")
        return paths

    def live_mask_for(r: int):
        if plan.dead_worker is None or r < plan.dead_from_round:
            return None
        mask = np.ones((plan.workers,), np.float32)
        mask[plan.dead_worker] = 0.0
        return mask

    def run_round(fd: _Feed, r: int) -> None:
        """One round of the faulted run (before the preemption and in the
        post-resume replay alike)."""
        nonlocal state, losses
        mask = live_mask_for(r)
        if mask is not None and r == plan.dead_from_round:
            counters["dead_worker_injected"] = 1
            _obs.fault("dead_worker", round=r, worker=plan.dead_worker)
            note(f"round {r}: dp worker {plan.dead_worker} died; averaging "
                 "over survivors")
        if membership_ctl is not None:
            # the view advances at the round boundary
            mview = membership_ctl.advance(r)
            if membership_ctl.pending_joiners():
                joiners = membership_ctl.pending_joiners()
                combined = mview.live_mask()
                if mask is not None:
                    combined = combined * mask
                state, _ = membership_mod.readmit(
                    trainer, solver, state, prefix, membership_ctl, r,
                    live_mask=combined, snapshot_fmt="BINARYPROTO", echo=note)
                counters.setdefault("slice_rejoin_round", r)
                _obs.instant("recovered", kind="slice_preemption", round=r,
                             workers=list(joiners))
                mview = membership_ctl.view
            mmask = membership_ctl.live_mask()
            mask = mmask if mask is None else mmask * mask
            if (counters.get("slice_preempt_injected")
                    and "slice_leave_round" not in counters
                    and any(s != membership_mod.LIVE for s in mview.states)):
                counters["slice_leave_round"] = r
            sw = spec.slices[plan.slice_preempt_slice]
            if all(mask[w] == 0.0 for w in sw):
                # a set: a replay revisits rounds by absolute index
                counters.setdefault("slice_masked_rounds", set()).add(r)
        last_mask["m"] = mask
        batches = fd.next_round(r)
        out = trainer.round(state, batches, live_mask=mask, round_index=r)
        state, losses = out[0], out[1]
        if sentry is not None:
            verdict = sentry.observe(r, losses, out[2])
            if verdict.nonfinite_total > 0:
                counters.setdefault("nan_detected_round", r)
            if r == plan.nan_round and counters.get("nan_injected"):
                # flagged at exactly the seeded round, the poisoned
                # worker(s) masked out of the average
                if (verdict.nonfinite_total > 0
                        and verdict.masked_workers == sorted(plan.nan_workers)
                        and sentry.last_anomaly_round == plan.nan_round):
                    counters["nan_survived"] = 1
                    note(f"round {r}: sentry flagged + masked poisoned "
                         f"worker(s) {verdict.masked_workers}; average "
                         "stayed healthy")
        if (profiler is not None and r == plan.straggler_round
                and counters.get("straggler_injected")
                # a replay of this round has no sleep: keep the first verdict
                and "straggler_detected_worker" not in counters):
            rec = profiler.last()
            w = (rec or {}).get("worker")
            counters["straggler_detected_worker"] = w["worst_worker"] if w else None
            counters["straggler_detected_round"] = rec["round"] if rec else None
            if (rec is not None and rec["round"] == r and w is not None
                    and w["straggler"]
                    and w["worst_worker"] == plan.straggler_worker):
                counters["straggler_survived"] = 1
                note("round %d: profiler attributed the slow round to worker "
                     "%d (skew %.2f) — straggler verdict exact"
                     % (r, w["worst_worker"], w["skew"]))
        if serve_faults is not None:
            serve_faults.on_round_end(r, solver, consensus)
        if outage is not None:
            outage.on_round_end(r)
        if (plan.driver_kill_round is not None and r == plan.driver_kill_round
                and not counters.get("driver_kill_injected")):
            counters["driver_kill_summary"] = _driver_kill_scenario(
                plan, counters, note, workdir, device)
        if (plan.slow_slice_round is not None and r == plan.slow_slice_round
                and not counters.get("slow_slice_injected")):
            counters["slow_slice_summary"] = _slow_slice_scenario(
                plan, counters, note, workdir, device)
        if membership_ctl is not None:
            if (r == plan.slice_preempt_round
                    and not counters.get("slice_preempt_injected")):
                # a real SIGTERM: the preemption notice for the slice
                counters["slice_preempt_injected"] = 1
                sw = list(spec.slices[plan.slice_preempt_slice])
                _obs.fault("slice_preemption", round=r,
                           slice=plan.slice_preempt_slice, workers=sw)
                note(f"round {r}: SIGTERM preemption notice for slice "
                     f"{plan.slice_preempt_slice} (workers {sw})")
                os.kill(os.getpid(), _signal.SIGTERM)
            if (counters.get("slice_preempt_injected")
                    and r == plan.slice_preempt_round + plan.slice_relaunch_delta
                    and not counters.get("slice_relaunched")):
                counters["slice_relaunched"] = 1
                membership_ctl.note_join(spec.slices[plan.slice_preempt_slice])
                note(f"round {r}: slice {plan.slice_preempt_slice} relaunched "
                     "— rejoin requested")

    # the round profiler attributes the seeded straggler (the faulted run
    # only; the baseline ran unprofiled)
    profiler = None
    if plan.straggler_round is not None:
        profiler = _profile.install(_profile.RoundProfiler())
    serve_faults = None
    if (plan.replica_death_round is not None
            or plan.decode_replica_kill_round is not None
            or plan.publish_corrupt_round is not None):
        serve_faults = _ServeFaults(plan, counters, note, workdir, device)
    # collector_outage: the fleet collector and shipper live for the
    # faulted run only (the baseline ran unshipped)
    outage = None
    if plan.collector_outage_round is not None:
        outage = _CollectorOutage(plan, counters, note)
    t_preempt = None
    if membership_ctl is not None:
        membership_ctl.sigterm_marks(plan.slice_preempt_slice)
    resumed_from_iter = None
    quarantined: List[str] = []
    recovery_latency_s = None
    try:
        with SignalHandler(sigint_effect=SolverAction.NONE,
                           sighup_effect=SolverAction.SNAPSHOT,
                           sigterm_hooks=membership_ctl is not None) as handler:
            for r in range(plan.rounds):
                run_round(feed, r)
                snapped = (r + 1) % plan.snapshot_every == 0
                if snapped:
                    take_snapshot(r)
                if plan.preempt_round is not None and r == plan.preempt_round:
                    # a real signal: the preemption notice as SIGHUP
                    os.kill(os.getpid(), _signal.SIGHUP)
                    if handler.get_action() == SolverAction.SNAPSHOT and not snapped:
                        take_snapshot(r)
                    counters["preempt_injected"] = 1
                    t_preempt = time.perf_counter()
                    preempted_at = r
                    _obs.fault("preemption", round=r)
                    note(f"round {r}: SIGHUP preemption — simulated process "
                         "death")
                    break
        feed.close()

        if preempted_at is not None:
            # the simulated restart: live state is gone, files survive
            state = None
            if plan.corrupt_newest:
                newest = checkpoint.find_snapshots(prefix)[-1]
                corrupt_file(newest, seed=plan.seed)
                counters["corruption_injected"] = 1
                _obs.fault("snapshot_corruption",
                           snapshot=os.path.basename(newest))
                note(f"corrupted newest snapshot {os.path.basename(newest)}")
            st, used = checkpoint.restore_newest_valid(solver, prefix)
            resumed_from_iter = int(st.iter)
            quarantined = [os.path.basename(p) for p in sorted(os.listdir(workdir))
                           if p.endswith(".corrupt")]
            if plan.corrupt_newest:
                if quarantined and used != newest:
                    counters["corruption_survived"] = 1
                note(f"resume fell back to {os.path.basename(used)} "
                     f"(quarantined: {quarantined})")
            state = trainer.broadcast_state(st)
            recovery_latency_s = time.perf_counter() - t_preempt
            counters["preempt_survived"] = 1
            _obs.instant("recovered", kind="preemption",
                         latency_s=round(recovery_latency_s, 3),
                         resumed_iter=resumed_from_iter)
            start_round = resumed_from_iter // plan.tau
            note("resumed at round %d (iter %d) in %.2fs; replaying %d round(s)"
                 % (start_round, resumed_from_iter, recovery_latency_s,
                    preempted_at + 1 - start_round))
            feed = _Feed(plan, xs, ys, counters, events, device, fault_state,
                         chunk_source=chunk_source)
            for r in range(start_round, plan.rounds):
                run_round(feed, r)
            feed.close()
    finally:
        feed.close()
        if membership_ctl is not None:
            membership_ctl.detach()
        if profiler is not None:
            _profile.uninstall(profiler)
        if serve_faults is not None:
            serve_faults.close()
        if outage is not None:
            try:
                outage.finalize()
            finally:
                outage.close()

    final_loss = final_round_loss(losses)
    if counters.get("dead_worker_injected") and np.isfinite(final_loss):
        counters["dead_worker_survived"] = 1
    if counters.get("slice_preempt_injected") and membership_ctl is not None:
        # left at exactly the boundary after the notice, masked every
        # round it was gone, epochs monotonic, the roster live again
        leave_r = counters.get("slice_leave_round")
        rejoin_r = counters.get("slice_rejoin_round")
        masked = set(counters.get("slice_masked_rounds", []))
        gone = (set(range(leave_r, rejoin_r))
                if leave_r is not None and rejoin_r is not None else None)
        if (leave_r == plan.slice_preempt_round + 1 and gone is not None
                and gone <= masked and membership_ctl.epochs_monotonic()
                and all(s == membership_mod.LIVE
                        for s in membership_ctl.view.states)
                and np.isfinite(final_loss)):
            counters["slice_preempt_survived"] = 1
            note("slice preemption survived: left at round %d, masked rounds "
                 "%s, rejoined at round %d, final epoch %d"
                 % (leave_r, sorted(masked), rejoin_r, membership_ctl.epoch))

    loss_band = max(0.25, 0.25 * abs(baseline_loss))
    loss_band_ok = bool(abs(final_loss - baseline_loss) <= loss_band)
    note(f"final-round loss {final_loss:.4f} vs baseline {baseline_loss:.4f} "
         f"(band +/-{loss_band:.3f}: {'OK' if loss_band_ok else 'OUT OF BAND'})")

    faults = {kind: {"injected": int(counters.get(ik, 0)),
                     "survived": int(counters.get(sk, 0))}
              for kind, (ik, sk) in _FAULT_KINDS.items()}
    return {
        "seed": plan.seed,
        "workers": plan.workers,
        "rounds": plan.rounds,
        "tau": plan.tau,
        "batch": plan.batch,
        "device": str(device),
        "faults_injected": sum(v["injected"] for v in faults.values()),
        "faults_survived": sum(v["survived"] for v in faults.values()),
        "faults": faults,
        "watchdog_fires": int(counters.get("watchdog_fires", 0)),
        "nan_round": plan.nan_round,
        "nan_detected_round": counters.get("nan_detected_round"),
        "straggler_round": plan.straggler_round,
        "straggler_worker": plan.straggler_worker,
        "straggler_detected_worker": counters.get("straggler_detected_worker"),
        "straggler_detected_round": counters.get("straggler_detected_round"),
        "cache_corrupt_round": plan.cache_corrupt_round,
        "cache_cold_round": plan.cache_cold_round,
        "collector_outage_round": plan.collector_outage_round,
        "collector_outage": outage.summary if outage is not None else None,
        "replica_death_round": plan.replica_death_round,
        "decode_replica_kill_round": plan.decode_replica_kill_round,
        "decode_tokens": serve_faults.decode_tokens if serve_faults else None,
        "publish_corrupt_round": plan.publish_corrupt_round,
        "driver_kill_round": plan.driver_kill_round,
        "driver_kill": counters.get("driver_kill_summary"),
        "slow_slice_round": plan.slow_slice_round,
        "slow_slice": counters.get("slow_slice_summary"),
        "slice_preempt_round": plan.slice_preempt_round,
        "slice_preempt_slice": plan.slice_preempt_slice,
        "slice_leave_round": counters.get("slice_leave_round"),
        "slice_rejoin_round": counters.get("slice_rejoin_round"),
        "slice_masked_rounds": sorted(counters.get("slice_masked_rounds", [])),
        "membership": (membership_ctl.state_dict()
                       if membership_ctl is not None else None),
        "cache_stats": {k: v - cache_stats_before.get(k, 0)
                        for k, v in chunk_source[1].stats.items()},
        "recovery_latency_s": (round(recovery_latency_s, 3)
                               if recovery_latency_s is not None else None),
        "resumed_from_iter": resumed_from_iter,
        "quarantined": quarantined,
        "final_loss": round(final_loss, 4),
        "baseline_final_loss": round(baseline_loss, 4),
        "loss_band": round(loss_band, 4),
        "loss_band_ok": loss_band_ok,
        "final_iter": plan.rounds * plan.tau,
        "events": events,
    }
