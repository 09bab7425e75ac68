"""The port's chaos harness (``runtime/chaos.py``) against the JAX
package's.

After ``tests/test_chaos.py``:

- the default ``FaultPlan`` equals the JAX plan field by field, and so
  does ``no_fault_view``;
- ``corrupt_file`` and the storage fault hook behave as the JAX ones
  on the same inputs (no bleed between slots);
- the feed delivers every round once, in order, across a watchdog
  rebuild;
- the chaos smoke (marked ``chaos``): the default plan less the
  ``collector_outage`` fault (not ported: it raises), on the CPU — every
  fault injected and survived, the NaN flagged at round 2, the
  straggler named at worker 3, round 1, the decode kill's resumed tokens
  equal to the undisturbed run's, the final loss in the baseline's band;
- ``run_kill_sweep`` on the CPU with one synchronous kill point, the two
  controls and the stale leg SIGKILLed at ``stale_boundary:1``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sparknet_tpu.runtime import chaos as jchaos
from sparknet_tpu_torch.runtime import chaos


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small nets: under the parallel test run's load one intra-op
    thread is faster than torch's default pool (as in
    ``tests/test_torch_db_apps.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_default_plan_equals_jax_field_by_field():
    t, j = chaos.FaultPlan.default(), jchaos.FaultPlan.default()
    tf = [f.name for f in dataclasses.fields(t)]
    assert tf == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.no_fault_view()) == \
        dataclasses.asdict(j.no_fault_view())


def test_no_fault_view_strips_every_fault():
    base = chaos.FaultPlan.default().no_fault_view()
    assert base.storage_faults == () and base.stall_rounds == ()
    assert base.preempt_round is None and not base.corrupt_newest
    for f in ("dead_worker", "nan_round", "straggler_round",
              "cache_corrupt_round", "cache_cold_round",
              "collector_outage_round", "replica_death_round",
              "decode_replica_kill_round", "publish_corrupt_round",
              "slice_preempt_round", "driver_kill_round", "slow_slice_round"):
        assert getattr(base, f) is None, f
    plan = chaos.FaultPlan.default()
    for f in ("seed", "workers", "rounds", "tau", "batch",
              "membership_slices", "cross_slice_every"):
        assert getattr(base, f) == getattr(plan, f)


def test_corrupt_file_flips_bytes_as_jax(tmp_path):
    payload = bytes(range(256)) * 64
    got = []
    for mod in (chaos, jchaos):
        p = str(tmp_path / f"{mod.__name__}.bin")
        with open(p, "wb") as f:
            f.write(payload)
        mod.corrupt_file(p, seed=3)
        got.append(open(p, "rb").read())
    assert got[0] == got[1]
    assert len(got[0]) == len(payload) and got[0] != payload


def _hook_trace(mod, faults, calls):
    plan = dataclasses.replace(mod.FaultPlan.default(), storage_faults=faults)
    counters = {}
    hook = mod.storage_fault_hook(plan, counters)
    out = []
    for url in calls:
        try:
            hook(url)
            out.append("ok")
        except ConnectionResetError:
            out.append("fault")
    return out, counters


@pytest.mark.parametrize("faults,calls,want", [
    (((0, 2),), ["a"] * 4, ["fault", "fault", "ok", "ok"]),
    (((0, 2), (4, 1)), ["a", "a", "a", "b", "b", "c"],
     ["fault", "fault", "ok", "fault", "ok", "ok"]),
], ids=["injects_then_heals", "slots_never_bleed"])
def test_storage_fault_hook_matches_jax(faults, calls, want):
    t = _hook_trace(chaos, faults, calls)
    assert t == _hook_trace(jchaos, faults, calls)
    assert t[0] == want
    assert t[1]["storage_injected"] == sum(n for _, n in faults)


def test_feed_delivers_rounds_in_order_across_watchdog_rebuild():
    plan = dataclasses.replace(
        chaos.FaultPlan.default(), workers=2, tau=1, batch=4, rounds=4,
        storage_faults=(), stall_rounds=(1,), stall_s=0.8, stall_timeout_s=0.2,
        preempt_round=None, corrupt_newest=False, dead_worker=None,
        nan_round=None, straggler_round=None)
    xs = [np.full((4, 3, 4, 4), i, np.float32) for i in range(8)]
    ys = [np.full((4,), float(i % 4), np.float32) for i in range(8)]
    counters = {"storage_injected": 0, "storage_survived": 0,
                "stalls_injected": 0, "stalls_survived": 0}
    feed = chaos._Feed(plan, xs, ys, counters, [], "cpu")
    try:
        for r in range(plan.rounds):
            data = feed.next_round(r)["data"]
            assert isinstance(data, torch.Tensor)
            for w in range(plan.workers):
                i = (r * plan.workers + w) % 8
                assert float(data[w, 0, 0, 0, 0, 0]) == float(i), (r, w)
    finally:
        feed.close()
    assert counters["stalls_injected"] == 1 and counters["stalls_survived"] == 1
    assert counters["watchdog_fires"] >= 1


def test_collector_outage_is_refused_before_anything_runs(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        chaos.run_chaos(workdir=str(tmp_path / "w"), device="cpu")
    assert not os.path.exists(str(tmp_path / "w"))


@pytest.mark.chaos
def test_chaos_smoke_default_plan(tmp_path):
    plan = dataclasses.replace(chaos.FaultPlan.default(),
                               collector_outage_round=None)
    rep = chaos.run_chaos(plan, workdir=str(tmp_path), device="cpu")
    assert rep["faults_injected"] > 0
    assert rep["faults_survived"] == rep["faults_injected"]
    for kind, v in rep["faults"].items():
        assert v["injected"] >= 1, kind
        assert v["survived"] == v["injected"], (kind, v)
    assert rep["resumed_from_iter"] is not None
    assert rep["resumed_from_iter"] < rep["final_iter"]
    assert any(".corrupt" in q for q in rep["quarantined"])
    assert 0 < rep["recovery_latency_s"] < 60
    assert rep["loss_band_ok"], (rep["final_loss"], rep["baseline_final_loss"])
    assert rep["nan_detected_round"] == plan.nan_round == 2
    assert rep["straggler_detected_worker"] == plan.straggler_worker == 3
    assert rep["straggler_detected_round"] == plan.straggler_round == 1
    dt = rep["decode_tokens"]
    assert dt["resumed"] == dt["expected"] == dt["after"] and dt["expected"]
    assert rep["cache_stats"]["quarantined"] >= 1
    cache_dir = os.path.join(str(tmp_path), "chunk_cache", "objects")
    assert any(f.endswith(".corrupt") for f in os.listdir(cache_dir))
    pub_dir = os.path.join(str(tmp_path), "publish")
    assert any(f.endswith(".corrupt") for f in os.listdir(pub_dir))
    assert rep["slice_leave_round"] == rep["slice_preempt_round"] + 1
    assert all(s == "live" for s in rep["membership"]["states"])
    dk = rep["driver_kill"]
    assert dk["crashed"] and dk["bit_identical"]
    assert dk["journal_truncated_bytes"] > 0 and dk["replayed_rounds"] <= 1
    ss = rep["slow_slice"]
    assert ss["survived"] and ss["stale"]["forced_waits"] == 0
    assert set(ss["stale"]["laggiest_by_slow_round"]) <= set(ss["workers"])


def test_kill_sweep_with_the_stale_leg(tmp_path, monkeypatch):
    # every recover process single-threaded (they run side by side)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rep = chaos.run_kill_sweep(workdir=str(tmp_path), rounds=3, kill_round=1,
                               kill_points=("execute",), device="cpu",
                               jobs=5)
    assert rep["killpoints_total"] == rep["killpoints_survived"] == 1
    assert rep["bit_identical_all"] and rep["max_replayed_rounds"] <= 1
    assert rep["no_journal_diverged"] and rep["journal_bit_neutral"]
    st = rep["stale"]
    assert st["survived"] and st["bit_identical"] and st["killed"]
    assert st["replayed_rounds"] <= st["stale_bound"]
    assert st["resumed_worker_rounds"] == [1, 0]
