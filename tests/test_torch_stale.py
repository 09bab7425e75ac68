"""The port's bounded-staleness averaging (``parallel/stale.py``)
against the JAX package's.

After ``tests/test_stale.py``, on the port's stacked trainer (toy net
of ``tests/test_parallel.py``, CPU tensors):

- ``B=0`` is the synchronous round bit for bit (flat, two-tier, audit);
- an absent worker's replica is bit-untouched and its losses read 0;
- the bound forces a live straggler, a dead worker is never forced, an
  all-absent boundary is skipped;
- full arrival at discount 1 is the synchronous mean (rtol 1e-5);
- arrivals coarsen to slices; intra and cross tiers alternate;
- the ledger, ``stale_window`` and the replicas round-trip;
- the sentry judges a stale arrival at its own round.

Parity: the same cifar10_quick solver, weights and arrival schedule
(worker 3 never arrives by itself, worker 1 misses boundary 1) through
both packages' ``BoundedStalenessTrainer`` over 4 boundaries in float64:
ledgers, weights and masks equal, params within 1e-5 relative to the
largest magnitude (they agree to ~1e-12).  The toy net's two-tier run is
held at 1e-9.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.obs.health import HealthSentry as JSentry
from sparknet_tpu.parallel import BoundedStalenessTrainer as JStale
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.parallel import stale_window as jstale_window
from sparknet_tpu.parallel.hierarchy import HierarchySpec as JSpec
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop, models
from sparknet_tpu_torch.obs.health import HealthSentry
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.parallel import HierarchySpec
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.parallel import hierarchy as thierarchy
from sparknet_tpu_torch.parallel.stale import (
    BoundedStalenessTrainer,
    export_worker_replicas,
    restore_worker_replicas,
    stale_window,
)
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map

from tests.test_parallel import NET, _solver

W = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small nets: under the parallel test run's load one intra-op
    thread is faster than torch's default pool (as in
    ``tests/test_torch_db_apps.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tsolver(audit=False):
    sp = tconfig.parse_solver_prototxt(
        'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9')
    return TSolver(sp, net_param=tconfig.parse_net_prototxt(NET), device="cpu",
                   audit=audit)


def _window(n, tau, r, batch=8, seed=0):
    rng = np.random.RandomState(seed * 1000 + r)
    return {
        "x": rng.randn(n, tau, batch, 6).astype(np.float32),
        "label": rng.randint(0, 4, (n, tau, batch)).astype(np.float32),
    }


def _t(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


def _leaves(state):
    return [x.clone() for x in tree_leaves(tuple(state))]


def _bitwise_equal(a, b):
    return all(torch.equal(x, y) or (torch.isnan(x).all() and torch.isnan(y).all())
               for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))))


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {"stale_bound": -1}, {"stale_bound": 2, "discount": 0.0},
    {"stale_bound": 2, "discount": 1.5}, {"stale_bound": 2, "compress": "int8"},
    {"stale_bound": 1, "overlap_avg": True},
])
def test_constructor_validation(kw):
    with pytest.raises(ValueError):
        BoundedStalenessTrainer(_tsolver(), 2, **kw)
    # the JAX constructor refuses the same
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    with pytest.raises(ValueError):
        JStale(_solver(), mesh, **kw)


def test_b0_composes_with_the_comm_plane():
    t = BoundedStalenessTrainer(_tsolver(), 2, stale_bound=0, compress="int8")
    assert t._comm is not None and t.stale_bound == 0


# ----------------------------------------------------------------------
# B = 0 is the synchronous round, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hier", [None, "two_tier"])
def test_b0_bit_identical_to_sync(hier):
    tau = 3
    spec = HierarchySpec.grouped(W, 2, cross_slice_every=2) if hier else None
    sync = TTrainer(_tsolver(), W, hierarchy=spec)
    stale = BoundedStalenessTrainer(_tsolver(), W, stale_bound=0, hierarchy=spec)
    s1, s2 = sync.init_state(0), stale.init_state(0)
    for r in range(3):
        w = _window(W, tau, r)
        s1, l1 = sync.round(s1, _t(w), round_index=r)
        s2, l2 = stale.round(s2, _t(w), round_index=r)
        assert torch.equal(l1, l2)
    assert _bitwise_equal(s1, s2)
    assert list(stale.worker_rounds) == [3] * W
    assert stale.last_boundary["tier"] == "sync"
    assert stale.last_boundary["forced"] == [False] * W


def test_b0_bit_identical_with_audit():
    n, tau = 2, 2
    sync = TTrainer(_tsolver(audit=True), n)
    stale = BoundedStalenessTrainer(_tsolver(audit=True), n, stale_bound=0)
    assert stale.solver.audit
    s1, s2 = sync.init_state(1), stale.init_state(1)
    w = _window(n, tau, 0, seed=1)
    s1, l1, a1 = sync.round(s1, _t(w), round_index=0)
    s2, l2, a2 = stale.round(s2, _t(w), round_index=0)
    assert torch.equal(l1, l2)
    assert _bitwise_equal(s1, s2)
    for x, y in zip(tree_leaves(a1), tree_leaves(a2)):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------
# partial-arrival boundaries
# ----------------------------------------------------------------------
def test_absent_worker_replica_untouched():
    tau, B = 2, 3
    t = BoundedStalenessTrainer(_tsolver(), W, stale_bound=B)
    st = t.init_state(0)
    before = _leaves(st)
    st, losses = t.round(st, _t(_window(W, tau, 0)),
                         arrived=np.array([True, True, True, False]),
                         round_index=0)
    after = _leaves(st)
    # worker 3's slot of every leaf (params, stats, history, iter)
    for b, a in zip(before, after):
        assert torch.equal(b[3], a[3])
    p_b, p_a = before[0], after[0]
    assert not torch.equal(p_b[0], p_a[0])
    assert torch.equal(p_a[0], p_a[1]) and torch.equal(p_a[0], p_a[2])
    assert torch.all(losses[3] == 0.0) and torch.all(losses[:3] != 0.0)
    lb = t.last_boundary
    assert lb["arrived"] == [True, True, True, False]
    assert lb["weights"][3] == 0.0
    assert list(t.worker_rounds) == [1, 1, 1, 0]


def test_bound_forces_live_straggler():
    n, tau, B = 2, 2, 2
    t = BoundedStalenessTrainer(_tsolver(), n, stale_bound=B)
    st = t.init_state(0)
    absent = np.array([True, False])
    for r in range(B):
        st, _ = t.round(st, _t(_window(n, tau, r)), arrived=absent,
                        round_index=r)
        assert t.last_boundary["forced"] == [False, False]
    st, _ = t.round(st, _t(_window(n, tau, B)), arrived=absent, round_index=B)
    lb = t.last_boundary
    assert lb["forced"] == [False, True]
    assert lb["arrived"] == [True, True]
    assert lb["weights"][1] == pytest.approx(t.discount ** B)
    assert list(t.worker_rounds) == [B + 1, 1]


def test_dead_worker_never_forced():
    n, tau = 2, 2
    t = BoundedStalenessTrainer(_tsolver(), n, stale_bound=1)
    st = t.init_state(0)
    live = np.array([1.0, 0.0])
    for r in range(3):
        st, _ = t.round(st, _t(_window(n, tau, r)), live_mask=live,
                        round_index=r)
        assert t.last_boundary["forced"] == [False, False]
        assert t.last_boundary["arrived"] == [True, False]
    assert list(t.worker_rounds) == [3, 0]
    assert list(t.lags(3)) == [0, 3]


def test_all_absent_boundary_skipped():
    n, tau = 2, 2
    metrics = TrainingMetrics()
    t = BoundedStalenessTrainer(_tsolver(), n, stale_bound=3, metrics=metrics)
    st = t.init_state(0)
    before = _leaves(st)
    st, losses = t.round(st, _t(_window(n, tau, 0)),
                         arrived=np.zeros(n, bool), round_index=0)
    assert t.last_boundary["skipped"]
    assert losses.shape == (n, tau) and torch.all(losses == 0.0)
    assert all(torch.equal(b, a) for b, a in zip(before, _leaves(st)))
    assert list(t.worker_rounds) == [0, 0]
    assert metrics.stale_boundaries_skipped.value == 1
    assert metrics.stale_skipped.labels("0").value == 1


def test_full_arrival_discount1_matches_sync_average():
    # equal unit weights: the weighted mean is the sync masked mean
    n, tau = 2, 2
    sync = TTrainer(_tsolver(), n)
    stale = BoundedStalenessTrainer(_tsolver(), n, stale_bound=2, discount=1.0)
    s1, s2 = sync.init_state(0), stale.init_state(0)
    w = _window(n, tau, 0)
    s1, _ = sync.round(s1, _t(w), round_index=0)
    s2, _ = stale.round(s2, _t(w), arrived=np.ones(n, bool), round_index=0)
    np.testing.assert_allclose(s1.params["ip2"][0].numpy(),
                               s2.params["ip2"][0].numpy(), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# slice coarsening (asymmetric hierarchy)
# ----------------------------------------------------------------------
def test_two_tier_arrivals_coarsen_to_slices():
    spec = HierarchySpec.grouped(W, 2, cross_slice_every=2)
    t = BoundedStalenessTrainer(_tsolver(), W, stale_bound=3, hierarchy=spec)
    st = t.init_state(0)
    st, _ = t.round(st, _t(_window(W, 2, 0)),
                    arrived=np.array([True, True, True, False]), round_index=0)
    assert t.last_boundary["arrived"] == [True, True, False, False]
    assert list(t.worker_rounds) == [1, 1, 0, 0]
    # a dead member does not hold its slice back
    st, _ = t.round(st, _t(_window(W, 2, 1)),
                    arrived=np.array([True, True, True, False]),
                    live_mask=np.array([1.0, 1.0, 1.0, 0.0]), round_index=1)
    assert t.last_boundary["arrived"] == [True, True, True, False]
    assert list(t.worker_rounds) == [2, 2, 1, 0]


def test_two_tier_intra_vs_cross_tier():
    spec = HierarchySpec.grouped(W, 2, cross_slice_every=2)
    metrics = TrainingMetrics()
    t = BoundedStalenessTrainer(_tsolver(), W, stale_bound=2, hierarchy=spec,
                                metrics=metrics)
    st = t.init_state(0)
    tiers = []
    for r in range(2):
        st, _ = t.round(st, _t(_window(W, 2, r)), arrived=np.ones(W, bool),
                        round_index=r)
        tiers.append(t.last_boundary["tier"])
        if r == 0:
            # intra: each slice adopts its own mean, the slices differ
            leaf = tree_leaves(st.params)[0]
            assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[2], leaf[3])
            assert not torch.equal(leaf[0], leaf[2])
    assert tiers == ["intra", "cross"]
    assert metrics.hierarchy_rounds.labels("intra").value == 1
    assert metrics.hierarchy_rounds.labels("cross").value == 1


# ----------------------------------------------------------------------
# ledger, mixed-round batches, replicas
# ----------------------------------------------------------------------
def test_stale_state_export_load_reset():
    n = 2
    t = BoundedStalenessTrainer(_tsolver(), n, stale_bound=2)
    st = t.init_state(0)
    st, _ = t.round(st, _t(_window(n, 2, 0)), arrived=np.array([True, False]),
                    round_index=0)
    frag = t.export_stale_state()
    assert int(frag["boundary"]) == 1
    assert list(frag["worker_rounds"]) == [1, 0]
    t2 = BoundedStalenessTrainer(_tsolver(), n, stale_bound=2)
    t2.load_stale_state(frag)
    assert t2._boundary == 1 and list(t2.worker_rounds) == [1, 0]
    with pytest.raises(ValueError):
        t2.load_stale_state({"worker_rounds": np.zeros(5, np.int64),
                             "boundary": 0})
    t2.reset_stale_state()
    assert t2._boundary == 0 and list(t2.worker_rounds) == [0, 0]
    assert t2.last_boundary is None


def test_stale_window_mixed_rounds_matches_jax():
    calls = []

    def window_fn(r):
        calls.append(r)
        base = np.full((3, 2, 4), float(r), np.float32)
        for w in range(3):
            base[w] += w * 10
        return {"x": base}

    out = stale_window(window_fn, [2, 0, 2])
    assert sorted(calls) == [0, 2]
    assert np.all(out["x"][0] == 2.0) and np.all(out["x"][1] == 10.0)
    assert np.all(out["x"][2] == 22.0)
    np.testing.assert_array_equal(out["x"],
                                  jstale_window(window_fn, [2, 0, 2])["x"])


def test_worker_replicas_roundtrip():
    n = 2
    t = BoundedStalenessTrainer(_tsolver(), n, stale_bound=2)
    st = t.init_state(0)
    st, _ = t.round(st, _t(_window(n, 2, 0)), arrived=np.array([True, False]),
                    round_index=0)
    frag = export_worker_replicas(st)
    st2 = restore_worker_replicas(t.init_state(9), frag)
    assert _bitwise_equal(st2, st)
    bad = {k: v[..., :1] for k, v in frag.items()}
    with pytest.raises(ValueError):
        restore_worker_replicas(t.init_state(9), bad)


def test_job_state_carries_ledger_and_replicas(tmp_path):
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.parallel import first_worker

    n = 2
    solver = _tsolver()
    t = BoundedStalenessTrainer(solver, n, stale_bound=2)
    st = t.init_state(0)
    st, _ = t.round(st, _t(_window(n, 2, 0)), arrived=np.array([True, False]),
                    round_index=0)
    prefix = str(tmp_path / "s")
    checkpoint.snapshot(solver, first_worker(st), prefix,
                        extra_state=t.export_job_state(st, {"round": 1}))
    t2 = BoundedStalenessTrainer(_tsolver(), n, stale_bound=2)
    st2, start, used, js = t2.resume_newest(prefix, 2)
    assert _bitwise_equal(st2, st)
    assert list(t2.worker_rounds) == [1, 0] and t2._boundary == 1


def test_cli_flags_build_the_stale_trainer():
    import argparse

    p = argparse.ArgumentParser()
    thierarchy.add_cli_args(p)
    a = p.parse_args(["--stale_bound", "2", "--stale_discount", "0.25"])
    assert thierarchy.stale_kwargs_from_args(a) == {"stale_bound": 2,
                                                    "discount": 0.25}
    t = thierarchy.averaging_trainer_from_args(a, _tsolver(), W)
    assert isinstance(t, BoundedStalenessTrainer)
    assert (t.stale_bound, t.discount) == (2, 0.25)
    b = p.parse_args([])
    assert thierarchy.stale_kwargs_from_args(b) == {}
    assert isinstance(thierarchy.averaging_trainer_from_args(b, _tsolver(), W),
                      TTrainer)


# ----------------------------------------------------------------------
# the sentry judges a stale arrival at its own round
# ----------------------------------------------------------------------
_WARM_CURVE = [5.0] * 5 + [1.0] * 7
_WARM_BOUNDARY = len(_WARM_CURVE)


def _warmed(cls, policy="warn", **kw):
    s = cls(policy=policy, z_threshold=4.0, warmup_rounds=2, ema_beta=0.5, **kw)
    for r, base in enumerate(_WARM_CURVE):
        s.observe(r, np.full((2, 3), base, np.float64), {},
                  arrived=[True, True], worker_rounds=[r, r])
        assert s.verdicts[-1].ok
    return s


@pytest.mark.parametrize("lag_loss,ok", [(5.0, True), (40.0, False)],
                         ids=["no_false_anomaly", "divergence_caught"])
def test_sentry_judges_stale_arrival_at_its_own_round(lag_loss, ok):
    losses = np.array([[1.0] * 3, [lag_loss] * 3])
    got = []
    for cls in (HealthSentry, JSentry):
        s = _warmed(cls)
        v = s.observe(_WARM_BOUNDARY, losses, {}, arrived=[True, True],
                      worker_rounds=[_WARM_BOUNDARY, 4])
        got.append(json.dumps(v.as_dict(), sort_keys=True))
        assert v.ok == ok
    assert got[0] == got[1]
    if ok:
        # the same numbers without staleness context spike (the naive
        # boundary mean against the settled EMA)
        v2 = _warmed(HealthSentry).observe(_WARM_BOUNDARY, losses, {})
        assert not v2.ok and "loss_spike" in v2.reasons


def test_sentry_rollback_policy_ignores_lagging_worker():
    calls = []

    def restore_fn():
        calls.append(1)
        raise AssertionError("rollback must not fire for a stale lag")

    s = _warmed(HealthSentry, "rollback", restore_fn=restore_fn)
    v = s.observe(_WARM_BOUNDARY, np.array([[1.0] * 3, [5.0] * 3]), {},
                  arrived=[True, True], worker_rounds=[_WARM_BOUNDARY, 4])
    assert v.ok and not calls


# ----------------------------------------------------------------------
# parity with the JAX BoundedStalenessTrainer
# ----------------------------------------------------------------------
def _arrivals(b):
    """Worker 3 never arrives by itself; worker 1 misses boundary 1."""
    arr = np.ones(W, bool)
    arr[3] = False
    if b == 1:
        arr[1] = False
    return arr


def _carried(jt, jsolver, tt, tsolver, np_dtype, dtype):
    j0 = jt.init_state(seed=0)
    params = {k: [np.asarray(b[0]) for b in v] for k, v in j0.params.items()}
    tparams, tstats = interop.net_params_from_jax(params, tsolver.net)
    tparams = tree_map(lambda t: t.to(dtype), tparams)
    ts = tt.broadcast_state(TrainState(
        tparams, tstats, _init_history(tsolver.method, tparams), torch.tensor(0)))
    js = jt.broadcast_state(jsolver.init_state(0)._replace(
        params={k: [jnp.asarray(np.asarray(b[0]), np_dtype) for b in v]
                for k, v in j0.params.items()},
        history=jax.tree_util.tree_map(
            lambda h: jnp.zeros(h.shape[1:], np_dtype), j0.history)))
    return js, ts


def _assert_close(ts, js, tol):
    for got, want in zip(tree_leaves(ts.params),
                         jax.tree_util.tree_leaves(js.params)):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= tol * scale


def test_cifar10_quick_stale_rounds_match_jax():
    batch, tau, B = 4, 2, 2
    netp_j = jconfig.replace_data_layers(
        jmodels.load_model("cifar10_quick"),
        [(batch, 3, 32, 32), (batch,)], [(batch, 3, 32, 32), (batch,)])
    netp_t = tconfig.replace_data_layers(
        models.load_model("cifar10_quick"),
        [(batch, 3, 32, 32), (batch,)], [(batch, 3, 32, 32), (batch,)])
    rng = np.random.RandomState(17)
    rounds = {r: {"data": rng.randn(W, tau, batch, 3, 32, 32),
                  "label": rng.randint(0, 10, (W, tau, batch)).astype(np.float64)}
              for r in range(5)}
    with jax.enable_x64(True):
        mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
        jsolver = JSolver(jmodels.load_model_solver("cifar10_quick"),
                          net_param=netp_j)
        jt = JStale(jsolver, mesh, stale_bound=B, discount=0.5)
        tsolver = TSolver(models.load_model_solver("cifar10_quick"),
                          net_param=netp_t, device="cpu")
        tt = BoundedStalenessTrainer(tsolver, W, stale_bound=B, discount=0.5)
        js, ts = _carried(jt, jsolver, tt, tsolver, np.float64, torch.float64)
        for b in range(4):
            assert list(tt.worker_rounds) == list(jt.worker_rounds)
            host = stale_window(lambda r: rounds[r], tt.worker_rounds)
            js, jl = jt.round(js, shard_leading(host, mesh),
                              arrived=_arrivals(b), round_index=b)
            ts, tl = tt.round(ts, _t(host), arrived=_arrivals(b), round_index=b)
            assert tt.last_boundary == jt.last_boundary
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9)
        assert list(tt.worker_rounds) == list(jt.worker_rounds)
        # worker 3 folded only where the bound forced it
        assert [int(v) for v in tt.worker_rounds] == [4, 3, 4, 2]
        _assert_close(ts, js, 1e-5)


def test_two_tier_stale_rounds_match_jax():
    tau = 2
    with jax.enable_x64(True):
        mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
        jsolver = _solver()
        jt = JStale(jsolver, mesh, stale_bound=2,
                    hierarchy=JSpec.grouped(W, 2, cross_slice_every=2))
        tsolver = _tsolver()
        tt = BoundedStalenessTrainer(tsolver, W, stale_bound=2,
                                     hierarchy=HierarchySpec.grouped(W, 2, 2))
        js, ts = _carried(jt, jsolver, tt, tsolver, np.float64, torch.float64)
        for b in range(4):
            w = {k: v.astype(np.float64) for k, v in _window(W, tau, b).items()}
            js, _ = jt.round(js, shard_leading(w, mesh), arrived=_arrivals(b),
                             round_index=b)
            ts, _ = tt.round(ts, _t(w), arrived=_arrivals(b), round_index=b)
            assert tt.last_boundary == jt.last_boundary
        _assert_close(ts, js, 1e-9)
