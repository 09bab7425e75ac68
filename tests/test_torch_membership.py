"""The port's elastic membership (``runtime/membership.py``), two-tier
spec (``parallel/hierarchy.py``) and the trainer's two-tier round
against the JAX package's.

- One event script (preempt, late, dead, joins before and after the
  leave completes, a fleet view with a restarted host, a SIGTERM) through
  both controllers: the views, epochs, transitions and ``export_state``
  equal after every boundary.
- ``HierarchySpec`` and its CLI surface, flag for flag.
- A flat spec (one slice, or K=1) is bit-identical to no spec.
- The two-tier round (W=4, 2 slices, K=2, ``tests/test_parallel.py``'s
  net) against the JAX trainer in float64 at 1e-9, with and without a
  dead slice, and the trainer's own round counter against an explicit
  schedule; the tier counters.
- ``readmit_state`` / ``consensus_state`` / ``readmit`` on tensors.
"""

import argparse
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import (
    ParameterAveragingTrainer as JTrainer,
    make_mesh,
    shard_leading,
)
from sparknet_tpu.parallel import hierarchy as jhierarchy
from sparknet_tpu.runtime import membership as jmembership
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.parallel import HierarchySpec
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.parallel import hierarchy as thierarchy
from sparknet_tpu_torch.runtime import membership as tmembership
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils.signals import SignalHandler, SolverAction
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map

from tests.test_parallel import NET, _data, _solver

W = 4


# ----------------------------------------------------------------------
# the controller against the JAX controller
# ----------------------------------------------------------------------
def _script(c, r):
    """The events queued before boundary ``r``."""
    if r == 1:
        c.note_preempt(slice_index=0)
    elif r == 2:
        c.note_join([0])  # races its own leave: deferred
        c.note_late([3])
    elif r == 3:
        c.note_dead([3])
    elif r == 4:
        c.note_join([0, 1, 3])
    elif r == 5:
        c.ingest_fleet_view(
            {"hosts": {"a": {"state": "live", "boot_id": "b1"},
                       "b": {"state": "late", "boot_id": "c1"}}},
            {"a": [0, 1], "b": [2]})
    elif r == 6:
        c.ingest_fleet_view(
            {"hosts": {"a": {"state": "live", "boot_id": "b2"},
                       "b": {"state": "dead"}}},
            {"a": [0, 1], "b": [2]})
    elif r == 8:
        c.note_join([2])


def _walk(mod, spec):
    c = mod.MembershipController(spec)
    out = []
    for r in range(10):
        _script(c, r)
        v = c.advance(r)
        if c.pending_joiners() and r % 2 == 0:
            v = c.admit(r)
        out.append((v.epoch, v.round, tuple(v.states),
                    tuple(v.live_mask().tolist()), c.export_state(),
                    c.state_dict()))
    return c, out


def test_controller_matches_jax_on_one_event_script():
    jc, jout = _walk(jmembership, jhierarchy.HierarchySpec.grouped(W, 2, 2))
    tc, tout = _walk(tmembership, HierarchySpec.grouped(W, 2, 2))
    assert tout == jout
    assert tc.transitions == jc.transitions and tc.epochs_monotonic()
    kinds = {k for _, _, k, _ in tc.transitions}
    assert {"leave", "late", "death", "join_request", "rejoin"} <= kinds
    # load_state continues the clock in either package's controller
    jc2 = jmembership.MembershipController(jhierarchy.HierarchySpec.grouped(W, 2, 2))
    jc2.load_state(tc.export_state())
    assert jc2.export_state() == tc.export_state()
    with pytest.raises(ValueError, match="workers"):
        tmembership.MembershipController(HierarchySpec.flat(2)).load_state(
            tc.export_state())


def test_auto_rejoin_and_sigterm_hook():
    metrics = TrainingMetrics()
    c = tmembership.MembershipController(HierarchySpec.grouped(W, 2, 2),
                                         metrics=metrics)
    auto = tmembership.AutoRejoin(c, after=2)
    prev = signal.getsignal(signal.SIGTERM)
    c.sigterm_marks(1)
    epochs = []
    try:
        with SignalHandler(sigint_effect=SolverAction.NONE,
                           sighup_effect=SolverAction.NONE,
                           sigterm_hooks=True):
            for r in range(7):
                if r == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                c.advance(r)
                auto.on_round(r)
                if c.pending_joiners():
                    c.admit(r)
                epochs.append((c.epoch, c.view.states))
    finally:
        c.detach()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert epochs[1] == (1, ("live", "live", "leaving", "leaving"))
    assert epochs[2][1][2:] == ("dead", "dead")
    assert epochs[-1][1] == ("live",) * 4
    assert [k for _, _, k, _ in c.transitions] == [
        "leave", "death", "join_request", "rejoin"]
    assert metrics.membership_epoch.value == c.epoch == 4
    assert metrics.membership_workers.labels("live").value == 4
    assert metrics.membership_transitions.labels("rejoin").value == 2


# ----------------------------------------------------------------------
# the spec
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,s,k", [(4, 2, 2), (5, 3, 1), (4, 1, 3), (2, 4, 2)])
def test_spec_matches_jax(n, s, k):
    t, j = HierarchySpec.grouped(n, s, k), jhierarchy.HierarchySpec.grouped(n, s, k)
    assert t.slices == j.slices and t.slice_ids() == j.slice_ids()
    assert t.is_flat() == j.is_flat()
    assert [t.is_cross_round(r) for r in range(6)] == \
        [j.is_cross_round(r) for r in range(6)]
    assert [t.slice_of(w) for w in range(n)] == [j.slice_of(w) for w in range(n)]
    with pytest.raises(ValueError):
        HierarchySpec(3, ((0, 1), (1, 2)))
    with pytest.raises(ValueError):
        HierarchySpec(2, ((0, 1),), 0)


@pytest.mark.parametrize("argv", [[], ["--slices", "2"],
                                  ["--slices", "2", "--cross_slice_every", "3"],
                                  ["--elastic"], ["--elastic", "--rejoin_after", "0"]])
def test_cli_surface_matches_jax(argv):
    tp, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    thierarchy.add_cli_args(tp)
    jhierarchy.add_cli_args(jp)
    ta, ja = tp.parse_args(argv), jp.parse_args(argv)
    assert vars(ta) == vars(ja)
    ts, js = thierarchy.spec_from_args(ta, W), jhierarchy.spec_from_args(ja, W)
    assert (ts is None) == (js is None)
    if ts is not None:
        assert (ts.slices, ts.cross_slice_every) == \
            (js.slices, js.cross_slice_every)
    with pytest.raises(SystemExit, match="--stale_bound"):
        thierarchy.check_args(tp.parse_args(["--stale_bound", "1"]), "app")


# ----------------------------------------------------------------------
# the trainer's two-tier round
# ----------------------------------------------------------------------
def _tsolver(momentum=0.9):
    sp = tconfig.parse_solver_prototxt(
        f'base_lr: 0.05 lr_policy: "fixed" momentum: {momentum}')
    return TSolver(sp, net_param=tconfig.parse_net_prototxt(NET), device="cpu")


def _t_data(seed):
    return {k: torch.from_numpy(v) for k, v in _data(W, 2, seed=seed).items()}


def _trained(hier, rounds=3, round_idx=True, compress="none"):
    tt = TTrainer(_tsolver(), W, hierarchy=hier, compress=compress)
    st = tt.init_state(0)
    for r in range(rounds):
        st = tt.round(st, _t_data(30 + r),
                      round_index=r if round_idx else None)[0]
    return tt, st


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_flat_spec_bit_identical_to_no_spec(compress):
    _, ref = _trained(None, compress=compress)
    for hier in (HierarchySpec.flat(W), HierarchySpec.grouped(W, 2, 1)):
        _, st = _trained(hier, compress=compress)
        for a, b in zip(tree_leaves(tuple(ref)), tree_leaves(tuple(st))):
            assert torch.equal(a, b)


def test_auto_round_counter_matches_explicit():
    _, a = _trained(HierarchySpec.grouped(W, 2, 2))
    _, b = _trained(HierarchySpec.grouped(W, 2, 2), round_idx=False)
    for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
        assert torch.equal(x, y)


def _both64(masks, rounds=3):
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    spec_j = jhierarchy.HierarchySpec.grouped(W, 2, 2)
    jsolver = _solver(momentum=0.9)
    jt = JTrainer(jsolver, mesh, hierarchy=spec_j)
    tsolver = _tsolver()
    metrics = TrainingMetrics()
    tt = TTrainer(tsolver, W, hierarchy=HierarchySpec.grouped(W, 2, 2),
                  metrics=metrics)
    j0 = jt.init_state(seed=0)
    params = {k: [np.asarray(b[0]) for b in v] for k, v in j0.params.items()}
    tparams, tstats = interop.net_params_from_jax(params, tsolver.net)
    tparams = tree_map(lambda t: t.double(), tparams)
    ts = tt.broadcast_state(TrainState(
        tparams, tstats, _init_history(tsolver.method, tparams), torch.tensor(0)))
    js = jt.broadcast_state(jsolver.init_state(0)._replace(
        params={k: [jnp.asarray(np.asarray(b[0]), jnp.float64) for b in v]
                for k, v in j0.params.items()},
        history=jax.tree_util.tree_map(
            lambda h: jnp.zeros(h.shape[1:], jnp.float64), j0.history)))
    for r in range(rounds):
        data = {k: v.astype(np.float64) for k, v in _data(W, 2, seed=40 + r).items()}
        m = None if masks is None else masks[r]
        js, jl = jt.round(js, shard_leading(data, mesh), live_mask=m,
                          round_index=r)
        ts, tl = tt.round(ts, {k: torch.from_numpy(v) for k, v in data.items()},
                          live_mask=m, round_index=r)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9)
    return js, ts, metrics


@pytest.mark.parametrize("dead", [False, True], ids=["healthy", "dead_slice"])
def test_two_tier_round_matches_jax(dead):
    masks = None
    if dead:
        m = np.array([1, 1, 0, 0], np.float32)
        masks = [np.ones(W, np.float32), m, m]
    with jax.enable_x64(True):
        js, ts, metrics = _both64(masks)
        for got, want in zip(tree_leaves(ts.params),
                             jax.tree_util.tree_leaves(js.params)):
            want = np.asarray(want)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    leaf = tree_leaves(ts.params)[0]
    if dead:
        # round 2 is intra: the live slice averages, each worker of the
        # dead slice keeps its own params
        assert torch.equal(leaf[0], leaf[1])
        assert not torch.equal(leaf[2], leaf[3])
    assert metrics.hierarchy_rounds.labels("intra").value == 2
    assert metrics.hierarchy_rounds.labels("cross").value == 1
    assert metrics.hierarchy_bytes.labels("cross").value > 0


def test_intra_rounds_launch_no_comm_stage():
    """A two-tier int8 run: only the cross rounds reach the comm plane
    (its encode/apply stages), intra rounds are the slice mean."""
    tt = TTrainer(_tsolver(), W, hierarchy=HierarchySpec.grouped(W, 2, 2),
                  compress="int8")
    calls = []
    orig = tt._comm.round
    tt._comm.round = lambda *a, **k: calls.append(1) or orig(*a, **k)
    st = tt.init_state(0)
    for r in range(4):
        st = tt.round(st, _t_data(50 + r), round_index=r)[0]
    assert len(calls) == 2


# ----------------------------------------------------------------------
# readmission
# ----------------------------------------------------------------------
def test_readmit_state_merges_rejoiners_and_zeroes_momentum():
    tt = TTrainer(_tsolver(), W)
    st = tt.init_state(0)
    for r in range(2):
        st = tt.round(st, _t_data(60 + r))[0]
    restored = tmembership.consensus_state(st, [0, 0, 0, 1])
    before = tuple(tree_map(lambda x: x.clone(), f) for f in st)
    merged = tmembership.readmit_state(tt, st, restored, workers=[0, 1])
    for b, a, r_ in zip(tree_leaves(before[0]), tree_leaves(merged.params),
                        tree_leaves(restored.params)):
        assert torch.equal(a[0], r_) and torch.equal(a[1], r_)
        assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    for b, a in zip(tree_leaves(before[2]), tree_leaves(merged.history)):
        assert not a[0].any() and not a[1].any()
        assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_readmit_through_a_snapshot(tmp_path):
    c = tmembership.MembershipController(HierarchySpec.grouped(W, 2, 2))
    tsolver = _tsolver()
    tt = TTrainer(tsolver, W)
    st = tt.round(tt.init_state(0), _t_data(70))[0]
    c.note_dead([2, 3])
    c.advance(0)
    c.note_join([2, 3])
    c.advance(1)
    st2, view = tmembership.readmit(tt, tsolver, st, str(tmp_path / "s"), c, 1)
    assert view.states == ("live",) * 4 and view.epoch == 3
    for leaf in tree_leaves(st2.params):
        assert torch.equal(leaf[2], leaf[0])
    for h in tree_leaves(st2.history):
        assert not h[2].any() and h[0].any()
    assert tmembership.readmit(tt, tsolver, st2, str(tmp_path / "s"), c, 2) \
        == (st2, None)
