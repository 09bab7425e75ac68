"""The port's training health (``obs/health.py``, ``obs/flight.py``, the
solver's audit and the trainer's in-round worker mask) against the JAX
package's.

- ``audit_iteration`` on the same numpy trees, with inf, NaN and
  all-zero groups: counts equal, norms and ratios within 1e-6 relative.
- The sentry on one stats sequence (warmup, a spike at and above the
  threshold, cooldown, non-finite rounds, an absorbed masked worker):
  verdicts, z-scores, actions and ``export_state`` equal, and under
  ``rollback`` / ``halt`` the same rollbacks and the same halt.
- Flight bundles: each package's ``load_bundle`` reads the other's.
- The masked round: worker 1's batch poisoned with NaN in round 1 of 2,
  the port trainer against the JAX trainer (``tests/test_parallel.py``'s
  net, W=4, tau=2), in float64 at 1e-9 for ``none`` and ``int8`` and
  float32 at 1e-5 for ``bf16 --overlap_avg``: params, the ``masked``
  verdict, and the masked worker's zeroed history.
- Audit on against off in the port, bit for bit, and the overlapped
  plane taking the barriered apply in a masked round.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.obs import flight as jflight
from sparknet_tpu.obs import health as jhealth
from sparknet_tpu.parallel import (
    ParameterAveragingTrainer as JTrainer,
    make_mesh,
    shard_leading,
)
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import obs as tobs
from sparknet_tpu_torch.obs import flight as tflight
from sparknet_tpu_torch.obs import health as thealth
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map

from tests.test_parallel import NET, _data, _solver

W = 4


@pytest.fixture(autouse=True)
def _clean_state():
    from sparknet_tpu import obs as jobs

    jobs._reset_training_metrics_for_tests()
    tflight.uninstall()
    tobs.set_sentry(None)
    yield
    jobs._reset_training_metrics_for_tests()
    tflight.uninstall()
    tobs.set_sentry(None)


# ----------------------------------------------------------------------
# the audit
# ----------------------------------------------------------------------
def _trees(case, seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"conv1": [(4, 3), (4,)], "fc": [(5, 4), (5,)]}
    params = {k: [rs.randn(*s).astype(np.float32) for s in v]
              for k, v in shapes.items()}
    grads = {k: [rs.randn(*s).astype(np.float32) for s in v]
             for k, v in shapes.items()}
    new = {k: [p - 0.1 * g for p, g in zip(params[k], grads[k])]
           for k in shapes}
    loss = np.float32(1.25)
    if case == "inf":
        grads["fc"][0][1, 2] = np.inf
        new["fc"][0][1, 2] = -np.inf
    elif case == "nan":
        grads["conv1"][1][:] = np.nan
        new["conv1"][1][0] = np.nan
        loss = np.float32(np.nan)
    elif case == "zeros":
        for t in grads["fc"] + params["fc"] + new["fc"]:
            t[:] = 0.0
    gnorm = np.float32(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                                   for v in grads.values() for g in v)))
    return grads, params, new, loss, gnorm


@pytest.mark.parametrize("case", ["plain", "inf", "nan", "zeros"])
def test_audit_iteration_matches_jax(case):
    grads, params, new, loss, gnorm = _trees(case)
    tj = lambda tr: {k: [jnp.asarray(x) for x in v] for k, v in tr.items()}
    tt = lambda tr: {k: [torch.from_numpy(x.copy()) for x in v]
                     for k, v in tr.items()}
    want = jax.device_get(jhealth.audit_iteration(
        tj(grads), tj(params), tj(new), jnp.asarray(loss), jnp.asarray(gnorm)))
    got = thealth.audit_iteration(tt(grads), tt(params), tt(new),
                                  torch.tensor(loss), torch.tensor(gnorm))
    for k in ("nonfinite_grads", "nonfinite_params", "nonfinite_loss"):
        assert got[k].dtype == torch.int32
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]),
                               rtol=1e-6)
    for k in ("param_norm", "update_ratio"):
        assert set(got[k]) == set(want[k])
        for g in want[k]:
            w, t = float(want[k][g]), float(got[k][g])
            if np.isnan(w):
                assert np.isnan(t)
            else:
                np.testing.assert_allclose(t, w, rtol=1e-6, atol=1e-30)
    if case == "zeros":
        assert float(got["update_ratio"]["fc"]) == 0.0


def test_nonfinite_count_of_an_empty_tree():
    assert int(thealth.nonfinite_count({})) == 0


@pytest.mark.parametrize("layout", ["large", "mixed", "all_nan", "split",
                                    "bf16"])
def test_nonfinite_count_matches_jax(layout, monkeypatch):
    """Leaves at and above the in-place size are marked where they lie,
    smaller ones gathered, and each piece of marks counted by an L0
    norm: the count equals the JAX package's either way (NaN, +inf and
    -inf, a leaf that is NaN throughout, pieces cut small, a bf16
    leaf)."""
    rs = np.random.RandomState(5)
    n = thealth._IN_PLACE_NUMEL
    if layout == "split":
        monkeypatch.setattr(thealth, "_EXACT_COUNT", 1000)
    big = rs.randn(n + 3).astype(np.float32)
    small = rs.randn(7, 5).astype(np.float32)
    if layout == "all_nan":
        big[:] = np.nan
    else:
        big[rs.choice(n + 3, 40, replace=False)] = [np.nan, np.inf,
                                                    -np.inf, np.nan] * 10
        small[2, 3], small[6, 0] = np.inf, np.nan
    tree = ({"fc": [big]} if layout == "large"
            else {"conv": [small], "fc": [big, small[0]]})
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if layout == "bf16"
                else (jnp.float32, torch.float32))
    want = int(jhealth.nonfinite_count(
        {k: [jnp.asarray(x, jdt) for x in v] for k, v in tree.items()}))
    got = thealth.nonfinite_count(
        {k: [torch.from_numpy(x.copy()).to(tdt) for x in v]
         for k, v in tree.items()})
    assert got.dtype == torch.int32
    assert int(got) == want


def test_audit_grad_norm_without_clipping_matches_jax():
    """With ClipGradients off the audit's grad norm is one multi-tensor
    pass; it equals the JAX solver's sum of squares within 1e-6."""
    grads, *_ = _trees("plain")
    want = jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(g)))
                        for v in grads.values() for g in v))
    got = thealth.grad_norm({k: [torch.from_numpy(x.copy()) for x in v]
                             for k, v in grads.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ----------------------------------------------------------------------
# the sentry against the JAX sentry
# ----------------------------------------------------------------------
def _stats(tau=2, workers=None, nonfinite_grads=0, masked=None, gn=1.0):
    full = (() if workers is None else (workers,)) + (tau,)
    s = {
        "grad_norm": np.full(full, gn, np.float32),
        "nonfinite_grads": np.zeros(full, np.int32),
        "nonfinite_params": np.zeros(full, np.int32),
        "nonfinite_loss": np.zeros(full, np.int32),
        "param_norm": {"conv1": np.full(full, 3.0, np.float32)},
        "update_ratio": {"conv1": np.full(full, 0.01, np.float32)},
    }
    if workers is not None:
        s["nonfinite_grads"][-1] = nonfinite_grads
        if masked is not None:
            s["masked"] = np.asarray(masked, np.float32)
    else:
        s["nonfinite_grads"][:] = nonfinite_grads
    return s


def _sequence():
    """(losses, stats) a round: warmup, steady, a spike exactly at the
    threshold's neighbourhood, a clear spike, cooldown, a non-finite
    round, a masked worker, recovery."""
    seq = []
    for r, l in enumerate([2.0, 1.9, 1.85, 1.8, 1.78, 1.75]):
        seq.append((np.asarray([l, l - 0.01]), _stats(gn=1.0 + r)))
    seq.append((np.asarray([4.5, 4.6]), _stats()))  # spike
    seq.append((np.asarray([9.0, 9.0]), _stats()))  # cooldown swallows
    seq.append((np.asarray([1.7, np.nan]), _stats(nonfinite_grads=3)))
    seq.append((np.asarray([[1.7, 1.6], [np.nan, np.nan]]),
                _stats(workers=2, nonfinite_grads=5, masked=[0.0, 1.0])))
    for l in (1.65, 1.6, 1.58, 1.57):
        seq.append((np.asarray([l, l]), _stats()))
    return seq


def _drive(sentry_cls, policy, restore):
    s = sentry_cls(policy=policy, restore_fn=restore)
    out = []
    for r, (losses, stats) in enumerate(_sequence()):
        v = s.observe(r, losses, stats)
        action = None
        if not v.ok:
            try:
                s._act(v, "STATE")
            except (jhealth.SentryHalt, thealth.SentryHalt) as e:
                action = ("halt", e.round_index)
        d = v.as_dict()
        out.append((d, action))
        if action is not None:
            break
    return s, out


@pytest.mark.parametrize("policy", ["warn", "rollback", "halt"])
def test_sentry_matches_jax(policy):
    restore = (lambda: ("RESTORED", "/x/s_iter_4.solverstate.npz"))
    js, jout = _drive(jhealth.HealthSentry, policy, restore)
    ts, tout = _drive(thealth.HealthSentry, policy, restore)
    assert len(tout) == len(jout)
    for (td, ta), (jd, ja) in zip(tout, jout):
        assert ta == ja
        for k in jd:
            if isinstance(jd[k], float) and np.isnan(jd[k]):
                assert np.isnan(td[k]), k
            else:
                assert td[k] == jd[k], (k, td[k], jd[k])
    assert ts.export_state() == js.export_state()
    assert ts.state_dict() == js.state_dict()
    assert (ts.rollbacks, ts.halted) == (js.rollbacks, js.halted)
    if policy == "rollback":
        assert ts.rollbacks == 2  # the spike and the non-finite round
    if policy == "halt":
        assert ts.halted and tout[-1][1] == ("halt", 6)


def test_sentry_state_round_trips():
    s = thealth.HealthSentry()
    for r, (losses, stats) in enumerate(_sequence()[:8]):
        s.observe(r, losses, stats)
    t = thealth.HealthSentry()
    t.load_state(s.export_state())
    assert t.export_state() == s.export_state()


def test_health_cli_args_match_jax():
    import argparse

    from sparknet_tpu import obs as jobs

    for argv in ([], ["--health"], ["--health", "rollback"],
                 ["--health_policy", "halt"], ["--flight_recorder"],
                 ["--flight_recorder", "b.json"]):
        jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
        jobs.add_cli_args(jp)
        tobs.add_cli_args(tp)
        ja, ta = jp.parse_args(argv), tp.parse_args(argv)
        for k in ("health", "health_policy", "flight_recorder"):
            assert getattr(ta, k) == getattr(ja, k)


# ----------------------------------------------------------------------
# flight bundles, both ways
# ----------------------------------------------------------------------
def test_flight_bundles_load_in_both_packages(tmp_path):
    from sparknet_tpu_torch.obs.trace import span

    rec = tflight.install(tflight.FlightRecorder(str(tmp_path / "t.json"),
                                                 capacity=8))
    with span("execute"):
        pass
    tobs.instant("health", cat="health", round=0)
    tflight.record_verdict({"round": 0, "action": "none"})
    tflight.record_verdict({"round": 0, "action": "warn"})  # replaces
    tflight.uninstall(rec)
    path = rec.dump("manual", extra={"why": "test"})
    jb = jflight.load_bundle(path)
    assert jb["reason"] == "manual" and jb["verdicts"] == [
        {"round": 0, "action": "warn"}]
    assert [e["name"] for e in jb["events"]] == ["execute", "health"]

    jrec = jflight.FlightRecorder(str(tmp_path / "j.json"))
    jrec.record_sample("loss", 1.5, round=3)
    tb = tflight.load_bundle(jrec.dump("sentry_halt"))
    assert tb["kind"] == "sparknet_flight_bundle" and tb["samples"][0]["round"] == 3
    (tmp_path / "bad.json").write_text('{"kind": "other"}')
    with pytest.raises(ValueError):
        tflight.load_bundle(str(tmp_path / "bad.json"))


def test_flight_install_chains_and_restores_hooks(tmp_path):
    import signal
    import sys

    prev_hook, prev_term = sys.excepthook, signal.getsignal(signal.SIGTERM)
    rec = tflight.install(tflight.FlightRecorder(str(tmp_path / "f.json")))
    assert sys.excepthook == rec._excepthook
    assert signal.getsignal(signal.SIGTERM) == rec._sigterm
    tflight.uninstall(rec)
    assert sys.excepthook is prev_hook
    assert signal.getsignal(signal.SIGTERM) == prev_term


# ----------------------------------------------------------------------
# the masked round against the JAX trainer
# ----------------------------------------------------------------------
def _tsolver(audit=True, clip=0.0):
    sp = tconfig.parse_solver_prototxt(
        f'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9 '
        f'clip_gradients: {clip}')
    return TSolver(sp, net_param=tconfig.parse_net_prototxt(NET), device="cpu",
                   audit=audit)


def _rounds(dtype, compress, overlap, poison=True):
    """Both trainers, 2 rounds from carried init, worker 1's batch NaN in
    round 1 (of 0, 1)."""
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jsolver = _solver()
    jsolver.audit = True
    jt = JTrainer(jsolver, mesh, compress=compress, overlap_avg=overlap)
    tsolver = _tsolver()
    tt = TTrainer(tsolver, W, compress=compress, overlap_avg=overlap)
    j0 = jt.init_state(seed=0)
    params = {k: [np.asarray(b[0]) for b in v] for k, v in j0.params.items()}
    tparams, tstats = interop.net_params_from_jax(params, tsolver.net)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    tparams = tree_map(lambda t: t.to(dtype), tparams)
    tstate = tt.broadcast_state(TrainState(
        tparams, tstats, _init_history(tsolver.method, tparams),
        torch.tensor(0)))
    jstate = jt.broadcast_state(jsolver.init_state(0)._replace(
        params={k: [jnp.asarray(np.asarray(b[0]), np_dtype) for b in v]
                for k, v in j0.params.items()},
        history=jax.tree_util.tree_map(
            lambda h: jnp.zeros(h.shape[1:], np_dtype), j0.history)))
    out = []
    for r in range(2):
        data = _data(W, 2, seed=10 + r)
        data = {k: v.astype(np_dtype) for k, v in data.items()}
        if poison and r == 1:
            data["x"][1] = np.nan
        jstate, jl, jst = jt.round(jstate, shard_leading(data, mesh))
        tstate, tl, tst = tt.round(
            tstate, {k: torch.from_numpy(v) for k, v in data.items()})
        out.append((jst, tst))
    return jt, tt, jstate, tstate, out


@pytest.mark.parametrize("compress,overlap,dtype,tol", [
    ("none", False, torch.float64, 1e-9),
    ("int8", False, torch.float64, 1e-9),
    ("bf16", True, torch.float32, 1e-5),
], ids=["none", "int8", "bf16_overlap"])
def test_masked_round_matches_jax(compress, overlap, dtype, tol):
    with jax.enable_x64(dtype == torch.float64):
        jt, tt, js, ts, out = _rounds(dtype, compress, overlap)
        jst, tst = out[1]
        np.testing.assert_array_equal(tst["masked"].numpy(),
                                      np.asarray(jst["masked"]))
        assert tst["masked"].tolist() == [0.0, 1.0, 0.0, 0.0]
        for got, want in zip(tree_leaves(ts.params),
                             jax.tree_util.tree_leaves(js.params)):
            assert got.dtype == dtype
            want = np.asarray(want)
            assert np.all(np.isfinite(got.numpy()))
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got.numpy() - want).max()) <= tol * scale
        # the masked worker rejoined with its momentum zeroed
        for h in tree_leaves(ts.history):
            assert not h[1].any() and h[0].any()
        if overlap:  # the masked round took the barriered apply (K10)
            assert not tt._comm.has_pending
        if compress != "none":  # K10's rejoin branch reset its residual
            assert all(not r[1].any() for r in tt._comm._resid)
        for k in ("nonfinite_grads", "nonfinite_params"):
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


def test_no_finite_worker_keeps_each_own_params():
    """Every worker poisoned: no survivor, each slot keeps its own
    (poisoned) params for the sentry to see, history untouched."""
    tt = TTrainer(_tsolver(), W)
    st = tt.init_state(0)
    data = {k: torch.from_numpy(v) for k, v in _data(W, 2, seed=3).items()}
    data["x"][:] = float("nan")
    st2, _, stats = tt.round(st, data)
    assert stats["masked"].tolist() == [1.0] * W
    assert all(torch.isnan(l).any() for l in tree_leaves(st2.params))


def test_audit_is_bit_neutral_in_the_port():
    """A trajectory with the audit on equals the one with it off bit for
    bit: fused round, int8 plane and a flat hierarchy spec."""
    from sparknet_tpu_torch.parallel import HierarchySpec

    for kw in ({}, {"compress": "int8"},
               {"hierarchy": HierarchySpec.flat(W)}):
        states = []
        for audit in (False, True):
            tt = TTrainer(_tsolver(audit), W, **kw)
            st = tt.init_state(0)
            for r in range(2):
                data = {k: torch.from_numpy(v)
                        for k, v in _data(W, 2, seed=20 + r).items()}
                st = tt.round(st, data)[0]
            states.append(st)
        for a, b in zip(tree_leaves(tuple(states[0])),
                        tree_leaves(tuple(states[1]))):
            assert torch.equal(a, b), kw


def test_audit_is_bit_neutral_with_clipping():
    """With ClipGradients on, the audit shares its grad norm: the
    clipped trajectory is the same bit for bit with the audit on or
    off, and the clip does bite."""
    states = []
    for audit, clip in ((False, 0.5), (True, 0.5), (False, 0.0)):
        tt = TTrainer(_tsolver(audit, clip), W)
        st = tt.init_state(0)
        for r in range(2):
            data = {k: torch.from_numpy(v)
                    for k, v in _data(W, 2, seed=30 + r).items()}
            st = tt.round(st, data)[0]
        states.append(tree_leaves(tuple(st)))
    assert all(torch.equal(a, b) for a, b in zip(states[0], states[1]))
    assert not all(torch.equal(a, b) for a, b in zip(states[0], states[2]))


def test_trainer_reads_the_solver_audit_each_round():
    """The trainer holds no copy of the audit switch: turned on after
    the trainer is built, the next round returns the stats and masks;
    turned off, it returns none."""
    solver = _tsolver(audit=False)
    tt = TTrainer(solver, W)
    st = tt.init_state(0)
    data = {k: torch.from_numpy(v) for k, v in _data(W, 2, seed=3).items()}
    assert len(tt.round(st, data)) == 2
    solver.audit = True
    data["x"][1] = float("nan")
    st2, _, stats = tt.round(st, data)
    assert stats["masked"].tolist() == [0.0, 1.0, 0.0, 0.0]
    assert all(torch.isfinite(l).all() for l in tree_leaves(st2.params))
    solver.audit = False
    assert len(tt.round(st, data)) == 2


def test_halt_and_rollback_on_the_trainer(tmp_path):
    """All workers poisoned: ``halt`` raises SentryHalt with a flight
    bundle on disk; ``rollback`` restores the newest snapshot and the
    run goes on with the next round's data."""
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.parallel import first_worker

    def poisoned():
        d = {k: torch.from_numpy(v) for k, v in _data(W, 2, seed=5).items()}
        d["x"][:] = float("nan")
        return d

    tsolver = _tsolver()
    tt = TTrainer(tsolver, W)
    st = tt.init_state(0)
    rec = tflight.install(tflight.FlightRecorder(str(tmp_path / "b.json")))
    sentry = thealth.HealthSentry(policy="halt")
    with pytest.raises(thealth.SentryHalt):
        sentry.guarded_round(tt, st, poisoned(), round_index=0)
    bundle = tflight.load_bundle(str(tmp_path / "b.json"))
    assert bundle["reason"] == "sentry_halt"
    assert bundle["verdicts"][-1]["action"] == "halt"
    tflight.uninstall(rec)

    prefix = str(tmp_path / "s")
    checkpoint.snapshot(tsolver, first_worker(st), prefix, fmt="BINARYPROTO")
    sentry = thealth.HealthSentry(
        policy="rollback",
        restore_fn=thealth.make_restore_fn(tsolver, prefix, trainer=tt))
    st2, _ = sentry.guarded_round(tt, st, poisoned(), round_index=0)
    assert sentry.rollbacks == 1
    for a, b in zip(tree_leaves(st2.params), tree_leaves(st.params)):
        assert torch.equal(a, b)
    good = {k: torch.from_numpy(v) for k, v in _data(W, 2, seed=6).items()}
    st3, _ = sentry.guarded_round(tt, st2, good, round_index=1)
    assert all(torch.isfinite(l).all() for l in tree_leaves(st3.params))
