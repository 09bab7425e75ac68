"""The port's checkpoint layer against the JAX package's, on the CPU.

- A snapshot either package writes restores in the other: params, stat
  blobs, history in ``jax.tree_util`` order (SGD and ADAM) and ``iter``,
  equal bit for bit; the weight files are byte-equal.
- The port's copies of the JAX fault-tolerance cases: the CRC manifest,
  bit-flip, truncation, quarantine with fall-back, all-corrupt, a solver
  mismatch that quarantines nothing, a manifest-less truncated snapshot.
- Async snapshots equal sync ones; BINARYPROTO and HDF5 continue exactly
  (snapshot, restore in a fresh solver, continue == straight through).
- ``Solver.step`` / ``step_repeat`` against the JAX solver's ``step``.
- The LM: a snapshot round trip, and ``lm_app`` stopped after round 2
  and resumed ends bit-identical to an uninterrupted run, with and
  without ``--compress int8``; its consensus snapshot restores in JAX.
- The job-state pieces: comm residuals (restored before and after the
  plane's first round), per-worker momentum, the loss window.
"""

import json
import os
import signal

import numpy as np
import pytest
import jax
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import solver as jsolver
from sparknet_tpu.io import checkpoint as jck
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import solver as tsolver
from sparknet_tpu_torch.io import checkpoint as tck
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.utils.tree import tree_leaves

NET = """
name: "ft_net"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
  inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "logits"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""
SGD = 'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9'
ADAM = 'base_lr: 0.05 lr_policy: "fixed" type: "ADAM"'


def _tsolver(text=SGD):
    return tsolver.Solver(tconfig.parse_solver_prototxt(text),
                          net_param=tconfig.parse_net_prototxt(NET),
                          device="cpu")


def _jsolver(text=SGD):
    return jsolver.Solver(jconfig.parse_solver_prototxt(text),
                          net_param=jconfig.parse_net_prototxt(NET))


def _batches(tau, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(tau, 8, 6).astype(np.float32),
            "label": rng.randint(0, 4, (tau, 8)).astype(np.float32)}


def _leaves(state):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in tree_leaves((state.params, state.stats, state.history))]


def _assert_states_equal(a, b):
    assert np.array_equal(np.asarray(a.iter), np.asarray(b.iter))
    la = _leaves(a)
    lb = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (b.params, b.stats, b.history))] if not isinstance(
        tree_leaves(b.params)[0], torch.Tensor) else _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and np.array_equal(x, y)


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# interchange with the JAX package


@pytest.mark.parametrize("text", [SGD, ADAM], ids=["SGD", "ADAM"])
def test_jax_snapshot_restores_in_the_port(tmp_path, text):
    js = _jsolver(text)
    st = js.init_state(0)
    st, _ = js.step(st, _batches(3))
    _, state_path = jck.snapshot(js, st, str(tmp_path / "j"))
    got = tck.restore(_tsolver(text), state_path)
    _assert_states_equal(got, jax.device_get(st))
    assert got.iter.dtype == torch.int64 and int(got.iter) == 3


@pytest.mark.parametrize("text", [SGD, ADAM], ids=["SGD", "ADAM"])
def test_port_snapshot_restores_in_jax_with_equal_bytes(tmp_path, text):
    js, ts = _jsolver(text), _tsolver(text)
    jst = js.init_state(0)
    params, stats = interop.net_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jst.params), ts.net)
    tst = tsolver.TrainState(params, stats,
                             tsolver._init_history(ts.method, params),
                             torch.tensor(0))
    tst, _ = ts.step(tst, _batches(3))
    tm, tstate_path = tck.snapshot(ts, tst, str(tmp_path / "t"))
    with np.load(tstate_path) as z:
        assert z["iter"].dtype == np.int64
    got = jck.restore(_jsolver(text), tstate_path)
    _assert_states_equal(tst, jax.device_get(got))
    # the same blobs through the JAX writer give the same weight file
    jm, _ = jck.snapshot(js, jax.device_get(got), str(tmp_path / "j"))
    with open(tm, "rb") as a, open(jm, "rb") as b:
        assert a.read() == b.read()


def test_hdf5_snapshot_interchanges_with_jax(tmp_path):
    pytest.importorskip("h5py")
    js = _jsolver()
    st = js.init_state(0)
    st, _ = js.step(st, _batches(2))
    _, jpath = jck.snapshot(js, st, str(tmp_path / "j"), fmt="HDF5")
    got = tck.restore(_tsolver(), jpath)
    _assert_states_equal(got, jax.device_get(st))
    _, tpath = tck.snapshot(_tsolver(), got, str(tmp_path / "t"), fmt="HDF5")
    assert tpath.endswith(".solverstate.h5")
    _assert_states_equal(got, jax.device_get(jck.restore(_jsolver(), tpath)))


# ---------------------------------------------------------------------------
# Solver.step


def test_step_matches_jax_step_and_feeds_smoothed_loss():
    js, ts = _jsolver(), _tsolver()
    jst = js.init_state(0)
    params, stats = interop.net_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jst.params), ts.net)
    tst = tsolver.TrainState(params, stats,
                             tsolver._init_history(ts.method, params),
                             torch.tensor(0))
    for seed in range(2):
        jst, jl = js.step(jst, _batches(3, seed))
        tst, tl = ts.step(tst, _batches(3, seed))  # numpy batches go in too
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5)
    assert int(tst.iter) == 6
    for got, want in zip(_leaves(tst), jax.tree_util.tree_leaves(
            (jst.params, jst.stats, jst.history))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=1e-6 * float(np.abs(want).max()))
    assert abs(ts.smoothed_loss - js.smoothed_loss) < 1e-5


def test_step_repeat_equals_step_on_a_repeated_batch():
    ts = _tsolver()
    b = _batches(1)
    st0 = ts.init_state(0)
    a, la = ts.step_repeat(st0, {k: v[0] for k, v in b.items()}, 3)
    c, lc = _tsolver().step(st0, {k: np.repeat(v, 3, axis=0) for k, v in b.items()})
    assert np.array_equal(la.numpy(), lc.numpy())
    _assert_states_equal(a, c)


# ---------------------------------------------------------------------------
# the port's copies of the JAX fault-tolerance cases


def _snapshot_at(solver, state, prefix, extra_steps=0, **kw):
    for _ in range(extra_steps):
        state, _ = solver.step(state, _batches(2))
    return state, tck.snapshot(solver, state, prefix, **kw)


def test_snapshot_writes_manifest_and_verifies(tmp_path):
    solver = _tsolver()
    metrics = TrainingMetrics()
    state, (model_path, state_path) = _snapshot_at(
        solver, solver.init_state(0), str(tmp_path / "ck"), 1, metrics=metrics)
    mpath = tck.manifest_path_for(state_path)
    tck.verify_snapshot(state_path)
    with open(mpath) as f:
        manifest = json.load(f)
    assert manifest["iter"] == 2 and manifest["format"] == "BINARYPROTO"
    assert set(manifest["files"]) == {os.path.basename(model_path),
                                      os.path.basename(state_path)}
    assert all(e["size"] > 0 for e in manifest["files"].values())
    # the JAX package reads the manifest as its own
    jck.verify_snapshot(state_path)
    assert metrics.snapshots.value == 1
    tck.restore(solver, state_path, metrics=metrics)
    assert metrics.restores.value == 1


def test_verify_catches_bitflip_and_truncation(tmp_path):
    solver = _tsolver()
    state, (_, state_path) = _snapshot_at(solver, solver.init_state(0),
                                          str(tmp_path / "ck"), 1)
    _flip_byte(state_path)
    with pytest.raises(tck.SnapshotCorrupt, match="CRC32"):
        tck.verify_snapshot(state_path)
    with pytest.raises(tck.SnapshotCorrupt):
        tck.restore(solver, state_path)  # restore() verifies too
    _, state_path = tck.snapshot(solver, state, str(tmp_path / "ck"))
    with open(state_path, "r+b") as f:
        f.truncate(os.path.getsize(state_path) // 2)
    with pytest.raises(tck.SnapshotCorrupt, match="truncated"):
        tck.verify_snapshot(state_path)


def test_restore_newest_valid_falls_back_and_quarantines(tmp_path):
    solver, metrics = _tsolver(), TrainingMetrics()
    prefix = str(tmp_path / "ck")
    state, _ = _snapshot_at(solver, solver.init_state(0), prefix, 2)
    state, (_, newest) = _snapshot_at(solver, state, prefix, 2)
    assert len(tck.find_snapshots(prefix)) == 2
    _flip_byte(newest)
    st, used = tck.restore_newest_valid(solver, prefix, metrics=metrics)
    assert used != newest and int(st.iter) == 4
    assert not os.path.exists(newest) and os.path.exists(newest + ".corrupt")
    assert tck.find_snapshots(prefix) == [used]
    assert metrics.quarantined.value == 1 and metrics.restores.value == 1


def test_restore_newest_valid_all_corrupt_raises(tmp_path):
    solver = _tsolver()
    prefix = str(tmp_path / "ck")
    _, (_, state_path) = _snapshot_at(solver, solver.init_state(0), prefix, 1)
    _flip_byte(state_path)
    with pytest.raises(tck.SnapshotCorrupt, match="all 1 candidates"):
        tck.restore_newest_valid(solver, prefix)
    with pytest.raises(FileNotFoundError):
        tck.restore_newest_valid(solver, prefix)  # all quarantined


def test_solver_mismatch_does_not_quarantine_healthy_snapshots(tmp_path):
    solver = _tsolver()
    prefix = str(tmp_path / "ck")
    _snapshot_at(solver, solver.init_state(0), prefix, 1)
    with pytest.raises(tck.SnapshotCorrupt, match="all 1 candidates"):
        tck.restore_newest_valid(_tsolver(ADAM), prefix)
    assert len(tck.find_snapshots(prefix)) == 1
    st, _ = tck.restore_newest_valid(solver, prefix)
    assert int(st.iter) == 2


def test_truncated_snapshot_without_manifest_still_falls_back(tmp_path):
    solver = _tsolver()
    prefix = str(tmp_path / "ck")
    state, _ = _snapshot_at(solver, solver.init_state(0), prefix, 1)
    state, (_, newest) = _snapshot_at(solver, state, prefix, 1)
    os.unlink(tck.manifest_path_for(newest))  # a pre-manifest snapshot
    with open(newest, "r+b") as f:
        f.truncate(16)
    st, used = tck.restore_newest_valid(solver, prefix)
    assert used != newest and int(st.iter) == 2
    assert os.path.exists(newest + ".corrupt")


def test_crash_before_publish_leaves_no_file(tmp_path):
    solver = _tsolver()
    state = solver.init_state(0)

    def boom(path):
        raise RuntimeError(f"killed before publishing {path}")

    tck.set_crash_hook(boom)
    try:
        with pytest.raises(RuntimeError, match="killed"):
            tck.snapshot(solver, state, str(tmp_path / "ck"))
    finally:
        tck.set_crash_hook(None)
    assert os.listdir(tmp_path) == []


def test_journaled_resume_is_not_yet_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tck.restore_newest_valid_journaled(_tsolver(), str(tmp_path / "ck"),
                                           journal=None)


# ---------------------------------------------------------------------------
# async == sync, and exact continuation in both formats


@pytest.mark.parametrize("fmt", ["BINARYPROTO", "HDF5"])
def test_async_checkpointer_matches_sync(tmp_path, fmt):
    if fmt == "HDF5":
        pytest.importorskip("h5py")
    s = _tsolver()
    st, _ = s.step(s.init_state(0), _batches(5, 0))
    sync_paths = tck.snapshot(s, st, str(tmp_path / "sync"), fmt=fmt)
    ckpt = tck.AsyncCheckpointer()
    try:
        ckpt.save(s, st, str(tmp_path / "async"), fmt=fmt)
        st2, _ = s.step(st, _batches(5, 1))  # training goes on meanwhile
        model_path, state_path = ckpt.wait()
    finally:
        ckpt.close()
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    with open(model_path, "rb") as a, open(sync_paths[0], "rb") as b:
        if fmt == "BINARYPROTO":
            assert a.read() == b.read()
    st_sync = tck.restore(_tsolver(), sync_paths[1])
    s_async = _tsolver()
    st_async = tck.restore(s_async, state_path)
    _assert_states_equal(st_sync, st_async)
    st_resumed, _ = s_async.step(st_async, _batches(5, 1))
    _assert_states_equal(st_resumed, st2)


def test_async_checkpointer_propagates_errors(tmp_path):
    s = _tsolver()
    st = s.init_state(0)
    ckpt = tck.AsyncCheckpointer()
    try:
        blocked = tmp_path / "not_a_dir"
        blocked.write_text("a file where a directory is needed")
        ckpt.save(s, st, str(blocked / "prefix"))
        with pytest.raises(OSError):
            ckpt.wait()
        ckpt.save(s, st, str(tmp_path / "ok"))  # still usable
        assert ckpt.wait() is not None
    finally:
        ckpt.close()


@pytest.mark.parametrize("fmt", ["BINARYPROTO", "HDF5"])
def test_snapshot_restore_continues_exactly(tmp_path, fmt):
    if fmt == "HDF5":
        pytest.importorskip("h5py")
    s_ref = _tsolver()
    st_ref, _ = s_ref.step(s_ref.init_state(0), _batches(5, 0))
    st_ref, _ = s_ref.step(st_ref, _batches(5, 1))

    s_a = _tsolver()
    st_a, _ = s_a.step(s_a.init_state(0), _batches(5, 0))
    model_path, state_path = tck.snapshot(s_a, st_a, str(tmp_path / "snap"),
                                          fmt=fmt)
    if fmt == "HDF5":
        assert model_path.endswith(".h5") and state_path.endswith(".h5")
    s_b = _tsolver()
    st_b = tck.restore(s_b, state_path)
    assert int(st_b.iter) == 5
    st_b, _ = s_b.step(st_b, _batches(5, 1))
    _assert_states_equal(st_b, st_ref)


def test_weights_warm_start(tmp_path):
    from sparknet_tpu_torch.io import caffemodel

    s = _tsolver()
    st, _ = s.step(s.init_state(0), _batches(3))
    path = str(tmp_path / "warm.caffemodel")
    caffemodel.save_weights(caffemodel.net_blobs(s.net, st.params, st.stats),
                            path)
    s2 = _tsolver()
    st2 = tck.load_weights_into_state(s2, s2.init_state(seed=42), path)
    assert np.array_equal(st2.params["ip1"][0].numpy(),
                          st.params["ip1"][0].numpy())
    assert int(st2.iter) == 0
    assert not any(h.abs().sum() for h in tree_leaves(st2.history))


def test_job_state_round_trip(tmp_path):
    s = _tsolver()
    st = s.init_state(0)
    extra = {"cursor": {"iter": 8, "round": 2},
             "workers": {"history": {"0": np.arange(6, dtype=np.float32)
                                     .reshape(2, 3)}},
             "comm": {"compress": "int8", "resid": {"0": torch.ones(2)}}}
    _, state_path = tck.snapshot(s, st, str(tmp_path / "ck"), extra_state=extra)
    manifest = tck.read_manifest(tck.manifest_path_for(state_path))
    assert os.path.basename(tck.jobstate_path_for(state_path)) in manifest["files"]
    for load in (tck.load_job_state, jck.load_job_state):
        js = load(state_path)
        assert js["cursor"] == {"iter": 8, "round": 2}
        assert js["comm"]["compress"] == "int8"
        assert np.array_equal(js["workers"]["history"]["0"],
                              extra["workers"]["history"]["0"])
        assert np.array_equal(js["comm"]["resid"]["0"], np.ones(2, np.float32))


# ---------------------------------------------------------------------------
# signals: the context-manager form


def test_signal_handler_context_manager():
    from sparknet_tpu_torch.utils import signals

    before = {s: signal.getsignal(s)
              for s in (signal.SIGHUP, signal.SIGINT, signal.SIGTERM)}
    with signals.SignalHandler() as h:
        assert signal.getsignal(signal.SIGHUP) != before[signal.SIGHUP]
        # SIGTERM's effect is NONE: its handler stays the one before
        assert signal.getsignal(signal.SIGTERM) == before[signal.SIGTERM]
        os.kill(os.getpid(), signal.SIGHUP)
        assert h.get_action() == signals.SolverAction.SNAPSHOT
        assert h.get_action() == signals.SolverAction.NONE
    assert {s: signal.getsignal(s) for s in before} == before


# ---------------------------------------------------------------------------
# the LM and its app

T, B, TAU = 16, 2, 2
APP = ["--device", "cpu", "--dim", "32", "--depth", "1", "--heads", "2",
       "--seq_len", str(T), "--batch", str(B), "--tau", str(TAU),
       "--workers", "2", "--log_every", "1"]


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))


def test_lm_snapshot_restore_roundtrip(tmp_path):
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.data import (
        TextWindowSampler,
        load_corpus,
        write_synthetic_corpus,
    )

    write_synthetic_corpus(str(tmp_path / "c"), num_docs=4, seed=0)
    docs = load_corpus(str(tmp_path / "c"))
    lm = models.build_transformer_lm(dim=32, depth=1, heads=2, seq_len=T)
    solver = tsolver.Solver(tconfig.parse_solver_prototxt(
        'base_lr: 0.1 lr_policy: "fixed" momentum: 0.9'), net=lm, device="cpu")
    state = solver.init_state(seed=0)
    s = TextWindowSampler(docs, T, B, seed=0, worker=0)
    state, _ = solver.step(state, s.window_for_round(0, TAU))
    prefix = str(tmp_path / "lm_ck")
    model_path, _ = tck.snapshot(solver, state, prefix, fmt="BINARYPROTO")
    restored, _ = tck.restore_newest_valid(solver, prefix)
    _assert_states_equal(restored, state)
    # one layer per group of the JAX LM's plan
    from sparknet_tpu_torch.io import caffemodel

    assert list(caffemodel.load_weights(model_path)) == [
        g for g, _ in lm._blob_plan()]


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_lm_app_resume_is_bit_identical(tmp_path, compress):
    """4 rounds straight through vs 2 rounds, then --resume to 4: the
    final params, momentum stacks, comm residuals and every smoothed
    loss after a round are equal bit for bit."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.data import write_synthetic_corpus

    corpus = str(tmp_path / "corpus")
    write_synthetic_corpus(corpus, num_docs=4, seed=0)
    common = APP + ["--corpus", corpus, "--compress", compress,
                    "--snapshot_every", "2"]
    pa, pb = str(tmp_path / "a" / "ck"), str(tmp_path / "b" / "ck")
    ra, rb, rc = {}, {}, {}
    assert lm_app.main(common + ["--rounds", "4", "--snapshot_prefix", pa], ra) == 0
    assert lm_app.main(common + ["--rounds", "2", "--snapshot_prefix", pb], rb) == 0
    assert lm_app.main(common + ["--rounds", "4", "--snapshot_prefix", pb,
                                 "--resume"], rc) == 0
    # each run trained deterministic and left torch's flags as it found them
    assert not torch.are_deterministic_algorithms_enabled()
    assert rc["start_round"] == 2 and len(rc["losses"]) == 2
    assert ra["smoothed"] == rb["smoothed"] + rc["smoothed"]
    assert np.array_equal(ra["losses"], np.concatenate([rb["losses"], rc["losses"]]))
    _assert_states_equal(ra["state"], rc["state"])
    ea, ec = ra["trainer"].export_comm_state(), rc["trainer"].export_comm_state()
    assert (ea is None) == (ec is None) == (compress == "none")
    if ea is not None:
        assert ea["compress"] == ec["compress"] == "int8"
        for k in ea["resid"]:
            assert np.array_equal(ea["resid"][k], ec["resid"][k])
    # the final snapshots agree too, and the JAX package restores one
    na, nc = ra["snapshots"][-1], rc["snapshots"][-1]
    assert os.path.basename(na) == os.path.basename(nc)
    with open(na.replace(".solverstate.npz", ".caffemodel"), "rb") as f, \
            open(nc.replace(".solverstate.npz", ".caffemodel"), "rb") as g:
        assert f.read() == g.read()
    from sparknet_tpu.apps import lm_app as jlm_app

    class Args:
        dim, depth, heads, seq_len = 32, 1, 2, T
        base_lr, momentum, weight_decay = 0.1, 0.9, 1e-4
        dense_attention = False

    _, jsolv = jlm_app.build_lm_solver(Args, sp=1)
    jst = jck.restore(jsolv, nc)
    from sparknet_tpu_torch.parallel import first_worker

    _assert_states_equal(first_worker(rc["state"]), jax.device_get(jst))


def test_lm_app_resume_refusals(tmp_path):
    from sparknet_tpu_torch.apps import lm_app

    with pytest.raises(SystemExit, match="needs --snapshot_prefix"):
        lm_app.main(APP + ["--resume"])
    with pytest.raises(SystemExit, match="no snapshots"):
        lm_app.main(APP + ["--resume", "--snapshot_prefix",
                           str(tmp_path / "none" / "ck")])
    with pytest.raises(SystemExit, match="in flight"):
        lm_app.main(APP + ["--overlap_avg", "--snapshot_every", "1",
                           "--snapshot_prefix", str(tmp_path / "ck")])


def _lm_trainer(compress):
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    args = lm_app._parser().parse_args(APP)
    _, solver = lm_app.build_lm_solver(args, torch.device("cpu"))
    return ParameterAveragingTrainer(solver, 2, compress=compress)


def _round_batch(r):
    rng = np.random.RandomState(r)
    toks = rng.randint(0, 256, (2, TAU, B, T + 1))
    return {"tokens": torch.from_numpy(toks[..., :-1]),
            "targets": torch.from_numpy(toks[..., 1:])}


@pytest.mark.parametrize("when", ["before_first_round", "after_a_round"])
def test_comm_residuals_restore_before_and_after_setup(when):
    ref = _lm_trainer("int8")
    st = ref.init_state(0)
    st, _ = ref.round(st, _round_batch(0))
    exported = ref.export_comm_state()
    assert any(np.abs(v).sum() > 0 for v in exported["resid"].values())
    st_ref, _ = ref.round(st, _round_batch(1))

    other = _lm_trainer("int8")
    if when == "after_a_round":
        other.round(other.init_state(0), _round_batch(5))
    from sparknet_tpu_torch.parallel import first_worker

    st2 = other.broadcast_state(first_worker(st))
    st2 = st2._replace(history=st.history)
    other.restore_comm_state(exported)
    st2, _ = other.round(st2, _round_batch(1))
    _assert_states_equal(st2, st_ref)
    with pytest.raises(ValueError, match="compress"):
        _lm_trainer("bf16").restore_comm_state(exported)
    with pytest.raises(ValueError, match="fused round"):
        _lm_trainer("none").restore_comm_state(exported)


def test_worker_history_round_trip_and_mismatch():
    from sparknet_tpu_torch.parallel import (
        export_worker_history,
        first_worker,
        restore_worker_history,
    )

    tr = _lm_trainer("none")
    st, _ = tr.round(tr.init_state(0), _round_batch(0))
    frag = export_worker_history(st)
    back = restore_worker_history(tr.broadcast_state(first_worker(st)), frag)
    for a, b in zip(tree_leaves(back.history), tree_leaves(st.history)):
        assert torch.equal(a, b)
    frag["history"]["0"] = frag["history"]["0"][:1]
    with pytest.raises(ValueError, match="does not match"):
        restore_worker_history(st, frag)


def test_loss_window_export_and_restore():
    s = _tsolver(SGD + " average_loss: 10")
    s.note_losses(torch.tensor([1.0, 2.0]))
    s.note_losses(torch.tensor([[3.0, 5.0], [5.0, 7.0]]))  # worker means 4, 6
    w = s.export_loss_window()
    assert w.dtype == np.float64 and w.tolist() == [1.0, 2.0, 4.0, 6.0]
    s2 = _tsolver(SGD + " average_loss: 10")
    s2.restore_loss_window(w)
    assert s2.smoothed_loss == s.smoothed_loss == 3.25


def test_garbage_manifest_is_corruption(tmp_path):
    solver = _tsolver()
    prefix = str(tmp_path / "ck")
    state, _ = _snapshot_at(solver, solver.init_state(0), prefix, 1)
    _, (_, newest) = _snapshot_at(solver, state, prefix, 1)
    with open(tck.manifest_path_for(newest), "w") as f:
        f.write('{"files": [')
    with pytest.raises(tck.SnapshotCorrupt, match="unreadable manifest"):
        tck.verify_snapshot(newest)
    st, used = tck.restore_newest_valid(solver, prefix)
    assert used != newest and int(st.iter) == 2
