"""The port's serving fleet and train-to-serve delivery, on the CPU.

Mirrors the JAX package's ``tests/test_serve_fleet.py`` on
``InferenceEngine(device="cpu")`` replicas: routing, fleet-wide shed
consistency at saturation, eject/respawn and the unservable fleet,
promote bit identity, in-flight requests surviving a promote, the
verdict-gated publisher, verify-time rejection and quarantine, canary
promote, rollback and the inconclusive window, the per-replica /healthz
contract and the read-only manifest helpers.  Parity with the JAX
package: the same publish verifies under both packages'
``verify_bytes_entry``, both fold a sentry into the same verdict, the
JAX watcher accepts the port's publish, and a generation fleet streams
the tokens of a single engine, resuming a stream on a sibling after a
replica death.
"""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sparknet_tpu.io import checkpoint as jcheckpoint
from sparknet_tpu.serve import publish as jpublish
from sparknet_tpu_torch import config
from sparknet_tpu_torch.config import parse_solver_prototxt
from sparknet_tpu_torch.io import caffemodel, checkpoint
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.serve import (
    DeliveryController,
    FleetUnservable,
    InferenceEngine,
    PublishRefused,
    QueueFull,
    ReplicaPool,
    Router,
    ServeServer,
    publish_snapshot,
)
from sparknet_tpu_torch.serve import publish as publish_mod
from sparknet_tpu_torch.solver import Solver

TOY_TRAIN = """
name: "toy"
layer { name: "data" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } shape { dim: 4 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""
TOY_DEPLOY = """
name: "toy"
input: "data"
input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "logits" top: "prob" }
"""

X = np.random.RandomState(0).randn(1, 3, 8, 8).astype(np.float32)


@pytest.fixture(scope="module")
def netp_deploy():
    return config.parse_net_prototxt(TOY_DEPLOY)


def _solver(text=TOY_TRAIN):
    return Solver(parse_solver_prototxt('base_lr: 0.01 lr_policy: "fixed"'),
                  net_param=config.parse_net_prototxt(text), device="cpu")


@pytest.fixture(scope="module")
def toy_solver():
    solver = _solver()
    return solver, solver.init_state(seed=3)


def _scaled(state, factor, **fields):
    """``state`` with every parameter times ``factor`` (a seeded
    divergence: outputs move, stay finite)."""
    params = {k: [b * factor for b in v] for k, v in state.params.items()}
    return state._replace(params=params, **fields)


def _flip_bytes(path, seed):
    """Flip bytes in the middle of ``path``, its size unchanged (only the
    CRC can tell)."""
    rs = np.random.RandomState(seed)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        for i in rs.randint(0, len(data), 8):
            data[i] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))


def _make_engine_factory(netp):
    def make_engine(weights=None, device="cpu"):
        return InferenceEngine(netp, weights=weights, buckets=(1, 4),
                               device=device)

    return make_engine


def _fleet(netp, replicas=2, max_inflight=32, canary_frac=0.5, max_queue=64,
           devices=None):
    pool = ReplicaPool(_make_engine_factory(netp), replicas=replicas,
                       max_queue=max_queue, devices=devices)
    router = Router(pool, max_inflight=max_inflight, canary_frac=canary_frac)
    return pool, router


def _gate_engines(pool):
    """Wrap every replica's forward behind an Event so requests park
    deterministically (the saturation fixture)."""
    gate = threading.Event()
    for rep in pool.replicas:
        eng = rep.engine
        orig = eng.run_padded

        def run_padded(px, _orig=orig):
            gate.wait()
            return _orig(px)

        eng.run_padded = run_padded
    return gate


# ----------------------------------------------------------------------
# router: routing, shed consistency, eject/respawn


def test_router_routes_and_matches_single_engine(netp_deploy):
    pool, router = _fleet(netp_deploy, replicas=2,
                          devices=[torch.device("cpu")])
    try:
        out = router.submit(X)
        assert np.array_equal(out, pool.replicas[0].engine.infer(X))
        # both replicas serve the identical boot weights, each its own copy
        assert np.array_equal(out, pool.replicas[1].engine.infer(X))
        p0 = pool.replicas[0].engine.params["ip"][0]
        p1 = pool.replicas[1].engine.params["ip"][0]
        assert p0.data_ptr() != p1.data_ptr()
        assert all(r.engine.jit_cache_size() == 2 for r in pool.replicas)
    finally:
        router.close()


@pytest.mark.parametrize("replicas", [1, 2])
def test_shed_consistency_at_saturation(netp_deploy, replicas):
    """At a fixed offered load past saturation the number of 429s is
    EXACTLY offered - bound, whatever the replica count."""
    offered, bound = 12, 4
    pool, router = _fleet(netp_deploy, replicas=replicas, max_inflight=bound)
    gate = _gate_engines(pool)
    codes = []
    lock = threading.Lock()

    def client():
        try:
            router.submit(X, timeout=60.0)
            c = 200
        except QueueFull:
            c = 429
        with lock:
            codes.append(c)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(offered)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 30
        while len(codes) < offered - bound and time.time() < deadline:
            time.sleep(0.01)
        assert codes.count(429) == offered - bound
        gate.set()
        for t in threads:
            t.join(60)
        assert codes.count(200) == bound
        assert codes.count(429) == offered - bound
    finally:
        gate.set()
        router.close()


def test_dead_replica_ejected_requests_retried_and_respawned(netp_deploy):
    pool, router = _fleet(netp_deploy, replicas=2)
    try:
        router.submit(X)
        pool.replicas[0].kill()
        for _ in range(4):  # every request still answered
            assert router.submit(X).shape == (1, 5)
        assert pool.replicas[0].state == "ejected"
        assert int(pool.m_ejections.value) == 1
        rep = pool.respawn(0)
        assert rep.state == "live" and rep.healthy
        assert int(pool.m_respawns.value) == 1
        assert np.array_equal(rep.engine.infer(X),
                              pool.replicas[1].engine.infer(X))
    finally:
        router.close()


def test_whole_fleet_dead_is_unservable(netp_deploy):
    pool, router = _fleet(netp_deploy, replicas=2)
    try:
        pool.replicas[0].kill()
        pool.replicas[1].kill()
        with pytest.raises(FleetUnservable):
            router.submit(X)
    finally:
        router.close()


def test_fleet_metrics_render_on_shared_registry(netp_deploy):
    pool, router = _fleet(netp_deploy, replicas=2)
    try:
        router.submit(X)
        router.submit(X)
        pool.eject(1)
        text = pool.registry.render()
        assert 'sparknet_serve_replica_state{replica="0"} 0' in text
        assert 'sparknet_serve_replica_state{replica="1"} 2' in text
        assert sum(c.value for c in pool.m_requests.children()) == 2
        assert "sparknet_serve_replica_requests_total" in text
        assert "sparknet_serve_replica_ejections_total 1" in text
        assert "serve_requests_total 2" in text  # the fleet sum
        assert "sparknet_delivery_canary_mirrors_total 0" in text
    finally:
        router.close()


# ----------------------------------------------------------------------
# hot reload: bit identity + in-flight survival


def _write_weights(netp, seed, path):
    """A .caffemodel with fresh seeded weights for the toy net."""
    net = TorchNet(netp, phase="TEST")
    params, stats = net.init(seed)
    caffemodel.save_weights(caffemodel.net_blobs(net, params, stats), path,
                            net_name="toy")
    return path


def test_promote_reload_bit_identity(netp_deploy, tmp_path):
    """The promoted fleet's outputs EXACTLY equal a fresh engine loaded
    from the same file: a hot reload changes nothing but the weights."""
    w1 = _write_weights(netp_deploy, 11, str(tmp_path / "w1.caffemodel"))
    pool, router = _fleet(netp_deploy, replicas=2)
    try:
        before = router.submit(X)
        assert pool.promote(w1, publish_id="w1") == 2
        assert pool.incumbent_id == "w1"
        after = router.submit(X)
        fresh = InferenceEngine(netp_deploy, weights=w1, buckets=(1, 4),
                                device="cpu")
        fresh.warmup()
        assert np.array_equal(after, fresh.infer(X))
        assert not np.array_equal(before, after)
        for rep in pool.replicas:
            assert np.array_equal(rep.engine.infer(X), after)
    finally:
        router.close()


def test_inflight_requests_survive_promote(netp_deploy, tmp_path):
    w1 = _write_weights(netp_deploy, 12, str(tmp_path / "w1.caffemodel"))
    pool, router = _fleet(netp_deploy, replicas=2)
    for rep in pool.replicas:  # slow forwards: the swap lands mid-stream
        eng = rep.engine
        orig = eng.run_padded

        def run_padded(px, _orig=orig):
            time.sleep(0.01)
            return _orig(px)

        eng.run_padded = run_padded
    errors, results = [], []
    lock = threading.Lock()

    def client():
        try:
            for _ in range(10):
                out = router.submit(X, timeout=60.0)
                with lock:
                    results.append(out)
        except BaseException as e:  # noqa: BLE001
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, daemon=True) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        pool.promote(w1, publish_id="w1")
        for t in threads:
            t.join(120)
        assert not errors, errors
        assert len(results) == 40  # nothing dropped
        fresh = InferenceEngine(netp_deploy, weights=w1, buckets=(1, 4),
                                device="cpu")
        assert np.array_equal(router.submit(X), fresh.infer(X))
    finally:
        router.close()


# ----------------------------------------------------------------------
# publish: the verdict gate


def test_publish_refuses_failing_verdict(toy_solver, tmp_path):
    solver, state = toy_solver
    with pytest.raises(PublishRefused):
        publish_snapshot(solver, state, str(tmp_path),
                         {"passing": False, "reason": "seeded failure"})
    assert not os.listdir(tmp_path)  # nothing was written


def _sentry(**kw):
    fields = dict(halted=False, halt_reason=None, rounds_observed=0,
                  last_round=None, last_anomaly_round=None)
    fields.update(kw)
    s = types.SimpleNamespace(**fields)
    s.state_dict = lambda: {"rounds_observed": s.rounds_observed}
    return s


@pytest.mark.parametrize("fields,passing", [
    (None, False),
    ({}, False),  # no rounds observed: no evidence
    (dict(rounds_observed=5, last_round=4), True),
    (dict(rounds_observed=5, last_round=4, last_anomaly_round=4), False),
    (dict(rounds_observed=5, last_round=4, last_anomaly_round=1), True),
    (dict(rounds_observed=5, last_round=4, halted=True,
          halt_reason="seeded"), False),
], ids=["none", "no_rounds", "clean", "hot_anomaly", "cold_anomaly",
        "halted"])
def test_verdict_from_sentry_matches_the_jax_package(fields, passing):
    """The verdict gate, over any object with the sentry's attributes,
    folds exactly as the JAX package's does."""
    s = None if fields is None else _sentry(**fields)
    got = publish_mod.verdict_from_sentry(s)
    assert got["passing"] is passing
    assert got == jpublish.verdict_from_sentry(s)


def test_publish_attaches_verdict_to_manifest(toy_solver, tmp_path):
    solver, state = toy_solver
    paths = publish_snapshot(solver, state, str(tmp_path),
                             {"passing": True, "reason": "seeded"})
    mpath = checkpoint.manifest_path_for(paths[1])
    with open(mpath) as f:
        assert json.load(f)["verdict"]["passing"] is True
    assert checkpoint.verify_manifest(mpath)["verdict"]["reason"] == "seeded"


def test_publish_is_atomic_with_verdict(toy_solver, tmp_path):
    solver, state = toy_solver
    publish_snapshot(solver, state, str(tmp_path),
                     {"passing": True, "reason": "ok"})
    entries = sorted(os.listdir(tmp_path))
    assert not any(e.startswith(".") for e in entries), entries
    assert len(entries) == 3  # model + state + manifest, nothing else
    mpath = [e for e in entries if e.endswith(".manifest.json")][0]
    with open(tmp_path / mpath) as f:
        assert json.load(f)["verdict"]["passing"] is True


def test_publish_verifies_under_both_packages(toy_solver, tmp_path):
    """The port's publish is the JAX package's format: both packages'
    ``parse_manifest``/``verify_bytes_entry`` accept it, and reject the
    same truncation."""
    solver, state = toy_solver
    model, statep = publish_snapshot(solver, state, str(tmp_path),
                                     {"passing": True, "reason": "ok"})
    mpath = checkpoint.manifest_path_for(statep)
    with open(mpath, "rb") as f:
        raw = f.read()
    with open(model, "rb") as f:
        data = f.read()
    for ck in (checkpoint, jcheckpoint):
        manifest = ck.parse_manifest(raw, label=mpath)
        ck.verify_bytes_entry(os.path.basename(model), data, manifest)
        with pytest.raises(ck.SnapshotCorrupt):
            ck.verify_bytes_entry(os.path.basename(model), data[:-1], manifest)
        assert ck.crc32_bytes(data) == checkpoint.crc32_file(model)[0]


# ----------------------------------------------------------------------
# delivery: verify-reject, canary promote/rollback


def test_delivery_rejects_unverdicted_publish(netp_deploy, toy_solver,
                                              tmp_path):
    solver, state = toy_solver
    publish_snapshot(solver, state, str(tmp_path),
                     {"passing": False, "reason": "unverified"},
                     require_passing=False)
    pool, router = _fleet(netp_deploy, replicas=1)
    try:
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"))
        assert ctl.poll_once() == "rejected"
        assert ctl.rejected == 1 and router.canary is None
        assert ctl.phase == "idle"
    finally:
        router.close()


def test_delivery_rejects_corrupt_publish_at_verify(netp_deploy, toy_solver,
                                                   tmp_path):
    solver, state = toy_solver
    paths = publish_snapshot(solver, state, str(tmp_path),
                             {"passing": True, "reason": "ok"})
    _flip_bytes(paths[0], seed=9)
    pool, router = _fleet(netp_deploy, replicas=1)
    try:
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"))
        assert ctl.poll_once() == "rejected"
        assert ctl.rejected == 1 and router.canary is None
        quarantined = ctl.last_decision["quarantined"]
        assert quarantined and all(q.endswith(".corrupt") for q in quarantined)
        assert ctl.poll_once() is None  # not resurrected
    finally:
        router.close()


def _drive(ctl, router, pred, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while not pred() and time.time() < deadline:
        router.submit(X)
        ctl.poll_once()
        time.sleep(0.02)
    assert pred(), ctl.status()


def test_canary_rollback_on_seeded_divergence(netp_deploy, toy_solver,
                                              tmp_path):
    solver, state = toy_solver
    bad = _scaled(state, 50.0, iter=torch.tensor(7, dtype=torch.int64))
    publish_snapshot(solver, bad, str(tmp_path),
                     {"passing": True, "reason": "forged: canary is the last line"})
    pool, router = _fleet(netp_deploy, replicas=1, canary_frac=0.5)
    try:
        incumbent = router.submit(X)
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"),
                                 decision_requests=4, divergence_max=0.05)
        assert ctl.poll_once() == "canary"
        assert ctl.phase == "canary"
        _drive(ctl, router, lambda: ctl.rollbacks == 1)
        d = ctl.last_decision
        assert d["action"] == "rolled_back"
        assert d["publish_id"] == "published_iter_7"
        assert "divergence" in d["why"] and d["quarantined"]
        assert router.canary is None and ctl.phase == "idle"
        assert np.array_equal(router.submit(X), incumbent)
        assert int(pool.registry.get(
            "sparknet_delivery_rollbacks_total").value) == 1
    finally:
        router.close()


def test_delivery_promotes_good_publish(netp_deploy, toy_solver, tmp_path):
    solver, state = toy_solver
    paths = publish_snapshot(solver, state, str(tmp_path),
                             {"passing": True, "reason": "ok"})
    pool, router = _fleet(netp_deploy, replicas=2, canary_frac=0.5)
    try:
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"),
                                 decision_requests=4, divergence_max=10.0)
        assert ctl.poll_once() == "canary"
        _drive(ctl, router, lambda: ctl.promotions == 1)
        assert pool.incumbent_id == "published_iter_0"
        assert ctl.last_decision["replicas_swapped"] == 2
        fresh = InferenceEngine(netp_deploy, weights=paths[0], buckets=(1, 4),
                                device="cpu")
        for rep in pool.replicas:
            assert np.array_equal(rep.engine.infer(X), fresh.infer(X))
        assert np.array_equal(router.submit(X), fresh.infer(X))
    finally:
        router.close()


def test_window_timeout_is_inconclusive_not_condemning(netp_deploy,
                                                       toy_solver, tmp_path):
    solver, state = toy_solver
    paths = publish_snapshot(solver, state, str(tmp_path),
                             {"passing": True, "reason": "ok"})
    pool, router = _fleet(netp_deploy, replicas=1, canary_frac=0.5)
    try:
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"),
                                 decision_requests=8, window_timeout_s=0.2)
        assert ctl.poll_once() == "canary"
        time.sleep(0.3)  # the window expires with nothing mirrored
        deadline = time.time() + 10
        while ctl.rollbacks == 0 and time.time() < deadline:
            ctl.poll_once()
            time.sleep(0.02)
        d = ctl.last_decision
        assert d["action"] == "rolled_back" and "inconclusive" in d["why"]
        assert d["quarantined"] == []
        for p in paths:
            assert os.path.exists(p), p
        assert router.canary is None and ctl.phase == "idle"
    finally:
        router.close()


def test_stale_cache_entry_refreshes_on_republish(netp_deploy, toy_solver,
                                                 tmp_path):
    solver, state = toy_solver
    publish_snapshot(solver, state, str(tmp_path),
                     {"passing": True, "reason": "v1"})
    pool, router = _fleet(netp_deploy, replicas=1, canary_frac=0.5)
    cache_dir = str(tmp_path / "cache")
    try:
        ctl1 = DeliveryController(pool, router, str(tmp_path),
                                  cache_dir=cache_dir)
        assert ctl1.poll_once() == "canary"
        router.clear_canary()
        params = {k: [b + 0.5 for b in v] for k, v in state.params.items()}
        publish_snapshot(solver, state._replace(params=params), str(tmp_path),
                         {"passing": True, "reason": "v2"})
        ctl2 = DeliveryController(pool, router, str(tmp_path),
                                  cache_dir=cache_dir)
        assert ctl2.poll_once() == "canary"
        assert ctl2.rejected == 0
    finally:
        router.close()


def test_rollback_quarantines_nested_publish_location(netp_deploy, toy_solver,
                                                      tmp_path):
    solver, state = toy_solver
    sub = tmp_path / "runA"
    paths = publish_snapshot(solver, _scaled(state, 50.0), str(sub),
                             {"passing": True, "reason": "forged"})
    pool, router = _fleet(netp_deploy, replicas=1, canary_frac=0.5)
    try:
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"),
                                 decision_requests=4, divergence_max=0.05)
        assert ctl.poll_once() == "canary"
        _drive(ctl, router, lambda: ctl.rollbacks == 1)
        moved = ctl.last_decision["quarantined"]
        assert moved
        for q in moved:
            assert os.path.dirname(q) == str(sub) and os.path.exists(q)
        for p in paths:
            assert not os.path.exists(p), p
    finally:
        router.close()


def test_incompatible_publish_rejected_without_wedging(netp_deploy, tmp_path):
    solver = _solver(TOY_TRAIN.replace("num_output: 5", "num_output: 7"))
    paths = publish_snapshot(solver, solver.init_state(seed=0), str(tmp_path),
                             {"passing": True, "reason": "wrong net"})
    pool, router = _fleet(netp_deploy, replicas=1)
    try:
        ctl = DeliveryController(pool, router, str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"))
        assert ctl.poll_once() == "rejected"
        assert ctl.rejected == 1 and ctl.phase == "idle"
        assert "build failed" in ctl.last_decision["why"]
        assert ctl.last_decision["quarantined"] == []
        for p in paths:
            assert os.path.exists(p), p
        assert router.canary is None
        assert ctl.poll_once() is None
        assert router.submit(X).shape == (1, 5)
    finally:
        router.close()


def test_jax_watcher_accepts_the_ports_publish(toy_solver, tmp_path):
    """A publish written by the port verifies end to end under the JAX
    package's manifest reader (the verdict rides the manifest)."""
    solver, state = toy_solver
    _model, statep = publish_snapshot(solver, state, str(tmp_path),
                                      {"passing": True, "reason": "ok"})
    manifest = jcheckpoint.verify_manifest(
        jcheckpoint.manifest_path_for(statep))
    assert manifest["verdict"] == {"passing": True, "reason": "ok"}
    assert manifest["iter"] == 0


# ----------------------------------------------------------------------
# the fleet /healthz contract


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_fleet_healthz_per_replica_and_503_only_when_unservable(
        netp_deploy, tmp_path):
    pool, router = _fleet(netp_deploy, replicas=2)
    ctl = DeliveryController(pool, router, str(tmp_path),
                             cache_dir=str(tmp_path / "cache"))
    srv = ServeServer(router=router, delivery=ctl, port=0)
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"
    try:
        status, body = _get(base, "/healthz")
        assert status == 200 and body["status"] == "ok"
        assert [r["state"] for r in body["replicas"]] == ["live", "live"]
        assert body["fleet"]["live"] == 2
        assert body["delivery"]["phase"] == "idle"
        assert body["delivery"]["promotions"] == 0
        pool.eject(0)
        status, body = _get(base, "/healthz")
        assert status == 200 and body["status"] == "ok"
        assert [r["state"] for r in body["replicas"]] == ["ejected", "live"]
        req = urllib.request.Request(
            base + "/predict", data=json.dumps({"data": X[0].tolist()}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        pool.replicas[1].kill()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "unservable"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "1"
    finally:
        srv.shutdown()


# ----------------------------------------------------------------------
# the read-only manifest helpers (io/checkpoint.py)


def test_checkpoint_readonly_verify_helpers(toy_solver, tmp_path):
    solver, state = toy_solver
    model, statep = checkpoint.snapshot(solver, state, str(tmp_path / "snap"))
    mpath = checkpoint.manifest_path_for(statep)
    manifest = checkpoint.verify_manifest(mpath)
    assert os.path.basename(model) in manifest["files"]
    with open(model, "rb") as f:
        data = f.read()
    checkpoint.verify_bytes_entry(os.path.basename(model), data, manifest)
    with pytest.raises(checkpoint.SnapshotCorrupt):
        checkpoint.verify_bytes_entry(os.path.basename(model), data[:-1],
                                      manifest)
    with pytest.raises(checkpoint.SnapshotCorrupt):
        checkpoint.verify_bytes_entry("nope.caffemodel", data, manifest)
    _flip_bytes(model, seed=1)
    with pytest.raises(checkpoint.SnapshotCorrupt):
        checkpoint.verify_manifest(mpath)
    with pytest.raises(checkpoint.SnapshotCorrupt):
        checkpoint.parse_manifest(b"not json")
    with pytest.raises(checkpoint.SnapshotCorrupt):
        checkpoint.parse_manifest(b'{"files": 3}')
    assert checkpoint.verify_manifest(str(tmp_path / "missing.json")) is None
    crc, _size = checkpoint.crc32_file(statep)
    with open(statep, "rb") as f:
        assert checkpoint.crc32_bytes(f.read()) == crc


# ----------------------------------------------------------------------
# the generation fleet (stream=True)


GEN = dict(dim=32, depth=2, heads=2, seq_len=32, vocab=64)
GEN_SERVE = dict(prefill_buckets=(8, 32), max_streams=2, kv_blocks=24,
                 kv_block_size=4)


def _gen_engine(weights=None, device="cpu"):
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.serve import GenerationEngine

    return GenerationEngine(TransformerLM(**GEN), weights=weights,
                            device=device, **GEN_SERVE)


def _tokens(events):
    evs = list(events)
    assert evs[-1]["event"] == "done", evs[-1]
    assert [e["index"] for e in evs[:-1]] == list(range(len(evs) - 1))
    return evs[-1]["tokens"]


def test_generation_fleet_streams_the_single_engines_tokens():
    """Two generation replicas, each its own module and KV arena, stream
    the tokens one engine streams; a replica killed mid-stream is
    ejected and the stream resumes on its sibling, the same tokens."""
    from sparknet_tpu_torch.serve import StreamBatcher

    single = _gen_engine()
    single.warmup()
    sb = StreamBatcher(single)
    prompts = [[5, 9, 2], [1, 2, 3, 4, 5], [7], [3, 3]]
    want = [sb.submit_stream(p, 12).result()["tokens"] for p in prompts]
    sb.stop()
    pool = ReplicaPool(_gen_engine, replicas=2, stream=True)
    router = Router(pool, max_inflight=8)
    try:
        a, b = (r.engine for r in pool.replicas)
        assert a.lm is not b.lm and a.pool.k.data_ptr() != b.pool.k.data_ptr()
        got = [None] * len(prompts)

        def client(i):
            got[i] = _tokens(router.submit_stream(prompts[i], 12))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert got == want
        # a replica death mid-stream: the stream resumes on the sibling
        events = router.submit_stream(prompts[0], 12)
        first = [next(events) for _ in range(3)]
        for rep in pool.replicas:
            if rep.batcher.active_count() or rep.batcher.queue_depth():
                rep.kill()
        rest = list(events)
        assert _tokens(first + rest) == want[0]
        assert int(router.m_resumes.value) + int(router.m_retries.value) >= 1
    finally:
        router.close()
