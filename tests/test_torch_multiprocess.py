"""SparkNet's averaging loop across OS processes, on the CPU over gloo.

Two ranks join once through a ``file://`` store (so parallel test
workers never race for a port) and run a list of averaging specs
(``utils/procs.py``), each rank stacking its own block of the W
workers; the one-process stacked run of the same W, made in rank 0's
process before it joins, is the reference.

- A two-rank round against the JAX package's one-process dp=2 round on
  the CPU mesh, from carried weights, within the stacked-trainer
  parity tests' tolerance (rtol 2e-5, atol 1e-6: ``test_torch_comm``).
- The same rounds against the port's stacked rounds bit for bit:
  default and ``--compress int8``, W=2 (one worker a rank) and W=4 (two
  a rank) — the gather-then-reduce design gives bits for any W.
- The survivor mask across ranks: a dead worker in the live mask, and a
  poisoned worker caught by the audit's in-round mask on another rank.
- The harness's workers (``toy_averaging_worker``, shipping each rank's
  spans to a collector under ``$SPARKNET_SHIP_TO``, and
  ``timed_averaging_worker``).
- ``tools/launch.py --nprocs 2 cifar --device cpu``: the one-process
  run's numbers, only rank 0 logging; ``imagenet`` across two ranks at
  a narrowed input against one process; the launcher's refusals, its
  ``--fleet_collector`` wiring, and its dispatch of the cluster
  lifecycle actions to ``tools/provision.py``.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from sparknet_tpu import config as jconfig
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch.tools import launch
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = {
    "none-2x1": {"workers": 2, "rounds": 2},
    "int8-2x1": {"workers": 2, "rounds": 2, "compress": "int8"},
    "none-2x2": {"workers": 4, "rounds": 2},
    "int8-2x2": {"workers": 4, "rounds": 2, "compress": "int8"},
    "live-2x2": {"workers": 4, "rounds": 2, "live": [1, 1, 0, 1]},
    "audit-2x2": {"workers": 4, "rounds": 2, "poison": 1},
    "jax-2x1": {"workers": 2, "rounds": 2, "tau": 3},
}


@pytest.fixture(scope="module")
def jax_dp2(tmp_path_factory):
    """The JAX one-process dp=2 trainer's rounds of ``jax-2x1`` and its
    initial weights, saved for the workers to start from."""
    d = tmp_path_factory.mktemp("jax")
    spec = procs._spec(SPECS["jax-2x1"])
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    solver = JSolver(jconfig.parse_solver_prototxt(procs.TOY_SOLVER),
                     net_param=jconfig.parse_net_prototxt(procs.TOY_NET))
    trainer = JTrainer(solver, mesh)
    state = trainer.init_state(seed=0)
    init = str(d / "init.npz")
    procs.save_weights(init, {k: [np.asarray(b)[0] for b in v]
                              for k, v in state.params.items()})
    losses = []
    for r in range(spec["rounds"]):
        state, l = trainer.round(
            state, shard_leading(procs.averaging_batches(spec, r), mesh))
        losses.append(np.asarray(l))
    params = [np.asarray(x)[0] for x in jax.tree_util.tree_leaves(state.params)]
    return init, np.stack(losses), params


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_dp2):
    """Every spec over two gloo ranks joined once, and each spec's W
    stacked with no group in rank 0 before it joined."""
    d = tmp_path_factory.mktemp("mp")
    specs = dict(SPECS)
    specs["jax-2x1"] = dict(specs["jax-2x1"], init=jax_dp2[0])
    names = list(specs)
    got, ref, logs = procs.run_averaging_processes(
        [specs[n] for n in names], REPO, nprocs=2, device="cpu",
        workdir=str(d), timeout=300, stacked_first=True)
    return {n: (got[i], ref[i]) for i, n in enumerate(names)}, logs


def _same(ranks, ref, what):
    """Each rank's rows of every param, and every worker's losses, equal
    the stacked run's bit for bit."""
    for r in ranks:
        lo, hi = r["rows"]
        for got, want in zip(r["all_rows"], ref["all_rows"]):
            np.testing.assert_array_equal(got, want[lo:hi], err_msg=what)
        np.testing.assert_array_equal(r["losses"], np.stack(ref["losses"]),
                                      err_msg=what)


@pytest.mark.parametrize("name", ["none-2x1", "int8-2x1", "none-2x2",
                                  "int8-2x2"])
def test_two_rank_rounds_are_the_stacked_rounds_bit_for_bit(runs, name):
    ranks, ref = runs[0][name]
    logs = runs[1]
    assert [r["rows"] for r in ranks] == (
        [[0, 1], [1, 2]] if name.endswith("2x1") else [[0, 2], [2, 4]])
    _same(ranks, ref, name)
    for r in ranks:  # every worker holds the consensus after a round
        for rows in r["all_rows"]:
            for w in range(1, rows.shape[0]):
                np.testing.assert_array_equal(rows[w], rows[0])
    # what crossed the group: the other rank's rows, each round
    n_other = 1 if name.endswith("2x1") else 2
    nparam = sum(p.size for p in ranks[0]["params"])
    per_round = (n_other * nparam * 4 if name.startswith("none")
                 else n_other * (nparam + 4 * len(ranks[0]["params"])))
    assert ranks[0]["group_bytes"] == [per_round] * 2
    assert "joined rank 0 of 2 on cpu over gloo" in logs[0]


def test_two_rank_round_matches_the_jax_dp2_round(runs, jax_dp2):
    (ranks, ref) = runs[0]["jax-2x1"]
    _, jlosses, jparams = jax_dp2
    _same(ranks, ref, "jax-2x1 stacked")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=2e-5, atol=1e-6)
        for got, want in zip(r["params"], jparams):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["live-2x2", "audit-2x2"])
def test_survivor_mask_across_ranks(runs, name):
    """A dead worker (rank 1's first) and a poisoned one (rank 0's
    second, caught by the audit on its own rank) leave the average on
    every rank: the bits of the stacked run, every param finite."""
    ranks, ref = runs[0][name]
    _same(ranks, ref, name)
    for r in ranks:
        for rows in r["all_rows"]:
            assert np.isfinite(rows).all()
            np.testing.assert_array_equal(rows[0], rows[-1])
    if name == "audit-2x2":
        assert np.isnan(ranks[1]["losses"][0, 1]).any()  # rank 0's worker
        assert np.isfinite(ranks[1]["losses"][0, [0, 2, 3]]).all()


def test_a_failed_rank_ends_the_wait_and_its_peer_is_killed():
    """``reap_processes`` (the harness's and the launcher's reaper): a rank
    that exits nonzero ends the wait at once, the peer still running (as
    one blocked in a collective would be) is killed, and every output is
    kept."""
    import time

    cmds = [[sys.executable, "-c", "import time; print('up', flush=True); "
             "time.sleep(120)"],
            [sys.executable, "-c", "print('bad'); raise SystemExit(3)"]]
    t0 = time.perf_counter()
    results, killed, timed_out = procs.reap_processes(
        cmds, [dict(os.environ)] * 2, timeout=60)
    assert time.perf_counter() - t0 < 30
    assert killed == [0] and not timed_out
    assert results[1] == (3, "bad\n") and results[0][0] != 0
    results, killed, timed_out = procs.reap_processes(
        cmds[:1], [dict(os.environ)], timeout=1)
    assert killed == [0] and timed_out and results[0][1] == "up\n"


def test_harness_workers(tmp_path):
    from sparknet_tpu_torch.obs.fleet import FleetCollector

    collector = FleetCollector(port=0).start()
    try:
        outs = procs.run_two_process_round(
            procs.toy_averaging_worker("TOY_OK"), "TOY_OK", REPO,
            devices_per_process=2, timeout=300, workdir=str(tmp_path),
            args=("--device", "cpu"),
            env_extra={"SPARKNET_SHIP_TO": collector.url,
                       "SPARKNET_SHIP_INTERVAL_S": "0.1"})
        # with $SPARKNET_SHIP_TO each rank shipped its round's spans
        hosts = collector.fleet_view()["hosts"]
    finally:
        collector.close()
    assert all(re.search(r"TOY_OK p\d loss=\d", o) for o in outs)
    assert sorted(hosts) == ["proc0", "proc1"]
    for st in hosts.values():
        assert st["state"] == "finished" and st["lost_events"] == 0
        assert st["received_events"] > 0
    outs = procs.run_two_process_round(
        procs.timed_averaging_worker("TIMED_OK"), "TIMED_OK", REPO,
        timeout=300, workdir=str(tmp_path), args=("--device", "cpu"))
    assert all("collective_ms=" in o and "tau=10" in o for o in outs)
    # the fleet-shipping worker (run in tests/test_torch_obs_fleet.py)
    src = procs.fleet_ship_worker("X")
    assert "@MARKER@" not in src and 'print(f"X p{pid}' in src


def _launch(tmp_path, *argv):
    store = "file://" + str(tmp_path / "store")
    out = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.launch", "--nprocs",
         "2", "--coordinator", store, *argv], capture_output=True, text=True,
        timeout=600, env=procs.repo_env(REPO), cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _last(pattern, text):
    return re.findall(pattern, text)[-1]


def test_launch_two_ranks_cifar_equals_one_process(tmp_path):
    from sparknet_tpu_torch.apps import cifar_app

    argv = ["--device", "cpu", "--rounds", "1", "--tau", "2", "--workers",
            "2", "--test_every", "1"]
    text = _launch(tmp_path, "cifar", *argv)
    assert "[host 0] launch: 2 process(es) joined over gloo" in text
    # only rank 0 echoes its log
    assert "smoothed_loss" in text and not re.search(
        r"\[host 1\] \d+\.\d+:", text)
    one = {}
    assert cifar_app.main(argv, result=one) == 0
    assert float(_last(r"final accuracy (\S+)", text)) == pytest.approx(
        one["accuracy"], abs=5e-5)
    assert float(_last(r"smoothed_loss (\S+)", text)) == pytest.approx(
        one["smoothed_loss"], abs=5e-5)


def test_imagenet_app_across_two_ranks(tmp_path):
    from sparknet_tpu_torch.apps import imagenet_app

    argv = ["--device", "cpu", "--workers", "2", "--tau", "2", "--rounds",
            "1", "--full_size", "72", "--crop", "67", "--train_batch", "2",
            "--test_batch", "2", "--test_every", "1"]
    text = _launch(tmp_path, "imagenet", *argv)
    assert "numTrainMinibatches" in text
    one = {}
    assert imagenet_app.main(argv, result=one) == 0
    assert float(_last(r"smoothed_loss (\S+)", text)) == pytest.approx(
        one["smoothed_loss"], abs=5e-5)
    assert float(_last(r"final accuracy (\S+)%", text)) == pytest.approx(
        one["accuracies"][-1] * 100, abs=5e-3)


@pytest.mark.parametrize("argv,what", [
    (["--nprocs", "2", "--devices_per_host", "2", "lm", "--device", "cpu",
      "--sp", "2"], "lm across 2 processes"),
    (["--nprocs", "2", "featurizer"], "featurizer across 2 processes"),
    (["--fleet_collector", "127.0.0.1:0", "cifar"], "--fleet_collector"),
])
def test_launch_refuses_what_is_not_yet_ported(argv, what, monkeypatch,
                                               capsys):
    """What the launcher has not ported refuses, naming it;
    ``--fleet_collector`` (once refused) runs: the children ship to the
    launcher's collector (here fake children, which never push, so the
    summary lists no host)."""
    if what == "--fleet_collector":
        from tests.test_torch_launch_slices import _fake_popen

        spawned = _fake_popen(monkeypatch, life=0.2)
        assert launch.main(["--nprocs", "2"] + argv) == 0
        out = capsys.readouterr().out
        assert "launch: fleet collector on http://127.0.0.1:" in out
        assert "launch: fleet summary — 0 host(s)" in out
        for pid, p in enumerate(spawned):
            assert p.env["SPARKNET_HOST_ID"] == f"host{pid}"
            assert any(a.startswith("--ship_to=http://127.0.0.1:")
                       for a in p.cmd)
        return
    with pytest.raises(SystemExit, match="not yet ported") as e:
        launch.main(argv)
    assert what in str(e.value)


@pytest.mark.parametrize("action", ["provision", "describe", "run", "ssh",
                                    "teardown"])
def test_launch_dispatches_lifecycle_actions_to_the_plan(action, capsys):
    """``launch <action> --dry-run ...`` (once refused) prints the
    action's ``tools/provision.py`` plan and exits 0."""
    from sparknet_tpu_torch.tools import provision

    flags = ["--name", "gpu", "--num_hosts", "2", "--worker", "1"]
    app = ["--", "cifar", "--rounds", "1"] if action == "run" else []
    assert launch.main([action, "--dry-run", *flags, *app]) == 0
    plan = provision.command_plan(action, provision.make_parser().parse_args(
        flags), app[1:])
    assert capsys.readouterr().out == provision.format_plan(plan) + "\n"
    assert plan and all(cmd[0] == "gcloud" for cmd in plan)
