"""The cluster lifecycle for GPU hosts (``tools/provision.py``, through
``tools/launch.py``): the exact ``--dry-run`` sequence of each action,
``command_plan`` as a pure function, and the actions executed against a
fake ``gcloud`` first on ``PATH`` (``utils/procs.write_fake_gcloud``; no
test runs a real one): ``provision`` polling a host's status until
``RUNNING``, ``run`` starting every host before any ends, a failing
host's exit code returned with its peers terminated, and ``run`` on two
real gloo CPU ranks bit for bit the stacked one-process run.
"""

import concurrent.futures
import os
import time

import numpy as np
import pytest

from sparknet_tpu_torch.tools import launch, provision
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z = "--zone us-central1-a"
DRY = {
    "provision": [
        f"gcloud compute instances create sparknet-0 sparknet-1 {Z} "
        "--machine-type a3-highgpu-1g --maintenance-policy TERMINATE "
        "--image-project deeplearning-platform-release --image-family "
        "pytorch-latest-gpu --metadata install-nvidia-driver=True",
        f"gcloud compute instances describe sparknet-0 {Z} "
        "'--format=value(status)'",
        f"gcloud compute instances describe sparknet-1 {Z} "
        "'--format=value(status)'",
        f"gcloud compute ssh sparknet-0 {Z} --command 'rm -rf ~/sparknet_tpu'",
        f"gcloud compute scp --recurse . 'sparknet-0:~/sparknet_tpu' {Z}",
        f"gcloud compute ssh sparknet-1 {Z} --command 'rm -rf ~/sparknet_tpu'",
        f"gcloud compute scp --recurse . 'sparknet-1:~/sparknet_tpu' {Z}",
    ],
    "describe": [f"gcloud compute instances describe sparknet-1 {Z}"],
    "run": [
        f"gcloud compute ssh sparknet-{i} {Z} --command 'cd ~/sparknet_tpu "
        "&& python -m sparknet_tpu_torch.tools.launch --coordinator "
        f"sparknet-0:8476 --num_processes 2 --process_id {i} --backend gloo "
        "cifar --rounds 3'" for i in range(2)],
    "ssh": [f"gcloud compute ssh sparknet-1 {Z}"],
    "teardown": [
        f"gcloud compute instances delete sparknet-0 sparknet-1 {Z} --quiet"],
}


def _opts(*argv):
    return provision.make_parser().parse_args(list(argv))


@pytest.mark.parametrize("action", provision.ACTIONS)
def test_dry_run_prints_the_exact_sequence(action, capsys, monkeypatch):
    def no_call(*a, **k):
        raise AssertionError("--dry-run executed a command")

    for name in ("Popen", "run", "call"):
        monkeypatch.setattr(provision.subprocess, name, no_call)
    argv = [action, "--dry-run", "--worker", "1"]
    if action == "run":
        argv += ["--", "--backend", "gloo", "cifar", "--rounds", "3"]
    assert launch.main(argv) == 0
    assert capsys.readouterr().out.splitlines() == DRY[action]


def test_command_plan_is_pure_and_takes_the_options():
    opts = _opts("--name", "h", "--num_hosts", "3", "--project", "p",
                 "--zone", "z", "--spot", "--network", "n", "--machine_type",
                 "a3-highgpu-8g", "--image_family", "fam", "--repo", "/src",
                 "--remote_dir", "/opt/sn")
    plan = provision.command_plan("provision", opts)
    assert plan == provision.command_plan("provision", opts)
    create = plan[0]
    assert create[:8] == ["gcloud", "--project", "p", "compute", "instances",
                          "create", "h-0", "h-1"]
    assert create[8] == "h-2" and create[-4:] == [
        "--provisioning-model", "SPOT", "--network", "n"]
    assert ["--machine-type", "a3-highgpu-8g"] == create[
        create.index("--machine-type"):create.index("--machine-type") + 2]
    assert "fam" in create and "TERMINATE" in create
    assert [c[6] for c in plan[1:4]] == ["h-0", "h-1", "h-2"]
    assert plan[-1] == ["gcloud", "--project", "p", "compute", "scp",
                        "--recurse", "/src", "h-2:/opt/sn", "--zone", "z"]
    assert len(plan) == 1 + 3 + 2 * 3


def test_run_line_names_the_coordinator_the_world_and_the_rank():
    opts = _opts("--num_hosts", "3", "--coordinator_host", "10.0.0.2",
                 "--coordinator_port", "9000", "--remote_dir", "/w d")
    assert provision.coordinator(opts) == "10.0.0.2:9000"
    assert provision.coordinator(_opts()) == "sparknet-0:8476"
    line = provision.run_line(opts, 2, ["cifar", "--data", "/a b"])
    assert line == (
        "cd '/w d' && python -m sparknet_tpu_torch.tools.launch "
        "--coordinator 10.0.0.2:9000 --num_processes 3 --process_id 2 cifar "
        "--data '/a b'")
    deploy = provision.command_plan("provision", opts)[4]
    assert deploy[-2:] == ["--command", "rm -rf '/w d'"]
    home = _opts("--remote_dir", "~/my run")
    assert provision.run_line(home, 0, ["cifar"]).startswith(
        "cd ~/'my run' && ")
    assert provision.command_plan("provision", home)[3][-1] == \
        "rm -rf ~/'my run'"
    plan = provision.command_plan("run", opts, ["cifar"])
    assert [cmd[3] for cmd in plan] == ["sparknet-0", "sparknet-1",
                                        "sparknet-2"]
    assert [cmd[-1] for cmd in plan] == [
        provision.run_line(opts, i, ["cifar"]) for i in range(3)]


@pytest.mark.parametrize("argv,what", [
    (["describe", "--worker", "2"], "--worker 2 outside 0..1"),
    (["ssh", "--num_hosts", "0"], "--num_hosts must be >= 1"),
    (["run", "--dry-run"], "run needs the app"),
    (["provision", "--dry-run", "--remote_dir", "~/"],
     "--remote_dir '~/' is not a directory of its own"),
    (["provision", "--dry-run", "--remote_dir", "/"],
     "--remote_dir '/' is not a directory of its own"),
], ids=["worker", "num_hosts", "run_without_app", "remote_home",
        "remote_root"])
def test_refusals(argv, what, capsys):
    with pytest.raises(SystemExit) as e:
        launch.main(argv)
    assert e.value.code == 2
    assert what in capsys.readouterr().err


def _fake(tmp_path, monkeypatch, **env):
    bin_dir = procs.write_fake_gcloud(str(tmp_path / "bin"))
    log = str(tmp_path / "gcloud.jsonl")
    for k, v in procs.fake_gcloud_env(bin_dir, log, env).items():
        monkeypatch.setenv(k, v)
    return log


def test_provision_polls_each_host_until_running(tmp_path, monkeypatch):
    """The deploy's clear is recorded, never executed here: the remote
    directory (a real one on this machine) survives."""
    log = _fake(tmp_path, monkeypatch,
                FAKE_GCLOUD_STATUS="PROVISIONING,STAGING,RUNNING")
    monkeypatch.setattr(provision, "POLL_S", 0.0)
    remote = tmp_path / "remote"
    (remote / "keep").mkdir(parents=True)
    assert launch.main(["provision", "--num_hosts", "2", "--remote_dir",
                        str(remote)]) == 0
    assert (remote / "keep").is_dir()
    calls = [c["argv"] for c in procs.fake_gcloud_calls(log) if "start" in c]
    assert [c[-1] for c in calls if c[1] == "ssh"] == [
        f"rm -rf {remote}"] * 2
    verbs = [(c[1], c[2]) for c in calls]
    assert verbs == ([("instances", "create")]
                     + [("instances", "describe")] * 6
                     + [("ssh", "sparknet-0"), ("scp", "--recurse"),
                        ("ssh", "sparknet-1"), ("scp", "--recurse")])
    assert [c[3] for c in calls[1:7]] == ["sparknet-0"] * 3 + ["sparknet-1"] * 3


def test_provision_stops_at_a_host_that_will_not_run(tmp_path, monkeypatch,
                                                     capsys):
    log = _fake(tmp_path, monkeypatch,
                FAKE_GCLOUD_STATUS="PROVISIONING,TERMINATED")
    monkeypatch.setattr(provision, "POLL_S", 0.0)
    assert launch.main(["provision", "--num_hosts", "2"]) == 1
    calls = [c["argv"] for c in procs.fake_gcloud_calls(log) if "start" in c]
    assert len(calls) == 3 and not any("scp" in c for c in calls)
    assert "sparknet-0 status: TERMINATED: it will not reach RUNNING" in \
        capsys.readouterr().err


def _ssh_records(log):
    recs = [c for c in procs.fake_gcloud_calls(log) if "ssh" in c["argv"]]
    starts = {c["argv"][2]: c["start"] for c in recs if "start" in c}
    ends = {c["argv"][2]: c["end"] for c in recs if "end" in c}
    return starts, ends


def test_run_starts_every_host_before_any_ends(tmp_path, monkeypatch):
    log = _fake(tmp_path, monkeypatch, **{
        f"FAKE_GCLOUD_{k}_sparknet_{i}": v for i in range(3)
        for k, v in (("SLEEP", "1.0"), ("RC", "0"))})
    assert launch.main(["run", "--num_hosts", "3", "--", "cifar"]) == 0
    starts, ends = _ssh_records(log)
    assert len(starts) == len(ends) == 3
    assert max(starts.values()) < min(ends.values())


def test_a_failing_host_returns_its_rc_and_its_peers_are_terminated(
        tmp_path, monkeypatch, capsys):
    log = _fake(tmp_path, monkeypatch, FAKE_GCLOUD_RC_sparknet_1="3",
                FAKE_GCLOUD_SLEEP_sparknet_0="60",
                FAKE_GCLOUD_SLEEP_sparknet_2="60")
    t0 = time.time()
    assert launch.main(["run", "--num_hosts", "3", "--", "cifar"]) == 3
    assert time.time() - t0 < 30
    starts, ends = _ssh_records(log)
    assert set(starts) == {"sparknet-0", "sparknet-1", "sparknet-2"}
    assert set(ends) == {"sparknet-1"}  # the peers never finished
    assert ("provision: host 1 failed (rc 3); terminated host(s) [0, 2]"
            in capsys.readouterr().err)


def test_run_prefixes_each_hosts_lines(tmp_path, monkeypatch, capsys):
    """Each host's session runs its launcher line (here ``--help``, which
    exits at once) with its output prefixed ``[host i]``."""
    _fake(tmp_path, monkeypatch)
    monkeypatch.setenv("PYTHONPATH", REPO)
    assert launch.main(["run", "--num_hosts", "2", "--remote_dir", REPO,
                        "--", "--help"]) == 0
    out = capsys.readouterr().out.splitlines()
    for i in range(2):
        assert f"[host {i}] usage: sparknet_tpu_torch.tools.launch " \
            "[-h] [--nprocs NPROCS]" in out


def test_run_app_is_the_only_rank_of_its_host_in_cluster_mode(monkeypatch):
    """One launcher a host: rank 1 of 2 given ``--coordinator`` takes
    local rank 0 of 1 (its host's first card), unless the environment
    (the local spawn's) says otherwise."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.parallel import mesh

    seen = []
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    monkeypatch.setattr(launch.os, "environ", env)
    monkeypatch.setattr(mesh, "initialize_distributed", lambda *a, **k: seen.append(
        (env.get("LOCAL_RANK"), env.get("LOCAL_WORLD_SIZE"), a)))
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    monkeypatch.setattr(mesh, "shutdown", lambda: None)
    monkeypatch.setattr(cifar_app, "main", lambda argv: 0)
    assert launch.run_app("cifar", [], "10.0.0.2:8476", 2, 1) == 0
    env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"] = "1", "2"
    assert launch.run_app("cifar", [], "10.0.0.2:8476", 2, 1) == 0
    assert [s[:2] for s in seen] == [("0", "1"), ("1", "2")]


def test_run_trains_two_real_cpu_ranks_bit_for_bit(tmp_path):
    """``launch run --num_hosts 2 --coordinator_host 127.0.0.1 -- cifar
    --device cpu --workers 2 --tau 2 --rounds 2`` through the fake
    ``gcloud``: two gloo ranks started at once, each observed, bit for
    bit the stacked one-process run.  A sequential ``run`` would hang
    host 0 in its join: the subprocess has its own timeout."""
    app = ["cifar", "--device", "cpu", "--workers", "2", "--tau", "2",
           "--rounds", "2"]
    env = {"SPARKNET_LOG_DIR": str(tmp_path / "logs")}
    # the two runs side by side, each its own processes
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        run = pool.submit(
            procs.observed_provision_run,
            ["--num_hosts", "2", "--coordinator_host", "127.0.0.1",
             "--coordinator_port", str(procs.free_port()), "--remote_dir",
             REPO, "--", *app], str(tmp_path / "run"), REPO, env, 300)
        ref = pool.submit(procs.observed_launch, app, str(tmp_path / "one"),
                          REPO, env, 300)
        done, ranks, calls = run.result()
        one_done, (one,) = ref.result()
    assert done.returncode == 0, done.stdout + done.stderr
    assert one_done.returncode == 0, one_done.stdout + one_done.stderr
    assert "[host 0] launch: 2 process(es) joined over gloo" in done.stdout
    assert [r["rows"] for r in ranks] == [[0, 1], [1, 2]]
    for r in ranks:
        lo, hi = r["rows"]
        for got, want in zip(r["leaves"], one["leaves"], strict=True):
            np.testing.assert_array_equal(got, want[lo:hi])
        np.testing.assert_array_equal(r["losses"], one["losses"])
        for key in ("masks", "smoothed_loss", "accuracy", "code"):
            assert r[key] == one[key], key
    assert r["losses"].shape == (2, 2, 2) and np.isfinite(r["losses"]).all()
    ssh = [c for c in calls if "ssh" in c["argv"]]
    starts = [c["start"] for c in ssh if "start" in c]
    ends = [c["end"] for c in ssh if "end" in c]
    assert max(starts) < min(ends)


def test_provision_parser_matches_the_jax_flags_it_keeps():
    """The JAX lifecycle's flags the port keeps parse the same; the TPU's
    (--accelerator, --version) are gone, the hosts' added."""
    from sparknet_tpu.tools import provision as jprovision

    jdest = {a.dest for a in jprovision.make_parser()._actions}
    tdest = {a.dest for a in provision.make_parser()._actions}
    assert jdest - tdest == {"accelerator", "version"}
    assert tdest - jdest == {
        "num_hosts", "machine_type", "image_family", "coordinator_host",
        "coordinator_port"}
    assert jprovision.ACTIONS == provision.ACTIONS
