"""Cluster lifecycle for a set of GPU hosts — the create/describe/destroy
half of L8.

The port of ``sparknet_tpu/tools/provision.py`` (reference:
``ec2/spark_ec2.py``).  The JAX package creates one Cloud TPU slice, runs
one ``gcloud ... ssh --worker=all`` line, and ``jax.distributed`` finds
the layout from the slice.  A set of GPU hosts is N separate Compute
Engine VMs, ``NAME-0`` ... ``NAME-{N-1}``, with nothing to find: each
host's launcher is told the coordinator (``NAME-0`` at
``--coordinator_port``, as the VPC's internal DNS resolves it;
``--coordinator_host`` overrides it), the world size and its own rank
(``tools/launch.py``'s ``--coordinator/--num_processes/--process_id``
mode, one process a host)::

    provision  ->  one `instances create` over every name (an A3 H100
                   machine type, a Deep Learning VM image with PyTorch and
                   CUDA), wait for each host's status RUNNING, deploy the
                   repo to every host
    describe   ->  one host's instance record (--worker)
    run        ->  the launcher on every host as rank i of N, the N ssh
                   sessions at once
    ssh        ->  interactive shell on one host (--worker)
    teardown   ->  one `instances delete` over every name

Every action resolves to an exact ``gcloud`` command sequence from
``command_plan`` — a pure function, so tests (and ``--dry-run``) can
assert the sequence without a cloud project.  ``--dry-run`` prints one
shell-quoted command per line and executes nothing::

    python -m sparknet_tpu_torch.tools.launch provision --dry-run \\
        --name sparknet-h100 --zone us-central1-a --num_hosts 2
    python -m sparknet_tpu_torch.tools.launch run --dry-run \\
        --name sparknet-h100 --num_hosts 2 -- imagenet --data /mnt/imagenet

``run`` starts the N sessions concurrently (one after another, host 0
would wait forever in its join for peers not yet started), prefixes each
host's output ``[host i]``, and when one session fails terminates the
others (each session's local process group) and returns the first
failing exit code.  GPU VMs need ``--maintenance-policy TERMINATE``;
a Compute Engine instance reports ``status`` (``RUNNING``), never the
TPU's ``READY``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

ACTIONS = ("provision", "describe", "run", "ssh", "teardown")

DEFAULT_MACHINE_TYPE = "a3-highgpu-1g"  # one H100 80GB a host
# Deep Learning VM images: PyTorch and CUDA; the metadata key makes the
# image install the NVIDIA driver on first boot
IMAGE_PROJECT = "deeplearning-platform-release"
DEFAULT_IMAGE_FAMILY = "pytorch-latest-gpu"
DEFAULT_REMOTE_DIR = "~/sparknet_tpu"
DEFAULT_COORDINATOR_PORT = 8476
# the wait for RUNNING: one describe a host every POLL_S seconds, at most
# POLL_TRIES times
POLL_S = 10.0
POLL_TRIES = 90
# statuses from which waiting will not reach RUNNING
_DEAD_STATUSES = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED",
                  "TERMINATED")
_STATUS_FORMAT = "--format=value(status)"


def host_names(opts) -> List[str]:
    return [f"{opts.name}-{i}" for i in range(opts.num_hosts)]


def coordinator(opts) -> str:
    """``host:port`` of rank 0: ``NAME-0`` unless overridden."""
    host = opts.coordinator_host or host_names(opts)[0]
    return f"{host}:{opts.coordinator_port}"


def shell_path(path: str) -> str:
    """``path`` quoted for the remote shell, a leading ``~/`` left bare so
    that the shell still expands it."""
    if path == "~" or path.startswith("~/"):
        rest = path[2:]
        return "~/" + shlex.quote(rest) if rest else "~"
    return shlex.quote(path)


def run_line(opts, rank: int, app_argv: List[str]) -> str:
    """The shell line host ``rank`` runs: the launcher as rank ``rank``
    of ``--num_hosts``, then the forwarded argv (launcher flags such as
    ``--backend gloo`` may open it)."""
    return " ".join(
        ["cd", shell_path(opts.remote_dir), "&&", "python", "-m",
         "sparknet_tpu_torch.tools.launch", "--coordinator",
         shlex.quote(coordinator(opts)), "--num_processes",
         str(opts.num_hosts), "--process_id", str(rank)]
        + [shlex.quote(a) for a in app_argv]
    )


def command_plan(
    action: str, opts, app_argv: Optional[List[str]] = None
) -> List[List[str]]:
    """The exact gcloud command sequence for one action (pure; no I/O).
    ``run`` gives one command a host, which ``main`` starts at once."""
    base = ["gcloud"]
    if opts.project:
        base += ["--project", opts.project]
    base += ["compute"]
    zone = ["--zone", opts.zone]
    names = host_names(opts)
    if action == "provision":
        create = base + [
            "instances", "create", *names, *zone,
            "--machine-type", opts.machine_type,
            "--maintenance-policy", "TERMINATE",
            "--image-project", IMAGE_PROJECT,
            "--image-family", opts.image_family,
            "--metadata", "install-nvidia-driver=True",
        ]
        if opts.spot:
            create += ["--provisioning-model", "SPOT"]
        if opts.network:
            create += ["--network", opts.network]
        plan = [create]
        # create returns once the instances exist; each host's status is
        # polled until RUNNING (the wait_for_cluster_state analog)
        plan += [base + ["instances", "describe", n, *zone, _STATUS_FORMAT]
                 for n in names]
        # deploy the framework to every host (deploy_files analog).  scp
        # --recurse into an EXISTING dir would nest the copy one level
        # down (stale code on redeploy), so clear first
        for n in names:
            plan.append(base + ["ssh", n, *zone, "--command",
                                f"rm -rf {shell_path(opts.remote_dir)}"])
            plan.append(base + ["scp", "--recurse", opts.repo,
                                f"{n}:{opts.remote_dir}", *zone])
        return plan
    if action == "describe":
        return [base + ["instances", "describe", names[opts.worker], *zone]]
    if action == "run":
        return [base + ["ssh", n, *zone, "--command",
                        run_line(opts, i, app_argv or [])]
                for i, n in enumerate(names)]
    if action == "ssh":
        return [base + ["ssh", names[opts.worker], *zone]]
    if action == "teardown":
        return [base + ["instances", "delete", *names, *zone, "--quiet"]]
    raise ValueError(f"unknown action {action!r}")


def format_plan(plan: List[List[str]]) -> str:
    return "\n".join(shlex.join(cmd) for cmd in plan)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="launch provision|describe|run|ssh|teardown",
        description=__doc__.split("\n", 1)[0],
    )
    p.add_argument("--name", default="sparknet",
                   help="host name prefix: NAME-0 ... NAME-{N-1}")
    p.add_argument("--num_hosts", type=int, default=2)
    p.add_argument("--zone", default="us-central1-a")
    p.add_argument("--project", default=None)
    p.add_argument("--machine_type", default=DEFAULT_MACHINE_TYPE)
    p.add_argument("--image_family", default=DEFAULT_IMAGE_FAMILY,
                   help="Deep Learning VM image family (PyTorch and CUDA)")
    p.add_argument("--spot", action="store_true",
                   help="preemptible capacity (spark_ec2 --spot-price analog)")
    p.add_argument("--network", default=None)
    p.add_argument("--repo", default=".", help="local repo dir to deploy")
    p.add_argument("--remote_dir", default=DEFAULT_REMOTE_DIR)
    p.add_argument("--coordinator_host", default=None,
                   help="rank 0's address as the hosts reach it (default "
                   "NAME-0, resolved by the VPC's internal DNS)")
    p.add_argument("--coordinator_port", type=int,
                   default=DEFAULT_COORDINATOR_PORT)
    p.add_argument("--worker", type=int, default=0,
                   help="host index for describe and ssh")
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   help="print the exact command sequence; execute nothing")
    return p


def main(action: str, argv: List[str]) -> int:
    # `run` forwards everything after `--` to each host's launcher
    argv = list(argv)
    app_argv: List[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, app_argv = argv[:cut], argv[cut + 1:]
    parser = make_parser()
    opts = parser.parse_args(argv)
    if opts.num_hosts < 1:
        parser.error("--num_hosts must be >= 1")
    if opts.remote_dir.rstrip("/") in ("", "~", "."):
        # provision clears it before the copy: never a home or a root
        parser.error(f"--remote_dir {opts.remote_dir!r} is not a directory "
                     "of its own")
    if not 0 <= opts.worker < opts.num_hosts:
        parser.error(f"--worker {opts.worker} outside 0..{opts.num_hosts - 1}")
    if action == "run" and not app_argv:
        parser.error("run needs the app and its arguments after --")
    plan = command_plan(action, opts, app_argv)
    if opts.dry_run:
        print(format_plan(plan))
        return 0
    if action == "run":
        return run_hosts(plan)
    for cmd in plan:
        print("+ " + shlex.join(cmd), file=sys.stderr)
        if cmd[-1] == _STATUS_FORMAT:
            rc = _wait_running(cmd)
        else:
            rc = subprocess.call(cmd)
        if rc != 0:
            return rc
    return 0


def _wait_running(cmd: List[str]) -> int:
    """Poll one host's status until RUNNING (spark_ec2.py
    wait_for_cluster_state analog); 1 on a status that will not get
    there, or after ``POLL_TRIES`` polls."""
    host = cmd[cmd.index("describe") + 1]
    for i in range(POLL_TRIES):
        r = subprocess.run(cmd, capture_output=True, text=True)
        status = r.stdout.strip()
        if r.returncode == 0 and status == "RUNNING":
            print(f"{host} status: RUNNING", file=sys.stderr)
            return 0
        if status in _DEAD_STATUSES:
            print(f"{host} status: {status}: it will not reach RUNNING",
                  file=sys.stderr)
            return 1
        print(f"{host} status: {status or r.stderr.strip()!r} "
              f"(waiting, {i + 1}/{POLL_TRIES})", file=sys.stderr)
        time.sleep(POLL_S)
    print(f"{host}: timed out waiting for RUNNING", file=sys.stderr)
    return 1


def _stop_group(p: subprocess.Popen) -> None:
    """End a session and everything it started (its process group)."""
    for sig, wait in ((signal.SIGTERM, 10), (signal.SIGKILL, 10)):
        if p.poll() is not None:
            return
        try:
            os.killpg(p.pid, sig)
        except ProcessLookupError:
            return
        try:
            p.wait(timeout=wait)
        except subprocess.TimeoutExpired:
            continue


def run_hosts(plan: List[List[str]], out=None) -> int:
    """Start every host's session at once, each in a process group of
    its own, and print its lines as they come, prefixed ``[host i]``.
    When a session fails the others are terminated; returns the first
    failing exit code, else 0."""
    out = out or sys.stdout
    lock = threading.Lock()
    procs: List[subprocess.Popen] = []
    pumps: List[threading.Thread] = []

    def pump(i: int, p: subprocess.Popen) -> None:
        for line in p.stdout:
            with lock:
                out.write(f"[host {i}] {line.rstrip(chr(10))}\n")
                out.flush()

    failed = None
    try:
        for i, cmd in enumerate(plan):
            print("+ " + shlex.join(cmd), file=sys.stderr)
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 start_new_session=True)
            procs.append(p)
            t = threading.Thread(target=pump, args=(i, p),
                                 name=f"provision-host{i}", daemon=True)
            t.start()
            pumps.append(t)
        while failed is None:
            codes = [p.poll() for p in procs]
            failed = next(((i, c) for i, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is None and None not in codes:
                break
            time.sleep(0.05)
    finally:
        peers = [i for i, p in enumerate(procs) if p.poll() is None]
        for i in peers:
            _stop_group(procs[i])
        for t in pumps:
            t.join(timeout=30)
        if peers:
            why = (f"host {failed[0]} failed (rc {failed[1]})"
                   if failed else "the run was interrupted")
            print(f"provision: {why}; terminated host(s) {peers}",
                  file=sys.stderr)
    return failed[1] if failed else 0
