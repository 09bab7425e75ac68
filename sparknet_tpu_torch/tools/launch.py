"""The launcher: one process per host (or per card), joined, then the app.

The port of ``sparknet_tpu/tools/launch.py`` (reference:
``ec2/spark_ec2.py`` + ``SETUP.md``): start one process per card,
join them through ``torch.distributed``
(``parallel/mesh.initialize_distributed``), and run the app, which sees
the joined world and loads only its own workers' partitions
(``parallel.local_worker_slice``).

Local (N processes on this machine; ``--device`` is the app's)::

    python -m sparknet_tpu_torch.tools.launch --nprocs 2 cifar \\
        --device cpu --rounds 3 --tau 2                # gloo, CPU ranks
    python -m sparknet_tpu_torch.tools.launch --nprocs 2 cifar \\
        --rounds 3                                     # NCCL, a card each
    python -m sparknet_tpu_torch.tools.launch --nprocs 2 --backend gloo \\
        cifar --device cuda:0 --rounds 3               # two ranks, one card

One process per real host (the same line on every host; the process is
local rank 0 of 1 on its host unless ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
say otherwise)::

    python -m sparknet_tpu_torch.tools.launch --coordinator 10.0.0.2:8476 \\
        --num_processes 4 --process_id $RANK imagenet --data /mnt/imagenet

The cluster lifecycle actions come first and go to
``tools/provision.py`` (Compute Engine GPU hosts through ``gcloud``;
``run`` starts the line above on every host)::

    python -m sparknet_tpu_torch.tools.launch provision|describe|run|ssh|teardown \\
        [--dry-run] --name NAME --num_hosts N ... [-- APP ARGS]

The backend rule (``parallel/mesh.py``): NCCL when every rank has a card
of its own, gloo for CPU ranks, and ranks that share a card refuse to
join unless ``--backend gloo`` says so.  Each local rank takes
``cuda:<rank>`` unless the app's ``--device`` pins a card;
``--devices_per_host`` is the number of workers each process stacks on
its device (the app's ``--workers`` must be ``nprocs x`` that).
``cifar``, ``imagenet`` and ``lm`` (its dp x sp mesh, one sequence shard
a rank at ``--sp`` > 1) have a multi-process mode, as in the JAX
package, and so does ``train`` (``cli train --devices N``, which spawns
its ranks through ``spawn_local``: synchronous gradient all-reduce on the
global batch); the other apps refuse a world above one process.

Slices of processes (``--slices N``, contiguous blocks of ``--nprocs``:
``proc_slice_members``): each child learns its slice through
``$SPARKNET_SLICE_ID``, which an ``--elastic`` app's SIGTERM hook marks
leaving.  ``--preempt_slice S --preempt_at T`` sends SIGTERM to every
live process of slice S after T seconds (the orchestrator's preemption
notice); ``--relaunch_after R`` seconds later any victim still running
is killed and reaped, and the same ``--process_id``s are spawned again
with ``$SPARKNET_RELAUNCHED=1`` (skipped once the run's deadline has
passed).  A preempted incarnation's exit code is not a failure.  A
``torch.distributed`` group has a fixed world size and takes no new
member, so a relaunched process exits at once, saying so, and the
survivors of a hard-killed peer fail in their next collective with
``mesh.PeerLost`` naming it (within the group's timeout,
``mesh.JOIN_TIMEOUT_S``).

``--fleet_collector [HOST:PORT]`` starts the fleet collector
(``obs/fleet.py``) in the launcher, appends ``--ship_to=<its url>`` to
every child's app argv, gives child ``pid`` the fleet identity
``$SPARKNET_HOST_ID=host<pid>`` (the same across a relaunch, so the
collector sees the host come back with a new boot id) and prints the
merged live/late/dead summary at the end.
"""

from __future__ import annotations

import argparse
import os
import sys

APPS = {
    "cifar": "sparknet_tpu_torch.apps.cifar_app",
    "imagenet": "sparknet_tpu_torch.apps.imagenet_app",
    "cifar_db": "sparknet_tpu_torch.apps.cifar_db_app",
    "imagenet_create_db": "sparknet_tpu_torch.apps.imagenet_create_db_app",
    "imagenet_run_db": "sparknet_tpu_torch.apps.imagenet_run_db_app",
    "featurizer": "sparknet_tpu_torch.apps.featurizer_app",
    "lm": "sparknet_tpu_torch.apps.lm_app",
    "train": "sparknet_tpu_torch.tools.cli",  # ``cli train``'s arguments
}
# the apps whose JAX counterparts run across processes
MULTIPROCESS_APPS = ("cifar", "imagenet", "lm", "train")
# the exit code of a run refused before any child spawned
USAGE_RC = 2


def proc_slice_members(nprocs: int, slices: int):
    """Contiguous process -> slice grouping, the simulated-pod topology
    rule (``HierarchySpec.grouped`` over the processes; more slices than
    processes clamps)."""
    from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec

    return HierarchySpec.grouped(nprocs, max(1, slices)).slices


def requested_device(app_argv) -> str:
    """The app's ``--device`` (``cuda`` when it names none): the device
    the rank joins with."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    return p.parse_known_args(list(app_argv))[0].device


def _app_int(app_argv, flag: str, default: int) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument(flag, type=int, default=default)
    return getattr(p.parse_known_args(list(app_argv))[0], flag.lstrip("-"))


def refuse_world(app: str, num_processes, app_argv=(),
                 devices_per_host: int = 1) -> None:
    n = num_processes or 1
    if n > 1 and app not in MULTIPROCESS_APPS:
        raise SystemExit(
            f"launch: {app} across {num_processes} processes is not yet "
            "ported to sparknet_tpu_torch (its JAX counterpart has no "
            f"multi-process mode; these do: {', '.join(MULTIPROCESS_APPS)})"
        )
    sp = _app_int(app_argv, "--sp", 1) if app == "lm" else 1
    if n > 1 and sp > 1 and devices_per_host > 1:
        raise SystemExit(
            f"launch: lm across {n} processes with --sp {sp} holds one "
            "sequence shard a rank; stacking --devices_per_host "
            f"{devices_per_host} slots a rank is not yet ported to "
            "sparknet_tpu_torch")


def run_app(app: str, app_argv, coordinator=None, num_processes=None,
            process_id=None, backend=None) -> int:
    """Join the runtime on the app's ``--device`` (one process without a
    coordinator, a world size or ``MASTER_ADDR``), then hand off to the
    app's ``main()``; leave the runtime when it returns."""
    import importlib

    from sparknet_tpu_torch.parallel import mesh

    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    refuse_world(app, world, app_argv,
                 int(os.environ.get("SPARKNET_LOCAL_WORKERS", "1")))
    if world > 1 and os.environ.get("SPARKNET_RELAUNCHED") == "1":
        raise SystemExit(
            f"launch: process_id {process_id} was relaunched "
            "(SPARKNET_RELAUNCHED=1), but a torch.distributed group of fixed "
            f"world size {world} takes no new member: it cannot re-enter the "
            "run (its survivors stop with mesh.PeerLost)")
    joined = False
    if coordinator or num_processes is not None or "MASTER_ADDR" in os.environ:
        if coordinator or num_processes is not None:
            # one host of a real cluster: the only rank on its host,
            # unless its environment (the local spawn's) says otherwise
            os.environ.setdefault("LOCAL_RANK", "0")
            os.environ.setdefault("LOCAL_WORLD_SIZE", "1")
        mesh.initialize_distributed(coordinator, num_processes, process_id,
                                    backend=backend,
                                    device=requested_device(app_argv))
        joined = True
        if mesh.process_index() == 0:
            print(f"launch: {mesh.process_count()} process(es) joined over "
                  f"{mesh.joined_backend()}", flush=True)
    try:
        mod = importlib.import_module(APPS[app])
        argv = (["train"] if app == "train" else []) + list(app_argv)
        return int(mod.main(argv) or 0)
    finally:
        if joined:
            mesh.shutdown()


def spawn_local(args, app_argv) -> int:
    """``_spawn_local_procs`` under ``--fleet_collector``: the collector
    runs in this process for the whole run and every child ships to it
    (``--ship_to`` appended to each app argv); it is closed however the
    run ends."""
    collector = None
    if getattr(args, "fleet_collector", None):
        from sparknet_tpu_torch.obs.fleet import FleetCollector, parse_hostport

        chost, cport = parse_hostport(args.fleet_collector)
        collector = FleetCollector(host=chost, port=cport).start()
        print(f"launch: fleet collector on {collector.url}/fleet", flush=True)
        app_argv = list(app_argv) + [f"--ship_to={collector.url}"]
    try:
        return _spawn_local_procs(args, app_argv, collector)
    finally:
        if collector is not None:
            collector.close()


def print_fleet_summary(collector) -> None:
    """The end-of-run fleet view: host counts by state (a host whose
    shipper sent its final push on a clean exit reads ``finished``), the
    round skew, and each host's state, round and push age."""
    view = collector.fleet_view()
    f = view["fleet"]
    print("launch: fleet summary — %d host(s): %d live, %d late, %d dead, "
          "%d finished; round skew %s"
          % (f["hosts_total"], f["hosts_live"], f["hosts_late"],
             f["hosts_dead"], f["hosts_finished"], f["round_skew"]))
    for h, st in sorted(view["hosts"].items()):
        print("launch:   %s is %s (round %s, last push %.1fs ago)"
              % (h, st["state"], st["round"], st["last_push_age_s"]))
    sys.stdout.flush()


def _spawn_local_procs(args, app_argv, collector=None) -> int:
    """N OS processes on this machine, joined through ``--coordinator``
    (a ``file://`` store or ``host:port``; a probed loopback port by
    default), spawned and reaped through ``utils.procs.Children``:
    every child's pipe is drained concurrently, and a child that fails
    (not a deliberately preempted one) ends the wait and has its peers
    killed rather than left in a collective.  Each child learns its
    slice (``$SPARKNET_SLICE_ID``); ``--preempt_slice`` runs the slice's
    preemption and relaunch on a thread while the wait goes on over the
    growing list.  Each child's lines are printed after it, prefixed
    ``[host <pid>]``.  Returns ``USAGE_RC`` for a ``--preempt_slice`` out
    of range (before any spawn), else the code of the first child that
    failed on its own, else 1 when children were killed at the timeout
    or after a failed peer, else 0."""
    import signal
    import subprocess
    import threading
    import time

    from sparknet_tpu_torch.utils import procs

    refuse_world(args.app, args.nprocs, app_argv, args.devices_per_host)
    slices = proc_slice_members(args.nprocs, getattr(args, "slices", 1))
    slice_of = {pid: i for i, members in enumerate(slices) for pid in members}
    preempt = getattr(args, "preempt_slice", None)
    if preempt is not None and not 0 <= preempt < len(slices):
        print(f"launch: --preempt_slice={preempt} out of range (have "
              f"{len(slices)} slice(s))", file=sys.stderr)
        return USAGE_RC
    coordinator = args.coordinator or f"127.0.0.1:{procs.free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env_base = {
        **os.environ,
        "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "LOCAL_WORLD_SIZE": str(args.nprocs),
        "SPARKNET_LOCAL_WORKERS": str(args.devices_per_host),
    }
    tail = [f"--backend={args.backend}"] if args.backend else []
    kids = procs.Children()
    # set once the wait has ended: the preemption thread spawns nothing
    # after it (the lock orders its check against the last kill)
    stopping = threading.Event()
    spawn_lock = threading.Lock()

    def spawn(pid: int, relaunched: bool = False):
        env = {**env_base, "LOCAL_RANK": str(pid),
               "SPARKNET_SLICE_ID": str(slice_of[pid])}
        if collector is not None:
            # a stable fleet identity, the same across a relaunch
            env["SPARKNET_HOST_ID"] = f"host{pid}"
        if relaunched:
            env["SPARKNET_RELAUNCHED"] = "1"
        kids.spawn(pid, [
            sys.executable, "-m", "sparknet_tpu_torch.tools.launch",
            f"--coordinator={coordinator}", f"--num_processes={args.nprocs}",
            f"--process_id={pid}", *tail, args.app, *app_argv], env)

    deadline = time.time() + args.timeout

    def say(line: str) -> None:
        print(line, flush=True)

    def do_preempt():
        members = slices[preempt]
        time.sleep(args.preempt_at or 0.0)
        victims = [e for e in kids.snapshot()
                   if e["pid"] in members and e["proc"].poll() is None]
        if stopping.is_set() or not victims:
            # the run ended (or failed) first: there is nothing to
            # preempt, and a relaunch would start the app from scratch
            say(f"launch: slice {preempt} preemption skipped (no live "
                "process in the slice)")
            return
        for e in victims:
            kids.forgiven.add(id(e["proc"]))
            e["proc"].send_signal(signal.SIGTERM)
        say(f"launch: slice {preempt} preempted (SIGTERM to host(s) "
            f"{sorted(e['pid'] for e in victims)})")
        if args.relaunch_after is None:
            return
        time.sleep(args.relaunch_after)
        if stopping.is_set() or time.time() >= deadline:
            say(f"launch: slice {preempt} relaunch skipped (the run "
                "ended or its deadline passed)")
            return
        # escalation: a victim that took the SIGTERM as a notice and
        # kept running (an --elastic child does) is killed and reaped
        # before its replacement takes the same --process_id
        for e in victims:
            if e["proc"].poll() is None:
                e["proc"].kill()
        for e in victims:
            try:
                e["proc"].wait(timeout=30)
            # sparknet: except-ok(best-effort reap of a killed victim; the final wait owns reaping and rc accounting)
            except subprocess.TimeoutExpired:
                pass
        with spawn_lock:
            if stopping.is_set():
                say(f"launch: slice {preempt} relaunch skipped (the run "
                    "ended while its victims were reaped)")
                return
            for pid in members:
                spawn(pid, relaunched=True)
        say(f"launch: slice {preempt} relaunched (host(s) {sorted(members)})")

    for pid in range(args.nprocs):
        spawn(pid)
    thread = None
    if preempt is not None:
        thread = threading.Thread(target=do_preempt, name="launch-preempt",
                                  daemon=True)
        thread.start()
    killed, timed_out = [], True
    try:
        killed, timed_out = kids.wait(
            deadline, busy=lambda: thread is not None and thread.is_alive())
    finally:
        with spawn_lock:
            stopping.set()
        killed = sorted(set(killed) | set(kids.kill_all()))
    if thread is not None:
        thread.join(timeout=5)
    for e in kids.snapshot():
        sys.stdout.write("".join(f"[host {e['pid']}] {line.rstrip(chr(10))}\n"
                                 for line in e["buf"]))
    if killed:
        why = f"the {args.timeout} s timeout" if timed_out else "a failed peer"
        sys.stdout.write(f"launch: killed host(s) {killed} after {why}\n")
    sys.stdout.flush()
    if collector is not None:
        print_fleet_summary(collector)
    failed = [e["proc"].returncode for e in kids.snapshot()
              if e["proc"].returncode != 0 and id(e["proc"]) not in kids.killed
              and id(e["proc"]) not in kids.forgiven]
    return failed[0] if failed else (1 if killed else 0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # cluster lifecycle actions (spark_ec2.py real_main action dispatch
    # analog) live in tools/provision.py: `launch provision --dry-run ...`
    from sparknet_tpu_torch.tools import provision

    if argv and argv[0] in provision.ACTIONS:
        return provision.main(argv[0], argv[1:])
    parser = argparse.ArgumentParser(
        prog="sparknet_tpu_torch.tools.launch",
        description=__doc__.split("\n", 1)[0],
        epilog="cluster lifecycle actions (dispatched before app launch): "
        "launch provision|describe|run|ssh|teardown [--dry-run] ... — see "
        "`launch provision --help`")
    parser.add_argument(
        "--nprocs", type=int, default=0,
        help="spawn N local processes; 0 = this process IS one host of a "
        "real cluster")
    parser.add_argument(
        "--devices_per_host", type=int, default=1,
        help="workers each spawned process stacks on its device (the "
        "app's --workers must be nprocs x this)")
    parser.add_argument(
        "--backend", choices=("gloo", "nccl"), default=None,
        help="the collective backend: default NCCL when each rank has a "
        "card of its own, gloo for CPU ranks; ranks that share a card "
        "need --backend gloo")
    parser.add_argument(
        "--coordinator", default=None,
        help="host:port of process 0, or a file:// store (default: a "
        "probed loopback port with --nprocs)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--timeout", type=int, default=1200)
    parser.add_argument(
        "--slices", type=int, default=1,
        help="group the spawned processes into N contiguous slices; each "
        "child gets its slice in $SPARKNET_SLICE_ID")
    parser.add_argument(
        "--preempt_slice", type=int, default=None,
        help="SIGTERM every live process of this slice at --preempt_at "
        "seconds (a preemption notice)")
    parser.add_argument("--preempt_at", type=float, default=None)
    parser.add_argument(
        "--relaunch_after", type=float, default=None,
        help="seconds after the preemption: kill and reap the victims "
        "still running, then spawn the same --process_ids again with "
        "$SPARKNET_RELAUNCHED=1")
    parser.add_argument(
        "--fleet_collector", nargs="?", default=None, const="127.0.0.1:0",
        metavar="HOST:PORT",
        help="start the fleet collector (obs/fleet.py) in the launcher and "
        "ship every child's telemetry to it (appends --ship_to to each app "
        "argv); prints the merged live/late/dead summary at the end")
    parser.add_argument("app", choices=sorted(APPS))
    parser.add_argument("app_argv", nargs=argparse.REMAINDER,
                        help="arguments passed through to the app")
    args = parser.parse_args(argv)
    if args.preempt_slice is not None and not args.nprocs:
        raise SystemExit("launch: --preempt_slice needs --nprocs (the "
                         "launcher spawns the slice it preempts)")
    app_argv = [a for a in args.app_argv if a != "--"]
    if args.nprocs:
        return spawn_local(args, app_argv)
    return run_app(args.app, app_argv, args.coordinator, args.num_processes,
                   args.process_id, args.backend)


if __name__ == "__main__":
    raise SystemExit(main())
