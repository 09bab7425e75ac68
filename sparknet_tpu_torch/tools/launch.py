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

One process per real host (the same line on every host)::

    python -m sparknet_tpu_torch.tools.launch --coordinator 10.0.0.2:8476 \\
        --num_processes 4 --process_id $RANK imagenet --data /mnt/imagenet

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
global batch); the other apps refuse a world above one process.  The
simulated-slice flags (``--slices``, ``--preempt_slice``,
``--preempt_at``, ``--relaunch_after``) and ``--fleet_collector`` are not
yet ported.
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
# the JAX launcher's lifecycle actions (tools/provision.py, not ported)
PROVISION_ACTIONS = ("provision", "describe", "run", "ssh", "teardown")
# (flag, default): the JAX launcher's flags of later work
_NOT_YET_PORTED = (("slices", 1), ("preempt_slice", None),
                   ("preempt_at", None), ("relaunch_after", None),
                   ("fleet_collector", None))


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
    joined = False
    if coordinator or num_processes is not None or "MASTER_ADDR" in os.environ:
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
    """N OS processes on this machine, joined through ``--coordinator``
    (a ``file://`` store or ``host:port``; a probed loopback port by
    default), spawned and reaped by ``utils.procs.reap_processes``:
    every child's pipe is drained concurrently, and a child that fails
    ends the wait and has its peers killed rather than left in a
    collective.  Each child's lines are printed after it, prefixed
    ``[host <pid>]``.  Returns the code of the first child that failed
    on its own, else 1 when children were killed at the timeout."""
    from sparknet_tpu_torch.utils import procs

    refuse_world(args.app, args.nprocs, app_argv, args.devices_per_host)
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
    cmds = [[sys.executable, "-m", "sparknet_tpu_torch.tools.launch",
             f"--coordinator={coordinator}", f"--num_processes={args.nprocs}",
             f"--process_id={pid}", *tail, args.app, *app_argv]
            for pid in range(args.nprocs)]
    envs = [{**env_base, "LOCAL_RANK": str(pid)} for pid in range(args.nprocs)]
    results, killed, timed_out = procs.reap_processes(cmds, envs, args.timeout)
    for pid, (rc, out) in sorted(results.items()):
        sys.stdout.write("".join(f"[host {pid}] {line}\n"
                                 for line in out.splitlines()))
    if killed:
        why = f"the {args.timeout} s timeout" if timed_out else "a failed peer"
        sys.stdout.write(f"launch: killed host(s) {killed} after {why}\n")
    sys.stdout.flush()
    failed = [rc for pid, (rc, _) in sorted(results.items())
              if rc != 0 and pid not in killed]
    return failed[0] if failed else (1 if killed else 0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in PROVISION_ACTIONS:
        raise SystemExit(f"launch: the cluster lifecycle action {argv[0]!r} "
                         "(tools/provision.py) is not yet ported to "
                         "sparknet_tpu_torch")
    parser = argparse.ArgumentParser(
        prog="sparknet_tpu_torch.tools.launch",
        description=__doc__.split("\n", 1)[0])
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
    parser.add_argument("--slices", type=int, default=1)
    parser.add_argument("--preempt_slice", type=int, default=None)
    parser.add_argument("--preempt_at", type=float, default=None)
    parser.add_argument("--relaunch_after", type=float, default=None)
    parser.add_argument("--fleet_collector", nargs="?", default=None,
                        const="127.0.0.1:0")
    parser.add_argument("app", choices=sorted(APPS))
    parser.add_argument("app_argv", nargs=argparse.REMAINDER,
                        help="arguments passed through to the app")
    args = parser.parse_args(argv)
    for attr, default in _NOT_YET_PORTED:
        if getattr(args, attr) != default:
            raise SystemExit(f"launch: --{attr} is not yet ported to "
                             "sparknet_tpu_torch")
    app_argv = [a for a in args.app_argv if a != "--"]
    if args.nprocs:
        return spawn_local(args, app_argv)
    return run_app(args.app, app_argv, args.coordinator, args.num_processes,
                   args.process_id, args.backend)


if __name__ == "__main__":
    raise SystemExit(main())
