"""Time the numerics audit (``obs/health.py``) at two models' widths, on
the card.

One worker's iteration of each solver — CaffeNet's of
``apps/imagenet_run_db_app.py`` (61 M params in 16 leaves) and the LM's
of ``apps/lm_app.py`` at dim 256, depth 4, heads 4, seq 256 (its many
small leaves) — applies its update to seeded grads twice: with the
audit off (``Solver._apply_update``) and on (the same, which then also
computes the audit's grad norm, plus ``health.pack`` over the grads,
the params and the new params).  Each is
timed on the device from a CUDA graph of 20 calls, and its kernel
launches are counted by ``torch.profiler`` (which also names the
costliest kernels with the audit on); the audit's cost is the
difference.  The bound is the audit's bytes (the grads, the params and
the new params, each read once) over the card's memory rate.  Run from
the root of a checkout, on a machine with the card::

    python -m sparknet_tpu_torch.tools.audit_cost [--tree DIR ...]

Each ``--tree`` (a checkout's root, e.g. an earlier commit unpacked
with ``git archive``) is measured in a process of its own with that
tree's package, in the order given (parent, change, change, parent
compares two versions); with none, this checkout is measured.  Every
result is one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
CALLS = 20


def _device_ms(fn, n: int = CALLS) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10 / n


def _launches(fn):
    """``(kernel launches of one call, its six costliest kernels as
    [name, device ms, launches])`` by ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return len(kernels), [[k[:90], ms, n] for k, (ms, n) in top]


def _solver(model: str, dev):
    if model == "caffenet":
        from sparknet_tpu_torch.apps import imagenet_run_db_app as app

        info = {"classes": 1000, "train_batch": 32, "test_batch": 16}
        return app.build_solver("caffenet", info, 227, dev)
    from sparknet_tpu_torch.apps import lm_app

    p = argparse.ArgumentParser()
    lm_app.add_lm_model_args(p)
    args = p.parse_args(["--dim", "256", "--depth", "4", "--heads", "4",
                         "--seq_len", "256", "--base_lr", "0.01"])
    return lm_app.build_lm_solver(args, dev)[1]


def measure(model: str) -> dict:
    """The audit's device ms and launches an iteration of ``model``, in
    this process's ``sparknet_tpu_torch``."""
    import torch

    import sparknet_tpu_torch
    from sparknet_tpu_torch.obs import health
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    dev = torch.device("cuda", 0)
    solver = _solver(model, dev)
    state = solver.init_state(seed=0)
    params, history = state.params, state.history
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = {k: [1e-3 * torch.randn(t.shape, generator=gen, device=dev)
                 for t in v] for k, v in params.items()}
    loss = torch.tensor(1.0, device=dev)

    def step(audit: bool):
        def one():
            solver.audit = audit
            new, _, gnorm = solver._apply_update(params, history, grads, 0)
            if audit:
                health.pack(grads, params, new, loss, gnorm)
        return one

    off_ms, on_ms = _device_ms(step(False)), _device_ms(step(True))
    (off_n, _), (on_n, top) = _launches(step(False)), _launches(step(True))
    leaves = [t for v in params.values() for t in v]
    n = sum(t.numel() for t in leaves)
    return {
        "tree": os.path.dirname(os.path.dirname(sparknet_tpu_torch.__file__)),
        "card": card_name_and_power_limit(0), "model": model,
        "params": n, "leaves": len(leaves),
        "clip_gradients": float(solver.param.clip_gradients),
        "update_ms": off_ms, "update_with_audit_ms": on_ms,
        "audit_ms": on_ms - off_ms,
        "launches": off_n, "launches_with_audit": on_n,
        "audit_launches": on_n - off_n,
        "audit_bound_ms": 3 * 4 * n / PEAK_BYTES_S * 1e3,
        "top_kernels_with_audit": top,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", action="append", default=[],
                   help="a checkout's root to measure (repeatable)")
    p.add_argument("--measure", action="store_true",
                   help=argparse.SUPPRESS)  # one tree, in this process
    args = p.parse_args(argv)
    if args.measure or not args.tree:
        for model in ("caffenet", "lm"):
            print(json.dumps(measure(model)), flush=True)
        return 0
    for tree in args.tree:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        # run by path, the script's own directory dropped from sys.path,
        # so the tree's package is the one imported
        code = ("import runpy, sys; sys.path.pop(0); "
                f"sys.argv = [{__file__!r}, '--measure']; "
                f"runpy.run_path({os.path.abspath(__file__)!r}, "
                "run_name='__main__')")
        rc = subprocess.run([sys.executable, "-c", code], env=env).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
