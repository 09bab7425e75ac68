"""The telemetry plane's effect on a run, and the serving and per-rank
parts of it, on the CPU (no JAX run: ``tests/test_torch_obs_apps.py``
holds the families and counts to the JAX package's).

- ``cifar_app --compress int8`` with every telemetry flag gives the
  losses, final parameters, stats and momentum of the same run without
  any, bit for bit, and leaves nothing of its telemetry installed.
- ``cli serve --generate --slo --device cpu``: ``/slo`` counts the
  streams it served.
- Across processes no two ranks write one trace file.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_obs_apps import (
    CIFAR,
    FLAGS,
    ROUNDS,
    get,
    sample,
    small_cifar,
)


@pytest.fixture(scope="module")
def on_off(tmp_path_factory):
    """``cifar_app --compress int8`` on one small CIFAR set, with every
    telemetry flag and with none."""
    d = tmp_path_factory.mktemp("obs_bits")
    data = small_cifar(d)
    torch.set_num_threads(1)
    runs = {}
    for leg, extra in (("off", []), ("on", FLAGS + [
            "--trace_out", str(d / "t.json"), "--flight_recorder",
            str(d / "f.json")])):
        r = {}
        assert cifar_app.main(CIFAR + ["--device", "cpu", "--data", data]
                              + extra, result=r) == 0
        runs[leg] = r
    return runs


def test_losses_and_params_bit_identical_with_telemetry(on_off):
    on, off = on_off["on"], on_off["off"]
    assert on["smoothed_loss"] == off["smoothed_loss"]
    assert on["accuracy"] == off["accuracy"]
    for name in ("params", "stats", "history"):
        for a, b in zip(tree_leaves(getattr(on["state"], name)),
                        tree_leaves(getattr(off["state"], name))):
            assert torch.equal(a, b), name
    assert on["profile"]["rounds"] == ROUNDS and off["profile"] is None
    # the run's telemetry was torn down: nothing of it stays installed
    from sparknet_tpu_torch.obs import trace

    assert obs.training_metrics() is None and trace._ship is None
    assert trace._phase_observer is None and obs.get_tracer() is None


def _stream(base, prompt, max_new, out, i):
    req = urllib.request.Request(
        base + "/generate",
        data=json.dumps({"prompt": prompt, "max_new": max_new}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out[i] = [json.loads(ln) for ln in r if ln.strip()]


def test_cli_serve_generate_slo_counts_the_streams():
    from sparknet_tpu_torch.tools import cli

    n = 6
    r = {}
    assert cli.main(["serve", "--generate", "--device", "cpu", "--port", "0",
                     "--lm_dim", "32", "--lm_depth", "2", "--lm_heads", "2",
                     "--lm_seq_len", "64", "--prefill_buckets", "8,16",
                     "--max_streams", "4", "--kv_blocks", "32",
                     "--kv_block_size", "8", "--obs", "--obs_port", "0",
                     "--slo"], result=r) == 0
    server, run = r["server"], r["obs"]
    server.start()
    try:
        run.sampler.sample_once()  # the baseline sample
        t0 = time.time()
        h, p = server.address
        rs = np.random.RandomState(0)
        out = [None] * n
        threads = [threading.Thread(target=_stream, args=(
            f"http://{h}:{p}", rs.randint(0, 256, 5).tolist(), 4, out, i))
            for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(o is not None and o[-1]["event"] == "done" for o in out)
        # the next sample lands in a later 1 s bucket than the baseline
        time.sleep(max(0.0, 1.05 - (time.time() - t0)))
        run.sampler.sample_once()
        oh, op = run.address
        code, body = get(f"http://{oh}:{op}/slo")
        assert code == 200
        row = {x["name"]: x for x in json.loads(body)["slos"]}["serve-ttft-p99"]
        assert row["status"] != "no_data", row
        ev = run.sampler.evaluator
        slo = next(s for s in ev.slos if s.name == "serve-ttft-p99")
        bad, total = slo.indicator(ev.tsdb, 300.0, time.time())
        assert total == n and 0 <= bad <= n
        assert get(f"http://{oh}:{op}/signals")[0] == 200
        text = get(f"http://{oh}:{op}/metrics")[1]
        assert sample(text, "sparknet_gen_ttft_seconds_count") == n
    finally:
        server.shutdown()
        run.close()


def test_trace_files_are_one_a_rank(tmp_path):
    """Across processes no two ranks write one file: rank 0 writes the
    ``--trace_out`` path (and the flight bundle) as given, rank r > 0
    ``STEM.p<r>.EXT``; rank 0 alone writes ``--profile_out``."""
    import argparse

    ap = argparse.ArgumentParser()
    obs.add_cli_args(ap)
    args = ap.parse_args(["--trace_out", str(tmp_path / "t.json"),
                          "--flight_recorder", str(tmp_path / "f.json"),
                          "--profile_out", str(tmp_path / "p.json")])
    for rank in (0, 1, 2):
        run = obs.start_from_args(args, echo=None, rank=rank)
        with obs.span("execute", round=rank):
            pass
        assert (run.profile_out is not None) == (rank == 0)
        assert run.recorder.path == str(
            tmp_path / ("f.json" if rank == 0 else f"f.p{rank}.json"))
        run.close()
    for name in ("t", "t.p1", "t.p2"):
        with open(tmp_path / f"{name}.json") as f:
            (ev,) = [e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"]
        assert ev["args"]["round"] == (0 if name == "t" else int(name[-1]))
        assert os.path.exists(tmp_path / f"{name}.jsonl")
    assert obs.rank_path(None, 3) is None
    assert obs.rank_path("run", 3) == "run.p3"
