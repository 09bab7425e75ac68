"""The port's round-anatomy profiler (``obs/profile.py``), FLOP counts
(``utils/flops.py``), per-layer profiler (``utils/profiler.py``) and
``cli time`` against the JAX package's.

After ``tests/test_profile.py`` and ``tests/test_profiler.py``:

- the module hooks are no-ops until a profiler is installed; install
  points the span observer at it, and a request profiler installed
  after it chains it (both receive spans);
- one script of synthetic spans and worker times through both
  packages' ``RoundProfiler``: hidden fractions, the phase breakdown,
  the per-phase straggler verdict, no false straggler, round keying
  across a replay, the gauges, the summary — the records equal;
- a real cifar10_quick round of the port's trainer under the profiler:
  phases, per-worker execute times (the host interval on CPU tensors),
  the modeled work; ``--profile_out`` from an app writes the summary;
- ``forward_flops``/``train_flops`` equal the JAX package's for
  cifar10_quick, CaffeNet and GoogLeNet exactly, and the conv and
  linear FLOPs agree with ``torch.utils.flop_counter`` on a CaffeNet
  forward (the bias terms aside, which it does not count);
- ``profile_net``'s table, ``format_profile`` (the JAX layout) and
  ``cli time`` on cifar10_quick.
"""

import json
import time

import numpy as np
import pytest
import torch

from sparknet_tpu import models as jmodels
from sparknet_tpu.net import JaxNet
from sparknet_tpu.obs import profile as jprofile
from sparknet_tpu.utils import flops as jflops
from sparknet_tpu.utils.profiler import format_profile as jformat_profile
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import models, obs
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.obs import profile as tprofile
from sparknet_tpu_torch.obs import reqtrace, trace
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.utils import flops as tflops
from sparknet_tpu_torch.utils.profiler import format_profile, profile_net
from sparknet_tpu_torch.utils.timers import CPUTimer, Timer


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small nets: under the parallel test run's load one intra-op
    thread is faster than torch's default pool (as in
    ``tests/test_torch_db_apps.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    yield
    tprofile.uninstall()
    jprofile.uninstall()
    trace.set_span_observer(None)


def _script(mod):
    """One synthetic run through a package's RoundProfiler: returns its
    records and summary (timing-free fields)."""
    p = mod.RoundProfiler(probe_workers=False)

    def consumer(t0, t1, thread="consumer"):
        p.on_span("execute", "phase", t0, t1, thread, None)

    def producer(r, t0, t1, name="assemble", nbytes=None):
        args = {"round": r}
        if nbytes is not None:
            args["nbytes"] = nbytes
        p.on_span(name, "phase", t0, t1, "prefetch-producer", args)

    # round 0: produced in the open; a per-phase straggler under a
    # uniformly large probe phase
    producer(0, -0.5, -0.2)
    p.note_worker_phase(0, "assemble", [0.001, 0.001, 0.001, 0.301])
    p.note_worker_phase(0, "execute_probe", [2.0, 2.001, 2.0, 2.002])
    p.note_consumed_round(0)
    consumer(0.0, 1.0)
    p.on_span("average", "phase", 0.0, 1.0, "consumer", None)
    p.on_span("quantize", "phase", 0.9, 0.95, "consumer", {"compress": "int8"})
    p.observe_round()
    # round 1: produced inside round 0's busy window; comm off thread
    producer(1, 0.2, 0.5)
    producer(1, 0.5, 0.7, name="h2d", nbytes=4096)
    p.note_worker_phase(1, "assemble", [0.1, 0.1, 0.1, 0.1])
    p.note_consumed_round(1)
    consumer(1.1, 2.0)
    p.on_span("allreduce", "phase", 1.2, 1.5, "comm-averaging",
              {"chunk": 0, "nbytes": 100})
    p.on_span("allreduce", "phase", 1.5, 1.8, "comm-averaging",
              {"chunk": 1, "nbytes": 100})
    p.observe_round()
    # round 2: half hidden; a barriered allreduce on the consumer thread;
    # a microsecond-noise ratio the floor suppresses
    producer(2, 1.5, 2.5)
    p.note_worker_phase(2, "assemble", [1e-6, 1e-6, 1e-6, 9e-6])
    p.note_consumed_round(2)
    consumer(2.6, 3.0)
    p.on_span("allreduce", "phase", 2.7, 2.8, "consumer", {"chunk": 0})
    p.observe_round()
    # a replay re-keys by the delivered round: 1 again, then 3
    for r in (1, 3):
        p.note_worker_phase(r, "assemble", [0.01, 0.02])
        p.note_consumed_round(r)
        consumer(3.1 + r, 3.5 + r)
        p.observe_round()
    p.note_round_work(flops_per_round=1e9, comm_bytes_per_round=1e6,
                      compress="int8", num_workers=4)
    recs = [{k: v for k, v in r.items() if k != "round_s"} for r in p._records]
    summ = {k: v for k, v in p.summary().items()
            if k not in ("round_ms", "achieved_flops_per_s", "mfu",
                         "peak_flops", "worker_execute_ms")}
    return p, recs, summ


def test_round_profiler_script_matches_jax():
    tp, trecs, tsum = _script(tprofile)
    jp, jrecs, jsum = _script(jprofile)
    assert trecs == jrecs
    assert tsum == jsum
    assert tprofile.PHASES == jprofile.PHASES
    assert tprofile.PHASE_RESOURCE == jprofile.PHASE_RESOURCE
    assert tp.state_dict() == jp.state_dict()


def test_hidden_fractions_and_keying():
    p, recs, summ = _script(tprofile)
    assert [r["round"] for r in recs] == [0, 1, 2, 1, 3]
    assert recs[0]["hidden_frac_h2d"] == 0.0
    assert recs[1]["hidden_frac_h2d"] == pytest.approx(1.0)
    assert recs[1]["h2d_bytes"] == 4096
    assert recs[2]["hidden_frac_h2d"] == pytest.approx(0.5)
    assert recs[4]["hidden_frac_h2d"] is None
    assert recs[1]["hidden_frac_comm"] == pytest.approx(1.0)
    assert recs[1]["comm_chunk_bytes"] == 200
    assert recs[2]["hidden_frac_comm"] == 0.0  # barriered: visible
    assert recs[0]["phases_ms"]["quantize"] == pytest.approx(50.0)
    assert summ["phases"]["execute"]["bound"] == "compute"
    assert summ["arithmetic_intensity_flops_per_byte"] == pytest.approx(1000.0)


def test_straggler_verdict_per_phase_and_no_false_straggler():
    p, recs, _ = _script(tprofile)
    w = recs[0]["worker"]
    assert w["straggler"] and w["worst_worker"] == 3
    assert w["straggler_phase"] == "assemble"
    assert not w["per_phase"]["execute_probe"]["straggler"]
    assert not recs[1]["worker"]["straggler"]  # homogeneous
    assert not recs[2]["worker"]["straggler"]  # microsecond noise
    assert p.straggler_rounds == 1 and p.last_straggler_round == 0


def test_hooks_are_noops_when_uninstalled():
    assert tprofile.active() is None
    tprofile.note_consumed_round(3)
    tprofile.note_worker_phase(0, "assemble", [0.1])
    assert tprofile.worker_timer(0, 0, 2) is tprofile._NULL_TIMER
    assert tprofile.worker_window_timer("cpu", 2) is None
    assert tprofile.timed_worker_windows(0, [lambda: 1, lambda: 2]) == [1, 2]
    tprofile.observe_round_if_active(None)
    assert tprofile.state() is None
    assert trace._span_observer is None
    assert trace.span("execute") is trace._NULL_SPAN


def test_install_flips_observer_and_composes_with_reqtrace():
    p = tprofile.install(tprofile.RoundProfiler(probe_workers=False))
    assert trace._span_observer == p.on_span
    seen = []

    class Seen(reqtrace.RequestProfiler):
        def on_span(self, name, *rest):
            seen.append(name)
            super().on_span(name, *rest)

    rp = reqtrace.install(Seen())
    try:
        with trace.span("execute"):
            pass
        p.note_consumed_round(0)
        rec = p.observe_round()
        assert "execute" in rec["phases_ms"]  # the round profiler saw it
        assert seen == ["execute"]  # ... and so did the request profiler
    finally:
        reqtrace.uninstall(rp)
    assert trace._span_observer == p.on_span  # put back
    tprofile.uninstall(p)
    assert trace._span_observer is None and tprofile.active() is None


def test_worker_timer_and_timed_windows_feed_attribution():
    p = tprofile.install(tprofile.RoundProfiler(probe_workers=False))
    with tprofile.worker_timer(0, 2, 4):
        time.sleep(0.01)
    assert tprofile.timed_worker_windows(1, [lambda: "a", lambda: "b"]) == ["a", "b"]
    p.note_consumed_round(0)
    times = p.observe_round()["worker"]["times_ms"]
    assert len(times) == 4 and times[2] >= 10.0 and times[0] == 0.0
    p.note_consumed_round(1)
    assert len(p.observe_round()["worker"]["times_ms"]) == 2


def test_worker_window_timer_on_cpu_times_host_intervals():
    t = tprofile.WorkerWindowTimer("cpu", 3)
    for w, s in ((0, 0.0), (2, 0.02)):
        t.start(w)
        time.sleep(s)
        t.stop(w)
    t.start(2)  # a second piece of worker 2's window adds up
    t.stop(2)
    secs = t.seconds()
    assert secs.shape == (3,) and secs[1] == 0.0 and secs[2] >= 0.02


def test_metrics_gauges_and_state_block():
    tm = TrainingMetrics()
    p = tprofile.install(tprofile.RoundProfiler(probe_workers=False))
    p.metrics = tm
    p.on_span("assemble", "phase", -0.5, -0.2, "producer", {"round": 0})
    p.note_worker_phase(0, "assemble", [0.001, 0.4])
    p.note_consumed_round(0)
    p.on_span("execute", "phase", 0.0, 1.0, "consumer", None)
    p.note_round_work(flops_per_round=1e9, comm_bytes_per_round=1e6,
                      compress="int8", num_workers=2)
    p.observe_round()
    text = tm.registry.render()
    assert 'sparknet_hidden_fraction{kind="h2d"}' in text
    assert "sparknet_straggler_worker 1" in text
    assert "sparknet_straggler_rounds_total 1" in text
    assert tprofile.state()["last_worst_worker"] == 1
    # no peak on the CPU, and no TPU entry in the table
    assert tprofile.device_peak_flops("cpu") == 0.0
    assert all("H100" in k for k, _ in tprofile._PEAKS)


def test_profile_instant_rides_the_tracer(tmp_path):
    jl = str(tmp_path / "run.trace.jsonl")
    tracer = trace.install_tracer(trace.Tracer(jsonl_path=jl))
    p = tprofile.install(tprofile.RoundProfiler(probe_workers=False))
    try:
        p.note_consumed_round(0)
        p.observe_round()
    finally:
        trace.uninstall_tracer()
        tracer.close()
    recs = [json.loads(line) for line in open(jl)]
    prof = [r for r in recs if r["name"] == "profile"]
    assert prof and prof[0]["args"]["round"] == 0


def test_profile_from_args_and_close_write_summary(tmp_path, capsys):
    """``--profile`` / ``--profile_out`` through the run's one telemetry
    entry (``obs.start_from_args``; ``ObsRun.close`` prints and writes
    the summary and uninstalls the profiler)."""
    import argparse

    ap = argparse.ArgumentParser()
    obs.add_cli_args(ap)
    assert obs.start_from_args(ap.parse_args([])).profiler is None
    out = tmp_path / "anatomy.json"
    run = obs.start_from_args(ap.parse_args(["--profile_out", str(out)]),
                              echo=print, rank=0)
    p = run.profiler
    assert tprofile.active() is p  # --profile_out implies --profile
    p.note_consumed_round(0)
    p.on_span("execute", "phase", 0.0, 0.5, "c", None)
    p.observe_round()
    run.close()
    summary = run.profile_summary
    assert tprofile.active() is None
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
    text = capsys.readouterr().out
    assert "round-anatomy profiler on" in text
    assert "profile: round anatomy over 1 round(s)" in text
    # across processes rank r > 0 profiles but writes no summary
    run = obs.start_from_args(ap.parse_args(["--profile_out", str(out)]),
                              echo=None, rank=1)
    assert run.profiler is not None and run.profile_out is None
    run.close()


# ----------------------------------------------------------------------
# a real round under the profiler
# ----------------------------------------------------------------------
def _quick_solver(batch=4):
    from sparknet_tpu_torch.solver import Solver

    netp = tconfig.replace_data_layers(
        models.load_model("cifar10_quick"), [(batch, 3, 32, 32), (batch,)],
        [(batch, 3, 32, 32), (batch,)])
    return Solver(models.load_model_solver("cifar10_quick"), net_param=netp,
                  device="cpu")


def test_profiled_training_round_end_to_end():
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    batch = 4
    solver = _quick_solver(batch)
    metrics = TrainingMetrics()
    trainer = ParameterAveragingTrainer(solver, 2, metrics=metrics)
    rng = np.random.RandomState(0)
    window = {"data": torch.from_numpy(rng.rand(2, 1, batch, 3, 32, 32)
                                       .astype(np.float32)),
              "label": torch.zeros((2, 1, batch))}
    p = tprofile.install(tprofile.RoundProfiler())
    state = trainer.init_state(seed=0)
    for _ in range(2):
        state = trainer.round(state, window)[0]
    rec = p.last()
    assert "execute" in rec["phases_ms"] and "average" in rec["phases_ms"]
    assert rec["worker"]["phases"] == ["execute_probe"]
    assert len(rec["execute_ms"]) == 2 and min(rec["execute_ms"]) > 0
    # the modeled work: train_flops of the net, tau 1, both workers
    assert p.flops_per_round == tflops.train_flops(solver.net) * 2
    assert p.comm_bytes_per_round > 0 and p.compress == "none"
    assert p.num_workers == 2 and p.metrics is metrics
    s = p.summary()
    assert s["rounds"] == 2 and s["mfu"] is None  # no peak on the CPU
    assert s["achieved_flops_per_s"] > 0
    assert len(s["worker_execute_ms"]["p50"]) == 2
    assert metrics.achieved_flops.value > 0


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_trainer_work_reads_the_peak_of_the_compute_dtype(monkeypatch, dtype):
    """The trainer hands the profiler its solver's compute dtype, so a
    bf16 round's MFU reads against the bf16 peak (989 TFLOP/s on an
    H100), an fp32 round's against the fp32 one."""
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver

    netp = tconfig.replace_data_layers(models.load_model("cifar10_quick"),
                                       [(2, 3, 32, 32), (2,)])
    solver = Solver(models.load_model_solver("cifar10_quick"), net_param=netp,
                    device="cpu", compute_dtype=dtype)
    trainer = ParameterAveragingTrainer(solver, 2)
    asked = []

    def peak(device=None, dtype=torch.float32):
        asked.append((torch.device(device).type, dtype))
        return 0.0

    monkeypatch.setattr(tprofile, "device_peak_flops", peak)
    prof = tprofile.RoundProfiler()
    tprofile.note_trainer_work(prof, trainer, 1, trainer.init_state(seed=0))
    want = torch.bfloat16 if dtype else torch.float32
    assert asked == [("cpu", want)]
    # the H100 table has both peaks
    assert dict(tprofile._PEAKS)["H100 SXM"] == {torch.float32: 67e12,
                                                torch.bfloat16: 989e12}


def test_app_profile_out_writes_the_summary(tmp_path):
    """``cifar_app --profile_out``: the feed keys the rounds, the draws
    and windows are timed per worker, the summary JSON lands."""
    from sparknet_tpu_torch.apps import cifar_app

    from sparknet_tpu_torch.data import CifarLoader

    data = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(data, num_train=200, num_test=20)
    out = tmp_path / "p.json"
    res = {}
    rc = cifar_app.main(["--device", "cpu", "--data", data, "--workers", "2",
                         "--tau", "1", "--rounds", "3", "--batch", "10",
                         "--test_every", "10", "--profile_out", str(out)],
                        result=res)
    assert rc == 0 and tprofile.active() is None
    s = json.loads(out.read_text())
    assert s["rounds"] == 3
    assert {"assemble", "h2d", "execute", "average"} <= set(s["phases"])
    assert len(s["worker_execute_ms"]["p50"]) == 2
    assert s["straggler_rounds"] == 0


# ----------------------------------------------------------------------
# FLOP counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cifar10_quick", "caffenet", "googlenet"])
def test_flops_equal_jax(name):
    tnet = TorchNet(models.load_model(name), phase="TRAIN")
    jnet = JaxNet(jmodels.load_model(name), phase="TRAIN")
    assert tflops.forward_flops(tnet) == jflops.forward_flops(jnet)
    assert tflops.train_flops(tnet) == jflops.train_flops(jnet)
    assert tflops.train_flops(tnet) == 3 * tflops.forward_flops(tnet) > 0


def test_flops_agree_with_torch_flop_counter_on_caffenet():
    from torch.utils.flop_counter import FlopCounterMode

    batch = 1
    netp = tconfig.replace_data_layers(
        models.load_model("caffenet"), [(batch, 3, 227, 227), (batch,)],
        [(batch, 3, 227, 227), (batch,)])
    net = TorchNet(netp, phase="TRAIN")
    params, stats = net.init(0)
    batch_t = {"data": torch.randn(batch, 3, 227, 227),
               "label": torch.zeros(batch)}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net.apply(params, stats, batch_t, train=False)
    counted = fc.get_total_flops()
    # the flop counter counts the multiply-adds, not the bias adds
    bias = 0.0
    for layer in net.layers:
        lp = layer.lp
        if lp.type == "Convolution" and lp.convolution_param.bias_term:
            n, k, oh, ow = net.blob_shapes[lp.top[0]]
            bias += 2.0 * n * k * oh * ow
        elif lp.type == "InnerProduct" and lp.inner_product_param.bias_term:
            bias += 2.0 * batch * lp.inner_product_param.num_output
    assert counted == tflops.forward_flops(net) - bias


# ----------------------------------------------------------------------
# the per-layer profiler and cli time
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def quick_net():
    b = 2
    netp = tconfig.replace_data_layers(
        models.load_model("cifar10_quick"), [(b, 3, 32, 32), (b,)],
        [(b, 3, 32, 32), (b,)])
    net = TorchNet(netp, phase="TRAIN")
    params, stats = net.init(0)
    rng = np.random.RandomState(0)
    batch = {"data": torch.from_numpy(rng.randn(b, 3, 32, 32).astype(np.float32)),
             "label": torch.from_numpy(rng.randint(0, 10, b).astype(np.float32))}
    return net, params, stats, batch


def test_profile_net_table_shape_and_times(quick_net):
    from sparknet_tpu_torch.ops import data_layers

    net, params, stats, batch = quick_net
    result = profile_net(net, params, stats, batch, iterations=1)
    expected = {l.name for l in net.layers
                if not isinstance(l, data_layers._HostFed)}
    assert set(result["layers"]) == expected and expected
    for name, row in result["layers"].items():
        assert set(row) == {"forward_ms", "backward_ms"}, name
        assert row["forward_ms"] > 0, name
        assert row["backward_ms"] > 0 or np.isnan(row["backward_ms"]), name
    assert result["layers"]["conv1"]["backward_ms"] > 0
    assert result["total_forward_ms"] > 0 and result["total_fwdbwd_ms"] > 0


def test_nothing_to_differentiate_reports_nan():
    netp = tconfig.parse_net_prototxt(
        'layer { name: "d" type: "HostData" top: "x" top: "y" '
        'java_data_param { shape { dim: 4 dim: 5 } shape { dim: 4 } } } '
        'layer { name: "acc" type: "Accuracy" bottom: "x" bottom: "y" '
        'top: "a" }')
    net = TorchNet(netp, phase="TRAIN")
    params, stats = net.init(0)
    batch = {"x": torch.randn(4, 5), "y": torch.zeros(4)}
    row = profile_net(net, params, stats, batch, iterations=1)["layers"]["acc"]
    assert row["forward_ms"] > 0 and np.isnan(row["backward_ms"])


def test_format_profile_matches_jax_layout(quick_net):
    net, params, stats, batch = quick_net
    result = profile_net(net, params, stats, batch, iterations=1)
    text = format_profile(result)
    assert text == jformat_profile(result)
    lines = text.splitlines()
    assert lines[0].split() == ["layer", "forward", "(ms)", "backward", "(ms)"]
    assert "fused whole-net: forward" in lines[-1]


def test_cli_time_prints_every_layer_of_cifar10_quick(capsys):
    from sparknet_tpu_torch.tools import cli

    res = {}
    assert cli.main(["time", "--model", "cifar10_quick", "--iterations", "1",
                     "--batch", "2", "--device", "cpu"], result=res) == 0
    text = capsys.readouterr().out
    names = [l.name for l in TorchNet(models.load_model("cifar10_quick"),
                                      phase="TRAIN").layers
             if l.lp.type not in ("Data", "HostData")]
    for name in names:
        assert any(line.split()[0] == name for line in text.splitlines()), name
    assert res["net"].blob_shapes["data"][0] == 2


def test_timers_and_profile_trace(tmp_path):
    t = CPUTimer().start()
    time.sleep(0.01)
    assert t.stop().milli_seconds() >= 10.0 and t.has_run_at_least_once
    d = Timer("cpu").start()
    assert d.stop().seconds() >= 0.0
    from sparknet_tpu_torch.utils.profiler import profile_trace

    path = str(tmp_path / "trace.json")
    with profile_trace(path):
        torch.ones(4) @ torch.ones(4)
    assert "traceEvents" in json.load(open(path))
