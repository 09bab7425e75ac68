"""Package rules of the port: no JAX, card by default, plain on CPU.

- No file of ``sparknet_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``sparknet_tpu`` (an AST scan of every import statement).
- Entry points run on the card unless the caller asks for the CPU:
  built without ``device``, they raise where there is no CUDA device
  (the serving CLI, ``apps.cifar_app``, ``apps.lm_app`` and ``cli
  train --lm``, ``apps.imagenet_app``, the DB apps
  ``apps.imagenet_run_db_app`` and ``apps.cifar_db_app``, ``cli test``,
  the solver and trainer).
- What a slice has not ported yet refuses, saying so; the telemetry
  flags once refused run.
- The kernel wrappers take the plain version for CPU tensors, and only
  there: no kernel is launched and no library is built.
- ``chip_smoke.py`` fails, printing no result, without a card and in a
  directory that holds nothing else of the repo.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import models
from sparknet_tpu_torch.apps import (
    cifar_app,
    cifar_db_app,
    imagenet_app,
    imagenet_run_db_app,
    lm_app,
)
from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops import cuda_comm as tcc
from sparknet_tpu_torch.ops import cuda_lrn as tcl
from sparknet_tpu_torch.ops import cuda_plp as tcp
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
from sparknet_tpu_torch.serve import GenerationEngine
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils.devices import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(dim=32, depth=1, heads=2, seq_len=16, vocab=32)


def _port_files():
    pkg = os.path.join(REPO, "sparknet_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    files = list(_port_files())
    assert len(files) > 40
    # the scan walks the whole package: the training slice is in it
    rel = {os.path.relpath(p, REPO) for p in files}
    for mod in ("apps/cifar_app.py", "parallel/comm.py", "parallel/trainers.py",
                "ops/cuda_comm.py", "solver.py", "net.py", "config/prototext.py",
                "data/round_feed.py", "apps/lm_app.py", "data/text.py",
                "apps/imagenet_app.py", "ops/cuda_lrn.py", "ops/cuda_plp.py",
                "data/imagenet.py", "data/transforms.py", "io/caffemodel.py",
                "models/builders.py", "utils/rngs.py", "io/wire.py",
                "io/checkpoint.py", "io/hdf5.py", "tools/cli.py",
                "runtime/__init__.py", "runtime/_build.py", "io/lmdb.py",
                "io/leveldb.py", "data/source.py", "ops/data_layers.py",
                "apps/imagenet_create_db_app.py",
                "apps/imagenet_run_db_app.py", "apps/cifar_db_app.py",
                "models/dsl.py", "ops/common.py", "ops/losses.py",
                "ops/vision.py", "config/schema.py", "data/shuffle.py",
                "data/prefetch.py", "data/transformer.py", "data/windows.py",
                "data/object_store.py", "data/chunk_cache.py",
                "apps/featurizer_app.py", "parallel/stale.py",
                "obs/profile.py", "utils/profiler.py", "utils/timers.py",
                "utils/flops.py", "runtime/chaos.py", "obs/tsdb.py",
                "obs/slo.py", "obs/ship.py", "obs/fleet.py",
                "obs/exporter.py", "obs/__init__.py", "io/protobin.py",
                "io/proto_fields.py", "data/mnist.py", "tools/parse_log.py",
                "tools/draw.py", "tools/net_surgery.py", "tools/detector.py",
                "tools/prepare_imagenet.py", "analysis/__init__.py",
                "analysis/astutil.py", "analysis/donation_check.py",
                "analysis/findings.py", "analysis/hotpaths.py",
                "analysis/registry.py", "analysis/registry_audit.py",
                "analysis/runner.py", "analysis/sanitize.py",
                "analysis/sync_check.py", "analysis/thread_check.py",
                "tools/lint.py", "tools/provision.py"):
        assert os.path.join("sparknet_tpu_torch", mod) in rel
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "sparknet_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(TransformerLM(**GEOM), prefill_buckets=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--generate", "--lm_dim", "32", "--lm_depth",
                  "1", "--lm_heads", "2", "--lm_seq_len", "16",
                  "--prefill_buckets", "8"])
    # the image-serving slice: /predict, the fleet and the watcher
    for extra in ([], ["--replicas", "2"], ["--watch", "/pub"],
                  ["--dtype", "bfloat16"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["serve", "--net", "caffenet"] + extra)
    # the training slice: the app, and the solver the trainer runs on
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cifar_app.main(["--workers", "2", "--tau", "2", "--rounds", "1",
                        "--compress", "int8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParameterAveragingTrainer(Solver(models.load_model_solver("cifar10_full")), 4)
    # the LM training slice: the app, its CLI dispatch and the net solver
    lm_argv = ["--dim", "32", "--depth", "1", "--heads", "2", "--seq_len",
               "16", "--rounds", "1", "--workers", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_app.main(lm_argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--lm"] + lm_argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(tconfig.parse_solver_prototxt("base_lr: 0.1"),
               net=models.build_transformer_lm(dim=32, depth=1, heads=2))
    # the ImageNet slice: the app, before it writes any data, with
    # AlexNet and with the deep nets
    for model in ("alexnet", "resnet50", "googlenet"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            imagenet_app.main(["--model", model, "--workers", "2", "--tau",
                               "2", "--rounds", "1"])
    # the DB slice: both training apps before they read or write a DB,
    # and cli test before it reads the net
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imagenet_run_db_app.main(["--db_dir", "/nonexistent", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cifar_db_app.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["test", "--model", "/nonexistent.prototxt"])
    # the data plane's featurizer, before it builds the net
    from sparknet_tpu_torch.apps import featurizer_app

    with pytest.raises(RuntimeError, match="no CUDA device"):
        featurizer_app.main(["--model", "caffenet", "--blob", "fc7"])
    # the inference commands, before they read the net or an image
    for argv in (["device_query"],
                 ["classify", "--model", "caffenet", "/nonexistent.jpg"],
                 ["detect", "--model", "rcnn_ilsvrc13", "--window_file",
                  "/nonexistent.txt"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert resolve_device("cpu").type == "cpu"


_CIFAR = ["--device", "cpu", "--workers", "2", "--tau", "2", "--rounds", "1"]


@pytest.mark.parametrize(
    "argv,what",
    [
        (["train", "--solver", "s.prototxt"] + flag, flag[0])
        for flag in (["--trace_out", "/t"], ["--ship_to", "http://h:1"],
                     ["--slo"])
    ] + [
        (["cifar_app"] + _CIFAR + flag, flag[0])
        for flag in (["--trace_out", "/t"], ["--obs_port", "1"],
                     ["--slo"], ["--ship_to", "http://h:1"], ["--obs"])
    ] + [
        (["imagenet_app", "--device", "cpu"] + flag, flag[0])
        for flag in (["--obs"], ["--host_id", "h"])
    ] + [
        (["imagenet_run_db_app", "--device", "cpu", "--db_dir", "/d"] + flag,
         flag[0])
        for flag in (["--trace_out", "/t"], ["--slo"])
    ] + [
        (["cifar_db_app", "--device", "cpu"] + flag, flag[0])
        for flag in (["--trace_out", "/t"], ["--obs"])
    ],
)
def test_cli_refuses_what_is_not_yet_ported(argv, what, tmp_path, monkeypatch):
    """The telemetry flags these entry points once refused run now
    (``tests/test_torch_obs_apps.py`` ``flag_runs``): each starts what
    its flag asks for.  A stand-in ``--solver`` or ``--db_dir`` becomes
    a small real one."""
    from tests.test_torch_obs_apps import flag_runs

    main = cli.main
    apps = {"cifar_app": cifar_app, "imagenet_app": imagenet_app,
            "imagenet_run_db_app": imagenet_run_db_app,
            "cifar_db_app": cifar_db_app}
    if argv[0] in apps:
        main, argv = apps[argv[0]].main, argv[1:]
    if "s.prototxt" in argv:
        argv = [_toy_solver(tmp_path) if a == "s.prototxt" else a
                for a in argv] + ["--device", "cpu"]
    if "/d" in argv:
        from sparknet_tpu_torch.apps import imagenet_create_db_app

        db = str(tmp_path / "db")
        assert imagenet_create_db_app.main(["--out", db]) == 0
        argv = [db if a == "/d" else a for a in argv]
    assert what in argv
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small nets under the parallel run's load
    try:
        flag_runs(monkeypatch, tmp_path, main, argv)
    finally:
        torch.set_num_threads(n)


def _toy_solver(tmp_path) -> str:
    from sparknet_tpu_torch.utils import procs

    net = tmp_path / "toy.prototxt"
    net.write_text(procs.TOY_NET)
    solver = tmp_path / "s.prototxt"
    solver.write_text(f'net: "{net}"\n{procs.TOY_SOLVER}\nmax_iter: 2\n')
    return str(solver)


@pytest.mark.parametrize("app,flag", [
    ("cifar_app", ["--profile_out"]), ("cifar_app", ["--stale_bound", "1"]),
    ("cifar_app", ["--profile"]), ("imagenet_app", ["--profile"]),
    ("imagenet_app", ["--stale_bound", "1"]),
])
def test_entry_points_run_what_this_slice_ports(tmp_path, app, flag):
    """``--stale_bound`` builds the bounded-staleness trainer (every
    worker arrives each round: the ledger counts every round), and
    ``--profile`` / ``--profile_out`` end the run with the profiler's
    summary (written as JSON for ``--profile_out``)."""
    import json

    from sparknet_tpu_torch.parallel.stale import BoundedStalenessTrainer

    from sparknet_tpu_torch.data import CifarLoader

    if flag == ["--profile_out"]:
        flag = flag + [str(tmp_path / "p.json")]
    data = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(data, num_train=200, num_test=20)
    argv = {"cifar_app": _CIFAR + ["--batch", "10", "--test_every", "10",
                                   "--data", data],
            "imagenet_app": ["--device", "cpu", "--workers", "2", "--tau", "1",
                             "--rounds", "1", "--train_batch", "2",
                             "--test_batch", "2"]}[app]
    mod = {"cifar_app": cifar_app, "imagenet_app": imagenet_app}[app]
    res = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small nets under the parallel run's load
    try:
        mod.main(argv + flag, result=res)
    finally:
        torch.set_num_threads(n)
    if flag[0] == "--stale_bound":
        tr = res["trainer"]
        assert isinstance(tr, BoundedStalenessTrainer) and tr.stale_bound == 1
        assert list(tr.worker_rounds) == [1, 1]
        assert res["profile"] is None
    else:
        assert res["profile"]["rounds"] == 1
        assert "execute" in res["profile"]["phases"]
        if flag[0] == "--profile_out":
            assert json.load(open(flag[1]))["rounds"] == 1


@pytest.mark.parametrize(
    "text",
    ['layer { name: "a" type: "Attention" bottom: "x" top: "y" '
     'attention_param { num_heads: 2 } }'],
    ids=["layer_param"],
)
def test_net_refuses_layers_not_yet_ported(text):
    """No layer type is left unported: the ``Attention`` layer, the last
    one refused, builds from its prototxt and runs on (B, T, E)."""
    from sparknet_tpu_torch.net import TorchNet

    head = ('layer { name: "in" type: "HostData" top: "x" '
            'java_data_param { shape { dim: 2 dim: 5 dim: 4 } } } ')
    net = TorchNet(tconfig.parse_net_prototxt(head + text))
    params, stats = net.init(0)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 5, 4)
                         .astype(np.float32))
    y = net.forward(params, stats, {"x": x})["y"]
    assert tuple(y.shape) == (2, 5, 4) and torch.isfinite(y).all()


def test_zoo_refuses_models_not_yet_ported():
    """Every zoo model of the JAX package is ported now: the deep nets
    load, and only an unknown name is refused."""
    for name, net in (("googlenet", "GoogLeNet"), ("resnet50", "ResNet-50"),
                      ("lenet", "LeNet")):
        assert models.load_model(name).name == net
    with pytest.raises(KeyError, match="unknown model"):
        models.load_model("inception_v3")
    assert models.load_model("cifar10_full").name == "CIFAR10_full"
    assert models.load_model("alexnet").name == "AlexNet"
    assert models.load_model("caffenet", batch=2).name == "CaffeNet"


def test_engine_refuses_weights(tmp_path):
    """Weights load now; a file whose groups do not fit the model (or
    that fits none of them) is refused, never served half-loaded."""
    from sparknet_tpu_torch.io import caffemodel

    lm = TransformerLM(**GEOM)
    wide = TransformerLM(**dict(GEOM, dim=64))
    path = str(tmp_path / "w.caffemodel")
    caffemodel.save_weights(
        {g: [np.zeros(s, np.float32) for s in shapes]
         for g, shapes in wide._blob_plan()}, path)
    with pytest.raises(ValueError, match="blob shape"):
        GenerationEngine(lm, weights=path, prefill_buckets=(8,), device="cpu")
    caffemodel.save_weights({"conv1": [np.zeros(3, np.float32)]}, path)
    with pytest.raises(ValueError, match="no layers matched"):
        GenerationEngine(lm, weights=path, prefill_buckets=(8,), device="cpu")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """Routing is by device only: CPU tensors never reach a kernel, so
    nothing is built and no launch is counted."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    r = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(r.randn(1, 9, 2, 32).astype(np.float32))
               for _ in range(3))
    before = dict(tca.LAUNCHES)
    got = tca.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, tca.flash_attention_reference(q, k, v, True))
    # the flash backward (K3, K4) through the autograd Function
    qg = q.clone().requires_grad_(True)
    tca.flash_attention(qg, k, v, causal=True).sum().backward()
    o, lse = tca._flash_core_reference(q, k, v, 0, 0, True)
    dq = tca._flash_bwd_dq_reference(q, k, v, torch.ones_like(q), o, lse,
                                     torch.zeros_like(lse), 0, 0, True)
    assert torch.equal(qg.grad, dq)
    lengths = torch.tensor([4], dtype=torch.int32)
    got = tca.decode_attention(q[:, :1], k, v, lengths)
    assert torch.equal(
        got, tca.decode_attention_reference(q[:, :1], k, v, lengths)
    )
    assert tca.LAUNCHES == before
    # the comm epilogue: K9, K10, K11
    comm_before = dict(tcc.LAUNCHES)
    xs = (q[0], k[0])  # (W=9, 2, 32) leaves
    qs, scales, _, _ = tcc.encode(xs, xs, xs, ("int8", "bf16"), True)
    means = tuple(x[0] for x in xs)
    alive = torch.ones(9)
    tcc.apply_barriered(xs, xs, means, xs, alive, alive.sum())
    tcc.apply_correction(xs, xs, qs, scales, means, ("int8", "bf16"))
    assert tcc.LAUNCHES == comm_before
    # the LRN (K5, K6) and the fused LRN + max pool (K7, K8)
    lrn_before, plp_before = dict(tcl.LAUNCHES), dict(tcp.LAUNCHES)
    x = torch.from_numpy(r.randn(2, 7, 11, 13).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    y = tcl.lrn_across_channels(xg, 5, 1e-4, 0.75, 1.0)
    assert torch.equal(y, tcl.lrn_across_reference(x, 5, 1e-4, 0.75, 1.0))
    y.sum().backward()
    assert torch.equal(xg.grad, tcl.lrn_across_bwd_reference(
        x, torch.ones_like(x), 5, 1e-4, 0.75, 1.0))
    xg = x.clone().requires_grad_(True)
    y = tcp.lrn_maxpool(xg, 5, 1e-4, 0.75, 1.0)
    assert torch.equal(y, tcp.lrn_maxpool_reference(x, 5, 1e-4, 0.75, 1.0))
    y.sum().backward()
    assert torch.equal(xg.grad, tcp.lrn_maxpool_bwd_reference(
        x, torch.ones_like(y), 5, 1e-4, 0.75, 1.0))
    assert tcl.LAUNCHES == lrn_before and tcp.LAUNCHES == plp_before


def test_kernel_build_plan_is_keyed_by_source():
    """Every kernel source has a library path keyed by a hash of its
    source and flags, in the git-ignored build directory; importing the
    module compiled nothing."""
    srcs = _build.sources()
    assert set(srcs) == {"flash_fwd", "flash_bwd", "decode_attention",
                         "comm_epilogue", "lrn", "lrn_pool", "lrn_pool_bf16"}
    for name in srcs:
        p = _build.library_path(name)
        assert p == _build.library_path(name)
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.relpath(_build.BUILD_DIR, REPO) == os.path.join(
        "build", "sparknet_tpu_torch"
    )
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_a_library_is_keyed_by_the_sources_it_includes(tmp_path, monkeypatch):
    """``lrn_pool_bf16.cu`` includes ``lrn_pool.cu``: an edit of the
    included file moves the including library's key too, and an edit of
    a source no library includes moves no other library's key."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    assert [p.name for p in _build.includes(src / "lrn_pool_bf16.cu")] == [
        "lrn_common.cuh", "lrn_pool.cu"]
    keys = {n: _build.library_path(n) for n in _build.sources()}
    (src / "lrn_pool.cu").write_text((src / "lrn_pool.cu").read_text() + "\n")
    moved = {n for n in keys if _build.library_path(n) != keys[n]}
    assert moved == {"lrn_pool", "lrn_pool_bf16"}
    keys = {n: _build.library_path(n) for n in _build.sources()}
    (src / "comm_epilogue.cu").write_text(
        (src / "comm_epilogue.cu").read_text() + "\n")
    assert {n for n in keys if _build.library_path(n) != keys[n]} == {
        "comm_epilogue"}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present: chip_smoke would run")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_slice_entry_points_default_to_the_card(tmp_path):
    """``run_chaos`` and ``cli time`` take the card unless asked for the
    CPU; without one they raise before writing anything."""
    if torch.cuda.is_available():
        return
    from sparknet_tpu_torch.runtime import chaos

    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_chaos(chaos.FaultPlan.default(),
                        workdir=str(tmp_path / "c"))
    assert not os.path.exists(str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["time", "--model", "cifar10_quick"])
