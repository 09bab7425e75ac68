"""Package rules of the port: no JAX, card by default, plain on CPU.

- No file of ``sparknet_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``sparknet_tpu`` (an AST scan of every import statement).
- Entry points run on the card unless the caller asks for the CPU:
  built without ``device``, they raise where there is no CUDA device
  (the serving CLI, ``apps.cifar_app``, ``apps.lm_app`` and ``cli
  train --lm``, the solver and trainer).
- What a slice has not ported yet refuses, saying so.
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
from sparknet_tpu_torch.apps import cifar_app, lm_app
from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops import cuda_comm as tcc
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
                "data/round_feed.py", "apps/lm_app.py", "data/text.py"):
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
    assert resolve_device("cpu").type == "cpu"


_CIFAR = ["--device", "cpu", "--workers", "2", "--tau", "2", "--rounds", "1"]


@pytest.mark.parametrize(
    "argv,what",
    [
        (["serve"], "/predict"),
        (["serve", "--generate", "--weights", "w.caffemodel"], "--weights"),
        (["serve", "--generate", "--replicas", "2"], "--replicas"),
        (["serve", "--generate", "--watch", "/pub"], "--watch"),
    ] + [
        (["cifar_app"] + _CIFAR + flag, flag[0])
        for flag in (["--elastic"], ["--slices", "2"],
                     ["--cross_slice_every", "2"], ["--stale_bound", "1"],
                     ["--health"], ["--journal"], ["--obs"], ["--profile"])
    ],
)
def test_cli_refuses_what_is_not_yet_ported(argv, what):
    main = cli.main
    if argv[0] == "cifar_app":
        main, argv = cifar_app.main, argv[1:]
    with pytest.raises(SystemExit, match="not yet ported") as e:
        main(argv)
    assert what in str(e.value)


@pytest.mark.parametrize(
    "text",
    ['layer { name: "d" type: "Dropout" bottom: "x" top: "x" }',
     'layer { name: "d" type: "Dropout" dropout_param { dropout_ratio: 0.5 } }'],
    ids=["layer_type", "layer_param"],
)
def test_net_refuses_layers_not_yet_ported(text):
    from sparknet_tpu_torch.net import TorchNet

    head = ('layer { name: "in" type: "HostData" top: "x" '
            'java_data_param { shape { dim: 2 dim: 3 } } } ')
    with pytest.raises((NotImplementedError, ValueError), match="not yet ported"):
        TorchNet(tconfig.parse_net_prototxt(head + text))


def test_zoo_refuses_models_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        models.load_model("alexnet")
    assert models.load_model("cifar10_full").name == "CIFAR10_full"


def test_engine_refuses_weights():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        GenerationEngine(TransformerLM(**GEOM), weights="w.caffemodel",
                         device="cpu")


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


def test_kernel_build_plan_is_keyed_by_source():
    """Every kernel source has a library path keyed by a hash of its
    source and flags, in the git-ignored build directory; importing the
    module compiled nothing."""
    srcs = _build.sources()
    assert set(srcs) == {"flash_fwd", "flash_bwd", "decode_attention",
                         "comm_epilogue"}
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
