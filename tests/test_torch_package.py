"""Package rules of the port: no JAX, card by default, plain on CPU.

- No file of ``sparknet_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``sparknet_tpu`` (an AST scan of every import statement).
- Entry points run on the card unless the caller asks for the CPU:
  built without ``device``, they raise where there is no CUDA device.
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

from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.serve import GenerationEngine
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
    assert len(files) > 20
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
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize(
    "argv,what",
    [
        (["serve"], "/predict"),
        (["serve", "--generate", "--weights", "w.caffemodel"], "--weights"),
        (["serve", "--generate", "--replicas", "2"], "--replicas"),
        (["serve", "--generate", "--watch", "/pub"], "--watch"),
    ],
)
def test_cli_refuses_what_is_not_yet_ported(argv, what):
    with pytest.raises(SystemExit, match="not yet ported") as e:
        cli.main(argv)
    assert what in str(e.value)


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
    lengths = torch.tensor([4], dtype=torch.int32)
    got = tca.decode_attention(q[:, :1], k, v, lengths)
    assert torch.equal(
        got, tca.decode_attention_reference(q[:, :1], k, v, lengths)
    )
    assert tca.LAUNCHES == before


def test_kernel_build_plan_is_keyed_by_source():
    """Every kernel source has a library path keyed by a hash of its
    source and flags, in the git-ignored build directory; importing the
    module compiled nothing."""
    srcs = _build.sources()
    assert set(srcs) == {"flash_fwd", "decode_attention"}
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
