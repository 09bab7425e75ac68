"""Which attention path the LM takes, and which head dims the kernels take.

The flash kernels (K1 forward, K3/K4 backward) and the decode kernel
(K2) are built for every multiple of 16 up to 128 and every multiple of
32 up to 256 (``csrc/head_dims.cuh``); on a CUDA tensor the wrappers
zero-pad any other head dim up to 256 onto them
(``tests/test_torch_attention_pad.py``).
A head dim above 256 raises on the card, naming the limit, under
``attention="auto"`` as under ``"flash"``: nothing on the card falls
back to the plain versions.  On the CPU every head dim takes the plain
versions through the same wrappers.  The card is stood in for by making
the wrappers' device check report one (``cuda_attention._on_cpu``):
every call that reaches a wrapper then takes the kernel's route, which
raises before anything is built for a head dim above the limit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.apps import lm_app
from sparknet_tpu_torch.models.transformer_lm import TransformerLM, TransformerLMNet
from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as tca

# (dim, heads) -> head_dim 272 and 288: above the kernels' limit
NO_BUILD = [(544, 2), (288, 1)]
NO_BUILD_IDS = ["D272", "D288"]
LIMIT_MSG = "is above the kernels' limit of 256"


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(tca, "_on_cpu", lambda t: False)


def _batch(seq_len, seed=0):
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(r.randint(0, 256, (2, seq_len)).astype(np.int64))
            for k in ("tokens", "targets")}


def test_kernel_head_dims_match_the_build():
    """The wrappers' list is the one the CUDA sources instantiate."""
    text = (_build.SRC_DIR / "head_dims.cuh").read_text()
    built = re.search(r"#define FLASH_HEAD_DIMS\(X\) (.*)", text).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", built)) == \
        tca.KERNEL_HEAD_DIMS
    assert tca.KERNEL_HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128,
                                    160, 192, 224, 256)


def _sw(d, r, c):
    """``sw<D>(r, c)`` of ``csrc/flash_common.cuh``."""
    period = 8 if d % 32 == 0 else 4
    return r * d + (c ^ ((r & (period - 1)) << 2))


@pytest.mark.parametrize("d", tca.KERNEL_HEAD_DIMS)
def test_swizzle_stays_inside_the_row(d):
    """Each row's 16-byte chunks are a permutation of the row's own
    chunks, so a swizzled tile of R rows holds exactly R x D floats and
    a 16-byte ``cp.async`` lands on 16 bytes."""
    for r in range(16):
        cols = [_sw(d, r, c) - r * d for c in range(d)]
        assert sorted(cols) == list(range(d))
        for c in range(0, d, 4):
            chunk = [_sw(d, r, c + i) for i in range(4)]
            assert chunk[0] % 4 == 0
            assert chunk == list(range(chunk[0], chunk[0] + 4))


@pytest.mark.parametrize("attention", ["auto", "flash"])
@pytest.mark.parametrize("dim,heads", NO_BUILD, ids=NO_BUILD_IDS)
def test_training_raises_on_the_card_where_no_kernel_is_built(card, attention,
                                                              dim, heads):
    """No plain fallback on the card: the error names the limit, and
    nothing launched."""
    tca.reset_launch_counts()
    net = TransformerLMNet(attention=attention, dim=dim, depth=1, heads=heads,
                           seq_len=16)
    assert net.on_kernel
    params, stats = net.init(0)
    with pytest.raises(ValueError, match=rf"head_dim {dim // heads} {LIMIT_MSG}"):
        net.loss_fn(params, stats, _batch(16))
    assert all(v == 0 for v in tca.LAUNCHES.values())


@pytest.mark.parametrize("dim,heads", NO_BUILD, ids=NO_BUILD_IDS)
def test_serving_raises_on_the_card_where_no_kernel_is_built(card, dim, heads):
    lm = TransformerLM(dim=dim, depth=1, heads=heads, seq_len=16).init(0)
    tokens = _batch(16)["tokens"][:, :9]
    with pytest.raises(ValueError, match=rf"head_dim {dim // heads} {LIMIT_MSG}"):
        lm.prefill_with_kv(tokens)
    q = torch.zeros((2, 1, heads, dim // heads))
    kv = torch.zeros((2, 16, heads, dim // heads))
    with pytest.raises(ValueError, match=rf"head_dim {dim // heads} {LIMIT_MSG}"):
        tca.decode_attention(q, kv, kv)


@pytest.mark.parametrize("attention,on_kernel", [("auto", True), ("flash", True),
                                                 ("dense", False)])
@pytest.mark.parametrize("dim,heads", [(64, 4), (96, 2)], ids=["D16", "D48"])
def test_the_kernels_carry_every_built_head_dim(attention, on_kernel, dim, heads):
    net = TransformerLMNet(attention=attention, dim=dim, depth=1, heads=heads,
                           seq_len=16)
    assert net.head_dim in tca.KERNEL_HEAD_DIMS
    assert net.on_kernel is on_kernel


@pytest.mark.parametrize("extra,gauge,path", [
    ([], 1.0, "plain versions of the flash kernels (CPU tensors)"),
    (["--dense_attention"], 0.0, "dense mha_reference"),
], ids=["flash", "dense"])
def test_lm_app_logs_the_path_and_sets_the_gauge(capsys, extra, gauge, path):
    """``--dim 96 --heads 2`` (head dim 48) trains on the CPU; the app
    logs one line saying which path attention takes."""
    result = {}
    assert lm_app.main(["--device", "cpu", "--dim", "96", "--depth", "1",
                        "--heads", "2", "--seq_len", "16", "--batch", "2",
                        "--tau", "1", "--workers", "1", "--rounds", "1",
                        *extra], result) == 0
    assert result["metrics"].kernel_path.labels("attention").value == gauge
    assert np.isfinite(result["losses"]).all()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "attention path:" in ln]
    assert len(lines) == 1 and path in lines[0]
