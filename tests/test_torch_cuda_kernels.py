"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where
there is no CUDA device.  On a machine with the card and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerance 2e-5 absolute: float32 on both sides, the kernels summing
tile by tile (online softmax) where the plain versions sum densely.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.serve import GenerationEngine

pytestmark = pytest.mark.cuda

ATOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _rand(dev, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev)


def _close_with_infs(got, want):
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    torch.testing.assert_close(got[~inf], want[~inf], atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "tq,tk,q_off,k_off,causal",
    [(16, 16, 0, 0, True), (37, 100, 63, 0, True), (70, 70, 0, 0, False),
     (128, 128, 0, 64, True), (1, 300, 299, 0, True)],
)
def test_flash_kernel_matches_plain(dev, d, tq, tk, q_off, k_off, causal):
    q = _rand(dev, 2, tq, 3, d, seed=1)
    k = _rand(dev, 2, tk, 3, d, seed=2)
    v = _rand(dev, 2, tk, 3, d, seed=3)
    before = tca.LAUNCHES["flash_fwd"]
    o, lse = tca._flash_core(q, k, v, q_off, k_off, causal)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = tca._flash_core_reference(q, k, v, q_off, k_off, causal)
    torch.testing.assert_close(o, o_ref, atol=ATOL, rtol=0)
    _close_with_infs(lse, lse_ref)


def test_flash_kernel_reads_strided_inputs(dev):
    """Heads sliced out of a wider tensor: strides, no copy."""
    wide = _rand(dev, 1, 40, 6, 64, seed=4)
    q, k, v = wide[:, :, 0:2], wide[:, :, 2:4], wide[:, :, 4:6]
    assert not q.is_contiguous()
    got = tca.flash_attention(q, k, v, causal=True)
    want = tca.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_kernel_matches_plain(dev, d):
    q = _rand(dev, 5, 1, 3, d, seed=5)
    k = _rand(dev, 5, 80, 3, d, seed=6)
    v = _rand(dev, 5, 80, 3, d, seed=7)
    lengths = torch.tensor([1, 9, 80, 33, 64], dtype=torch.int32, device=dev)
    before = tca.LAUNCHES["decode_attention"]
    got = tca.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["decode_attention"] == before + 1
    want = tca.decode_attention_reference(q, k, v, lengths)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    torch.testing.assert_close(
        tca.decode_attention(q, k, v),
        tca.decode_attention_reference(q, k, v), atol=ATOL, rtol=0,
    )


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = _rand(dev, 1, 8, 2, 64)
    with pytest.raises(TypeError, match="float32"):
        tca.flash_attention(q.double(), q.double(), q.double())
    odd = _rand(dev, 1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        tca.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="lengths"):
        tca.decode_attention(q[:, :1], q, q, torch.ones(1, device=dev,
                                                         dtype=torch.int64))
    with pytest.raises(ValueError, match="unit stride"):
        t = q.transpose(-1, -2)
        tca.flash_attention(t, t, t)


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    geom = dict(dim=64, depth=2, heads=2, seq_len=64, vocab=64)
    serve = dict(prefill_buckets=(8, 32), max_streams=2, kv_blocks=16,
                 kv_block_size=8)
    gpu = GenerationEngine(TransformerLM(**geom), device=dev, **serve)
    cpu = GenerationEngine(TransformerLM(**geom), device="cpu", **serve)
    gpu.warmup()
    tca.reset_launch_counts()
    for prompt in ([5, 9, 2], list(range(1, 20))):
        runs = []
        for eng in (gpu, cpu):
            slot, tok, lp = eng.admit(prompt, 12)
            toks, lps = [tok], [lp]
            while len(toks) < 12:
                t, l = eng.step()[slot]
                toks.append(t)
                lps.append(l)
            eng.finish(slot)
            runs.append((toks, lps))
        assert runs[0][0] == runs[1][0]
        np.testing.assert_allclose(runs[0][1], runs[1][1], atol=1e-4)
    assert tca.LAUNCHES["flash_fwd"] == 2 * geom["depth"]
    assert tca.LAUNCHES["decode_attention"] == 2 * 11 * geom["depth"]
