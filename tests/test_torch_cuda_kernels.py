"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where
there is no CUDA device.  On a machine with the card and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Attention: tolerance 2e-5 absolute, float32 on both sides, the kernels
summing tile by tile (online softmax) where the plain versions sum
densely.  The flash backward (K3, K4): 2e-5 of the largest magnitude of
the plain version's output (sums of up to T products, in another
order).  The comm epilogue kernels (K9-K11) are held to their plain
versions bit for bit, except the error readout's two sums (rtol 1e-5,
reduced in another order).
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops import cuda_comm as tcc
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


BWD_RTOL = 2e-5


def _close_scaled(got, want, what):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= BWD_RTOL * scale, (what, err, scale)


def _bwd_inputs(dev, b, tq, tk, h, d, q_off, k_off, causal, seed=0):
    q = _rand(dev, b, tq, h, d, seed=seed)
    k = _rand(dev, b, tk, h, d, seed=seed + 1)
    v = _rand(dev, b, tk, h, d, seed=seed + 2)
    do = _rand(dev, b, tq, h, d, seed=seed + 3)
    dlse = _rand(dev, b, h, tq, seed=seed + 4)
    o, lse = tca._flash_core_reference(q, k, v, q_off, k_off, causal)
    return (q, k, v, do, o.contiguous(), lse, dlse, q_off, k_off, causal)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "tq,tk,q_off,k_off,causal",
    [(16, 16, 0, 0, True), (37, 100, 63, 0, True), (70, 70, 0, 0, False),
     (128, 128, 0, 64, True), (1, 300, 299, 0, True), (256, 256, 0, 0, True)],
)
def test_flash_bwd_kernels_match_plain(dev, d, tq, tk, q_off, k_off, causal):
    """K3 and K4 with a nonzero dlse, ragged tiles and (128, 128, 0, 64)'s
    64 fully-masked query rows."""
    args = _bwd_inputs(dev, 2, tq, tk, 3, d, q_off, k_off, causal)
    before = dict(tca.LAUNCHES)
    dq = tca.flash_bwd_dq(*args)
    dk, dv = tca.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tca.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    _close_scaled(dq, tca._flash_bwd_dq_reference(*args), "dq")
    dk_ref, dv_ref = tca._flash_bwd_dkv_reference(*args)
    _close_scaled(dk, dk_ref, "dk")
    _close_scaled(dv, dv_ref, "dv")
    if (q_off, k_off) == (0, 64):
        assert bool((dq[:, :64] == 0).all())


def test_flash_bwd_kernels_read_strided_inputs(dev):
    wide = _rand(dev, 2, 40, 10, 64, seed=8)
    q, k, v, do, o = (wide[:, :, 2 * i:2 * i + 2] for i in range(5))
    assert not q.is_contiguous()
    _, lse = tca._flash_core_reference(q, k, v, 0, 0, True)
    dlse = _rand(dev, 2, 2, 40, seed=9)
    args = (q, k, v, do, o, lse, dlse, 0, 0, True)
    _close_scaled(tca.flash_bwd_dq(*args), tca._flash_bwd_dq_reference(*args),
                  "dq")
    for g, w in zip(tca.flash_bwd_dkv(*args), tca._flash_bwd_dkv_reference(*args)):
        _close_scaled(g, w, "dkv")


@pytest.mark.parametrize("q_off,k_off,causal", [(0, 0, True), (0, 8, True),
                                                (0, 0, False)])
def test_flash_autograd_on_the_card_matches_the_cpu(dev, q_off, k_off, causal):
    """``flash_attention_step``'s grads through o AND lse: the card's
    K1/K3/K4 against the CPU's plain versions."""
    grads = []
    for d in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(11)
        q, k, v = (torch.randn(2, 48, 2, 64, generator=g).to(d)
                   .requires_grad_(True) for _ in range(3))
        wo = torch.randn(2, 2, 48, 64, generator=g).to(d)
        wl = torch.randn(2, 2, 48, generator=g).to(d)
        o, lse = tca.flash_attention_step(q, k, v, q_off, k_off, causal)
        lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
        ((o * wo).sum() + (lse * wl).sum()).backward()
        grads.append([t.grad.cpu() for t in (q, k, v)])
    for got, want in zip(*grads):
        _close_scaled(got, want, "grad")


def test_lm_trainer_on_the_card_runs_the_flash_kernels(dev):
    """Two W=2 rounds of the LM on the card against the same rounds on
    the CPU: every attention forward and backward launches K1, K3 and
    K4 once, and the params agree to float32 rounding."""
    from sparknet_tpu_torch.config import parse_solver_prototxt
    from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.tree import tree_leaves

    sp = 'base_lr: 0.1 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0001'
    geom = dict(dim=64, depth=2, heads=2, seq_len=64)
    rs = np.random.RandomState(0)
    data = [{k: torch.from_numpy(rs.randint(0, 256, (2, 2, 4, 64)).astype(np.int32))
             for k in ("tokens", "targets")} for _ in range(2)]
    runs = []
    for d in (dev, torch.device("cpu")):
        tr = ParameterAveragingTrainer(
            Solver(parse_solver_prototxt(sp), net=TransformerLMNet(**geom),
                   device=d), 2)
        st = tr.init_state(0)
        tca.reset_launch_counts()
        for batch in data:
            st, losses = tr.round(st, {k: v.to(d) for k, v in batch.items()})
        torch.cuda.synchronize()
        runs.append((st, dict(tca.LAUNCHES), losses.cpu()))
    (gpu, launches, gl), (cpu, cpu_launches, cl) = runs
    n = geom["depth"] * 2 * 2 * 2  # depth x workers x tau x rounds
    assert launches == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                        "decode_attention": 0}
    assert all(v == 0 for v in cpu_launches.values())
    torch.testing.assert_close(gl, cl, rtol=0, atol=5e-5)
    for g, c in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=5e-5)


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
    _, lse = tca._flash_core_reference(q, q, q, 0, 0, True)
    with pytest.raises(ValueError, match="dlse"):
        tca.flash_bwd_dq(q, q, q, q, q, lse, lse[:, :, :4], 0, 0, True)
    with pytest.raises(ValueError, match="lse"):
        tca.flash_bwd_dkv(q, q, q, q, q, lse.double(), lse, 0, 0, True)
    with pytest.raises(ValueError, match="line up"):
        tca.flash_bwd_dq(q, q, q, q[:, :4], q, lse, lse, 0, 0, True)


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


# ----------------------------------------------------------------------
# K9-K11: the comm plane's epilogue kernels, bitwise against their plain
# versions at the cifar10_full chunk shapes (W=4, sorted leaf order)
# ----------------------------------------------------------------------
# tests/test_parallel.py's net (that module imports JAX, which the card's
# machine does not have)
TOY_NET = """
name: "toy"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
  inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "logits"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""
CIFAR_CHUNKS = (
    ((4, 32, 3, 5, 5), (4, 32), (4, 32, 32, 5, 5)),
    ((4, 32), (4, 64, 32, 5, 5)),
    ((4, 64), (4, 10, 1024), (4, 10)),
)


def _chunk(dev, shapes, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(s, generator=g) * scale).to(dev) for s in shapes)


def _same_bits(got, want):
    """Equal bit for bit; NaNs must sit in the same places (their bf16
    payloads are not compared)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not got.is_floating_point():
        assert torch.equal(got, want)
        return
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    assert torch.equal(gn, wn)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got[~gn], want[~wn])


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("ci", range(len(CIFAR_CHUNKS)))
def test_comm_encode_kernel_bitwise(dev, mode, with_err, ci):
    shapes = CIFAR_CHUNKS[ci]
    x = _chunk(dev, shapes, 1, 1e-2)
    a = _chunk(dev, shapes, 2, 1e-2)
    r = _chunk(dev, shapes, 3, 1e-5)
    x[0][1].view(-1)[7] = float("nan")  # a poisoned worker
    a[-1].zero_()
    x[-1].zero_()
    r[-1].zero_()  # an all-zero leaf
    modes = (mode,) * len(shapes)
    before = tcc.LAUNCHES["comm_encode"]
    got = tcc.encode(x, a, r, modes, with_err)
    torch.cuda.synchronize()
    assert tcc.LAUNCHES["comm_encode"] == before + 1
    want = tcc.encode_reference(x, a, r, modes, with_err)
    for g, w in zip(got[0] + got[1] + got[2], want[0] + want[1] + want[2]):
        _same_bits(g, w)
    if with_err:
        assert torch.equal(got[3][:, 0].isnan(), want[3][:, 0].isnan())
        ok = ~want[3][:, 0].isnan()
        assert torch.equal(got[3][ok, 0], want[3][ok, 0])
        torch.testing.assert_close(got[3][ok, 1:], want[3][ok, 1:], rtol=1e-5, atol=0)


@pytest.mark.parametrize("alive,denom0", [([1, 1, 1, 1], 4.0), ([1, 0, 1, 1], 3.0),
                                          ([0, 0, 0, 0], 0.0)])
@pytest.mark.parametrize("ci", range(len(CIFAR_CHUNKS)))
def test_comm_apply_barriered_kernel_bitwise(dev, alive, denom0, ci):
    shapes = CIFAR_CHUNKS[ci]
    x, a, r = _chunk(dev, shapes, 4), _chunk(dev, shapes, 5), _chunk(dev, shapes, 6)
    means = tuple(m[0].contiguous() for m in _chunk(dev, shapes, 7))
    alive_t = torch.tensor(alive, dtype=torch.float32, device=dev)
    d0 = torch.tensor(denom0, device=dev)
    got = tcc.apply_barriered(x, a, means, r, alive_t, d0)
    torch.cuda.synchronize()
    want = tcc.apply_barriered_reference(x, a, means, r, alive_t, d0)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _same_bits(g, w)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("ci", range(len(CIFAR_CHUNKS)))
def test_comm_apply_correction_kernel_bitwise(dev, mode, ci):
    shapes = CIFAR_CHUNKS[ci]
    modes = (mode,) * len(shapes)
    q, s, _, _ = tcc.encode_reference(
        _chunk(dev, shapes, 8, 1e-2), _chunk(dev, shapes, 9, 1e-2),
        _chunk(dev, shapes, 10, 1e-5), modes, False,
    )
    x, a = _chunk(dev, shapes, 11), _chunk(dev, shapes, 12)
    means = tuple(m[0].contiguous() for m in _chunk(dev, shapes, 13, 1e-2))
    got = tcc.apply_correction(x, a, q, s, means, modes)
    torch.cuda.synchronize()
    want = tcc.apply_correction_reference(x, a, q, s, means, modes)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _same_bits(g, w)


def test_comm_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = _chunk(dev, ((4, 8),), 0)
    with pytest.raises(TypeError, match="float32"):
        tcc.encode(tuple(t.double() for t in x), x, x, ("int8",), False)
    with pytest.raises(ValueError, match="contiguous"):
        t = (torch.randn(8, 4, device=dev).t(),)
        tcc.encode(t, t, t, ("int8",), False)
    with pytest.raises(ValueError, match="modes"):
        tcc.encode(x, x, x, ("int4",), False)


@pytest.mark.parametrize("compress,overlap,dead", [
    ("none", False, False), ("int8", False, False), ("bf16", True, False),
    ("int8", False, True), ("bf16", True, True)])
def test_trainer_on_the_card_matches_the_cpu_trainer(dev, compress, overlap, dead):
    """Two rounds of the averaging trainer on the card against the same
    trainer on the CPU (plain versions), from one init and one data;
    ``dead``: worker 1 is masked in the second round (its residual resets,
    and an overlapped plane falls back to the barriered apply)."""
    from sparknet_tpu_torch import config as tconfig
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.tree import tree_leaves

    sp = 'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9'
    runs = []
    for d in (dev, torch.device("cpu")):
        solver = Solver(tconfig.parse_solver_prototxt(sp),
                        net_param=tconfig.parse_net_prototxt(TOY_NET), device=d)
        tr = ParameterAveragingTrainer(solver, 4, compress=compress,
                                       overlap_avg=overlap)
        st = tr.init_state(0)
        tcc.reset_launch_counts()
        for r in range(2):
            rs = np.random.RandomState(r)
            data = {"x": torch.from_numpy(rs.randn(4, 3, 8, 6).astype(np.float32)),
                    "label": torch.from_numpy(
                        rs.randint(0, 4, (4, 3, 8)).astype(np.float32))}
            mask = [1, 0, 1, 1] if dead and r == 1 else None
            st, _ = tr.round(st, {k: v.to(d) for k, v in data.items()},
                             live_mask=mask)
        st = tr.finalize(st)
        runs.append((st, dict(tcc.LAUNCHES), len(tr._comm.chunk_slices)
                     if tr._comm is not None else 0))
    (gpu, launches, chunks), (cpu, cpu_launches, _) = runs
    assert all(v == 0 for v in cpu_launches.values())
    if compress != "none" or overlap:
        barriered = 2 if not overlap else (1 if dead else 0)
        assert launches["comm_encode"] == 2 * chunks
        assert launches["comm_apply_barriered"] == barriered * chunks
        assert launches["comm_apply_correction"] == (
            (1 if dead else 2) * chunks if overlap else 0)
    tol = dict(rtol=2e-5, atol=1e-6) if compress == "none" else dict(rtol=0, atol=5e-3)
    for g, c in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(g.cpu(), c, **tol)
