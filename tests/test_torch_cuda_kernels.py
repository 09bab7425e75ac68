"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where
there is no CUDA device.  On a machine with the card and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Attention, at every head dim the kernels are built for and at head dims
the wrappers zero-pad onto them (``PADDED_DIMS``; the paged decode reads
them from an arena kept at the built head dim): tolerance 2e-5
absolute, float32 on both sides, the kernels summing tile by tile
(online softmax, K1's products as three TF32 products on the tensor
cores) where the plain versions sum densely.  The flash backward (K3,
K4): 2e-5 of the largest magnitude of the plain version's output (sums of up to T products, in another
order, each product as three TF32 products on the tensor cores); with q
and k scaled by 8 the float32 plain version itself strays further than
that from the exact result, so that case is held to a float64
evaluation: within 2e-5 of the scale or the plain version's own gap,
whichever is larger.  Head dims above 128 (160 to 256, and 144 and 200
padded) run the same cases.  The comm epilogue kernels (K9-K11) are held
to their plain versions bit for bit, except the error readout's two sums
(rtol 1e-5, reduced in another order), at cifar10_full's chunks (W=4),
AlexNet's (W=2, fc6's 37.7M floats a worker) and edge leaves (one float,
worker slices off 16 bytes, views off 16 bytes).  The LRN kernels (K5, K6) and the fused LRN +
max pool (K7, K8): the JAX tests' tolerances (forward rtol 2e-5 / atol
2e-6, backward 5e-5 / 5e-6), K8's routing bit for bit (alpha = 0 makes
the LRN the identity, so K8's output is the routed gradient), and K6,
K7 and K8 bit for bit at AlexNet's two sandwiches, random and tied.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops import cuda_comm as tcc
from sparknet_tpu_torch.ops import cuda_lrn as tcl
from sparknet_tpu_torch.ops import cuda_plp as tcp
from sparknet_tpu_torch.serve import GenerationEngine

pytestmark = pytest.mark.cuda

ATOL = 2e-5
# head dims off the built ones: the autograd path and decode pad them to
# the next build (144 and 200 to 160 and 224, above 128)
PADDED_DIMS = (1, 24, 40, 100, 144, 200)
HEAD_DIMS = tca.KERNEL_HEAD_DIMS + PADDED_DIMS


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


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize(
    "tq,tk,q_off,k_off,causal",
    [(16, 16, 0, 0, True), (37, 100, 63, 0, True), (70, 70, 0, 0, False),
     (128, 128, 0, 64, True), (1, 300, 299, 0, True)],
)
def test_flash_kernel_matches_plain(dev, d, tq, tk, q_off, k_off, causal):
    q = _rand(dev, 2, tq, 3, d, seed=1)
    k = _rand(dev, 2, tk, 3, d, seed=2)
    v = _rand(dev, 2, tk, 3, d, seed=3)
    tca.reset_launch_counts()
    o, lse = tca._FlashCore.apply(q, k, v, q_off, k_off, causal)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["flash_fwd"] == 1
    assert tca.PAD_COPIES == (0 if d in tca.KERNEL_HEAD_DIMS else 3)
    assert o.shape == q.shape
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


@pytest.mark.parametrize("d", HEAD_DIMS)
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


def _paged_case(dev, h, d, lengths, bs, nblocks=40, seed=0):
    """q, a paged arena of ``nblocks`` + 1 blocks of ``bs`` rows
    ``arena_head_dim(d)`` wide (pad columns zero), and a block table of
    shuffled, non-contiguous blocks covering each slot's length (the
    trash block 0 past it), 80 positions wide."""
    g = torch.Generator().manual_seed(seed)
    dp, rows, width = tca.arena_head_dim(d), (nblocks + 1) * bs, -(-80 // bs)
    arenas = []
    for _ in range(2):
        a = torch.zeros(rows, h, dp)
        a[..., :d] = torch.randn(rows, h, d, generator=g)
        arenas.append(a.to(dev))
    table = torch.zeros(len(lengths), width, dtype=torch.int32)
    for i, n in enumerate(lengths):
        drawn = torch.randperm(nblocks, generator=g)[: min(-(-n // bs), width)]
        table[i, : drawn.numel()] = drawn + 1
    q = torch.randn(len(lengths), 1, h, d, generator=g).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, arenas[0], arenas[1], table.to(dev)), lens


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bs", [16, 5])
def test_paged_decode_kernel_matches_plain(dev, d, bs):
    """Lengths at a block edge and either side of it, 0 (o = 0), and past
    the table's width (read up to the width); two launches give the same
    bits; nothing is copied."""
    lengths = [1, bs - 1, bs, bs + 1, 0, 77, 80, 1000]
    case, lens = _paged_case(dev, 3, d, lengths, bs, seed=d)
    tca.reset_launch_counts()
    got = tca.paged_decode_attention(*case, lens, bs)
    again = tca.paged_decode_attention(*case, lens, bs)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["decode_attention"] == 2
    assert tca.PAD_COPIES == 0 and tca.ALIGN_COPIES == 0
    assert torch.equal(got, again)
    assert got.shape == case[0].shape and bool((got[4] == 0).all())
    want = tca.paged_decode_attention_reference(*case, lens, bs)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_paged_decode_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    case, lens = _paged_case(dev, 2, 40, [3, 20], 16)
    q, ak, av, table = case
    with pytest.raises(ValueError, match="rows of 48"):
        tca.paged_decode_attention(q, ak[..., :40], av[..., :40], table, lens,
                                   16)
    with pytest.raises(ValueError, match="block_table"):
        tca.paged_decode_attention(q, ak, av, table.long(), lens, 16)
    with pytest.raises(ValueError, match="16 bytes"):
        off = torch.zeros(ak.numel() + 1, device=dev)[1:].view(ak.shape)
        tca.paged_decode_attention(q, off, av, table, lens, 16)
    wide = torch.zeros(2, 1, 2, 272, device=dev)
    arena = torch.zeros(32, 2, 272, device=dev)
    with pytest.raises(ValueError, match="head_dim 272 is above"):
        tca.paged_decode_attention(wide, arena, arena, table, lens, 16)


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


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize(
    "tq,tk,q_off,k_off,causal",
    [(16, 16, 0, 0, True), (37, 100, 63, 0, True), (70, 70, 0, 0, False),
     (128, 128, 0, 64, True), (1, 300, 299, 0, True), (256, 256, 0, 0, True)],
)
def test_flash_bwd_kernels_match_plain(dev, d, tq, tk, q_off, k_off, causal):
    """K3 and K4 with a nonzero dlse, ragged tiles and (128, 128, 0, 64)'s
    64 fully-masked query rows."""
    args = _bwd_inputs(dev, 2, tq, tk, 3, d, q_off, k_off, causal)
    tca.reset_launch_counts()
    if d not in tca.KERNEL_HEAD_DIMS:
        # K3/K4 take built head dims: the autograd path pads q, k and v
        # once in the forward and do in the backward, and its o and lse
        # are what the plain versions are then given
        q, k, v = (t.clone().requires_grad_(True) for t in args[:3])
        o, lse = tca._FlashCore.apply(q, k, v, q_off, k_off, causal)
        torch.autograd.backward((o, lse), (args[3], args[6]))
        dq, dk, dv = q.grad, k.grad, v.grad
        args = (*args[:4], o.detach(), lse.detach(), *args[6:])
    else:
        dq = tca.flash_bwd_dq(*args)
        dk, dv = tca.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["flash_bwd_dq"] == 1
    assert tca.LAUNCHES["flash_bwd_dkv"] == 1
    assert tca.PAD_COPIES == (0 if d in tca.KERNEL_HEAD_DIMS else 4)
    assert dq.shape == args[0].shape and dk.shape == dv.shape == args[1].shape
    _close_scaled(dq, tca._flash_bwd_dq_reference(*args), "dq")
    dk_ref, dv_ref = tca._flash_bwd_dkv_reference(*args)
    _close_scaled(dk, dk_ref, "dk")
    _close_scaled(dv, dv_ref, "dv")
    if (q_off, k_off) == (0, 64):
        assert bool((dq[:, :64] == 0).all())


def _bwd_float64(q, k, v, do, o, lse, dlse):
    """(dq, dk, dv) of the causal flash backward in float64, densely."""
    q, k, v, do, o = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, do, o))
    t, d = q.shape[2], q.shape[3]
    s = (q @ k.transpose(-1, -2)) / d ** 0.5
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=q.device)
                      .triu(1), float("-inf"))
    p = torch.exp(s - lse.double()[..., None])
    delta = (do * o).sum(-1) - dlse.double()
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) / d ** 0.5
    return tuple(x.permute(0, 2, 1, 3) for x in (
        ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do))


@pytest.mark.parametrize("case", ["q, k x8", "fused qkv"])
def test_flash_bwd_kernels_at_the_training_shape(dev, case):
    """B=8, T=256, H=4, D=64, causal: q and k scaled by 8 (scores of ~64,
    against float64), and q, k, v as strided views of one (B, T, 3, H, D)
    tensor (against the plain versions)."""
    b, t, h, d = 8, 256, 4, 64
    if case == "fused qkv":
        q, k, v = _rand(dev, b, t, 3, h, d, seed=20).unbind(2)
        assert q.stride(1) == 3 * h * d
    else:
        q, k, v = (_rand(dev, b, t, h, d, seed=20 + i) for i in range(3))
        q, k = q * 8, k * 8
    do = _rand(dev, b, t, h, d, seed=23)
    dlse = _rand(dev, b, h, t, seed=24)
    o, lse = tca._flash_core(q, k, v, 0, 0, True)
    args = (q, k, v, do, o, lse, dlse, 0, 0, True)
    got = (tca.flash_bwd_dq(*args), *tca.flash_bwd_dkv(*args))
    plain = (tca._flash_bwd_dq_reference(*args),
             *tca._flash_bwd_dkv_reference(*args))
    if case == "fused qkv":
        for g, w, name in zip(got, plain, ("dq", "dk", "dv")):
            _close_scaled(g, w, name)
        return
    # at scores of ~64 float32 itself strays more than BWD_RTOL from the
    # exact result: the kernels must be as close to it as the plain
    # float32 version is, or within BWD_RTOL
    for g, w, x, name in zip(got, plain, _bwd_float64(*args[:7]),
                             ("dq", "dk", "dv")):
        scale = max(1.0, float(x.abs().max()))
        err = float((g.double() - x).abs().max())
        plain_gap = float((w.double() - x).abs().max())
        assert err <= max(BWD_RTOL * scale, plain_gap), (name, err, plain_gap)


def test_flash_bwd_kernels_are_deterministic(dev):
    """One owner per output tile, no atomics: two launches on the same
    inputs give the same bits."""
    args = _bwd_inputs(dev, 8, 256, 256, 4, 64, 0, 0, True, seed=30)
    first = (tca.flash_bwd_dq(*args), *tca.flash_bwd_dkv(*args))
    second = (tca.flash_bwd_dq(*args), *tca.flash_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
    wide = _rand(dev, 1, 8, 2, 272)
    with pytest.raises(ValueError, match="head_dim 272 is above the kernels' "
                       "limit of 256"):
        tca.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="head_dim 272 is above"):
        tca.decode_attention(wide[:, :1], wide, wide)
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
    # K3/K4 copy rows 16 bytes at a time: a base off by one float raises
    off = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    assert off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        tca.flash_bwd_dq(off, q, q, q, q, lse, lse, 0, 0, True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tca.flash_bwd_dkv(q, q, q, off, q, lse, lse, 0, 0, True)
    # the kernel wrappers take built head dims; the autograd path pads
    odd = q[..., :40]
    msg = "head_dim 40 is not one the kernels are built for"
    with pytest.raises(ValueError, match=msg):
        tca._flash_core(odd, odd, odd, 0, 0, True)
    with pytest.raises(ValueError, match=msg):
        tca.flash_bwd_dq(odd, odd, odd, odd, odd, lse, lse, 0, 0, True)


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused-qkv"])
def test_flash_kernel_at_the_lm_training_shape(dev, fused):
    """B=8 T=256 H=4 D=64 causal, q, k and v apart or as strided views of
    one fused qkv tensor."""
    if fused:
        q, k, v = _rand(dev, 8, 256, 3, 4, 64, seed=40).unbind(2)
        assert not q.is_contiguous()
    else:
        q, k, v = (_rand(dev, 8, 256, 4, 64, seed=41 + i) for i in range(3))
    o, lse = tca._flash_core(q, k, v, 0, 0, True)
    o_ref, lse_ref = tca._flash_core_reference(q, k, v, 0, 0, True)
    torch.testing.assert_close(o, o_ref, atol=ATOL, rtol=0)
    _close_with_infs(lse, lse_ref)


def test_flash_kernel_is_deterministic(dev):
    """One owner per output row and a fixed merge order: two launches on
    the same inputs give the same bits."""
    q, k, v = (_rand(dev, 8, 256, 4, 64, seed=44 + i) for i in range(3))
    first = tca._flash_core(q, k, v, 0, 0, True)
    second = tca._flash_core(q, k, v, 0, 0, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_backward_takes_a_view_offset_by_one_float(dev):
    """The autograd path copies rows the kernels cannot load 16 bytes at a
    time: forward and backward through a view offset by one float run
    K1, K3 and K4 and give the CPU's gradients."""
    grads = []
    for d in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(45)
        base = torch.randn(2 * 40 * 2 * 64 + 1, generator=g).to(d)
        off = base[1:].view(2, 40, 2, 64).requires_grad_(True)
        k, v = (torch.randn(2, 40, 2, 64, generator=g).to(d).requires_grad_(True)
                for _ in range(2))
        if d.type == "cuda":
            assert off.data_ptr() % 16 == 4
            tca.reset_launch_counts()
        tca.flash_attention(off, k, v, causal=True).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert tca.ALIGN_COPIES == 1  # q in the forward, saved aligned
            assert tca.LAUNCHES["flash_fwd"] == tca.LAUNCHES["flash_bwd_dq"] \
                == tca.LAUNCHES["flash_bwd_dkv"] == 1
        grads.append([t.grad.cpu() for t in (off, k, v)])
    for got, want in zip(*grads):
        _close_scaled(got, want, "grad")


def test_lm_app_trains_at_head_dim_48(dev):
    """``lm_app --dim 96 --heads 2`` (head_dim 48, an odd multiple of 16):
    one round trains on the kernels, the kernel-path gauge reads 1; at
    head_dim 144 (padded to the 160 build) a step runs on the kernels; at
    head_dim 272, above the kernels' limit, training raises on the card."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet

    result = {}
    tca.reset_launch_counts()
    assert lm_app.main(["--device", "cuda", "--dim", "96", "--depth", "2",
                        "--heads", "2", "--seq_len", "64", "--batch", "4",
                        "--tau", "2", "--workers", "2", "--rounds", "1",
                        "--base_lr", "0.01"], result) == 0
    torch.cuda.synchronize()
    # two workers x tau 2 steps x depth 2 layers
    assert tca.LAUNCHES["flash_fwd"] == tca.LAUNCHES["flash_bwd_dq"] \
        == tca.LAUNCHES["flash_bwd_dkv"] == 2 * 2 * 2
    assert result["metrics"].kernel_path.labels("attention").value == 1.0
    assert np.isfinite(result["losses"]).all()
    tokens = torch.zeros((2, 16), dtype=torch.int64, device=dev)
    batch = {"tokens": tokens, "targets": tokens}
    for attention in ("auto", "flash"):
        net = TransformerLMNet(attention=attention, dim=288, depth=1, heads=2,
                               seq_len=16)
        params, stats = net.init(0, dev)
        tca.reset_launch_counts()
        loss = net.loss_fn(params, stats, batch)
        loss = loss[0] if isinstance(loss, tuple) else loss
        torch.cuda.synchronize()
        assert bool(torch.isfinite(loss).all())
        assert tca.LAUNCHES["flash_fwd"] == 1 and tca.PAD_COPIES == 3
        net = TransformerLMNet(attention=attention, dim=544, depth=1, heads=2,
                               seq_len=16)
        params, stats = net.init(0, dev)
        with pytest.raises(ValueError, match="head_dim 272 is above the "
                           "kernels' limit of 256"):
            net.loss_fn(params, stats, batch)


def test_lm_app_trains_at_head_dim_24(dev):
    """``lm_app --dim 72 --heads 3`` (head_dim 24, zero-padded to 32):
    one round trains on K1/K3/K4, the gauge reads 1, the first round's
    losses agree with the CPU's plain versions."""
    from sparknet_tpu_torch.apps import lm_app

    argv = ["--dim", "72", "--depth", "2", "--heads", "3", "--seq_len", "64",
            "--batch", "4", "--tau", "2", "--workers", "2", "--rounds", "1",
            "--base_lr", "0.01"]
    runs = {}
    for d in ("cuda", "cpu"):
        result = {}
        tca.reset_launch_counts()
        assert lm_app.main(["--device", d] + argv, result) == 0
        torch.cuda.synchronize()
        runs[d] = (result, dict(tca.LAUNCHES), tca.PAD_COPIES)
    result, launches, pads = runs["cuda"]
    n = 2 * 2 * 2  # two workers x tau 2 steps x depth 2 layers
    assert launches == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                        "decode_attention": 0}
    assert pads > 0 and runs["cpu"][1]["flash_fwd"] == 0
    assert result["metrics"].kernel_path.labels("attention").value == 1.0
    np.testing.assert_allclose(result["losses"], runs["cpu"][0]["losses"],
                               atol=5e-4)


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


def test_engine_decode_step_at_head_dim_40_copies_nothing(dev):
    """``--lm_dim 160 --lm_heads 4``: the pool's rows are 48 wide, each
    decode step runs K2 once a layer and pads nothing; tokens and
    logprobs match the CPU engine's."""
    geom = dict(dim=160, depth=2, heads=4, seq_len=64, vocab=64)
    serve = dict(prefill_buckets=(8, 32), max_streams=3, kv_blocks=16,
                 kv_block_size=16)
    runs = []
    for d in (dev, "cpu"):
        eng = GenerationEngine(TransformerLM(**geom), device=d, **serve)
        assert tuple(eng.pool.k.shape[2:]) == (4, 48)
        slot, tok, lp = eng.admit(list(range(1, 20)), 10)
        tca.reset_launch_counts()
        toks, lps = [tok], [lp]
        while len(toks) < 10:
            t, l = eng.step()[slot]
            toks.append(t)
            lps.append(l)
        torch.cuda.synchronize()
        runs.append((toks, lps, tca.LAUNCHES["decode_attention"],
                     tca.PAD_COPIES))
        assert not eng.pool.k[..., 40:].any() and not eng.pool.v[..., 40:].any()
    (gt, gl, launches, pads), (ct, cl, _, _) = runs
    assert launches == 9 * geom["depth"] and pads == 0
    assert gt == ct
    np.testing.assert_allclose(gl, cl, atol=1e-4)


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


def _payload(dev, shape, mode, seed):
    """A random payload of ``mode``: int8 in [-127, 127], bf16 or fp32
    near 1e-2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if mode == "int8":
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    v = torch.randn(shape, generator=g, device=dev) * 1e-2
    return v.to(torch.bfloat16) if mode == "bf16" else v


def _off_16_bytes(t):
    """A contiguous copy of ``t`` whose storage starts 4 bytes past 16."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    base[1:].copy_(t.reshape(-1))
    return base[1:].view(t.shape)


# K11's chunks past cifar10_full's three (W=4): at W=2, the edge leaves
# (EDGE_SHAPES: a slice of 300,001 floats, many tiles, worker slices off
# 16 bytes), the same with x and the mean 4 bytes past 16, and a chunk
# with an empty slice
CORR_EXTRA = ("edges", "x and mean off 16 bytes", "an empty slice")


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("ci", range(len(CIFAR_CHUNKS) + len(CORR_EXTRA)))
def test_comm_apply_correction_kernel_bitwise(dev, mode, ci):
    if ci < len(CIFAR_CHUNKS):
        shapes = CIFAR_CHUNKS[ci]
        modes = (mode,) * len(shapes)
        q, s, _, _ = tcc.encode_reference(
            _chunk(dev, shapes, 8, 1e-2), _chunk(dev, shapes, 9, 1e-2),
            _chunk(dev, shapes, 10, 1e-5), modes, False,
        )
        x, a = _chunk(dev, shapes, 11), _chunk(dev, shapes, 12)
        means = tuple(m[0].contiguous() for m in _chunk(dev, shapes, 13, 1e-2))
    else:
        case = CORR_EXTRA[ci - len(CIFAR_CHUNKS)]
        shapes = ((5,), (0,), (8_193,)) if case == "an empty slice" else EDGE_SHAPES
        modes = (mode,) * len(shapes)
        x, a = (_comm_leaves(dev, shapes, 2, seed, 1.0) for seed in (11, 12))
        means = [m[0].contiguous()
                 for m in _comm_leaves(dev, shapes, 2, 13, 1e-2)]
        if case == "x and mean off 16 bytes":
            x, means = [_off_16_bytes(t) for t in x], [_off_16_bytes(t) for t in means]
            assert x[0].data_ptr() % 16 == 4 and means[0].data_ptr() % 16 == 4
        q = [_payload(dev, (2,) + sh, mode, 14 + i) for i, sh in enumerate(shapes)]
        g = torch.Generator(device=dev).manual_seed(15)
        s = [torch.rand(2, generator=g, device=dev) * 1e-3 + 1e-4
             for _ in shapes]
    before = tcc.LAUNCHES["comm_apply_correction"]
    got = tcc.apply_correction(x, a, q, s, means, modes)
    torch.cuda.synchronize()
    assert tcc.LAUNCHES["comm_apply_correction"] == before + 1
    want = tcc.apply_correction_reference(x, a, q, s, means, modes)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _same_bits(g, w)


# AlexNet's 16 parameter leaves (alexnet_train_val.prototxt) at W=2 in the
# three byte-balanced chunks parallel/comm.py cuts them into, and a chunk
# of edge leaves: one float, 10 floats (worker slices off 16 bytes), a
# slice of 300,001 floats (many tiles, off 16 bytes) and 8,193 (one tile
# and one more float)
ALEXNET_SHAPES = ((96, 3, 11, 11), (96,), (256, 48, 5, 5), (256,),
                  (384, 256, 3, 3), (384,), (384, 192, 3, 3), (384,),
                  (256, 192, 3, 3), (256,), (4096, 9216), (4096,),
                  (4096, 4096), (4096,), (1000, 4096), (1000,))
ALEXNET_CHUNKS = (slice(0, 11), slice(11, 13), slice(13, 16))
EDGE_SHAPES = ((1,), (10,), (300_001,), (8_193,))


def _comm_leaves(dev, shapes, w, seed, scale):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((w,) + s, generator=g, device=dev) * scale
            for s in shapes]


def _edge_cases(x, a, r):
    """A NaN in worker 1 of the first big leaf, the last leaf all zero."""
    big = max(range(len(x)), key=lambda i: x[i].numel())
    x[big][1].view(-1)[12345 % x[big][1].numel()] = float("nan")
    for t in (x, a, r):
        t[-1].zero_()


def _check_encode(x, a, r, modes):
    for with_err in (False, True):
        got = tcc.encode(x, a, r, modes, with_err)
        want = tcc.encode_reference(x, a, r, modes, with_err)
        torch.cuda.synchronize()
        for g, w in zip(got[0] + got[1] + got[2], want[0] + want[1] + want[2]):
            _same_bits(g, w)
        if with_err:
            assert torch.equal(got[3][:, 0].isnan(), want[3][:, 0].isnan())
            ok = ~want[3][:, 0].isnan()
            assert torch.equal(got[3][ok, 0], want[3][ok, 0])
            torch.testing.assert_close(got[3][ok, 1:], want[3][ok, 1:],
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("chunk", range(len(ALEXNET_CHUNKS) + 1),
                         ids=["alexnet0", "alexnet1", "alexnet2", "edges"])
def test_comm_encode_kernel_bitwise_at_alexnet_width(dev, mode, chunk):
    """K9 over AlexNet's chunks at W=2 (fc6: 37,748,736 floats a worker)
    and the edge leaves, with a NaN and an all-zero leaf, the readout off
    and on."""
    shapes = (ALEXNET_SHAPES[ALEXNET_CHUNKS[chunk]] if chunk < 3
              else EDGE_SHAPES)
    x = _comm_leaves(dev, shapes, 2, 1, 1e-2)
    a = _comm_leaves(dev, shapes, 2, 2, 1e-2)
    r = _comm_leaves(dev, shapes, 2, 3, 1e-5)
    _edge_cases(x, a, r)
    before = tcc.LAUNCHES["comm_encode"]
    _check_encode(x, a, r, (mode,) * len(shapes))
    assert tcc.LAUNCHES["comm_encode"] == before + 2  # one a call


@pytest.mark.parametrize("alive,denom0", [([1, 1], 2.0), ([1, 0], 1.0),
                                          ([0, 0], 0.0)])
@pytest.mark.parametrize("chunk", range(len(ALEXNET_CHUNKS) + 1),
                         ids=["alexnet0", "alexnet1", "alexnet2", "edges"])
def test_comm_apply_barriered_kernel_bitwise_at_alexnet_width(dev, alive,
                                                              denom0, chunk):
    shapes = (ALEXNET_SHAPES[ALEXNET_CHUNKS[chunk]] if chunk < 3
              else EDGE_SHAPES)
    x, a, r = (_comm_leaves(dev, shapes, 2, s, 1.0) for s in (4, 5, 6))
    means = [m[0].contiguous() for m in _comm_leaves(dev, shapes, 2, 7, 1.0)]
    alive_t = torch.tensor(alive, dtype=torch.float32, device=dev)
    d0 = torch.tensor(denom0, device=dev)
    got = tcc.apply_barriered(x, a, means, r, alive_t, d0)
    want = tcc.apply_barriered_reference(x, a, means, r, alive_t, d0)
    torch.cuda.synchronize()
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _same_bits(g, w)


def test_comm_kernels_take_views_off_16_bytes(dev):
    """Leaves whose storage starts 4 bytes past 16: taken one float at a
    time, the same bits."""
    shapes = ((3, 70), (1001,))
    views = []
    for seed in (1, 2, 3, 4):
        leaves = []
        for s in shapes:
            n = 2 * int(np.prod(s))
            base = _rand(dev, n + 1, seed=seed) * 1e-2
            leaves.append(base[1:].view((2,) + s))
        views.append(leaves)
    x, a, r, m = views
    assert x[0].data_ptr() % 16 == 4
    for mode in ("fp32", "bf16", "int8"):
        _check_encode(x, a, r, (mode,) * len(shapes))
    means = [t[0] for t in m]
    for alive in ([1, 1], [0, 1]):
        al = torch.tensor(alive, dtype=torch.float32, device=dev)
        got = tcc.apply_barriered(x, a, means, r, al, al.sum())
        want = tcc.apply_barriered_reference(x, a, means, r, al, al.sum())
        torch.cuda.synchronize()
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            _same_bits(g, w)


def test_comm_encode_calls_agree_and_leave_the_counters_zero(dev):
    """Two calls on the same inputs give the same bits, readout sums
    included (a fixed reduction order), and so do two replays of one
    call captured in a CUDA graph: every call zeroes its own per-slice
    tickets, so no counter state carries from one call to the next."""
    shapes = EDGE_SHAPES
    x, a, r = (_comm_leaves(dev, shapes, 2, s, 1e-2) for s in (8, 9, 10))
    modes = ("int8",) * len(shapes)

    def flat(out):
        return out[0] + out[1] + out[2] + (out[3],)

    first = tcc.encode(x, a, r, modes, True)
    second = tcc.encode(x, a, r, modes, True)
    torch.cuda.synchronize()
    for g, w in zip(flat(first), flat(second)):
        _same_bits(g, w)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tcc.encode(x, a, r, modes, True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(flat(captured), flat(first)):
            _same_bits(g, w)


@pytest.mark.parametrize("n", [33, 64, 131])
def test_comm_kernels_take_a_chunk_of_any_leaf_count(dev, n):
    """A chunk of ``n`` > 32 leaves (ResNet-50's last chunk holds 267):
    K9 in every mode with the readout, K10 with a masked worker and K11,
    one launch a group of at most MAX_LEAVES leaves, each bitwise equal
    to its plain version over the whole chunk."""
    rs = np.random.RandomState(n)
    shapes = [tuple(rs.randint(1, 70, rs.randint(1, 3))) for _ in range(n)]
    x = _comm_leaves(dev, shapes, 2, 1, 1e-2)
    a = _comm_leaves(dev, shapes, 2, 2, 1e-2)
    r = _comm_leaves(dev, shapes, 2, 3, 1e-5)
    means = [t[0].contiguous() for t in _comm_leaves(dev, shapes, 2, 4, 1e-2)]
    groups = -(-n // tcc.MAX_LEAVES)
    modes = tuple(("int8", "bf16", "fp32")[i % 3] for i in range(n))
    tcc.reset_launch_counts()
    _check_encode(x, a, r, modes)
    assert tcc.LAUNCHES["comm_encode"] == 2 * groups
    al = torch.tensor([1.0, 0.0], device=dev)
    got = tcc.apply_barriered(x, a, means, r, al, al.sum())
    want = tcc.apply_barriered_reference(x, a, means, r, al, al.sum())
    q, s = tcc.encode_reference(x, a, r, modes, False)[:2]
    got_c = tcc.apply_correction(x, a, q, s, means, modes)
    want_c = tcc.apply_correction_reference(x, a, q, s, means, modes)
    torch.cuda.synchronize()
    for g, w in zip(got[0] + got[1] + got_c[0] + got_c[1],
                    want[0] + want[1] + want_c[0] + want_c[1]):
        _same_bits(g, w)
    assert tcc.LAUNCHES["comm_apply_barriered"] == groups
    assert tcc.LAUNCHES["comm_apply_correction"] == groups


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


# LRN cases: (shape, local_size, beta) — AlexNet's two LRN inputs at the
# training batch, a ragged shape, C < n, n = 3 and a beta on the powf path
LRN_CASES = [((32, 96, 55, 55), 5, 0.75), ((32, 256, 27, 27), 5, 0.75),
             ((2, 7, 11, 13), 5, 0.75), ((2, 3, 9, 9), 5, 0.75),
             ((2, 16, 9, 9), 3, 0.75), ((2, 16, 9, 9), 5, 0.6),
             ((2, 16, 5, 7), 4, 0.75)]
PLP_SHAPES = [(32, 96, 55, 55), (32, 256, 27, 27), (2, 7, 11, 13),
              (1, 32, 9, 9), (2, 5, 3, 3), (2, 40, 35, 37)]


@pytest.mark.parametrize("shape,n,beta", LRN_CASES)
def test_lrn_kernels_match_plain(dev, shape, n, beta):
    x = _rand(dev, *shape, seed=20)
    dy = _rand(dev, *shape, seed=21)
    before = dict(tcl.LAUNCHES)
    y = tcl.lrn_fwd(x, n, 1e-4, beta, 1.0)
    dx = tcl.lrn_bwd(x, dy, n, 1e-4, beta, 1.0)
    torch.cuda.synchronize()
    assert tcl.LAUNCHES["lrn_fwd"] == before["lrn_fwd"] + 1
    assert tcl.LAUNCHES["lrn_bwd"] == before["lrn_bwd"] + 1
    torch.testing.assert_close(y, tcl.lrn_across_reference(x, n, 1e-4, beta, 1.0),
                               rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(
        dx, tcl.lrn_across_bwd_reference(x, dy, n, 1e-4, beta, 1.0),
        rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("shape", [(32, 96, 55, 55), (32, 256, 27, 27),
                                   (16, 96, 55, 55), (16, 256, 27, 27)],
                         ids=["conv1", "conv2", "conv1-test", "conv2-test"])
@pytest.mark.parametrize("n,beta", [(5, 0.75), (5, 0.6), (3, 0.75)],
                         ids=["fast", "powf", "n3"])
def test_lrn_fwd_is_bit_equal_to_plain(dev, shape, n, beta):
    """K5 at AlexNet's two LRN inputs, at the training batch 32 and the
    test batch 16 (N x H x W is no multiple of a block's positions at
    any of them), with Caffe's default window and power (the FAST
    kernel) and with two other settings (the general kernel): every
    operation an explicitly rounded intrinsic in the plain version's
    order, so y equals the plain version's bits."""
    x = _rand(dev, *shape, seed=28)
    y = tcl.lrn_fwd(x, n, 1e-4, beta, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(y, tcl.lrn_across_reference(x, n, 1e-4, beta, 1.0))


@pytest.mark.parametrize("shape", [(64, 96, 55, 55), (64, 256, 27, 27),
                                   (3, 7, 5, 9)],
                         ids=["norm1", "norm2", "odd"])
@pytest.mark.parametrize("ties", [False, True])
def test_lrn_fwd_bf16_matches_plain(dev, shape, ties):
    """K5 in bfloat16 (CaffeNet's two LRN inputs at the top serving
    bucket, and an odd shape): float32 math on the widened input, one
    round-to-nearest-even narrowing at the store, the plain version's
    operations, so y equals its bits; K6 refuses bf16."""
    x = (_tie_input(dev, shape, 5) if ties else _rand(dev, *shape, seed=29))
    xb = x.to(torch.bfloat16)
    before = tcl.LAUNCHES["lrn_fwd"]
    y = tcl.lrn_fwd(xb, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert tcl.LAUNCHES["lrn_fwd"] == before + 1
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, tcl.lrn_fwd_bf16_reference(xb, 5, 1e-4, 0.75, 1.0))
    with pytest.raises(TypeError, match="bfloat16"):
        tcl.lrn_bwd(xb, xb, 5, 1e-4, 0.75, 1.0)


def _tie_input(dev, shape, seed):
    """x constant along channels over a period-2 spatial pattern of small
    integers: windows tie between columns 0 and 2, rows 0 and 2, and
    across the pattern's repeats."""
    n, c, h, w = shape
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 3, (n, 1, 2, 2)).astype(np.float32)
    plane = np.tile(base, (1, 1, (h + 1) // 2, (w + 1) // 2))[:, :, :h, :w]
    return torch.from_numpy(np.repeat(plane, c, axis=1).copy()).to(dev)


@pytest.mark.parametrize("shape", PLP_SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_lrn_pool_kernels_match_plain(dev, shape, ties):
    x = _tie_input(dev, shape, 22) if ties else _rand(dev, *shape, seed=22)
    ph, pw = tcp.pooled_hw(shape[2], shape[3])
    dy = _rand(dev, shape[0], shape[1], ph, pw, seed=23)
    before = dict(tcp.LAUNCHES)
    y = tcp.lrn_pool_fwd(x, 5, 1e-4, 0.75, 1.0)
    dx = tcp.lrn_pool_bwd(x, dy, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert tcp.LAUNCHES["lrn_pool_fwd"] == before["lrn_pool_fwd"] + 1
    assert tcp.LAUNCHES["lrn_pool_bwd"] == before["lrn_pool_bwd"] + 1
    torch.testing.assert_close(y, tcp.lrn_maxpool_reference(x, 5, 1e-4, 0.75, 1.0),
                               rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(
        dx, tcp.lrn_maxpool_bwd_reference(x, dy, 5, 1e-4, 0.75, 1.0),
        rtol=5e-5, atol=5e-6)
    # alpha = 0: the LRN is the identity and K8 returns the routed
    # gradient itself, which must equal the plain routing bit for bit
    routed = tcp.lrn_pool_bwd(x, dy, 5, 0.0, 0.75, 1.0)
    assert torch.equal(routed, tcp.route_reference(x, dy))


@pytest.mark.parametrize("shape", [(32, 96, 55, 55), (32, 256, 27, 27)],
                         ids=["conv1", "conv2"])
@pytest.mark.parametrize("ties", [False, True])
def test_lrn_pool_bwd_is_bit_equal_to_plain(dev, shape, ties):
    """K8 at AlexNet's two sandwiches, random and tied inputs: every
    operation an explicitly rounded intrinsic in the plain version's
    order, so dx equals the plain version's bit for bit."""
    x = _tie_input(dev, shape, 24) if ties else _rand(dev, *shape, seed=24)
    ph, pw = tcp.pooled_hw(shape[2], shape[3])
    dy = _rand(dev, shape[0], shape[1], ph, pw, seed=25)
    dx = tcp.lrn_pool_bwd(x, dy, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(dx, tcp.lrn_maxpool_bwd_reference(x, dy, 5, 1e-4, 0.75, 1.0))


@pytest.mark.parametrize("shape", [(32, 96, 55, 55), (32, 256, 27, 27)],
                         ids=["conv1", "conv2"])
@pytest.mark.parametrize("ties", [False, True])
def test_lrn_pool_fwd_and_lrn_bwd_are_bit_equal_to_plain(dev, shape, ties):
    """K7 and K6 at AlexNet's two sandwiches, random and tied inputs: every
    LRN operation an explicitly rounded intrinsic in the plain version's
    order, so both give the plain versions' bits."""
    x = _tie_input(dev, shape, 26) if ties else _rand(dev, *shape, seed=26)
    dy = _rand(dev, *shape, seed=27)
    y = tcp.lrn_pool_fwd(x, 5, 1e-4, 0.75, 1.0)
    dx = tcl.lrn_bwd(x, dy, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(y, tcp.lrn_maxpool_reference(x, 5, 1e-4, 0.75, 1.0))
    assert torch.equal(dx, tcl.lrn_across_bwd_reference(x, dy, 5, 1e-4, 0.75,
                                                        1.0))


@pytest.mark.parametrize("shape", [(2, 16, 27, 27), (2, 24, 55, 55)],
                         ids=["whole-plane", "row-bands"])
@pytest.mark.parametrize("n,beta", [(3, 0.75), (7, 0.75), (5, 0.6), (5, 0.5)])
def test_lrn_pool_kernels_are_bit_equal_at_other_lrn_settings(dev, shape, n,
                                                              beta):
    """K7 and K8 in their general instantiation (any LRN setting but
    Caffe's default, which takes FAST): local_size 3 and 7, beta on the
    powf path (0.6) and the square-root path (0.5), on a plane of each of
    K7's tile kinds; both give the plain versions' bits."""
    hp = (n, 1e-4, beta, 1.0)
    x = _rand(dev, *shape, seed=30)
    ph, pw = tcp.pooled_hw(shape[2], shape[3])
    dy = _rand(dev, shape[0], shape[1], ph, pw, seed=31)
    before = dict(tcp.LAUNCHES)
    y = tcp.lrn_pool_fwd(x, *hp)
    dx = tcp.lrn_pool_bwd(x, dy, *hp)
    torch.cuda.synchronize()
    assert tcp.LAUNCHES["lrn_pool_fwd"] == before["lrn_pool_fwd"] + 1
    assert tcp.LAUNCHES["lrn_pool_bwd"] == before["lrn_pool_bwd"] + 1
    assert torch.equal(y, tcp.lrn_maxpool_reference(x, *hp))
    assert torch.equal(dx, tcp.lrn_maxpool_bwd_reference(x, dy, *hp))


def test_lrn_pool_fwd_takes_wide_planes_and_misaligned_views(dev):
    """K7's column tiles (a plane too wide for whole rows in one block)
    and channel runs that start off 16 bytes."""
    wide = _rand(dev, 1, 3, 5, 701, seed=28)
    view = _rand(dev, 2 * 5 * 11 * 13 + 1, seed=29)[1:].view(2, 5, 11, 13)
    for x in (wide, view):
        y = tcp.lrn_pool_fwd(x, 5, 1e-4, 0.75, 1.0)
        torch.cuda.synchronize()
        assert torch.equal(y, tcp.lrn_maxpool_reference(x, 5, 1e-4, 0.75, 1.0))


def test_lrn_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = _rand(dev, 2, 8, 9, 9)
    with pytest.raises(TypeError, match="float32"):
        tcl.lrn_fwd(x.double(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tcl.lrn_fwd(x.transpose(2, 3), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="NCHW"):
        tcl.lrn_fwd(x[0], 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="local_size"):
        tcl.lrn_fwd(x, 17, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="fusable"):
        tcp.lrn_pool_fwd(_rand(dev, 2, 8, 10, 9), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="fusable"):
        tcp.lrn_pool_fwd(x, 4, 1e-4, 0.75, 1.0)
