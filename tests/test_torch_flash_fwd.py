"""The port's flash forward (K1) against the JAX package's, and the
alignment policy of the flash kernels' autograd path, on the CPU.

The precision scheme of the CUDA kernel (``ops/csrc/flash_fwd.cu``): both
products (``s = q k^T`` and ``p v``) run on the tensor cores as three TF32
products of split operands, the online softmax in float32, F_SPLIT = 4
warps sharing each 16 query rows, each on its own 16-key slice of every
stage, their partials merged in split order.  A numpy emulation of that
arithmetic, at a serving prefill shape and a reduced LM training shape,
stays within the on-card tolerance (``KERNEL_ATOL`` of ``chip_smoke.py``,
2e-5 absolute) of the plain float32 version, which is held to the JAX
kernel in interpret mode on the same inputs; a single TF32 pass does not.

K1, K3 and K4 copy (B, T, H, D) rows into shared memory 16 bytes at a
time.  The wrappers refuse rows that are not 16-byte aligned; the
autograd path hands them a contiguous copy instead (``_kernel_rows``).
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.ops import pallas_attention as jpa
from sparknet_tpu_torch.ops import cuda_attention as tca

KERNEL_ATOL = 2e-5  # K1 against its plain version (chip_smoke.py)
SPLIT, SLICE = 4, 16  # K1's warps per 16 rows and keys per warp and stage


def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties
    away from zero (the 13 dropped bits cleared)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """``a @ b`` as the kernels form it: 8-deep steps (one m16n8k8 each),
    each summed into a fresh float32 accumulator and then added to the
    total; three passes take ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, one
    pass ``a_hi b_hi``."""
    total = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for c in range(0, a.shape[-1], 8):
        ac, bc = a[..., c:c + 8], b[..., c:c + 8, :]
        ah, bh = _tf32(ac), _tf32(bc)
        step = np.matmul(ah, bh)
        if passes == 3:
            step = (np.matmul(_tf32(ac - ah), bh)
                    + np.matmul(ah, _tf32(bc - bh))) + step
        total += step
    return total


def _k1_emulated(q, k, v, passes):
    """(o, lse) of the causal forward, (N, T, D) float32 arrays, in K1's
    order: SLICE-key slices dealt round-robin to SPLIT online softmaxes,
    each product as ``_tf32_matmul``, the partials merged in split order."""
    n, t, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    s = _tf32_matmul(q, k.swapaxes(-1, -2), passes) * scale
    s = np.where(np.tril(np.ones((t, t), bool)), s, np.float32(-np.inf))
    m = np.full((SPLIT, n, t), -np.inf, np.float32)
    l = np.zeros((SPLIT, n, t), np.float32)
    acc = np.zeros((SPLIT, n, t, d), np.float32)
    with np.errstate(invalid="ignore"):
        for i, c in enumerate(range(0, t, SLICE)):
            sp = i % SPLIT
            sc = s[..., c:c + SLICE]
            mn = np.maximum(m[sp], sc.max(-1))
            mu = np.where(np.isneginf(mn), np.float32(0), mn)
            alpha = np.exp(m[sp] - mu)
            p = np.exp(sc - mu[..., None])
            l[sp] = l[sp] * alpha + p.sum(-1, dtype=np.float32)
            m[sp] = mn
            acc[sp] = acc[sp] * alpha[..., None]
            for k in range(c, c + SLICE, 8):  # one m16n8k8 step of keys
                acc[sp] += _tf32_matmul(p[..., k - c:k - c + 8],
                                        v[:, k:k + 8], passes)
    big = m.max(0)
    mu = np.where(np.isneginf(big), np.float32(0), big)
    w = np.exp(m - mu)
    total = (l * w).sum(0, dtype=np.float32)
    o = (acc * w[..., None]).sum(0, dtype=np.float32)
    o = o / np.maximum(total, np.float32(1e-30))[..., None]
    lse = np.where(total > 0, mu + np.log(np.maximum(total, 1e-30)), -np.inf)
    return o, lse.astype(np.float32)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("b,t", [(1, 128), (2, 256)],
                         ids=["serving-prefill", "lm-training-reduced"])
def test_split_tf32_keeps_the_kernel_tolerance_where_one_pass_does_not(
        b, t, passes):
    """B=1 T=128 (the serving prefill bucket) and B=2 T=256 (the LM
    training shape at a quarter of its batch), H=4, D=64, causal: the
    plain float32 K1 against the JAX kernel in interpret mode, then K1's
    3xTF32 arithmetic against the plain version within KERNEL_ATOL, and
    one TF32 pass outside it."""
    h, d = 4, 64
    r = np.random.RandomState(31 + t)
    q, k, v = (r.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    o_j, lse_j = jpa.flash_attention_step(q, k, v, 0, 0, causal=True,
                                          block_q=128, interpret=True)
    o, lse = tca._flash_core(*(torch.from_numpy(x) for x in (q, k, v)),
                             0, 0, True)
    o_bhtd = o.permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(o_bhtd, np.asarray(o_j), atol=KERNEL_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=KERNEL_ATOL)

    def heads(x):  # (B, T, H, D) -> (B*H, T, D)
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * h, t, d)

    eo, el = _k1_emulated(heads(q), heads(k), heads(v), passes)
    err = max(float(np.abs(eo - o_bhtd.reshape(b * h, t, d)).max()),
              float(np.abs(el - lse.numpy().reshape(b * h, t)).max()))
    if passes == 3:
        assert err <= KERNEL_ATOL, err
    else:
        assert err > KERNEL_ATOL, err


def _offset_view(shape, seed=0):
    """A (B, T, H, D) float32 view whose base sits one float past an
    aligned allocation: no row of it starts on 16 bytes."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(int(np.prod(shape)) + 1, generator=g)
    return flat[1:].view(shape)


def test_the_autograd_path_copies_rows_the_kernels_cannot_load():
    """The copy decision of ``_FlashCore``: a view offset by one float is
    copied (contiguous, aligned, the same values, counted), an aligned
    tensor and one without unit stride along D pass as they are (the
    latter for the wrapper to refuse)."""
    tca.reset_launch_counts()
    off = _offset_view((1, 8, 2, 64))
    assert off.data_ptr() % 16 == 4 and not tca._rows_aligned(off)
    fixed = tca._kernel_rows(off)
    assert fixed is not off and fixed.is_contiguous()
    assert fixed.data_ptr() % 16 == 0 and tca._rows_aligned(fixed)
    assert torch.equal(fixed, off)
    assert tca.ALIGN_COPIES == 1
    aligned = torch.randn(1, 8, 2, 64)
    assert tca._kernel_rows(aligned) is aligned
    transposed = aligned.transpose(-1, -2)
    assert tca._kernel_rows(transposed) is transposed
    assert tca.ALIGN_COPIES == 1
    tca.reset_launch_counts()
    assert tca.ALIGN_COPIES == 0


def test_the_wrappers_refuse_misaligned_rows(monkeypatch):
    """With the device check reporting a card, K1's wrapper raises on a
    view offset by one float before anything is built."""
    monkeypatch.setattr(tca, "_on_cpu", lambda t: False)
    off = _offset_view((1, 8, 2, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tca._flash_core(off, off, off, 0, 0, True)


def test_gradients_through_an_offset_view_match_an_aligned_copy():
    """On the CPU the plain versions run; the offset view's gradients
    equal those of the same values in an aligned tensor."""
    grads = []
    for aligned in (False, True):
        q = _offset_view((1, 24, 2, 64), seed=1)
        if aligned:
            q = q.clone()
        q.requires_grad_(True)
        k, v = (torch.randn(1, 24, 2, 64, generator=torch.Generator()
                            .manual_seed(s)) for s in (2, 3))
        tca.flash_attention(q, k, v, causal=True).sum().backward()
        grads.append(q.grad)
    assert torch.equal(grads[0], grads[1])
