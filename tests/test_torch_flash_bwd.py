"""The port's flash backward (K3 dq, K4 dk/dv) against the JAX package's.

Same seeded numpy inputs through ``jax.grad`` of
``sparknet_tpu.ops.pallas_attention`` (its Pallas kernels in interpret
mode, forward and ``custom_vjp`` backward) and through the port's
``torch.autograd`` of ``ops.cuda_attention`` — the autograd Function
around ``_flash_core``, whose backward takes the plain versions of K3
and K4 on CPU tensors.  The step loss uses both ``o`` and ``lse``, so
the backward's ``dlse`` term is nonzero.  Tolerance 5e-5 absolute (the
JAX package's flash gradient tolerance, KERNELS_r21 ``flash_grad_tol``):
float32 on both sides, summed in different orders.

The precision scheme of the CUDA kernels (``ops/csrc/flash_bwd.cu``):
every product runs on the tensor cores as three TF32 products of split
operands.  A numpy emulation of that arithmetic at the LM training shape
stays within the on-card tolerance (``BWD_RTOL`` of ``chip_smoke.py``) of
the plain float32 versions, which are held to the JAX kernels there; a
single TF32 pass does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.ops import pallas_attention as jpa
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops.attention import mha_reference as t_mha

GRAD_TOL = 5e-5
B, H, D = 2, 2, 8


def _inputs(seed, tq, tk):
    r = np.random.RandomState(seed)
    q = r.randn(B, tq, H, D).astype(np.float32)
    k = r.randn(B, tk, H, D).astype(np.float32)
    v = r.randn(B, tk, H, D).astype(np.float32)
    wo = r.randn(B, H, tq, D).astype(np.float32)  # o's weights, JAX layout
    wl = r.randn(B, H, tq).astype(np.float32)     # lse's weights
    return q, k, v, wo, wl


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


def _assert_grads(got, want):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize(
    "tq,tk,q_off,k_off,causal",
    [
        (16, 16, 0, 0, True),
        (16, 16, 0, 0, False),
        (12, 16, 16, 0, True),   # every key visible from shifted queries
        (12, 16, 0, 8, True),    # rows 0..7 see no key: (0, -inf)
        (13, 16, 0, 0, True),    # ragged T_q (block_q 8 pads it in JAX)
        (13, 16, 0, 0, False),
    ],
)
def test_step_grads_through_o_and_lse_match_jax(tq, tk, q_off, k_off, causal):
    q, k, v, wo, wl = _inputs(tq * 31 + tk + q_off + k_off, tq, tk)

    def jloss(q, k, v):
        o, lse = jpa.flash_attention_step(q, k, v, q_off, k_off, causal=causal,
                                          block_q=8, interpret=True)
        lse = jnp.where(jnp.isfinite(lse), lse, 0.0)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
    o, lse = tca.flash_attention_step(qt, kt, vt, q_off, k_off, causal=causal)
    assert tuple(o.shape) == (B, H, tq, D) and tuple(lse.shape) == (B, H, tq)
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    loss = (o * torch.from_numpy(wo)).sum() + (lse * torch.from_numpy(wl)).sum()
    loss.backward()
    _assert_grads([t.grad.numpy() for t in (qt, kt, vt)], want)
    if (q_off, k_off) == (0, 8):  # masked rows pass no gradient to q
        assert float(qt.grad[:, :8].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(16, 16), (13, 13), (8, 24)])
def test_flash_attention_grads_match_jax_and_dense(causal, tq, tk):
    """End-aligned ``flash_attention``: grads of the o-only loss against
    ``jax.grad`` of the Pallas path and against autograd through the
    port's dense ``mha_reference`` (an independent derivation)."""
    q, k, v, wo, _ = _inputs(7 + tq + tk, tq, tk)
    w_bthd = np.ascontiguousarray(wo.transpose(0, 2, 1, 3))

    def jloss(q, k, v):
        o = jpa.flash_attention(q, k, v, causal=causal, block_q=8,
                                interpret=True)
        return jnp.sum(o * w_bthd)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    grads = []
    for fn in (lambda *a: tca.flash_attention(*a, causal=causal),
               lambda *a: t_mha(*a, causal=causal)):
        qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
        (fn(qt, kt, vt) * torch.from_numpy(w_bthd)).sum().backward()
        grads.append([t.grad.numpy() for t in (qt, kt, vt)])
    _assert_grads(grads[0], want)
    _assert_grads(grads[0], grads[1])


def test_plain_backward_terms_match_the_jax_kernels_formulas():
    """The plain versions of K3 and K4 called directly, with a nonzero
    dlse and fully-masked rows, against the same formulas in numpy
    (float64)."""
    tq, tk, q_off, k_off = 12, 16, 0, 8
    q, k, v, _, _ = _inputs(3, tq, tk)
    r = np.random.RandomState(4)
    do = r.randn(B, tq, H, D).astype(np.float32)
    dlse = r.randn(B, H, tq).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = tca._flash_core_reference(t[0], t[1], t[2], q_off, k_off, True)
    args = (t[0], t[1], t[2], t[3], o, lse, torch.from_numpy(dlse),
            q_off, k_off, True)
    dq = tca.flash_bwd_dq(*args).numpy()
    dk, dv = (x.numpy() for x in tca.flash_bwd_dkv(*args))

    qd, kd, vd, dod = (a.astype(np.float64).transpose(0, 2, 1, 3)
                       for a in (q, k, v, do))
    od = o.numpy().astype(np.float64).transpose(0, 2, 1, 3)
    lsed = lse.numpy().astype(np.float64)
    scale = 1.0 / np.sqrt(D)
    s = np.einsum("bhqd,bhkd->bhqk", qd, kd) * scale
    mask = (k_off + np.arange(tk))[None, :] <= (q_off + np.arange(tq))[:, None]
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - np.where(np.isfinite(lsed), lsed, 0.0)[..., None])
    delta = (dod * od).sum(-1) - dlse
    ds = p * (np.einsum("bhqd,bhkd->bhqk", dod, vd) - delta[..., None]) * scale
    want = {
        "dq": np.einsum("bhqk,bhkd->bqhd", ds, kd),
        "dk": np.einsum("bhqk,bhqd->bkhd", ds, qd),
        "dv": np.einsum("bhqk,bhqd->bkhd", p, dod),
    }
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got, want[name], atol=1e-5, err_msg=name)
    assert np.all(dq[:, :8] == 0.0)


# ----------------------------------------------------------------------
# the kernels' split-TF32 products, emulated
# ----------------------------------------------------------------------
BWD_RTOL = 2e-5  # K3/K4 against their plain versions (chip_smoke.py)


def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties
    away from zero (the 13 dropped bits cleared)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """``a @ b`` as K3/K4 form it: 8-deep steps (one m16n8k8 each), each
    summed into a fresh float32 accumulator and then added to the total.
    Three passes take ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with ``hi =
    tf32(x)``, ``lo = tf32(x - hi)``; one pass takes ``a_hi b_hi``."""
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


def _tf32_flash_bwd(q, k, v, do, o, lse, dlse, passes):
    """(dq, dk, dv) of the causal flash backward, (B, H, T, D) float32
    arrays, with every product emulated as ``_tf32_matmul``."""
    t, d = q.shape[2], q.shape[3]
    scale = np.float32(1.0 / np.sqrt(d))
    s = _tf32_matmul(q, k.swapaxes(-1, -2), passes) * scale
    lse_safe = np.where(np.isfinite(lse), lse, np.float32(0))
    mask = np.tril(np.ones((t, t), bool))
    p = np.exp(np.where(mask, s - lse_safe[..., None], -np.inf))
    delta = (do * o).sum(-1, dtype=np.float32) - dlse
    dp = _tf32_matmul(do, v.swapaxes(-1, -2), passes)
    ds = p * (dp - delta[..., None]) * scale
    return (_tf32_matmul(ds, k, passes),
            _tf32_matmul(ds.swapaxes(-1, -2), q, passes),
            _tf32_matmul(p.swapaxes(-1, -2), do, passes))


def _scaled_err(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("passes", [3, 1])
def test_split_tf32_keeps_the_kernel_tolerance_where_one_pass_does_not(passes):
    """At the LM training shape (B=8, T=256, H=4, D=64, causal, dlse !=
    0): the plain float32 K3/K4 against the JAX kernels in interpret mode
    on the same inputs, then the kernels' 3xTF32 arithmetic against the
    plain versions within BWD_RTOL of each output's magnitude, and one
    TF32 pass outside it, so the split is what holds the tolerance."""
    nb, t, h, d = 8, 256, 4, 64
    r = np.random.RandomState(21)
    q, k, v, do = (r.randn(nb, t, h, d).astype(np.float32) for _ in range(4))
    dlse = r.randn(nb, h, t).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tca._flash_core_reference(tq, tk, tv, 0, 0, True)
    args = (tq, tk, tv, tdo, o, lse, torch.from_numpy(dlse), 0, 0, True)
    plain = [tca.flash_bwd_dq(*args).numpy(),
             *(x.numpy() for x in tca.flash_bwd_dkv(*args))]

    def heads(x):  # (B, T, H, D) -> (B, H, T, D)
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3))

    flat = [heads(x).reshape(nb * h, t, d) for x in (q, k, v, o.numpy(), do)]
    res = (*flat[:3], jnp.zeros((1, 2), jnp.float32), flat[3],
           lse.numpy().reshape(nb * h, t))
    jax_grads = jpa._flash_core_bwd(True, 128, True, res,
                                    (flat[4], dlse.reshape(nb * h, t)))[:3]
    for got, want, name in zip(plain, jax_grads, ("dq", "dk", "dv")):
        want = np.asarray(want).reshape(nb, h, t, d).transpose(0, 2, 1, 3)
        assert _scaled_err(got, want) <= BWD_RTOL, name

    emulated = _tf32_flash_bwd(*(heads(x) for x in (q, k, v, do, o.numpy())),
                               lse.numpy(), dlse, passes)
    errs = [_scaled_err(heads(p_), e) for p_, e in zip(plain, emulated)]
    if passes == 3:
        assert max(errs) <= BWD_RTOL, errs
    else:
        assert min(errs) > BWD_RTOL, errs
