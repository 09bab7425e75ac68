"""Head dims off the kernels' builds, and above 128, on the CPU.

The kernels are built for every multiple of 16 up to 128 and every
multiple of 32 up to 256.  On the card ``ops/cuda_attention.py``
zero-pads q, k and v once (the
autograd path's forward keeps them, and o, padded for its backward, which
pads do; decode pads q and its context) up to the next built head dim,
launches the kernels with the scale of the true D, and slices o, dq, dk
and dv back to D.  Here:

- D = 24, 40 and 100 through ``flash_attention`` (the wrappers' plain
  versions on CPU tensors) against the JAX ``flash_attention`` (Pallas in
  interpret mode) and against ``mha_reference``, forward and gradients,
  and through ``decode_attention`` against the JAX decode kernel;
- D = 256 (B = 1, T = 16, H = 2) the same way, the widest build, whose
  kernels split the output's columns into halves;
- the padding itself: the flash plain versions on the padded tensors
  with the true scale, sliced back, against the same on the unpadded
  tensors (zero columns add nothing to q.kT; lse unchanged), with the
  copies counted in ``PAD_COPIES``, up to D = 250 (padded to 256);
- a head dim above 256 raises on the card, naming the limit.

Tolerances are those of ``tests/test_torch_attention.py`` (1e-5) and
``tests/test_torch_flash_bwd.py`` (5e-5): float32 summed in other orders.
"""

import math

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.ops import pallas_attention as jpa
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops.attention import mha_reference as t_mha

ATOL, GRAD_TOL = 1e-5, 5e-5
PAD_TOL = 1e-6  # the same float32 sums with zero terms added
ODD_DIMS = (24, 40, 100)


def _rand(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


@pytest.mark.parametrize("d", ODD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_and_dense(d, causal):
    q, k, v, w = _rand(d, (2, 13, 2, d), (2, 16, 2, d), (2, 16, 2, d),
                       (2, 13, 2, d))

    def jloss(q, k, v):
        o = jpa.flash_attention(q, k, v, causal=causal, block_q=8,
                                interpret=True)
        return (o * w).sum(), o

    (_, want_o), want = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    legs = {}
    for leg, fn in (("flash", tca.flash_attention), ("dense", t_mha)):
        qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
        o = fn(qt, kt, vt, causal=causal)
        (o * torch.from_numpy(w)).sum().backward()
        legs[leg] = (o.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)])
    o, grads = legs["flash"]
    np.testing.assert_allclose(o, np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(o, legs["dense"][0], atol=ATOL)
    for g, jg, dg, name in zip(grads, want, legs["dense"][1], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(jg), atol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g, dg, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("d", ODD_DIMS)
def test_decode_attention_matches_jax(d):
    q, k, v = _rand(d + 1, (3, 1, 2, d), (3, 16, 2, d), (3, 16, 2, d))
    lengths = np.array([3, 16, 9], np.int32)
    want = np.asarray(jpa.decode_attention(q, k, v, lengths, interpret=True))
    got = tca.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_and_decode_match_jax_at_head_dim_256(causal):
    d = 256
    q, k, v, w = _rand(d, (1, 16, 2, d), (1, 16, 2, d), (1, 16, 2, d),
                       (1, 16, 2, d))

    def jloss(q, k, v):
        o = jpa.flash_attention(q, k, v, causal=causal, block_q=8,
                                interpret=True)
        return (o * w).sum(), o

    (_, want_o), want = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
    o = tca.flash_attention(qt, kt, vt, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), atol=ATOL)
    for t, jg, name in zip((qt, kt, vt), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=GRAD_TOL, err_msg=name)
    lengths = np.array([9], np.int32)
    want_d = np.asarray(jpa.decode_attention(q[:, :1], k, v, lengths,
                                             interpret=True))
    got_d = tca.decode_attention(*(torch.from_numpy(a) for a in (q[:, :1], k, v)),
                                 torch.from_numpy(lengths))
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=ATOL)


@pytest.mark.parametrize("d", (1, 8) + ODD_DIMS + (144, 200, 250))
def test_padding_leaves_the_plain_versions_unchanged(d):
    """What the wrappers do around a launch, with the plain versions in
    the kernels' place."""
    dp = tca._kernel_head_dim("test", d)
    step = 16 if d <= 128 else 32
    assert dp % step == 0 and d <= dp < d + step and dp in tca.KERNEL_HEAD_DIMS
    q, k, v, do = (torch.from_numpy(a) for a in _rand(
        d + 2, (2, 12, 2, d), (2, 16, 2, d), (2, 16, 2, d), (2, 12, 2, d)))
    scale = 1.0 / math.sqrt(d)
    tca.reset_launch_counts()
    qp, kp, vp, dop = (tca._pad_head(t, dp) for t in (q, k, v, do))
    assert tca.PAD_COPIES == 4
    assert all(bool((t[..., d:] == 0).all())
               for t in (qp, kp, vp, dop))
    pos = (4, 0, True)
    o, lse = tca._flash_core_reference(q, k, v, *pos)
    op, lsep = tca._flash_core_reference(qp, kp, vp, *pos, scale=scale)
    torch.testing.assert_close(op[..., :d], o, rtol=0, atol=PAD_TOL)
    assert float(op[..., d:].abs().max()) == 0.0
    torch.testing.assert_close(lsep, lse, rtol=0, atol=PAD_TOL)
    dlse = torch.from_numpy(_rand(d + 3, tuple(lse.shape))[0])
    args = (q, k, v, do, o, lse, dlse, *pos)
    argsp = (qp, kp, vp, dop, tca._pad_head(o, dp), lse, dlse, *pos)
    want = [tca._flash_bwd_dq_reference(*args),
            *tca._flash_bwd_dkv_reference(*args)]
    got = [tca._flash_bwd_dq_reference(*argsp, scale=scale),
           *tca._flash_bwd_dkv_reference(*argsp, scale=scale)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :d], w, rtol=0, atol=PAD_TOL)
    assert tca._pad_head(qp, dp) is qp  # a built head dim is not copied


def test_head_dims_above_128_raise_naming_the_limit(monkeypatch):
    """Above the widest build (256; up to 128 until the builds above it)
    every wrapper raises, naming the limit, and launches nothing."""
    monkeypatch.setattr(tca, "_on_cpu", lambda t: False)  # stand in for a card
    q = torch.zeros((1, 8, 2, 272))
    lse = torch.zeros((1, 2, 8))
    msg = r"head_dim 272 is above the kernels' limit of 256"
    with pytest.raises(ValueError, match=msg):
        tca.flash_attention(q, q, q)
    with pytest.raises(ValueError, match=msg):
        tca.decode_attention(q[:, :1], q, q)
    for fn in (tca.flash_bwd_dq, tca.flash_bwd_dkv):
        with pytest.raises(ValueError, match=msg):
            fn(q, q, q, q, q, lse, lse, 0, 0, True)
    assert all(v == 0 for v in tca.LAUNCHES.values())
