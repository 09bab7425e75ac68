"""The port's cross-channel LRN (``ops/cuda_lrn.py``) against the JAX
package's, on the CPU.

The plain versions of K5 (forward) and K6 (backward) take the same
numpy-seeded inputs as the JAX Pallas LRN in interpret mode
(``sparknet_tpu.ops.pallas_lrn.lrn_across_channels``) and the XLA
``custom_vjp`` form (``sparknet_tpu.ops.vision.lrn_across_channels``).
Tolerances are the JAX tests': forward rtol 2e-5 / atol 2e-6, backward
5e-5 / 5e-6 (float32 on both sides, the same formulas, summed in the
same order but rounded by other libraries).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops import pallas_lrn
from sparknet_tpu.ops import vision as jvision
from sparknet_tpu_torch.ops import cuda_lrn

FWD = dict(rtol=2e-5, atol=2e-6)
BWD = dict(rtol=5e-5, atol=5e-6)

# (shape, local_size, alpha, beta, k): AlexNet's LRN at a small batch, a
# ragged shape, C < n, n = 3, an even n, and a beta on the pow path
CASES = [
    ((2, 96, 13, 13), 5, 1e-4, 0.75, 1.0),
    ((2, 7, 11, 13), 5, 1e-4, 0.75, 1.0),
    ((2, 3, 9, 9), 5, 1e-4, 0.75, 1.0),
    ((1, 16, 5, 7), 3, 1e-3, 0.75, 2.0),
    ((1, 16, 5, 7), 4, 1e-3, 0.75, 1.0),
    ((1, 16, 5, 7), 5, 1e-2, 0.6, 1.0),
]


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 3).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, dy


def _jax_fwd_bwd(fn, x, dy):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("shape,n,alpha,beta,k", CASES)
def test_plain_lrn_matches_the_pallas_kernel(shape, n, alpha, beta, k):
    x, dy = _inputs(shape, 0)
    y_j, dx_j = _jax_fwd_bwd(
        lambda v: pallas_lrn.lrn_across_channels(v, n, alpha, beta, k, True),
        x, dy)
    xt = torch.from_numpy(x)
    y = cuda_lrn.lrn_across_reference(xt, n, alpha, beta, k)
    dx = cuda_lrn.lrn_across_bwd_reference(xt, torch.from_numpy(dy), n, alpha,
                                           beta, k)
    np.testing.assert_allclose(y.numpy(), y_j, **FWD)
    np.testing.assert_allclose(dx.numpy(), dx_j, **BWD)


@pytest.mark.parametrize("shape,n,alpha,beta,k", CASES)
def test_lrn_op_matches_the_xla_form(shape, n, alpha, beta, k):
    """The differentiable op (CPU tensors: the plain version through the
    autograd Function) against JAX's custom_vjp form."""
    x, dy = _inputs(shape, 1)
    y_j, dx_j = _jax_fwd_bwd(
        lambda v: jvision.lrn_across_channels(v, n, alpha, beta, k), x, dy)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = cuda_lrn.lrn_across_channels(xt, n, alpha, beta, k)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), y_j, **FWD)
    np.testing.assert_allclose(dx.numpy(), dx_j, **BWD)


def test_window_sum_is_the_pallas_order():
    """Centre, then post side, then pre side — the order the kernels add
    in — bit for bit against the Pallas helper on a (C, L) block."""
    v = np.random.RandomState(2).rand(9, 40).astype(np.float32) * 1e3
    for n in (1, 2, 3, 5, 12):
        want = np.asarray(pallas_lrn._window_sum(jnp.asarray(v), n))
        got = cuda_lrn.window_sum(torch.from_numpy(v)[None, :, :, None], n)
        assert np.array_equal(got[0, :, :, 0].numpy(), want)


@pytest.mark.parametrize("beta", [0.75, 0.5, 0.6, 1.0])
def test_fast_negpow_matches_the_jax_composition(beta):
    """Within a few ulp (rtol 1e-6): each library's rsqrt is its own
    approximation, and up to three products follow it."""
    s = np.random.RandomState(3).uniform(1.0, 5.0, 1000).astype(np.float32)
    want = np.asarray(jvision._fast_negpow(jnp.asarray(s), beta))
    got = cuda_lrn.fast_negpow(torch.from_numpy(s), beta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_kernel_arguments():
    """What the wrappers hand the kernels: the window's reach, alpha/n,
    the backward's coefficient and the negpow path."""
    assert cuda_lrn.hp_args("t", 5, 1e-4, 0.75, 1.0)[:2] == (2, 2)
    assert cuda_lrn.hp_args("t", 4, 1e-4, 0.75, 1.0)[:2] == (1, 2)
    assert cuda_lrn.negpow_q(0.75) == 3 and cuda_lrn.negpow_q(0.6) == 0
    with pytest.raises(ValueError, match="local_size"):
        cuda_lrn.hp_args("t", 16, 1e-4, 0.75, 1.0)
