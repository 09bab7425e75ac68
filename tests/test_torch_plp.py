"""The port's fused LRN + 3x3/2 max pool (``ops/cuda_plp.py``) against
the JAX package's, on the CPU.

The plain versions of K7 (forward) and K8 (backward) take the same
numpy-seeded inputs as ``sparknet_tpu.ops.pallas_plp.lrn_maxpool`` in
interpret mode, on the JAX tests' shapes (``tests/test_pallas_plp.py``)
with their sin-weighted cotangent.  Tolerances are the JAX tests':
forward rtol 2e-5 / atol 2e-6, backward 5e-5 / 5e-6.  With ties in the
pooled windows the gradient's routing must be the Pallas kernel's
exactly: with alpha = 0 the LRN is the identity, so the backward IS the
routed gradient, and the two must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops import pallas_plp
from sparknet_tpu_torch.ops import cuda_plp

PARAMS = (5, 1e-4, 0.75, 1.0)
FWD = dict(rtol=2e-5, atol=2e-6)
BWD = dict(rtol=5e-5, atol=5e-6)
SHAPES = [(2, 7, 11, 13), (1, 96, 27, 27), (1, 32, 9, 9), (2, 5, 3, 3),
          (1, 16, 21, 19)]


def _pallas(x, params):
    return pallas_plp.lrn_maxpool(x, *params, True)


def _jax_fwd_bwd(x, params):
    """Pallas forward and the gradient of sum(sin(pooled))."""
    xj = jnp.asarray(x)
    y = np.asarray(_pallas(xj, params))
    g = jax.grad(lambda v: jnp.sum(jnp.sin(_pallas(v, params))))(xj)
    return y, np.asarray(g)


def _port_fwd_bwd(x, params):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = cuda_plp.lrn_maxpool(xt, *params)
    (g,) = torch.autograd.grad(torch.sin(y).sum(), xt)
    return y.detach().numpy(), g.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_lrn_maxpool_matches_the_pallas_kernel(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    y_j, g_j = _jax_fwd_bwd(x, PARAMS)
    y, g = _port_fwd_bwd(x, PARAMS)
    assert y.shape == (shape[0], shape[1]) + cuda_plp.pooled_hw(*shape[2:])
    np.testing.assert_allclose(y, y_j, **FWD)
    np.testing.assert_allclose(g, g_j, **BWD)


def _tie_input(shape, seed):
    """Constant along channels, a period-2 spatial pattern of small
    integers: every window ties between columns 0 and 2 and rows 0 and
    2, and many across the pattern."""
    n, c, h, w = shape
    base = np.random.RandomState(seed).randint(0, 3, (n, 1, 2, 2))
    plane = np.tile(base, (1, 1, (h + 1) // 2, (w + 1) // 2))[:, :, :h, :w]
    return np.repeat(plane, c, axis=1).astype(np.float32)


def _vjps(x, dy, params):
    """The Pallas backward and the port's for one pooled cotangent."""
    _, vjp = jax.vjp(lambda v: _pallas(v, params), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    got = cuda_plp.lrn_pool_bwd(torch.from_numpy(x), torch.from_numpy(dy),
                                *params)
    return got.numpy(), want


@pytest.mark.parametrize("shape", [(2, 3, 11, 13), (1, 6, 9, 9), (2, 2, 3, 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tie_routing_equals_the_pallas_kernel(shape, seed):
    x = _tie_input(shape, seed)
    ph, pw = cuda_plp.pooled_hw(*shape[2:])
    dy = np.random.RandomState(seed + 10).randn(
        shape[0], shape[1], ph, pw).astype(np.float32)
    got, want = _vjps(x, dy, (5, 0.0, 0.75, 1.0))
    assert np.array_equal(got, want)
    # and with the LRN on, within the backward tolerance
    got, want = _vjps(x, dy, PARAMS)
    np.testing.assert_allclose(got, want, **BWD)


def test_routing_rule_is_column_first_then_row():
    """One 3x3 window whose maximum ties at (row 0, col 2) and (row 1,
    col 0): the Pallas rule (first column whose 3-row max is the pooled
    value, then the first row of that column) sends the gradient to
    (row 1, col 0) — Caffe's row-major scan would pick (row 0, col 2)."""
    y = torch.zeros(1, 1, 3, 3)
    y[0, 0, 0, 2] = 1.0
    y[0, 0, 1, 0] = 1.0
    g = cuda_plp.route_reference(y, torch.full((1, 1, 1, 1), 7.0))
    want = torch.zeros(1, 1, 3, 3)
    want[0, 0, 1, 0] = 7.0
    assert torch.equal(g, want)
    gj = jax.grad(lambda v: 7.0 * _pallas(v, (5, 0.0, 0.75, 1.0)).sum())(
        jnp.asarray(y.numpy()))
    assert np.array_equal(np.asarray(gj), want.numpy())


@pytest.mark.parametrize(
    "args,ok",
    [(("ACROSS_CHANNELS", 5, "MAX", (3, 3), (2, 2), (0, 0), 55, 55), True),
     (("across_channels", 3, "max", (3, 3), (2, 2), (0, 0), 3, 27), True),
     (("WITHIN_CHANNEL", 5, "MAX", (3, 3), (2, 2), (0, 0), 55, 55), False),
     (("ACROSS_CHANNELS", 4, "MAX", (3, 3), (2, 2), (0, 0), 55, 55), False),
     (("ACROSS_CHANNELS", 5, "AVE", (3, 3), (2, 2), (0, 0), 55, 55), False),
     (("ACROSS_CHANNELS", 5, "MAX", (2, 2), (2, 2), (0, 0), 55, 55), False),
     (("ACROSS_CHANNELS", 5, "MAX", (3, 3), (1, 1), (0, 0), 55, 55), False),
     (("ACROSS_CHANNELS", 5, "MAX", (3, 3), (2, 2), (1, 1), 55, 55), False),
     (("ACROSS_CHANNELS", 5, "MAX", (3, 3), (2, 2), (0, 0), 12, 13), False),
     (("ACROSS_CHANNELS", 5, "MAX", (3, 3), (2, 2), (0, 0), 1, 1), False)],
)
def test_fusable_gate_is_the_jax_gate(args, ok):
    assert cuda_plp.fusable(*args) is ok
    assert pallas_plp.fusable(*args) is ok
    assert cuda_plp.pooled_hw(*args[-2:]) == pallas_plp.pooled_hw(*args[-2:])


def test_wrappers_refuse_shapes_that_do_not_fuse():
    with pytest.raises(ValueError, match="fusable"):
        cuda_plp.lrn_maxpool(torch.zeros(1, 4, 12, 13), *PARAMS)
    with pytest.raises(ValueError, match="fusable"):
        cuda_plp.lrn_pool_bwd(torch.zeros(1, 4, 11, 13),
                              torch.zeros(1, 4, 5, 6), 4, 1e-4, 0.75, 1.0)
