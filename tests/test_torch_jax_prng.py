"""The port's threefry (``utils/jax_prng.py``) against ``jax.random``.

One seed gives the JAX package's initial weights:

- keys (``PRNGKey``, ``fold_in``, ``split`` chains), ``random_bits``,
  ``uniform`` and ``bernoulli`` bit for bit, over odd sizes, a 4-D
  convolution shape and more than 2**16 elements;
- ``normal`` within ``NORMAL_ULPS``: XLA's CPU ``log1p`` inside its
  erfinv is its own polynomial, so ~1% of the draws differ by 1-3 ulp
  (measured: at most 3 ulp over 2**20 draws, 4 after a filler's
  scale);
- every ported filler against the JAX filler;
- ``TransformerLMNet.init`` (dim 256, depth 4, heads 4, seq 256) and
  ``TorchNet.init`` (cifar10_full and AlexNet at full width) against
  the JAX package's ``init`` from the same seed, with no weights
  carried;
- the port's ``lm_app.main`` against the JAX ``lm_app.main`` at dim 256
  (heads 4, seq 256, W=2, tau 4, batch 8, lr 0.01, seed 0; depth cut
  to 2, one round): per-iteration losses within ``TRAJ_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sparknet_tpu import models as jmodels
from sparknet_tpu.config.schema import FillerParameter as JFiller
from sparknet_tpu.models.transformer_lm import TransformerLM as JaxLM
from sparknet_tpu.net import JaxNet
from sparknet_tpu.ops import fillers as jfillers
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.apps import lm_app
from sparknet_tpu_torch.config.schema import FillerParameter as TFiller
from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.ops import fillers as tfillers
from sparknet_tpu_torch.utils import jax_prng

NORMAL_ULPS = 4
TRAJ_TOL = 5e-4  # the LM trainers' tolerance (tests/test_torch_lm_train.py)
CHECKSUM_RTOL = 1e-6


def _ulps(a, b):
    """Distance in float32 steps (sign-magnitude made monotonic)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _key_chain(chain):
    """The same key in both packages: a seed, then fold_in / split steps."""
    seed, steps = chain
    jk, tk = jax.random.PRNGKey(seed), jax_prng.prng_key(seed)
    for op, arg in steps:
        if op == "fold":
            jk, tk = jax.random.fold_in(jk, arg), jax_prng.fold_in(tk, arg)
        else:  # ("split", (num, index))
            num, i = arg
            jk, tk = jax.random.split(jk, num)[i], jax_prng.split(tk, num)[i]
    return jk, tk


CHAINS = [
    (0, []),
    (7, [("fold", 3)]),
    (2**32 + 5, [("fold", 11), ("split", (2, 1))]),
    (-1, [("fold", 0)]),
    (123, [("split", (5, 4)), ("fold", 2**31 + 9), ("split", (3, 0))]),
]
SHAPES = [(1,), (7,), (3, 5), (96, 3, 11, 11), (65537,), (3, 257, 129)]


@pytest.mark.parametrize("chain", CHAINS)
def test_keys_equal_jax(chain):
    jk, tk = _key_chain(chain)
    np.testing.assert_array_equal(np.asarray(jk), tk)
    np.testing.assert_array_equal(np.asarray(jax.random.split(jk, 6)),
                                  jax_prng.split(tk, 6))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chain", CHAINS[1:3])
def test_bits_and_uniform_equal_jax(chain, shape):
    jk, tk = _key_chain(chain)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
        jax_prng.random_bits(tk, shape))
    for lo, hi in ((0.0, 1.0), (-0.0625, 0.0625), (-1.7, 2.9)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi)),
            jax_prng.uniform(tk, shape, lo, hi))


@pytest.mark.parametrize("p", [0.0, 0.03, 0.5, 1.0])
def test_bernoulli_equals_jax(p):
    jk, tk = _key_chain(CHAINS[4])
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(jk, p, (64, 33))),
        jax_prng.bernoulli(tk, p, (64, 33)))


@pytest.mark.parametrize("shape", [(7,), (96, 3, 11, 11), (1 << 20,)])
@pytest.mark.parametrize("chain", CHAINS[:2])
def test_normal_within_a_few_ulp_of_jax(chain, shape):
    jk, tk = _key_chain(chain)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = jax_prng.normal(tk, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert int(_ulps(got, want).max()) <= NORMAL_ULPS


FILLER_CASES = [
    # (filler fields, exact): uniform-only fillers are bit for bit
    (dict(type="constant", value=0.25), True),
    (dict(type="uniform", min=-0.3, max=0.7), True),
    (dict(type="xavier"), True),
    (dict(type="xavier", variance_norm="AVERAGE"), True),
    (dict(type="bilinear"), True),
    (dict(type="gaussian", std=0.01), False),
    (dict(type="gaussian", mean=0.5, std=0.1, sparse=2), False),
    (dict(type="msra", variance_norm="FAN_OUT"), False),
    (dict(type="positive_unitball"), False),
]


@pytest.mark.parametrize("fields,exact", FILLER_CASES)
def test_fillers_equal_jax(fields, exact):
    shape = (8, 3, 5, 5)
    jk, tk = _key_chain(CHAINS[1])
    want = np.asarray(jfillers.fill(jk, shape, JFiller(**fields)))
    got = tfillers.fill(tk, shape, TFiller(**fields))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    elif fields["type"] == "positive_unitball":  # row sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got == 0, want == 0)  # the sparse mask
        assert int(_ulps(got, want).max()) <= NORMAL_ULPS


def _assert_params_equal_jax(jparams, tparams):
    assert sorted(jparams) == sorted(tparams)
    for name in jparams:
        assert len(jparams[name]) == len(tparams[name])
        for want, got in zip(jparams[name], tparams[name]):
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape, name
            assert int(_ulps(got.numpy(), want).max()) <= NORMAL_ULPS, name


def lm_checksum(params):
    """(sum, sum of |w|) in float64 over every blob, as chip_smoke prints it."""
    return chip_smoke.lm_init_checksum(params)


def test_lm_init_equals_jax_and_the_pinned_checksum():
    geom = dict(dim=256, depth=4, heads=4, seq_len=256)
    jparams, _ = JaxLM(**geom).init(0)
    tparams, stats = TransformerLMNet(**geom).init(0, torch.device("cpu"))
    assert stats == {}
    _assert_params_equal_jax(jparams, tparams)
    # the checksum chip_smoke.py prints for its LM phase, pinned
    assert geom == chip_smoke.LM_MODEL
    want = chip_smoke.LM_INIT_CHECKSUM
    for params in (tparams, {g: [torch.tensor(np.asarray(b)) for b in bs]
                             for g, bs in jparams.items()}):
        np.testing.assert_allclose(lm_checksum(params), want,
                                   rtol=CHECKSUM_RTOL)


@pytest.mark.parametrize("model", ["cifar10_full", "alexnet"])
def test_net_init_equals_jax(model):
    """Full width: AlexNet's 60,965,224 parameters from one seed."""
    jparams, jstats = JaxNet(jmodels.load_model(model), phase="TRAIN").init(0)
    tparams, tstats = TorchNet(tmodels.load_model(model),
                               phase="TRAIN").init(0, device="cpu")
    _assert_params_equal_jax(jparams, tparams)
    _assert_params_equal_jax(jstats, tstats)


def _jax_lm_losses(monkeypatch, argv):
    """Per-round (W, tau) losses of the JAX ``lm_app.main``: its trainer's
    ``round`` is wrapped to keep what the app discards."""
    from sparknet_tpu.apps import lm_app as jlm_app
    from sparknet_tpu.parallel import hierarchy

    losses = []
    build = hierarchy.averaging_trainer_from_args

    def recording(*a, **k):
        trainer = build(*a, **k)
        inner = trainer.round

        def round_(*ra, **rk):
            state, lo = inner(*ra, **rk)
            losses.append(np.asarray(lo))
            return state, lo

        trainer.round = round_
        return trainer

    monkeypatch.setattr(hierarchy, "averaging_trainer_from_args", recording)
    assert jlm_app.main(argv) == 0
    return np.stack(losses)


def test_lm_app_at_dim_256_reproduces_the_jax_app(monkeypatch):
    """No weights carried: the same seed draws the same model."""
    argv = ["--dim", "256", "--depth", "2", "--heads", "4", "--seq_len", "256",
            "--workers", "2", "--tau", "4", "--batch", "8", "--base_lr", "0.01",
            "--seed", "0", "--rounds", "1"]
    want = _jax_lm_losses(monkeypatch, argv)
    result = {}
    assert lm_app.main(argv + ["--device", "cpu"], result) == 0
    got = result["losses"]
    assert got.shape == want.shape == (1, 2, 4)
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL)
