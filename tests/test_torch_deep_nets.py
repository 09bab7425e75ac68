"""GoogLeNet and ResNet-50 whole nets against ``JaxNet`` from the same
weights and stats: a forward and backward of GoogLeNet (batch 2, image
96: the aux heads' 5x5/3 pool has input) and ResNet-50 (batch 2, image
128), jitted on the JAX side.

In float64 on both sides (``jax.enable_x64``) the port and JAX agree to
rounding: loss, every blob, every gradient and stat within 1e-9 of its
scale.  In float32 they do not agree leaf by leaf, and neither package
agrees with float64: ResNet-50's BatchNorm over 2 x 4 x 4 values a
channel at res5 divides by sqrt(var + 1e-5) of channels whose variance
is ~0, which amplifies float32 rounding to several percent of some
leaves in either package (measured: the port's worst leaf 18% of its
scale from the float64 result, JAX's 32%; in norm 1.3% and 5.9%), and
GoogLeNet routes max-pool ties by float32's rounding.  So in float32
each package is held to its distance from the float64 run.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu import models as jmodels
from sparknet_tpu.net import JaxNet
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.utils.tree import tree_map

from tests.test_torch_deep_models import _no_dropout


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# whole nets against JaxNet


WHOLE = {"googlenet": 96, "resnet50": 128}


def _random_stats(stats):
    """Nonzero BatchNorm stats (what a trained net carries): the update
    formula and the TEST phase's global stats both read them."""
    rs = np.random.RandomState(4)
    return {k: [torch.from_numpy(rs.randn(*m.shape) * 0.1).float(),
                torch.from_numpy(rs.rand(*v.shape) + 0.5).float(),
                torch.tensor([3.0])] for k, (m, v, f) in stats.items()}


@functools.lru_cache(maxsize=None)  # the float64 run referees two tests
def _whole(name, dtype, phase):
    """Both nets of ``name`` from the port's seeded init (the JAX
    package's weights: ``utils/jax_prng.py``) and random stats, in
    ``dtype``, on one seeded batch: ``(port (loss, blobs, grads, stats),
    JAX (loss, blobs, grads, stats), layer/blob order)``."""
    img = WHOLE[name]
    kw = dict(batch=2, image=img, classes=10)
    tnet = TorchNet(_no_dropout(tmodels.load_model(name, **kw)), phase)
    jnet = JaxNet(_no_dropout(jmodels.load_model(name, **kw)), phase)
    params, stats = tnet.init(0)
    stats = _random_stats(stats)
    params, stats = (tree_map(lambda t: t.to(dtype), x) for x in (params, stats))
    rs = np.random.RandomState(1)
    batch = {"data": rs.randn(2, 3, img, img), "label": rs.randint(0, 10, 2)}
    batch = {k: v.astype(np.float64 if dtype == torch.float64 else np.float32)
             for k, v in batch.items()}
    train = phase == "TRAIN"

    req = tree_map(lambda t: t.clone().requires_grad_(True), params)
    out = tnet.apply(req, stats, {k: torch.from_numpy(v) for k, v in batch.items()},
                     train=train)
    leaves = [b for v in req.values() for b in v]
    grads = torch.autograd.grad(out.loss, leaves) if train else []
    port = (float(out.loss), {k: v.detach().numpy() for k, v in out.blobs.items()},
            [g.numpy() for g in grads],
            {k: [s.detach().numpy() for s in v] for k, v in out.stats.items()})

    def f(p, s, b):
        o = jnet.apply(p, s, b, train=train)
        return o.loss, (o.blobs, o.stats)

    jp = {k: [jnp.asarray(t.numpy()) for t in v] for k, v in params.items()}
    js = {k: [jnp.asarray(t.numpy()) for t in v] for k, v in stats.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if train:
        (jl, (jblobs, jstats)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jp, js, jb)
        jg = [np.asarray(jg[k][i]) for k in params for i in range(len(params[k]))]
    else:
        jl, (jblobs, jstats) = jax.jit(f)(jp, js, jb)
        jg = []
    jax_ = (float(jl), {k: np.asarray(v) for k, v in jblobs.items()}, jg,
            {k: [np.asarray(s) for s in v] for k, v in jstats.items()})
    return port, jax_


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()) / max(
        1e-300, float(np.abs(b).max()))


@pytest.mark.parametrize("name,phase", [
    ("googlenet", "TRAIN"), ("resnet50", "TRAIN"), ("resnet50", "TEST")])
def test_whole_net_float64_equals_jax(name, phase):
    """Float64 on both sides: every blob, the loss, every gradient and
    every updated stat within 1e-9 of its scale of JAX's; ResNet-50's TEST
    phase normalizes by the global stats."""
    with jax.enable_x64(True):
        (tl, tb, tg, ts), (jl, jb, jg, js) = _whole(name, torch.float64, phase)
    assert tb["data"].dtype == np.float64
    assert abs(tl - jl) <= 1e-9 * abs(jl)
    assert set(tb) == set(jb)
    for k in jb:
        assert _rel(tb[k], jb[k]) <= 1e-9, k
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= 1e-9
    for k in js:
        for a, b in zip(ts[k], js[k]):
            assert _rel(a, b) <= 1e-9, k


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_whole_net_float32_lies_within_float32_noise_of_jax(name):
    """Float32 on both sides, against the float64 run as referee (see the
    module doc): each package's loss within 2e-4 of the float64 loss and
    its logits within 1e-3 of their scale; the port's gradients' distance
    from float64, in norm over the net, at most twice JAX's or 1e-3.
    GoogLeNet's float32 gradients may route a max-pool tie the other way:
    ceil-mode pooling lets overlapping windows pick the same input, a
    1x1 convolution maps equal inputs to equal outputs, and the next pool
    sees an exact tie that float32 breaks either way (measured on one
    torch thread: 2.1e-4 in norm, 3.5e-3 of conv1's weight gradient; JAX
    3e-7)."""
    (tl, tb, tg, _), (jl, jb, jg, _) = _whole(name, torch.float32, "TRAIN")
    with jax.enable_x64(True):
        (xl, xb, xg, _), _ = _whole(name, torch.float64, "TRAIN")
    logits = "loss3/classifier" if name == "googlenet" else "fc1000"
    for loss, blobs in ((tl, tb), (jl, jb)):
        assert abs(loss - xl) <= 2e-4 * abs(xl)
        assert _rel(blobs[logits], xb[logits]) <= 1e-3

    def norm_far(gs):
        return float(np.sqrt(sum(((np.float64(a) - x) ** 2).sum()
                                 for a, x in zip(gs, xg)))
                     / np.sqrt(sum((x ** 2).sum() for x in xg)))

    assert norm_far(tg) <= max(2 * norm_far(jg), 1e-3)
