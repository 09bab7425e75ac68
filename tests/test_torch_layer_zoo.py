"""The port's layer zoo against the JAX package's layers, forward and grads.

Every layer type the port registers beyond the first slices' eleven is
run here through the JAX layer and the port's from the same seeded
numpy inputs and the same carried blobs: each top, the updated stat
blobs, and the gradients of ``sum(top * cotangent)`` with respect to
every float input and every parameter blob.  Float32 on the CPU on both
sides, summed in other orders: rtol 1e-5 with an absolute floor of
1e-6 x the tensor's largest magnitude (``test_torch_layers.py``'s
tolerance).  Also: STOCHASTIC pooling in TRAIN held to its support and
mean, DummyData's threefry fillers against JAX's, the Python layer's
dispatch, and every zoo prototxt parsed to equal NetParameters by both
packages.
"""

import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu.net import JaxNet
from sparknet_tpu.ops.base import Layer as JaxLayer
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.ops.base import Layer as TorchLayer
from sparknet_tpu_torch.utils import rngs

RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only add overhead under the
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1e-30, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _text(layers, inputs):
    """A net of one HostData layer feeding ``inputs`` (numpy arrays) and
    the prototxt ``layers``."""
    tops = " ".join(f'top: "{t}"' for t in inputs)
    dims = " ".join("shape { " + " ".join(f"dim: {d}" for d in v.shape) + " }"
                    for v in inputs.values())
    return (f'name: "t" layer {{ name: "in" type: "HostData" {tops} '
            f"java_data_param {{ {dims} }} }}\n" + layers)


def _run(layers, inputs, top, const=(), train=True, stats_fn=None, seed=0,
         jlayers=None):
    """Run the net of ``layers`` in both packages from the same blobs;
    compare ``top``, the stats, and the grads wrt the params and every
    input not in ``const``.  ``stats_fn(stats)`` may replace the initial
    stat blobs (numpy); ``jlayers`` is the JAX side's text where it
    differs (a Python layer names its package's class)."""
    jnet = JaxNet(jconfig.parse_net_prototxt(_text(jlayers or layers, inputs)),
                  phase="TRAIN")
    tnet = TorchNet(tconfig.parse_net_prototxt(_text(layers, inputs)),
                    phase="TRAIN")
    assert jnet.blob_shapes == tnet.blob_shapes
    params, stats = jnet.init(seed)
    params = {k: [np.asarray(b) for b in v] for k, v in params.items()}
    stats = {k: [np.asarray(b) for b in v] for k, v in stats.items()}
    if stats_fn is not None:
        stats = stats_fn(stats)
    tparams, tstats = interop.net_params_from_jax(params, tnet, stats)
    var = [k for k in inputs if k not in const]

    def jf(p, xs):
        batch = {k: jnp.asarray(v) for k, v in inputs.items()}
        batch.update(xs)
        out = jnet.apply(p, stats, batch, train=train)
        return out.blobs[top], out.stats

    jx = {k: jnp.asarray(inputs[k]) for k in var}
    jy, jstats = jf(params, jx)
    jy = np.asarray(jy)
    tx = {k: torch.from_numpy(inputs[k].copy()).requires_grad_(True) for k in var}
    batch = {k: torch.from_numpy(v.copy()) for k, v in inputs.items()}
    batch.update(tx)
    leaves = [b.requires_grad_(True) for bl in tparams.values() for b in bl]
    out = tnet.apply(tparams, tstats, batch, train=train)
    ty = out.blobs[top]
    _close(ty.detach().numpy(), jy)
    for k, blobs in jstats.items():
        for i, b in enumerate(blobs):
            _close(out.stats[k][i].detach().numpy(), b)
    if not ty.requires_grad:  # an index-valued top: nothing to differentiate
        return ty.detach()
    ct = np.asarray(np.random.RandomState(seed + 7).randn(*jy.shape), np.float32)
    jgp, jgx = jax.grad(lambda p, xs: jnp.sum(jf(p, xs)[0] * ct),
                        argnums=(0, 1))(params, jx)
    (ty * torch.from_numpy(ct)).sum().backward()
    for k, v in tx.items():  # an input the top does not read: no grad
        _close(np.zeros(v.shape) if v.grad is None else v.grad.numpy(), jgx[k])
    for (k, bl) in tparams.items():
        for i, b in enumerate(bl):
            _close(b.grad.numpy(), jgp[k][i])
    assert len(leaves) == sum(len(v) for v in params.values())
    return ty.detach()


def _x(*shape, seed=0, lo=None):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x if lo is None else (np.abs(x) + lo).astype(np.float32)


_LAYER_TYPE = re.compile(r'name: "\w+" type: "(\w+)"')


def _ids(cases):
    """Test ids: each case's layer type(s) and its index."""
    return [f"{'+'.join(_LAYER_TYPE.findall(c[0]))}-{i}"
            for i, c in enumerate(cases)]


def _layer(type_, bottoms=("x",), tops=("y",), extra=""):
    b = " ".join(f'bottom: "{n}"' for n in bottoms)
    t = " ".join(f'top: "{n}"' for n in tops)
    return f'layer {{ name: "l" type: "{type_}" {b} {t} {extra} }}'


# ---------------------------------------------------------------------------
# elementwise (neuron) layers


@pytest.mark.parametrize("type_,extra,lo", [
    ("Sigmoid", "", None),
    ("TanH", "", None),
    ("AbsVal", "", None),
    ("BNLL", "", None),
    ("Power", "power_param { power: 2.0 scale: 0.5 shift: 1.0 }", None),
    ("Power", "power_param { power: 0.5 scale: 2.0 shift: 0.25 }", 0.1),
    ("Power", "power_param { scale: -3.0 shift: 0.5 }", None),
    ("Exp", "", None),
    ("Exp", "exp_param { base: 2.0 scale: 0.5 shift: -1.0 }", None),
    ("Log", "", 0.1),
    ("Log", "log_param { base: 10.0 scale: 2.0 shift: 0.5 }", 0.1),
    ("Threshold", "threshold_param { threshold: 0.3 }", None),
    ("PReLU", "", None),
    ("PReLU", "prelu_param { channel_shared: true "
              'filler { type: "uniform" min: 0.1 max: 0.9 } }', None),
    ("ELU", "", None),
    ("ELU", "elu_param { alpha: 0.4 }", None),
])
def test_elementwise(type_, extra, lo):
    _run(_layer(type_, extra=extra), {"x": _x(2, 4, 5, 5, seed=3, lo=lo)}, "y")


# ---------------------------------------------------------------------------
# normalization: BatchNorm (train with stat updates, test with global
# stats), Scale and Bias in both bottom forms, MVN


def _bn_stats(stats):
    rs = np.random.RandomState(9)
    out = {}
    for k, (m, v, f) in stats.items():
        out[k] = [rs.randn(*m.shape).astype(np.float32) * 2,
                  (rs.rand(*v.shape) * 3 + 0.5).astype(np.float32),
                  np.array([2.5], np.float32)]
    return out


def _zero_factor(stats):
    out = _bn_stats(stats)
    for k in out:
        out[k][2] = np.zeros(1, np.float32)  # factor 0 -> 1/factor = 1
    return out


@pytest.mark.parametrize("extra,train,stats_fn,shape", [
    ("", True, None, (4, 3, 5, 5)),
    ("batch_norm_param { moving_average_fraction: 0.9 eps: 0.001 }", True,
     _bn_stats, (4, 3, 5, 5)),
    ("", True, _bn_stats, (6, 5)),
    ("", False, _bn_stats, (4, 3, 5, 5)),
    ("", False, _zero_factor, (4, 3, 5, 5)),
    ("batch_norm_param { use_global_stats: true }", True, _bn_stats,
     (4, 3, 5, 5)),
    ("batch_norm_param { use_global_stats: false }", False, _bn_stats,
     (4, 3, 5, 5)),
])
def test_batch_norm(extra, train, stats_fn, shape):
    x = _x(*shape, seed=4) * 2 + 1
    _run(_layer("BatchNorm", extra=extra), {"x": x}, "y", train=train,
         stats_fn=stats_fn)


@pytest.mark.parametrize("type_,bottoms,extra,shapes", [
    ("Scale", ("x",), "", {"x": (2, 3, 4, 4)}),
    ("Scale", ("x",), 'scale_param { bias_term: true filler { type: "uniform" } '
     'bias_filler { type: "gaussian" std: 0.5 } }', {"x": (2, 3, 4, 4)}),
    ("Scale", ("x",), 'scale_param { axis: 2 num_axes: 2 filler { type: "uniform" } }',
     {"x": (2, 3, 4, 5)}),
    ("Scale", ("x",), 'scale_param { axis: 1 num_axes: -1 filler { type: "uniform" } }',
     {"x": (2, 3, 4)}),
    ("Scale", ("x", "s"), "", {"x": (2, 3, 4, 4), "s": (3, 4)}),
    ("Scale", ("x", "s"), 'scale_param { bias_term: true '
     'bias_filler { type: "uniform" } }', {"x": (2, 3, 4, 4), "s": (3,)}),
    ("Scale", ("x", "s"), "scale_param { axis: 0 }",
     {"x": (2, 3, 4, 4), "s": (2, 3)}),
    ("Bias", ("x",), 'bias_param { filler { type: "gaussian" } }',
     {"x": (2, 3, 4, 4)}),
    ("Bias", ("x",), 'bias_param { axis: 2 num_axes: 2 filler { type: "uniform" } }',
     {"x": (2, 3, 4, 5)}),
    ("Bias", ("x", "b"), "", {"x": (2, 3, 4, 4), "b": (3, 4)}),
])
def test_scale_and_bias(type_, bottoms, extra, shapes):
    inputs = {k: _x(*s, seed=i + 1) for i, (k, s) in enumerate(shapes.items())}
    _run(_layer(type_, bottoms, extra=extra), inputs, "y")


@pytest.mark.parametrize("extra", [
    "", "mvn_param { normalize_variance: false }",
    "mvn_param { across_channels: true eps: 0.001 }",
])
def test_mvn(extra):
    _run(_layer("MVN", extra=extra), {"x": _x(2, 3, 4, 4, seed=2) * 3 + 1}, "y")


# ---------------------------------------------------------------------------
# Softmax, Concat, Slice, Split, Flatten, Reshape, Eltwise


COMBINATION = [
    (_layer("Softmax"), {"x": (2, 5, 3)}, "y"),
    (_layer("Softmax", extra="softmax_param { axis: 2 }"), {"x": (2, 5, 3)}, "y"),
    (_layer("Concat", ("x", "z")), {"x": (2, 3, 4), "z": (2, 5, 4)}, "y"),
    (_layer("Concat", ("x", "z", "x"), extra="concat_param { axis: 2 }"),
     {"x": (2, 3, 4), "z": (2, 3, 2)}, "y"),
    (_layer("Concat", ("x", "z"), extra="concat_param { concat_dim: 0 }"),
     {"x": (2, 3), "z": (1, 3)}, "y"),
    (_layer("Slice", tops=("y", "w"), extra="slice_param { slice_point: 2 }"),
     {"x": (2, 5, 3)}, "w"),
    (_layer("Slice", tops=("y", "w", "v"), extra="slice_param { axis: 2 }"),
     {"x": (2, 5, 6)}, "v"),
    (_layer("Slice", tops=("y", "w"), extra="slice_param { slice_dim: 0 }"),
     {"x": (4, 3)}, "y"),
    (_layer("Split", tops=("y", "w")) + ' layer { name: "e" type: "Eltwise" '
     'bottom: "y" bottom: "w" top: "s" eltwise_param { operation: PROD } }',
     {"x": (2, 3)}, "s"),
    (_layer("Flatten"), {"x": (2, 3, 4, 5)}, "y"),
    (_layer("Flatten", extra="flatten_param { axis: 2 end_axis: 3 }"),
     {"x": (2, 3, 4, 5)}, "y"),
    (_layer("Reshape", extra="reshape_param { shape { dim: 0 dim: -1 dim: 2 } }"),
     {"x": (2, 3, 4, 5)}, "y"),
    (_layer("Reshape", extra="reshape_param { shape { dim: 6 } axis: 1 "
                             "num_axes: 2 }"), {"x": (2, 3, 2, 5)}, "y"),
    (_layer("Eltwise", ("x", "z")), {"x": (2, 3), "z": (2, 3)}, "y"),
    (_layer("Eltwise", ("x", "z", "x"),
            extra="eltwise_param { operation: SUM coeff: 0.5 coeff: -2 coeff: 3 }"),
     {"x": (2, 3), "z": (2, 3)}, "y"),
    (_layer("Eltwise", ("x", "z"), extra="eltwise_param { operation: PROD }"),
     {"x": (2, 3), "z": (2, 3)}, "y"),
    (_layer("Eltwise", ("x", "z", "w"), extra="eltwise_param { operation: MAX }"),
     {"x": (2, 3, 4), "z": (2, 3, 4), "w": (2, 3, 4)}, "y"),
]


@pytest.mark.parametrize("layers,shapes,top", COMBINATION, ids=_ids(COMBINATION))
def test_shape_and_combination(layers, shapes, top):
    inputs = {k: _x(*s, seed=i + 5) for i, (k, s) in enumerate(shapes.items())}
    _run(layers, inputs, top)


# ---------------------------------------------------------------------------
# Tile, Reduction, ArgMax, Embed, BatchReindex, Filter, Silence


MISC = [
    (_layer("Tile", extra="tile_param { tiles: 3 }"), {"x": _x(2, 3, 2)}, "y", ()),
    (_layer("Tile", extra="tile_param { axis: -1 tiles: 2 }"), {"x": _x(2, 3)},
     "y", ()),
    (_layer("Reduction"), {"x": _x(2, 3, 4)}, "y", ()),
    (_layer("Reduction", extra="reduction_param { operation: ASUM axis: 1 coeff: 2 }"),
     {"x": _x(2, 3, 4)}, "y", ()),
    (_layer("Reduction", extra="reduction_param { operation: SUMSQ axis: 2 }"),
     {"x": _x(2, 3, 4)}, "y", ()),
    (_layer("Reduction", extra="reduction_param { operation: MEAN axis: -1 "
                               "coeff: -0.5 }"), {"x": _x(2, 3, 4)}, "y", ()),
    (_layer("ArgMax"), {"x": _x(3, 7, seed=2)}, "y", ()),
    (_layer("ArgMax", extra="argmax_param { top_k: 3 out_max_val: true }"),
     {"x": _x(3, 2, 4, seed=2)}, "y", ()),
    (_layer("ArgMax", extra="argmax_param { axis: 1 top_k: 2 }"),
     {"x": _x(3, 5, 2, seed=2)}, "y", ()),
    (_layer("ArgMax", extra="argmax_param { axis: 2 out_max_val: true }"),
     {"x": _x(3, 2, 5, seed=2)}, "y", ()),
    (_layer("Embed", extra='embed_param { num_output: 4 input_dim: 6 '
                           'weight_filler { type: "gaussian" } '
                           'bias_filler { type: "uniform" } }'),
     {"x": np.array([[0, 5, 2], [3, 3, 1]], np.float32)}, "y", ("x",)),
    (_layer("Embed", extra='embed_param { num_output: 3 input_dim: 4 '
                           'bias_term: false weight_filler { type: "xavier" } }'),
     {"x": np.array([2, 0, 3], np.float32)}, "y", ("x",)),
    (_layer("BatchReindex", ("x", "i")),
     {"x": _x(4, 3, 2), "i": np.array([3, 0, 0, 2, 1], np.float32)}, "y", ("i",)),
    (_layer("Filter", ("x", "z", "s"), tops=("y", "w")),
     {"x": _x(4, 3), "z": _x(4, 2, 2, seed=1),
      "s": np.array([1, 0, 1, 1], np.float32)}, "w", ("s",)),
]


@pytest.mark.parametrize("layers,inputs,top,const", MISC, ids=_ids(MISC))
def test_misc_layers(layers, inputs, top, const):
    _run(layers, inputs, top, const=const)


def test_silence_consumes_and_produces_nothing():
    text = _text(_layer("Silence", ("x", "z"), tops=()),
                 {"x": _x(2, 3), "z": _x(2)})
    tnet = TorchNet(tconfig.parse_net_prototxt(text), phase="TRAIN")
    jnet = JaxNet(jconfig.parse_net_prototxt(text), phase="TRAIN")
    assert tnet.blob_shapes == jnet.blob_shapes == {"x": (2, 3), "z": (2,)}
    out = tnet.apply({}, {}, {"x": torch.ones(2, 3), "z": torch.ones(2)})
    assert set(out.blobs) == {"x", "z"} and float(out.loss) == 0.0


# ---------------------------------------------------------------------------
# the Python layer: a user class of each package's Layer


class JaxTimes(JaxLayer):
    """y = x * k, k from param_str (the JAX side)."""

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        return [bottoms[0] * float(self.lp.python_param.param_str)], None


class TorchTimes(TorchLayer):
    """y = x * k, k from param_str (the port's side)."""

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        return [bottoms[0] * float(self.lp.python_param.param_str)], None


def _python_layer(cls):
    return _layer("Python", extra=f'python_param {{ module: "{__name__}" '
                                  f'layer: "{cls}" param_str: "2.5" }}')


def test_python_layer():
    y = _run(_python_layer("TorchTimes"), {"x": _x(2, 3)}, "y",
             jlayers=_python_layer("JaxTimes"))
    np.testing.assert_array_equal(y.numpy(), _x(2, 3) * np.float32(2.5))
    with pytest.raises(TypeError, match="Layer subclass"):
        TorchNet(tconfig.parse_net_prototxt(_text(_python_layer("JaxTimes"),
                                                  {"x": _x(2, 3)})))


# ---------------------------------------------------------------------------
# losses


def _labels(n, k, seed=0):
    return np.random.RandomState(seed).randint(0, k, n).astype(np.float32)


def _probs(n, k, seed=0):
    p = np.random.RandomState(seed).rand(n, k).astype(np.float32) + 0.05
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


LOSSES = [
    (_layer("SigmoidCrossEntropyLoss", ("x", "t")),
     {"x": _x(4, 5) * 3, "t": np.random.RandomState(1).rand(4, 5).astype(np.float32)},
     ()),
    (_layer("EuclideanLoss", ("x", "t")), {"x": _x(4, 5), "t": _x(4, 5, seed=1)},
     ()),
    (_layer("HingeLoss", ("x", "label")), {"x": _x(6, 5), "label": _labels(6, 5)},
     ("label",)),
    (_layer("HingeLoss", ("x", "label"), extra="hinge_loss_param { norm: L2 }"),
     {"x": _x(6, 5), "label": _labels(6, 5)}, ("label",)),
    (_layer("MultinomialLogisticLoss", ("x", "label")),
     {"x": _probs(6, 5), "label": _labels(6, 5)}, ("label",)),
    (_layer("InfogainLoss", ("x", "label", "h")),
     {"x": _probs(6, 5), "label": _labels(6, 5),
      "h": np.random.RandomState(3).rand(5, 5).astype(np.float32)}, ("label",)),
    (_layer("ContrastiveLoss", ("a", "b", "sim")),
     {"a": _x(8, 3) * 0.5, "b": _x(8, 3, seed=1) * 0.5,
      "sim": (np.arange(8) % 2).astype(np.float32)}, ("sim",)),
    (_layer("ContrastiveLoss", ("a", "b", "sim"),
            extra="contrastive_loss_param { margin: 2.0 legacy_version: true }"),
     {"a": _x(8, 3) * 0.5, "b": _x(8, 3, seed=1) * 0.5,
      "sim": (np.arange(8) % 2).astype(np.float32)}, ("sim",)),
]


@pytest.mark.parametrize("layers,inputs,const", LOSSES, ids=_ids(LOSSES))
def test_losses(layers, inputs, const):
    _run(layers, inputs, "y", const=const)


# ---------------------------------------------------------------------------
# vision: Deconvolution, Im2col, SPP, STOCHASTIC pooling


VISION = [
    (_layer("Deconvolution", extra='convolution_param { num_output: 4 '
            'kernel_size: 3 stride: 2 pad: 1 weight_filler { type: "gaussian" } '
            'bias_filler { type: "uniform" } }'), (2, 3, 5, 5)),
    (_layer("Deconvolution", extra='convolution_param { num_output: 4 '
            'kernel_size: 4 stride: 2 group: 2 bias_term: false '
            'weight_filler { type: "bilinear" } }'), (2, 4, 4, 4)),
    (_layer("Deconvolution", extra='convolution_param { num_output: 2 '
            'kernel_h: 3 kernel_w: 2 dilation: 2 '
            'weight_filler { type: "xavier" } }'), (1, 3, 4, 5)),
    (_layer("Im2col", extra="convolution_param { kernel_size: 3 }"), (2, 3, 5, 6)),
    (_layer("Im2col", extra="convolution_param { kernel_size: 3 stride: 2 pad: 1 "
                            "dilation: 2 }"), (2, 2, 7, 7)),
    (_layer("SPP", extra="spp_param { pyramid_height: 3 }"), (2, 3, 7, 9)),
    (_layer("SPP", extra="spp_param { pyramid_height: 2 pool: AVE }"),
     (2, 3, 6, 6)),
    (_layer("Pooling", extra="pooling_param { pool: STOCHASTIC kernel_size: 3 "
                             "stride: 2 }"), (2, 3, 9, 9)),
    (_layer("Pooling", extra="pooling_param { pool: STOCHASTIC kernel_size: 2 "
                             "stride: 2 pad: 1 }"), (2, 3, 7, 7)),
]


@pytest.mark.parametrize("layers,shape", VISION, ids=_ids(VISION))
def test_vision(layers, shape):
    train = "STOCHASTIC" not in layers  # STOCHASTIC's TEST form
    _run(layers, {"x": _x(*shape, seed=6)}, "y", train=train)


def test_stochastic_pooling_train_draws_from_the_window():
    """TRAIN draws one entry of each window with probability proportional
    to its ReLU'd value: every output is an entry of its window, and the
    mean over many independent draws is the TEST output (the expected
    value), within 5 standard errors."""
    from sparknet_tpu_torch.ops.vision import _windows, stochastic_pool

    geom = ((3, 3), (2, 2), (0, 0), (3, 3))
    x = torch.from_numpy(_x(1, 2, 7, 7, seed=3))
    n = 4000
    xs = x.expand(n, -1, -1, -1).contiguous()
    y = stochastic_pool(xs, *geom, rngs.train_key(3), True)
    win = torch.relu(_windows(x, *geom))  # (1, c, 9, oh, ow)
    assert bool((y[:, :, None] == win).any(dim=2).all())
    want = stochastic_pool(x, *geom, None, False)[0]
    prob = win / win.sum(dim=2, keepdim=True).clamp_min(1e-12)
    var = (prob * win * win).sum(dim=2)[0] - want * want
    sem = torch.sqrt(var.clamp_min(0) / n)
    assert bool(((y.mean(dim=0) - want).abs() <= 5 * sem + 1e-6).all())
    # one key, one draw; another key, another draw
    assert torch.equal(y, stochastic_pool(xs, *geom, rngs.train_key(3), True))
    assert not torch.equal(y, stochastic_pool(xs, *geom, rngs.train_key(4), True))
    with pytest.raises(ValueError, match="rng"):
        stochastic_pool(x, *geom, None, True)


# ---------------------------------------------------------------------------
# data layers


def test_input_and_memory_data_shapes():
    text = ('name: "d" layer { name: "a" type: "Input" top: "x" '
            'input_param { shape { dim: 2 dim: 3 dim: 4 dim: 4 } } } '
            'layer { name: "m" type: "MemoryData" top: "img" top: "lab" '
            'memory_data_param { batch_size: 5 channels: 1 height: 6 width: 7 } }')
    tnet = TorchNet(tconfig.parse_net_prototxt(text), phase="TEST")
    jnet = JaxNet(jconfig.parse_net_prototxt(text), phase="TEST")
    assert tnet.blob_shapes == jnet.blob_shapes == {
        "x": (2, 3, 4, 4), "img": (5, 1, 6, 7), "lab": (5,)}
    assert tnet.feed_blobs == jnet.feed_blobs == ["x", "img", "lab"]


@pytest.mark.parametrize("fillers,shape", [
    ('data_filler { type: "constant" value: 1.5 }', "num: 2 channels: 3 height: 4 width: 5"),
    ('data_filler { type: "uniform" min: -2 max: 3 }', "shape { dim: 3 dim: 7 }"),
    ('data_filler { type: "xavier" } data_filler { type: "uniform" }',
     "shape { dim: 4 dim: 6 } shape { dim: 5 }"),
    ('data_filler { type: "gaussian" std: 2 mean: 1 }', "shape { dim: 64 dim: 9 }"),
])
def test_dummy_data_draws_the_jax_fillers(fillers, shape):
    """DummyData's tops from ``fold_in(PRNGKey(0), i)`` — the key the JAX
    layer draws from when the net is given none — equal JAX's: bit for
    bit from the uniform draws, within a few float32 ulp (2e-6) from the
    Gaussian ones (``utils/jax_prng.py``'s log1p)."""
    n_tops = shape.count("shape {") or 1
    tops = " ".join(f'top: "d{i}"' for i in range(n_tops))
    text = (f'name: "d" layer {{ name: "dd" type: "DummyData" {tops} '
            f"dummy_data_param {{ {fillers} {shape} }} }}")
    tout = TorchNet(tconfig.parse_net_prototxt(text), "TRAIN").apply(
        {}, {}, {})
    jout = JaxNet(jconfig.parse_net_prototxt(text), "TRAIN").apply({}, {}, {})
    for i in range(n_tops):
        got, want = tout.blobs[f"d{i}"].numpy(), np.asarray(jout.blobs[f"d{i}"])
        assert got.shape == want.shape
        if "gaussian" in fillers:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(got, want)
    # a training key draws another fill, the same for the same key
    key = rngs.train_key(1)
    net = TorchNet(tconfig.parse_net_prototxt(text), "TRAIN")
    a = net.apply({}, {}, {}, rng=key).blobs["d0"]
    assert torch.equal(a, net.apply({}, {}, {}, rng=key).blobs["d0"])
    if "constant" not in fillers:
        assert not torch.equal(a, tout.blobs["d0"])


# ---------------------------------------------------------------------------
# every zoo prototxt parses to equal NetParameters in both packages


def _as_dict(msg, keep):
    """``msg`` as nested dicts, keeping the fields of ``keep`` (the other
    package's message of the same path); a dropped field must hold its
    empty default."""
    if dataclasses.is_dataclass(msg):
        ref = keep if dataclasses.is_dataclass(keep) else None
        out = {}
        for f in dataclasses.fields(msg):
            v = getattr(msg, f.name)
            if ref is not None and not hasattr(ref, f.name):
                assert v in ([], None), (f.name, v)
                continue
            out[f.name] = _as_dict(v, getattr(ref, f.name, None))
        return out
    if isinstance(msg, list):
        ks = keep if isinstance(keep, list) else [None] * len(msg)
        return [_as_dict(v, k) for v, k in zip(msg, ks)]
    return msg


ZOO = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "sparknet_tpu", "models", "zoo", "*.prototxt")))


@pytest.mark.parametrize("name", ZOO)
def test_zoo_prototxt_parses_equal(name):
    """Both packages' copies of each zoo file (the same bytes) parse to
    the same message, field for field."""
    jpath = os.path.join(REPO, "sparknet_tpu", "models", "zoo", name)
    tpath = os.path.join(REPO, "sparknet_tpu_torch", "models", "zoo", name)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    if "solver" in name:
        j, t = jconfig.load_solver_prototxt(jpath), tconfig.load_solver_prototxt(tpath)
        j.net = t.net = None  # resolved against each package's own directory
    else:
        j, t = jconfig.load_net_prototxt(jpath), tconfig.load_net_prototxt(tpath)
    assert _as_dict(j, t) == _as_dict(t, j)
