"""The port's layers and net against the JAX package, forward and grads.

Each case builds the same prototxt in both packages (``JaxNet`` /
``TorchNet``), feeds the same seeded numpy inputs and weights, and
compares every top and the gradients of ``sum(top * cotangent)`` with
respect to the input and every parameter blob.  Float32 on the CPU on
both sides; XLA and PyTorch sum in other orders, hence rtol 1e-5 (with
an absolute floor of 1e-6 x the tensor's scale for entries near 0).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.net import JaxNet
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.ops.vision import _pool_geometry

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1e-30, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _pair(text, shapes):
    """(JaxNet, TorchNet) of a one-input net: ``shapes`` maps each host-fed
    top to its shape."""
    tops = " ".join(f'top: "{t}"' for t in shapes)
    dims = " ".join(
        "shape { " + " ".join(f"dim: {d}" for d in s) + " }"
        for s in shapes.values()
    )
    full = (f'name: "t" layer {{ name: "in" type: "HostData" {tops} '
            f"java_data_param {{ {dims} }} }}\n" + text)
    return (JaxNet(jconfig.parse_net_prototxt(full), phase="TRAIN"),
            TorchNet(tconfig.parse_net_prototxt(full), phase="TRAIN"))


def _run_both(jnet, tnet, inputs, top, seed=0):
    """Forward both nets on ``inputs`` (numpy), return (jax top, torch
    top, jax grads, torch grads) with grads of sum(top * ct) wrt the
    float inputs and the params."""
    params, stats = jnet.init(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    tparams, tstats = interop.net_params_from_jax(params, tnet, stats)
    float_in = [k for k, v in inputs.items() if k != "label"]

    def jf(p, xs):
        batch = dict(inputs, **xs)
        return jnet.apply(p, stats, {k: jnp.asarray(v) for k, v in batch.items()},
                          train=True).blobs[top]

    jx = {k: jnp.asarray(inputs[k]) for k in float_in}
    jy = np.asarray(jf(params, jx))
    ct = np.asarray(np.random.RandomState(seed + 7).randn(*jy.shape), np.float32)
    jg = jax.grad(lambda p, xs: jnp.sum(jf(p, xs) * ct), argnums=(0, 1))(
        params, jx
    )

    tx = {k: torch.from_numpy(inputs[k]).requires_grad_(True) for k in float_in}
    leaves = [(k, i, b.requires_grad_(True))
              for k, bl in tparams.items() for i, b in enumerate(bl)]
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    batch.update(tx)
    ty = tnet.apply(tparams, tstats, batch, train=True).blobs[top]
    (ty * torch.from_numpy(ct)).sum().backward()
    tg_params = {(k, i): b.grad.numpy() for k, i, b in leaves}
    tg_in = {k: v.grad.numpy() for k, v in tx.items()}
    return jy, ty.detach().numpy(), jg, (tg_params, tg_in)


def _check_all(jnet, tnet, inputs, top, seed=0):
    jy, ty, (jgp, jgx), (tgp, tgx) = _run_both(jnet, tnet, inputs, top, seed)
    _close(ty, jy)
    for k in jgx:
        _close(tgx[k], jgx[k])
    for (k, i), g in tgp.items():
        _close(g, jgp[k][i])
    return ty


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "geom",
    ["kernel_size: 3 stride: 1 pad: 1", "kernel_size: 5 stride: 2 pad: 2",
     "kernel_size: 3 stride: 2 pad: 0 group: 3"],
)
def test_convolution(geom):
    num_out = 6
    jnet, tnet = _pair(
        f'layer {{ name: "c" type: "Convolution" bottom: "x" top: "y" '
        f"convolution_param {{ num_output: {num_out} {geom} "
        f'weight_filler {{ type: "gaussian" std: 0.1 }} '
        f'bias_filler {{ type: "constant" value: 0.2 }} }} }}',
        {"x": (2, 3, 12, 12)},
    )
    _check_all(jnet, tnet, {"x": _x(2, 3, 12, 12)}, "y")


@pytest.mark.parametrize(
    "pool,geom,hw",
    [
        ("MAX", "kernel_size: 3 stride: 2", 32),  # 32 -> 16, last window clipped
        ("MAX", "kernel_size: 3 stride: 2", 12),
        ("MAX", "kernel_size: 3 stride: 2 pad: 1", 12),
        ("AVE", "kernel_size: 3 stride: 2", 32),
        ("AVE", "kernel_size: 3 stride: 2", 12),
        ("AVE", "kernel_size: 3 stride: 2 pad: 1", 12),
    ],
)
def test_pooling_ceil_mode(pool, geom, hw):
    jnet, tnet = _pair(
        f'layer {{ name: "p" type: "Pooling" bottom: "x" top: "y" '
        f"pooling_param {{ pool: {pool} {geom} }} }}",
        {"x": (2, 3, hw, hw)},
    )
    y = _check_all(jnet, tnet, {"x": _x(2, 3, hw, hw, seed=hw)}, "y")
    assert y.shape == tnet.blob_shapes["y"] == jnet.blob_shapes["y"]
    if hw == 32 and "pad" not in geom:
        assert y.shape[2:] == (16, 16)


def test_pool_geometry_clips_the_last_window():
    class P:
        global_pooling = False
        kernel_size, kernel_h, kernel_w = 3, 0, 0
        stride, stride_h, stride_w = 2, 0, 0
        pad, pad_h, pad_w = 0, 0, 0

    from sparknet_tpu.ops.vision import _pool_geometry as jgeom

    for hw in (12, 16, 32):
        assert _pool_geometry(P, hw, hw) == jgeom(P, hw, hw)
    assert _pool_geometry(P, 32, 32)[3] == (16, 16)


@pytest.mark.parametrize(
    "region,size,alpha",
    [("WITHIN_CHANNEL", 3, 5e-05), ("WITHIN_CHANNEL", 3, 0.5),
     ("ACROSS_CHANNELS", 5, 1e-04), ("ACROSS_CHANNELS", 3, 0.5)],
)
def test_lrn(region, size, alpha):
    jnet, tnet = _pair(
        f'layer {{ name: "n" type: "LRN" bottom: "x" top: "y" '
        f"lrn_param {{ local_size: {size} alpha: {alpha} beta: 0.75 "
        f"norm_region: {region} }} }}",
        {"x": (2, 6, 12, 12)},
    )
    _check_all(jnet, tnet, {"x": 3.0 * _x(2, 6, 12, 12, seed=size)}, "y")


def test_inner_product_and_relu():
    jnet, tnet = _pair(
        'layer { name: "ip" type: "InnerProduct" bottom: "x" top: "h" '
        'inner_product_param { num_output: 5 weight_filler { type: "xavier" } '
        'bias_filler { type: "constant" value: 0.1 } } } '
        'layer { name: "r" type: "ReLU" bottom: "h" top: "h" }',
        {"x": (2, 3, 4, 4)},
    )
    _check_all(jnet, tnet, {"x": _x(2, 3, 4, 4)}, "h")


@pytest.mark.parametrize(
    "loss_param",
    ["", "loss_param { normalization: FULL }",
     "loss_param { normalization: BATCH_SIZE }",
     "loss_param { normalization: NONE }",
     "loss_param { ignore_label: 2 }",
     "loss_param { normalize: false }"],
)
def test_softmax_with_loss_and_accuracy(loss_param):
    jnet, tnet = _pair(
        f'layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "x" '
        f'bottom: "label" top: "loss" {loss_param} }} '
        'layer { name: "acc" type: "Accuracy" bottom: "x" bottom: "label" '
        'top: "acc" } '
        'layer { name: "acc3" type: "Accuracy" bottom: "x" bottom: "label" '
        'top: "acc3" accuracy_param { top_k: 3 } }',
        {"x": (8, 10), "label": (8,)},
    )
    rs = np.random.RandomState(3)
    inputs = {"x": rs.randn(8, 10).astype(np.float32),
              "label": rs.randint(0, 10, 8).astype(np.float32)}
    inputs["label"][:3] = 2  # some ignored under ignore_label: 2
    _check_all(jnet, tnet, inputs, "loss")
    params, stats = jnet.init(0)
    tparams, tstats = interop.net_params_from_jax(params, tnet, stats)
    jb = jnet.apply(params, stats, {k: jnp.asarray(v) for k, v in inputs.items()},
                    train=False).blobs
    tb = tnet.apply(tparams, tstats, {k: torch.from_numpy(v) for k, v in inputs.items()},
                    train=False).blobs
    for top in ("acc", "acc3"):
        assert float(tb[top]) == float(jb[top])


def test_cifar10_full_forward_backward_batch2():
    """The whole cifar10_full TRAIN net at batch 2 from carried weights:
    every blob forward, every param grad of the loss."""
    jp = jmodels.load_model("cifar10_full")
    tp = tmodels.load_model("cifar10_full")
    for netp in (jp, tp):
        for l in netp.layer[:2]:
            l.java_data_param.shape[0].dim[0] = 2
            l.java_data_param.shape[1].dim[0] = 2
    jnet, tnet = JaxNet(jp, phase="TRAIN"), TorchNet(tp, phase="TRAIN")
    assert jnet.blob_shapes == tnet.blob_shapes
    rs = np.random.RandomState(5)
    x = (rs.randint(0, 255, (2, 3, 32, 32)) - 120).astype(np.float32)
    y = np.array([3, 7], np.float32)
    params, stats = jnet.init(11)
    # the zoo's std 1e-4 conv1 gives a near-constant net; scale the
    # carried weights up so every layer's contribution is visible
    params = {k: [np.asarray(b) * 30.0 for b in v] for k, v in params.items()}
    tparams, tstats = interop.net_params_from_jax(params, tnet)

    def jloss(p):
        out = jnet.apply(p, stats, {"data": jnp.asarray(x), "label": jnp.asarray(y)},
                         train=True)
        return out.loss, out.blobs

    (jl, jblobs), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    leaves = [b.requires_grad_(True) for bl in tparams.values() for b in bl]
    tout = tnet.apply(tparams, tstats, {"data": torch.from_numpy(x),
                                        "label": torch.from_numpy(y)}, train=True)
    tout.loss.backward()
    _close(tout.loss.detach().numpy(), jl)
    for name, blob in jblobs.items():
        _close(tout.blobs[name].detach().numpy(), blob)
    for k, bl in tparams.items():
        for i, b in enumerate(bl):
            _close(b.grad.numpy(), jg[k][i])
    assert len(leaves) == 8


def test_carry_checks_the_layout():
    tnet = TorchNet(tmodels.load_model("cifar10_full"), phase="TRAIN")
    jnet = JaxNet(jmodels.load_model("cifar10_full"), phase="TRAIN")
    params, _ = jnet.init(0)
    params = {k: [np.asarray(b) for b in v] for k, v in params.items()}
    got, _ = interop.net_params_from_jax(params, tnet)
    assert {k: [tuple(b.shape) for b in v] for k, v in got.items()} == \
        tnet.blob_layout()
    bad = dict(params, ip1=[params["ip1"][0].T, params["ip1"][1]])
    with pytest.raises(ValueError, match="shape"):
        interop.net_params_from_jax(bad, tnet)
    with pytest.raises(ValueError, match="layers"):
        interop.net_params_from_jax({"conv1": params["conv1"]}, tnet)
