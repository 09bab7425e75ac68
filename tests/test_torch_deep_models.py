"""The deep nets of the port against the JAX package: GoogLeNet, ResNet-50
and the rest of the zoo.

- Every builder and zoo model's NetParameter equals the JAX package's,
  and ``available_models()`` lists the same names.
- GoogLeNet's and ResNet-50's blob shapes and parameter counts equal
  ``JaxNet``'s (ResNet-50: 25.0-26.0 M learnable, 53 BatchNorm layers).
- The horizontal-conv plan equals the JAX plan on GoogLeNet and on the
  hazard nets of the JAX package's own tests, and the fused net computes
  what the unfused one does.
- (The whole-net forward and backward against ``JaxNet`` is in
  ``test_torch_deep_nets.py``.)
- ``imagenet_app.main`` at a tiny size for both models, GoogLeNet
  logging ``test output loss3/top-1``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.net import JaxNet
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.utils.tree import tree_map

from tests.test_torch_layer_zoo import _as_dict


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def hfuse_min2(monkeypatch):
    monkeypatch.setenv("SPARKNET_HFUSE", "1")
    monkeypatch.setenv("SPARKNET_HFUSE_MIN", "2")


def _no_dropout(netp):
    """Dropout off (its masks are drawn from each package's own stream)."""
    for lp in netp.layer:
        if lp.type == "Dropout":
            lp.dropout_param.dropout_ratio = 0.0
    return netp


# ---------------------------------------------------------------------------
# the builders and the zoo


@pytest.mark.parametrize("name", jmodels.available_models())
def test_load_model_equals_jax(name):
    assert tmodels.available_models() == jmodels.available_models()
    j, t = jmodels.load_model(name), tmodels.load_model(name)
    assert _as_dict(j, t) == _as_dict(t, j)
    if name in ("googlenet", "resnet50", "caffenet"):
        kw = dict(batch=3, image=99, classes=17)
        j, t = jmodels.load_model(name, **kw), tmodels.load_model(name, **kw)
        assert _as_dict(j, t) == _as_dict(t, j)
    if name not in ("flickr_style", "rcnn_ilsvrc13"):  # no zoo solver
        js, ts = jmodels.load_model_solver(name), tmodels.load_model_solver(name)
        assert _as_dict(js, ts) == _as_dict(ts, js)
    else:
        with pytest.raises(KeyError):
            tmodels.load_model_solver(name)


def test_load_model_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown model"):
        tmodels.load_model("vgg16")
    with pytest.raises(ValueError, match="prototxt-backed"):
        tmodels.load_model("lenet", batch=2)


@pytest.mark.parametrize("name", ["googlenet", "resnet50"])
def test_blob_shapes_and_param_counts_equal_jax(name):
    kw = dict(batch=2, image=224, classes=1000)
    for phase in ("TRAIN", "TEST"):
        tnet = TorchNet(tmodels.load_model(name, **kw), phase)
        jnet = JaxNet(jmodels.load_model(name, **kw), phase)
        assert tnet.blob_shapes == jnet.blob_shapes
        assert tnet.blob_layout("params") == {
            l.name: [tuple(d.shape) for d, r in zip(jnet._blob_defs[l.name],
                                                     jnet._blob_refs[l.name])
                     if r.collection == "params" and r.owner == l.name]
            for l in jnet.layers if any(
                r.collection == "params" and r.owner == l.name
                for r in jnet._blob_refs[l.name])}
        assert tnet.param_multipliers() == jnet.param_multipliers()
    layout = tnet.blob_layout("params")
    n_params = sum(int(np.prod(s)) for v in layout.values() for s in v)
    stats = tnet.blob_layout("stats")
    if name == "resnet50":
        assert 25.0e6 <= n_params <= 26.0e6
        assert len(stats) == 53 and all(len(v) == 3 for v in stats.values())
        assert sum(len(v) for v in layout.values()) == 161
    else:
        assert not stats
        weights = {l.name: l.loss_weights()[0] for l in tnet.layers
                   if l.lp.type == "SoftmaxWithLoss"}
        assert weights == {"loss1/loss": 0.3, "loss2/loss": 0.3,
                           "loss3/loss3": 1.0}
        assert tnet.blob_shapes["loss1/ave_pool"] == (2, 512, 4, 4)


# ---------------------------------------------------------------------------
# the horizontal-conv fusion

# the hazard nets of the JAX package's tests (tests/test_hconv.py)
_HEAD = ('name: "m" layer { name: "data" type: "HostData" top: "x" '
         "java_data_param { shape { dim: 2 dim: 3 dim: 8 dim: 8 } } }\n")


def _conv(name, bottom, top, n=2):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
            f'top: "{top}" convolution_param {{ num_output: {n} kernel_size: 1 '
            'weight_filler { type: "xavier" } bias_filler { type: "uniform" } } }\n')


HAZARD_NETS = {
    # cb's top "b" is read by q inside the would-be span: no fusion
    "member_top_read": _HEAD + (
        'layer { name: "p" type: "Power" bottom: "x" top: "b" '
        "power_param { scale: 2.0 } }\n" + _conv("ca", "x", "a")
        + 'layer { name: "q" type: "Power" bottom: "b" top: "q" '
        "power_param { shift: 1.0 } }\n" + _conv("cb", "x", "b")
        + 'layer { name: "r" type: "Eltwise" bottom: "q" bottom: "q" top: "r" }\n'),
    # a later layer rebinds a member's top with another width: the slice
    # sizes still come from the members
    "later_rebinding": _HEAD + _conv("ca", "x", "a") + _conv("cb", "x", "b")
    + _conv("cc", "x", "c") + _conv("rebind", "b", "a", n=5),
    # an in-place ReLU rewrites the shared bottom inside the span
    "inplace_bottom": _HEAD + _conv("ca", "x", "a")
    + 'layer { name: "rx" type: "ReLU" bottom: "x" top: "x" }\n'
    + _conv("cb", "x", "b"),
}


def _plans(jnet, tnet):
    jplan = [(g["lis"], g["sizes"], tuple(g["geom"]), g["bias"])
             for g in jnet._hconv_groups.values()]
    tplan = [(g["lis"], g["sizes"], tuple(g["geom"]), g["bias"])
             for g in tnet._hconv_groups.values()]
    return jplan, tplan


@pytest.mark.parametrize("name", sorted(HAZARD_NETS))
def test_hconv_plan_equals_jax_on_the_hazard_nets(hfuse_min2, monkeypatch, name):
    text = HAZARD_NETS[name]
    jnet = JaxNet(jconfig.parse_net_prototxt(text), "TRAIN")
    tnet = TorchNet(tconfig.parse_net_prototxt(text), "TRAIN")
    jplan, tplan = _plans(jnet, tnet)
    assert tplan == jplan
    assert bool(tplan) == (name == "later_rebinding")
    params, stats = tnet.init(0)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 8, 8)
                         .astype(np.float32))
    fused = tnet.forward(params, stats, {"x": x})
    jblobs = jnet.forward({k: [jnp.asarray(b.numpy()) for b in v]
                           for k, v in params.items()}, {}, {"x": x.numpy()})
    monkeypatch.setenv("SPARKNET_HFUSE", "0")
    plain_net = TorchNet(tconfig.parse_net_prototxt(text), "TRAIN")
    assert not plain_net._hconv_groups
    plain = plain_net.forward(params, stats, {"x": x})
    assert set(fused) == set(plain) == set(jblobs)
    for k in plain:
        np.testing.assert_allclose(fused[k].numpy(), plain[k].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fused[k].numpy(), np.asarray(jblobs[k]),
                                   rtol=1e-5, atol=1e-6)


def test_hconv_plan_on_googlenet(monkeypatch):
    """Nine groups, one an Inception block (its 1x1, 3x3-reduce and
    5x5-reduce read the block input), as in JAX; SPARKNET_HFUSE_MIN=2 adds
    none (no 2-member group there); the fused net's loss and gradients
    equal the unfused net's (dropout off)."""
    monkeypatch.delenv("SPARKNET_HFUSE_MIN", raising=False)
    monkeypatch.setenv("SPARKNET_HFUSE", "1")
    netp = _no_dropout(tmodels.load_model("googlenet", batch=2, image=96,
                                          classes=7))
    tnet = TorchNet(netp, "TRAIN")
    jnet = JaxNet(_no_dropout(jmodels.load_model("googlenet", batch=2, image=96,
                                                 classes=7)), "TRAIN")
    jplan, tplan = _plans(jnet, tnet)
    assert tplan == jplan and len(tplan) == 9
    assert [g[0] for g in tnet.hconv_groups] == [
        f"inception_{b}/1x1" for b in
        ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b")]
    assert all(len(g) == 3 for g in tnet.hconv_groups)
    assert len(TorchNet(netp, "TEST").hconv_groups) == 9
    monkeypatch.setenv("SPARKNET_HFUSE_MIN", "2")
    assert len(TorchNet(netp, "TRAIN").hconv_groups) == 9
    monkeypatch.setenv("SPARKNET_HFUSE", "0")
    plain = TorchNet(netp, "TRAIN")
    assert not plain.hconv_groups
    params, stats = plain.init(1)
    rs = np.random.RandomState(2)
    batch = {"data": torch.from_numpy(rs.randn(2, 3, 96, 96).astype(np.float32)),
             "label": torch.tensor([1.0, 5.0])}

    def loss_grads(net):
        req = tree_map(lambda t: t.clone().requires_grad_(True), params)
        out = net.apply(req, stats, batch, train=True)
        leaves = [b for v in req.values() for b in v]
        return out, torch.autograd.grad(out.loss, leaves)

    a, ga = loss_grads(tnet)
    b, gb = loss_grads(plain)
    assert set(a.blobs) == set(b.blobs)
    np.testing.assert_allclose(float(a.loss), float(b.loss), rtol=1e-6)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(y.abs().max()))


def test_hconv_composes_with_the_lrn_pool_fusion(monkeypatch):
    """At image 99 GoogLeNet's conv2/norm2 input is 25x25 (odd), so
    SPARKNET_FUSION=1 fuses it with pool2 (``cuda_plp``, its plain version
    here) in the same apply as the nine hconv groups: loss and gradients
    equal the net with neither plan."""
    netp = _no_dropout(tmodels.load_model("googlenet", batch=2, image=99,
                                          classes=5))
    monkeypatch.setenv("SPARKNET_HFUSE", "0")
    monkeypatch.setenv("SPARKNET_FUSION", "0")
    plain = TorchNet(netp, "TRAIN")
    monkeypatch.setenv("SPARKNET_HFUSE", "1")
    monkeypatch.setenv("SPARKNET_FUSION", "1")
    both = TorchNet(netp, "TRAIN")
    assert len(both.hconv_groups) == 9 and not plain.hconv_groups
    assert [t for t, _ in both._plp_fused.values()] == ["pool2/3x3_s2"]
    params, stats = plain.init(2)
    rs = np.random.RandomState(5)
    batch = {"data": torch.from_numpy(rs.randn(2, 3, 99, 99).astype(np.float32)),
             "label": torch.tensor([0.0, 3.0])}
    outs = []
    for net in (both, plain):
        req = tree_map(lambda t: t.clone().requires_grad_(True), params)
        out = net.apply(req, stats, batch, train=True)
        outs.append((out, torch.autograd.grad(
            out.loss, [b for v in req.values() for b in v])))
    (a, ga), (b, gb) = outs
    assert "conv2/norm2" not in a.blobs and "conv2/norm2" in b.blobs
    np.testing.assert_allclose(float(a.loss), float(b.loss), rtol=1e-6)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(y.abs().max()))


# ---------------------------------------------------------------------------
# the app


@pytest.mark.parametrize("model,crop,extra", [
    ("googlenet", 96, []), ("resnet50", 64, ["--compress", "int8"])])
def test_imagenet_app_trains_the_deep_nets_on_the_cpu(model, crop, extra,
                                                      capsys):
    """The app at a tiny size under each model's zoo solver: GoogLeNet's
    (poly, lr 0.01) and ResNet-50's (multistep from lr 0.1), the latter
    with its 320 leaves on the int8 comm plane."""
    result = {}
    rc = imagenet_app.main(
        ["--device", "cpu", "--model", model, "--workers", "2", "--tau", "2",
         "--rounds", "2", "--full_size", str(crop + 8), "--crop", str(crop),
         "--train_batch", "2", "--test_batch", "2", "--test_every", "1"]
        + extra, result)
    assert rc == 0
    assert result["losses"].shape == (2, 2, 2)
    assert np.isfinite(result["losses"]).all()
    logs = capsys.readouterr().out
    if model == "googlenet":
        assert "test output loss3/top-1 = " in logs
        assert "9 hconv groups" in logs
        # the solver's policy: poly from the zoo's googlenet_solver
        assert result["trainer"].solver.param.lr_policy == "poly"
    else:
        assert "test output accuracy = " in logs
        st = result["state"]
        for k, v in st.stats.items():  # every worker holds the averaged stats
            for s in v:
                assert torch.equal(s[0], s[1]), k
        chunks = result["trainer"]._comm.chunk_slices
        assert max(sl.stop - sl.start for sl in chunks) > 32
        param = result["trainer"].solver.param
        assert param.lr_policy == "multistep" and param.base_lr == 0.1
        assert param.stepvalue == [150000, 300000, 400000]
