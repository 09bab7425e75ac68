"""The port's ImageNet training path against the JAX package's, on the CPU.

- The data stage: the synthetic JPEG shard writer, ``ScaleAndConvert``'s
  minibatches, ``compute_mean``/``reduce_mean_sums`` and the
  ``mean.binaryproto`` bytes, bit for bit.
- The transforms: ``test_transform`` bit for bit, and the offset crop
  (``crop_batch``) bit for bit against JAX ``_crop_one`` at given offsets
  and flips.  The random draws cannot match JAX's; one key gives one
  draw.
- ``replace_data_layers`` and the Dropout layer.
- An AlexNet-shaped narrow net (AlexNet's layer sequence, 8/16/24/24/16
  convolutions and fc 32, crop 67: conv1 15x15 -> pool 7x7 -> conv2 7x7,
  so both LRN -> pool sandwiches are odd and fusable): the fused net
  against the unfused one on the port alone and against the JAX net
  (loss rtol 1e-6, grads rtol 1e-4 / atol 1e-6, the JAX test's), and one
  W=2 trainer round against the JAX trainer, the port with and without
  ``SPARKNET_FUSION`` (dropout 0, no mirror and full size = crop, so
  nothing random is drawn; losses and params rtol 1e-5 / atol 1e-6, float32
  summed in other orders).
- ``imagenet_app.main --device cpu`` at full AlexNet width on synthesized
  shards (full 72, crop 67: fc6 sees a 256x1x1 input).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu import config as jconfig
from sparknet_tpu.data import imagenet as jimagenet
from sparknet_tpu.data import transforms as jtransforms
from sparknet_tpu.io import caffemodel as jcaffemodel
from sparknet_tpu.net import JaxNet
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.data import imagenet as timagenet
from sparknet_tpu_torch.data import transforms as ttransforms
from sparknet_tpu_torch.io import caffemodel as tcaffemodel
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.ops import common as tcommon
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils import rngs
from sparknet_tpu_torch.utils.tree import tree_leaves

CROP = 67


def narrow_alexnet(batch: int, dropout: float = 0.5, classes: int = 4) -> str:
    """AlexNet's layer sequence (``alexnet_train_val.prototxt``) at narrow
    widths, host-fed at ``batch`` x 3 x 67 x 67."""
    def conv(name, bottom, n, k, s=1, p=0, g=1):
        return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
                f'top: "{name}" param {{ lr_mult: 1 decay_mult: 1 }} '
                f'param {{ lr_mult: 2 decay_mult: 0 }} convolution_param {{ '
                f'num_output: {n} kernel_size: {k} stride: {s} pad: {p} '
                f'group: {g} weight_filler {{ type: "xavier" }} '
                f'bias_filler {{ type: "constant" value: 0.1 }} }} }}\n'
                f'layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" '
                f'top: "{name}" }}\n')

    def lrn_pool(i, bottom):
        return (f'layer {{ name: "norm{i}" type: "LRN" bottom: "{bottom}" '
                f'top: "norm{i}" lrn_param {{ local_size: 5 alpha: 0.0001 '
                f'beta: 0.75 }} }}\n'
                f'layer {{ name: "pool{i}" type: "Pooling" bottom: "norm{i}" '
                f'top: "pool{i}" pooling_param {{ pool: MAX kernel_size: 3 '
                f'stride: 2 }} }}\n')

    def fc(name, bottom, n, drop):
        s = (f'layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" '
             f'top: "{name}" param {{ lr_mult: 1 decay_mult: 1 }} '
             f'param {{ lr_mult: 2 decay_mult: 0 }} inner_product_param {{ '
             f'num_output: {n} weight_filler {{ type: "xavier" }} '
             f'bias_filler {{ type: "constant" value: 0.1 }} }} }}\n')
        if drop:
            s += (f'layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" '
                  f'top: "{name}" }}\n'
                  f'layer {{ name: "drop_{name}" type: "Dropout" bottom: '
                  f'"{name}" top: "{name}" dropout_param {{ dropout_ratio: '
                  f'{dropout} }} }}\n')
        return s

    return (
        'name: "narrow_alexnet"\n'
        f'layer {{ name: "data" type: "HostData" top: "data" top: "label" '
        f'java_data_param {{ shape {{ dim: {batch} dim: 3 dim: {CROP} '
        f'dim: {CROP} }} shape {{ dim: {batch} }} }} }}\n'
        + conv("conv1", "data", 8, 11, s=4) + lrn_pool(1, "conv1")
        + conv("conv2", "pool1", 16, 5, p=2, g=2) + lrn_pool(2, "conv2")
        + conv("conv3", "pool2", 24, 3, p=1) + conv("conv4", "conv3", 24, 3, p=1, g=2)
        + conv("conv5", "conv4", 16, 3, p=1, g=2)
        + 'layer { name: "pool5" type: "Pooling" bottom: "conv5" top: "pool5" '
          'pooling_param { pool: MAX kernel_size: 3 stride: 2 } }\n'
        + fc("fc6", "pool5", 32, True) + fc("fc7", "fc6", 32, True)
        + fc("fc8", "fc7", classes, False)
        + 'layer { name: "accuracy" type: "Accuracy" bottom: "fc8" '
          'bottom: "label" top: "accuracy" include { phase: TEST } }\n'
        + 'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" '
          'bottom: "label" top: "loss" }\n'
    )


# ----------------------------------------------------------------------
# the data stage
# ----------------------------------------------------------------------
def test_synthetic_shards_and_minibatches_equal_jax(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    for mod, d in ((jimagenet, jdir), (timagenet, tdir)):
        mod.write_synthetic_imagenet(d, num_shards=2, images_per_shard=7,
                                     corrupt_every=5, seed=3)
    for name in sorted(os.listdir(jdir)):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jl = jimagenet.ImageNetLoader(jdir)
    tl = timagenet.ImageNetLoader(tdir)
    assert [os.path.basename(p) for p in jl.list_shards("train.")] == \
        [os.path.basename(p) for p in tl.list_shards("train.")]
    jparts = jl.partitions("train.", "train.txt", num_parts=2)
    tparts = tl.partitions("train.", "train.txt", num_parts=2)
    for jp, tp in zip(jparts, tparts):
        jm = list(jimagenet.ScaleAndConvert(2, 21, 19).make_minibatches(jp))
        tm = list(timagenet.ScaleAndConvert(2, 21, 19).make_minibatches(tp))
        assert len(jm) == len(tm) > 0
        for (jx, jy), (tx, ty) in zip(jm, tm):
            assert tx.dtype == np.uint8 and np.array_equal(tx, jx)
            assert ty.dtype == np.int32 and np.array_equal(ty, jy)
        jmean = jimagenet.compute_mean(iter(jm))
        tmean = timagenet.compute_mean(iter(tm))
        assert np.array_equal(jmean[0], tmean[0]) and jmean[1] == tmean[1]
        jsum = jimagenet.compute_mean(iter(jm), return_sum=True)
        tsum = timagenet.compute_mean(iter(tm), return_sum=True)
        assert np.array_equal(jimagenet.reduce_mean_sums([jsum, jsum]),
                              timagenet.reduce_mean_sums([tsum, tsum]))


@pytest.mark.parametrize("shape", [(3, 9, 11), (1, 3, 5, 5), (3, 1, 1)])
def test_mean_binaryproto_bytes_equal_jax(tmp_path, shape):
    mean = np.random.RandomState(4).rand(*shape).astype(np.float32) * 255
    jp, tp = str(tmp_path / "j.binaryproto"), str(tmp_path / "t.binaryproto")
    jcaffemodel.save_mean_image(mean, jp)
    tcaffemodel.save_mean_image(mean, tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    got = tcaffemodel.load_mean_image(jp)
    assert np.array_equal(got, jcaffemodel.load_mean_image(jp))
    assert np.array_equal(got.reshape(mean.shape), mean)


# ----------------------------------------------------------------------
# the transforms
# ----------------------------------------------------------------------
def _images(n=4, h=21, w=23, seed=5):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (n, 3, h, w)).astype(np.uint8)
    mean = (rs.rand(3, h, w) * 255).astype(np.float32)
    return imgs, mean


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_offset_crop_equals_jax_crop_one(per_channel, scale):
    imgs, mean = _images()
    if per_channel:
        mean = mean.mean(axis=(1, 2), keepdims=True)
    crop = 15
    h_offs, w_offs = [0, 6, 3, 2], [8, 0, 5, 1]
    flips = [False, True, True, False]
    want = np.stack([
        np.asarray(jtransforms._crop_one(
            jnp.asarray(im), jnp.asarray(mean), ho, wo, crop, jnp.asarray(fl),
            scale))
        for im, ho, wo, fl in zip(imgs, h_offs, w_offs, flips)
    ])
    got = ttransforms.crop_batch(torch.from_numpy(imgs), torch.from_numpy(mean),
                                 h_offs, w_offs, flips, crop, scale)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_channel", [False, True])
def test_test_transform_equals_jax(per_channel):
    imgs, mean = _images(h=20, w=23)
    if per_channel:
        mean = mean.mean(axis=(1, 2), keepdims=True)
    want = jtransforms.test_transform(mean, 15)({"data": jnp.asarray(imgs)})
    got = ttransforms.test_transform(mean, 15)(
        {"data": torch.from_numpy(imgs), "label": torch.zeros(4)})
    assert np.array_equal(got["data"].numpy(), np.asarray(want["data"]))
    assert "label" in got


def test_train_transform_draws_per_key():
    imgs, mean = _images(n=16)
    fn = ttransforms.train_transform(mean, 15)
    batch = {"data": torch.from_numpy(imgs)}
    a, b = fn(batch, 11)["data"], fn(batch, 11)["data"]
    assert torch.equal(a, b)  # one key, one crop
    assert not torch.equal(a, fn(batch, 12)["data"])
    # every image is one of its windows, mean-subtracted, maybe mirrored
    gen = rngs.generator(11)
    h = torch.randint(0, 21 - 15 + 1, (16,), generator=gen)
    w = torch.randint(0, 23 - 15 + 1, (16,), generator=gen)
    f = torch.rand((16,), generator=gen) < 0.5
    want = ttransforms.crop_batch(batch["data"], torch.from_numpy(mean), h, w,
                                  f, 15)
    assert torch.equal(a, want)
    assert 0 < int(f.sum()) < 16
    # no mirror, full size = crop: the identity minus the mean
    same = ttransforms.train_transform(mean, 21, mirror=False)(
        {"data": torch.from_numpy(imgs[..., :21])}, 3)["data"]
    assert torch.equal(same, torch.from_numpy(
        imgs[..., :21].astype(np.float32) - mean[..., :21]))


# ----------------------------------------------------------------------
# config and layers
# ----------------------------------------------------------------------
def test_replace_data_layers_equals_jax():
    text = narrow_alexnet(2)
    shapes = ([(8, 3, 67, 67), (8,)], [(4, 3, 67, 67), (4,)])
    jn = jconfig.replace_data_layers(jconfig.parse_net_prototxt(text), *shapes)
    tn = tconfig.replace_data_layers(tconfig.parse_net_prototxt(text), *shapes)
    assert [(l.name, l.type, l.top, l.bottom) for l in jn.layer] == \
        [(l.name, l.type, l.top, l.bottom) for l in tn.layer]
    for jl, tl in zip(jn.layer[:2], tn.layer[:2]):
        assert [s.dim for s in jl.java_data_param.shape] == \
            [s.dim for s in tl.java_data_param.shape]
        assert jl.include[0].phase == tl.include[0].phase
    assert TorchNet(tn, "TEST").blob_shapes["data"] == (4, 3, 67, 67)
    # the zoo AlexNet at the leg's batch: 60,965,224 parameters
    alex = tconfig.replace_data_layers(tmodels.load_model("alexnet"),
                                       [(2, 3, 227, 227), (2,)])
    layout = TorchNet(alex, "TRAIN").blob_layout()
    assert sum(int(np.prod(s)) for v in layout.values() for s in v) == 60965224


def test_dropout():
    x = torch.ones(64, 512)
    key = rngs.fold_in(rngs.train_key(0), 3)
    for train, ratio in ((False, 0.5), (True, 0.0)):
        assert tcommon.inverted_dropout(x, key, ratio, train, "d") is x
    with pytest.raises(ValueError, match="rng"):
        tcommon.inverted_dropout(x, None, 0.5, True, "d")
    ratio = 0.3
    y = tcommon.inverted_dropout(x, key, ratio, True, "d")
    kept = y != 0
    # the kept units are scaled by 1/(1-ratio), the rest are zero
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1 - ratio)))
    # the kept share within 3 sigma of 1 - ratio
    n = x.numel()
    sigma = np.sqrt(ratio * (1 - ratio) / n)
    assert abs(float(kept.float().mean()) - (1 - ratio)) < 3 * sigma
    # one key, one mask; another key, another mask
    assert torch.equal(y, tcommon.inverted_dropout(x, key, ratio, True, "d"))
    other = tcommon.inverted_dropout(x, key + 1, ratio, True, "d")
    assert not torch.equal(y, other)


# ----------------------------------------------------------------------
# the fused net
# ----------------------------------------------------------------------
def _batch(n, seed, classes=4):
    rs = np.random.RandomState(seed)
    return {"data": (rs.randn(n, 3, CROP, CROP) * 40).astype(np.float32),
            "label": rs.randint(0, classes, n).astype(np.float32)}


def _port_loss_grads(net, params, stats, batch, rng):
    req = {k: [p.clone().requires_grad_(True) for p in v] for k, v in params.items()}
    loss, _ = net.loss_fn(req, stats, {k: torch.from_numpy(v) for k, v in
                                       batch.items()}, True, rng=rng)
    grads = torch.autograd.grad(loss, tree_leaves(req))
    return float(loss.detach()), [g.numpy() for g in grads]


def test_net_level_fusion_matches_unfused(monkeypatch):
    """The port's TorchNet with SPARKNET_FUSION=1 fuses both sandwiches
    of the narrow AlexNet and gives the unfused loss and gradients (one
    key: the same dropout masks); the TEST net keeps the full blob map."""
    netp = tconfig.parse_net_prototxt(narrow_alexnet(4))
    batch = _batch(4, 6)
    monkeypatch.setenv("SPARKNET_FUSION", "0")
    plain = TorchNet(netp, "TRAIN")
    assert not plain._plp_fused
    params, stats = plain.init(seed=0, device="cpu")
    key = rngs.train_key(5)
    loss_ref, g_ref = _port_loss_grads(plain, params, stats, batch, key)
    monkeypatch.setenv("SPARKNET_FUSION", "1")
    fused = TorchNet(netp, "TRAIN")
    assert sorted(p[0] for p in fused._plp_fused.values()) == ["pool1", "pool2"]
    loss_f, g_f = _port_loss_grads(fused, params, stats, batch, key)
    np.testing.assert_allclose(loss_f, loss_ref, rtol=1e-6)
    for a, b in zip(g_f, g_ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    blobs = fused.apply(params, stats, {k: torch.from_numpy(v) for k, v in
                                        batch.items()}, rng=key).blobs
    assert "norm1" not in blobs and "pool1" in blobs
    assert not TorchNet(netp, "TEST")._plp_fused


def _port_and_jax_grads(monkeypatch, fusion):
    """The narrow AlexNet (dropout 0) of the port and of the JAX package
    from the same carried params on one batch: ``(tnet, params, stats,
    batch, port loss, port grads, JAX loss, JAX grads)``."""
    monkeypatch.setenv("SPARKNET_FUSION", fusion)
    text = narrow_alexnet(4, dropout=0.0)
    jnet = JaxNet(jconfig.parse_net_prototxt(text), phase="TRAIN")
    tnet = TorchNet(tconfig.parse_net_prototxt(text), "TRAIN")
    assert bool(jnet._plp_fused) == bool(tnet._plp_fused) == (fusion == "1")
    jparams, jstats = jnet.init(seed=0)
    params, stats = interop.net_params_from_jax(
        {k: [np.asarray(b) for b in v] for k, v in jparams.items()}, tnet)
    batch = _batch(4, 7)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, jstats, {k: jnp.asarray(v) for k, v in
                                           batch.items()},
                               jax.random.PRNGKey(0))[0])(jparams)
    loss, grads = _port_loss_grads(tnet, params, stats, batch, rngs.train_key(0))
    jleaves = [np.asarray(jgrads[k][i]) for k in params for i in range(len(params[k]))]
    return tnet, params, stats, batch, loss, grads, float(jloss), jleaves


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_net_matches_the_jax_net(monkeypatch, fusion):
    """Loss and gradients of the narrow AlexNet (dropout 0) against
    JaxNet's from the same carried params, fused (Pallas interpret) and
    unfused.  Each gradient leaf is held to rtol 1e-4 plus an atol of 1e-6
    of the leaf's largest magnitude: a fixed atol of 1e-6 sat below
    float32 noise on cancelling elements of the larger leaves (fc8's
    weight gradient, largest magnitude 5: port and JAX 1.8e-6 apart on
    one element of 2.8e-3, each ~1e-6 from the float64 result; see
    ``test_net_grads_lie_within_float32_noise_of_float64``)."""
    _, _, _, _, loss, grads, jloss, jleaves = _port_and_jax_grads(
        monkeypatch, fusion)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    for a, b in zip(grads, jleaves):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(b).max()))


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_net_grads_lie_within_float32_noise_of_float64(monkeypatch, fusion):
    """The referee of the test above: the port's net run in float64
    (params, stats and batch cast).  The port's and the JAX package's
    float32 gradients both lie within 2e-6 of each leaf's largest
    magnitude from it (measured: port 9.4e-7, JAX 6.1e-7 unfused and
    7.7e-7 fused; the port's extra is torch's CPU convolution summing
    conv1's 363 products in another order: 6.2e-7 of conv1's output
    from float64 against XLA's 3.2e-7)."""
    tnet, params, stats, batch, _, grads, _, jleaves = _port_and_jax_grads(
        monkeypatch, fusion)
    p64 = {k: [p.double() for p in v] for k, v in params.items()}
    s64 = {k: [x.double() for x in v] for k, v in stats.items()}
    b64 = {k: v.astype(np.float64) for k, v in batch.items()}
    _, exact = _port_loss_grads(tnet, p64, s64, b64, rngs.train_key(0))
    for a, b, x in zip(grads, jleaves, exact):
        assert x.dtype == np.float64
        scale = float(np.abs(x).max())
        assert float(np.abs(a - x).max()) <= 2e-6 * scale
        assert float(np.abs(b - x).max()) <= 2e-6 * scale


# ----------------------------------------------------------------------
# one trainer round against the JAX trainer
# ----------------------------------------------------------------------
W, TAU, B = 2, 2, 4


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_trainer_round_matches_the_jax_trainer(monkeypatch, fusion):
    """The JAX trainer runs unfused in both cases: on this JAX its
    shard_map refuses a pallas_call output without a ``vma``, so the JAX
    package's fused kernel cannot run inside its trainer's round; the
    fused JAX net is held to the port's in ``test_net_matches_the_jax_net``.
    """
    monkeypatch.setenv("SPARKNET_FUSION", "0")
    text = narrow_alexnet(B, dropout=0.0)
    rs = np.random.RandomState(8)
    mean = (rs.rand(3, CROP, CROP) * 255).astype(np.float32)
    data = {"data": rs.randint(0, 256, (W, TAU, B, 3, CROP, CROP)).astype(np.uint8),
            "label": rs.randint(0, 4, (W, TAU, B)).astype(np.float32)}
    sp = 'base_lr: 0.01 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0005'
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jsolver = JSolver(
        jconfig.parse_solver_prototxt(sp),
        net_param=jconfig.parse_net_prototxt(text),
        train_transform=jtransforms.train_transform(mean, CROP, mirror=False),
        test_transform=jtransforms.test_transform(mean, CROP),
    )
    jt = JTrainer(jsolver, mesh)
    monkeypatch.setenv("SPARKNET_FUSION", fusion)
    tsolver = TSolver(
        tconfig.parse_solver_prototxt(sp),
        net_param=tconfig.parse_net_prototxt(text), device="cpu",
        train_transform=ttransforms.train_transform(mean, CROP, mirror=False),
        test_transform=ttransforms.test_transform(mean, CROP),
    )
    tt = TTrainer(tsolver, W)
    assert bool(tsolver.net._plp_fused) == (fusion == "1")
    jstate = jt.init_state(seed=0)
    tparams, tstats = interop.net_params_from_jax(
        {k: [np.asarray(b[0]) for b in v] for k, v in jstate.params.items()},
        tsolver.net)
    tstate = tt.broadcast_state(TrainState(
        tparams, tstats, _init_history(tsolver.method, tparams),
        torch.tensor(0)))
    jstate, jl = jt.round(jstate, shard_leading(data, mesh))
    tstate, tl = tt.round(tstate, {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    for k, blobs in tstate.params.items():
        for i, t in enumerate(blobs):
            np.testing.assert_allclose(t.numpy(), np.asarray(jstate.params[k][i]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{k}[{i}]")
    # the test forward through the centre-crop transform
    test = {k: v[:, :1] for k, v in data.items()}
    jscores = jt.test_and_store_result(jstate, shard_leading(test, mesh))
    tscores = tt.test_and_store_result(
        tstate, {k: torch.from_numpy(v) for k, v in test.items()})
    for name in ("accuracy", "loss"):
        np.testing.assert_allclose(tscores[name], jscores[name], rtol=1e-5)


def test_overlapped_bf16_rounds_match_the_jax_trainer(monkeypatch):
    """Two rounds of narrow AlexNet with ``compress="bf16",
    overlap_avg=True`` and the JAX trainer with the same flags, then
    ``finalize``: the second round starts from the first's average,
    landed by the overlap correction (K11's plain version on the CPU),
    and finalize lands the second's.  Losses within rtol 1e-5, as one
    round's; each blob within 1e-3 of its move from the init (float32
    sums in another order over two rounds, and a last-bit difference may
    move a delta across a step of the bf16 grid; measured ~1e-4).
    base_lr 0.001: at 0.01 the narrow net's loss on these unscaled
    images climbs to ~100 in round 0."""
    monkeypatch.setenv("SPARKNET_FUSION", "0")
    text = narrow_alexnet(B, dropout=0.0)
    rs = np.random.RandomState(9)
    mean = (rs.rand(3, CROP, CROP) * 255).astype(np.float32)
    rounds = [{"data": rs.randint(0, 256, (W, TAU, B, 3, CROP, CROP)).astype(np.uint8),
               "label": rs.randint(0, 4, (W, TAU, B)).astype(np.float32)}
              for _ in range(2)]
    sp = 'base_lr: 0.001 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0005'
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jsolver = JSolver(
        jconfig.parse_solver_prototxt(sp),
        net_param=jconfig.parse_net_prototxt(text),
        train_transform=jtransforms.train_transform(mean, CROP, mirror=False),
        test_transform=jtransforms.test_transform(mean, CROP),
    )
    jt = JTrainer(jsolver, mesh, compress="bf16", overlap_avg=True)
    tsolver = TSolver(
        tconfig.parse_solver_prototxt(sp),
        net_param=tconfig.parse_net_prototxt(text), device="cpu",
        train_transform=ttransforms.train_transform(mean, CROP, mirror=False),
        test_transform=ttransforms.test_transform(mean, CROP),
    )
    tt = TTrainer(tsolver, W, compress="bf16", overlap_avg=True)
    jstate = jt.init_state(seed=0)
    tparams, tstats = interop.net_params_from_jax(
        {k: [np.asarray(b[0]) for b in v] for k, v in jstate.params.items()},
        tsolver.net)
    tstate = tt.broadcast_state(TrainState(
        tparams, tstats, _init_history(tsolver.method, tparams),
        torch.tensor(0)))
    x0 = {k: [t[0].clone() for t in v] for k, v in tstate.params.items()}
    for data in rounds:
        jstate, jl = jt.round(jstate, shard_leading(data, mesh))
        tstate, tl = tt.round(tstate, {k: torch.from_numpy(v)
                                       for k, v in data.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6)
    assert tt._comm.has_pending
    jstate, tstate = jt.finalize(jstate), tt.finalize(tstate)
    assert not tt._comm.has_pending
    for k, blobs in tstate.params.items():
        for i, t in enumerate(blobs):
            want = np.asarray(jstate.params[k][i])
            step = float(np.abs(want - x0[k][i].numpy()[None]).max())
            gap = float(np.abs(t.numpy() - want).max())
            assert gap <= 1e-3 * step, f"{k}[{i}]: {gap} of {step}"


# ----------------------------------------------------------------------
# the app
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fusion,extra", [
    ("0", []), ("1", []), ("0", ["--compress", "bf16", "--overlap_avg"])],
    ids=["0", "1", "0-bf16-overlap"])
def test_imagenet_app_runs_full_alexnet_on_the_cpu(monkeypatch, fusion, extra):
    monkeypatch.setenv("SPARKNET_FUSION", fusion)
    result = {}
    rc = imagenet_app.main(
        ["--device", "cpu", "--workers", "2", "--tau", "2", "--rounds", "2",
         "--full_size", "72", "--crop", "67", "--train_batch", "4",
         "--test_batch", "4", "--test_every", "1"] + extra, result)
    assert rc == 0
    losses = result["losses"]
    assert losses.shape == (2, 2, 2) and np.isfinite(losses).all()
    assert abs(float(losses[0, :, 0].mean()) - np.log(1000)) < 0.5
    assert len(result["accuracies"]) == 3  # rounds 0, 1 and the final test
    tr = result["trainer"]
    assert bool(tr.solver.net._plp_fused) == (fusion == "1")
    assert not tr.solver.test_net._plp_fused
    assert result["mean"].shape == (3, 72, 72)
    for t in tree_leaves(result["state"].params):
        assert torch.isfinite(t).all()
    if extra:  # every round's average landed, the last at finalize
        assert tr._comm.compress == "bf16" and tr._comm.overlap
        assert not tr._comm.has_pending


@pytest.mark.parametrize("flag", [["--trace_out", "/t"],
                                  ["--slo"], ["--model", "vgg16"]])
def test_imagenet_app_refuses_what_is_not_yet_ported(flag):
    """Every flag of a later slice exits saying so; a model outside the
    zoo (GoogLeNet and ResNet-50 are in it now) exits naming the zoo.
    (The chunk cache, ``--shuffle_epochs`` and object-store ``--data``
    run now: ``tests/test_torch_data_plane.py``.)"""
    match = "unknown --model" if flag[0] == "--model" else "not yet ported"
    with pytest.raises(SystemExit, match=match):
        imagenet_app.main(["--device", "cpu"] + flag)


def test_imagenet_app_stale_bound_trains_as_the_jax_app():
    """``--stale_bound 1`` (once refused here): the bounded-staleness
    trainer at AlexNet's full width; every worker arrives each round, so
    the run stays within 1e-5 of the synchronous one (the JAX package
    pins allclose), and ``--profile`` rides along."""
    argv = ["--device", "cpu", "--workers", "2", "--tau", "1", "--rounds", "1",
            "--full_size", "72", "--crop", "67", "--train_batch", "2",
            "--test_batch", "2", "--test_every", "10"]
    sync, stale = {}, {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # under the parallel run's load
    try:
        imagenet_app.main(argv, sync)
        imagenet_app.main(argv + ["--stale_bound", "1", "--profile"], stale)
    finally:
        torch.set_num_threads(n)
    assert list(stale["trainer"].worker_rounds) == [1, 1]
    assert stale["profile"]["rounds"] == 1
    for a, b in zip(tree_leaves(sync["state"].params),
                    tree_leaves(stale["state"].params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
