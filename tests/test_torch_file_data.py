"""The port's file-backed data sources and transforms against the JAX
package's, on the CPU.

Numpy-seeded throughout, so the port must give the JAX package's arrays
for the same files and seed:

- ``data/transforms.py``: ``finish_host_crops`` (the ``u8_output``
  finish) and every branch of ``from_transform_param`` against the JAX
  closures on the same inputs, bit for bit (tolerance: none).  The
  random crop and mirror draw from different generators by design
  (``utils/rngs.py``), so those branches are held at a full-size crop
  (offset 0) and, for the mirror, image by image to JAX's flipped or
  unflipped output;
- ``data/transformer.py`` (``DataTransformer``, ``oversample_chw``),
  ``data/windows.py`` (``parse_window_file``, ``crop_window``,
  ``WindowSampler``): equal to JAX's, after JAX ``tests/test_windows.py``;
- ``resolve_batches`` over ``HDF5Data``, ``ImageData`` and
  ``WindowData`` nets, their declared shapes, and
  ``write_hdf5_output``'s file: equal to JAX's;
- the ``HDF5Output`` sink taps its bottoms and ``cli train`` writes them;
- ``featurizer_app``'s features within 1e-5 of the JAX featurizer's on
  the same weights, relative to the features' largest magnitude (float32
  forwards of raw pixel values summed in another order: measured
  1.3e-5 absolute on features up to 43, 3.1e-7 relative, in the toy
  net's case).
"""

import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu import config as jconfig
from sparknet_tpu.apps import featurizer_app as jfeaturizer
from sparknet_tpu.config.schema import TransformationParameter as JTP
from sparknet_tpu.config.schema import WindowDataParameter as JWDP
from sparknet_tpu.data import source as jsource
from sparknet_tpu.data import transformer as jtransformer
from sparknet_tpu.data import transforms as jtransforms
from sparknet_tpu.data import windows as jwindows
from sparknet_tpu.io import hdf5 as jhdf5
from sparknet_tpu.net import JaxNet
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch.apps import featurizer_app
from sparknet_tpu_torch.config.schema import TransformationParameter as TTP
from sparknet_tpu_torch.config.schema import WindowDataParameter as TWDP
from sparknet_tpu_torch.data import CifarLoader
from sparknet_tpu_torch.data import source as tsource
from sparknet_tpu_torch.data import transformer as ttransformer
from sparknet_tpu_torch.data import transforms as ttransforms
from sparknet_tpu_torch.data import windows as twindows
from sparknet_tpu_torch.io import caffemodel, hdf5
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.tools import cli


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(tmp_path / "logs"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------
# device-side transforms

RS = np.random.RandomState(0)
IMGS = RS.randint(0, 256, (5, 3, 12, 14)).astype(np.uint8)
MEAN_IMG = (RS.rand(3, 12, 14) * 255).astype(np.float32)
MEAN_CH = np.asarray([100.0, 110.0, 120.0], np.float32)


@pytest.mark.parametrize("mean", ["image", "channel", "channel3d", "none"])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_finish_host_crops_equals_jax(mean, scale):
    """The u8_output finish: the mean over each image's source window,
    the scale and the mirror, bit for bit."""
    m = {"image": MEAN_IMG, "channel": MEAN_CH,
         "channel3d": MEAN_CH[:, None, None], "none": None}[mean]
    crops = RS.randint(0, 256, (5, 3, 8, 9)).astype(np.uint8)
    geo = {"h_off": np.array([0, 4, 2, 1, 3], np.int32),
           "w_off": np.array([5, 0, 3, 2, 1], np.int32),
           "flip": np.array([1, 0, 1, 0, 0], np.uint8)}
    host = {"data": crops, "label": np.arange(5, dtype=np.float32), **geo}
    got = ttransforms.finish_host_crops(m, scale)(
        {k: torch.from_numpy(v) for k, v in host.items()})
    want = jtransforms.finish_host_crops(m, scale)(
        {k: jnp.asarray(v) for k, v in host.items()}, None)
    assert set(got) == set(want) == {"data", "label"}
    assert np.array_equal(_np(got["data"]), np.asarray(want["data"]))
    assert got["data"].dtype == torch.float32


def _tp(cls, **kw):
    return cls(**kw)


FTP_CASES = {
    "identity": dict(),
    "scale_only": dict(scale=0.5),
    "mean_value": dict(mean_value=[100.0, 110.0, 120.0]),
    "mean_value_scale": dict(mean_value=[100.0, 110.0, 120.0], scale=0.125),
    "mean_file": dict(mean_file="MEAN"),
    "crop": dict(crop_size=8, mean_value=[50.0, 60.0, 70.0]),
    "crop_mean_file": dict(crop_size=8, mean_file="MEAN", scale=0.5),
    "full_crop": dict(crop_size=12, mean_file="MEAN"),
}


@pytest.mark.parametrize("case", sorted(FTP_CASES))
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_from_transform_param_equals_jax(case, phase, tmp_path):
    """Every branch the JAX closure takes, bit for bit: the identity
    (None), the no-crop branches and the crops.  A TRAIN crop smaller
    than the image draws its offsets from the port's generator, so there
    the test holds shapes and that each image is a window of the input."""
    kw = dict(FTP_CASES[case])
    imgs = IMGS[:, :, :, :12]  # 12 x 12 (the mean image likewise)
    if kw.get("mean_file"):
        from sparknet_tpu.io import caffemodel as jcaffemodel

        path = str(tmp_path / "mean.binaryproto")
        jcaffemodel.save_mean_image(MEAN_IMG[:, :, :12], path)
        kw["mean_file"] = path
    tfn = ttransforms.from_transform_param(_tp(TTP, **kw), phase=phase)
    jfn = jtransforms.from_transform_param(_tp(JTP, **kw), phase=phase)
    assert (tfn is None) == (jfn is None) == (case == "identity")
    if tfn is None:
        return
    tb = {"data": torch.from_numpy(imgs), "label": torch.zeros(5)}
    jb = {"data": jnp.asarray(imgs), "label": jnp.zeros(5)}
    if phase == "TRAIN":
        got, want = tfn(tb, 7), jfn(jb, jax.random.PRNGKey(7))
    else:
        got, want = tfn(tb), jfn(jb)
    g, w = _np(got["data"]), np.asarray(want["data"])
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    if phase == "TRAIN" and kw.get("crop_size") == 8:
        mean = (torch.tensor(kw["mean_value"])[:, None, None]
                if "mean_value" in kw else torch.from_numpy(MEAN_IMG[:, :, :12]))
        for i in range(5):
            assert any(np.array_equal(g[i], _np(ttransforms.crop_batch(
                tb["data"][i:i + 1], mean, [h], [x], [False], 8,
                kw.get("scale", 1.0))[0])) for h in range(5) for x in range(5))
        return
    assert np.array_equal(g, w)


def test_from_transform_param_no_crop_mirror_flips_whole_images():
    """No crop, TRAIN, mirror: each image is JAX's output or its mirror
    (the coin is the port's generator's), and both sides occur."""
    kw = dict(mirror=True, mean_value=[10.0, 20.0, 30.0])
    tfn = ttransforms.from_transform_param(_tp(TTP, **kw), phase="TRAIN")
    jfn = jtransforms.from_transform_param(_tp(JTP, **kw), phase="TEST")
    imgs = RS.randint(0, 256, (64, 3, 4, 5)).astype(np.uint8)
    got = _np(tfn({"data": torch.from_numpy(imgs)}, 3)["data"])
    plain = np.asarray(jfn({"data": jnp.asarray(imgs)})["data"])
    flipped = [np.array_equal(g, p[..., ::-1]) for g, p in zip(got, plain)]
    same = [np.array_equal(g, p) for g, p in zip(got, plain)]
    assert all(f or s for f, s in zip(flipped, same))
    assert any(flipped) and any(same)


# ----------------------------------------------------------------------
# the host DataTransformer


@pytest.mark.parametrize("kw,phase,mean", [
    (dict(crop_size=8, mirror=True), "TRAIN", "image"),
    (dict(crop_size=8, mirror=True), "TEST", "image"),
    (dict(crop_size=8, mean_value=[5.0, 6.0, 7.0], scale=0.5), "TRAIN", None),
    (dict(mean_value=[9.0]), "TEST", None),
    (dict(mirror=True, scale=2.0), "TRAIN", None),
    (dict(), "TEST", "full"),
])
def test_data_transformer_equals_jax(kw, phase, mean):
    imgs = IMGS[:, :, :, :12]
    mimg = {"image": MEAN_IMG[:, :, :12], "full": MEAN_IMG[:, :, :12],
            None: None}[mean]
    t = ttransformer.DataTransformer(TTP(**kw), phase=phase, mean_image=mimg,
                                     seed=3)
    j = jtransformer.DataTransformer(JTP(**kw), phase=phase, mean_image=mimg,
                                     seed=3)
    for _ in range(3):  # the generators advance alike
        assert np.array_equal(t(imgs), j(imgs))


def test_data_transformer_refusals_equal_jax():
    with pytest.raises(ValueError, match="mean_image"):
        ttransformer.DataTransformer(TTP(mean_file="m"))
    with pytest.raises(ValueError, match="exclusive"):
        ttransformer.DataTransformer(TTP(mean_value=[1.0]),
                                     mean_image=MEAN_IMG)
    with pytest.raises(ValueError, match="exceeds"):
        ttransformer.DataTransformer(TTP(crop_size=40))(IMGS)


def test_oversample_equals_jax():
    chw = IMGS[0]
    assert np.array_equal(ttransformer.oversample_chw(chw, 7, 9),
                          jtransformer.oversample_chw(chw, 7, 9))
    with pytest.raises(ValueError, match="smaller"):
        ttransformer.oversample_chw(chw, 20, 9)


# ----------------------------------------------------------------------
# R-CNN windows (after JAX tests/test_windows.py)


@pytest.fixture()
def window_file(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    entries = []
    for i in range(3):
        h, w = 48 + 8 * i, 64
        arr = rng.randint(0, 255, (h, w, 3), np.uint8)
        arr[10:30, 12:32] = [250, 10, 10]
        path = tmp_path / f"im{i}.png"
        Image.fromarray(arr).save(path)
        windows = [(3, 0.9, 12, 10, 31, 29), (3, 0.2, 30, 25, 60, 45),
                   (0, 0.0, 40, 2, 62, 20)]
        entries.append(f"# {i}\n{path}\n3\n{h}\n{w}\n{len(windows)}\n" + "\n".join(
            f"{c} {ov} {x1} {y1} {x2} {y2}" for c, ov, x1, y1, x2, y2 in windows))
    wf = tmp_path / "window_file.txt"
    wf.write_text("\n".join(entries) + "\n")
    return str(wf)


def _wparams(window_file, **kw):
    d = dict(source=window_file, batch_size=16, crop_size=24,
             fg_threshold=0.5, bg_threshold=0.5, fg_fraction=0.25,
             context_pad=0, crop_mode="warp")
    d.update(kw)
    return TWDP(**d), JWDP(**d)


def test_parse_window_file_equals_jax(window_file):
    t = twindows.parse_window_file(window_file)
    j = jwindows.parse_window_file(window_file)
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        assert (a.path, a.channels, a.height, a.width) == (
            b.path, b.channels, b.height, b.width)
        assert np.array_equal(a.windows, b.windows)
    assert twindows.read_window_file_header(window_file) == \
        jwindows.read_window_file_header(window_file) == (3, 48, 64)
    with pytest.raises(ValueError, match="not a window file"):
        twindows.read_window_file_header(__file__)


@pytest.mark.parametrize("pad,square,mirror", [
    (0, False, False), (4, False, False), (8, False, True), (0, True, False),
    (6, True, True)])
@pytest.mark.parametrize("box", [(0, 0, 19, 19), (12, 10, 31, 29),
                                 (40, 30, 63, 47)])
def test_crop_window_equals_jax(window_file, pad, square, mirror, box):
    img = jwindows._load_image(jwindows.parse_window_file(window_file)[0].path, 3)
    got = twindows.crop_window(img, *box, 24, context_pad=pad, square=square,
                               do_mirror=mirror)
    want = jwindows.crop_window(img, *box, 24, context_pad=pad, square=square,
                                do_mirror=mirror)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


@pytest.mark.parametrize("kw,mean", [
    (dict(), None),
    (dict(context_pad=4, mirror=True), "value"),
    (dict(crop_mode="square", scale=0.5, mirror=True), "image"),
    (dict(fg_fraction=0.5, cache_images=True), "value"),
])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_window_sampler_batches_equal_jax(window_file, kw, mean, phase):
    tp, jp = _wparams(window_file, **kw)
    m = {None: None, "value": np.asarray([100.0, 50.0, 25.0]),
         "image": (np.random.RandomState(1).rand(3, 30, 30) * 255)
         .astype(np.float32)}[mean]
    t = twindows.WindowSampler(tp, mean=m, phase=phase, seed=2)
    j = jwindows.WindowSampler(jp, mean=m, phase=phase, seed=2)
    assert len(t.fg) == len(j.fg) == 3 and len(t.bg) == len(j.bg) == 6
    for _ in range(2):
        (tx, ty), (jx, jy) = t.next_batch(), j.next_batch()
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    assert (ty == 3).sum() == int(16 * jp.fg_fraction)


def test_effective_window_params_equal_jax(window_file):
    text = f"""
    layer {{ name: "data" type: "WindowData" top: "data" top: "label"
      transform_param {{ mirror: true crop_size: 28 mean_value: 120 scale: 0.5 }}
      window_data_param {{ source: "{window_file}" batch_size: 6 }} }}"""
    tl = tconfig.parse_net_prototxt(text).layer[0]
    jl = jconfig.parse_net_prototxt(text).layer[0]
    assert twindows.effective_window_params(tl) == \
        jwindows.effective_window_params(jl)


# ----------------------------------------------------------------------
# resolve_batches over the file-backed layers


def _h5_files(tmp_path, n_files=2, rows=30):
    rng = np.random.RandomState(0)
    names = []
    for i in range(n_files):
        p = tmp_path / f"part{i}.h5"
        with h5py.File(p, "w") as h:
            h["data"] = rng.randn(rows, 4).astype(np.float32)
            h["label"] = rng.randint(0, 2, rows).astype(np.float32)
        names.append(p.name)
    listfile = tmp_path / "train.txt"
    listfile.write_text("\n".join(names) + "\n")
    return str(listfile)


def _h5_net(listfile, shuffle=True):
    return f"""
    name: "logreg"
    layer {{ name: "data" type: "HDF5Data" top: "data" top: "label"
      hdf5_data_param {{ source: "{listfile}" batch_size: 20
      shuffle: {str(shuffle).lower()} }} }}
    layer {{ name: "fc" type: "InnerProduct" bottom: "data" top: "logits"
      inner_product_param {{ num_output: 2 weight_filler {{ type: "xavier" }} }} }}
    layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label"
      top: "loss" }}
    """


def _both(text, phase="TRAIN"):
    tp, jp = tconfig.parse_net_prototxt(text), jconfig.parse_net_prototxt(text)
    return (TorchNet(tp, phase), tp), (JaxNet(jp, phase=phase), jp)


def _same_batches(got, want):
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("phase,shuffle", [("TRAIN", True), ("TEST", True),
                                           ("TRAIN", False)])
def test_hdf5_batches_equal_jax(tmp_path, phase, shuffle):
    listfile = _h5_files(tmp_path)
    (tn, tp), (jn, jp) = _both(_h5_net(listfile, shuffle), phase)
    assert tn.blob_shapes["data"] == jn.blob_shapes["data"] == (20, 4)
    got = tsource.resolve_batches(tn, tp, None, 5, phase=phase, seed=4)
    want = jsource.resolve_batches(jn, jp, None, 5, phase=phase, seed=4)
    _same_batches(got, want)
    # an .h5 / listfile --data routes through the HDF5Data layer
    one = str(tmp_path / "part1.h5")
    _same_batches(tsource.resolve_batches(tn, tp, one, 2, phase=phase),
                  jsource.resolve_batches(jn, jp, one, 2, phase=phase))


def test_hdf5_source_refusals(tmp_path):
    listfile = _h5_files(tmp_path, n_files=1, rows=10)
    (tn, tp), _ = _both(_h5_net(listfile).replace("batch_size: 20",
                                                  "batch_size: 12"))
    with pytest.raises(ValueError, match="rows < batch"):
        tsource.resolve_batches(tn, tp, None, 1, phase="TRAIN")
    with h5py.File(tmp_path / "part0.h5", "a") as h:
        del h["label"]
    with pytest.raises(KeyError, match="no dataset"):
        tsource.resolve_batches(tn, tp, None, 1, phase="TRAIN")


@pytest.fixture()
def image_list(tmp_path):
    from PIL import Image

    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.RandomState(0)
    lines = []
    for i in range(9):
        h, w = 30 + 2 * (i % 3), 36
        arr = rng.randint(0, 200, (h, w, 3), np.uint8)
        arr[:, :, i % 2] += 55
        Image.fromarray(arr).save(root / f"im{i}.png")
        lines.append(f"im{i}.png {i % 2}")
    listfile = tmp_path / "list.txt"
    listfile.write_text("\n".join(lines) + "\n")
    return str(listfile), str(root)


@pytest.mark.parametrize("extra,param", [
    ("crop_size: 24 mirror: true mean_value: 110",
     "new_height: 28 new_width: 32 shuffle: true"),
    ("crop_size: 20", "rand_skip: 4 is_color: false"),
    ("scale: 0.5", "new_height: 26 new_width: 26"),
])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_image_data_batches_equal_jax(image_list, extra, param, phase):
    listfile, root = image_list
    text = f"""
    name: "flickr_ft"
    layer {{ name: "data" type: "ImageData" top: "data" top: "label"
      transform_param {{ {extra} }}
      image_data_param {{ source: "{listfile}" root_folder: "{root}/"
        batch_size: 4 {param} }} }}
    layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
      inner_product_param {{ num_output: 2 weight_filler {{ type: "xavier" }} }} }}
    layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label"
      top: "loss" }}
    """
    (tn, tp), (jn, jp) = _both(text, phase)
    assert tn.blob_shapes["data"] == jn.blob_shapes["data"]
    got = tsource.resolve_batches(tn, tp, None, 4, phase=phase, seed=6)
    want = jsource.resolve_batches(jn, jp, None, 4, phase=phase, seed=6)
    _same_batches(got, want)


def test_image_data_shape_probe_equals_jax(image_list):
    """No crop and no resize: the shape is the first listed image's."""
    listfile, root = image_list
    text = f"""
    layer {{ name: "data" type: "ImageData" top: "data" top: "label"
      image_data_param {{ source: "{listfile}" root_folder: "{root}/"
        batch_size: 2 }} }}"""
    (tn, _), (jn, _) = _both(text, "TEST")
    assert tn.blob_shapes["data"] == jn.blob_shapes["data"] == (2, 3, 30, 36)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_window_data_batches_equal_jax(window_file, phase):
    text = f"""
    name: "ft"
    layer {{ name: "data" type: "WindowData" top: "data" top: "label"
      transform_param {{ mirror: true crop_size: 28 mean_value: 120 }}
      window_data_param {{ source: "{window_file}" batch_size: 6
        fg_fraction: 0.5 context_pad: 4 }} }}
    layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
      inner_product_param {{ num_output: 4 weight_filler {{ type: "xavier" }} }} }}
    layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label"
      top: "loss" }}
    """
    (tn, tp), (jn, jp) = _both(text, phase)
    assert tn.blob_shapes["data"] == jn.blob_shapes["data"] == (6, 3, 28, 28)
    got = tsource.resolve_batches(tn, tp, None, 3, phase=phase, seed=1)
    want = jsource.resolve_batches(jn, jp, None, 3, phase=phase, seed=1)
    _same_batches(got, want)


# ----------------------------------------------------------------------
# HDF5Output


def test_write_hdf5_output_file_equals_jax(tmp_path):
    blobs = {"ip1": np.random.RandomState(2).randn(6, 5).astype(np.float32),
             "label": np.arange(6, dtype=np.float32)}
    hdf5.write_hdf5_output(str(tmp_path / "t.h5"), blobs)
    jhdf5.write_hdf5_output(str(tmp_path / "j.h5"), blobs)
    with h5py.File(tmp_path / "t.h5", "r") as t, \
            h5py.File(tmp_path / "j.h5", "r") as j:
        assert sorted(t) == sorted(j) == ["ip1", "label"]
        for k in t:
            assert t[k].dtype == j[k].dtype
            assert np.array_equal(t[k][()], j[k][()])


def test_hdf5_output_taps_its_bottoms(tmp_path):
    """The sink has no tops; a forward keeps its bottoms, and
    ``write_net_outputs`` writes them under their names."""
    out = str(tmp_path / "tap.h5")
    text = f"""
    layer {{ name: "in" type: "HostData" top: "x"
      java_data_param {{ shape {{ dim: 3 dim: 4 }} }} }}
    layer {{ name: "ip" type: "InnerProduct" bottom: "x" top: "y"
      inner_product_param {{ num_output: 2 weight_filler {{ type: "xavier" }} }} }}
    layer {{ name: "h" type: "HDF5Output" bottom: "y" bottom: "x"
      hdf5_output_param {{ file_name: "{out}" }} }}"""
    net = TorchNet(tconfig.parse_net_prototxt(text), "TEST")
    params, stats = net.init(0)
    assert hdf5.write_net_outputs(net) == []  # nothing ran yet
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 4).astype(np.float32))
    blobs = net.forward(params, stats, {"x": x})
    assert hdf5.write_net_outputs(net) == [out]
    with h5py.File(out, "r") as h:
        assert np.array_equal(h["y"][()], blobs["y"].numpy())
        assert np.array_equal(h["x"][()], x.numpy())


def test_cli_train_on_hdf5_data_writes_hdf5_output(tmp_path):
    """``cli train`` on a net whose train source is HDF5Data (shapes from
    the file) and that taps ``ip1`` through HDF5Output: 2 windows, then
    the sink's file holds the last forward's ``ip1``."""
    listfile = _h5_files(tmp_path, rows=40)
    out = str(tmp_path / "ip1.h5")
    net = tmp_path / "net.prototxt"
    net.write_text(_h5_net(listfile).replace(
        'top: "logits" }}', 'top: "logits" }}').replace(
        'layer { name: "fc"', 'layer { name: "ip1"').replace(
        '"fc" type', '"ip1" type') + f"""
    layer {{ name: "tap" type: "HDF5Output" bottom: "logits"
      hdf5_output_param {{ file_name: "{out}" }} }}""")
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "fixed"\n'
                      f'snapshot_prefix: "{tmp_path}/ck"\n')
    r = {}
    assert cli.main(["train", f"--solver={solver}", "--device=cpu",
                     "--tau=2", "--max_iter=4"], r) == 0
    assert r["hdf5_outputs"] == [out]
    with h5py.File(out, "r") as h:
        logits = h["logits"][()]
    assert logits.shape == (20, 2) and np.isfinite(logits).all()
    tap = [l for l in r["solver"].net.layers if l.TYPE == "HDF5Output"][0]
    assert np.array_equal(logits, tap.tapped["logits"].numpy())


# ----------------------------------------------------------------------
# the featurizer


TOY = """
name: "toy"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 10 dim: 3 dim: 32 dim: 32 } shape { dim: 10 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "ip" type: "InnerProduct" bottom: "conv" top: "logits"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""
FEAT_RTOL = 1e-5  # of the features' largest magnitude


def _close_features(got, want):
    assert np.abs(got - want).max() <= FEAT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("out", ["f.npz", "f.h5"])
def test_featurizer_matches_the_jax_featurizer(tmp_path, out):
    model = tmp_path / "toy.prototxt"
    model.write_text(TOY)
    cifar = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(cifar, num_train=50, num_test=40, seed=1)
    net = TorchNet(tconfig.parse_net_prototxt(TOY), "TEST")
    params, stats = net.init(5)
    weights = str(tmp_path / "w.caffemodel")
    caffemodel.save_weights(caffemodel.net_blobs(net, params, stats), weights)
    argv = [f"--model={model}", "--blob=logits", f"--data={cifar}",
            "--batches=3", f"--weights={weights}"]
    r = {}
    assert featurizer_app.main(argv + ["--device=cpu",
                                       f"--out={tmp_path / ('t' + out)}"], r) == 0
    assert jfeaturizer.main(argv + [f"--out={tmp_path / ('j' + out)}"]) == 0
    if out.endswith(".h5"):
        with h5py.File(tmp_path / ("t" + out), "r") as h:
            got = h["logits"][()]
        with h5py.File(tmp_path / ("j" + out), "r") as h:
            want = h["logits"][()]
    else:
        got = np.load(tmp_path / ("t" + out))["features"]
        want = np.load(tmp_path / ("j" + out))["features"]
    assert got.shape == want.shape == (3, 10, 10)
    assert np.array_equal(got, r["features"])
    _close_features(got, want)


def test_featurizer_reads_the_nets_own_source(tmp_path, window_file):
    """No --data: a WindowData net feeds the featurizer from its window
    file, the JAX featurizer's batches."""
    text = f"""
    name: "rcnn"
    layer {{ name: "data" type: "WindowData" top: "data" top: "label"
      transform_param {{ crop_size: 16 mean_value: 100 }}
      window_data_param {{ source: "{window_file}" batch_size: 4 }} }}
    layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "fc"
      inner_product_param {{ num_output: 3 weight_filler {{ type: "xavier" }} }} }}
    """
    model = tmp_path / "rcnn.prototxt"
    model.write_text(text)
    r = {}
    assert featurizer_app.main([f"--model={model}", "--blob=fc",
                                "--batches=2", "--device=cpu"], r) == 0
    jn = JaxNet(jconfig.parse_net_prototxt(text), phase="TEST")
    jp, js = jn.init(0)
    batches = jsource.resolve_batches(jn, jconfig.parse_net_prototxt(text),
                                      None, 2, phase="TEST")
    want = np.stack([np.asarray(jn.forward(jp, js, {k: v[i] for k, v in
                                                    batches.items()})["fc"])
                     for i in range(2)])
    _close_features(r["features"], want)


def test_featurizer_refuses_an_unknown_blob(tmp_path):
    model = tmp_path / "toy.prototxt"
    model.write_text(TOY)
    with pytest.raises(SystemExit, match="not in net"):
        featurizer_app.main([f"--model={model}", "--blob=nope",
                             "--allow_synthetic", "--batches=1",
                             "--device=cpu"])
    assert os.path.exists(model)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("mean,scale", [("image", 1.0), ("image", 0.5),
                                        ("channel", 1.0), (None, 0.25)])
def test_u8_output_finished_on_the_device_equals_the_float_reader(
        tmp_path, native, mean, scale):
    """``runtime.DataPipeline(u8_output=True)`` ships uint8 crop windows
    and their geometry; ``finish_host_crops`` on them gives the float
    reader's batches from the same seed, bit for bit."""
    from sparknet_tpu_torch import runtime

    rng = np.random.RandomState(3)
    path = str(tmp_path / "db.sndb")
    runtime.write_datum_db(path, rng.randint(0, 256, (12, 3, 10, 11)),
                           rng.randint(0, 5, 12))
    m = {"image": (rng.rand(3, 10, 11) * 255).astype(np.float32),
         "channel": np.asarray([90.0, 100.0, 110.0], np.float32),
         None: None}[mean]
    common = dict(batch_size=4, shape=(3, 10, 11), crop=7, mirror=True,
                  train=True, mean=m, scale=scale, seed=9, native=native)
    fl = runtime.DataPipeline(path, **common)
    u8 = runtime.DataPipeline(path, u8_output=True, **common)
    finish = ttransforms.finish_host_crops(m, scale)
    try:
        for _ in range(3):
            want, wy = fl.next()
            x, y, ho, wo, fp = u8.next()
            got = finish({"data": torch.from_numpy(x), "label": torch.from_numpy(y),
                          "h_off": torch.from_numpy(ho),
                          "w_off": torch.from_numpy(wo),
                          "flip": torch.from_numpy(fp)})
            assert np.array_equal(got["data"].numpy(), want)
            assert np.array_equal(got["label"].numpy(), wy)
    finally:
        fl.close()
        u8.close()
