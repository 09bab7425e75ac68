"""The port's inference commands against the JAX package's: ``cli
classify`` (plain, ``--oversample``, a derived deploy view, a legacy V1
net), ``tools/detector.py Detector`` and ``cli detect``, and
``tools/net_surgery.py fc_to_conv``; then ``cli device_query`` and the
refusals without a card.

The nets are CaffeNet-shaped (conv 11x11/4, pool, ACROSS_CHANNELS LRN,
grouped convs, three fc layers) and narrowed so that the JAX side
compiles in seconds; both packages read one ``.caffemodel`` written from
the JAX net's seeded weights, or both draw them from one seed (the
port's seed gives the JAX package's weights, ROADMAP C.6).  Scores agree
within 1e-5 of the largest |score|.  The small nets run on one torch
thread."""

import numpy as np
import pytest
import torch
from PIL import Image

import sparknet_tpu.tools.cli as jcli
import sparknet_tpu_torch.tools.cli as tcli
from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.io import caffemodel as jcaffemodel
from sparknet_tpu.net import JaxNet
from sparknet_tpu.tools.detector import Detector as JDetector
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.tools.detector import Detector as TDetector

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small nets under the parallel run's load
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        float(np.abs(got - want).max()), scale)


IMAGE = 99


def _trunk(image=IMAGE, batch=1):
    """CaffeNet's trunk at narrow widths (96/256/384 -> 8/16/24, fc 4096
    -> 32), pool before norm as in ``models/builders.py``."""
    return f"""
layer {{ name: "data" type: "Input" top: "data"
  input_param {{ shape {{ dim: {batch} dim: 3 dim: {image} dim: {image} }} }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param {{ num_output: 8 kernel_size: 11 stride: 4
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
layer {{ name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}
layer {{ name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
  convolution_param {{ num_output: 16 pad: 2 kernel_size: 5 group: 2
    weight_filler {{ type: "gaussian" std: 0.05 }}
    bias_filler {{ type: "constant" value: 0.1 }} }} }}
layer {{ name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }}
layer {{ name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
layer {{ name: "norm2" type: "LRN" bottom: "pool2" top: "norm2"
  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}
layer {{ name: "conv3" type: "Convolution" bottom: "norm2" top: "conv3"
  convolution_param {{ num_output: 24 pad: 1 kernel_size: 3
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3" }}
layer {{ name: "conv4" type: "Convolution" bottom: "conv3" top: "conv4"
  convolution_param {{ num_output: 24 pad: 1 kernel_size: 3 group: 2
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "relu4" type: "ReLU" bottom: "conv4" top: "conv4" }}
layer {{ name: "conv5" type: "Convolution" bottom: "conv4" top: "conv5"
  convolution_param {{ num_output: 16 pad: 1 kernel_size: 3 group: 2
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "relu5" type: "ReLU" bottom: "conv5" top: "conv5" }}
layer {{ name: "pool5" type: "Pooling" bottom: "conv5" top: "pool5"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
layer {{ name: "fc6" type: "InnerProduct" bottom: "pool5" top: "fc6"
  inner_product_param {{ num_output: 32
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }}
layer {{ name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  inner_product_param {{ num_output: 32
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "relu7" type: "ReLU" bottom: "fc7" top: "fc7" }}
layer {{ name: "fc8" type: "InnerProduct" bottom: "fc7" top: "fc8"
  inner_product_param {{ num_output: 10
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
"""


DEPLOY = 'name: "narrow_caffenet"\n' + _trunk() + """
layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }
"""

# the same net as a train/test config: classify derives its deploy view
TRAIN_TEST = 'name: "narrow_caffenet"\n' + _trunk().replace(
    """layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 1 dim: 3 dim: 99 dim: 99 } } }""",
    """layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 4 dim: 3 dim: 99 dim: 99 }
                    shape { dim: 4 } } }""") + """
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" bottom: "label"
  top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "fc8" bottom: "label"
  top: "accuracy" include { phase: TEST } }
"""

_V1_TYPES = {"Input": None, "Convolution": "CONVOLUTION", "ReLU": "RELU",
             "Pooling": "POOLING", "LRN": "LRN",
             "InnerProduct": "INNER_PRODUCT", "Softmax": "SOFTMAX"}


def _v1_text(deploy_text: str) -> str:
    """The deploy net as a V1 prototxt: ``layers`` entries with enum type
    names and ``blobs_lr``/``weight_decay``, the input as net-level
    ``input``/``input_dim``."""
    netp = tconfig.parse_net_prototxt(deploy_text)
    (inp,) = [l for l in netp.layer if l.type == "Input"]
    lines = [f'name: "{netp.name}"', 'input: "data"'] + [
        f"input_dim: {d}" for d in inp.input_param.shape[0].dim]
    for lp in netp.layer:
        if lp.type == "Input":
            continue
        v1 = lp.copy()
        body = tconfig.dumps(v1).replace(f'type: "{lp.type}"',
                                         f"type: {_V1_TYPES[lp.type]}")
        if lp.type in ("Convolution", "InnerProduct"):
            body += ("blobs_lr: 1\nblobs_lr: 2\n"
                     "weight_decay: 1\nweight_decay: 0\n")
        lines.append("layers {\n" + body + "}")
    return "\n".join(lines) + "\n"


def _weights(tmp_path, text=DEPLOY) -> str:
    """A .caffemodel of the JAX net's seeded weights."""
    net = JaxNet(jconfig.parse_net_prototxt(text), phase="TEST")
    params, stats = net.init(0)
    path = str(tmp_path / "w.caffemodel")
    jcaffemodel.save_weights(jcaffemodel.net_blobs(net, params, stats), path)
    return path


def _images(tmp_path, n=3, side=120):
    rng = np.random.RandomState(5)
    paths = []
    for i in range(n):
        p = tmp_path / f"im{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (side, side + 7 * i, 3),
                                    np.uint8)).save(p, quality=95)
        paths.append(str(p))
    return paths


def _mean(tmp_path, side=112) -> str:
    path = str(tmp_path / "mean.binaryproto")
    m = np.random.RandomState(9).uniform(90, 140, (3, side, side))
    jcaffemodel.save_mean_image(m.astype(np.float32), path)
    return path


class _ScoreSpy:
    """Stands in for ``numpy`` inside the JAX ``cli`` module and keeps
    every vector ``classify`` ranks (its final scores), which the JAX
    command only prints to four decimals."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argsort(self, a, *args, **kw):
        self.seen.append(np.array(a))
        return np.argsort(a, *args, **kw)


def _jax_classify(monkeypatch, argv):
    spy = _ScoreSpy()
    with monkeypatch.context() as m:
        m.setattr(jcli, "np", spy)
        assert jcli.main(["classify"] + argv) == 0
    return spy.seen


@pytest.mark.parametrize("mode", ["plain", "oversample", "derived", "v1"])
def test_classify_gives_the_jax_scores(tmp_path, monkeypatch, mode):
    text = TRAIN_TEST if mode == "derived" else DEPLOY
    model = tmp_path / "net.prototxt"
    model.write_text(_v1_text(DEPLOY) if mode == "v1" else text)
    imgs = _images(tmp_path)
    argv = ["--model", str(model), "--weights", _weights(tmp_path),
            "--mean", _mean(tmp_path)] + imgs
    if mode == "oversample":
        argv.append("--oversample")
    want = _jax_classify(monkeypatch, argv)
    res = {}
    assert tcli.main(["classify", "--device", "cpu"] + argv,
                     result=res) == 0
    assert len(res["scores"]) == len(want) == len(imgs)
    for got, ref in zip(res["scores"], want):
        assert got.shape == (10,)
        _close(got, ref)
        assert int(np.argmax(got)) == int(np.argmax(ref))
    lrn = [l.name for l in res["net"].net_param.layer if l.type == "LRN"]
    assert lrn == ["norm1", "norm2"]
    assert all(l.lrn_param.norm_region == "ACROSS_CHANNELS"
               for l in res["net"].net_param.layer if l.type == "LRN")


def test_classify_channel_means_and_refusals(tmp_path, monkeypatch):
    model = tmp_path / "net.prototxt"
    model.write_text(DEPLOY)
    imgs = _images(tmp_path, n=1)
    argv = ["--model", str(model), "--mean", "104,117,123", "--topk", "3",
            imgs[0]]
    want = _jax_classify(monkeypatch, argv)
    res = {}
    assert tcli.main(["classify", "--device", "cpu"] + argv,
                     result=res) == 0
    # no --weights: the port's seed gives the JAX package's weights
    _close(res["scores"][0], want[0])
    small = _mean(tmp_path, side=64)
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        assert cli.main(["classify", "--model", str(model), "--mean", small,
                         imgs[0]] + extra) == 1
        assert cli.main(["classify", "--model", str(model), "--oversample",
                         "--resize", "50", imgs[0]] + extra) == 1


# --- the Detector on the JAX tests' fixtures ------------------------------

TINY = """
name: "tiny_det"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } } }
layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  inner_product_param { num_output: 3 } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


def _red_blue_image():
    im = np.zeros((16, 16, 3), np.uint8)
    im[:, :8, 0] = 200
    im[:, 8:, 2] = 200
    return im


def _channel_picker(det):
    w = np.zeros((3, 3 * 8 * 8), np.float32)
    for cls in range(3):
        w[cls, cls * 64:(cls + 1) * 64] = 0.01
    b = np.zeros(3, np.float32)
    if isinstance(det, TDetector):
        det.params["fc"] = [torch.from_numpy(w), torch.from_numpy(b)]
    else:
        det.params["fc"] = [w, b]


def _both_detectors(text, picker=True, **kw):
    out = []
    for cls, cfg in ((JDetector, jconfig), (TDetector, tconfig)):
        extra = {"device": "cpu"} if cls is TDetector else {}
        det = cls(cfg.parse_net_prototxt(text), **kw, **extra)
        if picker:
            _channel_picker(det)
        out.append(det)
    return out


def _same_detections(jd, td, jobs):
    want, got = jd.detect_windows(jobs), td.detect_windows(jobs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["filename"] == w["filename"]
        np.testing.assert_array_equal(g["window"], w["window"])
        _close(g["prediction"], w["prediction"])
    return got


def test_detect_windows_scores_by_content():
    jd, td = _both_detectors(TINY, batch=4)
    red, blue = (0, 0, 16, 8), (0, 8, 16, 16)
    got = _same_detections(jd, td, [(_red_blue_image(), [red, blue])])
    assert got[0]["filename"] is None and tuple(got[0]["window"]) == red
    assert [int(np.argmax(d["prediction"])) for d in got] == [0, 2]
    for d in got:
        np.testing.assert_allclose(d["prediction"].sum(), 1.0, rtol=1e-4)


def test_detect_windows_batching_and_files(tmp_path):
    jd, td = _both_detectors(TINY, batch=4)
    p = tmp_path / "im.png"
    Image.fromarray(_red_blue_image()).save(p)
    wins = [(0, 0, 16, 8), (0, 8, 16, 16)] * 3  # across a batch boundary
    got = _same_detections(jd, td, [(str(p), wins)])
    assert [int(np.argmax(d["prediction"])) for d in got] == [0, 2] * 3
    assert got[0]["filename"] == str(p)


def test_detect_float_images_and_refusals():
    jd, td = _both_detectors(TINY, batch=2)
    im = _red_blue_image().astype(np.float32) / 255.0
    _same_detections(jd, td, [(im, [(0, 0, 16, 8)])])
    with pytest.raises(TypeError, match="uint8 images"):
        td.detect_windows([(im * 4.0, [(0, 0, 16, 8)])])
    with pytest.raises(ValueError, match="smaller than the net input"):
        TDetector(tconfig.parse_net_prototxt(TINY),
                  mean=np.zeros((3, 4, 4), np.float32), device="cpu")


@pytest.mark.parametrize("crop_mode", ["warp", "square"])
def test_detector_context_pad(crop_mode):
    jd, td = _both_detectors(TINY, context_pad=2, crop_mode=crop_mode,
                             batch=2)
    got = _same_detections(jd, td, [(_red_blue_image(),
                                     [(2, 2, 10, 7), (0, 0, 6, 6)])])
    assert all(np.isfinite(d["prediction"]).all() for d in got)


def test_detector_context_pad_mean_keeps_padding_zero():
    mean = np.full(3, 100.0, np.float32)
    jd, td = _both_detectors(TINY, picker=False, mean=mean, context_pad=2,
                             batch=1)
    im = _red_blue_image()
    out, content = td.crop(im, (0, 0, 6, 6))
    jout, jcontent = jd.crop(im, (0, 0, 6, 6))
    np.testing.assert_array_equal(out, jout)
    assert content == jcontent
    pad_h, pad_w, (wh, ww) = content
    assert pad_h > 0 and pad_w > 0
    chw = td._preprocess(out, content)
    np.testing.assert_array_equal(chw, jd._preprocess(jout, jcontent))
    assert np.all(chw[:, :pad_h, :] == 0.0)
    assert np.all(chw[:, :, :pad_w] == 0.0)
    assert np.any(chw[:, pad_h:pad_h + wh, pad_w:pad_w + ww] != 0.0)


def test_detector_derives_deploy_view():
    """A train/test config (HostData + loss) reduces via deploy_variant;
    the port's seed gives the JAX LeNet's weights."""
    jd = JDetector(jmodels.load_model("lenet"), batch=2)
    td = TDetector(tmodels.load_model("lenet"), batch=2, device="cpu")
    assert list(td.net.feed_blobs) == ["data"]
    im = np.random.RandomState(0).randint(0, 255, (40, 40, 1), np.uint8)
    got = _same_detections(jd, td, [(im, [(0, 0, 28, 28), (5, 5, 33, 33)])])
    for d in got:
        assert d["prediction"].shape == (10,)
        np.testing.assert_allclose(d["prediction"].sum(), 1.0, rtol=1e-4)


def test_detect_cli_scores_the_window_file(tmp_path, capsys):
    """``cli detect`` on a CaffeNet-shaped deploy net (context pad 16, a
    mean image, batches of 4 over 6 windows) gives the JAX Detector's
    score for every window, in window-file order."""
    imgs = _images(tmp_path, n=2)
    rows = []
    for k, path in enumerate(imgs):
        rows.append(f"# {k}\n{path}\n3\n120\n{120 + 7 * k}\n3\n"
                    "1 0.9 0 0 60 70\n2 0.8 30 20 110 100\n"
                    "0 0.1 5 5 20 20\n")
    wf = tmp_path / "windows.txt"
    wf.write_text("".join(rows))
    model = tmp_path / "deploy.prototxt"
    model.write_text(DEPLOY)
    weights, mean = _weights(tmp_path), _mean(tmp_path)
    res = {}
    assert tcli.main(["detect", "--model", str(model), "--weights", weights,
                      "--window_file", str(wf), "--mean", mean,
                      "--context_pad", "16", "--batch", "4",
                      "--device", "cpu"], result=res) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(res["scores"]) == 6
    jd = JDetector(jconfig.parse_net_prototxt(DEPLOY), weights=weights,
                   mean=jcli._load_mean_arg(mean), context_pad=16, batch=4)
    jobs = [(p, [(0, 0, 71, 61), (20, 30, 101, 111), (5, 5, 21, 21)])
            for p in imgs]
    want = jd.detect_windows(jobs)
    for line, got, w in zip(lines, res["scores"], want):
        _close(got, w["prediction"])
        name, x1, y1, x2, y2, top, _ = line.split()
        assert name == w["filename"] and int(top) == int(
            np.argmax(w["prediction"]))
        ymin, xmin, ymax, xmax = [int(v) for v in w["window"]]
        assert (int(x1), int(y1), int(x2), int(y2)) == (
            xmin, ymin, xmax - 1, ymax - 1)


# --- net surgery ----------------------------------------------------------

def test_fc_to_conv_on_rcnn_at_image_99():
    """``examples/net_surgery.ipynb``: rcnn_ilsvrc13's fc layers cast to
    convolutions (the JAX test's net), the converted params bit-equal to
    the JAX conversion's, the scores within tolerance at 99 and as a
    dense map at 131."""
    from sparknet_tpu.tools.net_surgery import fc_to_conv as jfc
    from sparknet_tpu_torch.tools.net_surgery import fc_to_conv as tfc

    jnetp = jmodels.load_model("rcnn_ilsvrc13", batch=1, image=99,
                               classes=11)
    tnetp = tmodels.load_model("rcnn_ilsvrc13", batch=1, image=99,
                               classes=11)
    jnet, tnet = JaxNet(jnetp, phase="TEST"), TorchNet(tnetp, phase="TEST")
    # the port's seed draws the JAX package's weights (ROADMAP C.6);
    # the JAX side takes host copies of them
    params, stats = tnet.init(0)
    jparams = {k: [t.numpy().copy() for t in v] for k, v in params.items()}
    jstats = {k: [t.numpy().copy() for t in v] for k, v in stats.items()}
    assert interop.net_params_from_jax(jparams, tnet, jstats)[0].keys() \
        == params.keys()
    assert tnet.blob_shapes["pool5"] == (1, 256, 2, 2)

    rename = {"fc6": "fc6-conv", "fc7": "fc7-conv",
              "fc-rcnn": "fc-rcnn-conv"}
    jcn, jcp = jfc(jnetp, jnet.blob_shapes, jparams, list(rename),
                   rename=rename)
    tcn, tcp = tfc(tnetp, tnet.blob_shapes, params, list(rename),
                   rename=rename)
    assert tconfig.dumps(tcn) == jconfig.dumps(jcn)
    assert sorted(tcp) == sorted(jcp)
    for name in jcp:
        for t, j in zip(tcp[name], jcp[name]):
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the converted weight is its source reshaped
    assert tcp["fc6-conv"][0].data_ptr() == params["fc6"][0].data_ptr()

    x = np.random.RandomState(0).randn(1, 3, 99, 99).astype(np.float32)
    jconv = JaxNet(jcn, phase="TEST")
    tconv = TorchNet(tcn, phase="TEST")
    with torch.inference_mode():
        ref = tnet.forward(params, stats, {"data": torch.from_numpy(x)})[
            "fc-rcnn"].numpy()
        out = tconv.forward(tcp, stats, {"data": torch.from_numpy(x)})[
            "fc-rcnn-conv"].numpy()
    jout = np.asarray(jconv.forward(jcp, jstats, {"data": x})["fc-rcnn-conv"])
    assert out.shape == (1, 11, 1, 1)
    _close(out, jout)
    np.testing.assert_allclose(out[:, :, 0, 0], ref, atol=1e-4, rtol=1e-4)

    big = [(1, 3, 131, 131)]
    jbig = JaxNet(jconfig.replace_data_layers(jcn, big, big), phase="TEST")
    tbig = TorchNet(tconfig.replace_data_layers(tcn, big, big), phase="TEST")
    xb = np.random.RandomState(1).randn(1, 3, 131, 131).astype(np.float32)
    with torch.inference_mode():
        dense = tbig.forward(tcp, stats, {"data": torch.from_numpy(xb)})[
            "fc-rcnn-conv"].numpy()
    jdense = np.asarray(jbig.forward(jcp, jstats, {"data": xb})[
        "fc-rcnn-conv"])
    assert dense.shape[:2] == (1, 11) and dense.shape[2] > 1
    assert np.isfinite(dense).all()
    _close(dense, jdense)


def test_fc_to_conv_rejects_bad_targets():
    from sparknet_tpu_torch.tools.net_surgery import fc_to_conv

    netp = tmodels.load_model("rcnn_ilsvrc13", batch=1, image=67)
    net = TorchNet(netp, phase="TEST")
    params, _ = net.init(0)
    with pytest.raises(KeyError):
        fc_to_conv(netp, net.blob_shapes, params, ["nope"])
    with pytest.raises(ValueError, match="not InnerProduct"):
        fc_to_conv(netp, net.blob_shapes, params, ["conv1"])


# --- device_query and the card default ------------------------------------

def test_device_query_on_the_cpu(capsys):
    res = {}
    assert tcli.main(["device_query", "--device", "cpu"], result=res) == 0
    assert res["lines"] == ["device 0: platform=cpu kind=cpu process=0"]
    assert capsys.readouterr().out == res["lines"][0] + "\n"


def test_inference_commands_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = tmp_path / "deploy.prototxt"
    model.write_text(TINY)
    for argv in (["device_query"],
                 ["classify", "--model", str(model), "/nonexistent.jpg"],
                 ["detect", "--model", str(model), "--window_file",
                  "/nonexistent.txt"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDetector(tconfig.parse_net_prototxt(TINY))
