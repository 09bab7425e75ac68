"""The port's ``io/`` wire codec, ``.caffemodel`` weights and HDF5 files
against the JAX package's, on the CPU.

The port's writer must give the JAX writer's bytes for the same blobs,
and each reader must read what the other wrote: varints (negative and
packed too), blobs (``double_data``, legacy num/channels/height/width,
a shape without data), modern / V1 / V0 weight files, the net glue
(``net_blobs`` / ``apply_blobs`` with legacy 4-D right-alignment), HDF5
weights and solver state, and a JAX-written LM ``.caffemodel`` served by
the port's ``GenerationEngine``.  Also: every JAX layer type is either
registered in the port or listed as not yet ported (5 left: Attention
and the file-backed data layers), and ResNet-50's weights with its
BatchNorm stats in both packages' bytes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu.io import caffemodel as jcm
from sparknet_tpu.io import wire as jwire
from sparknet_tpu.net import JaxNet
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch.interop import net_params_from_jax
from sparknet_tpu_torch.io import caffemodel as tcm
from sparknet_tpu_torch.io import wire as twire
from sparknet_tpu_torch.net import TorchNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NET = """
name: "io_net"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 4 dim: 3 dim: 6 dim: 6 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "x" top: "c"
  convolution_param { num_output: 5 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "c" top: "logits"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""


def _rand_blobs(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "conv1": [rng.randn(8, 3, 5, 5).astype(np.float32),
                  rng.randn(8).astype(np.float32)],
        "fc": [rng.randn(10, 128).astype(np.float32)],
        "scalarish": [rng.randn(1).astype(np.float32),
                      np.zeros((0,), np.float32)],
    }


# ---------------------------------------------------------------------------
# wire


@pytest.mark.parametrize("v", [0, 1, 127, 128, 300, 2**32, 2**63 - 1, -1, -300,
                               -(2**63)])
def test_varint_bytes_equal_jax_and_round_trip(v):
    enc = twire.encode_varint(v)
    assert enc == jwire.encode_varint(v)
    dec, pos = twire.decode_varint(memoryview(enc), 0)
    assert pos == len(enc)
    assert dec == (v if v >= 0 else v + (1 << 64))  # two's complement on 64 bits


def test_packed_varints_and_floats_match_jax():
    vals = [0, 1, 300, 2**40, 7]
    assert twire.field_packed_varints(1, vals) == jwire.field_packed_varints(1, vals)
    body = twire.collect_fields(twire.field_packed_varints(3, vals))[3][0]
    assert twire.packed_varints(body) == vals
    assert twire.packed_varints(5) == [5]  # an unpacked repeated entry
    x = np.random.RandomState(0).randn(17).astype(np.float32)
    assert twire.field_packed_floats(5, x) == jwire.field_packed_floats(5, x)
    got = twire.packed_floats(twire.collect_fields(twire.field_packed_floats(5, x))[5][0])
    assert np.array_equal(got, x)
    msg = (twire.field_string(1, "név") + twire.field_float(2, 1.5)
           + twire.field_varint(3, -2))
    assert msg == (jwire.field_string(1, "név") + jwire.field_float(2, 1.5)
                   + jwire.field_varint(3, -2))
    assert twire.collect_fields(msg) == {
        k: [bytes(v) if isinstance(v, memoryview) else v for v in vs]
        for k, vs in jwire.collect_fields(msg).items()}


def test_truncated_and_unsupported_fields_raise():
    good = twire.field_bytes(1, b"abcdef")
    with pytest.raises(ValueError, match="truncated"):
        twire.collect_fields(good[:-2])
    with pytest.raises(ValueError, match="wire type"):
        twire.collect_fields(twire.tag(1, 3))


# ---------------------------------------------------------------------------
# blobs


@pytest.mark.parametrize("shape", [(4, 3, 2), (7,), (1, 1, 1, 5), (0,), ()])
def test_blob_bytes_equal_jax_and_round_trip(shape):
    arr = np.asarray(np.random.RandomState(1).randn(*shape), np.float32)
    enc = tcm.encode_blob(arr)
    assert enc == jcm.encode_blob(arr)
    for dec in (tcm.decode_blob(enc), jcm.decode_blob(enc)):
        assert dec.dtype == np.float32 and dec.shape == arr.shape
        assert np.array_equal(dec, arr)


def _legacy_blob(dims, values, field=5, unpacked=False):
    msg = b"".join(jwire.field_varint(i + 1, d) for i, d in enumerate(dims))
    if unpacked:
        return msg + b"".join(jwire.field_float(field, float(v)) for v in values)
    if field == 8:
        return msg + jwire.field_bytes(8, np.asarray(values, "<f8").tobytes())
    return msg + jwire.field_packed_floats(field, np.asarray(values, np.float32))


@pytest.mark.parametrize("case", ["legacy4d", "double_data", "unpacked",
                                  "flat_fallback"])
def test_decode_blob_matches_jax(case):
    vals = np.arange(24, dtype=np.float64) / 7.0
    data = {
        "legacy4d": _legacy_blob((1, 2, 3, 4), vals),
        "double_data": _legacy_blob((2, 3, 4, 1), vals, field=8),
        "unpacked": _legacy_blob((1, 1, 2, 3), vals[:6], unpacked=True),
        # legacy dims that do not multiply to the data: a flat blob
        "flat_fallback": _legacy_blob((5, 5, 1, 1), vals),
    }[case]
    got, want = tcm.decode_blob(data), jcm.decode_blob(data)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_shape_without_data_raises_like_jax():
    data = jwire.field_bytes(7, jwire.field_packed_varints(1, (2, 3)))
    for mod in (tcm, jcm):
        with pytest.raises(ValueError, match="no data values"):
            mod.decode_blob(data)


# ---------------------------------------------------------------------------
# weight files


def test_caffemodel_bytes_equal_jax_writer(tmp_path):
    blobs = _rand_blobs()
    tp, jp = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tcm.save_weights(blobs, tp, net_name="io_net")
    jcm.save_weights(blobs, jp, net_name="io_net")
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for path in (tp, jp):
        loaded = tcm.load_weights(path)
        # a layer whose blobs are all empty still lists them
        assert list(loaded) == list(blobs)
        for k in blobs:
            for x, y in zip(loaded[k], blobs[k]):
                assert np.array_equal(x, y)


def _v1_file(path, legacy_v0: bool):
    """A V1 NetParameter (layers=2, V1LayerParameter name=4 blobs=6), or
    with ``legacy_v0`` the V0 nesting (V1.layer=1 -> V0 name=1 blobs=50)."""
    rng = np.random.RandomState(3)
    w = rng.randn(1, 1, 3, 8).astype(np.float32)
    b = rng.randn(1, 1, 1, 3).astype(np.float32)
    blobs = [_legacy_blob(x.shape, x.reshape(-1)) for x in (w, b)]
    if legacy_v0:
        v0 = jwire.field_string(1, "fc") + b"".join(
            jwire.field_bytes(50, x) for x in blobs)
        layer = jwire.field_bytes(1, v0)
    else:
        layer = jwire.field_string(4, "fc") + b"".join(
            jwire.field_bytes(6, x) for x in blobs)
    with open(path, "wb") as f:
        f.write(jwire.field_string(1, "old") + jwire.field_bytes(2, layer))
    return w, b


@pytest.mark.parametrize("legacy_v0", [False, True], ids=["V1", "V0"])
def test_v1_and_v0_weight_files_load_like_jax(tmp_path, legacy_v0):
    path = str(tmp_path / "old.caffemodel")
    w, b = _v1_file(path, legacy_v0)
    got, want = tcm.load_weights(path), jcm.load_weights(path)
    assert list(got) == list(want) == ["fc"]
    for x, y, z in zip(got["fc"], want["fc"], (w, b)):
        assert np.array_equal(x, y) and np.array_equal(x, z)


def _nets():
    jnet = JaxNet(jconfig.parse_net_prototxt(NET), phase="TRAIN")
    jp, js = jnet.init(0)
    tnet = TorchNet(tconfig.parse_net_prototxt(NET), phase="TRAIN")
    tp, ts = net_params_from_jax(
        {k: [np.asarray(b) for b in v] for k, v in jp.items()}, tnet,
        {k: [np.asarray(b) for b in v] for k, v in js.items()})
    return jnet, jp, js, tnet, tp, ts


def test_net_blobs_and_weight_file_equal_jax(tmp_path):
    jnet, jp, js, tnet, tp, ts = _nets()
    got, want = tcm.net_blobs(tnet, tp, ts), jcm.net_blobs(jnet, jp, js)
    assert list(got) == list(want) == ["conv1", "ip1"]
    for k in want:
        for x, y in zip(got[k], want[k]):
            assert x.dtype == np.float32 and np.array_equal(x, np.asarray(y))
    a, b = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tcm.save_weights(got, a, net_name=tnet.name)
    jcm.save_weights(want, b, net_name=jnet.name)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_resnet50_caffemodel_with_bn_stats_round_trips_both_ways(tmp_path):
    """ResNet-50's weights file — 161 learnable blobs and the 159
    BatchNorm stat blobs, in layer order — written by each package is
    the other's bytes, and each package reads the other's file back to
    the same params and stats."""
    from sparknet_tpu_torch import models as tmodels
    from sparknet_tpu import models as jmodels

    kw = dict(batch=1, image=64, classes=10)
    tnet = TorchNet(tmodels.load_model("resnet50", **kw), phase="TRAIN")
    jnet = JaxNet(jmodels.load_model("resnet50", **kw), phase="TRAIN")
    tp, ts = tnet.init(0)
    rs = np.random.RandomState(6)
    ts = {k: [torch.from_numpy(rs.rand(*t.shape).astype(np.float32))
              for t in v] for k, v in ts.items()}
    host = {c: {k: [t.numpy() for t in v] for k, v in d.items()}
            for c, d in (("params", tp), ("stats", ts))}
    blobs = tcm.net_blobs(tnet, tp, ts)
    want = jcm.net_blobs(jnet, host["params"], host["stats"])
    assert list(blobs) == list(want)
    assert sum(len(v) for v in blobs.values()) == 161 + 159
    a, b = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tcm.save_weights(blobs, a, net_name=tnet.name)
    jcm.save_weights(want, b, net_name=jnet.name)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    zp = {k: [torch.zeros_like(t) for t in v] for k, v in tp.items()}
    zs = {k: [torch.zeros_like(t) for t in v] for k, v in ts.items()}
    params, stats = tcm.apply_blobs(tnet, zp, zs, tcm.load_weights(b),
                                    strict=True)
    for got, src in ((params, tp), (stats, ts)):
        for k in src:
            for x, y in zip(got[k], src[k]):
                assert torch.equal(x, y)
    jp, js = jcm.apply_blobs(jnet, {k: [np.zeros_like(x) for x in v]
                                    for k, v in host["params"].items()},
                             {k: [np.zeros_like(x) for x in v]
                              for k, v in host["stats"].items()},
                             jcm.load_weights(a))
    for got, src in ((jp, host["params"]), (js, host["stats"])):
        for k in src:
            for x, y in zip(got[k], src[k]):
                assert np.array_equal(np.asarray(x), y)


def test_apply_blobs_legacy_right_align_and_errors():
    _, _, _, tnet, tp, ts = _nets()
    rng = np.random.RandomState(5)
    w = rng.randn(1, 1, 3, 80).astype(np.float32)  # ip1 weight (3, 80) as 4-D
    b = rng.randn(1, 1, 1, 3).astype(np.float32)
    params, _ = tcm.apply_blobs(tnet, tp, ts, {"ip1": [w, b], "nope": [w]})
    assert isinstance(params["ip1"][0], torch.Tensor)
    assert np.array_equal(params["ip1"][0].numpy(), w.reshape(3, 80))
    assert np.array_equal(params["ip1"][1].numpy(), b.reshape(3))
    # untouched layers keep their tensors; the input dicts are not modified
    assert params["conv1"][0] is tp["conv1"][0]
    assert not np.array_equal(tp["ip1"][1].numpy(), b.reshape(3))
    with pytest.raises(ValueError, match="blob shape"):
        tcm.apply_blobs(tnet, tp, ts, {"ip1": [w.reshape(80, 3), b]})
    with pytest.raises(ValueError, match="file has 1 blobs, net expects 2"):
        tcm.apply_blobs(tnet, tp, ts, {"ip1": [w]})
    with pytest.raises(ValueError, match="no layers matched"):
        tcm.apply_blobs(tnet, tp, ts, {"nope": [w]}, strict=True)


# ---------------------------------------------------------------------------
# HDF5


def test_hdf5_weights_and_state_interchange_with_jax(tmp_path):
    pytest.importorskip("h5py")
    from sparknet_tpu.io import hdf5 as jh5
    from sparknet_tpu_torch.io import hdf5 as th5

    blobs = {k: v for k, v in _rand_blobs(2).items() if k != "scalarish"}
    leaves = [np.random.RandomState(i).randn(3, i + 1).astype(np.float32)
              for i in range(3)]
    for w_mod, r_mod in ((th5, jh5), (jh5, th5), (th5, th5)):
        wp, sp = str(tmp_path / "w.caffemodel.h5"), str(tmp_path / "s.solverstate.h5")
        w_mod.save_weights_hdf5(blobs, wp)
        w_mod.save_state_hdf5(sp, 17, leaves)
        got = r_mod.load_weights_hdf5(wp)
        assert sorted(got) == sorted(blobs)
        for k in blobs:
            for x, y in zip(got[k], blobs[k]):
                assert np.array_equal(x, y)
        it, step, hl = r_mod.load_state_hdf5(sp)
        assert (it, step) == (17, 0)
        for x, y in zip(hl, leaves):
            assert np.array_equal(x, y)
    with pytest.raises(IOError, match="no /data"):
        th5.load_weights_hdf5(sp)


def test_checkpoint_imports_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import sparknet_tpu_torch.io.checkpoint as c\n"
            "import sparknet_tpu_torch.io.hdf5\n"
            "try:\n"
            "    sparknet_tpu_torch.io.hdf5.load_weights_hdf5('x.h5')\n"
            "except ImportError:\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


# ---------------------------------------------------------------------------
# every JAX layer type is registered in the port or refused by name


def test_every_jax_layer_type_is_ported_or_listed():
    import sparknet_tpu.ops  # noqa: F401 — fills the JAX registry
    from sparknet_tpu.ops.base import LAYER_REGISTRY as jax_types
    from sparknet_tpu_torch.ops.base import _NOT_YET_PORTED
    from sparknet_tpu_torch.ops.base import LAYER_REGISTRY as port_types

    assert set(jax_types) - set(port_types) - set(_NOT_YET_PORTED) == set()
    assert not set(port_types) & set(_NOT_YET_PORTED)
    assert set(_NOT_YET_PORTED) == {"Attention"}
    assert {"HDF5Data", "HDF5Output", "ImageData", "WindowData"} <= set(
        port_types)
    assert {"BatchReindex", "Filter"} <= set(port_types)


@pytest.mark.parametrize("type_,exc,match", [
    ("Attention", NotImplementedError, "not yet ported"),
    ("NoSuchLayer", ValueError, "unknown layer type"),
])
def test_create_layer_refuses_unported_and_unknown(type_, exc, match):
    head = ('layer { name: "in" type: "HostData" top: "x" '
            'java_data_param { shape { dim: 2 dim: 3 } } } ')
    text = head + f'layer {{ name: "l" type: "{type_}" bottom: "x" top: "y" }}'
    with pytest.raises(exc, match=match):
        TorchNet(tconfig.parse_net_prototxt(text))


# ---------------------------------------------------------------------------
# a JAX-written LM .caffemodel, served by the port's engine

LM_GEOM = dict(dim=32, depth=2, heads=2, seq_len=32, vocab=64)
LM_SERVE = dict(prefill_buckets=(8, 32), max_streams=2, kv_blocks=24,
                kv_block_size=4)
# float32 through two layers on both sides, summed in another order
LM_ATOL = 1e-5


def test_jax_written_lm_caffemodel_serves_like_jax(tmp_path):
    import jax

    from sparknet_tpu.models.transformer_lm import TransformerLM as JaxLM
    from sparknet_tpu.serve import GenerationEngine as JaxEngine
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.serve import GenerationEngine

    jlm = JaxLM(**LM_GEOM)
    params, stats = jlm.init(7)  # not the engines' seed-0 init
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * 1.5, params)
    path = str(tmp_path / "lm.caffemodel")
    jcm.save_weights(jcm.net_blobs(jlm, params, stats), path, net_name=jlm.name)

    jeng = JaxEngine(jlm, weights=path, seed=0, **LM_SERVE)
    teng = GenerationEngine(TransformerLM(**LM_GEOM), weights=path,
                            device="cpu", **LM_SERVE)
    seeded = GenerationEngine(TransformerLM(**LM_GEOM), device="cpu",
                              **LM_SERVE)
    prompt, toks = [3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8]
    np.testing.assert_allclose(teng.score_tokens(prompt, toks),
                               jeng.score_tokens(prompt, toks), atol=LM_ATOL)

    def stream(eng, n=12):
        slot, tok, lp = eng.admit(prompt, n)
        out, lps = [tok], [lp]
        while len(out) < n:
            t, l = eng.step()[slot]
            out.append(t)
            lps.append(l)
        eng.finish(slot)
        return out, lps

    (tt, tl), (jt, jl) = stream(teng), stream(jeng)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, atol=LM_ATOL)
    assert stream(seeded)[0] != tt  # the file's weights, not the seed's
