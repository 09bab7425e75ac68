"""The port's binary proto codec and legacy upgrades against the JAX
package's (``io/protobin.py``, ``io/proto_fields.py``, the V0/V1 legs of
``config/prototext.py`` and the three ``upgrade_*`` commands).

Every case of ``tests/test_protobin.py`` and the upgrade cases of
``tests/test_parity_tails.py`` run here through both packages on the same
bytes or text: each case keeps the JAX test's own checks on the port's
result, and the port's result prints (``dumps``) the JAX result's text —
so every upgraded layer, multiplier and weight blob is equal, a float's
``repr`` being exact.  Files the commands write are compared byte for
byte."""

import struct
import types

import numpy as np
import pytest

import sparknet_tpu.config as jconfig
import sparknet_tpu.models as jmodels
import sparknet_tpu.tools.cli as jcli
import sparknet_tpu_torch.config as tconfig
import sparknet_tpu_torch.models as tmodels
import sparknet_tpu_torch.tools.cli as tcli
from sparknet_tpu.config import prototext as jprototext
from sparknet_tpu.config import schema as jschema
from sparknet_tpu.io import caffemodel as jcaffemodel
from sparknet_tpu.io import protobin as jprotobin
from sparknet_tpu.io import wire
from sparknet_tpu_torch.config import prototext as tprototext
from sparknet_tpu_torch.config import schema as tschema
from sparknet_tpu_torch.io import caffemodel as tcaffemodel
from sparknet_tpu_torch.io import protobin as tprotobin

J = types.SimpleNamespace(config=jconfig, models=jmodels, cli=jcli,
                          prototext=jprototext, schema=jschema,
                          protobin=jprotobin, caffemodel=jcaffemodel)
T = types.SimpleNamespace(config=tconfig, models=tmodels, cli=tcli,
                          prototext=tprototext, schema=tschema,
                          protobin=tprotobin, caffemodel=tcaffemodel)


def _both(case, tmp_path):
    """Run ``case(P, dir)`` for the JAX package and the port, each in a
    directory of its own; returns (jax result, port result)."""
    out = []
    for name, pkg in (("jax", J), ("port", T)):
        d = tmp_path / name
        d.mkdir()
        out.append(case(pkg, d))
    return out


def _text(P, msg) -> str:
    return P.prototext.dumps(msg)


def _same_text(case, tmp_path):
    j, t = _both(case, tmp_path)
    assert _text(T, t) == _text(J, j)
    return t


def _f32(field, v):
    return wire.tag(field, 5) + np.float32(v).tobytes()


def _v0_conn(inner: bytes, bottom=(), top=()) -> bytes:
    """One V0-era connection, wrapped as NetParameter.layers (field 2):
    V1LayerParameter{layer=1 bottom=2 top=3}."""
    out = wire.field_bytes(1, inner)
    for b in bottom:
        out += wire.field_bytes(2, b)
    for t in top:
        out += wire.field_bytes(3, t)
    return wire.field_bytes(2, out)


# --- every zoo net and solver: encode byte for byte, decode to the text ---

@pytest.mark.parametrize("name", jmodels.available_models())
def test_zoo_net_encodes_the_jax_bytes(name):
    jb = jprotobin.encode(jmodels.load_model(name), "NetParameter")
    tb = tprotobin.encode(tmodels.load_model(name), "NetParameter")
    assert tb == jb
    assert (tprototext.dumps(tprotobin.decode("NetParameter", jb))
            == jprototext.dumps(jprotobin.decode("NetParameter", jb)))


@pytest.mark.parametrize("name", sorted(jmodels._SOLVER_FILES))
def test_zoo_solver_encodes_the_jax_bytes(name):
    jb = jprotobin.encode(jmodels.load_model_solver(name), "SolverParameter")
    tb = tprotobin.encode(tmodels.load_model_solver(name), "SolverParameter")
    assert tb == jb
    assert (tprototext.dumps(tprotobin.decode("SolverParameter", jb))
            == jprototext.dumps(jprotobin.decode("SolverParameter", jb)))


# --- the cases of tests/test_protobin.py, through both packages ----------

def test_modern_net_roundtrip_exact(tmp_path):
    def case(P, d):
        netp = P.models.load_model("lenet")
        back = P.protobin.decode(
            "NetParameter", P.protobin.encode(netp, "NetParameter"))
        assert _text(P, netp) == _text(P, back)
        return back

    _same_text(case, tmp_path)


@pytest.mark.parametrize(
    "name", ["cifar10_full", "alexnet", "mnist_siamese", "mnist_autoencoder"]
)
def test_zoo_nets_roundtrip_fixed_point(name, tmp_path):
    def case(P, d):
        netp = P.models.load_model(name)
        once = P.protobin.encode(netp, "NetParameter")
        back = P.protobin.decode("NetParameter", once)
        assert once == P.protobin.encode(back, "NetParameter")
        assert [(l.name, l.type, tuple(l.top)) for l in netp.layer] == [
            (l.name, l.type, tuple(l.top)) for l in back.layer]
        for a, b in zip(netp.layer, back.layer):
            if a.lrn_param:
                np.testing.assert_allclose(
                    b.lrn_param.alpha, a.lrn_param.alpha, rtol=1e-7)
        return back

    _same_text(case, tmp_path)


def test_solver_roundtrip_and_enums(tmp_path):
    def case(P, d):
        sp = P.models.load_model_solver("cifar10_quick")
        sp.net_param = None
        back = P.protobin.decode(
            "SolverParameter", P.protobin.encode(sp, "SolverParameter"))
        assert back.snapshot_format == "HDF5"  # enum survives by NAME
        assert back.base_lr == np.float32(sp.base_lr)
        assert back.max_iter == sp.max_iter
        assert back.lr_policy == sp.lr_policy
        return back

    _same_text(case, tmp_path)


def test_v1_binary_net_upgrades(tmp_path):
    conv_param = wire.field_varint(1, 3) + wire.field_varint(4, 3)
    v1_layer = (
        wire.field_bytes(2, b"data")
        + wire.field_bytes(3, b"conv1")
        + wire.field_bytes(4, b"conv1")
        + wire.field_varint(5, 4)  # LayerType CONVOLUTION
        + _f32(7, 1.0) + _f32(7, 2.0)  # blobs_lr
        + wire.field_bytes(10, conv_param)
        + wire.field_bytes(1001, b"shared_w")
    )
    blob = wire.field_bytes(1, b"v1net") + wire.field_bytes(2, v1_layer)

    def case(P, d):
        src = d / "v1.binaryproto"
        src.write_bytes(blob)
        netp = P.protobin.load_net_binary(str(src))
        assert netp.name == "v1net"
        (layer,) = netp.layer
        assert layer.type == "Convolution"
        assert layer.convolution_param.kernel_size == [3]
        assert layer.param[0].name == "shared_w"
        assert [p.lr_mult for p in layer.param] == [1.0, 2.0]
        assert not layer.blobs_lr
        return netp

    _same_text(case, tmp_path)


def test_solver_binary_upgrades_legacy(tmp_path):
    v1_layer = wire.field_bytes(4, b"ip") + wire.field_varint(5, 14)
    sp_bytes = (wire.field_bytes(25, wire.field_bytes(2, v1_layer))
                + wire.field_varint(30, 1))  # solver_type NESTEROV

    def case(P, d):
        p = d / "legacy.solverstate"
        p.write_bytes(sp_bytes)
        sp = P.protobin.load_solver_binary(str(p))
        assert sp.solver_type is None and sp.type == "NESTEROV"
        assert sp.net_param.layer[0].type == "InnerProduct"
        return sp

    _same_text(case, tmp_path)


def test_weight_carrying_modern_net_loads(tmp_path):
    blob_proto = wire.field_varint(2, 1) + _f32(5, 7.0)
    layer = wire.field_bytes(1, b"ip") + wire.field_bytes(7, blob_proto)

    def case(P, d):
        p = d / "weights.binaryproto"
        p.write_bytes(wire.field_bytes(100, layer))
        netp = P.protobin.load_net_binary(str(p))
        (lp,) = netp.layer
        assert lp.name == "ip" and len(lp.blobs) == 1
        assert lp.blobs[0].channels == 1
        assert list(lp.blobs[0].data) == [7.0]
        return netp

    _same_text(case, tmp_path)


def test_double_data_blob_folds_into_data(tmp_path):
    vals = [1.5, -2.25, 3.0]
    packed = np.asarray(vals, "<f8").tobytes()
    blob_proto = (
        wire.field_bytes(7, wire.field_packed_varints(1, (3,)))
        + wire.field_bytes(8, packed)
        + wire.field_bytes(9, packed)
    )
    layer = wire.field_bytes(1, b"ip") + wire.field_bytes(7, blob_proto)

    def case(P, d):
        blob = P.protobin.decode("BlobProto", blob_proto)
        assert list(blob.data) == vals and list(blob.diff) == vals
        src = d / "double.binaryproto"
        src.write_bytes(wire.field_bytes(100, layer))
        netp = P.protobin.load_net_binary(str(src))
        assert list(netp.layer[0].blobs[0].data) == vals
        out = d / "upgraded.binaryproto"
        P.protobin.save_net_binary(netp, str(out))
        back = P.protobin.load_net_binary(str(out))
        assert list(back.layer[0].blobs[0].data) == vals
        return back

    _same_text(case, tmp_path)
    assert ((tmp_path / "port" / "upgraded.binaryproto").read_bytes()
            == (tmp_path / "jax" / "upgraded.binaryproto").read_bytes())


def test_double_data_unpacked_also_folds(tmp_path):
    blob_proto = b"".join(
        wire.tag(8, 1) + struct.pack("<d", v) for v in (4.5, 0.25))

    def case(P, d):
        blob = P.protobin.decode("BlobProto", blob_proto)
        assert list(blob.data) == [4.5, 0.25]
        return blob

    _same_text(case, tmp_path)


def test_upgrade_net_proto_binary_cli(tmp_path):
    def case(P, d):
        netp = P.models.load_model("lenet")
        src = d / "modern.binaryproto"
        P.protobin.save_net_binary(netp, str(src))
        out = d / "upgraded.binaryproto"
        assert P.cli.main(["upgrade_net_proto_binary", str(src),
                           str(out)]) == 0
        back = P.protobin.load_net_binary(str(out))
        assert _text(P, back) == _text(P, netp)
        return back

    _same_text(case, tmp_path)
    for name in ("modern.binaryproto", "upgraded.binaryproto"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_packed_repeated_decodes(tmp_path):
    packed = b"".join(np.float32(v).tobytes() for v in (0.5, 1.5, 2.5))
    lp = wire.field_bytes(1, b"x") + wire.field_bytes(5, packed)

    def case(P, d):
        layer = P.protobin.decode("LayerParameter", lp)  # 5 = loss_weight
        assert layer.loss_weight == [0.5, 1.5, 2.5]
        return layer

    _same_text(case, tmp_path)


def test_negative_varint_roundtrip(tmp_path):
    def case(P, d):
        ip = P.schema.InnerProductParameter(num_output=7, axis=-1)
        data = P.protobin.encode(ip, "InnerProductParameter")
        back = P.protobin.decode("InnerProductParameter", data)
        assert back.axis == -1 and back.num_output == 7
        return back

    _same_text(case, tmp_path)
    assert (tprotobin.encode(tschema.InnerProductParameter(axis=-1),
                             "InnerProductParameter")
            == jprotobin.encode(jschema.InnerProductParameter(axis=-1),
                                "InnerProductParameter"))


EXT_NET = """
name: "ext"
layer { name: "in" type: "Input" top: "x"
  input_param { shape { dim: 1 dim: 3 dim: 9 dim: 9 } } }
layer { name: "c" type: "Convolution" bottom: "x" top: "c"
  convolution_param { num_output: 2 kernel_size: 3 dilation: 2
    weight_filler { type: "xavier" } } }
layer { name: "e" type: "ELU" bottom: "c" top: "e"
  elu_param { alpha: 0.75 } }
layer { name: "s" type: "Scale" bottom: "e" top: "s"
  scale_param { bias_term: true } }
"""


def test_extension_fields_roundtrip(tmp_path):
    def case(P, d):
        netp = P.config.parse_net_prototxt(EXT_NET)
        back = P.protobin.decode(
            "NetParameter", P.protobin.encode(netp, "NetParameter"))
        assert _text(P, back) == _text(P, netp)
        assert back.layer[1].convolution_param.dilation == [2]
        assert back.layer[2].elu_param.alpha == 0.75
        assert back.layer[3].scale_param.bias_term is True
        assert back.layer[0].input_param.shape[0].dim == [1, 3, 9, 9]
        return back

    _same_text(case, tmp_path)


def _v0_net_bytes() -> bytes:
    pad_l = (wire.field_bytes(1, b"pad1") + wire.field_bytes(2, b"padding")
             + wire.field_varint(7, 2))
    conv = (
        wire.field_bytes(1, b"conv1") + wire.field_bytes(2, b"conv")
        + wire.field_varint(3, 4) + wire.field_varint(8, 3)
        + wire.field_varint(10, 1)
        + _f32(51, 1.0) + _f32(51, 2.0) + _f32(52, 1.0) + _f32(52, 0.0)
    )
    pool = (
        wire.field_bytes(1, b"pool1") + wire.field_bytes(2, b"pool")
        + wire.field_varint(8, 2) + wire.field_varint(10, 2)
        + wire.field_varint(11, 1)  # PoolMethod AVE
    )
    loss = wire.field_bytes(1, b"loss") + wire.field_bytes(2, b"softmax_loss")
    return (
        wire.field_bytes(1, b"v0net")
        + wire.field_bytes(3, b"data") + wire.field_bytes(3, b"label")
        + wire.field_varint(4, 1) + wire.field_varint(4, 3)
        + wire.field_varint(4, 8) + wire.field_varint(4, 8)
        + _v0_conn(pad_l, [b"data"], [b"pad1"])
        + _v0_conn(conv, [b"pad1"], [b"conv1"])
        + _v0_conn(pool, [b"conv1"], [b"pool1"])
        + _v0_conn(loss, [b"pool1", b"label"], [b"loss"])
    )


def test_v0_binary_net_upgrades(tmp_path):
    net = _v0_net_bytes()

    def case(P, d):
        src = d / "v0.binaryproto"
        src.write_bytes(net)
        assert P.protobin.net_needs_v0_upgrade(net)
        netp = P.protobin.load_net_binary(str(src))
        assert [l.type for l in netp.layer] == [
            "Convolution", "Pooling", "SoftmaxWithLoss"]
        c, p, s = netp.layer
        assert c.convolution_param.pad == [2]
        assert list(c.bottom) == ["data"]
        assert [ps.lr_mult for ps in c.param] == [1.0, 2.0]
        assert [ps.decay_mult for ps in c.param] == [1.0, 0.0]
        assert p.pooling_param.pool == "AVE"
        assert list(s.bottom) == ["pool1", "label"]
        out = d / "upgraded.binaryproto"
        assert P.cli.main(["upgrade_net_proto_binary", str(src),
                           str(out)]) == 0
        back = P.protobin.load_net_binary(str(out))
        assert _text(P, back) == _text(P, netp)
        return netp

    _same_text(case, tmp_path)
    assert ((tmp_path / "port" / "upgraded.binaryproto").read_bytes()
            == (tmp_path / "jax" / "upgraded.binaryproto").read_bytes())


def test_v0_binary_weight_carrying_net_upgrades_in_place(tmp_path):
    w = np.arange(2 * 3 * 3 * 3, dtype=np.float32)
    blob = (
        wire.field_varint(1, 2) + wire.field_varint(2, 3)
        + wire.field_varint(3, 3) + wire.field_varint(4, 3)
        + b"".join(_f32(5, v) for v in w)
    )
    bias = (wire.field_varint(1, 1) + wire.field_varint(2, 2)
            + wire.field_varint(3, 1) + wire.field_varint(4, 1)
            + _f32(5, 0.5) + _f32(5, -0.5))
    pad_l = (wire.field_bytes(1, b"pad1") + wire.field_bytes(2, b"padding")
             + wire.field_varint(7, 1))
    conv = (
        wire.field_bytes(1, b"conv1") + wire.field_bytes(2, b"conv")
        + wire.field_varint(3, 2) + wire.field_varint(8, 3)
        + wire.field_bytes(50, blob) + wire.field_bytes(50, bias)
    )
    net = (
        wire.field_bytes(1, b"v0w") + wire.field_bytes(3, b"data")
        + wire.field_varint(4, 1) + wire.field_varint(4, 3)
        + wire.field_varint(4, 8) + wire.field_varint(4, 8)
        + _v0_conn(pad_l, [b"data"], [b"pad1"])
        + _v0_conn(conv, [b"pad1"], [b"conv1"])
    )

    def case(P, d):
        p = d / "v0w.binaryproto"
        p.write_bytes(net)
        netp = P.protobin.load_net_binary(str(p))
        (c,) = netp.layer
        assert c.type == "Convolution" and c.convolution_param.pad == [1]
        assert (c.blobs[0].num, c.blobs[0].channels) == (2, 3)
        np.testing.assert_array_equal(np.asarray(c.blobs[0].data), w)
        np.testing.assert_array_equal(np.asarray(c.blobs[1].data),
                                      [0.5, -0.5])
        out = d / "upgraded.binaryproto"
        assert P.cli.main(["upgrade_net_proto_binary", str(p),
                           str(out)]) == 0
        back = P.protobin.load_net_binary(str(out))
        np.testing.assert_array_equal(
            np.asarray(back.layer[0].blobs[0].data), w)
        assert _text(P, back) == _text(P, netp)
        return back

    _same_text(case, tmp_path)
    assert ((tmp_path / "port" / "upgraded.binaryproto").read_bytes()
            == (tmp_path / "jax" / "upgraded.binaryproto").read_bytes())


def test_v0_text_padding_folds_too(tmp_path):
    text = """
        name: "v0t"
        input: "data"
        input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
        layers { layer { name: "pad1" type: "padding" pad: 1 }
                 bottom: "data" top: "pad1" }
        layers { layer { name: "conv1" type: "conv" num_output: 2
                         kernelsize: 3 }
                 bottom: "pad1" top: "conv1" }
        """

    def case(P, d):
        netp = P.config.parse(text, P.config.NetParameter)
        (c,) = netp.layer
        assert c.type == "Convolution" and c.convolution_param.pad == [1]
        assert list(c.bottom) == ["data"]
        return netp

    _same_text(case, tmp_path)


def test_v0_weight_file_loads_via_caffemodel(tmp_path):
    blob = (wire.field_varint(1, 1) + wire.field_varint(2, 1)
            + wire.field_varint(3, 1) + wire.field_varint(4, 2)
            + _f32(5, 3.0) + _f32(5, 4.0))
    inner = wire.field_bytes(1, b"ip") + wire.field_bytes(50, blob)
    data = wire.field_bytes(1, b"v0w") + _v0_conn(inner)

    def case(P, d):
        p = d / "v0.caffemodel"
        p.write_bytes(data)
        w = P.caffemodel.load_weights(str(p))
        assert list(w) == ["ip"]
        np.testing.assert_allclose(w["ip"][0].reshape(-1), [3.0, 4.0])
        return w

    j, t = _both(case, tmp_path)
    np.testing.assert_array_equal(t["ip"][0], j["ip"][0])


def test_mixed_v0_v1_binary_net(tmp_path):
    v0 = (wire.field_bytes(1, b"c1") + wire.field_bytes(2, b"conv")
          + wire.field_varint(3, 2) + wire.field_varint(8, 3))
    v1 = (wire.field_bytes(4, b"ip1") + wire.field_varint(5, 14)
          + _f32(7, 3.0) + wire.field_bytes(1001, b"shared_w")
          + wire.field_bytes(2, b"c1") + wire.field_bytes(3, b"ip1"))
    v1_w = (wire.field_bytes(4, b"w") + wire.field_varint(5, 14)
            + wire.field_bytes(6, wire.field_varint(1, 1) + _f32(5, 2.5))
            + wire.field_bytes(2, b"c1") + wire.field_bytes(3, b"w"))
    head = (wire.field_bytes(3, b"data")
            + wire.field_varint(4, 1) + wire.field_varint(4, 3)
            + wire.field_varint(4, 8) + wire.field_varint(4, 8)
            + _v0_conn(v0, [b"data"], [b"c1"]))
    mixed = wire.field_bytes(1, b"mixed") + head + wire.field_bytes(2, v1)
    mixed_w = wire.field_bytes(1, b"mw") + head + wire.field_bytes(2, v1_w)

    def case(P, d):
        (d / "m.bin").write_bytes(mixed)
        (d / "mw.bin").write_bytes(mixed_w)
        netp = P.protobin.load_net_binary(str(d / "m.bin"))
        assert [l.type for l in netp.layer] == ["Convolution",
                                               "InnerProduct"]
        ip = netp.layer[1]
        assert ip.param[0].name == "shared_w" and ip.param[0].lr_mult == 3.0
        assert not ip.blobs_lr
        netp2 = P.protobin.load_net_binary(str(d / "mw.bin"))
        assert list(netp2.layer[1].blobs[0].data) == [2.5]
        return P.schema.SolverParameter(test_net_param=[netp, netp2])

    _same_text(case, tmp_path)


def test_solver_with_embedded_v0_net(tmp_path):
    inner = (wire.field_bytes(1, b"fc") + wire.field_bytes(2, b"innerproduct")
             + wire.field_varint(3, 5))
    embedded = (wire.field_bytes(3, b"data")
                + wire.field_varint(4, 1) + wire.field_varint(4, 4)
                + _v0_conn(inner, [b"data"], [b"fc"]))

    def case(P, d):
        p = d / "v0solver.bin"
        p.write_bytes(wire.field_bytes(25, embedded))
        sp = P.protobin.load_solver_binary(str(p))
        (layer,) = sp.net_param.layer
        assert layer.type == "InnerProduct"
        assert layer.inner_product_param.num_output == 5
        return sp

    _same_text(case, tmp_path)


# --- the upgrade cases of tests/test_parity_tails.py ----------------------

V0_NET = """
name: "v0net"
input: "data"
input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8
layers {
  layer { name: "conv1" type: "conv" num_output: 4 kernelsize: 3 stride: 1
    pad: 1 blobs_lr: 1.0 blobs_lr: 2.0 weight_decay: 1.0 weight_decay: 0.0
    weight_filler { type: "xavier" } }
  bottom: "data" top: "conv1"
}
layers {
  layer { name: "pool1" type: "pool" pool: MAX kernelsize: 2 stride: 2 }
  bottom: "conv1" top: "pool1"
}
layers {
  layer { name: "norm1" type: "lrn" local_size: 3 alpha: 0.0001 beta: 0.75 }
  bottom: "pool1" top: "norm1"
}
layers {
  layer { name: "drop" type: "dropout" dropout_ratio: 0.4 }
  bottom: "norm1" top: "norm1"
}
layers {
  layer { name: "ip" type: "innerproduct" num_output: 3
    weight_filler { type: "xavier" } }
  bottom: "norm1" top: "ip"
}
layers {
  layer { name: "loss" type: "softmax_loss" }
  bottom: "ip" bottom: "label" top: "loss"
}
"""

V1_NET = """
name: "v1net"
input: "data"
input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1"
  lrn_param { local_size: 3 alpha: 0.0001 beta: 0.75 } }
layers { name: "ip" type: INNER_PRODUCT bottom: "norm1" top: "ip"
  blobs_lr: 1 blobs_lr: 2 inner_product_param { num_output: 3 } }
layers { name: "prob" type: SOFTMAX bottom: "ip" top: "prob" }
"""


@pytest.mark.parametrize("text", [V0_NET, V1_NET], ids=["v0", "v1"])
def test_legacy_net_text_upgrades_and_runs(text, tmp_path):
    """A V0 or V1 net loads through the port's parser as the JAX one
    upgrades it, and the port's net builds and runs on it."""
    import torch

    from sparknet_tpu_torch.net import TorchNet

    def case(P, d):
        netp = P.config.parse_net_prototxt(text)
        assert not netp.layers
        assert all(not l.blobs_lr for l in netp.layer)
        assert netp.layer[0].type == "Convolution"
        assert [p.lr_mult for p in netp.layer[0].param] == [1.0, 2.0]
        return netp

    netp = _same_text(case, tmp_path)
    feeds = {"data": (2, 3, 8, 8)}
    batch = {"data": torch.from_numpy(
        np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32))}
    if "label" in {b for l in netp.layer for b in l.bottom}:
        feeds["label"] = (2,)
        batch["label"] = torch.zeros(2)
    net = TorchNet(netp, phase="TRAIN", feed_shapes=feeds)
    params, stats = net.init(0)
    blobs = net.forward(params, stats, batch)
    assert all(torch.isfinite(v).all() for v in blobs.values()
               if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("text", [V0_NET, V1_NET], ids=["v0", "v1"])
def test_upgrade_proto_text_cli_writes_the_jax_bytes(text, tmp_path):
    """upgrade_net_proto_text and upgrade_solver_proto_text write the
    JAX commands' files."""
    solver = ('train_net: "n.prototxt"\nbase_lr: 0.01\nlr_policy: "fixed"\n'
              "max_iter: 10\nsolver_type: NESTEROV\n")

    def case(P, d):
        (d / "legacy.prototxt").write_text(text)
        (d / "legacy_solver.prototxt").write_text(solver)
        assert P.cli.main(["upgrade_net_proto_text",
                           str(d / "legacy.prototxt"),
                           str(d / "modern.prototxt")]) == 0
        assert P.cli.main(["upgrade_solver_proto_text",
                           str(d / "legacy_solver.prototxt"),
                           str(d / "modern_solver.prototxt")]) == 0
        out = (d / "modern.prototxt").read_text()
        assert "layers" not in out.split("{")[0]
        stext = (d / "modern_solver.prototxt").read_text()
        assert "solver_type" not in stext
        assert P.schema.solver_method(
            P.config.parse_solver_prototxt(stext)) == "NESTEROV"
        return P.config.parse_net_prototxt(out)

    _same_text(case, tmp_path)
    for name in ("modern.prototxt", "modern_solver.prototxt"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_v0_unknown_field_raises():
    bad = """
    layers {
      layer { name: "x" type: "relu" num_output: 3 }
      bottom: "a" top: "b"
    }
    """
    for config in (jconfig, tconfig):
        with pytest.raises(ValueError, match="no upgrade"):
            config.parse_net_prototxt(bad)


def test_weighted_legacy_binary_of_a_zoo_net(tmp_path):
    """A V1 binary CaffeNet-style net that carries its weights in the
    layers (the layout BVLC-era .caffemodel files share) upgrades to the
    JAX bytes, and its blobs read back bit for bit."""
    rng = np.random.RandomState(3)
    layers = b""
    for name, v1_type, shape in (("conv1", 4, (4, 3, 3, 3)),
                                 ("fc", 14, (5, 36))):
        w = rng.randn(*shape).astype(np.float32)
        blob = (b"".join(wire.field_varint(i + 1, n)
                         for i, n in enumerate((1,) * (4 - len(shape))
                                               + shape))
                + wire.field_bytes(5, w.tobytes()))
        layers += wire.field_bytes(2, (
            wire.field_bytes(4, name.encode()) + wire.field_varint(5, v1_type)
            + _f32(7, 1.0) + _f32(7, 2.0) + _f32(8, 1.0) + _f32(8, 0.0)
            + wire.field_bytes(6, blob)))
    data = wire.field_bytes(1, b"legacy") + layers

    def case(P, d):
        (d / "in.bin").write_bytes(data)
        assert P.cli.main(["upgrade_net_proto_binary", str(d / "in.bin"),
                           str(d / "out.bin")]) == 0
        netp = P.protobin.load_net_binary(str(d / "out.bin"))
        assert [l.type for l in netp.layer] == ["Convolution",
                                               "InnerProduct"]
        assert [p.decay_mult for p in netp.layer[0].param] == [1.0, 0.0]
        return netp

    _same_text(case, tmp_path)
    assert ((tmp_path / "port" / "out.bin").read_bytes()
            == (tmp_path / "jax" / "out.bin").read_bytes())
