"""The port's LMDB and LevelDB readers and writers, the Datum codec, the
record-DB importers and ``cli test`` against the JAX package's, on the CPU.

- LMDB / LevelDB: databases written by the JAX writers are read by the
  port's readers and the reverse (small inline values, overflow chains
  and several leaf pages; multi-block tables, snappy-literal blocks and
  a write-ahead log with overwrites and deletions).
- The Datum codec: ``encode_datum`` bytes equal, ``decode_datum`` of raw,
  float and encoded (JPEG, through PIL) Datums equal.
- ``lmdb_to_record_db`` and ``leveldb_to_record_db`` write the same
  record-DB bytes in both packages.
- The snappy decoder on the JAX tests' copy-tag cases.
- ``cli test``: the port's scores equal the JAX ``cli test``'s on the
  same LMDB (written by the port at the net's input size), net and
  weights (rtol 1e-5); a net's own ``Data`` source and a LevelDB
  ``--data`` score like the LMDB; a net fed by a source that is not yet
  ported refuses.
"""

import io
import os
import re

import numpy as np
import pytest

from sparknet_tpu.io import leveldb as jleveldb
from sparknet_tpu.io import lmdb as jlmdb
from sparknet_tpu.tools import cli as jcli
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch.io import caffemodel as tcaffemodel
from sparknet_tpu_torch.io import leveldb as tleveldb
from sparknet_tpu_torch.io import lmdb as tlmdb
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.tools import cli as tcli


def _items(n, seed=0, vmin=20, vmax=300):
    rng = np.random.RandomState(seed)
    return [(b"%08d" % i,
             rng.randint(0, 256, int(rng.randint(vmin, vmax)), np.uint8).tobytes())
            for i in range(n)]


def _images(n, c=3, h=8, w=8, seed=1, classes=10):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, c, h, w)).astype(np.uint8),
            rs.randint(0, classes, n))


# ----------------------------------------------------------------------
# LMDB
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,vmin,vmax", [(30, 5, 60), (120, 200, 3000)],
                         ids=["inline", "overflow-multileaf"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lmdb_each_package_reads_the_others(tmp_path, n, vmin, vmax, writer):
    items = _items(n, vmin=vmin, vmax=vmax)
    path = str(tmp_path / "db")
    (jlmdb if writer == "jax" else tlmdb).write_lmdb(path, items)
    assert tlmdb.is_lmdb(path) and jlmdb.is_lmdb(path)
    assert list(tlmdb.LMDBReader(path)) == list(jlmdb.LMDBReader(path)) == items
    other = str(tmp_path / "other")
    (tlmdb if writer == "jax" else jlmdb).write_lmdb(other, items)
    with open(os.path.join(path, "data.mdb"), "rb") as a, \
            open(os.path.join(other, "data.mdb"), "rb") as b:
        assert a.read() == b.read()  # the writers' bytes agree too


def test_datum_codec_equals_jax():
    imgs, labels = _images(3)
    for img, label in zip(imgs, labels):
        for encoded in (False, True):
            assert tlmdb.encode_datum(img, label, encoded) == \
                jlmdb.encode_datum(img, label, encoded)
        buf = jlmdb.encode_datum(img, label)
        got, lab = tlmdb.decode_datum(buf)
        assert lab == label and np.array_equal(got, img)
    # float_data Datums, and an encoded (JPEG) one through PIL
    from sparknet_tpu_torch.io import wire

    floats = np.arange(12, dtype=np.float32)
    fbuf = (wire.field_varint(1, 3) + wire.field_varint(2, 2)
            + wire.field_varint(3, 2) + wire.field_packed_floats(6, floats)
            + wire.field_varint(5, 4))
    for mod in (tlmdb, jlmdb):
        arr, lab = mod.decode_datum(fbuf)
        assert lab == 4 and np.array_equal(arr.reshape(-1), floats)
    from PIL import Image

    jpeg = io.BytesIO()
    Image.fromarray(imgs[0].transpose(1, 2, 0)).save(jpeg, format="JPEG")
    ebuf = (wire.field_bytes(4, jpeg.getvalue()) + wire.field_varint(5, 2)
            + wire.field_varint(7, 1))
    t, tl = tlmdb.decode_datum(ebuf)
    j, jl = jlmdb.decode_datum(ebuf)
    assert tl == jl == 2 and t.shape == (3, 8, 8) and np.array_equal(t, j)
    with pytest.raises(tlmdb.LMDBError):
        tlmdb.decode_datum(wire.field_varint(5, 1))


@pytest.mark.parametrize("classes", [10, 1000])
def test_lmdb_to_record_db_equals_jax(tmp_path, classes):
    imgs, labels = _images(25, classes=classes)
    src = str(tmp_path / "src_lmdb")
    tlmdb.write_datum_lmdb(src, imgs, labels)
    got = [tuple(x) for x in jlmdb.read_datum_lmdb(src)]
    assert all(np.array_equal(a, b) and la == lb for (a, la), b, lb in
               zip(got, imgs, labels))
    jout = jlmdb.lmdb_to_record_db(src, str(tmp_path / "j.sndb"))
    tout = tlmdb.lmdb_to_record_db(src, str(tmp_path / "t.sndb"))
    with open(jout, "rb") as a, open(tout, "rb") as b:
        assert a.read() == b.read()
    # cached: a second import returns the file as it is
    assert tlmdb.lmdb_to_record_db(src, tout) == tout


# ----------------------------------------------------------------------
# LevelDB
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["multiblock", "snappy", "log"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_leveldb_each_package_reads_the_others(tmp_path, case, writer):
    items = _items(150, seed=2)
    kw = {"multiblock": dict(block_size=512),
          "snappy": dict(block_size=1024, snappy_literal=True),
          "log": dict(log_items=[(items[3][0], b"new"), (items[7][0], None),
                                 (b"zz-late", b"tail")])}[case]
    path = str(tmp_path / "db")
    (jleveldb if writer == "jax" else tleveldb).write_leveldb(path, items, **kw)
    assert tleveldb.is_leveldb(path) and not tlmdb.is_lmdb(path)
    got = list(tleveldb.LevelDBReader(path))
    assert got == list(jleveldb.LevelDBReader(path))
    want = dict(items)
    for k, v in kw.get("log_items", []):
        if v is None:
            want.pop(k)
        else:
            want[k] = v
    assert got == sorted(want.items())


@pytest.mark.parametrize("classes", [10, 1000])
def test_leveldb_to_record_db_equals_jax(tmp_path, classes):
    imgs, labels = _images(25, seed=3, classes=classes)
    src = str(tmp_path / "src_leveldb")
    tleveldb.write_datum_leveldb(src, imgs, labels)
    jout = jleveldb.leveldb_to_record_db(src, str(tmp_path / "j.sndb"))
    tout = tleveldb.leveldb_to_record_db(src, str(tmp_path / "t.sndb"))
    with open(jout, "rb") as a, open(tout, "rb") as b:
        assert a.read() == b.read()
    for (a, la), b, lb in zip(tleveldb.read_datum_leveldb(src), imgs, labels):
        assert la == lb and np.array_equal(a, b)


@pytest.mark.parametrize("stream,raw", [
    # "abc" then copy(offset=3, len=9) then "X" (2-byte-offset copy tag)
    (bytes([13]) + bytes([(3 - 1) << 2]) + b"abc"
     + bytes([((9 - 1) << 2) | 2]) + (3).to_bytes(2, "little")
     + bytes([(1 - 1) << 2]) + b"X", b"abcabcabcabcX"),
    # a 1-byte-offset copy tag: copy len 4 offset 3 after "abcd"
    (bytes([8]) + bytes([(4 - 1) << 2]) + b"abcd"
     + bytes([((4 - 4) << 2) | 1]) + bytes([3]), b"abcdbcdb"),
], ids=["copy2", "copy1"])
def test_snappy_copy_tags_decode(stream, raw):
    assert tleveldb.snappy_decompress(stream) == raw
    assert jleveldb.snappy_decompress(stream) == raw
    literal = tleveldb.snappy_compress_literal(raw)
    assert literal == jleveldb.snappy_compress_literal(raw)
    assert tleveldb.snappy_decompress(literal) == raw


def test_crc32c_and_internal_keys_equal_jax():
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert tleveldb.crc32c(data) == jleveldb.crc32c(data)
        assert tleveldb.crc_unmask(tleveldb.crc_mask(tleveldb.crc32c(data))) \
            == tleveldb.crc32c(data)
    ikey = tleveldb.pack_internal_key(b"key", 77, 1)
    assert ikey == jleveldb.pack_internal_key(b"key", 77, 1)
    assert tleveldb.unpack_internal_key(ikey) == (b"key", 77, 1)


# ----------------------------------------------------------------------
# cli test
# ----------------------------------------------------------------------
S, B = 16, 10  # the net's input size and TEST batch

NET = f"""name: "tiny"
layer {{ name: "data" type: "HostData" top: "data" top: "label"
  java_data_param {{ shape {{ dim: {B} dim: 3 dim: {S} dim: {S} }}
                     shape {{ dim: {B} }} }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param {{ num_output: 8 kernel_size: 3 stride: 1
    weight_filler {{ type: "gaussian" std: 0.01 }} }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
layer {{ name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "norm1" top: "fc"
  inner_product_param {{ num_output: 10
    weight_filler {{ type: "gaussian" std: 0.01 }} }} }}
layer {{ name: "accuracy" type: "Accuracy" bottom: "fc" bottom: "label"
  top: "accuracy" include {{ phase: TEST }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
"""


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The net, its seeded weights and an LMDB of 30 records at its input
    size, written by the port."""
    d = tmp_path_factory.mktemp("cli_test")
    model = str(d / "net.prototxt")
    with open(model, "w") as f:
        f.write(NET)
    net = TorchNet(tconfig.parse_net_prototxt(NET), "TEST")
    params, stats = net.init(seed=4, device="cpu")
    weights = str(d / "w.caffemodel")
    tcaffemodel.save_weights(tcaffemodel.net_blobs(net, params, stats), weights)
    imgs, labels = _images(30, h=S, w=S, seed=5)
    lmdb_dir = str(d / "val_lmdb")
    tlmdb.write_datum_lmdb(lmdb_dir, imgs, labels)
    return model, weights, lmdb_dir, imgs, labels


def _jax_scores(argv, capsys, monkeypatch):
    """The JAX ``cli test``'s summed scores (its printed lines keep four
    decimals, so the totals are read where the command computes them)."""
    from sparknet_tpu.solver import Solver as JSolver

    seen = {}
    score = JSolver.test_and_store_result

    def keep(self, *a, **k):
        seen.update(score(self, *a, **k))
        return dict(seen)

    monkeypatch.setattr(JSolver, "test_and_store_result", keep)
    capsys.readouterr()
    assert jcli.main(argv) == 0
    printed = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(\w+) = (\S+)$", capsys.readouterr().out, re.M)}
    assert printed == {k: round(v / 2, 4) for k, v in seen.items()}
    return seen


def test_cli_test_scores_equal_the_jax_cli(scored, tmp_path, capsys,
                                           monkeypatch):
    model, weights, lmdb_dir, imgs, labels = scored
    argv = ["test", f"--model={model}", f"--weights={weights}",
            f"--data={lmdb_dir}", "--iterations=2"]
    want = _jax_scores(argv, capsys, monkeypatch)
    # the JAX import left its record DB beside the LMDB: start afresh
    os.remove(lmdb_dir + ".sndb")
    result = {}
    assert tcli.main(argv + ["--device=cpu"], result) == 0
    out = capsys.readouterr().out
    assert set(want) == {"accuracy", "loss"} == set(result["scores"])
    for name, total in result["scores"].items():
        np.testing.assert_allclose(total, want[name], rtol=1e-5)
        assert f"{name} = {total / 2:.4f}" in out
    # a LevelDB of the same records scores the same
    ldb = str(tmp_path / "val_leveldb")
    tleveldb.write_datum_leveldb(ldb, imgs, labels)
    again = {}
    assert tcli.main(["test", f"--model={model}", f"--weights={weights}",
                      f"--data={ldb}", "--iterations=2", "--device=cpu"],
                     again) == 0
    assert again["scores"] == result["scores"]


def test_cli_test_reads_the_nets_data_source(scored, tmp_path):
    """A ``Data`` layer's ``data_param.source`` (an LMDB) and its
    ``transform_param`` (mean_value, scale) feed the TEST net when
    ``--data`` is omitted."""
    from sparknet_tpu_torch.data.source import resolve_batches

    _, _, lmdb_dir, imgs, labels = scored
    text = NET.replace('type: "HostData"', 'type: "Data"').replace(
        "java_data_param", f'data_param {{ source: "{lmdb_dir}" '
        f'batch_size: {B} }} transform_param {{ mean_value: 100 '
        "mean_value: 110 mean_value: 120 scale: 0.5 } java_data_param")
    netp = tconfig.parse_net_prototxt(text)
    net = TorchNet(netp, "TEST", feed_shapes={"data": (B, 3, S, S),
                                              "label": (B,)})
    out = resolve_batches(net, netp, None, 2, phase="TEST")
    mean = np.array([100, 110, 120], np.float32).reshape(1, 3, 1, 1)
    want = (imgs[:20].astype(np.float32) - mean) * np.float32(0.5)
    assert np.array_equal(out["data"].reshape(20, 3, S, S), want)
    assert np.array_equal(out["label"].reshape(-1), labels[:20].astype(np.float32))
    for lp in netp.layer:
        if lp.type == "Data":
            lp.type = "ImageData"  # no image_data_param source: none
    with pytest.raises(ValueError, match="no data source"):
        resolve_batches(net, netp, None, 2, phase="TEST")
    with pytest.raises(ValueError, match="no data source"):
        resolve_batches(net, None, None, 2, phase="TEST")
    synth = resolve_batches(net, None, None, 2, phase="TEST",
                            allow_synthetic=True)
    assert synth["data"].shape == (2, B, 3, S, S)
