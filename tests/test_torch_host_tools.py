"""The port's host tools against the JAX package's: MNIST idx files
(``data/mnist.py``), the dataset converters and the mean image (``cli
convert_mnist``, ``convert_imageset``, ``compute_image_mean``), the log
parser (``tools/parse_log.py``, ``cli parse_log``), the net drawer
(``tools/draw.py``, ``cli draw_net``) and the ImageNet shard writer
(``tools/prepare_imagenet.py``).

Every file a tool writes is compared byte for byte with the file the
JAX tool writes on the same inputs (made from a seed with numpy); a tar
shard, whose headers may carry a time, is compared member for member."""

import gzip
import io
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

import sparknet_tpu.tools.cli as jcli
import sparknet_tpu_torch.tools.cli as tcli
from sparknet_tpu import models as jmodels
from sparknet_tpu.data import mnist as jmnist
from sparknet_tpu.tools import draw as jdraw
from sparknet_tpu.tools import parse_log as jparse
from sparknet_tpu.tools import prepare_imagenet as jprep
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.data import mnist as tmnist
from sparknet_tpu_torch.data.imagenet import ImageNetLoader
from sparknet_tpu_torch.tools import draw as tdraw
from sparknet_tpu_torch.tools import parse_log as tparse
from sparknet_tpu_torch.tools import prepare_imagenet as tprep


def _files(root) -> dict:
    """Relative path -> bytes of every file under ``root`` (or of
    ``root`` itself when it is a file)."""
    root = str(root)
    if os.path.isfile(root):
        return {"": open(root, "rb").read()}
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _members(path) -> list:
    """(name, size, mode, bytes) of every member of a tar shard."""
    with tarfile.open(path) as tf:
        return [(m.name, m.size, m.mode, tf.extractfile(m).read())
                for m in tf.getmembers()]


def _same_tree(a, b, tars_by_member=False):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        if tars_by_member and name.endswith(".tar"):
            assert (_members(os.path.join(str(a), name))
                    == _members(os.path.join(str(b), name))), name
        else:
            assert fa[name] == fb[name], name


# --- MNIST ---------------------------------------------------------------

def test_mnist_synthetic_files_are_the_jax_bytes(tmp_path):
    jmnist.write_synthetic(str(tmp_path / "j"), n_train=64, n_test=16,
                           seed=3)
    tmnist.write_synthetic(str(tmp_path / "t"), n_train=64, n_test=16,
                           seed=3)
    _same_tree(tmp_path / "j", tmp_path / "t")
    for train in (True, False):
        ji, jl = jmnist.load_mnist(str(tmp_path / "j"), train=train)
        ti, tl = tmnist.load_mnist(str(tmp_path / "t"), train=train)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        assert ti.shape[1:] == (1, 28, 28) and tl.dtype == jl.dtype


def test_mnist_idx_writers_and_gz(tmp_path):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (9, 1, 7, 5)).astype(np.uint8)
    labels = rng.randint(0, 10, 9)
    for mod, d in ((jmnist, "j"), (tmnist, "t")):
        os.makedirs(tmp_path / d)
        mod.write_idx_images(str(tmp_path / d / tmnist.TRAIN_IMAGES), images)
        mod.write_idx_labels(str(tmp_path / d / tmnist.TRAIN_LABELS), labels)
    _same_tree(tmp_path / "j", tmp_path / "t")
    # .gz copies read transparently (the reference's downloads are gzipped)
    g = tmp_path / "g"
    os.makedirs(g)
    for name in (tmnist.TRAIN_IMAGES, tmnist.TRAIN_LABELS):
        raw = (tmp_path / "t" / name).read_bytes()
        (g / (name + ".gz")).write_bytes(gzip.compress(raw, mtime=0))
    ti, tl = tmnist.load_mnist(str(g))
    ji, jl = jmnist.load_mnist(str(g))
    np.testing.assert_array_equal(ti, images)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    with pytest.raises(ValueError, match="single-channel"):
        tmnist.write_idx_images(str(g / "x"), np.zeros((1, 2, 3, 3)))
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist(str(tmp_path / "t"), train=False)


@pytest.mark.parametrize("seed", [0, 7])
def test_mnist_make_pairs_under_one_seed(seed):
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (20, 1, 6, 6)).astype(np.uint8)
    labels = rng.randint(0, 3, 20)
    tp, ts = tmnist.make_pairs(images, labels, 15, seed=seed)
    jp, js = jmnist.make_pairs(images, labels, 15, seed=seed)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    assert tp.shape == (15, 2, 6, 6) and set(ts) <= {0, 1}


# --- the converters and the mean image ------------------------------------

def _db_path(root, backend):
    return str(root / ("db.sndb" if backend == "sndb" else "db"))


@pytest.mark.parametrize("backend", ["sndb", "lmdb", "leveldb"])
@pytest.mark.parametrize("pairs", [0, 12])
def test_convert_mnist_writes_the_jax_db(tmp_path, backend, pairs):
    src = tmp_path / "mnist"
    tmnist.write_synthetic(str(src), n_train=40, n_test=8, seed=1)
    args = [str(src / tmnist.TRAIN_IMAGES), str(src / tmnist.TRAIN_LABELS)]
    extra = ["--backend", backend] + (["--pairs", str(pairs)] if pairs
                                      else [])
    for cli, d in ((jcli, "j"), (tcli, "t")):
        os.makedirs(tmp_path / d)
        assert cli.main(["convert_mnist"] + args
                        + [_db_path(tmp_path / d, backend)] + extra) == 0
    _same_tree(tmp_path / "j", tmp_path / "t")
    res = {}
    assert tcli.main(["convert_mnist"] + args
                     + [_db_path(tmp_path, backend)] + extra,
                     result=res) == 0
    assert res["records"] == (pairs or 40)


def _image_tree(root, n=6, size=(12, 12), gray=False, varied=False):
    """Square images: a record DB stores no shape, and the mean reads
    its records as square images (JAX ``data/source._record_shape``)."""
    rng = np.random.RandomState(0)
    root.mkdir()
    lines = []
    for i in range(n):
        w, h = (size[0] + i, size[1]) if varied else size
        arr = rng.randint(0, 256, (h, w) if gray else (h, w, 3), np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.png")
        lines.append(f"img_{i}.png {i % 3}")
    listfile = root.parent / "list.txt"
    listfile.write_text("\n".join(lines) + "\n")
    return str(root), str(listfile)


@pytest.mark.parametrize("backend", ["sndb", "lmdb", "leveldb"])
@pytest.mark.parametrize("flags", [
    [], ["--gray"], ["--shuffle", "--seed", "3"],
    ["--resize_width", "8", "--resize_height", "8"],
], ids=["plain", "gray", "shuffle", "resize"])
def test_convert_imageset_and_mean_write_the_jax_files(tmp_path, backend,
                                                       flags):
    root, listfile = _image_tree(tmp_path / "imgs")
    for cli, d in ((jcli, "j"), (tcli, "t")):
        os.makedirs(tmp_path / d / "out")
        db = _db_path(tmp_path / d / "out", backend)
        assert cli.main(["convert_imageset", root, listfile, db,
                         "--backend", backend] + flags) == 0
        ch = ["--channels", "1"] if "--gray" in flags else []
        assert cli.main(["compute_image_mean", db,
                         str(tmp_path / d / "out" / "mean.binaryproto")]
                        + ch) == 0
    _same_tree(tmp_path / "j", tmp_path / "t")
    res = {}
    db = _db_path(tmp_path / "t" / "out", backend)
    assert tcli.main(["compute_image_mean", db, str(tmp_path / "m.bp")]
                     + (["--channels", "1"] if "--gray" in flags else []),
                     result=res) == 0
    c = 1 if "--gray" in flags else 3
    hw = (8, 8) if "--resize_width" in flags else (12, 12)
    assert res["records"] == 6 and res["mean"].shape == (c,) + hw


def test_convert_imageset_check_size_and_refusals(tmp_path):
    root, listfile = _image_tree(tmp_path / "imgs", varied=True)
    for cli in (jcli, tcli):
        db = str(tmp_path / "x.sndb")
        assert cli.main(["convert_imageset", root, listfile, db,
                         "--check_size"]) == 1
        with pytest.raises(SystemExit, match="differing sizes"):
            cli.main(["convert_imageset", root, listfile, db])
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    assert tcli.main(["convert_imageset", root, str(empty),
                      str(tmp_path / "e.sndb")]) == 1
    os.makedirs(tmp_path / "notadb")
    assert tcli.main(["compute_image_mean", str(tmp_path / "notadb"),
                      str(tmp_path / "m")]) == 1


# --- parse_log ------------------------------------------------------------

_FLAT = """\
1.000: iter 10 smoothed_loss 2.3000
2.000: test output accuracy = 0.5000
2.000: test output loss = 1.2000
2.000: round 1, accuracy 0.5000
3.500: round 3 trained, smoothed_loss 1.9000
4.250, i = 3: something else
"""


def _parse_both(tmp_path, log):
    for cli, d in ((jcli, "j"), (tcli, "t")):
        os.makedirs(tmp_path / d)
        assert cli.main(["parse_log", log, "--out",
                         str(tmp_path / d / "out")]) == 0
    _same_tree(tmp_path / "j", tmp_path / "t")
    assert tparse.parse_log(log) == jparse.parse_log(log)
    return _files(tmp_path / "t")


def test_parse_log_flat_writes_the_jax_csvs(tmp_path):
    log = tmp_path / "training_log_1_x.txt"
    log.write_text(_FLAT)
    assert not tparse.is_jsonl_log(str(log))
    files = _parse_both(tmp_path, str(log))
    assert sorted(files) == ["out.test.csv", "out.train.csv"]
    train, test = tparse.parse_log(str(log))
    assert train[0] == {"seconds": 1.0, "round_or_iter": 10,
                        "smoothed_loss": 2.3}
    assert test[0] == {"seconds": 2.0, "accuracy": 0.5, "loss": 1.2,
                       "round": 1}


def test_parse_log_of_a_port_run_writes_the_jax_csvs(tmp_path, monkeypatch):
    """The flat log and the JSONL trace of a CPU ``cifar_app
    --trace_out`` run of the port parse to the JAX parser's CSVs."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.data import CifarLoader

    data = str(tmp_path / "cifar")
    CifarLoader.write_synthetic(data, num_train=200, num_test=20)
    logs = tmp_path / "logs"
    monkeypatch.setenv("SPARKNET_LOG_DIR", str(logs))
    trace = str(tmp_path / "run.trace.json")
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small nets under the parallel run's load
    try:
        assert cifar_app.main([
            "--device", "cpu", "--workers", "2", "--tau", "2", "--rounds",
            "2", "--batch", "10", "--test_every", "1", "--data", data,
            "--trace_out", trace]) == 0
    finally:
        torch.set_num_threads(n)
    jsonl = trace[: -len(".json")] + ".jsonl"
    assert tparse.is_jsonl_log(jsonl)
    (flat,) = [str(logs / f) for f in os.listdir(logs)
               if f.startswith("training_log_")]
    for log, kind in ((jsonl, "jsonl"), (flat, "flat")):
        files = _parse_both(tmp_path / kind, log)
        assert sorted(files) == ["out.test.csv", "out.train.csv"]
        train, test = tparse.parse_log(log)
        assert [r["round_or_iter"] for r in train] == [0, 1]
        assert all("accuracy" in r for r in test)


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if f.startswith("training_log_") and f.endswith(".txt")))
def test_parse_log_of_the_committed_logs(tmp_path, name):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _parse_both(tmp_path, os.path.join(repo, name))


# --- draw -----------------------------------------------------------------

@pytest.mark.parametrize("name", jmodels.available_models())
def test_net_to_dot_is_the_jax_text(name):
    jn, tn = jmodels.load_model(name), tmodels.load_model(name)
    for kw in ({}, {"phase": "TEST"}, {"phase": "TRAIN", "rankdir": "TB",
                                       "label_edges": False}):
        assert tdraw.net_to_dot(tn, **kw) == jdraw.net_to_dot(jn, **kw)


def test_committed_googlenet_dot_regenerates():
    path = os.path.join(os.path.dirname(tmodels.__file__), "zoo",
                        "googlenet.dot")
    text = tdraw.net_to_dot(tmodels.load_model("googlenet"), phase="TEST")
    assert open(path).read() == text


@pytest.mark.parametrize("flags", [[], ["--rankdir=TB", "--phase", "TEST"],
                                   ["--no_edge_labels"]])
def test_draw_net_cli_writes_the_jax_dot(tmp_path, flags):
    src = os.path.join(os.path.dirname(tmodels.__file__), "zoo",
                       "cifar10_full_train_test.prototxt")
    for cli, d in ((jcli, "j"), (tcli, "t")):
        os.makedirs(tmp_path / d)
        assert cli.main(["draw_net", src, str(tmp_path / d / "n.dot")]
                        + flags) == 0
    _same_tree(tmp_path / "j", tmp_path / "t")


# --- prepare_imagenet ------------------------------------------------------

def _make_class_tree(root, classes=3, per_class=4, size=(48, 40)):
    rng = np.random.RandomState(0)
    for c in range(classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            arr = rng.randint(0, 256, (size[1], size[0], 3), np.uint8)
            Image.fromarray(arr).save(d / f"c{c}_img_{i}.JPEG")


def _prep_both(tmp_path, argv):
    for prep, d in ((jprep, "j"), (tprep, "t")):
        assert prep.main([str(tmp_path / d)] + argv) == 0
    _same_tree(tmp_path / "j", tmp_path / "t", tars_by_member=True)
    return tmp_path / "t"


def test_prepare_dir_roundtrips_through_the_port_loader(tmp_path):
    src = tmp_path / "raw"
    _make_class_tree(src)
    out = _prep_both(tmp_path, ["--train_dir", str(src), "--val_dir",
                                str(src), "--num_train_chunks", "4",
                                "--num_val_chunks", "2", "--resize", "32",
                                "32"])
    loader = ImageNetLoader(str(out))
    shards = loader.list_shards("train")
    assert len(shards) == 4 and len(loader.list_shards("val")) == 2
    labels = loader.load_labels(str(out / "train.txt"))
    assert len(labels) == 12 and set(labels.values()) == {0, 1, 2}
    got = []
    for shard in shards:
        for data, label in loader.iter_shard(shard, labels):
            assert Image.open(io.BytesIO(data)).size == (32, 32)
            got.append(label)
    assert sorted(got) == sorted(labels.values())
    index = (out / "index.txt").read_text().split()
    assert "train.txt" in index and "val.txt" in index
    assert all(os.path.basename(s) in index for s in shards)


def test_chunking_is_seed_deterministic_and_round_robin():
    pairs = [(f"img{i}", i % 3) for i in range(10)]
    for seed in (7, 8):
        a = tprep.split_label_lines(pairs, 3, seed=seed)
        assert a == jprep.split_label_lines(pairs, 3, seed=seed)
        assert sorted(len(x) for x in a) == [3, 3, 4]
        assert sorted(p for ch in a for p in ch) == sorted(pairs)
    assert (tprep.split_label_lines(pairs, 3, seed=7)
            != tprep.split_label_lines(pairs, 3, seed=8))


def _nested_tar(tmp_path):
    rng = np.random.RandomState(1)
    outer_path = tmp_path / "train_nested.tar"
    with tarfile.open(outer_path, "w") as outer:
        for cls in ("n01", "n02"):
            sub = io.BytesIO()
            with tarfile.open(fileobj=sub, mode="w") as st:
                for i in range(3):
                    b = io.BytesIO()
                    Image.fromarray(rng.randint(0, 256, (24, 24, 3),
                                                np.uint8)).save(b, "JPEG")
                    info = tarfile.TarInfo(f"{cls}_img{i}.JPEG")
                    info.size = len(b.getvalue())
                    st.addfile(info, io.BytesIO(b.getvalue()))
            sub.seek(0)
            info = tarfile.TarInfo(f"{cls}.tar")
            info.size = len(sub.getvalue())
            outer.addfile(info, sub)
    labels = tmp_path / "train.txt"
    labels.write_text("".join(
        f"{cls}/{cls}_img{i}.JPEG {l}\n"
        for l, cls in enumerate(("n01", "n02")) for i in range(3)))
    return str(outer_path), str(labels)


def test_nested_tar_input_and_reader(tmp_path):
    tar, labels = _nested_tar(tmp_path)
    out = _prep_both(tmp_path, ["--train_tar", tar, "--train_labels",
                                labels, "--num_train_chunks", "2"])
    loader = ImageNetLoader(str(out))
    lab = loader.load_labels(str(out / "train.txt"))
    assert sum(1 for s in loader.list_shards("train")
               for _ in loader.iter_shard(s, lab)) == 6
    assert tprep.build_tar_index(tar) == jprep.build_tar_index(tar)
    read, jread = tprep.nested_tar_reader(tar), jprep.nested_tar_reader(tar)
    for name in ("n01/n01_img0.JPEG", "n02_img2.JPEG"):
        assert read(name) == jread(name)
    with pytest.raises(KeyError):
        read("n09/missing.JPEG")
    with pytest.raises(SystemExit, match="--train_labels is required"):
        tprep.main([str(tmp_path / "x"), "--train_tar", tar])


def test_worker_pool_writes_the_same_shards(tmp_path):
    src = tmp_path / "raw"
    _make_class_tree(src, classes=2, per_class=4)
    argv = ["--train_dir", str(src), "--num_train_chunks", "3",
            "--resize", "24", "24"]
    one = _prep_both(tmp_path / "w1", argv + ["--workers", "1"])
    # the pool forks: run it from a process that has not loaded JAX
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.prepare_imagenet",
         str(tmp_path / "w2"), *argv, "--workers", "2"],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _same_tree(one, tmp_path / "w2")


def test_upload_dry_run_and_refusals(tmp_path, capsys):
    src = tmp_path / "raw"
    _make_class_tree(src, classes=1, per_class=1)
    out = tmp_path / "prepared"
    assert tprep.main([str(out), "--train_dir", str(src),
                       "--num_train_chunks", "1", "--upload",
                       "gs://bucket/imagenet", "--dry-run"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"gsutil -m rsync -r {out} gs://bucket/imagenet")
    for dest in ("gs://b/p", "s3://b/p"):
        assert (tprep.upload_command(str(out), dest)
                == jprep.upload_command(str(out), dest))
    with pytest.raises(ValueError, match="unsupported"):
        tprep.upload_command(str(out), "ftp://x")
    assert tprep.main([str(tmp_path / "none")]) == 2
    dup = tmp_path / "dup"
    for c in range(2):
        (dup / f"cls{c}").mkdir(parents=True)
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
            dup / f"cls{c}" / "0001.JPEG")
    with pytest.raises(SystemExit, match="duplicate image basename"):
        tprep.main([str(tmp_path / "o"), "--train_dir", str(dup),
                    "--num_train_chunks", "1"])
