"""Real-data resolution for the evaluation entry points (``cli test``,
``apps/featurizer_app.py``).

The port's own copy of ``sparknet_tpu/data/source.py``.  The reference's
``caffe test`` scores whatever the net's data layers read (LMDB
sources in the prototxt); given a net and an optional ``--data``
argument, this resolves real stacked batches from

1. a CIFAR binary directory (``data_batch_*.bin`` / ``test_batch.bin``),
2. a Caffe LMDB or LevelDB (imported once into the record format,
   ``io/lmdb.py``, ``io/leveldb.py``), or a record-DB file — either
   named explicitly or found in the net's own ``Data`` layer
   ``data_param.source`` — with the layer's ``transform_param``
   (mean_file/mean_value, crop, scale, mirror) applied by
   ``runtime.DataPipeline``, as the engine's DataLayer+DataTransformer
   would,
3. the net's own file-backed source: an ``HDF5Data`` layer's ``.h5``
   files (or ``--data`` naming an ``.h5`` / listfile for such a net), a
   ``WindowData`` layer's window file (``data/windows.py``), an
   ``ImageData`` layer's listfile (``data/transformer.py``),
4. synthetic random batches only as an explicit last resort
   (``allow_synthetic=True``), with a loud warning: scoring noise is not
   an evaluation.

Each source gives the JAX module's batches for the same files and seed.
"""

from __future__ import annotations

import glob
import math
import os
import sys
from typing import Dict, Optional

import numpy as np


def synthetic_batches(net, iterations: int, seed: int = 0):
    """Random batches matching the net's feed shapes (labels in [0, 10))
    — the smoke-test generator shared with ``cli train``."""
    rng = np.random.RandomState(seed)
    out = {}
    for blob in net.feed_blobs:
        shape = net.blob_shapes[blob]
        if "label" in blob:
            out[blob] = rng.randint(
                0, 10, (iterations,) + tuple(shape)
            ).astype(np.float32)
        else:
            out[blob] = rng.randn(iterations, *shape).astype(np.float32)
    return out


def _cifar_batches(data_dir, net, iterations, phase, seed):
    from sparknet_tpu_torch.data.cifar import CifarLoader

    feed = net.feed_blobs
    batch = net.blob_shapes[feed[0]][0]
    loader = CifarLoader(data_dir, seed=seed)
    x, y = loader.minibatches(batch, train=(phase == "TRAIN"))
    if len(x) == 0:
        raise ValueError(f"no full minibatches of {batch} in {data_dir}")
    idx = [i % len(x) for i in range(iterations)]
    out = {feed[0]: np.stack([x[i] for i in idx])}
    if len(feed) > 1:
        out[feed[1]] = np.stack([y[i] for i in idx])
    return out


def _phase_layer(netp, phase, type_name, predicate):
    """First layer of ``type_name`` satisfying ``predicate`` in the
    phase's view (the NetState rule filtering of ``graph.filter_net``)."""
    from sparknet_tpu_torch.config.schema import NetState
    from sparknet_tpu_torch.graph import filter_net

    filtered = filter_net(netp, NetState(phase=phase.upper()))
    for lp in filtered.layer:
        if lp.type == type_name and predicate(lp):
            return lp
    return None


def _db_layer(netp, phase):
    """The phase's Data layer with a DB source."""
    return _phase_layer(
        netp, phase, "Data", lambda lp: lp.data_param and lp.data_param.source
    )


def _hdf5_layer(netp, phase):
    """The phase's HDF5Data layer (``hdf5_data_layer.cpp`` role)."""
    return _phase_layer(
        netp, phase, "HDF5Data", lambda lp: lp.hdf5_data_param is not None
    )


def _image_layer(netp, phase):
    """The phase's ImageData layer (``image_data_layer.cpp`` role)."""
    return _phase_layer(
        netp,
        phase,
        "ImageData",
        lambda lp: lp.image_data_param and lp.image_data_param.source,
    )


def _image_batches(lp, net, iterations, phase, seed):
    """Batches from an ImageData listfile: load + optional force-resize
    (new_height/new_width), shuffle when asked, then the standard
    DataTransformer (crop/mirror/mean/scale) — ``image_data_layer.cpp``
    load_batch semantics, cycled when iterations overrun the list."""
    from PIL import Image

    from sparknet_tpu_torch.data.transformer import DataTransformer
    from sparknet_tpu_torch.io import caffemodel

    p = lp.image_data_param
    entries = []
    with open(p.source) as f:
        for line in f:
            line = line.strip()
            if line:
                name, label = line.rsplit(None, 1)
                entries.append((name, int(label)))
    if not entries:
        raise ValueError(f"ImageData source {p.source!r} lists no images")
    if p.shuffle and phase == "TRAIN":
        np.random.RandomState(seed).shuffle(entries)
    if p.rand_skip:
        skip = np.random.RandomState(seed).randint(p.rand_skip)
        entries = entries[skip:] + entries[:skip]

    # the effective transform: the legacy ImageDataParameter copies
    # merged into transform_param's fields (the precedence
    # declared_shapes uses, so the served shape is the declared one)
    from sparknet_tpu_torch.config.schema import TransformationParameter

    tp = lp.transform_param or TransformationParameter()
    eff = TransformationParameter(
        crop_size=tp.crop_size or p.crop_size,
        mirror=bool(tp.mirror) or bool(p.mirror),
        scale=tp.scale if tp.scale != 1.0 else p.scale,
        mean_value=list(tp.mean_value),
    )
    mean = None
    if tp.mean_file:
        mean = caffemodel.load_mean_image(tp.mean_file)
    elif p.mean_file:  # legacy location on ImageDataParameter
        mean = caffemodel.load_mean_image(p.mean_file)
    transformer = DataTransformer(
        eff, phase=phase, mean_image=mean, seed=seed
    )

    if bool(p.new_height) != bool(p.new_width):
        # the reference CHECKs both-or-neither (image_data_layer.cpp)
        raise ValueError(
            "ImageData: new_height and new_width must be set together"
        )

    # decode lazily: only the entries the requested batches will touch
    # (real listfiles are tens of thousands of images; a short eval must
    # not decode them all).  Cache only when batches actually cycle —
    # otherwise each entry is touched once and caching is pure memory.
    batch = int(p.batch_size)
    n = len(entries)
    decoded = {}
    cache = iterations * batch > n

    def image(j):
        if j in decoded:
            return decoded[j]
        name, _ = entries[j]
        img = Image.open(os.path.join(p.root_folder, name))
        img = img.convert("RGB" if p.is_color else "L")
        if p.new_height and p.new_width:
            img = img.resize((p.new_width, p.new_height), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = np.ascontiguousarray(arr.transpose(2, 0, 1))
        if cache:
            decoded[j] = arr
        return arr

    tops = list(lp.top)
    xs, ys = [], []
    for i in range(iterations):
        idx = np.arange(i * batch, (i + 1) * batch) % n
        imgs = [image(j) for j in idx]
        shapes = {im.shape for im in imgs}
        if len(shapes) > 1:
            # variable-size images are fine when a crop unifies them
            # (the reference crops each cv::Mat individually); a mean
            # IMAGE cannot align to varying sizes, mean_value can
            if not eff.crop_size:
                raise ValueError(
                    f"ImageData source {p.source!r} mixes image sizes "
                    f"{shapes}; set new_height/new_width or a crop_size"
                )
            if mean is not None:
                raise ValueError(
                    "ImageData: mean_file needs uniform image sizes; "
                    "use mean_value or new_height/new_width"
                )
            xs.append(
                np.concatenate([transformer(im[None]) for im in imgs])
            )
        else:
            xs.append(transformer(np.stack(imgs)))
        ys.append(
            np.asarray([entries[j][1] for j in idx], np.float32)
        )
    out = {tops[0]: np.stack(xs)}
    if len(tops) > 1:
        out[tops[1]] = np.stack(ys)
    return out


def _window_layer(netp, phase):
    """The phase's WindowData layer (``window_data_layer.cpp`` role)."""
    return _phase_layer(
        netp,
        phase,
        "WindowData",
        lambda lp: lp.window_data_param and lp.window_data_param.source,
    )


def _window_batches(lp, net, iterations, phase, seed):
    from sparknet_tpu_torch.data.windows import (
        WindowSampler,
        effective_window_params,
    )

    crop, mirror, scale, mean_file, mean_value = effective_window_params(lp)
    mean = None
    if mean_file:
        from sparknet_tpu_torch.io import caffemodel

        mean = caffemodel.load_mean_image(mean_file)
    elif mean_value:
        mean = np.asarray(mean_value, np.float32)
    sampler = WindowSampler(
        lp.window_data_param,
        mean=mean,
        phase=phase,
        seed=seed,
        crop_size=crop,
        mirror=mirror,
        scale=scale,
    )
    xs, ys = [], []
    for _ in range(iterations):
        x, y = sampler.next_batch()
        xs.append(x)
        ys.append(y)
    # keyed by the layer's own tops, not feed_blobs order (another
    # host-fed layer may come first in the net)
    tops = list(lp.top)
    out = {tops[0]: np.stack(xs)}
    if len(tops) > 1:
        out[tops[1]] = np.stack(ys)
    return out


def _hdf5_batches(source, tops, shuffle, net, iterations, phase, seed):
    """Stacked batches from .h5 files whose datasets are named by the
    layer tops — concatenated across the listed files, shuffled for
    TRAIN when the layer asks (``HDF5DataLayer::Next`` semantics),
    cycled when iterations overrun the data."""
    import h5py

    from sparknet_tpu_torch.ops.data_layers import hdf5_source_files

    files = hdf5_source_files(source)
    if not files:
        raise ValueError(f"HDF5 source {source!r} lists no files")
    parts = {top: [] for top in tops}
    for fp in files:
        with h5py.File(fp, "r") as h:
            rows = None
            for top in tops:
                if top not in h:
                    raise KeyError(f"{fp} has no dataset {top!r}")
                arr = np.asarray(h[top])
                # the reference CHECKs this per file (LoadHDF5FileData)
                if rows is not None and len(arr) != rows:
                    raise ValueError(
                        f"{fp}: dataset {top!r} has {len(arr)} rows, "
                        f"{tops[0]!r} has {rows}"
                    )
                rows = len(arr)
                parts[top].append(arr)
    arrays = {
        top: np.concatenate(p) if len(p) > 1 else p[0]
        for top, p in parts.items()
    }
    n = len(arrays[tops[0]])
    # the batch of the layer actually being served, not feed_blobs[0]
    # (another host-fed layer may come first in the net)
    batch = net.blob_shapes[tops[0]][0]
    if n < batch:
        raise ValueError(f"HDF5 source has {n} rows < batch {batch}")
    order = np.arange(n)
    if shuffle and phase == "TRAIN":
        np.random.RandomState(seed).shuffle(order)
    idx = [
        np.arange(i * batch, (i + 1) * batch) % n for i in range(iterations)
    ]
    out = {}
    for top in tops:
        shuffled = arrays[top][order]
        out[top] = np.stack([shuffled[i].astype(np.float32) for i in idx])
    return out


def _record_shape(db_path, channels, h, w):
    """(C, H, W) of the stored records.  The net only knows the post-crop
    shape; cross-check against the DB's record size and fall back to a
    square stored image when they disagree (Datum records are a 1- or
    2-byte label + C*H*W image bytes)."""
    from sparknet_tpu_torch import runtime

    with runtime.RecordDB(db_path, "r") as db:
        if len(db) == 0:
            raise IOError(f"empty db {db_path}")
        total = len(db.read(0)[1])
    for label_w in (1, 2):
        nbytes = total - label_w
        if nbytes == channels * h * w:
            return channels, h, w
        side = math.isqrt(max(0, nbytes // channels))
        if side and channels * side * side == nbytes:
            return channels, side, side
    raise ValueError(
        f"db {db_path} records carry {total} bytes; neither "
        f"{channels}x{h}x{w} nor a square {channels}-channel image "
        "(with a 1- or 2-byte label)"
    )


def _db_batches(source, transform_param, net, iterations, phase, seed):
    from sparknet_tpu_torch import runtime
    from sparknet_tpu_torch.io import caffemodel, leveldb, lmdb

    if lmdb.is_lmdb(source):
        # a reference-created dataset (backend: LMDB): one-time import
        # into the record format, then the normal pipeline applies
        source = lmdb.lmdb_to_record_db(source)
    elif leveldb.is_leveldb(source):
        # backend: LEVELDB (Caffe's default) — the same one-time import
        source = leveldb.leveldb_to_record_db(source)

    feed = net.feed_blobs
    shape = net.blob_shapes[feed[0]]
    batch, (c, h, w) = shape[0], tuple(shape[1:])
    tp = transform_param
    crop = int(tp.crop_size) if tp is not None else 0
    mean = None
    if tp is not None and tp.mean_file:
        mean = caffemodel.load_mean_image(tp.mean_file)
    elif tp is not None and tp.mean_value:
        mean = np.asarray(tp.mean_value, np.float32)
    # with a crop the stored records are pre-crop: infer from the DB
    rec_shape = _record_shape(source, c, 0, 0) if crop else \
        _record_shape(source, c, h, w)
    pipe = runtime.DataPipeline(
        source,
        batch_size=batch,
        shape=rec_shape,
        crop=crop,
        mirror=bool(tp.mirror) if tp is not None else False,
        train=(phase == "TRAIN"),
        scale=float(tp.scale) if tp is not None else 1.0,
        mean=mean,
        seed=seed,
    )
    try:
        xs, ys = [], []
        for _ in range(iterations):
            x, y = pipe.next()
            xs.append(x)
            ys.append(y)
    finally:
        pipe.close()
    out = {feed[0]: np.stack(xs)}
    if len(feed) > 1:
        out[feed[1]] = np.stack(ys).astype(np.float32)
    return out


def resolve_batches(
    net,
    netp,
    data: Optional[str],
    iterations: int,
    phase: str = "TEST",
    seed: int = 0,
    allow_synthetic: bool = False,
) -> Dict[str, np.ndarray]:
    """Stacked real batches {feed_blob: (iterations, batch, ...)} for
    ``net`` — see the module docstring for the source precedence."""
    db_lp = _db_layer(netp, phase) if netp is not None else None
    tp = db_lp.transform_param if db_lp is not None else None
    h5_lp = _hdf5_layer(netp, phase) if netp is not None else None
    if data and h5_lp is not None and data.endswith((".h5", ".hdf5", ".txt")):
        # a net fed by HDF5Data routes .h5/listfile --data through it
        return _hdf5_batches(data, list(h5_lp.top),
                             bool(h5_lp.hdf5_data_param.shuffle), net,
                             iterations, phase, seed)
    if data:
        if os.path.isdir(data):
            from sparknet_tpu_torch.io import leveldb, lmdb

            if lmdb.is_lmdb(data) or leveldb.is_leveldb(data):
                return _db_batches(data, tp, net, iterations, phase, seed)
            has_cifar = glob.glob(
                os.path.join(data, "data_batch_*.bin")
            ) or os.path.exists(os.path.join(data, "test_batch.bin"))
            if not has_cifar:
                raise ValueError(
                    f"--data={data!r} is a directory without CIFAR binary "
                    "batches (data_batch_*.bin / test_batch.bin) and not an "
                    "LMDB or LevelDB; supported forms: a CIFAR binary dir, "
                    "a Caffe LMDB or LevelDB, a record-DB file path, or a "
                    "net with data_param.source"
                )
            return _cifar_batches(data, net, iterations, phase, seed)
        if os.path.exists(data):
            # an explicit DB file: still honour the net's transform_param
            # so eval preprocessing matches training
            return _db_batches(data, tp, net, iterations, phase, seed)
        raise FileNotFoundError(data)
    if db_lp is not None:
        return _db_batches(db_lp.data_param.source, tp, net, iterations,
                           phase, seed)
    if h5_lp is not None and h5_lp.hdf5_data_param.source:
        return _hdf5_batches(h5_lp.hdf5_data_param.source, list(h5_lp.top),
                             bool(h5_lp.hdf5_data_param.shuffle), net,
                             iterations, phase, seed)
    win_lp = _window_layer(netp, phase) if netp is not None else None
    if win_lp is not None:
        return _window_batches(win_lp, net, iterations, phase, seed)
    img_lp = _image_layer(netp, phase) if netp is not None else None
    if img_lp is not None:
        return _image_batches(img_lp, net, iterations, phase, seed)
    if not allow_synthetic:
        raise ValueError(
            "no data source: pass --data=DIR|DB or give the net a Data "
            "layer with data_param.source"
        )
    print(
        "WARNING: no data source — scoring SYNTHETIC random batches "
        "(pass --data for a real evaluation)",
        file=sys.stderr,
    )
    return synthetic_batches(net, iterations, seed)
