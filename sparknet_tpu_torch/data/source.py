"""Real-data resolution for the evaluation entry point (``cli test``).

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
3. synthetic random batches only as an explicit last resort
   (``allow_synthetic=True``), with a loud warning: scoring noise is not
   an evaluation.

The JAX module's HDF5Data, ImageData and WindowData sources are not yet
ported (they need the HDF5 data layer, ``data/transformer.py`` and
``data/windows.py``) and raise saying so.
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


# the JAX module's file-backed sources: (layer type, what they need)
_NOT_YET_PORTED = (
    ("HDF5Data", "the HDF5 data layer"),
    ("ImageData", "data/transformer.py"),
    ("WindowData", "data/windows.py"),
)


def _refuse_unported(netp, phase, types=None) -> None:
    for type_name, needs in _NOT_YET_PORTED:
        if types is not None and type_name not in types:
            continue
        if _phase_layer(netp, phase, type_name, lambda lp: True) is not None:
            raise NotImplementedError(
                f"a {type_name} source is not yet ported to sparknet_tpu_torch "
                f"(it needs {needs}); give --data a CIFAR directory, an "
                "LMDB, a LevelDB or a record DB"
            )


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
    if data and netp is not None and data.endswith((".h5", ".hdf5", ".txt")):
        # a net fed by HDF5Data routes .h5/listfile --data through it
        _refuse_unported(netp, phase, ("HDF5Data",))
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
    if netp is not None:
        _refuse_unported(netp, phase)
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
