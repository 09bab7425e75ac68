"""Binary weight-file compatibility: ``.caffemodel`` and ``mean.binaryproto``.

The port's own copy of ``sparknet_tpu/io/caffemodel.py``.  Field numbers
vendored from the reference schema (``caffe/src/caffe/proto/
caffe.proto``): NetParameter.layer=100 (modern) and .layers=2 (V1
legacy), LayerParameter{name=1,type=2,blobs=7}, V1LayerParameter{name=4,
blobs=6}, V0LayerParameter{name=1,blobs=50} (nested as V1's layer=1),
BlobProto{shape=7,data=5,diff=6,num..width=1..4,double_data=8},
BlobShape.dim=1.

This gives the parity capabilities of ``Net::CopyTrainedLayersFrom`` /
``ToProto`` (net.cpp:805-981), ``save/loadWeightsToFile`` (ccaffe.cpp:
261-269) and the mean-image writer (ccaffe.cpp:83-97).  The bytes
written equal the JAX writer's for the same blobs.

``net_blobs`` and ``apply_blobs`` walk a net's ``layers`` and
``_blob_refs`` (``net.TorchNet``, ``models.transformer_lm``): the
former copies the live tensors to host arrays, the latter writes loaded
arrays onto each blob's own device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sparknet_tpu_torch.io import wire

Blobs = Dict[str, List[np.ndarray]]


# ---------------------------------------------------------------------------
# BlobProto
# ---------------------------------------------------------------------------


def encode_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    shape_msg = wire.field_packed_varints(1, arr.shape)  # BlobShape.dim
    return wire.field_bytes(7, shape_msg) + wire.field_packed_floats(
        5, arr.reshape(-1)
    )


def decode_blob(data) -> np.ndarray:
    """One BlobProto as a float32 array of its shape (the BlobShape, or
    the legacy num/channels/height/width)."""
    fields = wire.collect_fields(data)
    if 5 in fields:  # float data
        values = np.concatenate([wire.packed_floats(v) for v in fields[5]])
    elif 8 in fields:  # double_data -> float32
        values = np.concatenate(
            [wire.packed_doubles(v) for v in fields[8]]
        ).astype(np.float32)
    else:
        values = np.zeros(0, np.float32)
    if 7 in fields:  # BlobShape
        dims: List[int] = []
        for v in wire.collect_fields(fields[7][-1]).get(1, []):
            dims.extend(wire.packed_varints(v))
        shape = tuple(dims)
    else:  # legacy num/channels/height/width
        shape = tuple(int(fields.get(i, [0])[-1]) for i in (1, 2, 3, 4))
        if values.size and int(np.prod(shape)) != values.size:
            shape = (values.size,)
    if values.size == 0:
        if int(np.prod(shape)) != 0:
            raise ValueError(
                f"BlobProto has shape {shape} but no data values (neither "
                f"float data nor double_data present)"
            )
        return np.zeros(shape, np.float32)
    return values.reshape(shape)


# ---------------------------------------------------------------------------
# Weight files (.caffemodel: a NetParameter with per-layer blobs)
# ---------------------------------------------------------------------------


def save_weights(layer_blobs: Blobs, path: str, net_name: str = "net") -> None:
    """Write {layer_name: [blobs]} as a modern NetParameter binaryproto."""
    parts = [wire.field_string(1, net_name)]
    for lname, blobs in layer_blobs.items():
        layer_msg = wire.field_string(1, lname)
        for b in blobs:
            layer_msg += wire.field_bytes(7, encode_blob(b))
        parts.append(wire.field_bytes(100, layer_msg))
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def _name(msg_fields, field: int) -> str:
    return bytes(msg_fields.get(field, [b""])[-1]).decode("utf-8")


def load_weights(path: str) -> Blobs:
    """Read a .caffemodel (modern layer=100, V1 layers=2, or V0-era
    nested layers=2 -> layer=1) into {layer_name: [np arrays]}."""
    with open(path, "rb") as f:
        data = f.read()
    fields = wire.collect_fields(data)
    out: Blobs = {}
    for layer_msg in fields.get(100, []):  # modern LayerParameter
        lf = wire.collect_fields(layer_msg)
        blobs = [decode_blob(b) for b in lf.get(7, [])]
        if blobs:
            out[_name(lf, 1)] = blobs
    for layer_msg in fields.get(2, []):  # V1LayerParameter
        lf = wire.collect_fields(layer_msg)
        name = _name(lf, 4)
        blobs = [decode_blob(b) for b in lf.get(6, [])]
        if blobs:
            out[name] = blobs
        # V0-era connection: weights nest one level deeper
        # (V1LayerParameter.layer=1 -> V0LayerParameter{name=1 blobs=50})
        for v0_msg in lf.get(1, []):
            v0 = wire.collect_fields(v0_msg)
            v0_blobs = [decode_blob(b) for b in v0.get(50, [])]
            if v0_blobs:
                out[_name(v0, 1) or name] = v0_blobs
    return out


# ---------------------------------------------------------------------------
# Mean image (mean.binaryproto is a single BlobProto)
# ---------------------------------------------------------------------------


def save_mean_image(mean: np.ndarray, path: str) -> None:
    """Write the mean as one legacy-4D BlobProto (num 1)."""
    mean = np.asarray(mean, np.float32)
    if mean.ndim == 3:
        mean = mean[None]
    msg = b"".join(
        wire.field_varint(i + 1, d) for i, d in enumerate(mean.shape)
    ) + wire.field_packed_floats(5, mean.reshape(-1))
    with open(path, "wb") as f:
        f.write(msg)


def load_mean_image(path: str) -> np.ndarray:
    """The mean image of a ``.binaryproto`` ((C, H, W) when num is 1)."""
    with open(path, "rb") as f:
        blob = decode_blob(f.read())
    return blob[0] if blob.ndim == 4 and blob.shape[0] == 1 else blob


# ---------------------------------------------------------------------------
# Net glue: params/stats dicts <-> layer blob lists
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def net_blobs(net, params, stats) -> Blobs:
    """Merge a net's params+stats into reference blob order per layer
    (order follows the net's blob refs), as host arrays."""
    out: Blobs = {}
    for layer in net.layers:
        refs = net._blob_refs[layer.name]
        if not refs:
            continue
        out[layer.name] = [
            _host((params if ref.collection == "params" else stats)
                  [ref.owner][ref.index])
            for ref in refs
        ]
    return out


def _legacy_align(arr: np.ndarray, target: Tuple[int, ...]) -> Optional[np.ndarray]:
    """Right-align a legacy 4-D num/channels/height/width blob onto the
    net's (possibly lower-rank) shape — ``Blob::ShapeEquals``/``LegacyShape``
    semantics (blob.cpp:390-404): BVLC-era files store e.g. an IP weight as
    (1, 1, M, N) and a bias as (1, 1, 1, N). Accept when the trailing dims
    match and every leading dim is 1; return the reshaped array, else None."""
    if arr.ndim != 4 or len(target) > 4:
        return None
    pad = (1,) * (4 - len(target)) + tuple(target)
    if tuple(arr.shape) != pad:
        return None
    return arr.reshape(target)


def apply_blobs(
    net, params, stats, loaded: Blobs, strict: bool = False
) -> Tuple[dict, dict]:
    """Copy loaded blobs into matching layers by name+shape — the
    ``CopyTrainedLayersFrom`` semantics (net.cpp:805-851): unknown layer
    names are ignored, shape mismatches raise.  Returns new ``(params,
    stats)`` dicts; a loaded blob lands as a float32 tensor on the device
    of the blob it replaces, the others are kept as they are."""
    params = {k: list(v) for k, v in params.items()}
    stats = {k: list(v) for k, v in stats.items()}
    matched = 0
    for layer in net.layers:
        if layer.name not in loaded:
            continue
        refs = net._blob_refs[layer.name]
        blobs = loaded[layer.name]
        if len(blobs) != len(refs):
            raise ValueError(
                f"layer {layer.name!r}: file has {len(blobs)} blobs, net "
                f"expects {len(refs)}"
            )
        for ref, arr in zip(refs, blobs):
            coll = params if ref.collection == "params" else stats
            cur = coll[ref.owner][ref.index]
            arr = np.asarray(arr)
            if tuple(cur.shape) != tuple(arr.shape):
                aligned = _legacy_align(arr, tuple(cur.shape))
                if aligned is None:
                    raise ValueError(
                        f"layer {layer.name!r}: blob shape "
                        f"{tuple(arr.shape)} != {tuple(cur.shape)}"
                    )
                arr = aligned
            dev = cur.device if isinstance(cur, torch.Tensor) else "cpu"
            coll[ref.owner][ref.index] = torch.from_numpy(
                np.array(arr, np.float32)
            ).to(dev)
        matched += 1
    if strict and matched == 0:
        raise ValueError("no layers matched the weight file")
    return params, stats
