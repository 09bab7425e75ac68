"""``mean.binaryproto``: the mean image as one Caffe ``BlobProto``.

The port's own copy of ``save_mean_image`` / ``load_mean_image`` of
``sparknet_tpu/io/caffemodel.py`` (reference: ``ComputeMean
.writeMeanToBinaryProto``, ``ccaffe.cpp:83-97``), with the few proto2
wire-format pieces of ``sparknet_tpu/io/wire.py`` they need: varints,
length-delimited fields and packed floats.  BlobProto field numbers
(``caffe.proto``): num, channels, height, width = 1..4, data = 5
(packed float), shape = 7 (BlobShape, dim = 1), double_data = 8.  The
bytes written equal the JAX writer's.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint((field << 3) | _VARINT) + _varint(int(value))


def _field_packed_floats(field: int, values: np.ndarray) -> bytes:
    data = np.ascontiguousarray(values, dtype="<f4").tobytes()
    return _varint((field << 3) | _LEN) + _varint(len(data)) + data


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _fields(data) -> Dict[int, List[object]]:
    """``{field number: [value, ...]}`` of one message; LEN values are
    memoryviews."""
    buf = memoryview(data)
    pos, out = 0, {}
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _FIXED64:
            value = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == _FIXED32:
            value = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == _LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            if len(value) != length:
                raise ValueError("truncated length-delimited field")
            pos += length
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(value)
    return out


def _floats(values, dtype: str) -> np.ndarray:
    """A packed (LEN) or unpacked repeated float field as an array."""
    parts = [np.frombuffer(v, dtype=dtype) if isinstance(v, memoryview)
             else np.asarray([v], dtype=dtype) for v in values]
    return np.concatenate(parts).astype(np.float32)


def decode_blob(data) -> np.ndarray:
    """One BlobProto as a float32 array of its shape (the BlobShape, or
    the legacy num/channels/height/width)."""
    f = _fields(data)
    if 5 in f:
        values = _floats(f[5], "<f4")
    elif 8 in f:
        values = _floats(f[8], "<f8")
    else:
        values = np.zeros(0, np.float32)
    if 7 in f:
        dims: List[int] = []
        for v in _fields(f[7][-1]).get(1, []):
            if isinstance(v, memoryview):
                pos = 0
                while pos < len(v):
                    d, pos = _read_varint(v, pos)
                    dims.append(d)
            else:
                dims.append(int(v))
        shape = tuple(dims)
    else:
        shape = tuple(int(f.get(i, [0])[-1]) for i in (1, 2, 3, 4))
        if values.size and int(np.prod(shape)) != values.size:
            shape = (values.size,)
    if int(np.prod(shape)) != values.size:
        raise ValueError(
            f"BlobProto has shape {shape} but {values.size} data values"
        )
    return values.reshape(shape)


def save_mean_image(mean: np.ndarray, path: str) -> None:
    """Write the mean as one legacy-4D BlobProto (num 1)."""
    mean = np.asarray(mean, np.float32)
    if mean.ndim == 3:
        mean = mean[None]
    msg = b"".join(_field_varint(i + 1, d) for i, d in enumerate(mean.shape))
    msg += _field_packed_floats(5, mean.reshape(-1))
    with open(path, "wb") as f:
        f.write(msg)


def load_mean_image(path: str) -> np.ndarray:
    """The mean image of a ``.binaryproto`` ((C, H, W) when num is 1)."""
    with open(path, "rb") as f:
        blob = decode_blob(f.read())
    return blob[0] if blob.ndim == 4 and blob.shape[0] == 1 else blob
