"""Minimal proto2 wire-format codec (varint / length-delimited / fixed32),
with numpy fast paths for packed float arrays.

The port's own copy of ``sparknet_tpu/io/wire.py``: the one wire codec
of the port, behind the reference's binary artifacts (``.caffemodel``
weight files and ``mean.binaryproto``, ``io/caffemodel.py``) without a
protobuf-codegen dependency — the binary contract is just field numbers
and wire types.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LEN = 2
WIRETYPE_FIXED32 = 5


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def encode_varint(value: int) -> bytes:
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


def tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def field_varint(field: int, value: int) -> bytes:
    return tag(field, WIRETYPE_VARINT) + encode_varint(int(value))


def field_bytes(field: int, data: bytes) -> bytes:
    return tag(field, WIRETYPE_LEN) + encode_varint(len(data)) + data


def field_string(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode("utf-8"))


def field_float(field: int, value: float) -> bytes:
    return tag(field, WIRETYPE_FIXED32) + struct.pack("<f", value)


def field_packed_floats(field: int, values: np.ndarray) -> bytes:
    data = np.ascontiguousarray(values, dtype="<f4").tobytes()
    return field_bytes(field, data)


def field_packed_varints(field: int, values) -> bytes:
    body = b"".join(encode_varint(int(v)) for v in values)
    return field_bytes(field, body)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def decode_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def iter_fields(data: Union[bytes, memoryview]) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). LEN fields yield memoryview."""
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = decode_varint(buf, pos)
        field, wire_type = key >> 3, key & 7
        if wire_type == WIRETYPE_VARINT:
            value, pos = decode_varint(buf, pos)
        elif wire_type == WIRETYPE_FIXED64:
            value = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire_type == WIRETYPE_FIXED32:
            value = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire_type == WIRETYPE_LEN:
            length, pos = decode_varint(buf, pos)
            value = buf[pos : pos + length]
            if len(value) != length:
                raise ValueError("truncated length-delimited field")
            pos += length
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value


def collect_fields(data) -> Dict[int, List[object]]:
    out: Dict[int, List[object]] = {}
    for field, _, value in iter_fields(data):
        out.setdefault(field, []).append(value)
    return out


def packed_floats(value, wire_type_hint=None) -> np.ndarray:
    """A packed (LEN) or repeated-unpacked float field -> float32 array."""
    if isinstance(value, (bytes, memoryview)):
        return np.frombuffer(value, dtype="<f4").copy()
    return np.asarray([value], dtype=np.float32)


def packed_doubles(value) -> np.ndarray:
    """A packed (LEN) or repeated-unpacked double field -> float64 array."""
    if isinstance(value, (bytes, memoryview)):
        return np.frombuffer(value, dtype="<f8").copy()
    return np.asarray([value], dtype=np.float64)


def packed_varints(value) -> List[int]:
    if isinstance(value, (bytes, memoryview)):
        out = []
        pos = 0
        buf = memoryview(value)
        while pos < len(buf):
            v, pos = decode_varint(buf, pos)
            out.append(v)
        return out
    return [int(value)]
