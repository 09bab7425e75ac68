"""Generic proto2 binary codec for the config schema.

The port's own copy of ``sparknet_tpu/io/protobin.py``.  Closes the
binary leg of the legacy-upgrade tools
(``caffe/tools/upgrade_net_proto_binary.cpp``) and gives binary
NetParameter/SolverParameter I/O in general: ``decode(name, data)``
binds a serialized message onto the typed dataclass schema
(``config/schema.py``), ``encode(obj, name)`` writes it back, both
driven by the field-number tables in ``io/proto_fields.py`` (extracted
from the wire contract's field declarations; regenerate by re-parsing
``caffe.proto``'s ``label type name = number`` lines).

Codec rules:

- scalars by proto type: (u)int32/64 + bool -> varint; float ->
  fixed32; double -> fixed64; string/bytes -> length-delimited;
- enums decode to their NAME strings (the schema stores enum fields as
  strings — ``pool: MAX``), resolved ``Message.Enum`` first, then any
  enum with a matching leaf name;
- repeated numeric fields accept both packed and unpacked encodings and
  encode unpacked (proto2's default);
- V1 ``layers`` entries decode through the ``V1LayerParameter`` table
  into modern ``LayerParameter`` objects (its enum ``type`` becomes the
  V1 NAME string that ``config.prototext._upgrade_net`` already
  converts; its legacy string ``param`` becomes ``ParamSpec.name``);
- V0-era nets (nested ``layer`` connection messages inside ``layers``)
  decode to prototext token dicts and run the shared V0 upgrade
  (``UpgradeV0Net`` analog: padding-layer folding + per-field routing);
- layer ``blobs`` weights decode through the BlobProto schema and ride
  through the upgrade passes in place (upgrade_proto.cpp:21-80 copies
  them the same way);
- BlobProto ``double_data``/``double_diff`` (fields 8/9) fold into the
  float ``data``/``diff`` lists on read — the schema keeps one f32
  precision, so double-precision weight files load losslessly-enough
  instead of decoding to empty blobs (encode always writes float
  ``data``, like the reference's upgrade output).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional

from sparknet_tpu_torch.config import schema
from sparknet_tpu_torch.io import wire
from sparknet_tpu_torch.io.proto_fields import ENUMS, FIELDS

# proto message name -> schema class name (identical unless listed)
_SCHEMA_NAME = {"V1LayerParameter": "LayerParameter"}

_VARINT_TYPES = {"int32", "int64", "uint32", "uint64", "sint32", "sint64",
                 "bool"}


class ProtoBinError(ValueError):
    pass


def _enum_table(msg: str, ftype: str) -> Optional[Dict[int, str]]:
    if f"{msg}.{ftype}" in ENUMS:
        return ENUMS[f"{msg}.{ftype}"]
    if ftype in ENUMS:
        return ENUMS[ftype]
    for key, table in ENUMS.items():
        if key.endswith(f".{ftype}"):
            return table
    return None


def _schema_cls(proto_msg: str):
    return getattr(schema, _SCHEMA_NAME.get(proto_msg, proto_msg))


def _field_types(cls) -> Dict[str, Any]:
    return {f.name: f for f in dataclasses.fields(cls)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _scalar_from_wire(msg, ftype, wiretype, value):
    if ftype in _VARINT_TYPES:
        if ftype == "bool":
            return bool(value)
        v = int(value)
        if ftype in ("int32", "int64") and v >= 1 << 63:
            v -= 1 << 64  # negative two's-complement varint
        return v
    if ftype in ("float", "double"):
        return float(value)  # wire.iter_fields already unpacks fixed32/64
    if ftype == "string":
        return bytes(value).decode("utf-8")
    if ftype == "bytes":
        return bytes(value)
    table = _enum_table(msg, ftype)
    if table is not None:
        v = int(value)
        if v not in table:
            raise ProtoBinError(f"{msg}.{ftype}: unknown enum value {v}")
        return table[v]
    raise ProtoBinError(f"{msg}: unhandled scalar type {ftype!r}")


def _packed_scalars(msg, ftype, data) -> List[Any]:
    """A packed repeated numeric field — delegates to the shared wire
    helpers (numpy fast path for float/double)."""
    if ftype == "float":
        return [float(v) for v in wire.packed_floats(data, 2)]
    if ftype == "double":
        return [float(v) for v in wire.packed_doubles(data)]
    return [
        _scalar_from_wire(msg, ftype, 0, v)
        for v in wire.packed_varints(data)
    ]


def decode(proto_msg: str, data: bytes):
    """Serialized ``proto_msg`` bytes -> schema object."""
    if proto_msg not in FIELDS:
        raise ProtoBinError(f"no field table for message {proto_msg!r}")
    cls = _schema_cls(proto_msg)
    table = FIELDS[proto_msg]
    ftypes = _field_types(cls)
    obj = cls()
    for num, wiretype, value in wire.iter_fields(data):
        if num not in table:
            continue  # unknown field: proto2 readers skip
        name, label, ftype = table[num]
        if proto_msg == "V1LayerParameter" and name == "layer":
            raise ProtoBinError(
                "V0-era connection message outside a NetParameter "
                "context; decode the whole net via load_net_binary"
            )
        if proto_msg == "BlobProto" and name in (
            "double_data", "double_diff"
        ):
            # fold double-precision payloads into the f32 data/diff
            # lists (field 8 -> 5, 9 -> 6 semantics) rather than
            # silently dropping them
            name = "data" if name == "double_data" else "diff"
        if name not in ftypes:
            continue  # field with no schema counterpart
        # V1 'param' is the legacy share-name string list -> ParamSpec
        if proto_msg == "V1LayerParameter" and name == "param":
            obj.param = list(obj.param) + [
                schema.ParamSpec(name=bytes(value).decode("utf-8"))
            ]
            continue
        # the schema's shape decides repetition (the fork declares
        # JavaDataParameter.shape optional but one per top is stored)
        repeated = label == "repeated" or isinstance(
            getattr(obj, name), list
        )
        if ftype in FIELDS:  # nested message
            sub_msg = ftype
            if proto_msg == "NetParameter" and name == "layers":
                sub_msg = "V1LayerParameter"
            if sub_msg == "NetParameter" and net_needs_v0_upgrade(
                bytes(value)
            ):
                # V0-era net embedded in a solver: shared token upgrade
                sub = _load_v0_net(bytes(value))
            else:
                sub = decode(sub_msg, bytes(value))
            if repeated:
                getattr(obj, name).append(sub)
            else:
                setattr(obj, name, sub)
            continue
        if repeated:
            cur = getattr(obj, name)
            if cur is None:
                cur = []
                setattr(obj, name, cur)
            if wiretype == 2 and ftype not in ("string", "bytes"):
                cur.extend(_packed_scalars(proto_msg, ftype, value))
            else:
                cur.append(
                    _scalar_from_wire(proto_msg, ftype, wiretype, value)
                )
        else:
            setattr(
                obj,
                name,
                _scalar_from_wire(proto_msg, ftype, wiretype, value),
            )
    return obj


# ---------------------------------------------------------------------------
# V0-era nets: decode to prototext token dicts and reuse the V0 text
# upgrade (UpgradeV0Net analog; reference handles V0 *binary* nets the
# same way text ones are handled — upgrade_proto.cpp:21-80 runs on the
# parsed proto regardless of which reader produced it)
# ---------------------------------------------------------------------------

def net_needs_v0_upgrade(data: bytes) -> bool:
    """``NetNeedsV0ToV1Upgrade`` (upgrade_proto.cpp:82-89): any ``layers``
    entry carrying the nested V0 ``layer`` connection message."""
    for num, wiretype, value in wire.iter_fields(data):
        if num == 2 and wiretype == 2:  # NetParameter.layers
            for n2, w2, _ in wire.iter_fields(bytes(value)):
                if n2 == 1 and w2 == 2:  # V1LayerParameter.layer
                    return True
    return False


def _to_token(value, ftype: str) -> str:
    """A decoded scalar -> the text token form ``prototext._bind`` expects
    (strings carry the tokenizer's quote marker; enums/numbers are bare)."""
    if ftype == "bool":
        return "true" if value else "false"
    if ftype == "string":
        return "\0STR" + str(value)
    if ftype in ("float", "double"):
        return repr(float(value))
    if ftype in _VARINT_TYPES:
        return str(int(value))
    return str(value)  # enum NAME


def _decode_tokens(proto_msg: str, data: bytes) -> Dict[str, List[Any]]:
    """Serialized message -> prototext-style token dict
    ``{field: [tokens-or-subdicts...]}``; used for schema-less legacy
    messages (V0LayerParameter) that only exist to be upgraded."""
    table = FIELDS[proto_msg]
    out: Dict[str, List[Any]] = {}
    for num, wiretype, value in wire.iter_fields(data):
        if num not in table:
            continue
        name, label, ftype = table[num]
        if name == "blobs" and proto_msg in (
            "V0LayerParameter", "V1LayerParameter", "LayerParameter"
        ):
            # weight-carrying legacy net: decode the blobs through the
            # schema codec and carry them alongside the token dict —
            # the V0 upgrade preserves them in place exactly like the
            # reference (upgrade_proto.cpp:21-80 copies layer blobs
            # into the upgraded net)
            out.setdefault(_BLOBS_KEY, []).append(
                decode("BlobProto", bytes(value))
            )
            continue
        # V1 legacy share-name string -> ParamSpec.name (same rule as
        # decode(); V1 entries can sit next to V0 ones in one file)
        if proto_msg == "V1LayerParameter" and name == "param":
            out.setdefault("param", []).append(
                {"name": ["\0STR" + bytes(value).decode("utf-8")]}
            )
            continue
        if ftype in FIELDS:
            out.setdefault(name, []).append(
                _decode_tokens(ftype, bytes(value))
            )
            continue
        if wiretype == 2 and ftype not in ("string", "bytes"):
            vals = _packed_scalars(proto_msg, ftype, value)
        else:
            vals = [_scalar_from_wire(proto_msg, ftype, wiretype, value)]
        out.setdefault(name, []).extend(_to_token(v, ftype) for v in vals)
    return out


# non-field token-dict key carrying decoded BlobProto objects through
# the V0 token upgrade (popped before _bind, re-attached positionally)
_BLOBS_KEY = "\0blobs"


def _load_v0_net(data: bytes) -> schema.NetParameter:
    from sparknet_tpu_torch.config import prototext

    d = _decode_tokens("NetParameter", data)
    # lift weight blobs out before the token upgrades walk the dicts.
    # The upgrade can DROP layers (padding folds into the next conv) but
    # keeps surviving layers' names, so blobs re-attach by name.
    blobs_by_name: Dict[str, List[Any]] = {}
    for e in d.get("layers", []):
        if not isinstance(e, dict):
            continue
        inner = e.get("layer", [None])[0]  # V0 connection sub-message
        for holder in (e, inner):
            if not isinstance(holder, dict):
                continue
            blobs = holder.pop(_BLOBS_KEY, None)
            if not blobs:
                continue
            name_tok = (holder.get("name") or e.get("name") or [""])[0]
            name = str(name_tok).replace("\0STR", "", 1)
            if not name:
                raise ProtoBinError(
                    "V0 layer carries weight blobs but no name; cannot "
                    "re-attach after upgrade"
                )
            blobs_by_name.setdefault(name, []).extend(blobs)
    prototext._upgrade_v0_tokens(d)
    # token-level _merge_v1_param_multipliers: entries carrying BOTH
    # param share-names and blobs_lr merge them into the same ParamSpec
    # (must happen before _bind, whose _upgrade_net clears blobs_lr)
    for e in d.get("layers", []):
        if not (isinstance(e, dict) and e.get("param") and e.get("blobs_lr")):
            continue
        params, lrs = e["param"], e["blobs_lr"]
        wds = e.get("weight_decay", [])
        while len(params) < len(lrs):
            params.append({})
        for i, lr in enumerate(lrs):
            params[i]["lr_mult"] = [lr]
            if i < len(wds):
                params[i]["decay_mult"] = [wds[i]]
        e.pop("blobs_lr", None)
        e.pop("weight_decay", None)
    # _bind finishes with _upgrade_net (blobs_lr -> ParamSpec, V1 names)
    netp = prototext._bind(schema.NetParameter, d, permissive=False)
    if blobs_by_name:
        for lp in netp.layer:
            blobs = blobs_by_name.pop(lp.name, None)
            if blobs:
                lp.blobs = blobs
        if blobs_by_name:
            raise ProtoBinError(
                "V0 upgrade dropped weight-carrying layer(s): "
                + ", ".join(sorted(blobs_by_name))
            )
    return netp


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _scalar_to_wire(msg, ftype, num, value) -> bytes:
    if ftype in _VARINT_TYPES:
        v = int(value)
        if v < 0:
            v += 1 << 64
        return wire.field_varint(num, v)
    if ftype == "float":
        return wire.tag(num, 5) + struct.pack("<f", float(value))
    if ftype == "double":
        return wire.tag(num, 1) + struct.pack("<d", float(value))
    if ftype == "string":
        return wire.field_bytes(num, str(value).encode("utf-8"))
    if ftype == "bytes":
        return wire.field_bytes(num, bytes(value))
    table = _enum_table(msg, ftype)
    if table is not None:
        rev = {n: i for i, n in table.items()}
        key = str(value).upper()
        if key not in rev:
            raise ProtoBinError(
                f"{msg}.{ftype}: {value!r} is not one of {sorted(rev)}"
            )
        return wire.field_varint(num, rev[key])
    raise ProtoBinError(f"{msg}: unhandled scalar type {ftype!r}")


def encode(obj, proto_msg: str) -> bytes:
    """Schema object -> serialized ``proto_msg`` bytes (defaults and
    empty fields omitted, like the text printer)."""
    if proto_msg not in FIELDS:
        raise ProtoBinError(f"no field table for message {proto_msg!r}")
    cls = _schema_cls(proto_msg)
    defaults = cls()
    out = bytearray()
    ftypes = _field_types(cls)
    for num, (name, label, ftype) in sorted(FIELDS[proto_msg].items()):
        if name not in ftypes:
            continue
        value = getattr(obj, name)
        if proto_msg == "V1LayerParameter" and name == "param":
            continue  # modern param encoding only (field 100x is legacy)
        if proto_msg == "NetParameter" and name == "layers":
            continue  # always emit the modern 'layer' field
        if label == "repeated" or isinstance(value, list):
            for item in value or []:
                if ftype in FIELDS:
                    out += wire.field_bytes(num, encode(item, ftype))
                else:
                    out += _scalar_to_wire(proto_msg, ftype, num, item)
            continue
        if value is None or value == getattr(defaults, name):
            continue
        if ftype in FIELDS:
            out += wire.field_bytes(num, encode(value, ftype))
        else:
            out += _scalar_to_wire(proto_msg, ftype, num, value)
    return bytes(out)


# ---------------------------------------------------------------------------
# file-level API (the upgrade_net_proto_binary surface)
# ---------------------------------------------------------------------------

def _merge_v1_param_multipliers(net: schema.NetParameter) -> None:
    """V1 layers can carry BOTH legacy share-name strings (decoded into
    ``ParamSpec.name`` entries) and ``blobs_lr``/``weight_decay`` lists;
    the reference's UpgradeV1LayerParameter merges them into the same
    ParamSpec — do that before ``_upgrade_net`` (whose blobs_lr leg only
    fires when no param entries exist)."""
    for layer in list(net.layers) + list(net.layer):
        if not (layer.blobs_lr and layer.param):
            continue
        while len(layer.param) < len(layer.blobs_lr):
            layer.param.append(schema.ParamSpec())
        for i, lr in enumerate(layer.blobs_lr):
            layer.param[i].lr_mult = lr
            if i < len(layer.weight_decay):
                layer.param[i].decay_mult = layer.weight_decay[i]
        layer.blobs_lr = []
        layer.weight_decay = []


def load_net_binary(path: str) -> schema.NetParameter:
    """Binary NetParameter file -> upgraded modern schema object
    (V0-era nets route through the shared V0 token upgrade)."""
    from sparknet_tpu_torch.config.prototext import _upgrade_net

    with open(path, "rb") as f:
        data = f.read()
    if net_needs_v0_upgrade(data):
        return _load_v0_net(data)
    net = decode("NetParameter", data)
    _merge_v1_param_multipliers(net)
    _upgrade_net(net)
    return net


def save_net_binary(netp: schema.NetParameter, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode(netp, "NetParameter"))


def load_solver_binary(path: str) -> schema.SolverParameter:
    """Binary SolverParameter file -> upgraded modern schema object
    (embedded nets upgraded like ``load_net_binary``; legacy enum
    ``solver_type`` folded into string ``type``)."""
    from sparknet_tpu_torch.config.prototext import _upgrade_net
    from sparknet_tpu_torch.config.schema import solver_method

    with open(path, "rb") as f:
        sp = decode("SolverParameter", f.read())
    for net in (
        [sp.net_param, sp.train_net_param]
        + list(sp.test_net_param or [])
    ):
        if net is not None:
            _merge_v1_param_multipliers(net)
            _upgrade_net(net)
    if sp.solver_type is not None:
        sp.type = solver_method(sp)
        sp.solver_type = None
    return sp


def save_solver_binary(sp: schema.SolverParameter, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode(sp, "SolverParameter"))
