"""Proto2 text-format parser bound to the dataclass schema.

The port's own copy of the parser half of
``sparknet_tpu/config/prototext.py``.  The grammar is the subset of
proto2 text format the reference's configs use::

    message   := field*
    field     := ident ':' scalar | ident [':'] '{' message '}'
    scalar    := number | 'true' | 'false' | quoted-string | ENUM_IDENT

Repeated fields accumulate across occurrences.  Unknown fields raise
(catches typos) unless ``permissive=True``.  ``dumps`` is the printer
(its output round-trips through ``parse``: a net built in Python is
written as a file a solver names).  A legacy net upgrades as it binds
(reference: ``caffe/src/caffe/util/upgrade_proto.cpp``): the V0 leg
(``_upgrade_v0_tokens``: padding layers folded into their consumer, each
flat V0 field routed into its modern sub-message) runs on the token
dicts before binding, the V1 leg (``_upgrade_net``: ``layers`` into
``layer``, enum type names into strings, ``blobs_lr``/``weight_decay``
into ``ParamSpec``) on the bound ``NetParameter`` at any depth.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Tuple, Type

from sparknet_tpu_torch.config import schema
from sparknet_tpu_torch.config.schema import Message

__all__ = ["dumps", "parse", "parse_file", "ParseError"]


class ParseError(ValueError):
    pass


_PUNCT = {"{", "}", ":", "<", ">"}
_CLOSER = {"{": "}", "<": ">"}


def _tokenize(text: str):
    """Yield (token, line) pairs."""
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r,;":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in _PUNCT:
            yield c, line
            i += 1
        elif c in "\"'":
            quote, j, buf = c, i + 1, []
            while j < n and text[j] != quote:
                if text[j] == "\\" and j + 1 < n:
                    esc = text[j + 1]
                    buf.append(
                        {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "'": "'"}.get(
                            esc, esc
                        )
                    )
                    j += 2
                else:
                    buf.append(text[j])
                    j += 1
            if j >= n:
                raise ParseError(f"line {line}: unterminated string")
            yield ("\0STR" + "".join(buf)), line
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in " \t\r\n,;:{}<>#\"'":
                j += 1
            yield text[i:j], line
            i = j
    yield None, line


def _parse_tokens(tokens, closer: str = "") -> Dict[str, List[Any]]:
    """Parse a message body into {field: [values...]}; values are scalars
    (str) or nested dicts.  ``closer`` is the expected closing token
    (empty at top level)."""
    out: Dict[str, List[Any]] = {}
    while True:
        tok, line = next(tokens)
        if tok is None:
            if closer:
                raise ParseError(f"line {line}: unexpected end of input")
            return out
        if tok in ("}", ">"):
            if tok != closer:
                raise ParseError(f"line {line}: unmatched '{tok}'")
            return out
        if tok in _PUNCT:
            raise ParseError(f"line {line}: expected field name, got {tok!r}")
        name = tok
        tok2, line2 = next(tokens)
        if tok2 == ":":
            tok3, line3 = next(tokens)
            if tok3 in ("{", "<"):
                value: Any = _parse_tokens(tokens, _CLOSER[tok3])
            elif tok3 is None or tok3 in _PUNCT:
                raise ParseError(f"line {line3}: expected value for '{name}'")
            else:
                value = tok3
        elif tok2 in ("{", "<"):
            value = _parse_tokens(tokens, _CLOSER[tok2])
        else:
            raise ParseError(f"line {line2}: expected ':' or '{{' after '{name}'")
        out.setdefault(name, []).append(value)


def _field_types(cls: Type[Message]) -> Dict[str, Tuple[str, Any]]:
    """Field name -> (kind, inner type); kind in {scalar, list, msg,
    msglist}."""
    hints = typing.get_type_hints(cls)
    out = {}
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        origin = typing.get_origin(t)
        if origin is list or origin is List:
            (inner,) = typing.get_args(t)
            if isinstance(inner, type) and issubclass(inner, Message):
                out[f.name] = ("msglist", inner)
            else:
                out[f.name] = ("list", inner)
        elif origin is typing.Union:  # Optional[X]
            inner = [a for a in typing.get_args(t) if a is not type(None)][0]
            if isinstance(inner, type) and issubclass(inner, Message):
                out[f.name] = ("msg", inner)
            else:
                out[f.name] = ("scalar", inner)
        elif isinstance(t, type) and issubclass(t, Message):
            out[f.name] = ("msg", t)
        else:
            out[f.name] = ("scalar", t)
    return out


_TYPE_CACHE: Dict[type, Dict[str, Tuple[str, Any]]] = {}


def _coerce(raw: str, target: Any, where: str):
    if isinstance(raw, dict):
        raise ParseError(f"{where}: expected scalar, got message")
    is_str = raw.startswith("\0STR")
    sval = raw[4:] if is_str else raw
    if target is str:
        return sval
    raw = sval
    if target is bool:
        low = raw.lower()
        if low in ("true", "1"):
            return True
        if low in ("false", "0"):
            return False
        raise ParseError(f"{where}: bad bool {raw!r}")
    if target is int:
        try:
            return int(raw, 0)
        except ValueError:
            try:
                fv = float(raw)
            except ValueError:
                raise ParseError(f"{where}: bad int {raw!r}") from None
            if fv != int(fv):
                raise ParseError(f"{where}: bad int {raw!r}")
            return int(fv)
    if target is float:
        try:
            return float(raw)
        except ValueError:
            raise ParseError(f"{where}: bad float {raw!r}") from None
    return sval


def _bind(cls: Type[Message], d: Dict[str, List[Any]], permissive: bool) -> Message:
    if cls not in _TYPE_CACHE:
        _TYPE_CACHE[cls] = _field_types(cls)
    ftypes = _TYPE_CACHE[cls]
    kwargs: Dict[str, Any] = {}
    for name, values in d.items():
        if name not in ftypes:
            if permissive:
                continue
            raise ParseError(f"unknown field '{name}' in {cls.__name__}")
        kind, inner = ftypes[name]
        where = f"{cls.__name__}.{name}"
        if kind == "scalar":
            kwargs[name] = _coerce(values[-1], inner, where)
        elif kind == "list":
            kwargs[name] = [_coerce(v, inner, where) for v in values]
        elif kind == "msg":
            # proto2 TextFormat merges repeated occurrences of a singular
            # message field rather than taking the last one
            merged: Dict[str, List[Any]] = {}
            for v in values:
                if not isinstance(v, dict):
                    raise ParseError(f"{where}: expected message")
                for k, vs in v.items():
                    merged.setdefault(k, []).extend(vs)
            kwargs[name] = _bind(inner, merged, permissive)
        else:  # msglist
            items = []
            for v in values:
                if not isinstance(v, dict):
                    raise ParseError(f"{where}: expected message")
                items.append(_bind(inner, v, permissive))
            kwargs[name] = items
    msg = cls(**kwargs)
    if isinstance(msg, schema.NetParameter):
        _upgrade_net(msg)
    return msg


# V1LayerParameter_LayerType enum name -> modern type string
# (reference: upgrade_proto.cpp:852-936 UpgradeV1LayerType)
_V1_LAYER_TYPES = {
    "ABSVAL": "AbsVal",
    "ACCURACY": "Accuracy",
    "ARGMAX": "ArgMax",
    "BNLL": "BNLL",
    "CONCAT": "Concat",
    "CONTRASTIVE_LOSS": "ContrastiveLoss",
    "CONVOLUTION": "Convolution",
    "DECONVOLUTION": "Deconvolution",
    "DATA": "Data",
    "DROPOUT": "Dropout",
    "DUMMY_DATA": "DummyData",
    "EUCLIDEAN_LOSS": "EuclideanLoss",
    "ELTWISE": "Eltwise",
    "EXP": "Exp",
    "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data",
    "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss",
    "IM2COL": "Im2col",
    "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss",
    "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN",
    "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss",
    "MVN": "MVN",
    "POOLING": "Pooling",
    "POWER": "Power",
    "RELU": "ReLU",
    "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence",
    "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "SPLIT": "Split",
    "SLICE": "Slice",
    "TANH": "TanH",
    "WINDOW_DATA": "WindowData",
    "THRESHOLD": "Threshold",
    "JAVA_DATA": "JavaData",
}


def _upgrade_net(net: "schema.NetParameter") -> None:
    """Fold legacy V1 constructs into the modern schema, at any nesting depth
    (reference: ``caffe/src/caffe/util/upgrade_proto.cpp``)."""
    if net.layers:
        net.layer = list(net.layers) + list(net.layer)
        net.layers = []
    for layer in net.layer:
        # V1 enum type names (CONVOLUTION, SOFTMAX_LOSS, ...) -> modern strings
        if layer.type in _V1_LAYER_TYPES:
            layer.type = _V1_LAYER_TYPES[layer.type]
        # V1 per-blob multipliers: blobs_lr -> ParamSpec.lr_mult,
        # weight_decay -> ParamSpec.decay_mult
        if layer.blobs_lr and not layer.param:
            layer.param = [
                schema.ParamSpec(
                    lr_mult=lr,
                    decay_mult=(
                        layer.weight_decay[i]
                        if i < len(layer.weight_decay)
                        else 1.0
                    ),
                )
                for i, lr in enumerate(layer.blobs_lr)
            ]
        layer.blobs_lr = []
        layer.weight_decay = []


# ---------------------------------------------------------------------------
# V0 upgrade (reference: upgrade_proto.cpp:96-529 UpgradeV0Net /
# UpgradeV0LayerParameter / UpgradeV0LayerType).  A V0 net wraps each
# layer in a connection: ``layers { layer { <flat fields> } bottom top }``
# with lowercase short type names and per-type flat fields; the upgrade
# routes each flat field into the modern per-type sub-message.  Runs on
# the raw token dicts (before schema binding, where the V0-only fields
# would be unknown); the V1 leg (_upgrade_net) then finishes blobs_lr ->
# ParamSpec.
# ---------------------------------------------------------------------------

_V0_LAYER_TYPES = {
    "accuracy": "Accuracy", "bnll": "BNLL", "concat": "Concat",
    "conv": "Convolution", "data": "Data", "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss", "flatten": "Flatten",
    "hdf5_data": "HDF5Data", "hdf5_output": "HDF5Output",
    "im2col": "Im2col", "images": "ImageData",
    "infogain_loss": "InfogainLoss", "innerproduct": "InnerProduct",
    "lrn": "LRN", "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling", "relu": "ReLU", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softmax_loss": "SoftmaxWithLoss",
    "split": "Split", "tanh": "TanH", "window_data": "WindowData",
}

# (v0_field, v0_type) -> (sub_message, field) routing; None sub = layer
# level.  Mirrors the if-ladders of UpgradeV0LayerParameter.
_V0_ROUTES = {
    ("num_output", "conv"): ("convolution_param", "num_output"),
    ("num_output", "innerproduct"): ("inner_product_param", "num_output"),
    ("biasterm", "conv"): ("convolution_param", "bias_term"),
    ("biasterm", "innerproduct"): ("inner_product_param", "bias_term"),
    ("weight_filler", "conv"): ("convolution_param", "weight_filler"),
    ("weight_filler", "innerproduct"): ("inner_product_param", "weight_filler"),
    ("bias_filler", "conv"): ("convolution_param", "bias_filler"),
    ("bias_filler", "innerproduct"): ("inner_product_param", "bias_filler"),
    ("pad", "conv"): ("convolution_param", "pad"),
    ("pad", "pool"): ("pooling_param", "pad"),
    ("kernelsize", "conv"): ("convolution_param", "kernel_size"),
    ("kernelsize", "pool"): ("pooling_param", "kernel_size"),
    ("group", "conv"): ("convolution_param", "group"),
    ("stride", "conv"): ("convolution_param", "stride"),
    ("stride", "pool"): ("pooling_param", "stride"),
    ("pool", "pool"): ("pooling_param", "pool"),
    ("dropout_ratio", "dropout"): ("dropout_param", "dropout_ratio"),
    ("local_size", "lrn"): ("lrn_param", "local_size"),
    ("alpha", "lrn"): ("lrn_param", "alpha"),
    ("beta", "lrn"): ("lrn_param", "beta"),
    ("k", "lrn"): ("lrn_param", "k"),
    ("source", "data"): ("data_param", "source"),
    ("source", "hdf5_data"): ("hdf5_data_param", "source"),
    ("source", "images"): ("image_data_param", "source"),
    ("source", "window_data"): ("window_data_param", "source"),
    ("source", "infogain_loss"): ("infogain_loss_param", "source"),
    ("batchsize", "data"): ("data_param", "batch_size"),
    ("batchsize", "hdf5_data"): ("hdf5_data_param", "batch_size"),
    ("batchsize", "images"): ("image_data_param", "batch_size"),
    ("batchsize", "window_data"): ("window_data_param", "batch_size"),
    ("rand_skip", "data"): ("data_param", "rand_skip"),
    ("rand_skip", "images"): ("image_data_param", "rand_skip"),
    ("shuffle_images", "images"): ("image_data_param", "shuffle"),
    ("new_height", "images"): ("image_data_param", "new_height"),
    ("new_width", "images"): ("image_data_param", "new_width"),
    ("concat_dim", "concat"): ("concat_param", "concat_dim"),
    # data transformations (UpgradeNetDataTransformation folds these into
    # transform_param for every data-ish type)
    ("scale", "data"): ("transform_param", "scale"),
    ("scale", "images"): ("transform_param", "scale"),
    ("scale", "window_data"): ("transform_param", "scale"),
    ("meanfile", "data"): ("transform_param", "mean_file"),
    ("meanfile", "images"): ("transform_param", "mean_file"),
    ("meanfile", "window_data"): ("transform_param", "mean_file"),
    ("cropsize", "data"): ("transform_param", "crop_size"),
    ("cropsize", "images"): ("transform_param", "crop_size"),
    ("cropsize", "window_data"): ("transform_param", "crop_size"),
    ("mirror", "data"): ("transform_param", "mirror"),
    ("mirror", "images"): ("transform_param", "mirror"),
    ("mirror", "window_data"): ("transform_param", "mirror"),
    # R-CNN-era detection fields (upgrade_proto.cpp:382-412)
    ("det_fg_threshold", "window_data"): ("window_data_param", "fg_threshold"),
    ("det_bg_threshold", "window_data"): ("window_data_param", "bg_threshold"),
    ("det_fg_fraction", "window_data"): ("window_data_param", "fg_fraction"),
    ("det_context_pad", "window_data"): ("window_data_param", "context_pad"),
    ("det_crop_mode", "window_data"): ("window_data_param", "crop_mode"),
}


def _tok_str(tok: Any) -> str:
    s = str(tok)
    return s[4:] if s.startswith("\0STR") else s


def _v0_type(entry: Dict[str, List[Any]]) -> str:
    inner = entry["layer"][0]
    return _tok_str(inner.get("type", [""])[0])


def _fold_v0_padding(d: Dict[str, List[Any]]) -> None:
    """Merge V0 ``padding`` layers into the following conv/pool layer
    (reference: ``UpgradeV0PaddingLayers``, upgrade_proto.cpp:120-178):
    the padding layer disappears, its ``pad`` lands on the consumer, and
    the consumer's bottom is rewired to the padding layer's input."""
    entries = d.get("layers") or []
    if not any(isinstance(e, dict) and "layer" in e for e in entries):
        return
    blob_src: Dict[str, Any] = {
        _tok_str(t): None for t in d.get("input", [])
    }
    kept = []
    for e in entries:
        is_v0 = isinstance(e, dict) and "layer" in e
        if not (is_v0 and _v0_type(e) == "padding"):
            kept.append(e)
        for j, b in enumerate(e.get("bottom", []) if isinstance(e, dict) else []):
            bname = _tok_str(b)
            if bname not in blob_src:
                # the reference LOG(FATAL)s on unknown inputs
                # (upgrade_proto.cpp:142-144) because every blob there
                # must come from a layer or net input; here externally-fed
                # blobs (feed_shapes / replaceDataLayers flow) are
                # legitimate.  Safe for the fold: a deleted padding
                # layer's top is always registered in blob_src, so an
                # unknown bottom can never dangle on one.
                continue
            src = blob_src[bname]
            if not (isinstance(src, dict) and "layer" in src
                    and _v0_type(src) == "padding"):
                continue
            # the reference declares these geometries undefined and
            # CHECK-fails (upgrade_proto.cpp:152-163): consumer must be a
            # single-bottom conv/pool; padding must be 1-bottom/1-top
            if not (is_v0 and _v0_type(e) in ("conv", "pool")):
                raise ValueError(
                    "V0 padding layer feeds a non-conv/pool layer "
                    f"({_v0_type(e) if is_v0 else 'V1'}) — undefined in "
                    "the reference upgrade (upgrade_proto.cpp:152-155)"
                )
            if len(e.get("bottom", [])) != 1:
                raise ValueError(
                    "V0 padding-fed conv/pool layer must take a single "
                    "bottom (upgrade_proto.cpp:156-157)"
                )
            if len(src.get("bottom", [])) != 1 or len(src.get("top", [])) != 1:
                raise ValueError(
                    "V0 padding layer must have one bottom and one top "
                    "(upgrade_proto.cpp:158-163)"
                )
            e["layer"][0]["pad"] = list(src["layer"][0].get("pad", ["0"]))
            e["bottom"][j] = src["bottom"][0]
        if isinstance(e, dict):
            for t in e.get("top", []):
                blob_src[_tok_str(t)] = e
    d["layers"] = kept


def _upgrade_v0_entry(entry: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
    """One V0 ``layers { layer {...} bottom top }`` connection -> a modern
    layer token dict."""
    inner = entry["layer"][0]
    out: Dict[str, List[Any]] = {}
    for key in ("bottom", "top"):
        if key in entry:
            out[key] = list(entry[key])
    v0_type = str(inner.get("type", [""])[0])
    if v0_type.startswith("\0STR"):
        v0_type = v0_type[4:]
    if "name" in inner:
        out["name"] = list(inner["name"])
    if v0_type:
        if v0_type not in _V0_LAYER_TYPES:
            raise ValueError(f"unknown V0 layer type {v0_type!r}")
        out["type"] = [_V0_LAYER_TYPES[v0_type]]
    for field, values in inner.items():
        if field in ("name", "type"):
            continue
        if field in ("blobs_lr", "weight_decay", "blobs"):
            out.setdefault(field, []).extend(values)
            continue
        route = _V0_ROUTES.get((field, v0_type))
        if route is None:
            raise ValueError(
                f"V0 field {field!r} has no upgrade for layer type "
                f"{v0_type!r} (upgrade_proto.cpp would mark this net "
                "not fully compatible)"
            )
        sub, new_name = route
        subdicts = out.setdefault(sub, [{}])
        subdicts[0].setdefault(new_name, []).extend(values)
    return out


def _upgrade_v0_tokens(d: Dict[str, List[Any]]) -> None:
    """Rewrite V0 connections inside a NetParameter token dict in place;
    pure-V1 ``layers`` entries pass through untouched."""
    entries = d.get("layers")
    if not entries:
        return
    _fold_v0_padding(d)
    d["layers"] = [
        _upgrade_v0_entry(e) if isinstance(e, dict) and "layer" in e else e
        for e in d.get("layers") or []
    ]


def parse(text: str, cls: Type[Message], permissive: bool = False) -> Message:
    """Parse prototxt text into an instance of ``cls`` (a legacy V0 or V1
    net upgrades to the modern schema on the way)."""
    d = _parse_tokens(_tokenize(text))
    if cls is schema.NetParameter:
        _upgrade_v0_tokens(d)
    return _bind(cls, d, permissive)


def parse_file(path: str, cls: Type[Message], permissive: bool = False) -> Message:
    with open(path, "r") as f:
        return parse(f.read(), cls, permissive)


# ---------------------------------------------------------------------------
# Printer
# ---------------------------------------------------------------------------

_ENUMISH_FIELDS = {
    # fields whose string values print unquoted (proto enums)
    ("NetStateRule", "phase"),
    ("NetState", "phase"),
    ("LayerParameter", "phase"),
    ("ParamSpec", "share_mode"),
    ("FillerParameter", "variance_norm"),
    ("LossParameter", "normalization"),
    ("ConvolutionParameter", "engine"),
    ("PoolingParameter", "pool"),
    ("PoolingParameter", "engine"),
    ("EltwiseParameter", "operation"),
    ("LRNParameter", "norm_region"),
    ("LRNParameter", "engine"),
    ("ReductionParameter", "operation"),
    ("HingeLossParameter", "norm"),
    ("DataParameter", "backend"),
    ("SoftmaxParameter", "engine"),
    ("ReLUParameter", "engine"),
    ("SigmoidParameter", "engine"),
    ("TanHParameter", "engine"),
    ("SPPParameter", "pool"),
    ("SPPParameter", "engine"),
    ("SolverParameter", "snapshot_format"),
    ("SolverParameter", "solver_mode"),
    ("SolverParameter", "solver_type"),
}


def _fmt_scalar(cls_name: str, fname: str, v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if (cls_name, fname) in _ENUMISH_FIELDS:
        return str(v)
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def dumps(msg: Message, indent: int = 0) -> str:
    """Print a message as prototxt (round-trips through :func:`parse`)."""
    cls = type(msg)
    if cls not in _TYPE_CACHE:
        _TYPE_CACHE[cls] = _field_types(cls)
    ftypes = _TYPE_CACHE[cls]
    pad = "  " * indent
    lines = []
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        kind, _ = ftypes[f.name]
        default = (
            f.default_factory()
            if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        if kind in ("scalar", "list") and (v == default or v is None):
            continue
        if kind in ("msg", "msglist") and not v:
            continue
        if kind == "scalar":
            lines.append(f"{pad}{f.name}: {_fmt_scalar(cls.__name__, f.name, v)}")
        elif kind == "list":
            for item in v:
                lines.append(
                    f"{pad}{f.name}: {_fmt_scalar(cls.__name__, f.name, item)}"
                )
        elif kind == "msg":
            body = dumps(v, indent + 1)
            lines.append(f"{pad}{f.name} {{\n{body}{pad}}}")
        else:
            for item in v:
                body = dumps(item, indent + 1)
                lines.append(f"{pad}{f.name} {{\n{body}{pad}}}")
    return "".join(line + "\n" for line in lines)
