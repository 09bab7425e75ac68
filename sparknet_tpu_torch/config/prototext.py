"""Proto2 text-format parser bound to the dataclass schema.

The port's own copy of the parser half of
``sparknet_tpu/config/prototext.py``.  The grammar is the subset of
proto2 text format the reference's configs use::

    message   := field*
    field     := ident ':' scalar | ident [':'] '{' message '}'
    scalar    := number | 'true' | 'false' | quoted-string | ENUM_IDENT

Repeated fields accumulate across occurrences.  Unknown fields raise
(catches typos) unless ``permissive=True``.  The V0/V1 legacy upgrades
and the printer are not ported.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Tuple, Type

from sparknet_tpu_torch.config.schema import Message

__all__ = ["parse", "parse_file", "ParseError"]


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
    return cls(**kwargs)


def parse(text: str, cls: Type[Message], permissive: bool = False) -> Message:
    """Parse prototxt text into an instance of ``cls``."""
    return _bind(cls, _parse_tokens(_tokenize(text)), permissive)


def parse_file(path: str, cls: Type[Message], permissive: bool = False) -> Message:
    with open(path, "r") as f:
        return parse(f.read(), cls, permissive)
