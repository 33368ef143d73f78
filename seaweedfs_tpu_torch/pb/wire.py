"""Protobuf messages built from the proto3 text, with the binary wire format
written by hand.

The reference compiles its `.proto` files with protoc and imports the
generated `_pb2` modules, which need `google.protobuf`; the machine with the
card has no protobuf package.  This module reads the same `.proto` text at
import time (`load`) and builds one Python class per message, nested
messages and enums included, plus the services with each rpc's `stream`
flags.  The classes speak the protobuf binary wire format — varints, zigzag,
fixed32/64, length-delimited fields, packed repeated scalars, map entries —
so their bytes equal what the reference's `SerializeToString()` writes for
the same field values (`tests/test_torch_pb.py` holds every message of both
files to that), and bytes read off a peer decode without re-encoding.

The message API is the part of protobuf's the port uses: keyword
construction, attribute access with proto3 defaults, `repeated` fields as
lists (`add()`, `append`, `extend`), `map` fields as dicts, `HasField`,
`CopyFrom`, `SetInParent`, `SerializeToString`, `FromString` and
equality.  Reading an unset sub-message returns a default instance that
attaches itself to its parent on its first write, as protobuf's does.
Unknown fields are skipped on parse.  Not covered: `oneof`, proto2, groups,
extensions and `Any`, which neither file uses.
"""
from __future__ import annotations

import math
import os
import re
import struct
from dataclasses import dataclass, field
from types import SimpleNamespace

# wire types
VARINT, I64, LEN, I32 = 0, 1, 2, 5

_VARINT_TYPES = {"int32", "int64", "uint32", "uint64", "sint32", "sint64",
                 "bool", "enum"}
_I64_TYPES = {"fixed64", "sfixed64", "double"}
_I32_TYPES = {"fixed32", "sfixed32", "float"}
_SCALARS = _VARINT_TYPES | _I64_TYPES | _I32_TYPES | {"string", "bytes"}
_STRUCT = {"fixed64": "<Q", "sfixed64": "<q", "double": "<d",
           "fixed32": "<I", "sfixed32": "<i", "float": "<f"}


class DecodeError(ValueError):
    pass


# ----------------------------------------------------------------- varints


def _put_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64  # negative int32/int64: ten-byte two's complement
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _to_varint_value(kind: str, v) -> int:
    if kind == "bool":
        return 1 if v else 0
    if kind in ("sint32", "sint64"):
        return _zigzag(int(v))
    if kind == "uint32":
        return int(v) & 0xFFFFFFFF
    if kind == "uint64":
        return int(v) & 0xFFFFFFFFFFFFFFFF
    return int(v)  # int32, int64, enum: negatives go out as 10 bytes


def _from_varint_value(kind: str, v: int):
    if kind == "bool":
        return v != 0
    if kind == "sint32":
        return _signed(_unzigzag(v & 0xFFFFFFFF), 32)
    if kind == "sint64":
        return _unzigzag(v & 0xFFFFFFFFFFFFFFFF)
    if kind == "uint32":
        return v & 0xFFFFFFFF
    if kind == "uint64":
        return v & 0xFFFFFFFFFFFFFFFF
    if kind == "int64":
        return _signed(v, 64)
    return _signed(v, 32)  # int32, enum


def _wire_type(kind: str) -> int:
    if kind in _VARINT_TYPES:
        return VARINT
    if kind in _I64_TYPES:
        return I64
    if kind in _I32_TYPES:
        return I32
    return LEN


def _default(kind: str):
    if kind in ("string",):
        return ""
    if kind == "bytes":
        return b""
    if kind == "bool":
        return False
    if kind in ("double", "float"):
        return 0.0
    return 0


def _is_default(kind: str, v) -> bool:
    """proto3 implicit presence: a scalar equal to its default is not
    written.  A float is default only when its bits are zero (-0.0 is
    written, as protobuf writes it)."""
    if kind in ("double", "float"):
        return v == 0 and math.copysign(1.0, v) > 0
    return not v


def _encode_scalar(out: bytearray, kind: str, v) -> None:
    """The value part of one scalar (no tag)."""
    if kind in _VARINT_TYPES:
        _put_varint(out, _to_varint_value(kind, v))
    elif kind in _STRUCT:
        out += struct.pack(_STRUCT[kind], v)
    elif kind == "string":
        b = v.encode("utf-8")
        _put_varint(out, len(b))
        out += b
    else:  # bytes
        _put_varint(out, len(v))
        out += v


def _decode_scalar(kind: str, buf, pos: int, wt: int):
    if wt == VARINT:
        raw, pos = _get_varint(buf, pos)
        return _from_varint_value(kind, raw), pos
    if wt == I64:
        if pos + 8 > len(buf):
            raise DecodeError("truncated fixed64")
        return struct.unpack_from(_STRUCT[kind], buf, pos)[0], pos + 8
    if wt == I32:
        if pos + 4 > len(buf):
            raise DecodeError("truncated fixed32")
        v = struct.unpack_from(_STRUCT[kind], buf, pos)[0]
        return v, pos + 4
    n, pos = _get_varint(buf, pos)
    if pos + n > len(buf):
        raise DecodeError("truncated length-delimited field")
    raw = bytes(buf[pos:pos + n])
    return (raw.decode("utf-8") if kind == "string" else raw), pos + n


def _skip(buf, pos: int, wt: int) -> int:
    if wt == VARINT:
        return _get_varint(buf, pos)[1]
    if wt == I64:
        return pos + 8
    if wt == I32:
        return pos + 4
    if wt == LEN:
        n, pos = _get_varint(buf, pos)
        return pos + n
    raise DecodeError(f"unsupported wire type {wt}")


# ------------------------------------------------------------ descriptors


@dataclass
class FieldDesc:
    name: str
    number: int
    kind: str  # a scalar name, "message" or "map"
    repeated: bool = False
    message: type | None = None  # the class, for kind == "message"
    type_name: str = ""  # as written in the .proto, resolved later
    key_kind: str = ""  # map key scalar
    value_kind: str = ""  # map value scalar or "message"
    value_message: type | None = None
    value_type_name: str = ""


@dataclass
class MethodDesc:
    name: str
    full_path: str  # "/package.Service/Method"
    input: type
    output: type
    client_streaming: bool
    server_streaming: bool


@dataclass
class ServiceDesc:
    name: str
    full_name: str
    methods: dict[str, MethodDesc] = field(default_factory=dict)


# -------------------------------------------------------------- containers


class _Repeated(list):
    """A repeated field: a list that tells its owner it was written."""

    __slots__ = ("_owner", "_fd")

    def __init__(self, owner, fd, items=()):
        super().__init__(items)
        self._owner = owner
        self._fd = fd

    def _touch(self):
        self._owner._mark()

    def append(self, v):
        super().append(v)
        self._touch()

    def extend(self, vs):
        super().extend(vs)
        self._touch()

    def insert(self, i, v):
        super().insert(i, v)
        self._touch()

    def __setitem__(self, i, v):
        super().__setitem__(i, v)
        self._touch()

    def __iadd__(self, vs):
        self.extend(vs)
        return self

    def add(self, **kw):
        """A new element message appended and returned (repeated message
        fields only)."""
        m = self._fd.message(**kw)
        self.append(m)
        return m


class _Map(dict):
    """A map field: a dict that tells its owner it was written.  A missing
    key of a message-valued map is created on read, as protobuf does."""

    __slots__ = ("_owner", "_fd")

    def __init__(self, owner, fd, items=()):
        super().__init__(items)
        self._owner = owner
        self._fd = fd

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._owner._mark()

    def __missing__(self, k):
        if self._fd.value_kind != "message":
            raise KeyError(k)
        m = self._fd.value_message()
        self[k] = m
        return m

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self._owner._mark()

    def setdefault(self, k, v=None):
        r = super().setdefault(k, v)
        self._owner._mark()
        return r


# ----------------------------------------------------------------- message


class Message:
    """Base of every generated message class.  `_fields` (name -> FieldDesc)
    and `_by_number` are filled in by `load`."""

    __slots__ = ("_v", "_parent", "_pname")
    _fields: dict[str, FieldDesc] = {}
    _by_number: dict[int, FieldDesc] = {}
    _ordered: tuple[FieldDesc, ...] = ()
    DESCRIPTOR_NAME = ""

    def __init__(self, **kw):
        object.__setattr__(self, "_v", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pname", "")
        for k, val in kw.items():
            fd = self._fields.get(k)
            if fd is None:
                raise ValueError(
                    f"{type(self).__name__} has no field {k!r}")
            if val is None:
                continue
            if fd.kind == "map":
                getattr(self, k).update(val)
            elif fd.repeated:
                getattr(self, k).extend(val)
            elif fd.kind == "message":
                if not isinstance(val, fd.message):
                    raise TypeError(
                        f"{type(self).__name__}.{k} takes "
                        f"{fd.message.__name__}, not {type(val).__name__}")
                getattr(self, k).CopyFrom(val)
            else:
                setattr(self, k, val)

    # -- presence ------------------------------------------------------------

    def _mark(self) -> None:
        """A write reached this message: if it was a default instance read
        off a parent, attach it there (and the parent to its own)."""
        parent = self._parent
        if parent is not None:
            parent._v[self._pname] = self
            object.__setattr__(self, "_parent", None)
            parent._mark()

    def __getattr__(self, name):
        fd = type(self)._fields.get(name)
        if fd is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        v = self._v
        if name in v:
            return v[name]
        if fd.kind == "map":
            m = _Map(self, fd)
            self._v[name] = m
            return m
        if fd.repeated:
            r = _Repeated(self, fd)
            self._v[name] = r
            return r
        if fd.kind == "message":
            child = fd.message()
            object.__setattr__(child, "_parent", self)
            object.__setattr__(child, "_pname", name)
            return child
        return _default(fd.kind)

    def __setattr__(self, name, value):
        fd = type(self)._fields.get(name)
        if fd is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        if fd.repeated or fd.kind in ("map", "message"):
            raise AttributeError(
                f"assignment to {fd.kind if not fd.repeated else 'repeated'} "
                f"field {name!r} is not allowed; use CopyFrom/extend/update")
        self._v[name] = _coerce(fd.kind, value)
        self._mark()

    def HasField(self, name: str) -> bool:
        fd = type(self)._fields.get(name)
        if fd is None or fd.repeated or fd.kind != "message":
            raise ValueError(f"{name!r} is not a singular message field")
        return name in self._v

    def SetInParent(self) -> None:
        self._mark()

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom of {type(other).__name__} into "
                            f"{type(self).__name__}")
        self._v.clear()
        self.MergeFromString(other.SerializeToString())
        self._mark()

    def MergeFromString(self, data) -> int:
        _decode_into(self, memoryview(data), 0, len(data))
        self._mark()
        return len(data)

    @classmethod
    def FromString(cls, data) -> "Message":
        m = cls()
        _decode_into(m, memoryview(data), 0, len(data))
        return m

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        out = bytearray()
        _encode_into(out, self)
        return bytes(out)

    def ListFields(self) -> list[tuple[FieldDesc, object]]:
        out = []
        for fd in self._ordered:
            if fd.name not in self._v:
                continue
            v = self._v[fd.name]
            if (fd.repeated or fd.kind == "map") and not v:
                continue
            if fd.kind not in ("message", "map") and not fd.repeated and \
                    _is_default(fd.kind, v):
                continue
            out.append((fd, v))
        return out

    def __eq__(self, other):
        return (type(other) is type(self)
                and self.SerializeToString() == other.SerializeToString())

    def __hash__(self):
        raise TypeError("unhashable: protobuf messages are mutable")

    def __repr__(self):
        body = ", ".join(f"{fd.name}={v!r}" for fd, v in self.ListFields())
        return f"{type(self).__name__}({body})"

    def __str__(self):
        """Protobuf's text format, as `str()` of a protoc message prints
        it (fields in number order, strings with their UTF-8 as it is and
        bytes C-escaped).  Map entries print by sorted key, as protobuf's
        text_format module does (`str()` of a upb message keeps its map's
        own order); an enum prints as its number."""
        out: list[str] = []
        _text_into(out, self, "")
        return "".join(out)


_CESCAPE = [chr(i) if 32 <= i < 127 else "\\%03o" % i for i in range(256)]
for _c, _e in ((10, "\\n"), (13, "\\r"), (9, "\\t"), (39, "\\'"), (34, '\\"'),
               (92, "\\\\")):
    _CESCAPE[_c] = _e


def _text_scalar(kind: str, v) -> str:
    if kind == "bytes":
        return '"' + "".join(_CESCAPE[b] for b in bytes(v)) + '"'
    if kind == "string":  # UTF-8 stays as it is; control bytes escape
        return '"' + "".join(c if ord(c) >= 128 else _CESCAPE[ord(c)]
                             for c in v) + '"'
    if kind == "bool":
        return "true" if v else "false"
    return str(v)


def _text_into(out: list[str], msg: "Message", indent: str) -> None:
    for fd, v in sorted(msg.ListFields(), key=lambda p: p[0].number):
        if fd.kind == "map":
            for k in sorted(v):
                out.append(f"{indent}{fd.name} {{\n")
                inner = indent + "  "
                out.append(f"{inner}key: {_text_scalar(fd.key_kind, k)}\n")
                if fd.value_kind == "message":
                    out.append(f"{inner}value {{\n")
                    _text_into(out, v[k], inner + "  ")
                    out.append(f"{inner}}}\n")
                else:
                    out.append(f"{inner}value: "
                               f"{_text_scalar(fd.value_kind, v[k])}\n")
                out.append(f"{indent}}}\n")
            continue
        for item in (v if fd.repeated else [v]):
            if fd.kind == "message":
                out.append(f"{indent}{fd.name} {{\n")
                _text_into(out, item, indent + "  ")
                out.append(f"{indent}}}\n")
            else:
                out.append(f"{indent}{fd.name}: "
                           f"{_text_scalar(fd.kind, item)}\n")


def _coerce(kind: str, v):
    if kind == "string":
        if isinstance(v, bytes):
            v = v.decode("utf-8")
        if not isinstance(v, str):
            raise TypeError(f"string field got {type(v).__name__}")
        return v
    if kind == "bytes":
        if isinstance(v, str):
            v = v.encode("utf-8")
        return bytes(v) if not isinstance(v, bytes) else v
    if kind == "bool":
        return bool(v)
    if kind in ("double", "float"):
        return float(v)
    if isinstance(v, float) and not v.is_integer():
        raise TypeError(f"{kind} field got a non-integral float {v!r}")
    v = int(v)
    lim = {"int32": (-(1 << 31), 1 << 31), "sint32": (-(1 << 31), 1 << 31),
           "sfixed32": (-(1 << 31), 1 << 31), "enum": (-(1 << 31), 1 << 31),
           "uint32": (0, 1 << 32), "fixed32": (0, 1 << 32),
           "uint64": (0, 1 << 64), "fixed64": (0, 1 << 64),
           "int64": (-(1 << 63), 1 << 63), "sint64": (-(1 << 63), 1 << 63),
           "sfixed64": (-(1 << 63), 1 << 63)}[kind]
    if not lim[0] <= v < lim[1]:
        raise ValueError(f"value {v} out of range for {kind}")
    return v


# ---------------------------------------------------------------- encoding


def _tag(out: bytearray, number: int, wt: int) -> None:
    _put_varint(out, (number << 3) | wt)


def _encode_into(out: bytearray, msg: Message) -> None:
    v = msg._v
    for fd in msg._ordered:
        if fd.name not in v:
            continue
        val = v[fd.name]
        if fd.kind == "map":
            for k in sorted(val):
                entry = bytearray()
                _tag(entry, 1, _wire_type(fd.key_kind))
                _encode_scalar(entry, fd.key_kind, k)
                item = val[k]
                if fd.value_kind == "message":
                    sub = bytearray()
                    _encode_into(sub, item)
                    _tag(entry, 2, LEN)
                    _put_varint(entry, len(sub))
                    entry += sub
                else:
                    _tag(entry, 2, _wire_type(fd.value_kind))
                    _encode_scalar(entry, fd.value_kind, item)
                _tag(out, fd.number, LEN)
                _put_varint(out, len(entry))
                out += entry
        elif fd.kind == "message":
            items = val if fd.repeated else (val,)
            for item in items:
                sub = bytearray()
                _encode_into(sub, item)
                _tag(out, fd.number, LEN)
                _put_varint(out, len(sub))
                out += sub
        elif fd.repeated:
            if not val:
                continue
            if fd.kind in ("string", "bytes"):
                for item in val:
                    _tag(out, fd.number, LEN)
                    _encode_scalar(out, fd.kind, _coerce(fd.kind, item))
            else:  # proto3 packs repeated numeric scalars
                packed = bytearray()
                for item in val:
                    _encode_scalar(packed, fd.kind, _coerce(fd.kind, item))
                _tag(out, fd.number, LEN)
                _put_varint(out, len(packed))
                out += packed
        else:
            if _is_default(fd.kind, val):
                continue
            _tag(out, fd.number, _wire_type(fd.kind))
            _encode_scalar(out, fd.kind, val)


def _decode_into(msg: Message, buf, pos: int, end: int) -> None:
    by_number = msg._by_number
    v = msg._v
    while pos < end:
        key, pos = _get_varint(buf, pos)
        number, wt = key >> 3, key & 7
        fd = by_number.get(number)
        if fd is None:
            pos = _skip(buf, pos, wt)
            continue
        if fd.kind == "message" or fd.kind == "map":
            if wt != LEN:
                raise DecodeError(f"field {fd.name}: wire type {wt}")
            n, pos = _get_varint(buf, pos)
            stop = pos + n
            if stop > end:
                raise DecodeError(f"field {fd.name}: truncated")
            if fd.kind == "map":
                k, val = _default(fd.key_kind), None
                p = pos
                while p < stop:
                    ek, p = _get_varint(buf, p)
                    en, ewt = ek >> 3, ek & 7
                    if en == 1:
                        k, p = _decode_scalar(fd.key_kind, buf, p, ewt)
                    elif en == 2 and fd.value_kind == "message":
                        ln, p = _get_varint(buf, p)
                        val = fd.value_message()
                        _decode_into(val, buf, p, p + ln)
                        p += ln
                    elif en == 2:
                        val, p = _decode_scalar(fd.value_kind, buf, p, ewt)
                    else:
                        p = _skip(buf, p, ewt)
                if val is None:
                    val = (fd.value_message() if fd.value_kind == "message"
                           else _default(fd.value_kind))
                m = v.get(fd.name)
                if m is None:
                    m = v[fd.name] = _Map(msg, fd)
                dict.__setitem__(m, k, val)
            else:
                if fd.repeated:
                    sub = fd.message()
                    _decode_into(sub, buf, pos, stop)
                    r = v.get(fd.name)
                    if r is None:
                        r = v[fd.name] = _Repeated(msg, fd)
                    list.append(r, sub)
                else:
                    sub = v.get(fd.name)
                    if sub is None:
                        sub = v[fd.name] = fd.message()
                    _decode_into(sub, buf, pos, stop)
            pos = stop
        elif fd.repeated:
            r = v.get(fd.name)
            if r is None:
                r = v[fd.name] = _Repeated(msg, fd)
            if wt == LEN and fd.kind not in ("string", "bytes"):
                n, pos = _get_varint(buf, pos)  # packed
                stop = pos + n
                ewt = _wire_type(fd.kind)
                while pos < stop:
                    item, pos = _decode_scalar(fd.kind, buf, pos, ewt)
                    list.append(r, item)
            else:
                item, pos = _decode_scalar(fd.kind, buf, pos, wt)
                list.append(r, item)
        else:
            val, pos = _decode_scalar(fd.kind, buf, pos, wt)
            v[fd.name] = val
    if pos != end:
        raise DecodeError("message overran its length")


# ----------------------------------------------------------------- parsing

_TOKEN = re.compile(
    r'\s+|//[^\n]*|/\*.*?\*/|"(?:[^"\\]|\\.)*"|\'(?:[^\'\\]|\\.)*\''
    r'|[A-Za-z_][\w.]*|-?\d+|[{}()\[\]<>;=,]',
    re.S,
)


def _tokens(text: str) -> list[str]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise SyntaxError(f"proto: unexpected {text[pos:pos + 20]!r}")
        tok = m.group()
        pos = m.end()
        if tok[0].isspace() or tok.startswith("//") or tok.startswith("/*"):
            continue
        out.append(tok)
    return out


class _Parser:
    def __init__(self, tokens: list[str]):
        self.t = tokens
        self.i = 0

    def peek(self) -> str:
        return self.t[self.i] if self.i < len(self.t) else ""

    def take(self, want: str | None = None) -> str:
        tok = self.peek()
        if want is not None and tok != want:
            raise SyntaxError(f"proto: expected {want!r}, got {tok!r}")
        self.i += 1
        return tok

    def skip_statement(self) -> None:
        depth = 0
        while True:
            tok = self.take()
            if tok == "{":
                depth += 1
            elif tok == "}":
                depth -= 1
                if depth == 0:
                    return
            elif tok == ";" and depth == 0:
                return

    def skip_options(self) -> None:
        if self.peek() == "[":
            while self.take() != "]":
                pass


@dataclass
class _MsgSpec:
    name: str  # full name within the package: "Outer.Inner"
    fields: list[FieldDesc] = field(default_factory=list)


def _parse_message(p: _Parser, prefix: str, msgs: list, enums: dict) -> None:
    name = p.take()
    full = f"{prefix}{name}"
    spec = _MsgSpec(full)
    msgs.append(spec)
    p.take("{")
    while p.peek() != "}":
        tok = p.peek()
        if tok == "message":
            p.take()
            _parse_message(p, full + ".", msgs, enums)
        elif tok == "enum":
            p.take()
            _parse_enum(p, full + ".", enums)
        elif tok in ("option", "reserved", "extensions"):
            p.skip_statement()
        elif tok == ";":
            p.take()
        elif tok == "oneof":
            raise SyntaxError("proto: oneof is not supported")
        elif tok == "map":
            p.take()
            p.take("<")
            key = p.take()
            p.take(",")
            val = p.take()
            p.take(">")
            fname = p.take()
            p.take("=")
            num = int(p.take())
            p.skip_options()
            p.take(";")
            spec.fields.append(FieldDesc(
                fname, num, "map", key_kind=key,
                value_kind=val if val in _SCALARS else "message",
                value_type_name="" if val in _SCALARS else val,
            ))
        else:
            repeated = False
            if tok in ("repeated", "optional"):
                repeated = p.take() == "repeated"
            ftype = p.take()
            fname = p.take()
            p.take("=")
            num = int(p.take())
            p.skip_options()
            p.take(";")
            spec.fields.append(FieldDesc(
                fname, num, ftype if ftype in _SCALARS else "message",
                repeated=repeated,
                type_name="" if ftype in _SCALARS else ftype,
            ))
    p.take("}")


def _parse_enum(p: _Parser, prefix: str, enums: dict) -> None:
    name = p.take()
    values: dict[str, int] = {}
    p.take("{")
    while p.peek() != "}":
        tok = p.take()
        if tok in ("option", "reserved"):
            p.i -= 1
            p.skip_statement()
            continue
        if tok == ";":
            continue
        p.take("=")
        values[tok] = int(p.take())
        p.skip_options()
        p.take(";")
    p.take("}")
    enums[f"{prefix}{name}"] = values


def _parse_service(p: _Parser, services: list) -> None:
    name = p.take()
    rpcs = []
    p.take("{")
    while p.peek() != "}":
        tok = p.take()
        if tok == "option":
            p.i -= 1
            p.skip_statement()
            continue
        if tok == ";":
            continue
        if tok != "rpc":
            raise SyntaxError(f"proto: unexpected {tok!r} in service")
        mname = p.take()
        p.take("(")
        cs = p.peek() == "stream" and bool(p.take())
        itype = p.take()
        p.take(")")
        p.take("returns")
        p.take("(")
        ss = p.peek() == "stream" and bool(p.take())
        otype = p.take()
        p.take(")")
        if p.peek() == "{":
            p.skip_statement()
        else:
            p.take(";")
        rpcs.append((mname, itype, otype, cs, ss))
    p.take("}")
    services.append((name, rpcs))


def _resolve(name: str, scope: str, known) -> str:
    """A type name as written, resolved the protobuf way: from the
    innermost enclosing scope outward."""
    name = name.lstrip(".")
    parts = scope.split(".") if scope else []
    for i in range(len(parts), -1, -1):
        cand = ".".join(parts[:i] + [name])
        if cand in known:
            return cand
    raise SyntaxError(f"proto: unknown type {name!r} in {scope!r}")


def parse(text: str, module_name: str = "") -> SimpleNamespace:
    """Build the message classes, enums and services of one proto3 file.
    -> a namespace with one attribute per top-level message and enum
    (nested ones as attributes of their parent class), `SERVICES`
    (name -> ServiceDesc) and `PACKAGE`."""
    p = _Parser(_tokens(text))
    package = ""
    msgs: list[_MsgSpec] = []
    enums: dict[str, dict[str, int]] = {}
    services: list = []
    while p.peek():
        tok = p.take()
        if tok == "syntax":
            p.take("=")
            if p.take().strip("\"'") != "proto3":
                raise SyntaxError("proto: only proto3 is supported")
            p.take(";")
        elif tok == "package":
            package = p.take()
            p.take(";")
        elif tok == "message":
            _parse_message(p, "", msgs, enums)
        elif tok == "enum":
            _parse_enum(p, "", enums)
        elif tok == "service":
            _parse_service(p, services)
        elif tok in ("import", "option"):
            p.i -= 1
            p.skip_statement()
        elif tok == ";":
            continue
        else:
            raise SyntaxError(f"proto: unexpected {tok!r}")

    classes: dict[str, type] = {}
    for spec in msgs:
        cls = type(spec.name.split(".")[-1], (Message,), {
            "__slots__": (),
            "DESCRIPTOR_NAME": f"{package}.{spec.name}" if package else spec.name,
            "__module__": module_name or __name__,
            "__qualname__": spec.name,
        })
        classes[spec.name] = cls
    for spec in msgs:
        scope = spec.name
        for fd in spec.fields:
            for attr, tn in (("type_name", fd.type_name),
                             ("value_type_name", fd.value_type_name)):
                if not tn:
                    continue
                full = _resolve(tn, scope, set(classes) | set(enums))
                if full in enums:
                    if attr == "type_name":
                        fd.kind = "enum"
                    else:
                        fd.value_kind = "enum"
                elif attr == "type_name":
                    fd.message = classes[full]
                else:
                    fd.value_message = classes[full]
        cls = classes[spec.name]
        ordered = tuple(sorted(spec.fields, key=lambda f: f.number))
        cls._fields = {f.name: f for f in spec.fields}
        cls._by_number = {f.number: f for f in spec.fields}
        cls._ordered = ordered
    ns = SimpleNamespace(PACKAGE=package, SERVICES={})
    for full, cls in classes.items():
        head, _, leaf = full.rpartition(".")
        if head:
            setattr(classes[head], leaf, cls)
        else:
            setattr(ns, leaf, cls)
    for full, values in enums.items():
        enum_ns = SimpleNamespace(**values)
        head, _, leaf = full.rpartition(".")
        if head:
            setattr(classes[head], leaf, enum_ns)
        else:
            setattr(ns, leaf, enum_ns)
        for k, num in values.items():  # top-level enum values, as protoc
            if not head:
                setattr(ns, k, num)
    for sname, rpcs in services:
        full = f"{package}.{sname}" if package else sname
        sd = ServiceDesc(sname, full)
        for mname, itype, otype, cs, ss in rpcs:
            sd.methods[mname] = MethodDesc(
                mname, f"/{full}/{mname}",
                classes[_resolve(itype, "", classes)],
                classes[_resolve(otype, "", classes)], cs, ss,
            )
        ns.SERVICES[sname] = sd
    return ns


def load(filename: str, module_name: str = "") -> SimpleNamespace:
    """Parse a `.proto` that sits beside this module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), filename)
    with open(path, encoding="utf-8") as f:
        return parse(f.read(), module_name)
