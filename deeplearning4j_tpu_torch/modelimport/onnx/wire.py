"""The ONNX wire format in pure Python (counterpart:
``deeplearning4j_tpu/modelimport/onnx/onnx_minimal_pb2.py``, the protoc
bindings of ``onnx_minimal.proto``).

A reader and writer of the protocol-buffer messages that the minimal ONNX
schema defines — ModelProto, GraphProto, NodeProto, AttributeProto,
TensorProto, ValueInfoProto, TypeProto (with its Tensor), TensorShapeProto
(with its Dimension) and OperatorSetIdProto — with the schema's field
numbers, so real ``.onnx`` files and the protoc bindings' bytes read the
same. It needs neither ``google.protobuf`` nor ``onnx``.

Messages behave as the generated classes do where the importer and the
model writers touch them: fields by name (``model.graph.node``,
``n.op_type``, ``a.type``, ``t.raw_data``), enum values as class
attributes (``AttributeProto.FLOAT``, ``TensorProto.INT64``), repeated
fields as lists with ``add()``, ``ParseFromString``, ``FromString``,
``SerializeToString`` and ``HasField``. Serialization
follows protobuf's proto3 rules: fields in number order, singular scalars
only when they differ from their default, numeric repeated fields packed,
a sub-message whenever it was set. The reader accepts packed and unpacked
repeated scalars, skips fields the schema does not name, and keeps
``bytes`` fields (``raw_data``) as zero-copy views of the input.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1

# kind -> wire type
_WIRE = {"int64": 0, "int32": 0, "uint64": 0, "enum": 0, "float": 5,
         "double": 1, "string": 2, "bytes": 2, "message": 2}
_NUMPY = {"float": "<f4", "double": "<f8"}
_DEFAULT = {"int64": 0, "int32": 0, "uint64": 0, "enum": 0, "float": 0.0,
            "double": 0.0, "string": "", "bytes": b""}


def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed(v: int, kind: str) -> int:
    if kind == "uint64":
        return v
    if kind in ("int32", "enum"):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    return v - (1 << 64) if v >= 1 << 63 else v


class _Repeated(list):
    """A repeated field: a list that marks its message as set when it
    grows, with ``add()`` for message elements."""

    __slots__ = ("_owner", "_cls")

    def __init__(self, owner, cls=None, items=()):
        super().__init__(items)
        self._owner = owner
        self._cls = cls

    def add(self, **fields):
        m = self._cls(**fields)
        self.append(m)
        return m

    def append(self, v):
        super().append(v)
        self._owner._mark()

    def extend(self, vs):
        super().extend(vs)
        self._owner._mark()


class Message:
    """Base of the schema's messages. ``FIELDS``: name -> (number, kind,
    repeated, message class name)."""

    FIELDS: Dict[str, Tuple[int, str, bool, Any]] = {}
    _BY_NUMBER: Dict[int, str] = {}
    _ORDER: tuple = ()

    def __init__(self, **fields):
        d = self.__dict__
        d["_set"] = False
        d["_parent"] = None
        d["_values"] = {}
        for k, v in fields.items():
            setattr(self, k, v)

    # ---------------------------------------------------------- fields
    @classmethod
    def _cls_of(cls, name):
        spec = cls.FIELDS[name][3]
        return _CLASSES[spec] if isinstance(spec, str) else spec

    def __getattr__(self, name):
        spec = type(self).FIELDS.get(name)
        if spec is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        vals = self.__dict__["_values"]
        if name in vals:
            return vals[name]
        _, kind, repeated, _ = spec
        if repeated:
            v = _Repeated(self, self._cls_of(name) if kind == "message" else None)
        elif kind == "message":
            v = self._cls_of(name)()
            v.__dict__["_parent"] = self
        else:
            return _DEFAULT[kind]
        vals[name] = v
        return v

    def __setattr__(self, name, value):
        spec = type(self).FIELDS.get(name)
        if spec is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        _, kind, repeated, _ = spec
        if repeated:
            value = _Repeated(self, self._cls_of(name) if kind == "message" else None,
                              value)
        elif kind == "message":
            if not isinstance(value, self._cls_of(name)):
                raise TypeError(f"{name} takes a {self._cls_of(name).__name__}")
            value.__dict__["_parent"] = self
            value._mark()
        self.__dict__["_values"][name] = value
        self._mark()

    def _mark(self):
        m = self
        while m is not None and not m.__dict__["_set"]:
            m.__dict__["_set"] = True
            m = m.__dict__["_parent"]

    def HasField(self, name) -> bool:
        v = self.__dict__["_values"].get(name)
        if type(self).FIELDS[name][1] == "message":
            return v is not None and v.__dict__["_set"]
        return v is not None and v != _DEFAULT[type(self).FIELDS[name][1]]

    # ----------------------------------------------------------- write
    def SerializeToString(self) -> bytes:
        out = []
        vals = self.__dict__["_values"]
        for name, (num, kind, repeated, _) in type(self)._ORDER:
            if name not in vals:
                continue
            v = vals[name]
            if repeated:
                if not v:
                    continue
                if kind in _NUMPY:
                    body = np.asarray(v, _NUMPY[kind]).tobytes()
                    out += [_varint(num << 3 | 2), _varint(len(body)), body]
                elif _WIRE[kind] == 0:
                    body = b"".join(_varint(int(x)) for x in v)
                    out += [_varint(num << 3 | 2), _varint(len(body)), body]
                else:
                    for x in v:
                        out += self._emit(num, kind, x)
            elif kind == "message":
                if v.__dict__["_set"]:
                    out += self._emit(num, kind, v)
            elif v != _DEFAULT[kind] or (kind == "bytes" and len(v)):
                out += self._emit(num, kind, v)
        return b"".join(out)

    @staticmethod
    def _emit(num, kind, v):
        wt = _WIRE[kind]
        if wt == 0:
            return [_varint(num << 3), _varint(int(v))]
        if wt == 5:
            return [_varint(num << 3 | 5), struct.pack("<f", v)]
        if wt == 1:
            return [_varint(num << 3 | 1), struct.pack("<d", v)]
        if kind == "message":
            body = v.SerializeToString()
        elif kind == "string":
            body = v.encode("utf-8")
        else:
            body = v
        return [_varint(num << 3 | 2), _varint(len(body)), body]

    # ------------------------------------------------------------ read
    @classmethod
    def FromString(cls, data):
        m = cls()
        m.ParseFromString(data)
        return m

    def ParseFromString(self, data) -> int:
        buf = memoryview(data)
        if buf.format != "B":
            buf = buf.cast("B")
        self.__dict__["_values"] = {}
        self._parse(buf, 0, len(buf))
        self._mark()
        return len(buf)

    def _parse(self, buf, pos, end):
        by_num = type(self)._BY_NUMBER
        fields = type(self).FIELDS
        vals = self.__dict__["_values"]
        while pos < end:
            key, pos = _read_varint(buf, pos)
            num, wt = key >> 3, key & 7
            name = by_num.get(num)
            if wt == 0:
                raw, pos = _read_varint(buf, pos)
            elif wt == 1:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wt == 5:
                raw, pos = buf[pos:pos + 4], pos + 4
            elif wt == 2:
                n, pos = _read_varint(buf, pos)
                raw, pos = (pos, pos + n), pos + n
            else:
                raise ValueError(f"unsupported wire type {wt} (field {num})")
            if pos > end:
                raise ValueError("truncated message")
            if name is None:
                continue   # a field this schema does not name
            _, kind, repeated, _ = fields[name]
            if repeated and wt == 2 and kind not in ("string", "bytes", "message"):
                items = self._unpack(buf, raw[0], raw[1], kind)
                getattr(self, name)
                list.extend(vals[name], items)
                continue
            val = self._scalar(buf, raw, wt, kind, name)
            if repeated:
                getattr(self, name)
                list.append(vals[name], val)
            elif kind == "message" and name in vals:
                vals[name]._parse(buf, raw[0], raw[1])   # protobuf merges repeats
            else:
                vals[name] = val

    def _scalar(self, buf, raw, wt, kind, name):
        if kind == "message":
            m = self._cls_of(name)()
            m.__dict__["_parent"] = self
            m.__dict__["_set"] = True
            m._parse(buf, raw[0], raw[1])
            return m
        if kind == "string":
            return bytes(buf[raw[0]:raw[1]]).decode("utf-8")
        if kind == "bytes":
            return buf[raw[0]:raw[1]]
        if kind == "float":
            return struct.unpack("<f", raw)[0]
        if kind == "double":
            return struct.unpack("<d", raw)[0]
        return _signed(raw, kind)

    @staticmethod
    def _unpack(buf, start, stop, kind):
        if kind in _NUMPY:
            return np.frombuffer(buf[start:stop], _NUMPY[kind]).astype(float).tolist()
        out = []
        pos = start
        while pos < stop:
            v, pos = _read_varint(buf, pos)
            out.append(_signed(v, kind))
        return out


_CLASSES: Dict[str, type] = {}


def _message(name, fields, enums=None, nested=None):
    cls = type(name, (Message,), {"FIELDS": fields, "__slots__": ()})
    cls._BY_NUMBER = {spec[0]: f for f, spec in fields.items()}
    cls._ORDER = tuple(sorted(fields.items(), key=lambda kv: kv[1][0]))
    for k, v in (enums or {}).items():
        setattr(cls, k, v)
    for k, v in (nested or {}).items():
        setattr(cls, k, v)
    _CLASSES[name] = cls
    return cls


def _f(num, kind, repeated=False, msg=None):
    return (num, kind, repeated, msg)


OperatorSetIdProto = _message("OperatorSetIdProto", {
    "domain": _f(1, "string"), "version": _f(2, "int64")})

_Dimension = _message("TensorShapeProto.Dimension", {
    "dim_value": _f(1, "int64"), "dim_param": _f(2, "string")})
TensorShapeProto = _message("TensorShapeProto", {
    "dim": _f(1, "message", True, "TensorShapeProto.Dimension")},
    nested={"Dimension": _Dimension})

_TypeTensor = _message("TypeProto.Tensor", {
    "elem_type": _f(1, "int32"), "shape": _f(2, "message", False, "TensorShapeProto")})
TypeProto = _message("TypeProto", {
    "tensor_type": _f(1, "message", False, "TypeProto.Tensor")},
    nested={"Tensor": _TypeTensor})

TensorProto = _message("TensorProto", {
    "dims": _f(1, "int64", True), "data_type": _f(2, "int32"),
    "float_data": _f(4, "float", True), "int32_data": _f(5, "int32", True),
    "string_data": _f(6, "bytes", True), "int64_data": _f(7, "int64", True),
    "name": _f(8, "string"), "raw_data": _f(9, "bytes"),
    "double_data": _f(10, "double", True), "uint64_data": _f(11, "uint64", True)},
    enums=dict(UNDEFINED=0, FLOAT=1, UINT8=2, INT8=3, UINT16=4, INT16=5, INT32=6,
               INT64=7, STRING=8, BOOL=9, FLOAT16=10, DOUBLE=11, UINT32=12,
               UINT64=13, BFLOAT16=16))

ValueInfoProto = _message("ValueInfoProto", {
    "name": _f(1, "string"), "type": _f(2, "message", False, "TypeProto"),
    "doc_string": _f(3, "string")})

AttributeProto = _message("AttributeProto", {
    "name": _f(1, "string"), "f": _f(2, "float"), "i": _f(3, "int64"),
    "s": _f(4, "bytes"), "t": _f(5, "message", False, "TensorProto"),
    "g": _f(6, "message", False, "GraphProto"), "floats": _f(7, "float", True),
    "ints": _f(8, "int64", True), "strings": _f(9, "bytes", True),
    "tensors": _f(10, "message", True, "TensorProto"),
    "graphs": _f(11, "message", True, "GraphProto"), "type": _f(20, "enum")},
    enums=dict(UNDEFINED=0, FLOAT=1, INT=2, STRING=3, TENSOR=4, GRAPH=5, FLOATS=6,
               INTS=7, STRINGS=8, TENSORS=9, GRAPHS=10))

NodeProto = _message("NodeProto", {
    "input": _f(1, "string", True), "output": _f(2, "string", True),
    "name": _f(3, "string"), "op_type": _f(4, "string"),
    "attribute": _f(5, "message", True, "AttributeProto"),
    "doc_string": _f(6, "string"), "domain": _f(7, "string")})

GraphProto = _message("GraphProto", {
    "node": _f(1, "message", True, "NodeProto"), "name": _f(2, "string"),
    "initializer": _f(5, "message", True, "TensorProto"),
    "doc_string": _f(10, "string"),
    "input": _f(11, "message", True, "ValueInfoProto"),
    "output": _f(12, "message", True, "ValueInfoProto"),
    "value_info": _f(13, "message", True, "ValueInfoProto")})

ModelProto = _message("ModelProto", {
    "ir_version": _f(1, "int64"), "producer_name": _f(2, "string"),
    "producer_version": _f(3, "string"), "domain": _f(4, "string"),
    "model_version": _f(5, "int64"), "doc_string": _f(6, "string"),
    "graph": _f(7, "message", False, "GraphProto"),
    "opset_import": _f(8, "message", True, "OperatorSetIdProto")})
