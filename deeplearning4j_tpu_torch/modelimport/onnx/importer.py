"""ONNX ModelProto -> SameDiff import (counterpart:
``deeplearning4j_tpu/modelimport/onnx/importer.py``; ref:
nd4j/samediff-import-onnx — OnnxFrameworkImporter.runImport + per-op
OnnxMappingProcess rules).

The same declarative architecture as the TF importer (one rule per
op_type, emitting shared-registry ops onto a SameDiff graph) — the
reference's rule table, emitting the same nodes under the same names, so
the two packages' imports of one model match op for op. Two
ONNX-specific simplifications:

- ONNX is **NCHW-native** for conv/pool, matching this framework's cnn
  ops — no layout transposes are needed (the TF path wraps every spatial
  op in NHWC<->NCHW permutes).
- Attribute-carrying inputs (Reshape shapes, Slice starts/ends, Clip
  bounds) are initializers or Constant nodes in practice; the importer
  resolves them eagerly to python values, as the reference's mapping
  rules read initializer protos.

The wire format is read by the pure-Python ``wire`` module (the schema
of the reference's ``onnx_minimal.proto``), so neither ``onnx`` nor
``google.protobuf`` is needed.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable
from deeplearning4j_tpu_torch.modelimport.onnx import wire as onnx_pb

# TensorProto.DataType -> numpy
_NP_DT = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def tensor_to_numpy(t) -> np.ndarray:
    """Decode a TensorProto (raw_data or typed repeated fields)."""
    dt = _NP_DT.get(t.data_type)
    if dt is None:
        raise ValueError(f"unsupported ONNX tensor dtype {t.data_type}")
    dims = tuple(t.dims)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dt)
    elif t.float_data:
        arr = np.asarray(list(t.float_data), dtype=dt)
    elif t.int64_data:
        arr = np.asarray(list(t.int64_data), dtype=dt)
    elif t.int32_data:
        arr = np.asarray(list(t.int32_data), dtype=dt)
    elif t.double_data:
        arr = np.asarray(list(t.double_data), dtype=dt)
    else:
        arr = np.zeros(int(np.prod(dims)) if dims else 1, dtype=dt)
    return arr.reshape(dims)


def numpy_to_tensor(name: str, arr: np.ndarray):
    """Encode (used by tests / model writers)."""
    rev = {np.dtype(v): k for k, v in _NP_DT.items()}
    t = onnx_pb.TensorProto()
    t.name = name
    t.data_type = rev[arr.dtype]
    t.dims.extend(arr.shape)
    t.raw_data = arr.tobytes()
    return t


class OnnxFrameworkImporter:
    """(ref: org.nd4j.samediff.frameworkimport.onnx.importer.
    OnnxFrameworkImporter)."""

    @staticmethod
    def runImport(model_or_path, device=None) -> SameDiff:
        """Import a ModelProto (this package's, or any message with
        ``SerializeToString()`` — the reference's protoc one), its
        serialized bytes, or an ``.onnx`` path into a SameDiff graph on
        ``device`` (default ``"cuda"``)."""
        model = _load_model(model_or_path)
        return _OnnxGraphImporter(model, device).run()


def _load_model(src):
    if isinstance(src, onnx_pb.ModelProto):
        return src
    m = onnx_pb.ModelProto()
    if isinstance(src, (bytes, bytearray, memoryview)):
        m.ParseFromString(src)
        return m
    if hasattr(src, "SerializeToString"):
        m.ParseFromString(src.SerializeToString())
        return m
    with open(src, "rb") as f:
        m.ParseFromString(f.read())
    return m


def _attrs(node) -> Dict[str, Any]:
    out = {}
    for a in node.attribute:
        T = onnx_pb.AttributeProto
        if a.type == T.FLOAT:
            out[a.name] = a.f
        elif a.type == T.INT:
            out[a.name] = int(a.i)
        elif a.type == T.STRING:
            out[a.name] = bytes(a.s).decode("utf-8")
        elif a.type == T.TENSOR:
            out[a.name] = tensor_to_numpy(a.t)
        elif a.type == T.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == T.INTS:
            out[a.name] = [int(i) for i in a.ints]
        elif a.type == T.STRINGS:
            out[a.name] = [bytes(s).decode("utf-8") for s in a.strings]
        else:
            out[a.name] = a
    return out


def _onnx_pads(pads: List[int], spatial: int):
    """ONNX pads = [b1..bn, e1..en] -> ((b1,e1), ...)."""
    if not pads:
        return [(0, 0)] * spatial
    return list(zip(pads[:spatial], pads[spatial:]))


class _OnnxGraphImporter:
    def __init__(self, model, device=None):
        self.model = model
        self.g = model.graph
        self.sd = SameDiff.create(device)
        self.vars: Dict[str, SDVariable] = {}
        self.consts: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------- helpers
    def _in(self, node, i) -> SDVariable:
        return self.vars[node.input[i]]

    def _opt(self, node, i):
        if i < len(node.input) and node.input[i]:
            return self.vars[node.input[i]]
        return None

    def _const(self, node, i) -> np.ndarray:
        name = node.input[i]
        if name not in self.consts:
            raise ValueError(
                f"input {i} of {node.name or node.op_type} must be an "
                f"initializer/Constant (dynamic attribute inputs unsupported)")
        return self.consts[name]

    def _emit(self, ns, opname, inputs, name, **kw) -> SDVariable:
        return self.sd._op(ns, opname, inputs, name=name, **kw)

    def _register(self, node, outs):
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        for ref, o in zip(node.output, outs):
            if ref:
                self.vars[ref] = o

    # ----------------------------------------------------------------- run
    def run(self) -> SameDiff:
        init_names = set()
        for t in self.g.initializer:
            arr = tensor_to_numpy(t)
            self.consts[t.name] = arr
            # a copy: raw_data's array is a read-only view of the model bytes
            self.vars[t.name] = self.sd.constant(t.name, np.array(arr))
            init_names.add(t.name)
        for vi in self.g.input:
            if vi.name in init_names:
                continue  # pre-IR4 models list initializers as inputs too
            shape = None
            tt = vi.type.tensor_type
            if tt.shape.dim:
                shape = tuple(d.dim_value if d.dim_value > 0 else None
                              for d in tt.shape.dim)
            dt = np.dtype(_NP_DT.get(tt.elem_type, np.float32)).name
            self.vars[vi.name] = self.sd.placeHolder(vi.name, shape=shape, dtype=dt)
        for node in self.g.node:
            self._map_node(node)
        # graph outputs keep their ONNX names: vars are registered by tensor
        # name, so a node's output name is its SameDiff variable's
        return self.sd

    def outputs(self) -> List[str]:
        return [o.name for o in self.g.output]

    def _map_node(self, node):
        op = node.op_type
        rule = _RULES.get(op)
        if rule is None:
            raise ValueError(f"ONNX op '{op}' (node {node.name}) has no "
                             f"mapping rule (ref: OpMappingRegistry lookup)")
        out = rule(self, node)
        if out is not None:
            self._register(node, out)
            # eager const folding for attribute-carrying chains
            # (Shape->Gather->Unsqueeze->Concat feeding a Reshape)
            if all((not i) or i in self.consts for i in node.input) and node.input:
                try:
                    outs = out if isinstance(out, (tuple, list)) else [out]
                    for ref, o in zip(node.output, outs):
                        self.consts[ref] = np.asarray(o.eval({}).toNumpy())
                except Exception:
                    pass


_RULES: Dict[str, Any] = {}


def rule(*op_types):
    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn
    return deco


# ------------------------------------------------------------- elementwise

for _t, _ns, _o in [
    ("Add", "math", "add"), ("Sub", "math", "sub"), ("Mul", "math", "mul"),
    ("Div", "math", "div"), ("Pow", "math", "pow"),
    ("Equal", "math", "eq"), ("Greater", "math", "gt"), ("Less", "math", "lt"),
    ("GreaterOrEqual", "math", "gte"), ("LessOrEqual", "math", "lte"),
    ("And", "math", "logicalAnd"), ("Or", "math", "logicalOr"),
    ("Xor", "math", "logicalXor"), ("Min", "math", "min"), ("Max", "math", "max"),
]:
    _RULES[_t] = (lambda ns, o: lambda g, n: g._emit(
        ns, o, [g._in(n, 0), g._in(n, 1)], n.output[0]))(_ns, _o)

for _t, _ns, _o in [
    ("Abs", "math", "abs"), ("Neg", "math", "neg"), ("Exp", "math", "exp"),
    ("Log", "math", "log"), ("Sqrt", "math", "sqrt"),
    ("Reciprocal", "math", "reciprocal"), ("Floor", "math", "floor"),
    ("Ceil", "math", "ceil"), ("Round", "math", "round"), ("Sign", "math", "sign"),
    ("Sin", "math", "sin"), ("Cos", "math", "cos"), ("Tan", "math", "tan"),
    ("Asin", "math", "asin"), ("Acos", "math", "acos"), ("Atan", "math", "atan"),
    ("Sinh", "math", "sinh"), ("Cosh", "math", "cosh"), ("Tanh", "math", "tanh"),
    ("Erf", "math", "erf"), ("Not", "math", "logicalNot"),
    ("Relu", "nn", "relu"), ("Sigmoid", "nn", "sigmoid"),
    ("Softplus", "nn", "softplus"), ("Softsign", "nn", "softsign"),
    ("Identity", "math", "identity"),
]:
    _RULES[_t] = (lambda ns, o: lambda g, n: g._emit(
        ns, o, [g._in(n, 0)], n.output[0]))(_ns, _o)


@rule("Constant")
def _constant(g, n):
    a = _attrs(n)
    if "value" in a:
        val = a["value"]
    elif "value_float" in a:
        val = np.float32(a["value_float"])
    elif "value_int" in a:
        val = np.int64(a["value_int"])
    elif "value_floats" in a:
        val = np.asarray(a["value_floats"], np.float32)
    elif "value_ints" in a:
        val = np.asarray(a["value_ints"], np.int64)
    else:
        raise ValueError("Constant node without value attribute")
    g.consts[n.output[0]] = np.asarray(val)
    return g.sd.constant(n.output[0], np.array(val))


@rule("LeakyRelu")
def _leaky(g, n):
    alpha = _attrs(n).get("alpha", 0.01)
    return g._emit("nn", "leakyRelu", [g._in(n, 0)], n.output[0], alpha=alpha)


@rule("Elu")
def _elu(g, n):
    alpha = _attrs(n).get("alpha", 1.0)
    return g._emit("nn", "elu", [g._in(n, 0)], n.output[0], alpha=alpha)


@rule("Selu")
def _selu(g, n):
    return g._emit("nn", "selu", [g._in(n, 0)], n.output[0])


@rule("HardSigmoid")
def _hard_sigmoid(g, n):
    a = _attrs(n)
    alpha, beta = a.get("alpha", 0.2), a.get("beta", 0.5)
    x = g._in(n, 0)
    ax = g._emit("math", "mul", [x, alpha], f"{n.output[0]}/ax")
    axb = g._emit("math", "add", [ax, beta], f"{n.output[0]}/axb")
    return g._emit("math", "clipByValue", [axb], n.output[0], lo=0.0, hi=1.0)


@rule("PRelu")
def _prelu(g, n):
    return g._emit("nn", "prelu", [g._in(n, 0), g._in(n, 1)], n.output[0])


@rule("Softmax")
def _softmax(g, n):
    axis = _attrs(n).get("axis", -1)
    return g._emit("nn", "softmax", [g._in(n, 0)], n.output[0], axis=axis)


@rule("LogSoftmax")
def _log_softmax(g, n):
    axis = _attrs(n).get("axis", -1)
    return g._emit("nn", "logSoftmax", [g._in(n, 0)], n.output[0], axis=axis)


@rule("Clip")
def _clip(g, n):
    a = _attrs(n)
    if "min" in a or "max" in a:  # opset < 11
        lo, hi = a.get("min", -np.inf), a.get("max", np.inf)
    else:
        lo = float(g._const(n, 1)) if len(n.input) > 1 and n.input[1] else -np.inf
        hi = float(g._const(n, 2)) if len(n.input) > 2 and n.input[2] else np.inf
    return g._emit("math", "clipByValue", [g._in(n, 0)], n.output[0], lo=lo, hi=hi)


@rule("Where")
def _where(g, n):
    return g._emit("shape", "where", [g._in(n, 0), g._in(n, 1), g._in(n, 2)],
                   n.output[0])


@rule("Cast")
def _cast(g, n):
    to = _NP_DT[_attrs(n)["to"]]
    return g._emit("shape", "castTo", [g._in(n, 0)], n.output[0],
                   dtype=np.dtype(to).name)


@rule("Dropout")
def _dropout(g, n):
    # inference import: dropout is identity (ref: the reference imports
    # Dropout as noop outside training)
    return g._emit("math", "identity", [g._in(n, 0)], n.output[0])


# ------------------------------------------------------------------ matmul


@rule("MatMul")
def _matmul(g, n):
    return g._emit("linalg", "matmul", [g._in(n, 0), g._in(n, 1)], n.output[0])


@rule("Gemm")
def _gemm(g, n):
    a = _attrs(n)
    alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
    transA, transB = a.get("transA", 0), a.get("transB", 0)
    A, B = g._in(n, 0), g._in(n, 1)
    if transA:
        A = g._emit("shape", "transpose", [A], f"{n.output[0]}/At")
    if transB:
        B = g._emit("shape", "transpose", [B], f"{n.output[0]}/Bt")
    out = g._emit("linalg", "matmul", [A, B], f"{n.output[0]}/mm")
    if alpha != 1.0:
        out = g._emit("math", "mul", [out, alpha], f"{n.output[0]}/alpha")
    if len(n.input) > 2 and n.input[2]:
        C = g._in(n, 2)
        if beta != 1.0:
            C = g._emit("math", "mul", [C, beta], f"{n.output[0]}/beta")
        out = g._emit("math", "add", [out, C], n.output[0])
    else:
        out = g._emit("math", "identity", [out], n.output[0])
    return out


# ------------------------------------------------------------ conv / pool


@rule("Conv")
def _conv(g, n):
    a = _attrs(n)
    w = g._in(n, 1)
    b = g._opt(n, 2)
    kshape = a.get("kernel_shape") or list(g._const(n, 1).shape[2:])
    spatial = len(kshape)
    strides = tuple(a.get("strides", [1] * spatial))
    dilations = tuple(a.get("dilations", [1] * spatial))
    groups = a.get("group", 1)
    auto_pad = a.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = "SAME"
    elif auto_pad == "VALID" or not a.get("pads"):
        padding = "VALID" if not a.get("pads") else _onnx_pads(a["pads"], spatial)
    else:
        padding = _onnx_pads(a["pads"], spatial)
    inputs = [g._in(n, 0), w] + ([b] if b is not None else [])
    if spatial == 2:
        return g._emit("cnn", "conv2d", inputs, n.output[0], strides=strides,
                       padding=padding, dilation=dilations, groups=groups)
    if spatial == 1:
        if groups != 1:
            raise ValueError("grouped Conv1d import unsupported")
        return g._emit("cnn", "conv1d", inputs, n.output[0],
                       strides=strides[0], padding=padding)
    if groups != 1:
        raise ValueError("grouped Conv3d import unsupported")
    return g._emit("cnn", "conv3d", inputs, n.output[0], strides=strides,
                   padding=padding)


def _pool_rule(kind):
    def fn(g, n):
        a = _attrs(n)
        kshape = a["kernel_shape"]
        spatial = len(kshape)
        strides = tuple(a.get("strides", [1] * spatial))
        auto_pad = a.get("auto_pad", "NOTSET")
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            padding = "SAME"
        elif a.get("pads"):
            padding = _onnx_pads(a["pads"], spatial)
        else:
            padding = "VALID"
        opname = {1: f"{kind}Pool1d", 2: f"{kind}Pool2d", 3: f"{kind}Pool3d"}[spatial]
        kernel = kshape[0] if spatial == 1 else tuple(kshape)
        stride = strides[0] if spatial == 1 else strides
        return g._emit("cnn", opname, [g._in(n, 0)], n.output[0],
                       kernel=kernel, strides=stride, padding=padding)
    return fn


_RULES["MaxPool"] = _pool_rule("max")
_RULES["AveragePool"] = _pool_rule("avg")


@rule("GlobalAveragePool")
def _gap(g, n):
    return g._emit("cnn", "globalAvgPool", [g._in(n, 0)], n.output[0],
                   keepdims=True)


@rule("GlobalMaxPool")
def _gmp(g, n):
    return g._emit("cnn", "globalMaxPool", [g._in(n, 0)], n.output[0],
                   keepdims=True)


@rule("BatchNormalization")
def _batchnorm(g, n):
    eps = _attrs(n).get("epsilon", 1e-5)
    x, scale, bias, mean, var = (g._in(n, i) for i in range(5))
    return g._emit("nn", "batchNorm", [x, mean, var, scale, bias], n.output[0],
                   eps=eps, axis=1)


@rule("InstanceNormalization")
def _instancenorm(g, n):
    eps = _attrs(n).get("epsilon", 1e-5)
    x, scale, bias = g._in(n, 0), g._in(n, 1), g._in(n, 2)
    # normalize over spatial dims per-sample per-channel
    return g._emit("nn", "instanceNorm", [x, scale, bias], n.output[0], eps=eps)


@rule("LRN")
def _lrn(g, n):
    a = _attrs(n)
    size = a.get("size", 5)
    return g._emit("nn", "lrn", [g._in(n, 0)], n.output[0],
                   depth_radius=(size - 1) // 2, bias=a.get("bias", 1.0),
                   alpha=a.get("alpha", 1e-4) / size, beta=a.get("beta", 0.75))


@rule("Flatten")
def _flatten(g, n):
    """ONNX Flatten: 2D output (prod(dims[:axis]), prod(dims[axis:]))."""
    axis = _attrs(n).get("axis", 1)
    x = g._in(n, 0)
    dims = list(x.shape or ())
    lead, tail = dims[:axis], dims[axis:]
    if all(d is not None for d in tail):
        shape = (-1, int(np.prod(tail)) if tail else 1)
    elif all(d is not None for d in lead):
        shape = (int(np.prod(lead)) if lead else 1, -1)
    else:
        raise ValueError(f"Flatten {n.name}: unresolvable shape {dims}")
    return g._emit("shape", "reshape", [x], n.output[0], shape=shape)


# ------------------------------------------------------------ shape ops


@rule("Reshape")
def _reshape(g, n):
    shape = [int(s) for s in g._const(n, 1)]
    return g._emit("shape", "reshape", [g._in(n, 0)], n.output[0], shape=shape)


@rule("Transpose")
def _transpose(g, n):
    perm = _attrs(n).get("perm")
    if perm is None:
        return g._emit("shape", "transpose", [g._in(n, 0)], n.output[0])
    return g._emit("shape", "permute", [g._in(n, 0)], n.output[0],
                   axes=tuple(perm))


@rule("Concat")
def _concat(g, n):
    axis = _attrs(n)["axis"]
    ins = [g.vars[i] for i in n.input]
    return g._emit("shape", "concatN", ins, n.output[0], axis=axis)


@rule("Split")
def _split(g, n):
    a = _attrs(n)
    axis = a.get("axis", 0)
    x = g._in(n, 0)
    if "split" in a:
        sizes = a["split"]
    elif len(n.input) > 1 and n.input[1]:
        sizes = [int(s) for s in g._const(n, 1)]
    else:
        sizes = None
    if axis < 0:
        axis += len(x.shape or ())
    if sizes is None:
        num = len(n.output)
        outs = g._emit("shape", "splitN", [x], n.output[0], num=num, axis=axis)
        return list(outs) if isinstance(outs, (tuple, list)) else [outs]
    outs = []
    start = 0
    for i, s in enumerate(sizes):
        sl = [slice(None)] * axis + [slice(start, start + s)]
        outs.append(g._emit("shape", "stridedSlice", [x], n.output[i],
                            slices=tuple(sl)))
        start += s
    return outs


@rule("Squeeze")
def _squeeze(g, n):
    a = _attrs(n)
    axes = a.get("axes")
    if axes is None and len(n.input) > 1 and n.input[1]:
        axes = [int(i) for i in g._const(n, 1)]
    return g._emit("shape", "squeeze", [g._in(n, 0)], n.output[0],
                   axis=tuple(axes) if axes else None)


@rule("Unsqueeze")
def _unsqueeze(g, n):
    a = _attrs(n)
    axes = a.get("axes")
    if axes is None:
        axes = [int(i) for i in g._const(n, 1)]
    out = g._in(n, 0)
    for i, ax in enumerate(sorted(axes)):
        nm = n.output[0] if i == len(axes) - 1 else f"{n.output[0]}/u{i}"
        out = g._emit("shape", "expandDims", [out], nm, axis=ax)
    return out


@rule("Gather")
def _gather(g, n):
    axis = _attrs(n).get("axis", 0)
    return g._emit("shape", "gather", [g._in(n, 0), g._in(n, 1)], n.output[0],
                   axis=axis)


@rule("Slice")
def _slice(g, n):
    a = _attrs(n)
    if "starts" in a:  # opset < 10
        starts, ends = a["starts"], a["ends"]
        axes = a.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = [int(i) for i in g._const(n, 1)]
        ends = [int(i) for i in g._const(n, 2)]
        axes = ([int(i) for i in g._const(n, 3)]
                if len(n.input) > 3 and n.input[3] else list(range(len(starts))))
        steps = ([int(i) for i in g._const(n, 4)]
                 if len(n.input) > 4 and n.input[4] else [1] * len(starts))
    x = g._in(n, 0)
    rank = len(x.shape or ())
    INT_MAX = 2 ** 31 - 1
    slices = [slice(None)] * rank
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if ax < 0:
            ax += rank
        en = None if en >= INT_MAX else en  # INT64_MAX/INT32_MAX = "to end"
        slices[ax] = slice(st, en, sp)
    return g._emit("shape", "stridedSlice", [x], n.output[0],
                   slices=tuple(slices))


@rule("Pad")
def _pad_rule(g, n):
    a = _attrs(n)
    mode = a.get("mode", "constant")
    if mode != "constant":
        raise ValueError(f"Pad mode {mode} unsupported")
    if "pads" in a:
        pads = a["pads"]
        value = a.get("value", 0.0)
    else:
        pads = [int(i) for i in g._const(n, 1)]
        value = float(g._const(n, 2)) if len(n.input) > 2 and n.input[2] else 0.0
    rank = len(pads) // 2
    pairs = [(pads[i], pads[i + rank]) for i in range(rank)]
    return g._emit("shape", "pad", [g._in(n, 0)], n.output[0],
                   paddings=pairs, value=value)


@rule("Expand")
def _expand(g, n):
    shape = [int(s) for s in g._const(n, 1)]
    return g._emit("shape", "broadcastTo", [g._in(n, 0)], n.output[0],
                   shape=shape)


@rule("Shape")
def _shape(g, n):
    return g._emit("shape", "shapeOf", [g._in(n, 0)], n.output[0])


@rule("ConstantOfShape")
def _const_of_shape(g, n):
    shape = [int(s) for s in g._const(n, 0)]
    val = _attrs(n).get("value")
    fill = float(val.ravel()[0]) if val is not None else 0.0
    dtype = val.dtype if val is not None else np.float32
    arr = np.full(shape, fill, dtype=dtype)
    g.consts[n.output[0]] = arr
    return g.sd.constant(n.output[0], arr)


@rule("Tile")
def _tile(g, n):
    reps = [int(i) for i in g._const(n, 1)]
    return g._emit("shape", "tile", [g._in(n, 0)], n.output[0], reps=reps)


@rule("Range")
def _range(g, n):
    start, limit, delta = (g._const(n, i) for i in range(3))
    # ONNX: output dtype == input dtype (int Range must stay integer —
    # float-folding would break Gather indices downstream)
    dtype = np.result_type(start.dtype, limit.dtype, delta.dtype)
    arr = np.arange(start.item(), limit.item(), delta.item(), dtype=dtype)
    g.consts[n.output[0]] = arr
    return g.sd.constant(n.output[0], arr)


# ------------------------------------------------------------- reductions


def _reduce_rule(opname):
    def fn(g, n):
        a = _attrs(n)
        axes = a.get("axes")
        if axes is None and len(n.input) > 1 and n.input[1]:
            axes = [int(i) for i in g._const(n, 1)]
        keepdims = bool(a.get("keepdims", 1))
        return g._emit("reduce", opname, [g._in(n, 0)], n.output[0],
                       dims=tuple(axes) if axes else None, keepdims=keepdims)
    return fn


for _t, _o in [("ReduceSum", "sum"), ("ReduceMean", "mean"), ("ReduceMax", "max"),
               ("ReduceMin", "min"), ("ReduceProd", "prod")]:
    _RULES[_t] = _reduce_rule(_o)


@rule("ArgMax")
def _argmax(g, n):
    a = _attrs(n)
    return g._emit("reduce", "argmax", [g._in(n, 0)], n.output[0],
                   dims=a.get("axis", 0), keepdims=bool(a.get("keepdims", 1)))


@rule("ArgMin")
def _argmin(g, n):
    a = _attrs(n)
    return g._emit("reduce", "argmin", [g._in(n, 0)], n.output[0],
                   dims=a.get("axis", 0), keepdims=bool(a.get("keepdims", 1)))


# ---------------------------------------------------------------------------
# Recurrent ops, ConvTranspose, Resize, einsum, indexing,
# reductions, and activation stragglers (ref: samediff-import-onnx rule set).

_UNARY2 = [
    ("HardSwish", "nn", "hardSwish"), ("Mish", "nn", "mish"),
    ("IsNaN", "math", "isnan"), ("IsInf", "math", "isinf"),
    ("Acosh", "math", "acosh"), ("Asinh", "math", "asinh"),
    ("Atanh", "math", "atanh"), ("Cosh", "math", "cosh"),
    ("Tanh", "math", "tanh"), ("Erf", "math", "erf"),
]
for _t, _ns, _o in _UNARY2:
    if _t not in _RULES:
        _RULES[_t] = (lambda ns, o: lambda g, n: g._emit(
            ns, o, [g._in(n, 0)], n.output[0]))(_ns, _o)


@rule("Celu")
def _celu(g, n):
    return g._emit("nn", "celu", [g._in(n, 0)], n.output[0],
                   alpha=_attrs(n).get("alpha", 1.0))


@rule("ThresholdedRelu")
def _thresholded_relu(g, n):
    return g._emit("nn", "thresholdRelu", [g._in(n, 0)], n.output[0],
                   theta=_attrs(n).get("alpha", 1.0))


@rule("Shrink")
def _shrink(g, n):
    a = _attrs(n)
    return g._emit("nn", "shrink", [g._in(n, 0)], n.output[0],
                   bias=a.get("bias", 0.0), lambd=a.get("lambd", 0.5))


@rule("Mod")
def _mod(g, n):
    fmod = _attrs(n).get("fmod", 0)
    opname = "fmod" if fmod else "mod"
    return g._emit("math", opname, [g._in(n, 0), g._in(n, 1)], n.output[0])


@rule("Sum")
def _sum_variadic(g, n):
    if len(n.input) == 1:  # legal ONNX identity form
        return g._emit("math", "identity", [g._in(n, 0)], n.output[0])
    out = g._in(n, 0)
    for i in range(1, len(n.input)):
        out = g._emit("math", "add", [out, g._in(n, i)],
                      f"{n.output[0]}/acc{i}" if i < len(n.input) - 1
                      else n.output[0])
    return out


@rule("Mean")
def _mean_variadic(g, n):
    k = len(n.input)
    out = g._in(n, 0)
    for i in range(1, k):
        out = g._emit("math", "add", [out, g._in(n, i)], f"{n.output[0]}/acc{i}")
    inv = g.sd.constant(f"{n.output[0]}/invk", np.float32(1.0 / k))
    return g._emit("math", "mul", [out, inv], n.output[0])


def _reduce_composed(inner, post=None, pre=None):
    """ReduceL1/L2/LogSum/LogSumExp/SumSquare as compositions."""
    def fn(g, n):
        a = _attrs(n)
        axes = a.get("axes")
        if axes is None and len(n.input) > 1 and n.input[1]:
            axes = [int(i) for i in g._const(n, 1)]
        keepdims = bool(a.get("keepdims", 1))
        x = g._in(n, 0)
        if pre:
            x = g._emit("math", pre, [x], n.output[0] + "/pre")
        red = g._emit("reduce", inner, [x],
                      n.output[0] + "/red" if post else n.output[0],
                      dims=tuple(axes) if axes else None, keepdims=keepdims)
        if post:
            return g._emit("math", post, [red], n.output[0])
        return red
    return fn


_RULES["ReduceL1"] = _reduce_rule("norm1")
_RULES["ReduceSumSquare"] = _reduce_rule("squaredNorm")
_RULES["ReduceL2"] = _reduce_rule("norm2")
_RULES["ReduceLogSum"] = _reduce_composed("sum", post="log")


@rule("ReduceLogSumExp")
def _reduce_lse(g, n):
    a = _attrs(n)
    axes = a.get("axes")
    if axes is None and len(n.input) > 1 and n.input[1]:
        axes = [int(i) for i in g._const(n, 1)]
    keepdims = bool(a.get("keepdims", 1))
    return g._emit("reduce", "logSumExp", [g._in(n, 0)], n.output[0],
                   dims=tuple(axes) if axes else None, keepdims=keepdims)


@rule("Einsum")
def _einsum_onnx(g, n):
    eq = _attrs(n)["equation"]
    if isinstance(eq, bytes):
        eq = eq.decode()
    return g._emit("linalg", "einsum", [g._in(n, i) for i in range(len(n.input))],
                   n.output[0], equation=eq)


@rule("TopK")
def _topk_onnx(g, n):
    a = _attrs(n)
    k = int(np.atleast_1d(g._const(n, 1))[0])
    axis = a.get("axis", -1)
    largest = a.get("largest", 1)
    x = g._in(n, 0)
    if axis not in (-1, len(x.shape or []) - 1):
        raise ValueError("TopK: only last-axis supported")
    if not largest:  # smallest-k via negation (indices unaffected)
        x = g._emit("math", "neg", [x], n.output[0] + "/neg")
    vals, idx = g._emit("math", "topK", [x], n.output[0] + "/tk", k=k)
    if not largest:
        vals = g._emit("math", "neg", [vals], n.output[0] + "/vneg")
    outs = [g._emit("math", "identity", [o], ref)
            for ref, o in zip(n.output, (vals, idx)) if ref]
    g._register(n, outs)
    return None


@rule("CumSum")
def _cumsum_onnx(g, n):
    a = _attrs(n)
    axis = int(np.atleast_1d(g._const(n, 1))[0])
    x = g._in(n, 0)
    if a.get("reverse"):
        x = g._emit("shape", "reverse", [x], n.output[0] + "/rin", dims=(axis,))
    out = g._emit("shape", "cumsum", [x], n.output[0] + "/cs", axis=axis)
    if a.get("exclusive"):
        out = g._emit("math", "sub", [out, x], n.output[0] + "/excl")
    if a.get("reverse"):
        out = g._emit("shape", "reverse", [out], n.output[0] + "/rout",
                      dims=(axis,))
    return g._emit("math", "identity", [out], n.output[0])


@rule("OneHot")
def _onehot_onnx(g, n):
    depth = int(np.atleast_1d(g._const(n, 1))[0])
    values = g._const(n, 2)  # [off, on]
    axis = _attrs(n).get("axis", -1)
    return g._emit("shape", "oneHot", [g._in(n, 0)], n.output[0],
                   depth=depth, axis=axis, on=float(values[1]),
                   off=float(values[0]))


@rule("GatherND")
def _gather_nd_onnx(g, n):
    if _attrs(n).get("batch_dims", 0):
        raise ValueError("GatherND: batch_dims unsupported")
    return g._emit("shape", "gatherNd", [g._in(n, 0), g._in(n, 1)], n.output[0])


@rule("ScatterND")
def _scatter_nd_onnx(g, n):
    red = _attrs(n).get("reduction", "none")
    if isinstance(red, bytes):
        red = red.decode()
    opname = {"none": "scatterNdUpdate", "add": "scatterNdAdd"}.get(red)
    if opname is None:
        raise ValueError(f"ScatterND: reduction '{red}' unsupported")
    return g._emit("shape", opname,
                   [g._in(n, 0), g._in(n, 1), g._in(n, 2)], n.output[0])


@rule("GatherElements")
def _gather_elements(g, n):
    return g._emit("shape", "gatherElements", [g._in(n, 0), g._in(n, 1)],
                   n.output[0], axis=_attrs(n).get("axis", 0))


@rule("ScatterElements")
def _scatter_elements(g, n):
    a = _attrs(n)
    red = a.get("reduction", "none")
    if isinstance(red, bytes):
        red = red.decode()
    return g._emit("shape", "scatterElements",
                   [g._in(n, 0), g._in(n, 1), g._in(n, 2)], n.output[0],
                   axis=a.get("axis", 0), reduction=red)


@rule("EyeLike")
def _eyelike(g, n):
    return g._emit("shape", "eyeLike", [g._in(n, 0)], n.output[0],
                   k=_attrs(n).get("k", 0))


@rule("Trilu")
def _trilu(g, n):
    upper = _attrs(n).get("upper", 1)
    k = 0
    if len(n.input) > 1 and n.input[1]:
        k = int(np.atleast_1d(g._const(n, 1))[0])
    return g._emit("shape", "triu" if upper else "tril", [g._in(n, 0)],
                   n.output[0], k=k)


@rule("MeanVarianceNormalization")
def _mvn(g, n):
    axes = tuple(_attrs(n).get("axes", (0, 2, 3)))
    return g._emit("nn", "meanVarianceNormalization", [g._in(n, 0)],
                   n.output[0], axes=axes)


@rule("DepthToSpace")
def _d2s_onnx(g, n):
    a = _attrs(n)
    bs = int(a["blocksize"])
    mode = a.get("mode", "DCR")
    if isinstance(mode, bytes):
        mode = mode.decode()
    x = g._in(n, 0)
    if mode == "DCR":
        return g._emit("cnn", "depthToSpace", [x], n.output[0],
                       block_size=bs, data_format="NCHW")
    # CRD: reshape (N, C', b, b, H, W) -> permute -> (N, C', H*b, W*b)
    N, C, H, W = x.shape
    r1 = g._emit("shape", "reshape", [x], n.output[0] + "/r1",
                 shape=(N, C // (bs * bs), bs, bs, H, W))
    p = g._emit("shape", "permute", [r1], n.output[0] + "/p",
                axes=(0, 1, 4, 2, 5, 3))
    return g._emit("shape", "reshape", [p], n.output[0],
                   shape=(N, C // (bs * bs), H * bs, W * bs))


@rule("SpaceToDepth")
def _s2d_onnx(g, n):
    bs = int(_attrs(n)["blocksize"])
    return g._emit("cnn", "spaceToDepth", [g._in(n, 0)], n.output[0],
                   block_size=bs, data_format="NCHW")


@rule("ConvTranspose")
def _conv_transpose(g, n):
    a = _attrs(n)
    w = g._in(n, 1)  # ONNX: (C_in, C_out/groups, kH, kW)
    b = g._opt(n, 2)
    spatial = len(a.get("kernel_shape") or g._const(n, 1).shape[2:])
    if spatial != 2:
        raise ValueError("ConvTranspose: only 2D supported")
    if a.get("group", 1) != 1:
        raise ValueError("ConvTranspose: groups unsupported")
    strides = tuple(a.get("strides", [1, 1]))
    pads = a.get("pads")
    if a.get("output_padding") or a.get("output_shape"):
        raise ValueError("ConvTranspose: output_padding/output_shape unsupported")
    if pads and any(pads):
        padding = _onnx_pads(pads, 2)
    else:
        padding = "VALID"
    inputs = [g._in(n, 0), w] + ([b] if b is not None else [])
    return g._emit("cnn", "deconv2d", inputs, n.output[0], strides=strides,
                   padding=padding)


@rule("Resize", "Upsample")
def _resize_onnx(g, n):
    a = _attrs(n)
    mode = a.get("mode", "nearest")
    if isinstance(mode, bytes):
        mode = mode.decode()
    coord = a.get("coordinate_transformation_mode", "half_pixel")
    if isinstance(coord, bytes):
        coord = coord.decode()
    if n.op_type == "Upsample":
        coord = "asymmetric"  # the deprecated op's fixed semantics
        a = dict(a, nearest_mode="floor")
    x = g._in(n, 0)
    N, C, H, W = x.shape
    align = coord == "align_corners"
    half_pixel = coord in ("half_pixel", "pytorch_half_pixel")
    tf_car = coord == "tf_crop_and_resize"
    if not (align or half_pixel or coord == "asymmetric" or tf_car):
        raise ValueError(f"Resize: coordinate mode '{coord}' unsupported")
    extra = {}
    roi_hw = ((0.0, 1.0), (0.0, 1.0))
    if tf_car:
        # roi (input 1): 2*rank normalized starts then ends; only the
        # spatial axes may crop — N/C roi must be the identity [0, 1]
        roi_vals = [float(v) for v in g._const(n, 1)]
        starts, ends = roi_vals[:4], roi_vals[4:]
        if (starts[0], starts[1], ends[0], ends[1]) != (0.0, 0.0, 1.0, 1.0):
            raise ValueError("Resize(tf_crop_and_resize): N/C roi must be "
                             "[0, 1] — only spatial cropping is supported")
        roi_hw = ((starts[2], ends[2]), (starts[3], ends[3]))
        extra["roi"] = roi_hw
        extra["extrapolation_value"] = float(a.get("extrapolation_value", 0.0))
    if coord == "pytorch_half_pixel":
        extra["pytorch_half_pixel"] = True
    # sizes (input 3) take precedence over scales (input 2; Upsample: input 1)
    if len(n.input) > 3 and n.input[3]:
        sizes = [int(s) for s in g._const(n, 3)]
        out_hw = (sizes[2], sizes[3])
    else:
        scale_idx = 1 if n.op_type == "Upsample" else 2
        scales = [float(s) for s in g._const(n, scale_idx)]
        # tf_crop_and_resize scales apply to the ROI extent, not the full
        # image: output_dim = floor(input_dim * (roi_end - roi_start) * scale)
        eh = roi_hw[0][1] - roi_hw[0][0]
        ew = roi_hw[1][1] - roi_hw[1][0]
        out_hw = (int(H * eh * scales[2]), int(W * ew * scales[3]))
    if mode == "nearest":
        nearest_mode = a.get("nearest_mode", "round_prefer_floor")
        if isinstance(nearest_mode, bytes):
            nearest_mode = nearest_mode.decode()
        if nearest_mode not in ("floor", "round_prefer_floor"):
            raise ValueError(f"Resize: nearest_mode '{nearest_mode}' unsupported")
        opname = "resizeNearest"
        extra["nearest_mode"] = nearest_mode
    elif mode in ("linear", "bilinear"):
        opname = "resizeBilinear"
    elif mode == "cubic":
        opname = "resizeBicubic"
        extra["cubic_coeff_a"] = float(a.get("cubic_coeff_a", -0.75))
        extra["exclude_outside"] = bool(a.get("exclude_outside", 0))
    else:
        raise ValueError(f"Resize: mode '{mode}' unsupported")
    return g._emit("image", opname, [x], n.output[0], size=out_hw,
                   data_format="NCHW", align_corners=align,
                   half_pixel_centers=half_pixel, **extra)


def _rnn_common(g, n, opname, extra_kw):
    """ONNX LSTM/GRU/RNN share the optional-input layout (B, sequence_lens,
    initial_h[, initial_c]); missing optionals are materialized as their
    defaulting constants so the op call stays uniformly positional."""
    a = _attrs(n)
    direction = a.get("direction", "forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    x, w, r = g._in(n, 0), g._in(n, 1), g._in(n, 2)
    T, B = x.shape[0], x.shape[1]
    if T is None or B is None:
        raise ValueError(
            f"{n.op_type} node '{n.name or n.output[0]}': dynamic time/batch "
            "dims need explicit sequence_lens/initial state inputs (defaults "
            "cannot be materialized from an unknown shape)")
    D, gates_h = w.shape[0], w.shape[1]
    H = {"lstmOnnx": gates_h // 4, "gruOnnx": gates_h // 3,
         "rnnOnnx": gates_h}[opname]
    n_b = {"lstmOnnx": 8, "gruOnnx": 6, "rnnOnnx": 2}[opname] * H

    def opt_or(i, name, default):
        v = g._opt(n, i)
        if v is None:
            v = g.sd.constant(f"{n.output[0]}/{name}", default)
        return v

    b = opt_or(3, "b0", np.zeros((D, n_b), np.float32))
    seq = opt_or(4, "seqlens", np.full((B,), T, np.int32))
    h0 = opt_or(5, "h0", np.zeros((D, B, H), np.float32))
    inputs = [x, w, r, b, seq, h0]
    if opname == "lstmOnnx":
        inputs.append(opt_or(6, "c0", np.zeros((D, B, H), np.float32)))
    outs = g._emit("rnn", opname, inputs, n.output[0] + "/rnn",
                   direction=direction, **extra_kw)
    # multi-output vars are named base#i — re-emit identities so each ONNX
    # output ref is a real SameDiff variable name
    outs = [g._emit("math", "identity", [o], ref)
            for ref, o in zip(n.output, outs) if ref]
    g._register(n, outs)
    return None


@rule("LSTM")
def _lstm_onnx_rule(g, n):
    if _attrs(n).get("layout", 0) != 0:
        raise ValueError("LSTM: layout=1 unsupported (use default T,B,I)")
    return _rnn_common(g, n, "lstmOnnx", {})


@rule("GRU")
def _gru_onnx_rule(g, n):
    a = _attrs(n)
    if a.get("layout", 0) != 0:
        raise ValueError("GRU: layout=1 unsupported")
    return _rnn_common(g, n, "gruOnnx",
                       {"linear_before_reset": a.get("linear_before_reset", 0)})


@rule("RNN")
def _rnn_onnx_rule(g, n):
    a = _attrs(n)
    if a.get("layout", 0) != 0:
        raise ValueError("RNN: layout=1 unsupported")
    acts = a.get("activations")
    act = "Tanh"
    if acts:
        act = acts[0].decode() if isinstance(acts[0], bytes) else acts[0]
    return _rnn_common(g, n, "rnnOnnx", {"activation": act})
