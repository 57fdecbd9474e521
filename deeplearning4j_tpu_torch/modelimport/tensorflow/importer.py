"""TF GraphDef -> SameDiff import (counterpart:
``deeplearning4j_tpu/modelimport/tensorflow/importer.py``; ref:
nd4j/samediff-import-tensorflow — TensorflowFrameworkImporter.runImport +
per-op MappingProcess rules; legacy path TFGraphMapper).

One mapping rule per TF op type, translating a NodeDef (attrs +
const-resolved inputs) into ops from the shared registry on a SameDiff
graph — the reference's 54 rules, emitting the same nodes under the same
names, so the two packages' imports of one GraphDef match op for op.
Layout: TF conv/pool nodes are NHWC; the registry's cnn ops are NCHW, so
rules wrap them in transposes.

The importer resolves Const nodes eagerly so attribute-carrying inputs
(axes, shapes, paddings, perms) become python values, exactly as the
reference's `MappingRule`s pull from initializers. ``tensorflow`` is
imported only inside the import functions: the package itself never
needs it.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable

# TF DataType enum -> dtype name
_TF_DT = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 6: "int8",
    9: "int64", 10: "bool", 14: "bfloat16", 19: "float16",
}


def _clean(name: str) -> str:
    if name.startswith("^"):
        return ""
    return name.split(":")[0]


class TensorflowFrameworkImporter:
    """(ref: org.nd4j.samediff.frameworkimport.tensorflow.importer.
    TensorflowFrameworkImporter)."""

    @staticmethod
    def runImport(graph_def_or_path, device=None) -> SameDiff:
        """Import a frozen GraphDef (proto object, serialized bytes, or .pb
        path) into a SameDiff graph on ``device`` (default ``"cuda"``)
        (ref: runImport / importFrozenTF)."""
        gd = _load_graphdef(graph_def_or_path)
        return _GraphImporter(gd, device).run()

    # reference-parity alias (SameDiff.importFrozenTF)
    importFrozenTF = runImport


def _load_graphdef(src):
    from tensorflow.core.framework import graph_pb2
    if isinstance(src, graph_pb2.GraphDef):
        return src
    gd = graph_pb2.GraphDef()
    if isinstance(src, bytes):
        gd.ParseFromString(src)
        return gd
    with open(src, "rb") as f:
        gd.ParseFromString(f.read())
    return gd


class _GraphImporter:
    def __init__(self, gd, device=None):
        self.gd = gd
        self.sd = SameDiff.create(device)
        self.vars: Dict[str, SDVariable] = {}     # tf node name -> SDVariable
        self.consts: Dict[str, np.ndarray] = {}   # eagerly-resolved Const values
        # function library (control-flow bodies; GraphDef.library.function)
        self.library: Dict[str, Any] = {
            f.signature.name: f for f in gd.library.function} if gd is not None else {}
        # NodeDef by name — rules peek at producers (e.g. Pack feeding Reshape)
        self.nodes: Dict[str, Any] = {
            n.name: n for n in gd.node} if gd is not None else {}

    # ------------------------------------------------------------- helpers
    def _resolve(self, ref: str) -> SDVariable:
        """Resolve a tensor reference. GraphDef refs are ``name[:idx]``;
        FunctionDef refs are ``name:out_arg:idx`` — multi-output nodes (While,
        If) register their extra outputs under ``name:idx``."""
        parts = ref.split(":")
        name = parts[0]
        idx = int(parts[-1]) if len(parts) > 1 and parts[-1].isdigit() else 0
        if idx:
            if f"{name}:{idx}" not in self.vars:
                raise KeyError(
                    f"tensor ref {ref}: node {name} registered no output {idx}")
            return self.vars[f"{name}:{idx}"]
        return self.vars[name]

    def _in(self, node, i) -> SDVariable:
        return self._resolve(node.input[i])

    def _const(self, node, i) -> np.ndarray:
        name = _clean(node.input[i])
        if name not in self.consts:
            raise ValueError(
                f"input {i} of {node.name} ({node.op}) must be a Const "
                f"(dynamic attribute inputs are not supported)")
        return self.consts[name]

    def _ins(self, node) -> List[SDVariable]:
        return [self._resolve(n) for n in node.input if _clean(n)]

    def _register_outputs(self, node, outs):
        """Register a multi-output node's results as name / name:i."""
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        self.vars[node.name] = outs[0]
        for i, o in enumerate(outs[1:], start=1):
            self.vars[f"{node.name}:{i}"] = o

    def _import_function(self, fname: str):
        """FunctionDef -> (sub-SameDiff, in_names, out_names) for control ops
        (ref: samediff-import maps tf.function bodies to SameDiff subgraphs)."""
        import tensorflow as tf
        fdef = self.library[fname]
        sub = _GraphImporter.__new__(_GraphImporter)
        sub.gd = None
        sub.sd = SameDiff.create(self.sd.device)
        sub.vars = {}
        sub.consts = {}
        sub.library = self.library
        sub.nodes = {n.name: n for n in fdef.node_def}
        in_names = []
        for arg in fdef.signature.input_arg:
            ph = sub.sd.placeHolder(arg.name, shape=None,
                                    dtype=_TF_DT.get(arg.type, "float32"))
            sub.vars[arg.name] = ph
            in_names.append(arg.name)
        for node in fdef.node_def:
            sub._map_node(node, tf)
        out_names = []
        for out_arg in fdef.signature.output_arg:
            ref = fdef.ret[out_arg.name]
            out_names.append(sub._resolve(ref).name)
        return sub.sd, in_names, out_names

    def _emit(self, ns: str, opname: str, inputs, name: str, **kwargs) -> SDVariable:
        out = self.sd._op(ns, opname, inputs, name=name, **kwargs)
        return out

    def _nhwc_to_nchw(self, v, name):
        return self._emit("shape", "permute", [v], f"{name}/nchw", axes=(0, 3, 1, 2))

    def _nchw_to_nhwc(self, v, name):
        return self._emit("shape", "permute", [v], f"{name}/nhwc", axes=(0, 2, 3, 1))

    # ----------------------------------------------------------------- run
    def run(self) -> SameDiff:
        import tensorflow as tf
        for node in self.gd.node:
            self._map_node(node, tf)
        return self.sd

    def _map_node(self, node, tf):
        op = node.op
        name = node.name
        sd = self.sd

        if op == "Const":
            val = tf.make_ndarray(node.attr["value"].tensor)
            self.consts[name] = val
            self.vars[name] = sd.constant(name, val)
            return
        if op == "Placeholder":
            shape = None
            if node.attr["shape"].shape.dim:
                shape = tuple(d.size if d.size > 0 else None
                              for d in node.attr["shape"].shape.dim)
            self.vars[name] = sd.placeHolder(
                name, shape=shape, dtype=_TF_DT.get(node.attr["dtype"].type, "float32"))
            return
        if op in ("Identity", "StopGradient", "PreventGradient", "Snapshot",
                  "CheckNumerics"):
            src = _clean(node.input[0])
            # emit a real node so the TF node name is addressable as a graph
            # output (frozen-fn outputs are typically named "Identity");
            # _resolve keeps multi-output refs like "while:1" intact
            self.vars[name] = self._emit(
                "math", "identity", [self._resolve(node.input[0])], name)
            if src in self.consts:
                self.consts[name] = self.consts[src]
            return
        if op == "NoOp":
            return

        fn = _RULES.get(op)
        if fn is None:
            raise ValueError(f"TF op '{op}' (node {name}) has no mapping rule "
                             f"(ref: OpMappingRegistry lookup failure)")
        out = fn(self, node)
        if out is not None:
            self.vars[name] = out
            # eager const folding: a node whose inputs are all consts is
            # itself a const (ref: the importer resolves constant subgraphs so
            # downstream rules can read attribute-carrying inputs — e.g.
            # StridedSlice over a constant-folded Shape feeding a Reshape)
            ins = [_clean(x) for x in node.input if _clean(x)]
            if ins and all(i in self.consts for i in ins):
                try:
                    val = _eval_const_node(self, node, out)
                    if val is not None:
                        self.consts[name] = val
                except Exception:
                    pass


def _eval_const_node(g, node, out: SDVariable):
    """Evaluate a const-input node's value at import time (small results only
    — shape math; folding megabyte weights would duplicate them)."""
    if out.shape is None or int(np.prod(out.shape or (1,))) > 4096:
        return None
    return np.asarray(out.eval({}).toNumpy())


# --------------------------------------------------------------- mapping rules

def _rule(*tf_ops):
    def deco(fn):
        for t in tf_ops:
            _RULES[t] = fn
        return fn
    return deco


_RULES: Dict[str, Any] = {}

_BINARY = {
    "Add": ("math", "add"), "AddV2": ("math", "add"), "Sub": ("math", "sub"),
    "Mul": ("math", "mul"), "RealDiv": ("math", "div"), "Div": ("math", "div"),
    "Maximum": ("math", "max"), "Minimum": ("math", "min"),
    "Pow": ("math", "pow"), "FloorDiv": ("math", "floorDiv"),
    "FloorMod": ("math", "floorMod"), "Atan2": ("math", "atan2"),
    "LogicalAnd": ("math", "logicalAnd"), "LogicalOr": ("math", "logicalOr"),
    "SquaredDifference": ("math", "squaredDifference"),
    "Equal": ("math", "eq"), "NotEqual": ("math", "neq"),
    "Less": ("math", "lt"), "LessEqual": ("math", "lte"),
    "Greater": ("math", "gt"), "GreaterEqual": ("math", "gte"),
}
_UNARY = {
    "Relu": ("nn", "relu"), "Relu6": ("nn", "relu6"), "Elu": ("nn", "elu"),
    "Selu": ("nn", "selu"), "Sigmoid": ("nn", "sigmoid"),
    "Softplus": ("nn", "softplus"), "Softsign": ("nn", "softsign"),
    "Tanh": ("math", "tanh"), "Exp": ("math", "exp"), "Log": ("math", "log"),
    "Log1p": ("math", "log1p"), "Neg": ("math", "neg"), "Abs": ("math", "abs"),
    "Square": ("math", "square"), "Sqrt": ("math", "sqrt"),
    "Rsqrt": ("math", "rsqrt"), "Erf": ("math", "erf"), "Floor": ("math", "floor"),
    "Ceil": ("math", "ceil"), "Round": ("math", "round"), "Sign": ("math", "sign"),
    "Sin": ("math", "sin"), "Cos": ("math", "cos"), "Tan": ("math", "tan"),
    "Reciprocal": ("math", "reciprocal"), "LogicalNot": ("math", "logicalNot"),
    "IsNan": ("math", "isnan"), "IsInf": ("math", "isinf"),
    "IsFinite": ("math", "isfinite"),
    "Sinh": ("math", "sinh"), "Cosh": ("math", "cosh"),
    "Asin": ("math", "asin"), "Acos": ("math", "acos"),
    "Atan": ("math", "atan"), "Asinh": ("math", "asinh"),
    "Acosh": ("math", "acosh"), "Atanh": ("math", "atanh"),
    "Expm1": ("math", "expm1"), "Erfc": ("math", "erfc"),
    "Digamma": ("math", "digamma"), "Lgamma": ("math", "lgamma"),
}
_REDUCE = {
    "Mean": "mean", "Sum": "sum", "Max": "max", "Min": "min", "Prod": "prod",
    "All": "all", "Any": "any",
}

for _t, (_ns, _o) in list(_BINARY.items()):
    _RULES[_t] = (lambda ns, o: lambda g, n: g._emit(
        ns, o, [g._in(n, 0), g._in(n, 1)], n.name))(_ns, _o)
for _t, (_ns, _o) in list(_UNARY.items()):
    _RULES[_t] = (lambda ns, o: lambda g, n: g._emit(
        ns, o, [g._in(n, 0)], n.name))(_ns, _o)
for _t, _o in list(_REDUCE.items()):
    def _red(g, n, _o=_o):
        axes = g._const(n, 1)
        dims = tuple(int(a) for a in np.atleast_1d(axes))
        keep = bool(n.attr["keep_dims"].b)
        return g._emit("reduce", _o, [g._in(n, 0)], n.name, dims=dims, keepdims=keep)
    _RULES[_t] = _red


@_rule("MatMul")
def _matmul(g, n):
    a, b = g._in(n, 0), g._in(n, 1)
    if n.attr["transpose_a"].b:
        a = g._emit("shape", "permute", [a], n.name + "/ta", axes=(1, 0))
    if n.attr["transpose_b"].b:
        b = g._emit("shape", "permute", [b], n.name + "/tb", axes=(1, 0))
    return g._emit("linalg", "matmul", [a, b], n.name)


@_rule("BatchMatMul", "BatchMatMulV2")
def _bmm(g, n):
    a, b = g._in(n, 0), g._in(n, 1)
    if n.attr["adj_x"].b:
        nd = len(a.shape or (0, 0, 0))
        g_axes = tuple(range(nd - 2)) + (nd - 1, nd - 2)
        a = g._emit("shape", "permute", [a], n.name + "/ta", axes=g_axes)
    if n.attr["adj_y"].b:
        nd = len(b.shape or (0, 0, 0))
        g_axes = tuple(range(nd - 2)) + (nd - 1, nd - 2)
        b = g._emit("shape", "permute", [b], n.name + "/tb", axes=g_axes)
    return g._emit("linalg", "matmul", [a, b], n.name)


@_rule("BiasAdd")
def _bias_add(g, n):
    # NHWC (default): bias broadcasts over the trailing channel dim
    fmt = n.attr["data_format"].s.decode() or "NHWC"
    x, b = g._in(n, 0), g._in(n, 1)
    if fmt == "NCHW":
        raise ValueError("BiasAdd NCHW import unsupported (TF frozen graphs are NHWC)")
    return g._emit("math", "add", [x, b], n.name)


@_rule("Softmax")
def _softmax(g, n):
    return g._emit("nn", "softmax", [g._in(n, 0)], n.name)


@_rule("LeakyRelu")
def _leaky(g, n):
    return g._emit("nn", "leakyRelu", [g._in(n, 0)], n.name,
                   alpha=float(n.attr["alpha"].f or 0.2))


@_rule("Reshape")
def _reshape(g, n):
    ref = _clean(n.input[1])
    if ref in g.consts:
        shape = tuple(int(s) for s in g.consts[ref])
        return g._emit("shape", "reshape", [g._in(n, 0)], n.name, shape=shape)
    # dynamic shape: typically Pack([batch_from_Shape, const, const, ...]).
    # Resolve each dynamic component back to the tensor whose tf.shape() it
    # came from ("dim:i" of a reference input, read when the node runs); a
    # single unresolvable one degrades to -1.
    producer = g.nodes.get(ref)
    if producer is not None and producer.op == "Pack":
        dims: List[Any] = []
        ref_node = None
        for inp in producer.input:
            nm = _clean(inp)
            if nm in g.consts:
                dims.append(int(np.atleast_1d(g.consts[nm])[0]))
                continue
            src = _dim_of_shape(g, nm)
            if src is not None:
                target, idx = src
                if ref_node is None or ref_node == target:
                    ref_node = target
                    dims.append(f"dim:{idx}")
                    continue
            dims.append(-1)
        n_unres = sum(1 for d in dims if d == -1)
        if ref_node is not None and n_unres == 0:
            return g._emit("shape", "reshapeRef",
                           [g._in(n, 0), g._resolve(ref_node)], n.name,
                           dims=list(dims))
        if ref_node is None and n_unres <= 1:
            return g._emit("shape", "reshape", [g._in(n, 0)], n.name,
                           shape=tuple(dims))
        if n_unres <= 1:
            # mixed: keep ref dims, let the one unresolved dim be inferred
            return g._emit("shape", "reshapeRef",
                           [g._in(n, 0), g._resolve(ref_node)], n.name,
                           dims=list(dims))
    raise ValueError(
        f"Reshape {n.name}: dynamic shape input {ref} unresolvable "
        "(need Const or Pack of consts / tf.shape() components)")


def _dim_of_shape(g, name):
    """If node ``name`` is StridedSlice(Shape(y), [i]) return (y, i)."""
    node = g.nodes.get(name)
    if node is None or node.op != "StridedSlice":
        return None
    shp = g.nodes.get(_clean(node.input[0]))
    if shp is None or shp.op != "Shape":
        return None
    try:
        i = int(np.atleast_1d(g.consts[_clean(node.input[1])])[0])
    except KeyError:
        return None
    return _clean(shp.input[0]), i


@_rule("Transpose")
def _transpose(g, n):
    perm = tuple(int(p) for p in g._const(n, 1))
    return g._emit("shape", "permute", [g._in(n, 0)], n.name, axes=perm)


@_rule("ExpandDims")
def _expand(g, n):
    axis = int(np.atleast_1d(g._const(n, 1))[0])
    return g._emit("shape", "expandDims", [g._in(n, 0)], n.name, axis=axis)


@_rule("Squeeze")
def _squeeze(g, n):
    dims = tuple(int(d) for d in n.attr["squeeze_dims"].list.i) or None
    return g._emit("shape", "squeeze", [g._in(n, 0)], n.name, axis=dims)


@_rule("ConcatV2")
def _concat(g, n):
    axis = int(np.atleast_1d(g._const(n, len(n.input) - 1))[0])
    xs = [g._in(n, i) for i in range(len(n.input) - 1)]
    return g._emit("shape", "concatN", xs, n.name, axis=axis)


@_rule("Pack")
def _pack(g, n):
    axis = int(n.attr["axis"].i)
    return g._emit("shape", "stackN", g._ins(n), n.name, axis=axis)


@_rule("Pad", "PadV2")
def _pad(g, n):
    pads = tuple(tuple(int(v) for v in row) for row in g._const(n, 1))
    return g._emit("shape", "pad", [g._in(n, 0)], n.name, paddings=pads)


@_rule("GatherV2", "Gather")
def _gather(g, n):
    axis = 0
    if len(n.input) > 2:
        axis = int(np.atleast_1d(g._const(n, 2))[0])
    return g._emit("shape", "gather", [g._in(n, 0), g._in(n, 1)], n.name, axis=axis)


@_rule("Cast")
def _cast(g, n):
    return g._emit("shape", "castTo", [g._in(n, 0)], n.name,
                   dtype=_TF_DT.get(n.attr["DstT"].type, "float32"))


@_rule("ArgMax")
def _argmax(g, n):
    axis = int(np.atleast_1d(g._const(n, 1))[0])
    return g._emit("reduce", "argmax", [g._in(n, 0)], n.name, dims=axis)


@_rule("OneHot")
def _onehot(g, n):
    depth = int(np.atleast_1d(g._const(n, 1))[0])
    on = float(np.atleast_1d(g._const(n, 2))[0])
    off = float(np.atleast_1d(g._const(n, 3))[0])
    return g._emit("shape", "oneHot", [g._in(n, 0)], n.name, depth=depth,
                   on=on, off=off)


@_rule("Shape")
def _shape(g, n):
    return g._emit("shape", "shapeOf", [g._in(n, 0)], n.name)


@_rule("StridedSlice")
def _strided_slice(g, n):
    begin = [int(v) for v in g._const(n, 1)]
    end = [int(v) for v in g._const(n, 2)]
    strides = [int(v) for v in g._const(n, 3)]
    bm = int(n.attr["begin_mask"].i)
    em = int(n.attr["end_mask"].i)
    sm = int(n.attr["shrink_axis_mask"].i)
    nm = int(n.attr["new_axis_mask"].i)
    el = int(n.attr["ellipsis_mask"].i)
    if el:
        raise ValueError("StridedSlice with ellipsis mask unsupported")
    slices = []
    for i in range(len(begin)):
        if nm & (1 << i):
            slices.append(None)  # np.newaxis (e.g. pos_emb[tf.newaxis])
            continue
        if sm & (1 << i):
            slices.append(begin[i])
            continue
        b = None if bm & (1 << i) else begin[i]
        e = None if em & (1 << i) else end[i]
        slices.append(slice(b, e, strides[i]))
    return g._emit("shape", "stridedSlice", [g._in(n, 0)], n.name,
                   slices=tuple(slices))


@_rule("Conv2D")
def _conv2d(g, n):
    fmt = n.attr["data_format"].s.decode() or "NHWC"
    if fmt != "NHWC":
        raise ValueError(f"Conv2D data_format {fmt} unsupported (frozen TF graphs are NHWC)")
    strides = list(n.attr["strides"].list.i)  # NHWC order
    dil = list(n.attr["dilations"].list.i) or [1, 1, 1, 1]
    padding = n.attr["padding"].s.decode()
    x = g._nhwc_to_nchw(g._in(n, 0), n.name)
    # kernel HWIO -> OIHW
    w = g._emit("shape", "permute", [g._in(n, 1)], n.name + "/w", axes=(3, 2, 0, 1))
    out = g._emit("cnn", "conv2d", [x, w], n.name + "/conv",
                  strides=(strides[1], strides[2]), padding=padding,
                  dilation=(dil[1], dil[2]))
    return g._nchw_to_nhwc(out, n.name)


@_rule("DepthwiseConv2dNative")
def _depthwise(g, n):
    strides = list(n.attr["strides"].list.i)
    padding = n.attr["padding"].s.decode()
    x = g._nhwc_to_nchw(g._in(n, 0), n.name)
    # kernel (kh,kw,C,mult) -> (C*mult, 1, kh, kw); frozen graphs have it const
    kv = g._const(n, 1)
    kh, kw_, C, mult = kv.shape
    w = g.sd.constant(n.name + "/w",
                      kv.transpose(2, 3, 0, 1).reshape(C * mult, 1, kh, kw_))
    out = g._emit("cnn", "depthwiseConv2d", [x, w], n.name + "/conv",
                  strides=(strides[1], strides[2]), padding=padding)
    return g._nchw_to_nhwc(out, n.name)


@_rule("MaxPool", "AvgPool")
def _pool(g, n):
    fmt = n.attr["data_format"].s.decode() or "NHWC"
    if fmt != "NHWC":
        raise ValueError(f"{n.op} data_format {fmt} unsupported")
    k = list(n.attr["ksize"].list.i)
    s = list(n.attr["strides"].list.i)
    padding = n.attr["padding"].s.decode()
    x = g._nhwc_to_nchw(g._in(n, 0), n.name)
    opname = "maxPool2d" if n.op == "MaxPool" else "avgPool2d"
    out = g._emit("cnn", opname, [x], n.name + "/pool",
                  kernel=(k[1], k[2]), strides=(s[1], s[2]), padding=padding)
    return g._nchw_to_nhwc(out, n.name)


@_rule("Split")
def _split(g, n):
    axis = int(np.atleast_1d(g._const(n, 0))[0])
    num = int(n.attr["num_split"].i)
    outs = g._emit("shape", "splitN", [g._in(n, 1)], n.name, num=num, axis=axis)
    g._register_outputs(n, outs)
    return None


@_rule("SplitV")
def _splitv(g, n):
    sizes = [int(s) for s in g._const(n, 1)]
    axis = int(np.atleast_1d(g._const(n, 2))[0])
    x = g._in(n, 0)
    rank = len(x.shape) if x.shape is not None else None
    if axis < 0:
        if rank is None:
            raise ValueError(f"SplitV {n.name}: negative axis on unknown rank")
        axis += rank
    outs, off = [], 0
    for j, sz in enumerate(sizes):
        sl = [slice(None)] * axis + [slice(off, off + sz)]
        outs.append(g._emit("shape", "stridedSlice", [x], f"{n.name}/s{j}",
                            slices=tuple(sl)))
        off += sz
    g._register_outputs(n, outs)
    return None


@_rule("Fill")
def _fill(g, n):
    dims = tuple(int(d) for d in g._const(n, 0))
    val = g._const(n, 1)
    return g.sd.constant(n.name, np.full(dims, val))


@_rule("Select", "SelectV2")
def _select(g, n):
    return g._emit("shape", "where", [g._in(n, 0), g._in(n, 1), g._in(n, 2)],
                   n.name)


@_rule("AddN")
def _addn(g, n):
    xs = g._ins(n)
    acc = xs[0]
    for j, x in enumerate(xs[1:]):
        acc = g._emit("math", "add", [acc, x],
                      n.name if j == len(xs) - 2 else f"{n.name}/p{j}")
    return acc


@_rule("Rank")
def _rank(g, n):
    return g._emit("shape", "rank", [g._in(n, 0)], n.name)


@_rule("ZerosLike", "OnesLike")
def _fill_like(g, n):
    opname = "zerosLike" if n.op == "ZerosLike" else "onesLike"
    return g._emit("math", opname, [g._in(n, 0)], n.name)


@_rule("While", "StatelessWhile")
def _while_rule(g, n):
    """TF2 functional while: cond/body live in the function library (ref:
    SameDiff InferenceSession Enter/Exit/... — a structured loop node here)."""
    cg = g._import_function(n.attr["cond"].func.name)
    bg = g._import_function(n.attr["body"].func.name)
    loop_vars = g._ins(n)
    outs = g.sd._control_op("while", loop_vars,
                            {"cond_graph": cg, "body_graph": bg}, n.name)
    g._register_outputs(n, outs)
    return None


@_rule("If", "StatelessIf")
def _if_rule(g, n):
    tg = g._import_function(n.attr["then_branch"].func.name)
    fg = g._import_function(n.attr["else_branch"].func.name)
    ins = g._ins(n)
    outs = g.sd._control_op("if", ins,  # ins[0] is the predicate
                            {"true_graph": tg, "false_graph": fg}, n.name)
    g._register_outputs(n, outs)
    return None


@_rule("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(g, n):
    eps = float(n.attr["epsilon"].f or 1e-3)
    x, gamma, beta, mean, var = (g._in(n, i) for i in range(5))
    # NHWC: channel is the last axis
    return g._emit("nn", "batchNorm", [x, mean, var, gamma, beta],
                   n.name, eps=eps, axis=-1)


# ---------------------------------------------------------------------------
# High-frequency frozen-graph ops beyond the original set (ref:
# samediff-import-tensorflow per-op mapping rules for the same TF ops).

@_rule("Tile")
def _tile(g, n):
    reps = tuple(int(r) for r in np.atleast_1d(g._const(n, 1)))
    return g._emit("shape", "tile", [g._in(n, 0)], n.name, reps=reps)


@_rule("Range")
def _range(g, n):
    start = float(np.atleast_1d(g._const(n, 0))[0])
    limit = float(np.atleast_1d(g._const(n, 1))[0])
    delta = float(np.atleast_1d(g._const(n, 2))[0])
    out_dtype = n.attr["Tidx"].type if "Tidx" in n.attr else None
    v = g._emit("shape", "arange", [], n.name, start=start, stop=limit,
                step=delta)
    if out_dtype in (3, 9):  # DT_INT32 / DT_INT64
        v = g._emit("shape", "castTo", [v], n.name + "/cast",
                    dtype="int32" if out_dtype == 3 else "int64")
    return v


@_rule("Slice")
def _slice(g, n):
    x = g._in(n, 0)
    begin = [int(b) for b in np.atleast_1d(g._const(n, 1))]
    size = [int(s) for s in np.atleast_1d(g._const(n, 2))]
    # TF size=-1 means "to the end of the dim" — needs a static dim to resolve
    for i, s in enumerate(size):
        if s == -1 and (x.shape is None or x.shape[i] is None):
            raise ValueError(
                f"Slice '{n.name}': size=-1 over dynamic dim {i} cannot be "
                "resolved at import time (shape unknown)")
    size = [x.shape[i] - begin[i] if s == -1 else s
            for i, s in enumerate(size)]
    return g._emit("shape", "slice", [x], n.name, begin=tuple(begin),
                   size=tuple(size))


@_rule("Unpack")
def _unpack(g, n):
    axis = int(n.attr["axis"].i)
    outs = g._emit("shape", "unstack", [g._in(n, 0)], n.name, axis=axis)
    g._register_outputs(n, outs)
    return None


@_rule("ReverseV2")
def _reverse_v2(g, n):
    dims = tuple(int(a) for a in np.atleast_1d(g._const(n, 1)))
    return g._emit("shape", "reverse", [g._in(n, 0)], n.name, dims=dims)


@_rule("Cumsum")
def _cumsum(g, n):
    axis = int(np.atleast_1d(g._const(n, 1))[0])
    exclusive = bool(n.attr["exclusive"].b)
    reverse = bool(n.attr["reverse"].b)
    x = g._in(n, 0)
    if reverse:
        x = g._emit("shape", "reverse", [x], n.name + "/rev_in", dims=(axis,))
    out = g._emit("shape", "cumsum", [x], n.name + "/cs", axis=axis)
    if exclusive:  # shift right by one along axis: out - x
        out = g._emit("math", "sub", [out, x], n.name + "/excl")
    if reverse:
        out = g._emit("shape", "reverse", [out], n.name + "/rev_out",
                      dims=(axis,))
    return out


@_rule("TopKV2")
def _topk(g, n):
    k = int(np.atleast_1d(g._const(n, 1))[0])
    outs = g._emit("math", "topK", [g._in(n, 0)], n.name, k=k)
    g._register_outputs(n, outs)
    return None


@_rule("GatherNd")
def _gather_nd(g, n):
    return g._emit("shape", "gatherNd", [g._in(n, 0), g._in(n, 1)], n.name)


@_rule("ScatterNd")
def _scatter_nd(g, n):
    shape = tuple(int(s) for s in np.atleast_1d(g._const(n, 2)))
    return g._emit("shape", "scatterNd", [g._in(n, 0), g._in(n, 1)], n.name,
                   shape=shape)


@_rule("MirrorPad")
def _mirror_pad(g, n):
    pads = tuple(tuple(int(v) for v in row) for row in g._const(n, 1))
    mode = n.attr["mode"].s.decode() or "REFLECT"
    return g._emit("shape", "mirrorPad", [g._in(n, 0)], n.name,
                   paddings=pads, mode=mode)


@_rule("ClipByValue")
def _clip_by_value(g, n):
    return g._emit("math", "clipByValue",
                   [g._in(n, 0), g._in(n, 1), g._in(n, 2)], n.name)


@_rule("L2Loss")
def _l2_loss(g, n):
    return g._emit("loss", "l2Loss", [g._in(n, 0)], n.name)


@_rule("LRN")
def _lrn(g, n):
    x = g._nhwc_to_nchw(g._in(n, 0), n.name)
    out = g._emit("nn", "lrn", [x], n.name + "/lrn",
                  depth_radius=int(n.attr["depth_radius"].i or 5),
                  bias=float(n.attr["bias"].f or 1.0),
                  alpha=float(n.attr["alpha"].f or 1.0),
                  beta=float(n.attr["beta"].f or 0.5))
    return g._nchw_to_nhwc(out, n.name)


@_rule("SpaceToBatchND")
def _space_to_batch_nd(g, n):
    block = [int(b) for b in np.atleast_1d(g._const(n, 1))]
    pads = [tuple(int(v) for v in row) for row in np.atleast_2d(g._const(n, 2))]
    # TF layout (N, spatial..., rest) matches the op's contract directly
    return g._emit("cnn", "spaceToBatchNd", [g._in(n, 0)], n.name,
                   block_shape=block, paddings=pads)


@_rule("BatchToSpaceND")
def _batch_to_space_nd(g, n):
    block = [int(b) for b in np.atleast_1d(g._const(n, 1))]
    crops = [tuple(int(v) for v in row) for row in np.atleast_2d(g._const(n, 2))]
    return g._emit("cnn", "batchToSpaceNd", [g._in(n, 0)], n.name,
                   block_shape=block, crops=crops)


@_rule("DepthToSpace")
def _depth_to_space(g, n):
    bs = int(n.attr["block_size"].i)
    fmt = n.attr["data_format"].s.decode() or "NHWC"
    return g._emit("cnn", "depthToSpace", [g._in(n, 0)], n.name,
                   block_size=bs, data_format=fmt)


@_rule("SpaceToDepth")
def _space_to_depth_rule(g, n):
    bs = int(n.attr["block_size"].i)
    fmt = n.attr["data_format"].s.decode() or "NHWC"
    return g._emit("cnn", "spaceToDepth", [g._in(n, 0)], n.name,
                   block_size=bs, data_format=fmt)


@_rule("ResizeBilinear", "ResizeNearestNeighbor")
def _resize(g, n):
    size = tuple(int(s) for s in np.atleast_1d(g._const(n, 1)))
    opname = ("resizeBilinear" if n.op == "ResizeBilinear"
              else "resizeNearest")
    # TF1 graphs carry align_corners / legacy coordinates; TF2 emits
    # half_pixel_centers=true — the op implements all three samplings
    return g._emit("image", opname, [g._in(n, 0)], n.name, size=size,
                   data_format="NHWC",
                   align_corners=bool(n.attr["align_corners"].b),
                   half_pixel_centers=bool(n.attr["half_pixel_centers"].b))


@_rule("Einsum")
def _einsum(g, n):
    eq = n.attr["equation"].s.decode()
    return g._emit("linalg", "einsum", g._ins(n), n.name, equation=eq)
