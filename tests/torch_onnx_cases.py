"""BASELINE config #4's encoder written as an ONNX ModelProto, node for
node as an opset-13 exporter writes a BERT encoder: Gather embeddings
(token ids and a ``position_ids`` initializer), layernorm decomposed into
ReduceMean / Sub / Pow / ReduceMean / Add / Sqrt / Div / Mul / Add,
MatMul + Add projections (one fused QKV MatMul, then Split), heads through
Reshape and Transpose, the score chain in the form ``fuseAttention``
matches — k through ``Transpose(perm=[0, 1, 3, 2])``, MatMul, ``Mul`` by
a scalar initializer, Softmax, MatMul — with no additive mask, and the
erf-GELU as Div / Erf / Add / Mul / Mul. The weights are
``torch_samediff_cases.bert_weights``' draws under the API-built graph's
names (``tok_emb``, ``l{i}/qkv_w``, ...), so the same seed gives the same
encoder as ``build_bert_encoder``.

Serialized by the port's pure-Python writer (``modelimport.onnx.wire``).
Shared by the CPU tests and ``chip_smoke.py``'s ``importers`` phase, so it
imports the port and numpy, never ``jax`` or ``tensorflow``.
"""
from __future__ import annotations

import numpy as np

from torch_samediff_cases import bert_weights

OUTPUT = "encoder_out"


def bert_onnx_model(L, H, A, V, T, intermediate, seed=0, pb=None):
    """The encoder as a ModelProto of ``pb`` (the port's ``wire`` module
    unless given — the reference's protoc bindings take the same calls).
    Input ``ids`` (batch, T) int64; output ``encoder_out`` (batch, T, H)."""
    if pb is None:
        from deeplearning4j_tpu_torch.modelimport.onnx import wire as pb
    W = bert_weights(L, H, A, V, T, intermediate, seed)
    D = H // A
    f32 = np.float32
    m = pb.ModelProto(ir_version=7, producer_name="torch_onnx_cases")
    m.opset_import.add(domain="", version=13)
    g = m.graph
    g.name = "bert_encoder"

    def init(name, arr):
        arr = np.ascontiguousarray(arr)
        t = g.initializer.add()
        t.name = name
        t.data_type = {np.dtype(f32): 1, np.dtype(np.int64): 7}[arr.dtype]
        t.dims.extend(arr.shape)
        t.raw_data = arr.tobytes()
        return name

    def node(op, inputs, out, **attrs):
        outs = [out] if isinstance(out, str) else out
        n = g.node.add(op_type=op, name=outs[0])
        n.input.extend(inputs)
        n.output.extend(outs)
        for k, v in attrs.items():
            a = n.attribute.add(name=k)
            if isinstance(v, list):
                a.type = pb.AttributeProto.INTS
                a.ints.extend(v)
            else:
                a.type = pb.AttributeProto.INT
                a.i = v
        return out

    vi = g.input.add(name="ids")
    vi.type.tensor_type.elem_type = 7
    vi.type.tensor_type.shape.dim.add(dim_param="batch")
    vi.type.tensor_type.shape.dim.add(dim_value=T)
    vo = g.output.add(name=OUTPUT)
    vo.type.tensor_type.elem_type = 1

    heads_shape = init("heads_shape", np.array([-1, T, A, D], np.int64))
    merge_shape = init("merge_shape", np.array([-1, T, H], np.int64))
    eps = init("ln_eps", np.array(1e-12, f32))
    two = init("pow_two", np.array(2.0, f32))

    def layer_norm(x, i):
        p = f"ln{i}"
        gamma = init(f"{p}/gamma", np.ones((H,), f32))
        beta = init(f"{p}/beta", np.zeros((H,), f32))
        mean = node("ReduceMean", [x], f"{p}/mean", axes=[-1], keepdims=1)
        d = node("Sub", [x, mean], f"{p}/centered")
        var = node("ReduceMean", [node("Pow", [d, two], f"{p}/sq")], f"{p}/var",
                   axes=[-1], keepdims=1)
        std = node("Sqrt", [node("Add", [var, eps], f"{p}/var_eps")], f"{p}/std")
        n = node("Div", [d, std], f"{p}/norm")
        return node("Add", [node("Mul", [n, gamma], f"{p}/scaled"), beta], f"{p}/out")

    def dense(x, w, b, name):
        return node("Add", [node("MatMul", [x, w], f"{name}/mm"), b], name)

    def heads(t, name):
        r = node("Reshape", [t, heads_shape], f"{name}/r")
        return node("Transpose", [r], f"{name}/t", perm=[0, 2, 1, 3])

    pos_ids = init("position_ids", np.arange(T, dtype=np.int64)[None])
    tok = node("Gather", [init("tok_emb", W["tok"]), "ids"], "emb/tok", axis=0)
    pos = node("Gather", [init("pos_emb", W["pos"]), pos_ids], "emb/pos", axis=0)
    x = layer_norm(node("Add", [tok, pos], "emb/sum"), 2 * L)
    for i in range(L):
        p = f"l{i}"
        h = layer_norm(x, 2 * i)
        qkv = dense(h, init(f"{p}/qkv_w", W["qkv"][i]),
                    init(f"{p}/qkv_b", np.zeros((3 * H,), f32)), f"{p}/qkv")
        q, k, v = node("Split", [qkv], [f"{p}/q", f"{p}/k", f"{p}/v"], axis=-1)
        kt = node("Transpose", [heads(k, f"{p}/kh")], f"{p}/kt", perm=[0, 1, 3, 2])
        s = node("MatMul", [heads(q, f"{p}/qh"), kt], f"{p}/scores")
        s = node("Mul", [s, init(f"{p}/scale", np.array(1.0 / np.sqrt(D), f32))],
                 f"{p}/scaled_scores")
        probs = node("Softmax", [s], f"{p}/probs", axis=-1)
        ctx = node("MatMul", [probs, heads(v, f"{p}/vh")], f"{p}/ctx")
        ctx = node("Reshape", [node("Transpose", [ctx], f"{p}/ctx_t", perm=[0, 2, 1, 3]),
                               merge_shape], f"{p}/ctx_r")
        attn = dense(ctx, init(f"{p}/proj_w", W["proj"][i]),
                     init(f"{p}/proj_b", np.zeros((H,), f32)), f"{p}/proj")
        x = node("Add", [x, attn], f"{p}/res1")
        h = layer_norm(x, 2 * i + 1)
        f = dense(h, init(f"{p}/fc1_w", W["fc1"][i]),
                  init(f"{p}/fc1_b", np.zeros((intermediate,), f32)), f"{p}/fc1")
        e = node("Erf", [node("Div", [f, init(f"{p}/sqrt2", np.array(np.sqrt(2.0), f32))],
                               f"{p}/gelu_div")], f"{p}/gelu_erf")
        e = node("Add", [e, init(f"{p}/one", np.array(1.0, f32))], f"{p}/gelu_add")
        gelu = node("Mul", [node("Mul", [f, e], f"{p}/gelu_mul"),
                            init(f"{p}/half", np.array(0.5, f32))], f"{p}/gelu")
        x = node("Add", [x, dense(gelu, init(f"{p}/fc2_w", W["fc2"][i]),
                                  init(f"{p}/fc2_b", np.zeros((H,), f32)),
                                  f"{p}/fc2")], f"{p}/res2")
    node("Identity", [x], OUTPUT)
    return m


def bert_onnx_bytes(L, H, A, V, T, intermediate, seed=0) -> bytes:
    """:func:`bert_onnx_model` serialized by the port's writer."""
    return bert_onnx_model(L, H, A, V, T, intermediate, seed).SerializeToString()
