"""BASELINE config #4's encoder built through the port's SameDiff API, op
for op as ``tools/tf_bert.py``'s frozen TF graph imports: Gather
embeddings plus sliced position embeddings, layernorm through moments
(mean, a StopGradient identity, squaredDifference), multi-head attention
as split / reshapeRef / permute / matmul with a scalar scale (and the
additive ``(1 - m) * -1e4`` mask when ``masked``), softmax, erf-GELU and
dense matmul plus bias. The weights are ``tools/tf_bert.py``'s draws
(numpy ``default_rng(seed)``, N(0, 0.02), in its order; layernorm gains
1, biases 0), so the same seed gives the same encoder as the import.

Shared by the CPU tests and ``chip_smoke.py``'s ``samediff`` phase, so it
imports the port and numpy, never ``jax`` or ``tensorflow``.
"""
from __future__ import annotations

import numpy as np

# BASELINE config #4 (tools/bench_tf_import.py): BERT-base, T=128, B=32
BERT_BASE = dict(L=12, H=768, A=12, V=30522, T=128, intermediate=3072)
TINY = dict(L=2, H=32, A=4, V=64, T=16, intermediate=64)


def bert_weights(L, H, A, V, T, intermediate, seed=0):
    """tools/tf_bert.py's random weights, drawn in its order."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    tok, pos = w(V, H), w(T, H)
    qkv = [w(H, 3 * H) for _ in range(L)]
    proj = [w(H, H) for _ in range(L)]
    fc1 = [w(H, intermediate) for _ in range(L)]
    fc2 = [w(intermediate, H) for _ in range(L)]
    return dict(tok=tok, pos=pos, qkv=qkv, proj=proj, fc1=fc1, fc2=fc2)


def build_bert_encoder(L, H, A, V, T, intermediate, seed=0, masked=False,
                       device=None):
    """(sd, input names, output name): the encoder's final hidden states
    (B, T, H) for token ids (B, T) int32 — and a (B, T) float mask when
    ``masked`` (input names are then ``("ids", "mask")``)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    W = bert_weights(L, H, A, V, T, intermediate, seed)
    D = H // A
    sd = SameDiff.create(device)
    f32 = np.float32
    ids = sd.placeHolder("ids", shape=(None, T), dtype="int32")

    def const(name, value):
        return sd.constant(name, np.asarray(value, f32))

    def layer_norm(x, i, eps=1e-12):
        g = const(f"ln{i}/gamma", np.ones((H,)))
        b = const(f"ln{i}/beta", np.zeros((H,)))
        mean = sd.reduce.mean(x, dims=(-1,), keepdims=True)
        centered = x - mean
        var = sd.reduce.mean(sd.math.squaredDifference(x, sd.math.identity(mean)),
                             dims=(-1,), keepdims=True)
        r = sd.math.rsqrt(var + const(f"ln{i}/eps", eps))
        return centered * r * g + b

    def dense(x, w, b):
        return x.mmul(w) + b

    def heads(t):
        return sd.shapes.permute(
            sd.shapes.reshapeRef(t, ids, dims=["dim:0", T, A, D]),
            axes=(0, 2, 1, 3))

    adder = None
    if masked:
        mask = sd.placeHolder("mask", shape=(None, T), dtype="float32")
        sl = sd.shapes.stridedSlice(mask, slices=(slice(None, None, 1), None, None,
                                                  slice(None, None, 1)))
        adder = (const("mask/one", 1.0) - sl) * const("mask/neg", -1e4)

    x = sd.shapes.gather(const("tok_emb", W["tok"]), ids, axis=0)
    x = x + sd.shapes.stridedSlice(const("pos_emb", W["pos"]), slices=(None,))
    x = layer_norm(x, 2 * L)
    for i in range(L):
        h = layer_norm(x, 2 * i)
        qkv = dense(h, const(f"l{i}/qkv_w", W["qkv"][i]),
                    const(f"l{i}/qkv_b", np.zeros((3 * H,))))
        q, k, v = sd.shapes.splitN(qkv, num=3, axis=-1)
        kt = sd.shapes.permute(heads(k), axes=(0, 1, 3, 2))
        s = sd.linalg.matmul(heads(q), kt) * const(f"l{i}/scale", 1.0 / np.sqrt(D))
        if adder is not None:
            s = s + adder
        p = sd.nn.softmax(s)
        o = sd.linalg.matmul(p, heads(v))
        o = sd.shapes.reshapeRef(sd.shapes.permute(o, axes=(0, 2, 1, 3)), ids,
                                 dims=["dim:0", T, H])
        x = x + o.mmul(const(f"l{i}/proj_w", W["proj"][i])) \
            + const(f"l{i}/proj_b", np.zeros((H,)))
        h = layer_norm(x, 2 * i + 1)
        f = dense(h, const(f"l{i}/fc1_w", W["fc1"][i]),
                  const(f"l{i}/fc1_b", np.zeros((intermediate,))))
        gelu = (const(f"l{i}/half", 0.5) * f) * (
            const(f"l{i}/one", 1.0)
            + sd.math.erf(sd.math.div(f, const(f"l{i}/sqrt2", np.sqrt(2.0)))))
        x = x + gelu.mmul(const(f"l{i}/fc2_w", W["fc2"][i])) \
            + const(f"l{i}/fc2_b", np.zeros((H,)))
    out = sd.math.identity(x).rename("encoder_out")
    names = ("ids", "mask") if masked else "ids"
    return sd, names, out.name


def add_mlm_head(sd, out_name, H, V, B, T, seed=0):
    """tools/bench_tf_import.py's MLM head: ``lm_head`` (H, V) XAVIER, the
    logits of the encoder output and ``loss.sparseMcxent`` against int32
    ``targets`` (B, T). Returns the loss variable's name."""
    lm_w = sd.var("lm_head", (H, V), weightInit="XAVIER", seed=seed)
    logits = sd.linalg.matmul(sd.getVariable(out_name), lm_w)
    targets = sd.placeHolder("targets", shape=(B, T), dtype="int32")
    loss = sd.loss.sparseMcxent(targets, logits)
    sd.setLossVariables(loss.name)
    return loss.name


def mlm_batch(V, B, T, seed=0):
    """tools/bench_tf_import.py's batch: ids and targets from numpy seed."""
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, V, (B, T)).astype(np.int32),
            "targets": rng.integers(0, V, (B, T)).astype(np.int32)}
