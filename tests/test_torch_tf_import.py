"""The port's TF importer (``modelimport/tensorflow/importer.py``) held
against the JAX package's on the CPU.

The frozen graphs are ``tests/test_tf_import.py``'s corpus, built once for
the module, and ``tools/tf_bert.py``'s encoder. Both packages import the
same GraphDef: the two graphs must hold the same nodes (op, inputs,
outputs, in order) and variables, and the port's outputs must match live
TF within each graph's stated ``atol`` (the reference test's, which
holds the reference's to the same). The BERT encoder's outputs also
match the reference's within 1e-5, and its fine-tune through the import runs
in both packages: losses within 1e-4 relative (the XAVIER head's normal
draws differ in their last bits).
"""
import os
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.autodiff import TrainingConfig as RConfig  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow import (  # noqa: E402
    TensorflowFrameworkImporter as RImporter)
from deeplearning4j_tpu.train import Adam as RAdam  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import TrainingConfig as PConfig  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TensorflowFrameworkImporter as PImporter)
from deeplearning4j_tpu_torch.train import Adam as PAdam  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.tf_bert import build_frozen_bert  # noqa: E402

RNG = np.random.default_rng(0)


def _freeze(fn, *specs):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    cf = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(cf, lower_control_flow=False)
    gd = frozen.graph.as_graph_def()
    return (gd, [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs], frozen)


def _corpus():
    """name -> (fn, inputs, atol): tests/test_tf_import.py's graphs."""
    R = np.random.default_rng(0)
    f32 = np.float32
    w1, b1, w2 = (R.normal(size=s).astype(f32) for s in ((6, 16), (16,), (16, 3)))
    k = R.normal(size=(3, 3, 2, 4)).astype(f32) * 0.1
    D = 16
    wq, wk, wv = (R.normal(size=(D, D)).astype(f32) * 0.1 for _ in range(3))
    gamma, beta = (R.normal(size=(8,)).astype(f32) for _ in range(2))
    table = R.normal(size=(11, 5)).astype(f32)

    def attention(x):
        q = tf.matmul(x, tf.reshape(wq, (1, D, D)) + tf.zeros((1, 1, 1)))
        kk = tf.matmul(x, tf.reshape(wk, (1, D, D)) + tf.zeros((1, 1, 1)))
        v = tf.matmul(x, tf.reshape(wv, (1, D, D)) + tf.zeros((1, 1, 1)))
        s = tf.matmul(q, kk, transpose_b=True) / tf.sqrt(tf.cast(D, tf.float32))
        return tf.matmul(tf.nn.softmax(s, axis=-1), v)

    def layernorm(x):
        mu = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.square(x - mu), axis=-1, keepdims=True)
        return (x - mu) * tf.math.rsqrt(var + 1e-6) * gamma + beta

    def shape_ops(x):
        y = tf.concat([tf.reshape(tf.transpose(x, (0, 2, 1)), (-1, 6))] * 2, axis=1)
        return tf.squeeze(tf.expand_dims(y, 1), axis=1)

    def while_loop(x):
        _, out = tf.while_loop(lambda i, acc: i < 4, lambda i, acc: (i + 1, acc * 2.0),
                               (tf.constant(0), x))
        return out

    def cond(x):
        return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0, lambda: x - 1.0)

    def split_reshape(x):
        a, b = tf.split(x, 2, axis=-1)
        return tf.reshape(a * b, (tf.shape(x)[0], -1))

    def shape_manip(x):
        s = tf.slice(tf.reverse(tf.tile(x, [2, 1]), axis=[1]), [1, 0], [3, -1])
        return tf.unstack(s, axis=0)[1]

    def range_cumsum(x):
        return (tf.cumsum(x, axis=1) + tf.cumsum(x, axis=1, exclusive=True)
                + tf.cumsum(x, axis=1, reverse=True) + tf.range(0.0, 4.0, 1.0))

    def topk_gather_nd(x):
        vals, idx = tf.math.top_k(x, k=2)
        g = tf.gather_nd(x, [[0, 1], [1, 0]])
        return vals + tf.cast(idx, tf.float32)[:, :1] + g[0]

    def space_depth(x):
        y = tf.batch_to_space(tf.space_to_batch(x, [2, 2], [[0, 0], [0, 0]]),
                              [2, 2], [[0, 0], [0, 0]])
        return y + tf.nn.depth_to_space(tf.nn.space_to_depth(x, 2), 2)

    def resize(x):
        return (tf.image.resize(x, [6, 6], method="bilinear")
                + tf.image.resize(x, [6, 6], method="nearest"))

    def resize_tf1(x):
        return (tf.compat.v1.image.resize_bilinear(x, [7, 9], align_corners=True)
                + tf.compat.v1.image.resize_bilinear(x, [7, 9], align_corners=False)
                + tf.compat.v1.image.resize_nearest_neighbor(x, [7, 9], align_corners=True)
                + tf.compat.v1.image.resize_nearest_neighbor(x, [7, 9]))

    n = lambda *s: R.normal(size=s).astype(f32)  # noqa: E731
    return {
        "mlp": (lambda x: tf.nn.softmax(tf.matmul(tf.nn.relu(tf.matmul(x, w1) + b1), w2)),
                [n(4, 6)], 1e-5),
        "conv_pool": (lambda x: tf.reduce_mean(tf.nn.max_pool2d(tf.nn.relu(
            tf.nn.conv2d(x, k, strides=1, padding="SAME")), 2, 2, padding="VALID"),
            axis=[1, 2]), [n(2, 8, 8, 2)], 1e-4),
        "attention_block": (attention, [n(2, 6, D)], 1e-4),
        "layernorm": (layernorm, [n(3, 5, 8)], 1e-5),
        "shape_ops": (shape_ops, [n(2, 6, 3)], 1e-5),
        "gather": (lambda ids: tf.reduce_sum(tf.gather(table, ids), axis=1),
                   [R.integers(0, 11, (3, 7)).astype(np.int32)], 1e-5),
        "strided_slice": (lambda x: x[:, 1:4, ::2], [n(2, 6, 8)], 1e-5),
        "argmax_dilated_conv": (lambda x: tf.argmax(tf.reduce_mean(tf.nn.conv2d(
            x, k, strides=1, padding="SAME", dilations=[1, 2, 2, 1]), axis=[1, 2]),
            axis=1), [n(2, 8, 8, 2)], 1e-5),
        "while": (while_loop, [n(3)], 1e-5),
        "cond_true": (cond, [np.array([1.0, 2.0], f32)], 1e-5),
        "cond_false": (cond, [np.array([-5.0, 2.0], f32)], 1e-5),
        "split_dynamic_reshape": (split_reshape, [n(4, 8)], 1e-5),
        "tile_reverse_slice_unstack": (shape_manip, [n(3, 5)], 1e-5),
        "range_cumsum": (range_cumsum, [n(2, 4)], 1e-5),
        "topk_gather_nd": (topk_gather_nd, [n(3, 5)], 1e-5),
        "scatter_nd_clip": (lambda x: tf.clip_by_value(
            x + tf.scatter_nd([[0], [2]], [5.0, 7.0], [4]), -1.0, 1.0), [n(4)], 1e-5),
        "mirror_pad_l2loss": (lambda x: tf.pad(x, [[1, 1], [0, 0]], mode="REFLECT")
                              + tf.nn.l2_loss(x), [n(3, 4)], 1e-5),
        "space_batch_depth": (space_depth, [n(1, 4, 4, 3)], 1e-5),
        "resize": (resize, [n(1, 3, 3, 2)], 1e-4),
        "resize_tf1_modes": (resize_tf1, [n(1, 4, 5, 2)], 1e-5),
        "einsum": (lambda x, y: tf.einsum("bij,bjk->bik", x, y), [n(2, 3, 4), n(2, 4, 5)],
                   1e-5),
        "lrn": (lambda x: tf.nn.local_response_normalization(
            x, depth_radius=2, bias=1.0, alpha=0.5, beta=0.5),
            [np.abs(n(1, 3, 3, 8))], 1e-4),
        "extra_unary": (lambda x: tf.math.sinh(x) + tf.math.cosh(x) + tf.math.expm1(x)
                        + tf.math.erfc(x) + tf.math.atan(x), [n(8) * 0.5], 1e-4),
    }


CORPUS = list(_corpus())


@pytest.fixture(scope="module")
def frozen_corpus():
    """Every corpus graph frozen once: name -> (gd, ins, outs, inputs,
    TF's outputs, atol)."""
    out = {}
    for name, (fn, inputs, atol) in _corpus().items():
        specs = [tf.TensorSpec(x.shape, tf.as_dtype(x.dtype)) for x in inputs]
        gd, ins, outs, frozen = _freeze(fn, *specs)
        exp = frozen(*[tf.constant(x) for x in inputs])
        exp = [np.asarray(e) for e in (exp if isinstance(exp, (list, tuple)) else [exp])]
        out[name] = (gd, ins, outs, inputs, exp, atol)
    return out


def _nodes(sd):
    return [(o.namespace, o.opname, o.inputs, o.outputs) for o in sd._ops]


def _port_import(gd):
    return PImporter.runImport(gd, device="cpu")


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_graph_imports_as_the_reference(frozen_corpus, name):
    gd, ins, outs, inputs, expected, atol = frozen_corpus[name]
    ref, port = RImporter.runImport(gd), _port_import(gd)
    assert _nodes(port) == _nodes(ref)
    assert list(port._vars) == list(ref._vars)
    feed = dict(zip(ins, inputs))
    for out, exp in zip(outs, expected):
        np.testing.assert_allclose(port.getVariable(out).eval(feed).toNumpy(), exp,
                                   atol=atol)


def test_unknown_op_reports_clearly():
    gd, *_ = _freeze(lambda x: tf.raw_ops.Betainc(a=x, b=x, x=x),
                     tf.TensorSpec((2,), tf.float32))
    with pytest.raises(ValueError, match="no mapping rule"):
        _port_import(gd)


def test_bert_import_parity_and_fine_tune():
    """tests/test_tf_import.py's BERT cases: the 2-layer H=64 encoder
    against live TF (1e-4) and the reference (1e-5); then its fine-tune
    through the import (constants -> variables, a pooled classifier head,
    Adam 1e-3, 12 steps) in both packages: the port's losses within 1e-4
    relative of the reference's (the XAVIER head's normal draws differ in
    their last bits) and falling below 0.7 of the first."""
    gd, i, o, frozen = build_frozen_bert(L=2, H=64, A=4, V=100, T=16, intermediate=128)
    ids = RNG.integers(0, 100, (2, 16)).astype(np.int32)
    exp = np.asarray(frozen(tf.constant(ids))[0] if isinstance(
        frozen(tf.constant(ids)), (list, tuple)) else frozen(tf.constant(ids)))
    ref, port = RImporter.runImport(gd), _port_import(gd)
    got = port.getVariable(o).eval({i: ids}).toNumpy()
    np.testing.assert_allclose(got, exp, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref.getVariable(o).eval({i: ids}).toNumpy()),
                               atol=1e-5)
    ids = RNG.integers(0, 100, (8, 16)).astype(np.int32)
    y = RNG.integers(0, 4, (8,)).astype(np.int32)
    hists = []
    for sd, cfg, adam, i32 in ((ref, RConfig, RAdam, "int32"), (port, PConfig, PAdam, "int32")):
        assert sd.convertAllConstantsToVariables() > 0
        pooled = sd.reduce.mean(sd.getVariable(o), dims=(1,))
        logits = sd.linalg.matmul(pooled, sd.var("cls_W", (64, 4), weightInit="XAVIER"))
        loss = sd.loss.sparseMcxent(sd.placeHolder("labels", shape=(8,), dtype=i32), logits)
        sd.setLossVariables(loss.name)
        sd.setTrainingConfig(cfg(updater=adam(1e-3)))
        hist = []
        for _ in range(12):
            hist += sd.fit({i: ids, "labels": y})
        hists.append(hist)
    assert sorted(ref._trainable_names()) == sorted(port._trainable_names())
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-4)
    assert hists[1][-1] < hists[1][0] * 0.7
