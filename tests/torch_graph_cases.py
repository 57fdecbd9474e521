"""Jax-free graph recipes for the ComputationGraph slice, built by name
from either package's ``nn`` and ``train`` modules, so the same recipe
drives the JAX package and the port (``tests/test_torch_graph*.py``,
``tests/test_torch_transfer_earlystop.py``, ``tests/
test_torch_data_parallel.py``; ``chip_smoke.py``'s ``graphs`` phase
imports this module, so it imports no JAX):

- :func:`resnet50` — the reference zoo's ResNet-50 (``deeplearning4j_tpu/
  zoo/models.py``, ``ResNet50.conf``) layer for layer, with knobs to cut
  it (blocks a stage, a width divisor, the input size, the classes, the
  data type); the zoo is not ported yet, so this copy stands in for it;
- :func:`attention_graph` — two SelfAttentionLayers, each in a residual
  ``ElementWiseVertex(Add)``, a ``MergeVertex`` of the two block outputs,
  global pooling and a softmax output; :func:`attention_vertex_graph` —
  the same tail over a ``DotProductAttentionVertex`` and an
  ``AttentionVertex``;
- :func:`multi_io` — two inputs (one masked sequence), two outputs, conf
  dropout, BatchNormalization and node names that sort differently from
  the topological order;
- :data:`VERTEX_CASES` — one small case per vertex type and variant.
"""
import numpy as np


def resnet50(nn, train, *, num_classes=1000, hw=224, channels=3, blocks=(3, 4, 6, 3),
             width_div=1, seed=123, dtype="FLOAT", updater=None):
    """The zoo's ResNet-50 configuration (bottleneck blocks, Same-padded
    convolutions, BatchNormalization, ``ElementWiseVertex(Add)``
    shortcuts, Adam 1e-3, He init); ``blocks``/``width_div``/``hw`` cut it
    and ``updater`` (a function of ``train``) replaces Adam."""
    L = nn.layers
    w = lambda n: max(n // width_div, 1)  # noqa: E731
    g = (nn.NeuralNetConfiguration.Builder().seed(seed).dataType(dtype)
         .updater(updater(train) if updater else train.Adam(1e-3)).weightInit("RELU")
         .graphBuilder()
         .addInputs("input")
         .setInputTypes(nn.InputType.convolutional(hw, hw, channels)))
    g.addLayer("stem_conv", L.ConvolutionLayer(nOut=w(64), kernelSize=(7, 7), stride=(2, 2),
                                               convolutionMode="Same",
                                               activation="IDENTITY"), "input")
    g.addLayer("stem_bn", L.BatchNormalization(activation="RELU"), "stem_conv")
    g.addLayer("stem_pool", L.SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                               stride=(2, 2), convolutionMode="Same"),
               "stem_bn")
    prev = "stem_pool"
    stages = [(blocks[0], 64, 256, 1), (blocks[1], 128, 512, 2),
              (blocks[2], 256, 1024, 2), (blocks[3], 512, 2048, 2)]
    for si, (n_blocks, mid, out, first_stride) in enumerate(stages):
        mid, out = w(mid), w(out)
        for bi in range(n_blocks):
            stride = first_stride if bi == 0 else 1
            name = f"s{si}b{bi}"
            g.addLayer(f"{name}_c1", L.ConvolutionLayer(nOut=mid, kernelSize=(1, 1),
                                                        stride=(stride, stride),
                                                        activation="IDENTITY"), prev)
            g.addLayer(f"{name}_bn1", L.BatchNormalization(activation="RELU"), f"{name}_c1")
            g.addLayer(f"{name}_c2", L.ConvolutionLayer(nOut=mid, kernelSize=(3, 3),
                                                        convolutionMode="Same",
                                                        activation="IDENTITY"), f"{name}_bn1")
            g.addLayer(f"{name}_bn2", L.BatchNormalization(activation="RELU"), f"{name}_c2")
            g.addLayer(f"{name}_c3", L.ConvolutionLayer(nOut=out, kernelSize=(1, 1),
                                                        activation="IDENTITY"), f"{name}_bn2")
            g.addLayer(f"{name}_bn3", L.BatchNormalization(activation="IDENTITY"),
                       f"{name}_c3")
            if bi == 0:
                g.addLayer(f"{name}_sc", L.ConvolutionLayer(nOut=out, kernelSize=(1, 1),
                                                            stride=(stride, stride),
                                                            activation="IDENTITY"), prev)
                g.addLayer(f"{name}_scbn", L.BatchNormalization(activation="IDENTITY"),
                           f"{name}_sc")
                shortcut = f"{name}_scbn"
            else:
                shortcut = prev
            g.addVertex(f"{name}_add", nn.ElementWiseVertex(op="Add"), f"{name}_bn3", shortcut)
            g.addLayer(f"{name}_relu", L.ActivationLayer(activation="RELU"), f"{name}_add")
            prev = f"{name}_relu"
    g.addLayer("avgpool", L.GlobalPoolingLayer(poolingType="AVG"), prev)
    g.addLayer("output", L.OutputLayer(nOut=num_classes, activation="SOFTMAX",
                                       lossFunction="MCXENT"), "avgpool")
    g.setOutputs("output")
    return g.build()


def attention_graph(nn, train, *, d=768, heads=12, T=512, classes=10, seed=5,
                    dtype="FLOAT", attention_kernel=None, lr=1e-3):
    """Two residual self-attention blocks, merged, pooled, classified."""
    L = nn.layers
    g = (nn.NeuralNetConfiguration.Builder().seed(seed).dataType(dtype)
         .updater(train.Adam(lr)).graphBuilder()
         .addInputs("x").setInputTypes(nn.InputType.recurrent(d, T)))
    g.addLayer("sa1", L.SelfAttentionLayer(nOut=d, nHeads=heads,
                                           attentionKernel=attention_kernel), "x")
    g.addVertex("add1", nn.ElementWiseVertex(op="Add"), "sa1", "x")
    g.addLayer("sa2", L.SelfAttentionLayer(nOut=d, nHeads=heads,
                                           attentionKernel=attention_kernel), "add1")
    g.addVertex("add2", nn.ElementWiseVertex(op="Add"), "sa2", "add1")
    g.addVertex("merge", nn.MergeVertex(), "add1", "add2")
    g.addLayer("pool", L.GlobalPoolingLayer(poolingType="AVG"), "merge")
    g.addLayer("out", L.OutputLayer(nOut=classes, activation="SOFTMAX",
                                    lossFunction="MCXENT"), "pool")
    g.setOutputs("out")
    return g.build()


def attention_vertex_graph(nn, train, graph_mod, *, d=768, heads=12, T=512, classes=10,
                           seed=6, dtype="FLOAT", lr=1e-3):
    """The attention vertices: a DotProductAttentionVertex and a
    (parameterised) AttentionVertex over the same input, merged, pooled,
    classified. ``graph_mod`` is the package's ``nn.conf.graph``."""
    L = nn.layers
    g = (nn.NeuralNetConfiguration.Builder().seed(seed).dataType(dtype)
         .updater(train.Adam(lr)).graphBuilder()
         .addInputs("x").setInputTypes(nn.InputType.recurrent(d, T)))
    g.addVertex("dpa", graph_mod.DotProductAttentionVertex(), "x", "x", "x")
    g.addVertex("att", graph_mod.AttentionVertex(nInQueries=d, nInKeys=d, nInValues=d,
                                                 nOut=d, nHeads=heads), "x", "x", "x")
    g.addVertex("merge", nn.MergeVertex(), "dpa", "att")
    g.addLayer("pool", L.GlobalPoolingLayer(poolingType="AVG"), "merge")
    g.addLayer("out", L.OutputLayer(nOut=classes, activation="SOFTMAX",
                                    lossFunction="MCXENT"), "pool")
    g.setOutputs("out")
    return g.build()


def multi_io(nn, train, *, seed=3, frozen=None):
    """Two inputs, two outputs; ``frozen`` names a node to freeze."""
    L = nn.layers
    g = (nn.NeuralNetConfiguration.Builder().seed(seed).updater(train.Adam(1e-2))
         .l2(1e-3).graphBuilder()
         .addInputs("in1", "in2")
         .setInputTypes(nn.InputType.feedForward(5), nn.InputType.recurrent(4, 6))
         .addLayer("zd", L.DenseLayer(nOut=6, activation="TANH", dropOut=0.8), "in1")
         .addLayer("bn", L.BatchNormalization(), "zd")
         .addLayer("lstm", L.LSTM(nOut=5), "in2")
         .addLayer("pool", L.GlobalPoolingLayer(poolingType="AVG"), "lstm")
         .addLayer("drop", L.DropoutLayer(dropOut=0.7), "pool")
         .addVertex("m", nn.MergeVertex(), "bn", "drop")
         .addLayer("a_out", L.OutputLayer(nOut=3), "m")
         .addLayer("b_out", L.OutputLayer(nOut=2, lossFunction="MSE", activation="IDENTITY"),
                   "bn")
         .setOutputs("a_out", "b_out"))
    conf = g.build()
    if frozen:
        next(n for n in conf.nodes if n.name == frozen).op.frozen = True
    return conf


def multi_io_data(seed=0, batch=4):
    """Features [(B,5), (B,6,4)], labels [(B,3) one-hot, (B,2)], and the
    sequence input's mask (rows of different lengths)."""
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((batch, 5)).astype(np.float32)
    x2 = rng.standard_normal((batch, 6, 4)).astype(np.float32)
    y1 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]
    y2 = rng.standard_normal((batch, 2)).astype(np.float32)
    m2 = (np.arange(6)[None] < rng.integers(1, 7, batch)[:, None]).astype(np.float32)
    return [x1, x2], [y1, y2], m2


# ------------------------------------------------------------------ vertices
# (id, (class name, kwargs), input shapes, module): "graph" classes live
# in ``nn.conf.graph``; every input is a float32 normal draw except where
# the id says ``mask`` (the last input is then a (B, Tk) 0/1 key mask).

VERTEX_CASES = [
    ("merge_ff", ("MergeVertex", {}), [(3, 4), (3, 2)]),
    ("merge_cnn", ("MergeVertex", {}), [(2, 3, 4, 4), (2, 1, 4, 4)]),
    ("merge_rnn", ("MergeVertex", {}), [(2, 5, 3), (2, 5, 2)]),
    ("add", ("ElementWiseVertex", dict(op="Add")), [(3, 4)] * 3),
    ("subtract", ("ElementWiseVertex", dict(op="Subtract")), [(3, 4)] * 2),
    ("product", ("ElementWiseVertex", dict(op="Product")), [(2, 3, 5)] * 3),
    ("average", ("ElementWiseVertex", dict(op="Average")), [(3, 4)] * 3),
    ("max", ("ElementWiseVertex", dict(op="Max")), [(2, 2, 3, 3)] * 2),
    ("subset_ff", ("SubsetVertex", dict(fromIndex=1, toIndex=3)), [(3, 5)]),
    ("subset_rnn", ("SubsetVertex", dict(fromIndex=0, toIndex=1)), [(2, 4, 3)]),
    ("stack", ("StackVertex", {}), [(2, 4), (2, 4)]),
    ("unstack", ("UnstackVertex", dict(fromIndex=1, stackSize=2)), [(4, 3)]),
    ("scale", ("ScaleVertex", dict(scaleFactor=2.5)), [(3, 4)]),
    ("shift", ("ShiftVertex", dict(shiftFactor=-0.5)), [(3, 4)]),
    ("l2_normalize", ("L2NormalizeVertex", {}), [(2, 3, 2, 2)]),
    ("reshape", ("ReshapeVertex", dict(newShape=(-1, 3, 4))), [(2, 12)]),
    ("dot_product_attention", ("DotProductAttentionVertex", {}),
     [(2, 4, 6), (2, 5, 6), (2, 5, 3)]),
    ("dot_product_attention_scaled_mask", ("DotProductAttentionVertex", dict(scale=0.5)),
     [(2, 4, 6), (2, 5, 6), (2, 5, 3), (2, 5)]),
    ("attention", ("AttentionVertex", dict(nInQueries=6, nInKeys=5, nInValues=4, nOut=8,
                                           nHeads=2)),
     [(2, 3, 6), (2, 5, 5), (2, 5, 4)]),
    ("pre_cnn_to_ff", ("PreprocessorVertex", dict(preprocessor="cnnToFF")), [(2, 3, 2, 2)]),
    ("pre_ff_to_rnn", ("PreprocessorVertex", dict(preprocessor="ffToRnn")), [(2, 5)]),
    ("pre_rnn_to_ff", ("PreprocessorVertex", dict(preprocessor="rnnToFF")), [(2, 3, 4)]),
    ("pre_rnn_to_cnn", ("PreprocessorVertex", dict(preprocessor="rnnToCnn", channels=2,
                                                   height=2, width=3)), [(2, 3, 12)]),
    ("pre_cnn_to_rnn", ("PreprocessorVertex", dict(preprocessor="cnnToRnn")), [(2, 2, 3, 2)]),
]

VERTEX_NAMES = ("MergeVertex", "ElementWiseVertex", "SubsetVertex", "StackVertex",
                "UnstackVertex", "ScaleVertex", "ShiftVertex", "L2NormalizeVertex",
                "ReshapeVertex", "DotProductAttentionVertex", "AttentionVertex",
                "PreprocessorVertex")


def vertex_case(case_id):
    return next(c for c in VERTEX_CASES if c[0] == case_id)


def make_vertex(graph_mod, case_id):
    _, (name, kwargs), _ = vertex_case(case_id)
    return getattr(graph_mod, name)(**kwargs)


def vertex_inputs(case_id, seed=0):
    _, _, shapes = vertex_case(case_id)
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if case_id.endswith("mask"):
        B, T = shapes[-1]
        out[-1] = (np.arange(T)[None] < np.arange(T, T - B, -1)[:, None]).astype(np.float32)
    return out


# ------------------------------------------------------- data parallelism


def dp_net(nn, train, *, seed=11):
    """A network with what data parallelism must see across the blocks:
    conf-level dropout, BatchNormalization, a DropoutLayer (uniform init,
    so both packages start from the same bits)."""
    L = nn.layers
    return (nn.NeuralNetConfiguration.Builder().seed(seed).weightInit("XAVIER_UNIFORM")
            .updater(train.Adam(1e-2)).list()
            .layer(L.DenseLayer(nOut=8, activation="RELU", dropOut=0.8))
            .layer(L.BatchNormalization())
            .layer(L.DropoutLayer(dropOut=0.7))
            .layer(L.OutputLayer(nOut=3))
            .setInputType(nn.InputType.feedForward(6)).build())


def dp_batches(seed=0, sizes=(8, 8, 7)):
    """(features, labels) batches; the last one partial (7 rows over 2
    ranks: cyclic-padded to 8)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for b in sizes]
