"""The port's configuration DSL, seeded init and dropout
(``deeplearning4j_tpu_torch/nn/conf``) against the JAX package's on the
CPU:

- ``MultiLayerConfiguration.to_json`` gives the reference's string for
  one configuration per layer case of ``tests/torch_nn_cases.py``, the
  reference's 57 layer types (and
  for a configuration with every builder global set), and each package's
  ``from_json`` reads the other's string back to the same string;
- a network's seeded ``init`` gives the reference's parameter trees
  (uniform draws bit for bit, normal draws within 4e-6 of the largest
  |value|: the last bits of ``erfinv`` differ between XLA and torch).
Every ``WeightInit`` and dropout variant alone is in
``tests/test_torch_nn_init.py``. The port's 64-bit switch is on, as the
suite runs the reference.
"""
import json

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.nn.conf import dropout as jdrop
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.nn.conf import dropout as pdrop
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

import torch_nn_cases as C

NORMAL_ABS = 4e-6


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id", C.CASE_IDS)
def test_to_json_equals_reference(case_id):
    _, jconf = C.build(jnn, case_id, seed=7)
    _, pconf = C.build(pnn, case_id, seed=7)
    js, ps = jconf.to_json(), pconf.to_json()
    assert ps == js
    # either package reads the other's string back to the same string
    assert pnn.MultiLayerConfiguration.from_json(js).to_json() == js
    assert jnn.MultiLayerConfiguration.from_json(ps).to_json() == ps


def _full_conf(pkg, train, dropout):
    return (pkg.NeuralNetConfiguration.Builder().seed(12)
            .updater(train.Nesterovs(lr=train.StepSchedule(initialValue=0.2, decayRate=0.5,
                                                           step=3), momentum=0.8))
            .activation("RELU").weightInit("XAVIER_UNIFORM").biasInit(0.1)
            .dropOut(dropout.GaussianDropout(0.2)).l1(1e-4).l2(2e-4).weightDecay(1e-3)
            .gradientNormalization("ClipL2PerLayer", 0.5).dataType("FLOAT")
            .list()
            .layer(pkg.layers.DenseLayer(nOut=6))
            .layer(pkg.layers.DropoutLayer(dropOut=dropout.SpatialDropout(0.7)))
            .layer(pkg.layers.OutputLayer(nOut=2, lossFunction="MSE"))
            .setInputType(pkg.InputType.feedForward(5))
            .backpropType("TruncatedBPTT").tBPTTForwardLength(4).tBPTTBackwardLength(4)
            .build())


def test_builder_globals_to_json():
    """Every builder global (updater with a schedule, activation, init,
    bias, an IDropout, regularization, gradient normalization, tBPTT)."""
    js = _full_conf(jnn, jtrain, jdrop).to_json()
    ps = _full_conf(pnn, ptrain, pdrop).to_json()
    assert ps == js
    back = pnn.MultiLayerConfiguration.from_json(js)
    assert back.to_json() == js
    assert isinstance(back.layers[0].dropOut, pdrop.GaussianDropout)
    assert isinstance(back.updater.lr, ptrain.StepSchedule)


@pytest.mark.parametrize("weight_init", ["XAVIER", "XAVIER_UNIFORM", "RELU"])
def test_network_seeded_init_equals_reference(weight_init):
    """``MultiLayerNetwork.init`` splits the seed's key once per layer and
    each layer splits again: the trees equal the reference's (uniform bit
    for bit, normal within 4e-6), over layers that split in different ways
    (Dense, Conv, LSTM, Bidirectional, SelfAttention, separable conv)."""
    def conf(pkg):
        L = pkg.layers
        return (pkg.NeuralNetConfiguration.Builder().seed(31).weightInit(weight_init).list()
                .layer(L.ConvolutionLayer(nOut=2, kernelSize=(3, 3)))
                .layer(L.SeparableConvolution2D(nOut=3, kernelSize=(2, 2)))
                .layer(L.DenseLayer(nOut=5))
                .layer(L.RepeatVector(repetitionFactor=4))
                .layer(L.Bidirectional(fwd=L.LSTM(nOut=3)))
                .layer(L.SelfAttentionLayer(nOut=4, nHeads=2))
                .layer(L.GravesLSTM(nOut=3))
                .layer(L.RnnOutputLayer(nOut=2))
                .setInputType(pkg.InputType.convolutional(6, 6, 1)).build())

    jnet = jnn.MultiLayerNetwork(conf(jnn)).init()
    pnet = pnn.MultiLayerNetwork(conf(pnn), device="cpu").init()
    want = jax.tree_util.tree_leaves(jnet._params)
    got = tree_leaves(pnet._params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if weight_init.endswith("UNIFORM"):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=NORMAL_ABS * max(np.abs(w).max(), 1.0))
    assert pnet.numParams() == jnet.numParams()
    np.testing.assert_allclose(pnet.params().toNumpy(), np.asarray(jnet.params().jax),
                               rtol=0, atol=NORMAL_ABS)


def test_input_types_round_trip():
    for make in (lambda T: T.feedForward(4), lambda T: T.convolutional(3, 4, 2),
                 lambda T: T.convolutionalFlat(28, 28, 1), lambda T: T.recurrent(5, 7),
                 lambda T: T.convolutional3D(2, 3, 4, 5),
                 lambda T: T.convolutionalSequence(3, 3, 2, 4)):
        j, p = make(jnn.InputType), make(pnn.InputType)
        assert j.to_dict() == p.to_dict()
        assert pnn.InputType.from_dict(json.loads(json.dumps(j.to_dict()))) == p
        assert j.flat_size() == p.flat_size()
        assert j.array_shape(3) == p.array_shape(3)
