"""Training through the second half's heads and autoencoders, against
the JAX package on the CPU: networks ending in a CenterLossOutputLayer,
an OCNNOutputLayer and a Yolo2OutputLayer fitted 3 steps side by side
(``_loss_for``'s head branches; losses and parameters within 1e-5
relative), and AutoEncoder / VariationalAutoencoder ``pretrain`` (the
corruption masks and the ELBO's noise are the reference's draws on the
same keys) and the VAE's ``reconstructionProbability``. The port's 64-bit
switch is on, as the suite runs the reference.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

import torch_nn_parity as H
from test_torch_nn_layers2_heads import _head_labels

REL = 1e-5


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


def _head_net(pkg, train, head):
    L = pkg.layers
    b = (pkg.NeuralNetConfiguration.Builder().seed(9).updater(train.Adam(5e-2)).list())
    if head == "yolo":
        return (b.layer(L.ConvolutionLayer(nOut=14, kernelSize=(1, 1)))
                .layer(L.Yolo2OutputLayer(boundingBoxes=((1.0, 1.5), (2.0, 1.0))))
                .setInputType(pkg.InputType.convolutional(3, 3, 2)).build())
    b = b.layer(L.DenseLayer(nOut=6, activation="TANH"))
    if head == "center":
        b = b.layer(L.CenterLossOutputLayer(nOut=3, lambda_=0.5))
    else:
        b = b.layer(L.OCNNOutputLayer(hiddenSize=4))
    return b.setInputType(pkg.InputType.feedForward(5)).build()


@pytest.mark.parametrize("head", ["center", "ocnn", "yolo"])
def test_head_network_fit_matches_reference(head):
    """A network ending in the head: 3 fit steps from the same weights,
    the reference's losses and parameters (``_loss_for``'s head
    branches); the center loss's features never stay in the state."""
    jnet = jnn.MultiLayerNetwork(_head_net(jnn, jtrain, head)).init()
    jnet.fuseSteps = 0
    pnet = pnn.MultiLayerNetwork(pnn.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                 device="cpu").init()
    pnet.setParamTrees(H.np_tree(jnet._params), H.np_tree(jnet._state))
    rng = np.random.default_rng(2)
    if head == "yolo":
        x = rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
        y = _head_labels("yolo2_output", (3, 14, 3, 3))
    else:
        x = rng.standard_normal((4, 5)).astype(np.float32)
        y = np.eye(3 if head == "center" else 1, dtype=np.float32)[rng.integers(
            0, 3 if head == "center" else 1, 4)]
    for step in range(3):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        H.close(pnet.score(), float(jnet.score()), REL, f"{head} loss {step}")
    want = np.asarray(jnet.params().jax)
    H.close(pnet.params().toNumpy(), want, REL, f"{head} params")
    assert all(not s for s in pnet._state)


def _ae_net(pkg, train, kind, dist="GAUSSIAN"):
    L = pkg.layers
    pre = (L.AutoEncoder(nOut=4, activation="SIGMOID", corruptionLevel=0.3, sparsity=0.1)
           if kind == "ae" else
           L.VariationalAutoencoder(nOut=3, encoderLayerSizes=(7,), decoderLayerSizes=(6,),
                                    activation="TANH", numSamples=2,
                                    reconstructionDistribution=dist))
    return (pkg.NeuralNetConfiguration.Builder().seed(21).updater(train.Adam(1e-2)).list()
            .layer(L.DenseLayer(nOut=5, activation="RELU"))
            .layer(pre)
            .layer(L.OutputLayer(nOut=2))
            .setInputType(pkg.InputType.feedForward(6)).build())


@pytest.mark.parametrize("kind,dist", [("ae", None), ("vae", "GAUSSIAN"),
                                       ("vae", "BERNOULLI")])
def test_pretrain_layer_matches_reference(kind, dist):
    """``pretrain`` (every pretrainable layer, in order; the others
    skipped) for 2 epochs over 2 batches: the pretrained layer's
    parameters, the other layers untouched, the last pretrain score and
    the iteration count equal the reference's. The VAE's
    ``reconstructionProbability`` afterwards too."""
    jnet = jnn.MultiLayerNetwork(_ae_net(jnn, jtrain, kind, dist or "GAUSSIAN")).init()
    pnet = pnn.MultiLayerNetwork(pnn.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                 device="cpu").init()
    pnet.setParamTrees(H.np_tree(jnet._params), H.np_tree(jnet._state))
    rng = np.random.default_rng(8)
    xs = [rng.uniform(0, 1, (5, 6)).astype(np.float32) for _ in range(2)]
    ys = [np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)] for _ in range(2)]
    from deeplearning4j_tpu.data import ListDataSetIterator as JIt
    from deeplearning4j_tpu_torch.data import ListDataSetIterator as PIt
    jnet.pretrain(JIt([JDataSet(x, y) for x, y in zip(xs, ys)]), epochs=2)
    pnet.pretrain(PIt([DataSet(x, y) for x, y in zip(xs, ys)]), epochs=2)
    assert pnet.getIterationCount() == jnet.getIterationCount() == 4
    H.close(pnet.score(), float(jnet.score()), REL, "pretrain score")
    for i in range(3):
        for a, b in zip(tree_leaves(pnet._params[i]),
                        jax.tree_util.tree_leaves(jnet._params[i])):
            H.close(a.numpy(), np.asarray(b), REL, f"layer {i} after pretrain")
    if kind == "vae":
        feats = np.asarray(jnet.feedForward(xs[0])[1].jax)
        lay_j, lay_p = jnet.layers[1], pnet.layers[1]
        want = lay_j.reconstructionProbability(jnet._params[1], feats, num_samples=3)
        got = lay_p.reconstructionProbability(pnet._params[1], torch.tensor(feats),
                                              num_samples=3)
        H.close(got.numpy(), np.asarray(want), REL, "reconstructionProbability")
