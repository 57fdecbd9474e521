"""The port's ``MultiLayerNetwork`` training options against the JAX
package's on the CPU, each port network built from the reference
network's ``to_json()`` and fed the same numpy batches:

- conf-level dropout (a float retain probability and ``IDropout``s) and
  a ``DropoutLayer``: the training forward of a step key equal to the
  reference's (the zeros bit for bit: the step key's per-layer split and
  fold_in(7) draw the reference's masks), and 3-step trajectories;
- each gradient normalization mode with L1, L2 and weight-decay
  regularization over convolutions and BatchNormalization, 3 steps.
Losses within 1e-5 relative, parameters within 1e-5 of the network's
largest |parameter|. The port's 64-bit switch is on, as the suite runs
the reference.
"""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import dropout as jdrop
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import random as prng
from deeplearning4j_tpu_torch.nn.conf import dropout as pdrop
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.util import crash_reporting
from torch_threads import one_torch_thread  # noqa: F401,E402


REL = 1e-5


@pytest.fixture(autouse=True)
def _x64(tmp_path):
    crash_reporting.crashDumpOutputDirectory(str(tmp_path))
    with nd.enableX64(True):
        yield
    crash_reporting.crashDumpOutputDirectory(None)


def close(got, want, rel, what, scale=None):
    """max |got - want| <= rel x (``scale``, else the largest |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def port_of(jnet, carry=True):
    """The port's network for the reference network's configuration: its
    own seeded init, then (``carry``) the reference's weights and layer
    state taken across as numpy, so both run from the same values."""
    conf = pnn.MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = pnn.MultiLayerNetwork(conf, device="cpu").init()
    if carry:
        net.setParamTrees(jax.tree_util.tree_map(np.asarray, jnet._params),
                          jax.tree_util.tree_map(np.asarray, jnet._state))
    return net


def pds(ds):
    return DataSet(ds.features, ds.labels, ds.features_mask, ds.labels_mask)


def same_params(pnet, jnet, rel, what):
    """Every parameter within ``rel`` of the network's largest |parameter|
    (a leaf's own scale can be noise: a conv bias before BatchNorm has a
    gradient of 0 up to rounding)."""
    got, want = tree_leaves(pnet._params), jax.tree_util.tree_leaves(jnet._params)
    assert len(got) == len(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a.detach().numpy(), b, rel, f"{what} param {i}", scale=scale)


def _dropout_conf(pkg, drop_mod):
    L = pkg.layers
    return (pkg.NeuralNetConfiguration.Builder().seed(8).updater(
                (jtrain if pkg is jnn else ptrain).Sgd(0.1))
            .list()
            .layer(L.DenseLayer(nOut=12, activation="RELU", dropOut=0.7))
            .layer(L.DropoutLayer(dropOut=0.6))
            .layer(L.DenseLayer(nOut=10, activation="TANH",
                                dropOut=drop_mod.AlphaDropout(0.85)))
            .layer(L.DenseLayer(nOut=8, activation="TANH",
                                dropOut=drop_mod.SpatialDropout(0.8)))
            .layer(L.OutputLayer(nOut=3, lossFunction="MCXENT"))
            .setInputType(pkg.InputType.feedForward(6)).build())


def test_conf_level_dropout_masks_and_trajectory():
    """The step key's per-layer split and fold_in(7) give the reference's
    masks: the training forward is equal bit for bit in where it is zero,
    and 3 fit steps follow the reference's trajectory."""
    jnet = jnn.MultiLayerNetwork(_dropout_conf(jnn, jdrop)).init()
    pnet = port_of(jnet)
    assert pnet.conf.to_json() == _dropout_conf(pnn, pdrop).to_json()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    fwd = jax.jit(lambda p, s, x, k: jnet._forward(p, s, x, training=True, rng=k)[0])
    for seed in (0, 1):
        jacts = np.asarray(fwd(jnet._params, jnet._state, jax.numpy.asarray(x),
                               jax.random.key(seed)))
        got, _, _ = pnet._forward(pnet._params, pnet._state, torch.tensor(x),
                                  training=True, rng=prng.prng_key(seed))
        close(got.detach().numpy(), jacts, REL, f"dropout forward {seed}")
    for i in range(3):
        ds = JDataSet(x[i * 5:(i + 1) * 5 + 1], y[i * 5:(i + 1) * 5 + 1])
        jnet.fit(ds)
        pnet.fit(pds(ds))
        assert pnet.score() == pytest.approx(jnet.score(), rel=REL)
    same_params(pnet, jnet, REL, "dropout")


def test_dropout_layer_masks_bit_equal():
    """A DropoutLayer's zeros in the training forward are the reference's,
    element for element, for several step keys."""
    def conf(pkg):
        return (pkg.NeuralNetConfiguration.Builder().seed(2).list()
                .layer(pkg.layers.DropoutLayer(dropOut=0.5))
                .layer(pkg.layers.ActivationLayer(activation="IDENTITY", dropOut=0.4))
                .setInputType(pkg.InputType.feedForward(40)).build())
    jnet = jnn.MultiLayerNetwork(conf(jnn)).init()
    pnet = port_of(jnet)
    x = np.random.default_rng(1).standard_normal((8, 40)).astype(np.float32)
    fwd = jax.jit(lambda p, s, x, k: jnet._forward(p, s, x, training=True, rng=k)[0])
    for seed in range(4):
        want = fwd(jnet._params, jnet._state, jax.numpy.asarray(x), jax.random.key(seed))
        got, _, _ = pnet._forward(pnet._params, pnet._state, torch.tensor(x),
                                  training=True, rng=prng.prng_key(seed))
        np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("norm", ["ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
                                  "ClipL2PerParamType", "RenormalizeL2PerLayer"])
def test_gradient_normalization_and_regularization(norm):
    def conf(pkg, train):
        L = pkg.layers
        return (pkg.NeuralNetConfiguration.Builder().seed(4).updater(train.Adam(5e-2))
                .l1(1e-3).l2(2e-3).weightDecay(1e-2).gradientNormalization(norm, 0.05)
                .list()
                .layer(L.ConvolutionLayer(nOut=3, kernelSize=(3, 3), activation="RELU"))
                .layer(L.BatchNormalization())
                .layer(L.SeparableConvolution2D(nOut=2, kernelSize=(2, 2)))
                .layer(L.OutputLayer(nOut=2, lossFunction="XENT", activation="SIGMOID"))
                .setInputType(pkg.InputType.convolutional(6, 6, 2)).build())
    jnet = jnn.MultiLayerNetwork(conf(jnn, jtrain)).init()
    pnet = port_of(jnet)
    rng = np.random.default_rng(3)
    for _ in range(3):
        ds = JDataSet(rng.standard_normal((5, 2, 6, 6)).astype(np.float32),
                      (rng.random((5, 2)) > 0.5).astype(np.float32))
        jnet.fit(ds)
        pnet.fit(pds(ds))
        assert pnet.score() == pytest.approx(jnet.score(), rel=REL)
    same_params(pnet, jnet, REL, norm)
