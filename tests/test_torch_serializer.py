"""``ModelSerializer`` (``deeplearning4j_tpu_torch/util/
model_serializer.py``) in both directions against the JAX package's, on
the CPU: a zip the reference wrote restores in the port and one the port
wrote restores in the reference, each giving the writer's outputs (1e-5
relative), ``numParams``, iteration count and updater-state leaves (equal,
in optax's order), and, after one more step with the restored updater
state, the writer's next parameters (within 1e-5 of the largest
|parameter|) — over Adam, Nesterovs with BatchNormalization's running
statistics in ``state.npz``, and AdaGrad with a learning-rate schedule
(its count in the updater state). And the refusal of what is not a
network. The port's 64-bit switch is on, as the suite runs the reference.
"""
import json

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.util.model_serializer import ModelSerializer as JSerializer
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.util import crash_reporting
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

import test_golden_trajectories as G

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


def _serializer_case(name):
    jnet, batches = G.CASES[name]()
    if name == "lstm_adam":  # a schedule: the updater state carries its count
        conf = json.loads(jnet.conf.to_json())
        conf["updater"] = jtrain.AdaGrad(lr=jtrain.ExponentialSchedule(
            initialValue=0.05, gamma=0.9)).to_dict()
        jnet = jnn.MultiLayerNetwork(jnn.MultiLayerConfiguration.from_json(
            json.dumps(conf))).init()
    return jnet, batches


@pytest.mark.parametrize("name", ["mlp_adam", "cnn_bn_nesterovs", "lstm_adam"])
def test_serializer_reference_to_port(name, tmp_path):
    jnet, batches = _serializer_case(name)
    for ds in batches[:3]:
        jnet.fit(ds)
    path = str(tmp_path / "ref.zip")
    JSerializer.writeModel(jnet, path, saveUpdater=True)
    pnet = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    x = batches[3].features
    close(pnet.output(x).toNumpy(), np.asarray(jnet.output(x).jax), REL, "restored output")
    np.testing.assert_array_equal(pnet.params().toNumpy(), np.asarray(jnet.params().jax))
    assert pnet.numParams() == jnet.numParams()
    assert pnet.getIterationCount() == jnet.getIterationCount() == 3
    for a, b in zip(tree_leaves(pnet._opt_state), jax.tree_util.tree_leaves(jnet._opt_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jnet.fit(batches[3])
    pnet.fit(pds(batches[3]))
    same_params(pnet, jnet, REL, "continued")


@pytest.mark.parametrize("name", ["mlp_adam", "cnn_bn_nesterovs", "lstm_adam"])
def test_serializer_port_to_reference(name, tmp_path):
    jnet, batches = _serializer_case(name)
    pnet = port_of(jnet)
    for ds in batches[:3]:
        pnet.fit(pds(ds))
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(pnet, path, saveUpdater=True)
    back = JSerializer.restoreMultiLayerNetwork(path)
    x = batches[3].features
    close(np.asarray(back.output(x).jax), pnet.output(x).toNumpy(), REL, "restored output")
    assert back.numParams() == pnet.numParams()
    assert back.getIterationCount() == 3
    for a, b in zip(jax.tree_util.tree_leaves(back._opt_state), tree_leaves(pnet._opt_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back.fit(batches[3])
    pnet.fit(pds(batches[3]))
    same_params(pnet, back, REL, "continued")
    # and the port restores its own file: the same params, then the same step
    again = ModelSerializer.restoreModel(path, device="cpu")
    assert again.getIterationCount() == 3


def test_serializer_refusals(tmp_path):
    with pytest.raises(TypeError, match="cannot serialize dict"):
        ModelSerializer.writeModel({}, str(tmp_path / "x.zip"))


def test_serializer_half_network_both_ways(tmp_path):
    """A HALF (bfloat16) network: the reference's zip (its bfloat16 leaves
    stored as two-byte records) restores in the port with every updater
    leaf equal, and the port writes bfloat16 leaves as float32 (exact),
    which the reference reads back to the same values."""
    def conf(pkg, train):
        return (pkg.NeuralNetConfiguration.Builder().seed(5).updater(train.Adam(1e-2))
                .dataType("HALF").list()
                .layer(pkg.layers.DenseLayer(nOut=6, activation="TANH"))
                .layer(pkg.layers.BatchNormalization())
                .layer(pkg.layers.OutputLayer(nOut=3))
                .setInputType(pkg.InputType.feedForward(4)).build())
    rng = np.random.default_rng(0)
    ds = JDataSet(rng.standard_normal((8, 4)).astype(np.float32),
                  np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
    jnet = jnn.MultiLayerNetwork(conf(jnn, jtrain)).init()
    jnet.fit(ds)
    path = str(tmp_path / "half.zip")
    JSerializer.writeModel(jnet, path)
    pnet = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert pnet.conf.to_json() == conf(pnn, ptrain).to_json()
    for a, b in zip(tree_leaves(pnet._opt_state) + tree_leaves(pnet._state),
                    jax.tree_util.tree_leaves(jnet._opt_state)
                    + jax.tree_util.tree_leaves(jnet._state)):
        np.testing.assert_array_equal(a.float().numpy() if a.is_floating_point() else a.numpy(),
                                      np.asarray(b, np.float32 if a.is_floating_point() else None))
    path2 = str(tmp_path / "half_port.zip")
    ModelSerializer.writeModel(pnet, path2)
    back = JSerializer.restoreMultiLayerNetwork(path2)
    for a, b in zip(jax.tree_util.tree_leaves(back._opt_state),
                    jax.tree_util.tree_leaves(jnet._opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(back.params().jax, np.float32),
                                  np.asarray(jnet.params().jax, np.float32))
