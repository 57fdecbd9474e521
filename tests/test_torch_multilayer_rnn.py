"""The port's ``MultiLayerNetwork`` on sequences against the JAX package's
on the CPU, each port network built from the reference network's
``to_json()``: masked batches (features and labels masks) through every
mask-taking layer kind, tBPTT (the cases of ``tests/test_rnn_state.py``:
LSTM, GravesLSTM, SimpleRnn and GRU, NWC and NCW) and ``rnnTimeStep``
streaming (chunks and single steps against the whole-sequence output and
the reference's stream). Losses within 1e-5 relative, parameters within
1e-5 of the network's largest |parameter|. The port's 64-bit switch is
on, as the suite runs the reference.
"""

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.util import crash_reporting


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


def _seq_conf(pkg, train):
    L = pkg.layers
    return (pkg.NeuralNetConfiguration.Builder().seed(6).updater(train.Nesterovs(
                lr=train.StepSchedule(initialValue=0.05, decayRate=0.5, step=2)))
            .list()
            .layer(L.Bidirectional(fwd=L.GravesLSTM(nOut=4)))
            .layer(L.SelfAttentionLayer(nOut=6, nHeads=2))
            .layer(L.LSTM(nOut=4))
            .layer(L.RnnOutputLayer(nOut=3, lossFunction="MCXENT"))
            .setInputType(pkg.InputType.recurrent(3, 7)).build())


def test_masked_sequence_trajectory():
    """Features and labels masks through every mask-taking layer kind,
    3 steps, a Nesterovs step schedule (linear in the gradients: an
    updater that normalizes them, as RmsProp does, would turn rounding-level
    gradients of masked positions into full steps)."""
    jnet = jnn.MultiLayerNetwork(_seq_conf(jnn, jtrain)).init()
    pnet = port_of(jnet)
    rng = np.random.default_rng(5)
    for i in range(3):
        x = rng.standard_normal((4, 7, 3)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 7))]
        fm = (np.arange(7)[None] < np.array([7, 5, 3, 6])[:, None]).astype(np.float32)
        ds = JDataSet(x, y, fm, fm)
        jnet.fit(ds)
        pnet.fit(pds(ds))
        assert pnet.score() == pytest.approx(jnet.score(), rel=REL)
    out = pnet.output(x, features_mask=fm).toNumpy()
    close(out, np.asarray(jnet.output(x, features_mask=fm).jax), REL, "masked output")
    same_params(pnet, jnet, REL, "masked")


def _rnn_conf(pkg, train, cell, tbptt=False, k=8):
    b = (pkg.NeuralNetConfiguration.Builder().seed(5).updater(train.Adam(0.01)).list()
         .layer(getattr(pkg.layers, cell)(nIn=4, nOut=8))
         .layer(pkg.layers.RnnOutputLayer(nIn=8, nOut=4, activation="SOFTMAX",
                                          lossFunction="MCXENT")))
    if tbptt:
        b = b.backpropType("TruncatedBPTT").tBPTTForwardLength(k).tBPTTBackwardLength(k)
    return b.build()


@pytest.mark.parametrize("cell", ["LSTM", "GravesLSTM", "SimpleRnn", "GRU"])
def test_tbptt_trajectory(cell):
    """(test_rnn_state.test_tbptt_trains) 24 steps in 8-step segments:
    3 updates a DataSet, the reference's losses and parameters."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 24, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 24))]
    jnet = jnn.MultiLayerNetwork(_rnn_conf(jnn, jtrain, cell, tbptt=True)).init()
    pnet = port_of(jnet)
    scores = []
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        scores.append(pnet.score(DataSet(x, y)))
        assert scores[-1] == pytest.approx(jnet.score(JDataSet(x, y)), rel=REL)
    assert pnet.getIterationCount() == 9
    assert scores[-1] < scores[0]
    same_params(pnet, jnet, REL, f"tbptt {cell}")


def test_tbptt_ncw_layout():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 24)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 24))].transpose(0, 2, 1)

    def conf(pkg, train):
        return (pkg.NeuralNetConfiguration.Builder().seed(5).updater(train.Adam(0.01)).list()
                .layer(pkg.layers.LSTM(nIn=4, nOut=8, rnnDataFormat="NCW"))
                .layer(pkg.layers.RnnOutputLayer(nIn=8, nOut=4, activation="SOFTMAX",
                                                 lossFunction="MCXENT", rnnDataFormat="NCW"))
                .backpropType("TruncatedBPTT").tBPTTForwardLength(8).build())
    jnet = jnn.MultiLayerNetwork(conf(jnn, jtrain)).init()
    pnet = port_of(jnet)
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.getIterationCount() == 3
    same_params(pnet, jnet, REL, "tbptt ncw")


@pytest.mark.parametrize("cell", ["LSTM", "GravesLSTM", "GRU"])
def test_rnn_time_step_streams_the_sequence(cell):
    """(test_rnn_state) chunks and single steps through rnnTimeStep equal
    the whole-sequence output, which equals the reference's; clearing
    restarts; the stored state is readable."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4)).astype(np.float32)
    jnet = jnn.MultiLayerNetwork(_rnn_conf(jnn, jtrain, cell)).init()
    pnet = port_of(jnet)
    whole = pnet.output(x).toNumpy()
    close(whole, np.asarray(jnet.output(x).jax), REL, "whole")
    parts = [pnet.rnnTimeStep(x[:, a:a + 4]).toNumpy() for a in range(0, 16, 4)]
    np.testing.assert_allclose(np.concatenate(parts, axis=1), whole, atol=1e-5)
    pnet.rnnClearPreviousState()
    steps = [pnet.rnnTimeStep(x[:, t]).toNumpy() for t in range(16)]
    np.testing.assert_allclose(np.stack(steps, axis=1), whole, atol=1e-5)
    jnet.rnnClearPreviousState()
    jsteps = [np.asarray(jnet.rnnTimeStep(x[:, t]).jax) for t in range(16)]
    close(np.stack(steps, 1), np.stack(jsteps, 1), REL, "streamed")
    st = pnet.rnnGetPreviousState(0)
    assert "h" in st and st["h"].shape == (2, 8)
    pnet.rnnClearPreviousState()
    np.testing.assert_allclose(pnet.rnnTimeStep(x[:, 0]).toNumpy(), steps[0], atol=1e-6)
