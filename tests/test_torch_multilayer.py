"""The port's ``MultiLayerNetwork`` (``deeplearning4j_tpu_torch/nn/
multilayer.py``) and listeners against the JAX package's on the CPU. Each
port network is built from the reference network's own ``to_json()`` and
fed the same numpy batches.

- The reference's golden cases whose layers are all in this slice
  (``mlp_adam``, ``cnn_bn_nesterovs``, ``lstm_adam``,
  ``self_attention_adam``, ``conv_lstm2d_adam``): the port's seeded init
  and 5 fit steps, the loss per step and the final parameter sums within
  ``RTOL = 2e-4`` of ``tests/goldens/<case>.json`` (the golden suite's
  tolerance); and, from the reference's weights carried across
  (``setParamTrees``), the loss per step (1e-5 relative) and every final
  parameter (within 1e-5 of the network's largest |parameter|) of the
  reference run side by side.
- Evaluation, the flat-parameter surface, fit's overloads and epochs,
  listeners, a HALF network.
Dropout and gradient normalization are in
``tests/test_torch_multilayer_reg.py``, the recurrent paths in
``tests/test_torch_multilayer_rnn.py``, the serializer in
``tests/test_torch_serializer.py``. The port's 64-bit
switch is on, as the suite runs the reference.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.optimize import listeners as jlst
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.optimize import listeners as plst
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.util import crash_reporting

import test_golden_trajectories as G
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


GOLDEN = ["mlp_adam", "cnn_bn_nesterovs", "lstm_adam", "self_attention_adam",
          "conv_lstm2d_adam"]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_trajectory(name):
    with open(os.path.join(G.GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    jnet, batches = G.CASES[name]()
    pnet = port_of(jnet, carry=False)  # the port's own seeded init
    carried = port_of(jnet)
    losses, closses, jlosses = [], [], []
    for ds in batches:
        pnet.fit(pds(ds))
        losses.append(pnet.score())
        carried.fit(pds(ds))
        closses.append(carried.score())
        jnet.fit(ds)
        jlosses.append(jnet.score())
    leaves = pnet.params().toNumpy()
    np.testing.assert_allclose(losses, golden["losses"], rtol=G.RTOL)
    assert float(np.abs(leaves).sum()) == pytest.approx(golden["param_abs_sum"], rel=G.RTOL)
    assert float((leaves.astype(np.float64) ** 2).sum()) == pytest.approx(
        golden["param_sq_sum"], rel=G.RTOL)
    close(closses, jlosses, REL, f"{name} losses")
    same_params(carried, jnet, REL, name)
    assert carried.getIterationCount() == jnet.getIterationCount() == 5
    assert carried.getEpochCount() == jnet.getEpochCount() == 5
    # the layer state too (cnn_bn's running statistics)
    for a, b in zip(tree_leaves(carried._state), jax.tree_util.tree_leaves(jnet._state)):
        close(a.numpy(), b, REL, f"{name} state")


def test_flat_params_feed_forward_and_evaluation():
    jnet, batches = G.CASES["cnn_bn_nesterovs"]()
    pnet = port_of(jnet)
    x = batches[0].features
    np.testing.assert_allclose(pnet.params().toNumpy(), np.asarray(jnet.params().jax),
                               rtol=0, atol=4e-6)
    assert pnet.numParams() == jnet.numParams()
    flat = np.asarray(jnet.params().jax)
    pnet.setParams(flat)
    np.testing.assert_array_equal(pnet.params().toNumpy(), flat)
    acts, jacts = pnet.feedForward(x), jnet.feedForward(x)
    assert len(acts) == len(jacts)
    for a, b in zip(acts, jacts):
        close(a.toNumpy(), np.asarray(b.jax), REL, "feedForward")
    np.testing.assert_array_equal(pnet.predict(x), jnet.predict(x))
    ev, jev = pnet.evaluate(ListDataSetIterator([pds(b) for b in batches])), \
        jnet.evaluate(ListDataSetIterator([pds(b) for b in batches]))
    assert ev.stats() == jev.stats()
    reg = pnet.evaluateRegression(ListDataSetIterator([pds(batches[0])]))
    jreg = jnet.evaluateRegression(ListDataSetIterator([pds(batches[0])]))
    assert reg.meanSquaredError() == pytest.approx(jreg.meanSquaredError(), rel=REL)
    w = pnet.getParam(0, "W")
    pnet.setParam(0, "W", w.toNumpy() * 2)
    np.testing.assert_array_equal(pnet.getParam(0, "W").toNumpy(), w.toNumpy() * 2)
    other = pnet.clone()
    np.testing.assert_array_equal(other.params().toNumpy(), pnet.params().toNumpy())
    assert pnet.summary() == jnet.summary()


def test_fit_overloads_epochs_and_listeners(tmp_path):
    jnet, batches = G.CASES["mlp_adam"]()
    pnet = port_of(jnet)
    jc, pc = jlst.CollectScoresListener(), plst.CollectScoresListener()
    jnet.setListeners(jc)
    pnet.setListeners(pc, plst.ScoreIterationListener(2),
                      plst.PerformanceListener(frequency=2, reportScore=True),
                      plst.TimeIterationListener(10))
    ckpt = plst.CheckpointListener(str(tmp_path / "ck"), keepLast=2, saveEveryNIterations=3)
    pnet.addListeners(ckpt)
    jnet.fit(JListIterator(batches[:3]), epochs=2)
    pnet.fit(ListDataSetIterator([pds(b) for b in batches[:3]]), epochs=2)
    assert pc.iterations == jc.iterations == [1, 2, 3, 4, 5, 6]
    close(pc.scores, jc.scores, REL, "collected scores")
    assert pnet.getEpochCount() == 2 and pnet.getIterationCount() == 6
    jnet.fit(batches[3].features, batches[3].labels)
    pnet.fit(batches[3].features, batches[3].labels)
    assert pnet.score() == pytest.approx(jnet.score(), rel=REL)
    cps = plst.CheckpointListener.availableCheckpoints(str(tmp_path / "ck"))
    assert [n for n, _ in cps] == [0, 1]  # saved at iterations 3 and 6, kept 2
    back = plst.CheckpointListener.loadCheckpointMLN(str(tmp_path / "ck"), device="cpu")
    assert back.getIterationCount() == 6
    ev_l = plst.EvaluativeListener(ListDataSetIterator([pds(batches[4])]), frequency=1)
    pnet.setListeners(ev_l)
    pnet.fit(pds(batches[4]))
    assert len(ev_l.evaluations) == 1


def test_half_network_keeps_integer_ids_and_bf16_params():
    """HALF is bfloat16; token ids are never cast to it (ids above 256
    would collide)."""
    def conf(pkg):
        return (pkg.NeuralNetConfiguration.Builder().seed(3).dataType("HALF").list()
                .layer(pkg.layers.EmbeddingSequenceLayer(nIn=1000, nOut=8))
                .layer(pkg.layers.GlobalPoolingLayer(poolingType="AVG"))
                .layer(pkg.layers.OutputLayer(nOut=3))
                .setInputType(pkg.InputType.recurrent(1000, 5)).build())
    pnet = pnn.MultiLayerNetwork(conf(pnn), device="cpu").init()
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(pnet._params))
    ids = np.array([[997, 998, 999, 1, 2], [513, 514, 515, 516, 517]], np.int32)
    out = pnet.output(ids)
    assert out.dtype == torch.bfloat16
    W = pnet.getParam(0, "W").torch.float()
    want = torch.softmax(W[torch.tensor(ids, dtype=torch.int64)].mean(1).bfloat16().float()
                         @ pnet.getParam(2, "W").torch.float()
                         + pnet.getParam(2, "b").torch.float(), -1)
    np.testing.assert_allclose(out.toNumpy(), want.numpy(), atol=2e-2)
    pnet.fit(ids, np.eye(3, dtype=np.float32)[[0, 1]])
    assert np.isfinite(pnet.score())
    # a float32 mask keeps the pooled activations in bf16 (the reference
    # lifts them to float32 there and its matmul promotes; torch's does not)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    assert pnet.output(ids, features_mask=mask).dtype == torch.bfloat16


def test_float64_features_join_the_network_dtype():
    """With the 64-bit switch on, float64 features into a FLOAT network
    are cast to float32 (torch's matmuls take one dtype; the reference
    would compute that layer in float64): the output equals the float32
    features' and is float32."""
    jnet, batches = G.CASES["mlp_adam"]()
    pnet = port_of(jnet)
    x = batches[0].features
    out64 = pnet.output(x.astype(np.float64))
    assert out64.dtype == torch.float32
    np.testing.assert_array_equal(out64.toNumpy(), pnet.output(x).toNumpy())


def test_summary_of_nested_params():
    """A Bidirectional layer's nested {'fwd', 'bwd'} params are counted
    (the reference's summary indexes the nested dict's values as arrays
    and raises there)."""
    conf = (pnn.NeuralNetConfiguration.Builder().seed(1).list()
            .layer(pnn.layers.Bidirectional(fwd=pnn.layers.LSTM(nOut=3)))
            .layer(pnn.layers.RnnOutputLayer(nOut=2))
            .setInputType(pnn.InputType.recurrent(4, 5)).build())
    net = pnn.MultiLayerNetwork(conf, device="cpu").init()
    lines = net.summary().splitlines()
    assert lines[1].split()[:3] == ["0", "Bidirectional", str(2 * (4 * 12 + 3 * 12 + 12))]
    assert lines[-1] == f"Total params: {net.numParams()}"
