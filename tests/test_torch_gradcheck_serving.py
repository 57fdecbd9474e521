"""The port's gradient checks (``utils/gradientcheck.py``) and model
adapters (``serving/registry.py``: ``MultiLayerNetworkAdapter``,
``ComputationGraphAdapter``, ``SameDiffAdapter``; ``as_adapter``;
``ParallelInference.engine()``) on the CPU.

Gradient checks: a parametrised pick of ``tests/test_gradchecks.py``'s
networks, built by both packages on the reference's initial weights
(crossed through numpy). Both packages must pass at the reference's
tolerance (``max_rel_error`` 1e-3), check the same parameter indices
(the same ``seed`` over the same ``ravel_pytree`` order) and report the
same analytic gradients within 1e-6 relative; the numerical gradients
agree within 1e-6 absolute (central differences at epsilon 1e-6 in
float64), and each package's worst relative error, over the indices
whose absolute error passes ``min_abs_error`` as the check counts them,
is under the tolerance.

Adapters: a bucket batch served through the registry's engine is
compared bit for bit with the model's own call on the same padded batch
(the engine pads 3 rows to bucket 4). That is the contract the engine
keeps; the rows of a 3-row call may differ from the padded call's by
float rounding (the reference's own test, which compares with the
unpadded call, fails by one float32 ulp for that reason), so the
unpadded call is held to 1e-6 relative.
"""
import re

import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu.utils import gradientcheck as jgc
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.serving.registry import (
    ComputationGraphAdapter, MultiLayerNetworkAdapter, SameDiffAdapter, as_adapter)
from deeplearning4j_tpu_torch.utils import gradientcheck as pgc

import jax
from torch_threads import one_torch_thread  # noqa: F401,E402


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


def _mln(nn, train, input_type, layers):
    conf = nn.NeuralNetConfiguration.Builder().seed(7).updater(train.Sgd(0.1)).list()
    for l in layers:
        conf = conf.layer(l)
    return conf.setInputType(input_type).build()


def _graph(nn, train, build, nin=4, nout=2):
    L = nn.layers if hasattr(nn, "layers") else nn.conf.layers
    g = nn.NeuralNetConfiguration.Builder().seed(7).updater(train.Sgd(0.1)) \
        .graphBuilder().addInputs("in")
    last = build(nn, L, g)
    g.addLayer("out", L.OutputLayer(nIn=None, nOut=nout, lossFunction="MCXENT"), last)
    g.setOutputs("out")
    g.setInputTypes(nn.InputType.feedForward(nin))
    return g.build()


def _merge(nn, L, g):
    g.addLayer("a", L.DenseLayer(nIn=4, nOut=3, activation="TANH"), "in")
    g.addLayer("b", L.DenseLayer(nIn=4, nOut=3, activation="SIGMOID"), "in")
    g.addVertex("m", nn.MergeVertex(), "a", "b")
    return "m"


def _add(nn, L, g):
    g.addLayer("a", L.DenseLayer(nIn=4, nOut=3, activation="TANH"), "in")
    g.addLayer("b", L.DenseLayer(nIn=4, nOut=3, activation="SIGMOID"), "in")
    g.addVertex("e", nn.ElementWiseVertex(op="Add"), "a", "b")
    return "e"


RNG = np.random.default_rng(42)


def _ff(n, nin, ncls):
    return (RNG.normal(size=(n, nin)), np.eye(ncls)[RNG.integers(0, ncls, n)])


# id -> (kind, layers(L) or graph builder, input type(nn), x, y, subset)
CASES = {
    "dense_tanh": ("mln", lambda L: [L.DenseLayer(nOut=5, activation="TANH"),
                                     L.OutputLayer(nOut=3, lossFunction="MCXENT")],
                   lambda nn: nn.InputType.feedForward(4), *_ff(6, 4, 3), 40),
    "dense_sigmoid_mse": ("mln", lambda L: [L.DenseLayer(nOut=5, activation="SIGMOID"),
                                            L.OutputLayer(nOut=3, activation="TANH",
                                                          lossFunction="MSE")],
                          lambda nn: nn.InputType.feedForward(4),
                          RNG.normal(size=(6, 4)), RNG.normal(size=(6, 3)), 40),
    "batchnorm_dense": ("mln", lambda L: [L.DenseLayer(nOut=6, activation="IDENTITY"),
                                          L.BatchNormalization(activation="TANH"),
                                          L.OutputLayer(nOut=3, lossFunction="MCXENT")],
                        lambda nn: nn.InputType.feedForward(4), *_ff(8, 4, 3), 40),
    "conv2d_pool": ("mln", lambda L: [
        L.ConvolutionLayer(nOut=3, kernelSize=(3, 3), activation="TANH"),
        L.SubsamplingLayer(poolingType="AVG", kernelSize=(2, 2), stride=(2, 2)),
        L.OutputLayer(nOut=2, lossFunction="MCXENT")],
        lambda nn: nn.InputType.convolutional(8, 8, 2),
        RNG.normal(size=(3, 2, 8, 8)), np.eye(2)[RNG.integers(0, 2, 3)], 50),
    "graph_merge": ("graph", _merge, None, *_ff(4, 4, 2), 50),
    "graph_add": ("graph", _add, None, *_ff(4, 4, 2), 40),
}

ROW = re.compile(r"param\[(\d+)\]: analytic=(\S+) numeric=(\S+) relErr=(\S+)")


def _rows(out):
    return [(int(i), float(a), float(n), float(r)) for i, a, n, r in ROW.findall(out)]


def _build(kind, spec, itype):
    if kind == "mln":
        jnet = jnn.MultiLayerNetwork(_mln(jnn, jtrain, itype(jnn), spec(jnn.conf.layers
                                                                        if hasattr(jnn, "conf")
                                                                        else jnn.layers)))
        pnet = pnn.MultiLayerNetwork(_mln(pnn, ptrain, itype(pnn), spec(pnn.layers)),
                                     device="cpu")
    else:
        from deeplearning4j_tpu.nn.computation_graph import ComputationGraph
        jnet = ComputationGraph(_graph(jnn, jtrain, spec))
        pnet = pnn.ComputationGraph(_graph(pnn, ptrain, spec), device="cpu")
    jnet.init()
    # the reference's check calls the network's loss once a parameter
    # side: jitted once here, as the rest of the suite runs it
    jnet._loss_for = jax.jit(jnet._loss_for)
    pnet.init()
    tree = jax.tree_util.tree_map(np.asarray, jnet._params)
    state = jax.tree_util.tree_map(np.asarray, jnet._state)
    pnet.setParamTrees(tree, state)
    return jnet, pnet


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_check_matches_the_reference(case, capsys):
    kind, spec, itype, x, y, subset = CASES[case]
    jnet, pnet = _build(kind, spec, itype)
    jcheck = jgc.check_gradients if kind == "mln" else jgc.check_gradients_graph
    pcheck = pgc.check_gradients if kind == "mln" else pgc.check_gradients_graph
    assert pcheck(pnet, x, y, subset=subset)
    # a negative tolerance makes every checked index "fail": the
    # reference prints its rows (index, analytic, numeric, relative
    # error), 20 of them, and judges nothing else
    capsys.readouterr()
    assert not jcheck(jnet, x, y, subset=20, max_rel_error=-1.0, min_abs_error=-1.0)
    jrows = _rows(capsys.readouterr().out)
    prows = [r[:4] for r in (pgc.gradient_errors(pnet, x, y, subset=20) if kind == "mln"
                             else _graph_rows(pnet, x, y))]
    assert len(prows) == len(jrows) == 20
    assert [r[0] for r in prows] == [r[0] for r in jrows]
    pa, ja = np.array([r[1] for r in prows]), np.array([r[1] for r in jrows])
    np.testing.assert_allclose(pa, ja, rtol=1e-6, atol=1e-6 * np.abs(ja).max())
    np.testing.assert_allclose([r[2] for r in prows], [r[2] for r in jrows], atol=1e-6)
    # both pass the reference's check (relative error 1e-3 where the
    # absolute error exceeds min_abs_error 1e-8, as the check counts it)
    worst = [max([r[3] for r in rows if abs(r[1] - r[2]) > 1e-8] or [0.0])
             for rows in (prows, jrows)]
    assert max(worst) < 1e-3, worst


def _graph_rows(graph, x, y):
    """check_gradients_graph's rows (its loss, as the check builds it)."""
    import torch
    inputs = {"in": torch.as_tensor(x, dtype=torch.float64)}
    labels = [torch.as_tensor(y, dtype=torch.float64)]
    state = pgc._f64(graph._state)
    with pgc._float64(graph):
        return pgc._flat_errors(
            lambda p: graph._loss_for(p, state, inputs, labels, None, None)[0],
            pgc._f64(graph._params), 1e-6, 20, 12345)


def test_function_gradient_check_matches_the_reference(capsys):
    import jax.numpy as jnp
    import torch
    x = RNG.normal(size=(3, 4))
    assert jgc.check_function_gradients(lambda t: jnp.sum(jnp.tanh(t) ** 2), x)
    assert pgc.check_function_gradients(lambda t: torch.sum(torch.tanh(t) ** 2), x)
    assert not pgc.check_function_gradients(lambda t: torch.sum(torch.tanh(t) ** 2) + 0
                                            * t.detach().sum(), x, max_rel_error=-1.0,
                                            min_abs_error=-1.0)
    assert "x[" in capsys.readouterr().out
    # a wrong gradient is caught: the detached factor hides d/dt of t*t
    assert not pgc.check_function_gradients(
        lambda t: torch.sum(t.detach() * t), x, print_failures=False)


# ----------------------------------------------------------------- serving


def _nets():
    """A dense MultiLayerNetwork, the reference test's ComputationGraph and
    SameDiff graph, on the CPU."""
    L = pnn.layers
    mln = pnn.MultiLayerNetwork(
        pnn.NeuralNetConfiguration.Builder().seed(7).updater(ptrain.Sgd(0.5)).list()
        .layer(L.DenseLayer(nIn=4, nOut=8, activation="TANH"))
        .layer(L.OutputLayer(nIn=8, nOut=3, activation="SOFTMAX", lossFunction="MCXENT"))
        .build(), device="cpu").init()
    cg = pnn.ComputationGraph(
        pnn.NeuralNetConfiguration.Builder().seed(7).updater(ptrain.Sgd(0.5)).graphBuilder()
        .addInputs("in")
        .addLayer("h", L.DenseLayer(nIn=4, nOut=8, activation="TANH"), "in")
        .addLayer("out", L.OutputLayer(nIn=8, nOut=2, activation="SOFTMAX",
                                       lossFunction="MCXENT"), "h")
        .setOutputs("out").build(), device="cpu").init()
    sd = SameDiff.create("cpu")
    x = sd.placeHolder("x", shape=(None, 4))
    sd.math.tanh(x.mmul(sd.var("w", np.full((4, 2), 0.5, np.float32)))).rename("y")
    return mln, cg, sd


def test_as_adapter_dispatch_and_errors():
    mln, cg, sd = _nets()
    assert isinstance(as_adapter(mln), MultiLayerNetworkAdapter)
    a = as_adapter(cg, output_index=0)
    assert isinstance(a, ComputationGraphAdapter) and a.output_index == 0
    s = as_adapter(sd)
    assert isinstance(s, SameDiffAdapter) and (s.input_name, s.output_name) == ("x", "y")
    assert as_adapter(s) is s
    assert a.cache_size() is None and s.cache_size() is None
    with pytest.raises(TypeError, match="cannot serve"):
        as_adapter(object())
    two = SameDiff.create("cpu")
    two.placeHolder("a", shape=(None, 2))
    two.placeHolder("b", shape=(None, 2))
    with pytest.raises(ValueError, match="2 placeholders"):
        SameDiffAdapter(two)
    empty = SameDiff.create("cpu")
    empty.placeHolder("a", shape=(None, 2))
    with pytest.raises(ValueError, match="no ops"):
        SameDiffAdapter(empty)


def test_registry_serves_networks_graphs_and_samediff():
    mln, cg, sd = _nets()
    reg = ModelRegistry(default_buckets=(1, 2, 4))
    reg.deploy("mln", mln)
    reg.deploy("cg", cg)
    reg.deploy("sd", sd, output_name="y")
    xv = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    padded = np.concatenate([xv, np.zeros((1, 4), np.float32)])
    direct = {"mln": lambda a: mln.output(a).toNumpy(),
              "cg": lambda a: cg.outputSingle(a).toNumpy(),
              "sd": lambda a: sd.output({"x": a}, "y")["y"].toNumpy()}
    for name, call in direct.items():
        with reg.engine(name, max_wait_ms=0) as eng:
            got = np.asarray(eng.output(xv))
        np.testing.assert_array_equal(got, call(padded)[:3])
        np.testing.assert_allclose(got, call(xv), rtol=1e-6, atol=1e-7)


def test_parallel_inference_engine_serves_the_network():
    mln, _, _ = _nets()
    pi = ParallelInference.Builder(mln).batchLimit(4).build()
    xv = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
    with pi.engine(max_wait_ms=0) as eng:
        assert eng.max_batch_size == 4
        got = np.asarray(eng.output(xv))
    np.testing.assert_array_equal(got, pi.output(xv).toNumpy())
    np.testing.assert_allclose(got, mln.output(xv).toNumpy(), rtol=1e-6, atol=1e-7)
