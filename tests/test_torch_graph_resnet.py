"""ResNet-50 from each package's ``zoo.ResNet50``, cut by
``tests/torch_graph_cases.py`` to one block a stage, widths /8, 32x32
inputs and 10 classes, on the CPU against the JAX package's
ComputationGraph: the configuration's string, the seeded init (normal
draws within 1e-5 of the largest |value|: ``erfinv``'s last bits differ
between XLA and torch, most in the tails), 2 steps (losses and
parameters within 1e-5 relative, BatchNormalization's running
statistics), and ``ModelSerializer`` in both directions — a zip the
reference wrote restores in the port (``restoreComputationGraph``) and
one the port wrote restores in the reference, each giving the writer's
outputs, parameters, updater state and next step.

The parameter trajectories run under Nesterov momentum. Under the
recipe's Adam they cannot agree to 1e-5: a convolution's bias feeding a
BatchNormalization (and some BN shifts) has a gradient that is zero up
to rounding, which Adam divides by its own root-mean-square, so the
rounding noise of either package becomes a step of about ``lr`` of
either sign. So the Adam steps are held on their losses. The batch is 16:
at 32x32 the last stage is 1x1, and BatchNormalization over 4 values
(a batch of 4) amplifies rounding past 1e-5 within two steps. The port's
64-bit switch is on, as the suite runs the reference.
"""
import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu.zoo as jzoo
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.util.model_serializer import ModelSerializer as JSerializer
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
import deeplearning4j_tpu_torch.zoo as pzoo
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.util import crash_reporting
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

import torch_graph_cases as G
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

REL = 1e-5
CUT = dict(num_classes=10, hw=32, blocks=(1, 1, 1, 1), width_div=8)
MOMENTUM = dict(CUT, updater=lambda train: train.Nesterovs(0.01, 0.9))


@pytest.fixture(autouse=True)
def _x64(tmp_path):
    crash_reporting.crashDumpOutputDirectory(str(tmp_path))
    with nd.enableX64(True):
        yield
    crash_reporting.crashDumpOutputDirectory(None)


def _data(seed, batch=16):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, 3, 32, 32), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    return x, y


def _same(pg, jg, what):
    H.close(pg.params().toNumpy(), np.asarray(jg.params().jax), REL, what)
    for a, b in zip(tree_leaves(pg._state), jax.tree_util.tree_leaves(jg._state)):
        H.close(a.numpy(), np.asarray(b), REL, f"{what}: running statistics")


@pytest.fixture(scope="module")
def trained():
    """(reference graph, port graph) after 2 steps from the same seed."""
    with nd.enableX64(True):
        jg = jnn.ComputationGraph(G.resnet50(jzoo, jtrain, **MOMENTUM)).init()
        jg.fuseSteps = 0
        pg = pnn.ComputationGraph(G.resnet50(pzoo, ptrain, **MOMENTUM), device="cpu").init()
        assert pg.conf.to_json() == jg.conf.to_json()
        init_ok = all(
            np.abs(a.numpy() - np.asarray(b)).max() <= REL * np.abs(np.asarray(b)).max()
            for a, b in zip(tree_leaves(pg._params), jax.tree_util.tree_leaves(jg._params))
            if np.abs(np.asarray(b)).max() > 0)
        losses = []
        for step in range(2):
            x, y = _data(step)
            jg.fit(JDataSet(x, y))
            pg.fit(DataSet(x, y))
            losses.append((pg.score(), float(jg.score())))
    return jg, pg, init_ok, losses


def test_resnet_cut_init_and_two_steps(trained):
    jg, pg, init_ok, losses = trained
    assert init_ok, "seeded init differs from the reference's"
    for i, (got, want) in enumerate(losses):
        H.close(got, want, REL, f"loss {i}")
    _same(pg, jg, "params after 2 steps")
    assert len([n for n in pg._order if type(n.op).__name__ == "ElementWiseVertex"]) == 4


def test_serializer_reference_to_port(trained, tmp_path):
    jg, _, _, _ = trained
    path = str(tmp_path / "ref.zip")
    JSerializer.writeModel(jg, path)
    pg = ModelSerializer.restoreComputationGraph(path, device="cpu")
    assert pg.getIterationCount() == jg.getIterationCount() == 2
    _same(pg, jg, "restored")
    for a, b in zip(tree_leaves(pg._opt_state), jax.tree_util.tree_leaves(jg._opt_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x, y = _data(7)
    H.close(pg.outputSingle(x).toNumpy(), np.asarray(jg.outputSingle(x).jax), REL, "output")
    with pytest.raises(ValueError, match="contains a ComputationGraph"):
        ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")


def test_serializer_port_to_reference(trained, tmp_path):
    _, pg, _, _ = trained
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(pg, path)
    jg = JSerializer.restoreComputationGraph(path)
    jg.fuseSteps = 0
    H.close(pg.params().toNumpy(), np.asarray(jg.params().jax), REL, "restored in the reference")
    back = ModelSerializer.restoreModel(path, device="cpu")
    assert type(back).__name__ == "ComputationGraph"
    np.testing.assert_array_equal(back.params().toNumpy(), pg.params().toNumpy())
    x, y = _data(3)
    np.testing.assert_array_equal(back.outputSingle(x).toNumpy(), pg.outputSingle(x).toNumpy())
    # the next step from the restored updater state, on both sides
    jg.fit(JDataSet(x, y))
    back.fit(DataSet(x, y))
    H.close(back.score(), float(jg.score()), REL, "next loss")
    _same(back, jg, "next step")


def test_resnet_cut_adam_losses():
    """The recipe as it is (Adam 1e-3): 2 steps, the reference's losses."""
    jg = jnn.ComputationGraph(G.resnet50(jzoo, jtrain, **CUT)).init()
    jg.fuseSteps = 0
    pg = pnn.ComputationGraph(G.resnet50(pzoo, ptrain, **CUT), device="cpu").init()
    for step in range(2):
        x, y = _data(10 + step)
        jg.fit(JDataSet(x, y))
        pg.fit(DataSet(x, y))
        H.close(pg.score(), float(jg.score()), REL, f"Adam loss {step}")
