"""The reference's golden trajectories (``tests/goldens``,
``tests/test_golden_trajectories.py``) whose layers are in the second
half of the networks slice, run by the port on the CPU: the graph of
Dense layers and a MergeVertex, the VAE's layer-wise pretraining, the
learned and recurrent attention layers, GravesBidirectionalLSTM. From
the port's own seeded init each must meet the golden's losses and
parameter checksums (the golden suite's ``RTOL = 2e-4``); from the
reference's weights carried across (normal draws differ in ``erfinv``'s
last bits) the losses within 1e-5 relative of the JAX run's and the
parameters within 1e-5 of the network's largest |parameter|. The port's
64-bit switch is on, as the suite runs the reference.
"""
import json
import os

import jax
import numpy as np
import pytest

import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet

import test_golden_trajectories as G
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

REL = 1e-5
GOLDEN = ["graph_merge_adam", "vae_pretrain_adam", "learned_recurrent_attention_adam",
          "graves_bidirectional_lstm_adam"]


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


def _port(jnet, carry):
    if type(jnet).__name__ == "ComputationGraph":
        net = pnn.ComputationGraph(
            pnn.ComputationGraphConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    else:
        net = pnn.MultiLayerNetwork(
            pnn.MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    net.init()
    if carry:
        net.setParamTrees(jax.tree_util.tree_map(np.asarray, jnet._params),
                          jax.tree_util.tree_map(np.asarray, jnet._state))
    return net


def _step(name, net, ds):
    if name == "vae_pretrain_adam":
        net.pretrainLayer(0, ds)
    else:
        net.fit(ds)
    return float(net.score())


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_trajectory(name):
    with open(os.path.join(G.GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    jnet, batches = G.CASES[name]()
    jnet.fuseSteps = 0
    own, carried = _port(jnet, False), _port(jnet, True)
    losses, closses, jlosses = [], [], []
    for ds in batches:
        pds = DataSet(ds.features, ds.labels)
        losses.append(_step(name, own, pds))
        closses.append(_step(name, carried, pds))
        jlosses.append(_step(name, jnet, ds))
    leaves = own.params().toNumpy()
    np.testing.assert_allclose(losses, golden["losses"], rtol=G.RTOL)
    assert float(np.abs(leaves).sum()) == pytest.approx(golden["param_abs_sum"], rel=G.RTOL)
    assert float((leaves.astype(np.float64) ** 2).sum()) == pytest.approx(
        golden["param_sq_sum"], rel=G.RTOL)
    H.close(closses, jlosses, REL, f"{name} losses")
    want = np.asarray(jnet.params().jax)
    H.close(carried.params().toNumpy(), want, REL, f"{name} params")
    assert carried.getIterationCount() == jnet.getIterationCount() == len(batches)
