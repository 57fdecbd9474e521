"""``ParallelWrapper`` and ``ParallelInference`` (``deeplearning4j_tpu_
torch/parallel/data_parallel.py``) in a 2-rank gloo world (``tests/
torch_dist_worker.py``'s ``dataparallel`` suite, one process a rank)
against the JAX package's ``ParallelWrapper`` over 2 of the suite's 8
virtual CPU devices, which jits one step over the global batch:

- a network with conf dropout, BatchNormalization and a DropoutLayer over
  3 batches, the last one partial (7 rows, cyclic-padded to 8): the
  losses, the parameters and the running statistics within 1e-5 relative
  of the reference's — the global batch's moments, masks drawn at the
  global shape, the global mean gradient — and every rank holding the
  same parameters;
- a two-input ComputationGraph with a sequence mask through the wrapper,
  against the same graph's plain ``fit`` on the padded global batches;
- ``ParallelInference.output`` of 5 rows (the 2·2^k ladder's 8) equal to
  the network's own output, and the same rows through ``engine()``, the
  batching ``InferenceEngine`` over the wrapper's mesh (its buckets
  multiples of the 'data' size), bit-equal.
"""
import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.parallel.data_parallel import ParallelWrapper as JPW

import torch_dist_worker as W
import torch_graph_cases as GC
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

TIMEOUT = 240.0
REL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World("dataparallel", 2, tmp_path_factory.mktemp("torch_data_parallel"), TIMEOUT)
    yield w
    w.close()


@pytest.fixture(scope="module")
def reference():
    net = jnn.MultiLayerNetwork(GC.dp_net(jnn, jtrain)).init()
    pw = JPW(net, workers=2)
    losses = []
    for x, y in GC.dp_batches():
        pw.fit(JDataSet(x, y))
        losses.append(float(net.score()))
    return net, losses


def test_wrapper_matches_reference_with_batchnorm_and_dropout(world, reference):
    got = world.case("mln")
    net, losses = reference
    H.close(got["losses"], losses, REL, "losses")
    H.close(got["params"], np.asarray(net.params().jax), REL, "params")
    for a, b in zip(got["state"], jax.tree_util.tree_leaves(net._state)):
        H.close(a, np.asarray(b), REL, "running statistics")
    assert got["ranks_equal"]
    assert got["iterations"] == net.getIterationCount() == 3
    assert got["epochs"] == net.getEpochCount() == 3


def test_wrapper_over_a_graph_equals_plain_fit_on_the_global_batch(world):
    got = world.case("graph")
    H.close(got["losses"], got["plain_losses"], REL, "graph losses")
    H.close(got["params"], got["plain_params"], REL, "graph params")
    assert got["ranks_equal"]


def test_parallel_inference_pads_to_the_ladder(world):
    got = world.case("inference")
    assert got["bucket"] == 8
    np.testing.assert_array_equal(got["parallel"], got["plain"])
    assert all(b % 2 == 0 for b in got["engine_buckets"])
    np.testing.assert_array_equal(got["engine"], got["parallel"])


def test_data_parallel_world_imports_no_jax(world):
    assert world.results()["_jax_imported"] == []
