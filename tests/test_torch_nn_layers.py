"""The port's feed-forward and convolutional layers
(``deeplearning4j_tpu_torch/nn/conf/layers.py``: dense, embeddings and
the convolutions; pooling, normalization and the rest of the
feed-forward kinds are in ``tests/test_torch_nn_pool.py``) against the
JAX package's on the CPU, on the
same weights (the reference's seeded init, carried across as numpy) and
inputs (the recipes of ``tests/torch_nn_cases.py``): the forward in
inference and in training mode (the same dropout key on both sides), the
new layer state (BatchNormalization's running statistics), and the
gradients of sum(out * c), c a fixed seeded cotangent, with respect to
the input and every parameter. The harness and its tolerances (1e-5
forward, 1e-4 gradients, relative to the largest |value|) are in
``tests/torch_nn_parity.py``; the recurrent, attention and output layers
are in ``tests/test_torch_nn_rnn.py``.
"""
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd

import torch_nn_cases as C
import torch_nn_parity as H

IDS = C.CASE_IDS[:C.CASE_IDS.index("pool_max")]


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id,training,masked", list(H.variants(IDS)))
def test_layer_forward_and_gradients(case_id, training, masked):
    H.check_case(case_id, training, masked)


def test_cases_cover_the_slice():
    """Every one of the reference's 57 layer types has a case, and the
    port's LAYER_TYPES holds exactly them."""
    used = {spec[0] for _, spec, _, _ in C.CASES}
    assert used == set(C.LAYER_NAMES)
    assert set(pnn.layers.LAYER_TYPES) == set(C.LAYER_NAMES)
    assert len(C.LAYER_NAMES) == 57


@pytest.mark.parametrize("case_id", ["conv_same_s2", "deconv_same", "lstm",
                                     "bidirectional_concat", "self_attention",
                                     "conv_lstm2d_seq", "pool_avg_same",
                                     "conv1d_truncate", "depthwise"])
def test_output_type_and_n_params(case_id):
    """Shape inference and parameter counts equal the reference's; the
    forward's shape is what ``output_type`` says where both agree on it."""
    jl, _ = C.build(jnn, case_id)
    pl, _ = C.build(pnn, case_id)
    ispec = C.case(case_id)[2]
    jt = jl.output_type(C.input_type(jnn.InputType, ispec))
    pt = pl.output_type(C.input_type(pnn.InputType, ispec))
    assert jt.to_dict() == pt.to_dict()
    assert jl.n_params() == pl.n_params()
