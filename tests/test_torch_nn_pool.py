"""The port's pooling, normalization, dropout, activation, upsampling,
padding, cropping and global pooling layers
(``deeplearning4j_tpu_torch/nn/conf/layers.py``) against the JAX
package's on the CPU, as ``tests/test_torch_nn_layers.py`` holds the
dense and convolutional ones: on the
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

from deeplearning4j_tpu_torch import nd

import torch_nn_cases as C
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

IDS = C.CASE_IDS[C.CASE_IDS.index("pool_max"):C.CASE_IDS.index("lstm")]


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id,training,masked", list(H.variants(IDS)))
def test_layer_forward_and_gradients(case_id, training, masked):
    H.check_case(case_id, training, masked)
