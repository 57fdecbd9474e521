"""The port's recurrent layers (``deeplearning4j_tpu_torch/nn/conf/
layers.py``: LSTM in both layouts, GravesLSTM, SimpleRnn, GRU,
Bidirectional, ConvLSTM2D) against the JAX package's on the CPU, as
``tests/test_torch_nn_layers.py`` holds the others: forward in both
modes and every gradient, the sequence cases also with a features mask
(rows of different lengths), through the harness of
``tests/torch_nn_parity.py`` (1e-5 forward, 1e-4 gradients, relative to
the largest |value|).
"""
import pytest

from deeplearning4j_tpu_torch import nd

import torch_nn_cases as C
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

IDS = C.CASE_IDS[C.CASE_IDS.index("lstm"):C.CASE_IDS.index("repeat_vector")]


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id,training,masked", list(H.variants(IDS)))
def test_layer_forward_and_gradients(case_id, training, masked):
    H.check_case(case_id, training, masked)
