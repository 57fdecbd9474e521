"""The second half of the port's layer types (``deeplearning4j_tpu_torch/
nn/conf/layers.py``: the shape and elementwise layers, the 3D
convolution and pooling, the locally connected layers) against the JAX
package's on the CPU, through the harness of ``tests/torch_nn_parity.py``
(forward in both modes, every gradient; 1e-5 forward, 1e-4 gradients,
relative to the largest |value|) over the recipes of
``tests/torch_nn_cases.py``. Also: the port's layer registry holds the
reference's 57 types, and every second-half case's shape inference and
parameter count equal the reference's. The recurrent extras, capsules,
heads and autoencoders are in ``tests/test_torch_nn_layers2_heads.py``.
"""
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd

import torch_nn_cases as C
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

IDS = C.SECOND_HALF_IDS[:C.SECOND_HALF_IDS.index("graves_bidirectional_lstm")]


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id,training,masked", list(H.variants(IDS)))
def test_layer_forward_and_gradients(case_id, training, masked):
    H.check_case(case_id, training, masked)


def test_registry_layer_types_equal_reference():
    """The port's LAYER_TYPES has the reference's 57 keys, every one a
    class of the same name, and nothing is refused by name any more."""
    assert sorted(pnn.layers.LAYER_TYPES) == sorted(jnn.layers.LAYER_TYPES)
    assert len(pnn.layers.LAYER_TYPES) == 57
    assert all(cls.__name__ == name for name, cls in pnn.layers.LAYER_TYPES.items())
    assert not hasattr(pnn.layers, "NOT_YET_PORTED")


@pytest.mark.parametrize("case_id", C.SECOND_HALF_IDS)
def test_output_type_and_n_params(case_id):
    """Shape inference, the filled-in configuration and the parameter
    count equal the reference's."""
    jl, jconf = C.build(jnn, case_id)
    pl, pconf = C.build(pnn, case_id)
    ispec = C.case(case_id)[2]
    jt = jl.output_type(C.input_type(jnn.InputType, ispec))
    pt = pl.output_type(C.input_type(pnn.InputType, ispec))
    assert jt.to_dict() == pt.to_dict()
    assert jl.n_params() == pl.n_params()
    assert pconf.to_json() == jconf.to_json()
