"""The forward and gradient of every key of the port's ``math``, ``bitwise`` and ``reduce``
namespaces against the JAX package's registry on the CPU
(``tests/torch_op_parity.py``; recipes and tolerances in
``tests/torch_op_cases.py``)."""
import pytest

from torch_op_parity import check_forward, check_gradient, grad_keys, keys_of

KEYS = keys_of('math', 'bitwise', 'reduce')


@pytest.mark.parametrize("key", grad_keys(KEYS))
def test_gradient(key):
    check_gradient(key)


@pytest.mark.parametrize("key", KEYS)
def test_forward(key):
    check_forward(key)
